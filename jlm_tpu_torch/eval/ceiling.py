"""Exact Bayes-optimal top-1 ceiling of the synthetic conversion task.

The port's copy of :mod:`jlm_tpu.eval.ceiling`.

The synthetic generator (:mod:`jlm_tpu_torch.data.synthetic`) picks a template
uniformly and each slot's word independently with the zipf-power rule
``idx = int(n * r**2.2)``, so the true posterior over surfaces given a
kana string is computable exactly by DP over (template, slot, position):

  P(idx = k) = ((k+1)/n)**(1/2.2) - (k/n)**(1/2.2)

No model can beat the MAP decoder of this posterior in expectation — its
accuracy is the task's top-1 ceiling (VERDICT r1 missing #4: distinguishes
"corpus-limited" from "undertrained" for trained checkpoints).
"""

from __future__ import annotations

from collections import defaultdict
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

from jlm_tpu_torch.data.synthetic import _TEMPLATES

_INV = 1.0 / 2.2


def _pool_readings(pool) -> Dict[str, List[Tuple[str, float]]]:
    """reading -> [(display, prob)] for one POS pool under the zipf rule."""
    n = len(pool)
    out: Dict[str, List[Tuple[str, float]]] = defaultdict(list)
    for k, (display, reading, _pos) in enumerate(pool):
        out[reading].append((display, ((k + 1) / n) ** _INV - (k / n) ** _INV))
    return out


def surface_posteriors(kana: str, _cache={}) -> Dict[str, float]:
    """Unnormalized P(display surface, kana) summed over templates/paths."""
    rmaps = _cache.setdefault("rmaps", {})
    out: Dict[str, float] = defaultdict(float)
    for tpl in _TEMPLATES:
        n_slots = len(tpl)
        maps = []
        for pool in tpl:
            key = id(pool)
            if key not in rmaps:
                rmaps[key] = _pool_readings(pool)
            maps.append(rmaps[key])

        @lru_cache(maxsize=None)
        def ways(pos: int, slot: int):
            if slot == n_slots:
                return [("", 1.0)] if pos == len(kana) else []
            res = []
            rm = maps[slot]
            for wlen in range(1, len(kana) - pos + 1):
                seg = kana[pos : pos + wlen]
                if seg not in rm:
                    continue
                tails = ways(pos + wlen, slot + 1)
                if not tails:
                    continue
                for display, p in rm[seg]:
                    for tail, tp in tails:
                        res.append((display + tail, p * tp))
            return res

        for display, p in ways(0, 0):
            out[display] += p / len(_TEMPLATES)
        ways.cache_clear()
    return out


def surface_posteriors_ctx(kana: str, _cache={}) -> Dict[str, float]:
    """Exact unnormalized P(surface, kana) under the TOPIC-conditioned
    generator (:mod:`jlm_tpu_torch.data.synthetic_ctx`): marginalize the latent
    topic, then the same (template, slot, position) DP as the context-free
    case — slot choices are conditionally independent GIVEN the topic, so
    the per-topic factorization is exact."""
    from jlm_tpu_torch.data.synthetic_ctx import TOPICS, pool_reading_probs

    rmaps = _cache.setdefault("rmaps_ctx", {})
    out: Dict[str, float] = defaultdict(float)
    w_mix = 1.0 / (len(TOPICS) * len(_TEMPLATES))
    for topic in TOPICS:
        for tpl in _TEMPLATES:
            n_slots = len(tpl)
            maps = []
            for pool in tpl:
                key = (id(pool), topic)
                if key not in rmaps:
                    rmaps[key] = pool_reading_probs(pool, topic)
                maps.append(rmaps[key])

            @lru_cache(maxsize=None)
            def ways(pos: int, slot: int):
                if slot == n_slots:
                    return [("", 1.0)] if pos == len(kana) else []
                res = []
                rm = maps[slot]
                for wlen in range(1, len(kana) - pos + 1):
                    seg = kana[pos : pos + wlen]
                    if seg not in rm:
                        continue
                    tails = ways(pos + wlen, slot + 1)
                    if not tails:
                        continue
                    for display, p in rm[seg]:
                        for tail, tp in tails:
                            res.append((display + tail, p * tp))
                return res

            for display, p in ways(0, 0):
                out[display] += p * w_mix
            ways.cache_clear()
    return out


def _map_accuracy(
    tests: Sequence[Tuple[str, str]], posterior_fn
) -> Dict[str, float]:
    hits = 0
    gold_mass = 0.0
    ambiguous = 0
    for kana, gold in tests:
        post = posterior_fn(kana)
        total = sum(post.values()) or 1.0
        best = max(post.items(), key=lambda kv: kv[1])[0] if post else ""
        hits += best == gold
        gold_mass += post.get(gold, 0.0) / total
        ambiguous += len(post) > 1
    n = max(1, len(tests))
    return {
        "top1_ceiling": hits / n,
        "gold_posterior_mass": gold_mass / n,
        "ambiguous_frac": ambiguous / n,
    }


def bayes_ceiling_ctx(tests: Sequence[Tuple[str, str]]) -> Dict[str, float]:
    """Exact Bayes top-1 ceiling of the topic-conditioned task."""
    return _map_accuracy(tests, surface_posteriors_ctx)


def bayes_ceiling(tests: Sequence[Tuple[str, str]]) -> Dict[str, float]:
    """MAP-decode each (kana, gold) pair under the true generator posterior.

    Returns {"top1_ceiling", "gold_posterior_mass", "ambiguous_frac"}.
    """
    hits = 0
    gold_mass = 0.0
    ambiguous = 0
    for kana, gold in tests:
        post = surface_posteriors(kana)
        total = sum(post.values()) or 1.0
        best = max(post.items(), key=lambda kv: kv[1])[0] if post else ""
        hits += best == gold
        gold_mass += post.get(gold, 0.0) / total
        ambiguous += len(post) > 1
    n = max(1, len(tests))
    return {
        "top1_ceiling": hits / n,
        "gold_posterior_mass": gold_mass / n,
        "ambiguous_frac": ambiguous / n,
    }
