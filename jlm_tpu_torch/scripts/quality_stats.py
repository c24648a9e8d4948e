"""Statistically solid config-5 quality: N>=1000 tests, multiple seeds
(counterpart of ``scripts/quality_stats.py``).

The recorded trained-quality numbers once moved 0.735 -> 0.675 between
rounds while the harness's own run-to-run noise at 200 eval sentences was
+/-0.03-0.06.  This script makes the claim chain measurable:

- evaluates on >=1000 context-dependent test sentences (the generator is
  synthetic and unlimited; 200 was a choice, not a constraint);
- trains the config-5 shape (2-layer, 100k-padded D-softmax head) from
  ``--seeds`` independent seeds with the port's trainer and reports mean
  +/- sd;
- reports the exact Bayes ceiling and the bigram baseline on the SAME
  test set, so the ordering  ceiling >= beam10 > greedy > bigram  is a
  single-table check with known error bars.

Writes/merges ``--tag`` (default ``config5_stats``) into ``--out`` (default
QUALITY.json).  Training and the LM decodes (``BeamDecoder``, batched) run
on ``--device`` (default the card); the n-gram baseline and the ceiling
are host-exact.  The shipping seed is picked on 300 sentences of a
disjoint generator seed.

  python -m jlm_tpu_torch.scripts.quality_stats --fused-ce [--seeds 3 4 5] \
      [--sentences 30000] [--tests 1000] [--epochs 25] [--skip-baselines] \
      [--out QUALITY.json] [--exp-root exp/quality_stats] [--device cuda]

Binomial sanity: at N=1000, one seed's accuracy has se ~ sqrt(p(1-p)/N)
~ 0.014 at p=0.7 — so a seed-to-seed sd <= 0.02 separates real training
variance from eval-set noise, which 200-sentence evals could not.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m jlm_tpu_torch.scripts.quality_stats")
    ap.add_argument("--sentences", type=int, default=30_000)
    ap.add_argument("--tests", type=int, default=1000)
    ap.add_argument("--seeds", type=int, nargs="+", default=[3, 4, 5])
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--lr-decay-start", type=int, default=4)
    ap.add_argument("--lr-decay-gate", type=float, default=0.0,
                    help=">0: hold full lr until dev PPL clears this gate "
                         "(robust to the seed-dependent plateau-escape "
                         "epoch), then decay per epoch")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--fused-ce", action="store_true")
    ap.add_argument("--out", default="QUALITY.json")
    ap.add_argument("--tag", default="config5_stats",
                    help="report key in QUALITY.json (recipe A/Bs)")
    ap.add_argument("--exp-root", default="exp/quality_stats")
    ap.add_argument("--save-data", default=None,
                    help="also save the (vocab, splits) dataset dir — the "
                         "bench_all --data5 companion for --exp5 rows")
    ap.add_argument("--skip-baselines", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    import numpy as np

    from jlm_tpu_torch.config import Config, default_dsoftmax_blocks
    from jlm_tpu_torch.data.corpus import build_vocab, encode_corpus, split_corpus
    from jlm_tpu_torch.data.lexicon import Lexicon
    from jlm_tpu_torch.data.synthetic_ctx import (
        generate_corpus_ctx,
        generate_test_set_ctx,
    )
    from jlm_tpu_torch.decoder.engine import BeamDecoder
    from jlm_tpu_torch.eval.ceiling import bayes_ceiling_ctx
    from jlm_tpu_torch.eval.conversion import evaluate_conversion
    from jlm_tpu_torch.train.trainer import train_lm

    corpus = generate_corpus_ctx(args.sentences, seed=1234)
    tests = generate_test_set_ctx(args.tests, seed=777)
    vocab = build_vocab(corpus, 100_000)
    lexicon = Lexicon.from_vocab(vocab)
    ids = encode_corpus(corpus, vocab)
    train_ids, dev_ids, test_ids = split_corpus(ids)
    log(f"corpus {args.sentences} sentences, real vocab {len(vocab)}, "
        f"tests {len(tests)}")
    if args.save_data:
        from jlm_tpu_torch.data.io import save_dataset

        save_dataset(args.save_data, vocab, train_ids, dev_ids, test_ids)
        log(f"dataset saved to {args.save_data}")

    V = 100_000  # config-5 padded vocab: the model pays the full head cost
    stats = {
        "test_sentences": len(tests),
        "train_sentences": args.sentences,
        "epochs": args.epochs,
        "seeds": list(args.seeds),
        "binomial_se_at_0.7": round((0.7 * 0.3 / len(tests)) ** 0.5, 4),
    }

    if not args.skip_baselines:
        ceil = bayes_ceiling_ctx(tests)
        stats["bayes_ceiling"] = {k: round(v, 4) for k, v in ceil.items()}
        log(f"ceiling: {ceil}")
        from jlm_tpu_torch.oracle import OracleDecoder
        from jlm_tpu_torch.oracle.ngram import NgramLM, ngram_config

        base_cfg = Config(vocab_size=V, beam_width=10)
        t0 = time.time()
        lm2 = NgramLM(vocab, order=2).fit_lines(corpus, vocab)
        dec2 = OracleDecoder(lm2, lexicon, vocab, ngram_config(base_cfg))
        rep2 = evaluate_conversion(dec2, tests, batched=False)
        stats["bigram"] = {
            "top1_acc": round(rep2.sentence_accuracy, 4),
            "char_acc": round(rep2.char_accuracy, 4),
        }
        log(f"bigram on {len(tests)}: {rep2.summary()} "
            f"({time.time()-t0:.0f}s)")

    cfg5 = Config(
        vocab_size=V, embed_size=256, hidden_size=512, num_layers=2,
        head="dsoftmax", dsoftmax=default_dsoftmax_blocks(V, 512),
        epochs=args.epochs, batch_size=args.batch_size, num_steps=32,
        learning_rate=args.lr,
        lr_decay_start_epoch=args.lr_decay_start,
        lr_decay_gate_ppl=args.lr_decay_gate,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        fused_ce=args.fused_ce,
    )
    stats["recipe"] = {
        "batch_size": args.batch_size, "lr": args.lr, "bf16": args.bf16,
        "fused_ce": args.fused_ce, "lr_decay_start": args.lr_decay_start,
        "lr_decay_gate_ppl": args.lr_decay_gate,
    }

    # Model selection set: DISJOINT from the test set (different generator
    # seed) — the shipping checkpoint is picked by dev-set conversion
    # accuracy, the honest response to the measured seed lottery; the test
    # numbers of the SELECTED model are what BENCH_DETAIL records.
    dev_tests = generate_test_set_ctx(300, seed=31337)

    per_seed = []
    for seed in args.seeds:
        cfg = cfg5.replace(seed=seed)
        exp_dir = os.path.join(args.exp_root, f"seed{seed}")
        resume = os.path.exists(os.path.join(exp_dir, "ckpt-latest.npz"))
        t0 = time.time()
        params, hist = train_lm(cfg, train_ids, dev_ids, exp_dir=exp_dir,
                                log=False, resume=resume, save_every=10,
                                device=args.device)
        dev_ppl = hist[-1]["dev_ppl"] if hist else float("nan")
        log(f"seed {seed}: trained in {time.time()-t0:.0f}s, "
            f"dev_ppl={dev_ppl:.2f}")
        row = {"seed": seed, "dev_ppl": round(float(dev_ppl), 3),
               "exp_dir": exp_dir}
        for bw, name in ((10, "beam10"), (1, "greedy")):
            dcfg = cfg.replace(beam_width=bw, n_best_max=1)
            eng = BeamDecoder(params, lexicon, vocab, dcfg,
                              precision="default", device=args.device)
            t0 = time.time()
            rep = evaluate_conversion(eng, tests)
            row[name] = {
                "top1_acc": round(rep.sentence_accuracy, 4),
                "char_acc": round(rep.char_accuracy, 4),
            }
            if name == "beam10":
                rep_d = evaluate_conversion(eng, dev_tests)
                row["beam10_devsel_acc"] = round(rep_d.sentence_accuracy, 4)
            log(f"seed {seed} {name}: {rep.summary()} "
                f"({time.time()-t0:.0f}s)")
        per_seed.append(row)

    stats["per_seed"] = per_seed
    best = max(per_seed, key=lambda r: r["beam10_devsel_acc"])
    stats["selected"] = {
        "seed": best["seed"],
        "exp_dir": best["exp_dir"],
        "rule": "argmax dev-set (seed-31337, disjoint) beam-10 accuracy",
        "beam10_devsel_acc": best["beam10_devsel_acc"],
        "beam10_test_acc": best["beam10"]["top1_acc"],
    }
    for name in ("beam10", "greedy"):
        accs = np.asarray([r[name]["top1_acc"] for r in per_seed])
        chars = np.asarray([r[name]["char_acc"] for r in per_seed])
        stats[f"{name}_top1_mean"] = round(float(accs.mean()), 4)
        stats[f"{name}_top1_sd"] = round(float(accs.std(ddof=1)), 4) if len(
            accs) > 1 else 0.0
        stats[f"{name}_char_mean"] = round(float(chars.mean()), 4)
    if not args.skip_baselines:
        m, sd = stats["beam10_top1_mean"], stats["beam10_top1_sd"]
        big = stats["bigram"]["top1_acc"]
        stats["claims"] = {
            "beam10_mean_minus_2sd_beats_bigram": (m - 2 * sd) > big,
            "beam_beats_greedy": m >= stats["greedy_top1_mean"],
            "gap_to_ceiling": round(
                stats["bayes_ceiling"]["top1_ceiling"] - m, 4),
        }
        log(f"claims: {stats['claims']}")

    # merge into QUALITY.json
    report = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            report = json.load(f)
    report[args.tag] = stats
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({args.tag: {
        k: v for k, v in stats.items()
        if k.endswith(("_mean", "_sd")) or k == "claims"
    }}))


if __name__ == "__main__":
    main()

