"""Reproduce the reference's quality claims on the context-dependent corpus
(counterpart of ``scripts/eval_quality.py``).

The reference's headline result (SURVEY.md §8 quality row; ref:
JLM:README.md / arXiv:1810.09309) is *quality*, not just speed:

  1. the LSTM LM beats the n-gram baseline on conversion accuracy;
  2. beam search beats greedy;
  3. D-softmax* (prefix) ~ full softmax accuracy, and better than disjoint
     D-softmax on rare words (the §4.4 open [C-med] A/B).

This script runs the whole story on the topic-conditioned corpus
(:mod:`jlm_tpu_torch.data.synthetic_ctx`):

  exact Bayes ceiling  >=  LSTM beam-10  >  LSTM greedy  >  bigram  >  unigram

and writes ``--out`` (default QUALITY.json) with every number.  The LMs
train with the port's trainer on ``--device`` (default the card; ``cpu``
runs the small default dims on the host); the decodes are the numpy
oracle's.

  python -m jlm_tpu_torch.scripts.eval_quality [--sentences 30000] [--tests 200] \
      [--epochs 10] [--skip-dsoftmax] [--out QUALITY.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m jlm_tpu_torch.scripts.eval_quality")
    ap.add_argument("--sentences", type=int, default=30_000)
    ap.add_argument("--tests", type=int, default=200)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--hidden", type=int, default=192)
    ap.add_argument("--embed", type=int, default=64)
    ap.add_argument("--out", default="QUALITY.json")
    ap.add_argument("--skip-dsoftmax", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device of the training (default cuda)")
    args = ap.parse_args(argv)

    from jlm_tpu_torch.config import Config, DSoftmaxConfig
    from jlm_tpu_torch.data.corpus import build_vocab, encode_corpus, split_corpus
    from jlm_tpu_torch.data.lexicon import Lexicon
    from jlm_tpu_torch.data.synthetic_ctx import (
        generate_corpus_ctx,
        generate_test_set_ctx,
        generate_test_tokens_ctx,
    )
    from jlm_tpu_torch.eval.ceiling import bayes_ceiling_ctx
    from jlm_tpu_torch.eval.conversion import evaluate_conversion
    from jlm_tpu_torch.models.params import params_to_numpy
    from jlm_tpu_torch.oracle import OracleDecoder, OracleLM
    from jlm_tpu_torch.oracle.ngram import NgramLM, ngram_config
    from jlm_tpu_torch.train.trainer import train_lm

    corpus = generate_corpus_ctx(args.sentences, seed=1234)
    tests = generate_test_set_ctx(args.tests, seed=777)
    test_tokens = generate_test_tokens_ctx(args.tests, seed=777)
    vocab = build_vocab(corpus, 50_000)
    V_real = len(vocab)
    lexicon = Lexicon.from_vocab(vocab)
    log(f"corpus: {args.sentences} sentences, real vocab {V_real}")

    report = {"corpus_sentences": args.sentences, "test_sentences": args.tests,
              "vocab": V_real}

    # --- exact Bayes ceiling (topic-marginalized DP) ----------------------
    ceil = bayes_ceiling_ctx(tests)
    report["bayes_ceiling"] = ceil
    log(f"exact Bayes ceiling: {ceil}")

    # --- n-gram baselines (exact Viterbi via the oracle decoder) ----------
    base_cfg = Config(vocab_size=max(256, V_real), beam_width=10)
    for order, name in ((1, "unigram"), (2, "bigram")):
        lm = NgramLM(vocab, order=order).fit_lines(corpus, vocab)
        dec = OracleDecoder(lm, lexicon, vocab, ngram_config(base_cfg))
        rep = evaluate_conversion(dec, tests, batched=False)
        report[name] = {"top1_acc": rep.sentence_accuracy,
                        "char_acc": rep.char_accuracy}
        log(f"{name}: {rep.summary()}")

    # --- LSTM: train on the ctx corpus ------------------------------------
    ids = encode_corpus(corpus, vocab)
    train_ids, dev_ids, _ = split_corpus(ids)

    def train_and_eval(tag, cfg):
        t0 = time.time()
        params, hist = train_lm(cfg, train_ids, dev_ids, log=False, device=args.device)
        dev_ppl = hist[-1]["dev_ppl"]
        log(f"{tag}: trained {cfg.epochs} epochs in {time.time()-t0:.0f}s, "
            f"dev_ppl={dev_ppl:.2f}")
        params = params_to_numpy(params)
        out = {"dev_ppl": dev_ppl}
        for bw, bname in ((1, "greedy"), (10, "beam10")):
            dcfg = cfg.replace(beam_width=bw)
            dec = OracleDecoder(OracleLM(params, dcfg), lexicon, vocab, dcfg)
            rep = evaluate_conversion(dec, tests, batched=False)
            out[bname] = {"top1_acc": rep.sentence_accuracy,
                          "char_acc": rep.char_accuracy}
            log(f"{tag} {bname}: {rep.summary()}")
        return params, out

    lstm_cfg = Config(
        vocab_size=max(256, V_real), embed_size=args.embed,
        hidden_size=args.hidden, num_layers=1, epochs=args.epochs,
        batch_size=32, num_steps=32, learning_rate=2e-3,
        lr_decay_start_epoch=max(2, args.epochs - 5), seed=3,
    )
    _params, lstm_rep = train_and_eval("lstm_full", lstm_cfg)
    report["lstm_full"] = lstm_rep

    # --- D-softmax prefix vs disjoint A/B (rare-word quality, §4.4) -------
    if not args.skip_dsoftmax:
        # frequency-tiered blocks over the REAL vocab: frequent third gets
        # the full hidden dim, middle third half, rare tail a quarter.
        Vp = max(256, V_real)
        b0 = max(8, Vp // 6)
        b1 = max(8, Vp // 3)
        b2 = Vp - b0 - b1
        rare_start = b0 + b1  # ids in the last block = "rare words"
        rare_readings = {
            vocab.reading(w) for w in range(rare_start, V_real)
            if vocab.reading(w)
        }

        def rare_word_acc(params, cfg):
            """Token accuracy on gold tokens whose id is in the rare block.

            Alignment is by kana character span: a rare gold token counts as
            correct iff the decoded path contains a segment covering the
            same span with the same word id (robust to segmentation
            differences elsewhere in the sentence).
            """
            dcfg = cfg.replace(beam_width=10)
            dec = OracleDecoder(OracleLM(params, dcfg), lexicon, vocab, dcfg)

            def spans(segs):
                out, pos = {}, 0
                for display, wid in segs:
                    rlen = len(display) if wid == 1 else len(vocab.reading(wid))
                    out[(pos, pos + rlen)] = wid
                    pos += rlen
                return out

            hit = tot = 0
            for kana, toks in test_tokens:
                gold = [(vocab.id_of.get(f"{d}/{r}/{p}", 1), r)
                        for d, r, p in toks]
                if not any(g >= rare_start for g, _ in gold):
                    continue
                res = dec.decode(kana, 1)
                hyp_spans = spans(res[0].segments) if res else {}
                pos = 0
                for g, r in gold:
                    span = (pos, pos + len(r))
                    pos += len(r)
                    if g < rare_start:
                        continue
                    tot += 1
                    hit += hyp_spans.get(span) == g
            return hit / max(1, tot), tot

        # FLOP-matched A/B (the arXiv:1810.09309 comparison): identical
        # block dims for both modes, summing to H so the disjoint rule is
        # valid — prefix re-USES the first dims across blocks, disjoint
        # gives each block its own segment.  The paper's claim is that
        # prefix ("D-softmax*") wins on rare words at the same cost.
        dims = (max(8, args.hidden // 2), max(8, args.hidden // 4),
                max(8, args.hidden // 4))
        for mode in ("prefix", "disjoint"):
            ds = DSoftmaxConfig(
                block_sizes=(b0, b1, b2), block_dims=dims, mode=mode,
            )
            cfg = lstm_cfg.replace(head="dsoftmax", dsoftmax=ds)
            params, rep = train_and_eval(f"lstm_dsoftmax_{mode}", cfg)
            racc, rtot = rare_word_acc(params, cfg)
            rep["rare_word_acc"] = racc
            rep["rare_word_tokens"] = rtot
            log(f"lstm_dsoftmax_{mode}: rare-word acc {racc:.3f} on {rtot}")
            report[f"lstm_dsoftmax_{mode}"] = rep

    # --- the claims, asserted --------------------------------------------
    lstm_beam = report["lstm_full"]["beam10"]["top1_acc"]
    lstm_greedy = report["lstm_full"]["greedy"]["top1_acc"]
    report["claims"] = {
        "lstm_beats_bigram": lstm_beam > report["bigram"]["top1_acc"],
        "lstm_beats_unigram": lstm_beam > report["unigram"]["top1_acc"],
        "beam_beats_greedy": lstm_beam >= lstm_greedy,
        "lstm_vs_ceiling_gap": ceil["top1_ceiling"] - lstm_beam,
    }
    log(f"claims: {report['claims']}")

    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({"quality": report["claims"],
                      "lstm_beam10": lstm_beam,
                      "bigram": report["bigram"]["top1_acc"],
                      "unigram": report["unigram"]["top1_acc"],
                      "ceiling": ceil["top1_ceiling"]}))


if __name__ == "__main__":
    main()
