"""Conversion CLI / interactive demo (counterpart of ``scripts/convert.py``).

  python -m jlm_tpu_torch.scripts.convert --data data/ --exp experiments/h512
      [--int8] [--kana きょうはいいてんき] [--n-best 3] [--incremental]
      [--device cuda]

With no --kana, reads kana lines from stdin (interactive IME demo).  An
input longer than the checkpoint's ``max_kana_len`` is converted in chunks
(``BeamDecoder.decode_long``).
"""

import argparse
import sys

from jlm_tpu_torch.data.io import load_dataset
from jlm_tpu_torch.data.lexicon import Lexicon
from jlm_tpu_torch.decoder.engine import BeamDecoder
from jlm_tpu_torch.decoder.incremental import IncrementalDecoder
from jlm_tpu_torch.ops.quant import quantize_params
from jlm_tpu_torch.train import load_checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--exp", required=True)
    ap.add_argument("--kana", default=None)
    ap.add_argument("--n-best", type=int, default=3)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--incremental", action="store_true")
    ap.add_argument("--beam-width", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    vocab, *_ = load_dataset(args.data)
    lexicon = Lexicon.from_vocab(vocab)
    params, cfg = load_checkpoint(args.exp)
    if args.beam_width:
        cfg = cfg.replace(beam_width=args.beam_width)
    if args.n_best > cfg.n_best_max:
        cfg = cfg.replace(n_best_max=args.n_best)
    if args.int8:
        params = quantize_params(params)

    if args.incremental:
        dec = IncrementalDecoder(params, lexicon, vocab, cfg, device=args.device)

        def convert(kana):
            dec.reset()
            for ch in kana:
                res = dec.push(ch, n_best=args.n_best)
            return res
    else:
        eng = BeamDecoder(params, lexicon, vocab, cfg, device=args.device)

        def convert(kana):
            return eng.decode(kana, n_best=args.n_best)

    def emit(kana):
        for r in convert(kana):
            print(f"{r.surface}\t{r.score:.4f}")

    if args.kana:
        emit(args.kana)
    else:
        print("kana> ", end="", flush=True)
        for line in sys.stdin:
            kana = line.strip()
            if kana:
                emit(kana)
            print("kana> ", end="", flush=True)


if __name__ == "__main__":
    main()
