"""Import a reference (JLM-style) numpy weight export into an experiment
dir (counterpart of ``scripts/import_reference_weights.py``).

The reference's pipeline exports trained TF variables as a plain numpy
dict (pickle or .npz — SURVEY.md §3.1 "Checkpoint→numpy exporter"); this
CLI re-keys such an export into the weight spec and writes a standard
experiment checkpoint the engine and eval tools load directly:

    python -m jlm_tpu_torch.scripts.import_reference_weights \
        --export jlm_weights.pkl --exp exp/imported \
        --vocab-size 50000 --hidden 512 [--dsoftmax] [--int8]
"""

from __future__ import annotations

import argparse
import json
import sys

from jlm_tpu_torch.config import Config, default_dsoftmax_blocks
from jlm_tpu_torch.ops.quant import quantize_params
from jlm_tpu_torch.train.checkpoint import save_checkpoint
from jlm_tpu_torch.train.import_reference import import_reference_weights, load_export


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--export", required=True,
                    help="reference weight export (.pkl or .npz)")
    ap.add_argument("--exp", required=True, help="output experiment dir")
    ap.add_argument("--vocab-size", type=int, default=50_000)
    ap.add_argument("--embed", type=int, default=256)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--dsoftmax", action="store_true")
    ap.add_argument("--int8", action="store_true",
                    help="also quantize the imported weights to int8")
    args = ap.parse_args(argv)

    cfg = Config(
        vocab_size=args.vocab_size, embed_size=args.embed,
        hidden_size=args.hidden, num_layers=args.layers,
        head="dsoftmax" if args.dsoftmax else "full",
        dsoftmax=default_dsoftmax_blocks(args.vocab_size, args.hidden)
        if args.dsoftmax else None,
    )
    params, mapping = import_reference_weights(load_export(args.export), cfg)
    if args.int8:
        params = quantize_params(params)
        cfg = cfg.replace(quantize=True)
    path = save_checkpoint(args.exp, params, cfg)
    print(json.dumps({"checkpoint": path, "mapping": mapping}, indent=1),
          file=sys.stderr)
    print(path)


if __name__ == "__main__":
    main()
