"""Checkpoint -> int8 inference-weight exporter CLI (counterpart of
``scripts/export_int8.py``).

Reads a training checkpoint, quantizes it per the weight spec (symmetric
int8, per-output-channel scales; embeddings per row) and writes an
``int8``-tagged checkpoint the decoders of either package load directly.

  python -m jlm_tpu_torch.scripts.export_int8 --exp experiments/h512 [--tag int8]
"""

import argparse

import numpy as np

from jlm_tpu_torch.ops.quant import quantize_params
from jlm_tpu_torch.train import load_checkpoint, save_checkpoint
from jlm_tpu_torch.train.checkpoint import flatten


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", required=True)
    ap.add_argument("--src-tag", default="latest")
    ap.add_argument("--tag", default="int8")
    args = ap.parse_args(argv)

    params, config = load_checkpoint(args.exp, tag=args.src_tag)
    qp = quantize_params(params)
    path = save_checkpoint(args.exp, qp, config, tag=args.tag)

    f32 = sum(np.asarray(x).nbytes for x in flatten(params).values())
    i8 = sum(np.asarray(x).nbytes for x in flatten(qp).values())
    print(f"wrote {path}: {f32/1e6:.1f} MB fp32 -> {i8/1e6:.1f} MB int8 "
          f"({f32/i8:.2f}x smaller)")


if __name__ == "__main__":
    main()
