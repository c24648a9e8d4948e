"""Perplexity evaluation CLI (counterpart of ``scripts/eval_ppl.py``).

  python -m jlm_tpu_torch.scripts.eval_ppl --data data/ --exp experiments/h512
      [--split test] [--device cuda]
"""

import argparse

from jlm_tpu_torch.data.io import load_dataset
from jlm_tpu_torch.train import Trainer, load_checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--exp", required=True)
    ap.add_argument("--split", default="test", choices=["dev", "test"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    vocab, train, dev, test = load_dataset(args.data)
    params, cfg = load_checkpoint(args.exp)
    trainer = Trainer(cfg, params=params, device=args.device)
    ids = dev if args.split == "dev" else test
    ppl = trainer.evaluate_ppl(ids)
    print(f"{args.split}_ppl={ppl:.3f}")


if __name__ == "__main__":
    main()
