"""Report the synthetic task's exact Bayes-optimal top-1 ceiling
(counterpart of ``scripts/quality_ceiling.py``).

See :mod:`jlm_tpu_torch.eval.ceiling` for the math: word choices are
context-free given the slot by construction, so no LM can beat the MAP
decoder of the true posterior.

Usage: python -m jlm_tpu_torch.scripts.quality_ceiling [--n 200] [--seed 777]
"""

import argparse

from jlm_tpu_torch.data.synthetic import generate_test_set
from jlm_tpu_torch.eval.ceiling import bayes_ceiling


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--seed", type=int, default=777)
    args = ap.parse_args(argv)
    tests = generate_test_set(args.n, seed=args.seed)
    r = bayes_ceiling(tests)
    print(f"test sentences: {len(tests)} (seed {args.seed})")
    print(f"ambiguous kana strings: {r['ambiguous_frac']:.3f}")
    print(f"Bayes-optimal top-1 accuracy (the task ceiling): "
          f"{r['top1_ceiling']:.3f}")
    print(f"mean posterior mass of the gold surface:        "
          f"{r['gold_posterior_mass']:.3f}")
    print("A perfectly-trained LM can at best match the ceiling; compare "
          "scripts/eval_conversion.py on the trained checkpoint.")


if __name__ == "__main__":
    main()
