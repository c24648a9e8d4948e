"""Run one benchmark cell once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number of the output check beside
its limit); the checks are also the last lines of standard error.  With
``--trace 0`` the metrics are the cell's end-to-end ones, with ``--trace 1``
its per-layer ones.  A run without as many CUDA cards as the cell asks for
exits with code 2 and prints no result, as does one whose process has
loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names that may never be loaded: JAX and the JAX package
# (compared whole: the port's name begins with the JAX package's)
BARRED = ("jax", "jaxlib", "flax", "jlm_tpu")


def barred_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BARRED))


def fail(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(2)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")

    from benchmark.core import program, registry

    try:
        program.require()
    except ImportError as e:
        fail(f"the program under test is missing: {e}")
    cell = registry.workload(args.workload)
    cfg = registry.config(cell["config"])
    try:
        registry.family_of(cfg)
    except (FileNotFoundError, ValueError) as e:
        fail(str(e))
    kind = registry.traffic(cell["traffic"]["kind"])

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA card: the benchmark measures the card and does not fall back to the CPU")
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"{args.workload} needs {cell['chips']} card(s), {torch.cuda.device_count()} found")
    device = torch.device("cuda", 0)
    torch.set_num_threads(1)  # one process, few threads: the host is shared
    from benchmark.core import run_cell

    out = run_cell.run(cell, cfg, kind, args.seed, args.seconds, bool(args.trace), device,
                       T_START, os.path.join(ROOT, "build", "native"))
    found = barred_modules()
    if found:
        fail(f"the process loaded {', '.join(found)}: nothing the benchmark runs may")
    line = run_cell.result_line(out, bool(args.trace), registry.metrics(), device,
                                cell["chips"])
    from benchmark.core.peaks import card

    c = card()
    print(f"card {c['name']}, power limit {c['power_limit']}, max SM clock {c['max_sm_clock']}",
          file=sys.stderr)
    print(f"phases setup_s {out['setup_s']!r} window_s {out['window_s']!r} "
          f"check_s {out['check_s']!r}", file=sys.stderr)
    if "rate_by_fifth" in out:
        print("rate_by_fifth " + " ".join(f"{r:.1f}" for r in out["rate_by_fifth"]),
              file=sys.stderr)
    if args.trace:
        dw = out["trace"].device
        for label, sec in sorted(dw.device_s_by_range.items(), key=lambda kv: -kv[1]):
            print(f"device_s {label} {sec!r}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))


if __name__ == "__main__":
    main()
