"""Multi-session server latency/throughput under load (counterpart of
``scripts/bench_server.py``).

Simulates M concurrent typing sessions pushing keystrokes in batches of E
events per device step and reports the per-step latency distribution
(median/p95/p99), per-keystroke amortized latency, and keystrokes/s.

Each timed step ends in ``srv.results(...)`` of one session, which fetches
that session's n-best from the device, so a step's clock stops only after
its device work.  Batching E keystrokes per step is what keeps throughput
real: that ratio (events/step-latency) is the serving number.

  python -m jlm_tpu_torch.scripts.bench_server [--sessions 64] [--events 64] \
      [--steps 40] [--quick] [--device cuda]

Prints one JSON line: ``median_step_ms``, ``p95_step_ms``, ``p99_step_ms``,
``keystrokes_per_sec``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

# the model's widths: BASELINE's 50k flagship (one layer, E 256, H 512)
SIZES = {"V": 50_000, "E": 256, "H": 512}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m jlm_tpu_torch.scripts.bench_server")
    ap.add_argument("--sessions", type=int, default=64)
    ap.add_argument("--events", type=int, default=64,
                    help="keystroke events batched per device step")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.quick:
        args.sessions, args.events, args.steps = 16, 16, 10

    from jlm_tpu_torch.config import Config
    from jlm_tpu_torch.data import Lexicon, build_vocab, generate_corpus, generate_test_set
    from jlm_tpu_torch.decoder.server import SessionServer
    from jlm_tpu_torch.models.params import init_params, resolve_device

    dev = resolve_device(args.device)  # raises for a card that is not there
    config = Config(
        vocab_size=SIZES["V"], embed_size=SIZES["E"], hidden_size=SIZES["H"], num_layers=1,
        beam_width=10, seed=0,
    )
    vocab = build_vocab(generate_corpus(2000, seed=1234), config.vocab_size)
    lexicon = Lexicon.from_vocab(vocab)
    params = init_params(config)
    srv = SessionServer(params, lexicon, vocab, config, max_sessions=args.sessions,
                        precision="default", device=dev)

    kanas = [k for k, _ in generate_test_set(200, seed=777)]
    streams = [itertools.cycle(kanas[i % len(kanas)]) for i in range(args.sessions)]
    sids = [srv.open() for _ in range(args.sessions)]
    # reset a session when its input would exceed the static bound
    typed = [0] * args.sessions

    def make_events(n):
        evs = []
        for _ in range(n):
            i = len(evs) % args.sessions
            if typed[i] >= config.max_kana_len - 1:
                srv.close(sids[i])
                sids[i] = srv.open()
                typed[i] = 0
            evs.append((sids[i], next(streams[i])))
            typed[i] += 1
        return evs

    srv.push(make_events(args.events))  # build the kernels + warm
    lat = []
    t_all = time.time()
    for _ in range(args.steps):
        evs = make_events(args.events)
        t0 = time.time()
        srv.push(evs)
        srv.results(evs[0][0], 1)  # force sync: one session's materialized result
        lat.append(time.time() - t0)
    wall = time.time() - t_all
    lat.sort()
    n = len(lat)
    med, p95, p99 = lat[n // 2], lat[int(n * 0.95)], lat[min(n - 1, int(n * 0.99))]
    ev_total = args.steps * args.events
    log(f"sessions={args.sessions} events/step={args.events} steps={args.steps}")
    log(f"step latency ms: median {med*1e3:.1f}  p95 {p95*1e3:.1f}  "
        f"p99 {p99*1e3:.1f}")
    log(f"amortized per-keystroke: {med*1e3/args.events:.2f} ms; "
        f"throughput {ev_total/wall:.0f} keystrokes/s")
    out = {"median_step_ms": round(med * 1e3, 1),
           "p95_step_ms": round(p95 * 1e3, 1),
           "p99_step_ms": round(p99 * 1e3, 1),
           "keystrokes_per_sec": round(ev_total / wall, 1)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
