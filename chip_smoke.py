#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jlm_tpu_torch``) on one GPU.

Run from the repository root on a machine with one Hopper card and the CUDA
toolkit:  ``python3 chip_smoke.py``.  Phases, none of them caught:

1. print the card, its power limit, the torch/CUDA versions, and build the
   three kernels from ``jlm_tpu_torch/csrc`` with nvcc (sm_90a);
2. compare each kernel with its plain PyTorch version on the card at the
   main path's shapes, with a stated bound, and time both (CUDA events);
3. drive the main path — streaming beam-10 conversion at V=50,000, E=256,
   H=512, one layer, int8 head, speed mode — over one 2,048-lattice chunk
   through ``BeamDecoder.decode_stream``, and check that every kernel was
   launched by it;
4. check top-1 path identity against the numpy oracle on the 50 test
   sentences: fp32 greedy, int8 beam-10, and bf16 beam-10 (50/50 each).

Weights are random (``init_params`` seed 0).  The last line is
``{"ok": true, "device": {...}}``; any failure exits non-zero before it.
No JAX is imported (the oracle is numpy).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# main-path shapes (bench.py): 2,048 lattices per chunk, beam_pad 10
S, B, C1 = 2048, 10, 65
V, E, H = 50_000, 256, 512
R = S * B
PASSES = 3
BOUNDS = {  # kernel vs plain version, on the same inputs on the card
    "project_lse int8": 1e-4,   # abs, lse; the int32 product is exact
    "project_lse bf16": 1e-3,   # abs, lse; fp32 sums in another order
    "lstm_cell_step bf16": 2.0,  # bf16 ulps of c' and h' (see bf16_ulps)
    "cand_dot bf16": 1e-3,      # abs error / max(1, max |plain|)
}


def log(*a):
    print(*a, flush=True)


def check(ok: bool, what: str) -> None:
    """Fail the run (unlike ``assert``, this survives ``python -O``)."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps: int = 10) -> float:
    """Median device time of one call, from CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def bf16_ulps(a: torch.Tensor, ref: torch.Tensor) -> float:
    """Max |a - ref| in bf16 ulps (8-bit mantissa) at max(|ref|, 2**-8):
    below 2**-8 the fp32 sum-order noise (~1e-6 absolute) of a value that
    cancels to near zero would count as many ulps of a tiny number."""
    a, ref = a.float(), ref.float()
    mag = ref.abs().clamp(min=2.0 ** -8)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((a - ref).abs() / ulp).max())


def kernel_cases(dev, rng):
    """(name, kernel call, plain call, error fn) per case; the error fn
    returns (the bounded metric, the max absolute error)."""
    from jlm_tpu.ops.quant import quantize_weight
    from jlm_tpu_torch.ops.cand_dot import cand_dot, cand_dot_ref
    from jlm_tpu_torch.ops.lstm_cell import lstm_cell_ref, lstm_cell_step
    from jlm_tpu_torch.ops.project import project_lse, project_lse_ref

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(dtype)

    bf = torch.bfloat16
    h = t(rng.uniform(-1, 1, (R, H)), bf)
    w = rng.normal(0, 0.05, (H, V)).astype(np.float32)
    bias = t(rng.normal(0, 0.1, V))
    q = quantize_weight(w, axis=0)
    Wq = torch.from_numpy(q["q"]).to(dev)
    head_q = {"W": {"q": Wq, "scale": t(q["scale"])}, "b": bias,
              "WT": Wq.t().contiguous()}
    Wb = t(w, bf)
    head_b = {"W": Wb, "b": bias, "WT": Wb.t().contiguous()}

    x = t(rng.normal(0, 0.3, (R, E)), bf)
    c = t(rng.normal(0, 1.0, (R, H)), bf)
    Wc = t(rng.normal(0, 0.05, (E + H, 4 * H)), bf)
    bc = t(rng.normal(0, 0.1, 4 * H))

    h3 = t(rng.uniform(-1, 1, (S, B, H)), bf)
    cols = t(rng.normal(0, 0.05, (S, C1, H)), bf)
    cbias = t(rng.normal(0, 0.1, (S, C1)))

    def abs_err(k, p):
        return float((k.float() - p.float()).abs().max())

    def lse_err(k, p):
        return abs_err(k, p), abs_err(k, p)

    def cell_plain():
        c_new, h_new = lstm_cell_ref(x, h, c, Wc, bc, 1.0)
        return c_new.to(bf), h_new.to(bf)

    def cell_err(k, p):
        return (max(bf16_ulps(k[0], p[0]), bf16_ulps(k[1], p[1])),
                max(abs_err(k[0], p[0]), abs_err(k[1], p[1])))

    def cand_err(k, p):
        return abs_err(k, p) / max(1.0, float(p.abs().max())), abs_err(k, p)

    return [
        ("project_lse int8",
         lambda: project_lse(h, head_q, None, compute_dtype=bf, int8_mxu=True),
         lambda: project_lse_ref(h, Wq, head_q["W"]["scale"], bias,
                                 compute_dtype=bf, int8_mxu=True),
         lse_err),
        ("project_lse bf16",
         lambda: project_lse(h, head_b, None, compute_dtype=bf),
         lambda: project_lse_ref(h, Wb, None, bias, compute_dtype=bf),
         lse_err),
        ("lstm_cell_step bf16",
         lambda: lstm_cell_step(x, h, c, Wc, bc, 1.0, compute_dtype=bf,
                                c_out_dtype=bf),
         cell_plain, cell_err),
        ("cand_dot bf16",
         lambda: cand_dot(h3, cols, cbias),
         lambda: cand_dot_ref(h3, cols, cbias),
         cand_err),
    ]


def bench_data():
    """The bench's config, vocab, lexicon, weights and 50 test sentences."""
    from jlm_tpu.config import Config
    from jlm_tpu.data import Lexicon, build_vocab, generate_corpus, generate_test_set
    from jlm_tpu.models.params import init_params
    from jlm_tpu.ops.quant import quantize_params

    config = Config(vocab_size=V, embed_size=E, hidden_size=H, num_layers=1,
                    beam_width=10, n_best_max=1, seed=0)
    vocab = build_vocab(generate_corpus(2000, seed=1234), config.vocab_size)
    lexicon = Lexicon.from_vocab(vocab)
    params = init_params(config)
    kanas = [k for k, _ in generate_test_set(50, seed=777)]
    return config, vocab, lexicon, params, quantize_params(params), kanas


def identical(results, oracle_results) -> int:
    return sum(r[0].segments == o.segments for r, o in zip(results, oracle_results))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs one CUDA card",
              file=sys.stderr)
        return 1
    from jlm_tpu.oracle import OracleDecoder, OracleLM
    from jlm_tpu_torch.decoder.engine import BeamDecoder
    from jlm_tpu_torch.ops import _build
    from jlm_tpu_torch.ops.cand_dot import cand_dot
    from jlm_tpu_torch.ops.lstm_cell import lstm_cell_step
    from jlm_tpu_torch.ops.project import project_lse

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- phase 1: card and build ----
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    _build.lib()
    info = _build.build_info
    log(f"kernels: {info['path']} built in {info['seconds']:.1f} s "
        f"(cached={info['cached']}) from {', '.join(_build.sources())}")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- phase 2: each kernel vs its plain version at main-path shapes ----
    rng = np.random.default_rng(0)
    measured = {}
    for name, kernel, plain, err_fn in kernel_cases(dev, rng):
        err, max_abs = err_fn(kernel(), plain())
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        log(f"{name}: err {err:.3e} (bound {BOUNDS[name]:g}; max abs {max_abs:.3e}), "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        check(err <= BOUNDS[name], f"{name}: error {err} exceeds {BOUNDS[name]}")
        measured[name] = (max_abs, ms, plain_ms)
    torch.cuda.empty_cache()

    # ---- phase 3: the main path, streaming beam-10 at flagship width ----
    config, vocab, lexicon, params, qp, kanas = bench_data()
    engine = BeamDecoder(qp, lexicon, vocab, config, precision="default", device=dev)
    stream = (kanas * (-(-S // len(kanas))))[:S]
    n_chars = sum(len(k) for k in stream)
    t0 = time.perf_counter()
    engine.decode_stream(stream, chunk_size=S)
    log(f"first decode_stream (warm-up): {time.perf_counter() - t0:.3f} s")
    counters = (project_lse, lstm_cell_step, cand_dot)
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(PASSES):
        t0 = time.perf_counter()
        results = engine.decode_stream(stream, chunk_size=S, n_best=1)
        times.append(time.perf_counter() - t0)  # ends in the blob fetch
    launches = {fn.__name__: fn.launches for fn in counters}
    frames = min(engine._t_bucket(max(len(k) for k in stream)), config.max_kana_len)
    forwards = PASSES * (frames + 1)  # root forward + one per frame
    log(f"launches over {PASSES} passes ({frames} frames each): {launches}")
    check(launches == {"project_lse": forwards, "cand_dot": forwards,
                       "lstm_cell_step": forwards * config.num_layers},
          f"launch counts {launches}, expected {forwards} forwards")
    med = statistics.median(times)
    log(f"main path: {n_chars} chars per pass, passes {[round(t, 4) for t in times]} s; "
        f"median {n_chars / med:.1f} chars/s, best {n_chars / min(times):.1f} chars/s "
        f"on {card}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    finite = all(len(r) == 1 and np.isfinite(r[0].score) for r in results)
    check(len(results) == len(stream) and finite,
          "main path: every sentence has one finite top-1 result")

    # ---- phase 4: parity with the numpy oracle on the 50 test sentences ----
    greedy_cfg = config.replace(beam_width=1)
    oracle = OracleDecoder(OracleLM(params, greedy_cfg), lexicon, vocab, greedy_cfg)
    greedy = BeamDecoder(params, lexicon, vocab, greedy_cfg, precision="highest",
                         device=dev)
    n = identical(greedy.decode_batch(kanas), [oracle.decode(k)[0] for k in kanas])
    log(f"greedy fp32 parity {n}/{len(kanas)} (top-1 path identity vs oracle)")
    check(n == len(kanas), "greedy parity")
    oracle_q = OracleDecoder(OracleLM(qp, config), lexicon, vocab, config)
    n = identical(results[:len(kanas)], [oracle_q.decode(k)[0] for k in kanas])
    log(f"beam-10 int8 parity {n}/{len(kanas)} (kernel path vs int8 oracle)")
    check(n == len(kanas), "int8 beam parity")
    bf16_engine = BeamDecoder(params, lexicon, vocab, config, precision="default",
                              device=dev)
    oracle_f = OracleDecoder(OracleLM(params, config), lexicon, vocab, config)
    n = identical(bf16_engine.decode_batch(kanas),
                  [oracle_f.decode(k)[0] for k in kanas])
    log(f"beam-10 bf16 parity {n}/{len(kanas)} (kernel path vs fp32 oracle)")
    check(n == len(kanas), "bf16 beam parity")
    check("jax" not in sys.modules, "the port imported jax")

    # ---- phase 5: records ----
    sources = {
        "project_lse": ("jlm_tpu_torch/csrc/project_lse.cu", "jlm_tpu/ops/project.py:42",
                        "project_lse int8"),
        "lstm_cell_step": ("jlm_tpu_torch/csrc/lstm_cell.cu",
                           "jlm_tpu/ops/lstm_cell.py:38", "lstm_cell_step bf16"),
        "cand_dot": ("jlm_tpu_torch/csrc/cand_dot.cu", "jlm_tpu/ops/cand_dot.py:31",
                     "cand_dot bf16"),
    }
    kernels = []
    for name, (src, replaces, case) in sources.items():
        err, ms, plain_ms = measured[case]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
