"""The port at the widths past 512 that the JAX package takes, on the CPU.

The fused CE at hidden slices of 640 and 1,024, the LSTM scan at
H = E = 1,024, and the bf16 and dequant-bf16 heads at a 1,024-wide slice:
numpy-seeded inputs go through the JAX functions (Pallas in interpret mode,
as tests/test_kernels.py runs them; the JAX scan takes its jnp fallback at
these widths) and through the port's wrappers, which run their plain
versions on CPU tensors.  tests/test_torch_kernels_cuda.py holds the CUDA
kernels to those plain versions on the card at the same widths.  The scan
recurrences' launch plan (Wh resident or not, units a block, blocks) is
checked here against an occupancy table of the card's shape, and the fp32
GEMM's split of K as a function of the card's SM count.  Tolerances as in
test_torch_softmax_ce.py, test_torch_lstm_scan.py and test_torch_ops.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jlm_tpu.config import Config
from jlm_tpu.ops import project as jax_project
from jlm_tpu.ops import softmax_ce as jax_ce
from jlm_tpu.ops.lstm_scan import lstm_scan as jax_scan
from jlm_tpu.ops.quant import quantize_weight
from jlm_tpu_torch.ops import lstm_scan as ls
from jlm_tpu_torch.ops import project as port
from jlm_tpu_torch.ops import softmax_ce as ce

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("D", [640, 1024])
def test_ce_wide_matches_jax(D, dtype):
    """The per-row triple (m, s, t) and the generalized backward (dh, dW,
    db; independent ga, gb; -1 targets) at a slice wider than 512, V = 700.
    fp32: 1e-5 abs and rel (sum order only).  bf16: the triple within 1e-5
    (both sides round h and W to bf16 and sum in fp32); each gradient within
    1e-3 of its largest magnitude (a gp on a bf16 rounding boundary may
    round either way)."""
    jd, td = DTYPES[dtype]
    N, V = 16, 700
    rng = np.random.default_rng(51)
    h = rng.normal(size=(N, D)).astype(np.float32)
    W = rng.normal(size=(D, V)).astype(np.float32) * 0.05
    b = rng.normal(size=(V,)).astype(np.float32) * 0.01
    y = rng.integers(0, V, N).astype(np.int32)
    y[::5] = -1
    ga = rng.normal(size=(N,)).astype(np.float32)
    gb = rng.normal(size=(N,)).astype(np.float32)
    kw = dict(tile_v=512, compute_dtype=jd, interpret=True)
    m_j, s_j, t_j = jax_ce._ce_fwd_raw(*map(jnp.asarray, (h, W)), None, jnp.asarray(b),
                                      jnp.asarray(y), **kw)
    hT, WT, bT, yT = (torch.from_numpy(a) for a in (h, W, b, y))
    m_t, s_t, t_t = ce.ce_fwd_raw(hT, WT, bT, yT, td)
    for got, want in ((m_t, m_j), (s_t, s_j), (t_t, t_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    lse = (m_j + jnp.log(s_j)).astype(jnp.float32)
    want = jax_ce._ce_bwd_impl(*map(jnp.asarray, (h, W)), None, jnp.asarray(b),
                               jnp.asarray(y), lse, jnp.asarray(ga), jnp.asarray(gb), **kw)
    got = ce.ce_bwd(hT, WT, bT, yT, torch.from_numpy(np.array(lse)), torch.from_numpy(ga),
                    torch.from_numpy(gb), td)
    for g, w, name in zip(got, want, ("dh", "dW", "db")):
        assert tuple(g.shape) == tuple(w.shape), name
        if dtype == "fp32":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            assert _rel(g.numpy(), np.asarray(w, np.float32)) <= 1e-3, name


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_lstm_scan_1024_matches_jax(dtype):
    """H = E = 1,024, B = 2, T = 3: hs, c_T, h_T and the grads of xs, W, b,
    c0, h0 from all three outputs through the port's autograd Function (its
    forward and backward wrappers) vs JAX's.  At this width the JAX package
    takes its jnp fallback, which computes in fp32 whatever the compute
    dtype.  fp32: outputs 1e-5, grads 2e-4 abs + 1e-4 rel.  bf16 (x, h and
    W rounded to bf16 before each product in the port, not in the
    fallback): outputs within 2e-3 abs (the bf16 scan kernel's bound on the
    card) and each grad within 1e-2 of its largest magnitude."""
    jd, td = DTYPES[dtype]
    B, T, E, H = 2, 3, 1024, 1024
    rng = np.random.default_rng(52)
    args = (rng.normal(size=(B, T, E)).astype(np.float32) * 0.1,
            rng.normal(size=(E + H, 4 * H)).astype(np.float32) * 0.03,
            rng.normal(size=(4 * H,)).astype(np.float32) * 0.01,
            rng.normal(size=(B, H)).astype(np.float32) * 0.1,
            rng.normal(size=(B, H)).astype(np.float32) * 0.1)
    wh = rng.normal(size=(B, T, H)).astype(np.float32)
    wc = rng.normal(size=(B, H)).astype(np.float32)

    def loss_j(*a):
        hs, cf, hf = jax_scan(*a, 1.0, T, jd, True)
        return jnp.sum(hs * wh) + jnp.sum(cf * wc) + jnp.sum(hf * wc), (hs, cf, hf)

    (_, outs_j), grads_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    n0 = (ls.lstm_scan_fwd.launches, ls.lstm_scan_bwd.launches)
    hs, cf, hf = ls.lstm_scan(*leaves, 1.0, td)
    loss = ((hs * torch.from_numpy(wh)).sum() + (cf * torch.from_numpy(wc)).sum()
            + (hf * torch.from_numpy(wc)).sum())
    grads = torch.autograd.grad(loss, leaves)
    assert (ls.lstm_scan_fwd.launches, ls.lstm_scan_bwd.launches) == n0
    for got, want in zip((hs, cf, hf), outs_j):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5 if dtype == "fp32" else 2e-3)
    for got, want, name in zip(grads, grads_j, ["xs", "W", "b", "c0", "h0"]):
        if dtype == "fp32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-4,
                                       err_msg=name)
        else:
            assert _rel(got.numpy(), np.asarray(want)) <= 1e-2, name


class _Occupancy:
    """Stands in for the kernel library's occupancy query with the numbers
    of a 132-SM card.  A recurrence block with its Wh share resident (nu
    columns or rows x 4H, fp32 or bf16, plus the forward's 36 KB stage)
    fits once an SM from 114 KB (the forward at nu = 8, H = 1,024 in fp32),
    twice below, not at all past 227 KB; without its Wh share twice (none
    with ``no_room``)."""

    def __init__(self, no_room=False):
        self.calls, self.no_room = [], no_room

    def jlm_scan_recur_max_blocks(self, fwd, resident, bf16, nu, H, device):
        self.calls.append((fwd, resident, nu))
        smem = (nu * 4 * H * (2 if bf16 else 4) if resident else 0) + (36864 if fwd else 0)
        if self.no_room or smem > 232448:
            return 0
        return 132 if smem > 232448 // 2 else 264


@pytest.mark.parametrize("B,E,H,bwd,want", [
    (32, 256, 512, 0, (1, 4, 128, 1)),     # the 50k training shape: Wh columns resident
    (32, 256, 512, 1, (1, 4, 128, 1)),     # Wh rows resident, 4 units a block
    (32, 1024, 1024, 0, (1, 8, 128, 1)),   # H = E = 1,024: 8 units, 164 KB: one an SM
    (32, 1024, 1024, 1, (1, 8, 128, 1)),   # 8 units a block, 128 KB of Wh: one an SM
    (32, 2048, 2048, 0, (0, 8, 256, 1)),   # 256 KB of Wh a block: read from the L2
    (32, 2048, 2048, 1, (0, 8, 256, 1)),
    (4096, 1024, 1024, 1, (1, 8, 128, 1)),  # large batches: the carries are in device memory
    (16384, 16, 1024, 0, (1, 8, 128, 1)),   # the batch the forward once refused
    (16384, 16, 1024, 1, (1, 8, 128, 1)),
])
def test_lstm_scan_plan(monkeypatch, B, E, H, bwd, want):
    """``_plan`` keeps Wh's share resident where all H / nu blocks fit,
    whatever the batch, for the forward's recurrence (its 4 nu columns) and
    the backward's (its nu rows); else it reads Wh from the L2 with a grid
    that the card holds at once, each block owning ceil(H / nu / grid)
    groups."""
    from jlm_tpu_torch.ops import _build

    fake = _Occupancy()
    monkeypatch.setattr(_build, "lib", lambda: fake)
    cpu = torch.device("cpu")
    assert ls._plan(H, torch.float32, cpu, fwd=not bwd) == want
    resident, nu, grid, nvb = want
    assert grid * nvb * nu >= H and grid <= (132 if resident else 264)
    assert all(fwd == (not bwd) for fwd, _, _ in fake.calls)


def test_lstm_scan_plan_refuses_only_what_no_grid_holds(monkeypatch):
    """Neither recurrence refuses a batch (the forward at B = 16,384 plans:
    its carries are in device memory); a plan raises, with the reason, only
    where the card reports no room for even a block without Wh; the units a
    block must be 4 or 8 dividing H (the wrappers pad E and H to multiples
    of 4)."""
    from jlm_tpu_torch.ops import _build

    cpu = torch.device("cpu")
    monkeypatch.setattr(_build, "lib", lambda: _Occupancy())
    assert ls._plan(1024, torch.float32, cpu, fwd=True) == (1, 8, 128, 1)
    with pytest.raises(ValueError, match="4 or 8 units"):
        ls._plan(30, torch.float32, cpu, fwd=True)
    monkeypatch.setattr(_build, "lib", lambda: _Occupancy(no_room=True))
    for fwd in (True, False):
        with pytest.raises(ValueError, match="not one block"):
            ls._plan(1024, torch.float32, cpu, fwd=fwd)


@pytest.mark.parametrize("sms,want", [(132, [(1, 768), (1, 2048), (16, 128), (4, 1024)]),
                                      (114, [(1, 768), (1, 2048), (13, 160), (1, 4096)])])
@pytest.mark.parametrize("case", range(4))
def test_scan_gemm_plan(sms, want, case):
    """The fp32 GEMM's split of K at the training window's four shapes (M =
    B T = 1,024: ``scan_gates`` at H = 512 and 1,024, ``scan_dx`` at H =
    512 and 1,024) on a 132-SM and a 114-SM card: K is split only where
    the 128 x 128 tiles would leave more than half the SMs without a block,
    into ranges of whole 16-deep chunks (at least 8) that cover K exactly,
    as many as the card's two blocks an SM take."""
    M, N, K = [(1024, 2048, 768), (1024, 4096, 2048), (1024, 256, 2048),
               (1024, 1024, 4096)][case]
    splits, kc = ls._gemm_plan(M, N, K, sms)
    assert (splits, kc) == want[case]
    assert kc % 16 == 0 and kc >= min(K, 128) and (splits - 1) * kc < K <= splits * kc
    tiles = -(-M // 128) * -(-N // 128)
    assert (splits > 1) == (2 * tiles <= sms) and tiles * splits <= max(tiles, 2 * sms)


# weights: (quantized, JAX / port compute dtype, tolerance) -- bf16 operands
# on both sides, fp32 sums (test_torch_ops.py's 1e-3)
_HEADS = {
    "bf16": (False, jnp.bfloat16, torch.bfloat16, 1e-3),
    "dequant_bf16": (True, jnp.bfloat16, torch.bfloat16, 1e-3),
}


def _head_case(weights, H=1024, V=1000, R=8, seed=53):
    quantized, jd, td, tol = _HEADS[weights]
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(R, H)).astype(np.float32)
    w = rng.normal(size=(H, V)).astype(np.float32) * 0.05
    b = rng.normal(size=(V,)).astype(np.float32) * 0.01
    if quantized:
        q = quantize_weight(w, axis=0)
        wj, sj = jnp.asarray(q["q"]), jnp.asarray(q["scale"])
        wt, st = torch.from_numpy(q["q"]), torch.from_numpy(q["scale"])
    else:
        wj, sj, wt, st = jnp.asarray(w, jd), None, torch.from_numpy(w).to(td), None
    return h, b, (wj, sj), (wt, st), Config(vocab_size=V, embed_size=64, hidden_size=H)


@pytest.mark.parametrize("weights", list(_HEADS))
def test_project_lse_1024_matches_jax(weights):
    """A full head on a 1,024-wide slice, V = 1000 (ragged against every
    tile), bf16 weights or int8 weights dequantized to bf16, vs JAX's
    project_lse in interpret mode; project_ms merges to the same lse."""
    _, jd, td, tol = _HEADS[weights]
    h, b, (wj, sj), (wt, st), cfg = _head_case(weights)
    head_j = {"W": wj if sj is None else {"q": wj, "scale": sj}, "b": jnp.asarray(b)}
    head_t = port._full_head(wt, st, torch.from_numpy(b))
    lse_j = jax_project.project_lse(jnp.asarray(h), head_j, cfg, tile_v=512, compute_dtype=jd,
                                    interpret=True, int8_mxu=False)
    lse_t = port.project_lse(torch.from_numpy(h), head_t, cfg, compute_dtype=td,
                             int8_mxu=False)
    assert lse_t.shape == (8, 1)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j), atol=tol)
    m, s = port.project_ms(torch.from_numpy(h), head_t, cfg, compute_dtype=td, int8_mxu=False)
    np.testing.assert_allclose(_np(m + torch.log(s)), _np(lse_t), atol=1e-6)


@pytest.mark.parametrize("weights", list(_HEADS))
def test_project_candidates_1024_matches_jax(weights):
    """Candidate log-probs on a 1,024-wide slice: C = 40 ids with repeats,
    the vocab edges and a -1 (no column: -lse), vs JAX's
    project_candidates in interpret mode."""
    _, jd, td, tol = _HEADS[weights]
    h, b, (wj, sj), (wt, st), cfg = _head_case(weights, seed=54)
    rng = np.random.default_rng(55)
    cand = rng.integers(0, 1000, 40).astype(np.int32)
    cand[:5] = [0, 999, 321, 321, -1]
    out_j = jax_project.project_candidates(
        jnp.asarray(h), wj, sj, jnp.asarray(b), jnp.asarray(cand), tile_v=512,
        compute_dtype=jd, interpret=True, int8_mxu=False)
    out_t = port.project_candidates(torch.from_numpy(h), wt, st, torch.from_numpy(b),
                                    torch.from_numpy(cand), compute_dtype=td, int8_mxu=False)
    assert out_t.shape == (8, 40) and out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), atol=tol)
    np.testing.assert_array_equal(out_t[:, 2].numpy(), out_t[:, 3].numpy())
    lse = port.project_lse(torch.from_numpy(h), port._full_head(wt, st, torch.from_numpy(b)),
                           compute_dtype=td, int8_mxu=False)
    np.testing.assert_allclose(out_t[:, 4].numpy(), -lse[:, 0].numpy(), atol=1e-6)


def test_head_plan_widths():
    """The bf16 and dequant-bf16 plans take any slice width (the kernel
    streams h in K chunks; 1,056 here, padded to a multiple of 32); the
    int8-MXU plan takes a slice wider than 1,024 too (1,050, padded to
    1,152, a multiple of the streamed kernel's 128-wide K chunk), planned
    with the streamed kernel's tile (128 rows, 256 columns)."""
    for weights in _HEADS:
        _, _, _, (wt, st), _ = _head_case(weights, H=1050, V=64)
        head = port._full_head(wt, st, torch.zeros(64))
        head["WT"] = wt.t().contiguous()
        plan = port._block_plan(head, None, 1050, torch.device("cpu"), torch.bfloat16, False)
        assert plan[0][7] == 1056 and tuple(plan[0][2].shape) == (64, 1056)
    _, _, _, (wt, st), _ = _head_case("dequant_bf16", H=1050, V=64)
    head = port._full_head(wt, st, torch.zeros(64))
    head["WT"] = wt.t().contiguous()
    plan = port._block_plan(head, None, 1050, torch.device("cpu"), torch.bfloat16, True)
    assert plan[0][3] == port.INT8_MXU and plan[0][7] == 1152
    assert tuple(plan[0][2].shape) == (64, 1152)
    assert float(plan[0][2][:, 1050:].abs().max()) == 0.0
    assert port._int8_tile(1152) == (128, 256) and port._int8_tile(1024) == (128, 32)
    assert [port.int8_width(d) for d in (80, 1024, 1025, 1536, 2048)] == [128, 1024, 1152,
                                                                           1536, 2048]


@pytest.mark.parametrize("what", ["lse", "candidates"])
@pytest.mark.parametrize("H", [1050, 2048])
def test_project_int8_wide_matches_jax(H, what):
    """The int8-MXU head on a slice wider than the 1,024 its resident kernel
    holds (1,050, padded to 1,152; 2,048), V = 1000: the lse, and the
    candidate log-probs of 40 ids with repeats, the vocab edges and a -1,
    vs JAX's project_lse / project_candidates with ``int8_mxu=True`` in
    interpret mode; 1e-4 (the int32 products are exact on both sides, the
    per-row scale the same IEEE division; fp32 sums in another order)."""
    rng = np.random.default_rng(56)
    R, V = 8, 1000
    h = rng.normal(size=(R, H)).astype(np.float32)
    q = quantize_weight(rng.normal(size=(H, V)).astype(np.float32) * 0.05, axis=0)
    b = rng.normal(size=(V,)).astype(np.float32) * 0.01
    wj, sj = jnp.asarray(q["q"]), jnp.asarray(q["scale"])
    wt, st = torch.from_numpy(q["q"]), torch.from_numpy(q["scale"])
    kw_j = dict(tile_v=512, compute_dtype=jnp.bfloat16, interpret=True, int8_mxu=True)
    kw_t = dict(compute_dtype=torch.bfloat16, int8_mxu=True)
    if what == "lse":
        cfg = Config(vocab_size=V, embed_size=64, hidden_size=H)
        got = port.project_lse(torch.from_numpy(h), port._full_head(wt, st, torch.from_numpy(b)),
                               cfg, **kw_t)
        want = jax_project.project_lse(jnp.asarray(h), {"W": {"q": wj, "scale": sj},
                                                        "b": jnp.asarray(b)}, cfg, **kw_j)
        assert got.shape == (R, 1)
    else:
        cand = rng.integers(0, V, 40).astype(np.int32)
        cand[:5] = [0, V - 1, 321, 321, -1]
        got = port.project_candidates(torch.from_numpy(h), wt, st, torch.from_numpy(b),
                                      torch.from_numpy(cand), **kw_t)
        want = jax_project.project_candidates(jnp.asarray(h), wj, sj, jnp.asarray(b),
                                              jnp.asarray(cand), **kw_j)
        assert got.shape == (R, 40)
        np.testing.assert_array_equal(got[:, 2].numpy(), got[:, 3].numpy())
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)
