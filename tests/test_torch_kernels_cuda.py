"""The hand-written CUDA kernels vs their plain PyTorch versions, on the card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
The file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from jlm_tpu_torch.ops.quant import quantize_weight
from jlm_tpu_torch.ops.cand_dot import cand_dot, cand_dot_ref
from jlm_tpu_torch.ops.lstm_cell import lstm_cell_ref, lstm_cell_step
from jlm_tpu_torch.ops.project import (
    head_blocks, project_lse, project_lse_ref, project_ms, quantize_rows)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _lse_case(seed, B, H, V):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, H)).astype(np.float32)
    w = rng.normal(size=(H, V)).astype(np.float32) * 0.05
    b = rng.normal(size=(V,)).astype(np.float32) * 0.01
    return h, w, b


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "int8_fp32_act", "bf16"])
def test_project_kernel_vs_plain(cuda, mode):
    """Kernel vs plain version on the card, ragged vocab, rows not a
    multiple of the row tile; int8 weights take bf16 or fp32 activations.
    Bound 1e-4 (fp32 summation order)."""
    h, w, b = _lse_case(seed=6, B=300, H=256, V=5000)
    act = torch.float32 if mode == "int8_fp32_act" else torch.bfloat16
    h_t = torch.from_numpy(h).to(cuda).to(act)
    b_t = torch.from_numpy(b).to(cuda)
    if mode.startswith("int8"):
        q = quantize_weight(w, axis=0)
        W, scale = torch.from_numpy(q["q"]).to(cuda), torch.from_numpy(q["scale"]).to(cuda)
        head = {"W": {"q": W, "scale": scale}, "b": b_t}
    else:
        W, scale = torch.from_numpy(w).to(cuda).to(act), None
        head = {"W": W, "b": b_t}
    n0 = project_lse.launches
    got = project_lse(h_t, head, None, compute_dtype=act, int8_mxu=True)
    assert project_lse.launches == n0 + 1
    ref = project_lse_ref(h_t, head, compute_dtype=act, int8_mxu=True)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=1e-4)
    m, s = project_ms(h_t, head, None, compute_dtype=act, int8_mxu=True)
    assert project_lse.launches == n0 + 2
    np.testing.assert_allclose((m + torch.log(s)).cpu().numpy(), got.cpu().numpy(), atol=1e-6)


# (compute dtype, quantized, int8_mxu, bound): the kernel's weight modes
_BLOCK_MODES = {
    "bf16": (torch.bfloat16, False, False, 1e-4),
    "int8_mxu": (torch.bfloat16, True, True, 1e-4),
    "int8_dequant_bf16": (torch.bfloat16, True, False, 1e-4),
    "fp32": (torch.float32, False, False, 1e-4),
    "int8_dequant_fp32": (torch.float32, True, False, 1e-4),
}


def _tf32(x):
    """``x`` rounded to TF32's 10-bit mantissa (to nearest, ties to even)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def _wrong_lse(weights, h, head, cfg):
    """The plain version with the fault that the mode's bound must catch,
    or None: fp32 operands (the weights dequantized first) rounded to TF32;
    the bf16 dequant's exact int8 product rescaled after it instead of
    ``q * scale`` rounded to bf16 before it; the int8-MXU row scale taken
    over all H instead of each block's slice."""
    blocks = head_blocks(head, cfg, h.shape[1])

    def lse(logits):  # logits(h slice, block) -> [R, V_k]; merged over blocks
        parts = [torch.logsumexp(logits(h[:, off:off + d], blk) + blk["b"][None, :], 1,
                                 keepdim=True) for off, d, blk in blocks]
        return torch.logsumexp(torch.cat(parts, 1), 1, keepdim=True)

    def dequant(W):
        return W["q"].float() * W["scale"][None, :] if isinstance(W, dict) else W

    if weights in ("fp32", "int8_dequant_fp32"):
        return lse(lambda hs, blk: _tf32(hs) @ _tf32(dequant(blk["W"])))
    if weights == "int8_dequant_bf16":
        return lse(lambda hs, blk: hs.float() @ blk["W"]["q"].float()
                   * blk["W"]["scale"][None, :])
    if weights == "int8_mxu" and len(blocks) > 1:
        _, s = quantize_rows(h)
        return lse(lambda hs, blk: torch.round(hs.float() / s) @ blk["W"]["q"].float()
                   * s * blk["W"]["scale"][None, :])
    return None


@pytest.mark.cuda
@pytest.mark.parametrize("weights", list(_BLOCK_MODES))
@pytest.mark.parametrize("mode", ["full", "prefix", "disjoint"])
def test_project_kernel_modes_vs_plain(cuda, mode, weights):
    """Every weight mode on a full head and on D-softmax heads (one launch
    per block on its slice of h, read in place; one merge) vs the plain
    version on the card: 300 rows, ragged blocks.  The largest |h| of each
    row lies outside the narrower blocks' prefixes, so an int8-MXU row
    scale taken over all H would miss.  Weights of scale 0.5 make the
    softmax peaked, so that the lse moves with the rounding of its largest
    logits instead of averaging it away.  Bound 1e-4 (fp32 sums in another
    order; the same bf16 or int8 roundings on both sides); the plain
    version with the mode's likely fault (``_wrong_lse``) must read above
    it."""
    from jlm_tpu_torch.config import Config, DSoftmaxConfig

    cd, quantized, int8_mxu, bound = _BLOCK_MODES[weights]
    rng = np.random.default_rng(15)
    H, sizes = 256, (1000, 2000, 3001)
    dims = {"full": (H,), "prefix": (256, 128, 64), "disjoint": (128, 64, 64)}[mode]
    if mode == "full":
        sizes = (6001,)
    cfg = Config(vocab_size=sum(sizes), hidden_size=H, head="dsoftmax",
                 dsoftmax=DSoftmaxConfig(block_sizes=sizes, block_dims=dims,
                                         mode="disjoint" if mode == "disjoint" else "prefix"))
    h = rng.normal(size=(300, H)).astype(np.float32)
    h[:, 200] = 9.0
    blocks = []
    for n, d in zip(sizes, dims):
        w = rng.normal(size=(d, n)).astype(np.float32) * 0.5
        b = torch.from_numpy(rng.normal(size=n).astype(np.float32) * 0.01).to(cuda)
        if quantized:
            q = quantize_weight(w, axis=0)
            W = {"q": torch.from_numpy(q["q"]).to(cuda),
                 "scale": torch.from_numpy(q["scale"]).to(cuda)}
        else:
            W = torch.from_numpy(w).to(cuda).to(cd)
        blocks.append({"W": W, "b": b})
    head = blocks[0] if mode == "full" else {"blocks": blocks}
    h_t = torch.from_numpy(h).to(cuda).to(cd)
    n0 = project_lse.launches
    got = project_lse(h_t, head, cfg, compute_dtype=cd, int8_mxu=int8_mxu)
    assert project_lse.launches == n0 + len(blocks)
    ref = project_lse_ref(h_t, head, cfg, compute_dtype=cd, int8_mxu=int8_mxu)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=bound)
    wrong = _wrong_lse(weights, h_t, head, cfg)
    if wrong is not None:
        assert float((wrong - ref).abs().max()) > bound


@pytest.mark.cuda
@pytest.mark.parametrize("R,E,H", [
    (300, 64, 96),      # ragged rows; three 32-unit blocks
    (512, 256, 512),    # the fp32 parity run's frame
    (77, 1024, 1024),   # the widest training width, fewer rows than a block
    (77, 30, 20),       # E, H off the kernel's multiple of 32: padded, sliced back
])
def test_lstm_cell_fp32_kernel_vs_plain(cuda, R, E, H):
    """fp32 compute (exact fp32 FMAs): c' and h' fp32 within 1e-5 of the
    plain version (sum order only), c read as fp32 or bf16."""
    rng = np.random.default_rng(9)

    def t(*shape, scale=0.3):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale).to(cuda)

    x, h, c, W, b = t(R, E), t(R, H), t(R, H), t(E + H, 4 * H, scale=0.1), t(4 * H, scale=0.01)
    for c_in in (c, c.to(torch.bfloat16)):
        n0 = lstm_cell_step.launches
        c_k, h_k = lstm_cell_step(x, h, c_in, W, b, 1.0)
        assert lstm_cell_step.launches == n0 + 1
        assert c_k.dtype == h_k.dtype == torch.float32
        c_r, h_r = lstm_cell_ref(x, h, c_in, W, b, 1.0)
        np.testing.assert_allclose(c_k.cpu().numpy(), c_r.cpu().numpy(), atol=1e-5)
        np.testing.assert_allclose(h_k.cpu().numpy(), h_r.cpu().numpy(), atol=1e-5)
    # c' stored in bf16: c' rounded once (one bf16 ulp where a sum-order
    # difference meets a rounding boundary)
    c_b, _ = lstm_cell_step(x, h, c, W, b, 1.0, c_out_dtype=torch.bfloat16)
    c_r, _ = lstm_cell_ref(x, h, c, W, b, 1.0)
    assert c_b.dtype == torch.bfloat16
    np.testing.assert_allclose(c_b.float().cpu().numpy(), c_r.cpu().numpy(),
                               rtol=2.0 ** -7, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("c_out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_dtype", [torch.float32, torch.bfloat16])
def test_lstm_cell_kernel_vs_plain(cuda, c_dtype, c_out_dtype):
    """Kernel vs plain version on the card; bound: one bf16 rounding of h'
    (8e-3 at |h'| < 1), 1e-4 on fp32 c' and one bf16 rounding of a bf16 c'
    (8e-3 relative: |c'| reaches about 2 here)."""
    rng = np.random.default_rng(8)
    R, E, H = 300, 64, 96
    bf = torch.bfloat16

    def t(*shape, scale=0.3, dtype=bf):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale).to(cuda).to(dtype)

    x, h, c = t(R, E), t(R, H), t(R, H, dtype=c_dtype)
    W, b = t(E + H, 4 * H, scale=0.1), t(4 * H, scale=0.01, dtype=torch.float32)
    c_k, h_k = lstm_cell_step(x, h, c, W, b, 1.0, compute_dtype=bf, c_out_dtype=c_out_dtype)
    c_r, h_r = lstm_cell_ref(x, h, c, W, b, 1.0)
    assert c_k.dtype == c_out_dtype and h_k.dtype == bf
    if c_out_dtype == torch.float32:
        np.testing.assert_allclose(c_k.cpu().numpy(), c_r.cpu().numpy(), atol=1e-4)
    else:
        np.testing.assert_allclose(c_k.float().cpu().numpy(), c_r.cpu().numpy(),
                                   rtol=8e-3, atol=1e-4)
    np.testing.assert_allclose(h_k.float().cpu().numpy(), h_r.cpu().numpy(), atol=8e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cand_dot_kernel_vs_plain(cuda, dtype):
    """Kernel vs plain version on the card; bound 1e-4 (fp32 sums)."""
    rng = np.random.default_rng(12)
    S, B, C1, H = 37, 10, 65, 512
    h3 = torch.from_numpy(rng.normal(size=(S, B, H)).astype(np.float32) * 0.3).to(cuda).to(dtype)
    cols = torch.from_numpy(rng.normal(size=(S, C1, H)).astype(np.float32) * 0.3).to(cuda).to(dtype)
    bias = torch.from_numpy(rng.normal(size=(S, C1)).astype(np.float32)).to(cuda)
    np.testing.assert_allclose(cand_dot(h3, cols, bias).cpu().numpy(),
                               cand_dot_ref(h3, cols, bias).cpu().numpy(), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,B,C1,H", [
    (7, 10, 65, 136),     # H padded to the K step (144 bf16, 136 fp32)
    (7, 20, 65, 136),     # two beam groups
    (5, 10, 300, 64),     # two candidate groups (256 + 44)
    (9, 10, 65, 1024),    # K chunks of 1 KB a row: 2 a sentence in bf16, 4 in fp32
    (3000, 10, 65, 512),  # more sentences than the persistent grid
    (4, 1, 1, 16),        # one beam row, one candidate
])
def test_cand_dot_kernel_shapes(cuda, S, B, C1, H, dtype):
    """cand_dot's ring (bulk copies a row, mma.sync in bf16, whole dots in
    fp32) at ragged shapes vs the plain version: 1e-4 abs (fp32 sums of the
    same products in another order); one launch a group of beams and
    candidates."""
    rng = np.random.default_rng(36)

    def t(*shape, dt=dtype):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.3).to(cuda).to(dt)

    h3, cols, bias = t(S, B, H), t(S, C1, H), t(S, C1, dt=torch.float32)
    n0 = cand_dot.launches
    got = cand_dot(h3, cols, bias)
    assert cand_dot.launches == n0 + (-(-B // 16)) * (-(-C1 // 256))
    assert got.shape == (S, B, C1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), cand_dot_ref(h3, cols, bias).cpu().numpy(),
                               atol=1e-4)


def _ce_case(cuda, seed, N, D, V, neg_every=0, scale=0.05):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.uniform(-1, 1, (N, D)).astype(np.float32)).to(cuda)
    W = torch.from_numpy(rng.normal(0, scale, (D, V)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.normal(0, 0.1, V).astype(np.float32)).to(cuda)
    y = rng.integers(0, V, N)
    if neg_every:
        y[::neg_every] = -1
    g = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(cuda)
    return h, W, b, torch.from_numpy(y).to(cuda), g


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,V,neg_every", [
    (1024, 512, 50_000, 0),   # the training shape
    (300, 256, 1000, 7),      # ragged rows and vocab tile, -1 targets
    (77, 128, 1001, 3),       # vocab not a multiple of 8 (padded W)
    (200, 640, 3001, 5),      # a slice over 512: K chunks of 512 and 128, two dh/dW slices
    (70, 1024, 2003, 4),      # H = 1,024: two full chunks; ragged rows and vocab
    (129, 512, 5000, 6),      # one row past two 64-row tiles
    (300, 384, 3000, 0),      # a 384-wide slice (192 columns a warpgroup)
    (1024, 128, 8003, 9),     # config 5's 128 and 256 blocks, a ragged vocab tile
    (1024, 256, 8003, 0),
    (8, 2048, 300, 3),        # rows, vocab under one tile; four slices, rows streamed
])
def test_ce_kernels_vs_plain(cuda, N, D, V, neg_every):
    """ce_fwd, ce_bwd_dh and ce_bwd_dw vs their plain versions on the same
    bf16-rounded inputs.  Bounds: m + log s and t within 1e-4 abs (fp32
    sums in another order); dh, dW and db within 1e-3 of their largest
    magnitude (gp is rounded to bf16 on both sides and may round the other
    way on a boundary)."""
    from jlm_tpu_torch.ops import softmax_ce as ce

    bf = torch.bfloat16
    h, W, b, y, g = _ce_case(cuda, 13, N, D, V, neg_every)
    n0 = (ce.ce_fwd_raw.launches, ce.ce_bwd_dh.launches, ce.ce_bwd_dw.launches)
    m, s, t = ce.ce_fwd_raw(h, W, b, y, bf)
    mp, sp, tp = ce.ce_fwd_raw_ref(h, W, b, y, bf)
    lse = mp + torch.log(sp)
    assert float((m + torch.log(s) - lse).abs().max()) <= 1e-4
    assert float((t - tp).abs().max()) <= 1e-4
    if neg_every:
        assert float(t[::neg_every].abs().max()) == 0.0
    dh = ce.ce_bwd_dh(h, W, b, y, lse, g, -g, bf)
    dW, db = ce.ce_bwd_dw(h, W, b, y, lse, g, -g, bf)
    assert (ce.ce_fwd_raw.launches, ce.ce_bwd_dh.launches, ce.ce_bwd_dw.launches) == \
        tuple(n + 1 for n in n0)
    torch.cuda.synchronize()
    assert _rel(dh, ce.ce_bwd_dh_ref(h, W, b, y, lse, g, -g, bf)) <= 1e-3
    dWp, dbp = ce.ce_bwd_dw_ref(h, W, b, y, lse, g, -g, bf)
    assert dW.shape == (D, V) and db.shape == (V,)
    assert _rel(dW, dWp) <= 1e-3 and _rel(db, dbp) <= 1e-3
    # gb = 0: the p-term alone (the one-hot term sets max |plain| above)
    zero = torch.zeros_like(g)
    assert _rel(ce.ce_bwd_dh(h, W, b, y, lse, g, zero, bf),
                ce.ce_bwd_dh_ref(h, W, b, y, lse, g, zero, bf)) <= 1e-3
    for got, want in zip(ce.ce_bwd_dw(h, W, b, y, lse, g, zero, bf),
                         ce.ce_bwd_dw_ref(h, W, b, y, lse, g, zero, bf)):
        assert _rel(got, want) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("V", [1001, 50_000])
@pytest.mark.parametrize("N", [7, 1000, 1024])
@pytest.mark.parametrize("D", [96, 128, 512, 1024])
def test_ce_fwd_kernel_vs_plain(cuda, D, N, V):
    """The bf16 forward (wgmma over W^T) vs its plain version, every third
    target -1 (owned by no column) and one past V: m + log s and t within
    1e-4 abs (fp32 sums in another order), t = 0 where no column owns the
    target; the same bits with the W^T the caller made (``wt=``), one
    launch each, one cast of W where the wrapper made it."""
    from jlm_tpu_torch.ops import softmax_ce as ce

    bf = torch.bfloat16
    h, W, b, y, _ = _ce_case(cuda, 33, N, D, V, neg_every=3)
    y[1 % N] = V
    n0, c0 = ce.ce_fwd_raw.launches, ce.cast_wt.launches
    m, s, t = ce.ce_fwd_raw(h, W, b, y, bf)
    assert (ce.ce_fwd_raw.launches, ce.cast_wt.launches) == (n0 + 1, c0 + 1)
    mp, sp, tp = ce.ce_fwd_raw_ref(h, W, b, y, bf)
    assert float((m + torch.log(s) - mp - torch.log(sp)).abs().max()) <= 1e-4
    assert float((t - tp).abs().max()) <= 1e-4
    assert float(t[::3].abs().max()) == 0.0 and float(t[1 % N]) == 0.0
    wt = ce.cast_wt(W, -(-D // 128) * 128)
    again = ce.ce_fwd_raw(h, W, b, y, bf, wt=wt)
    assert ce.ce_fwd_raw.launches == n0 + 2
    for a, w, name in zip(again, (m, s, t), "mst"):
        assert torch.equal(a, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,D,V", [(1024, 512, 50_000), (1000, 1024, 50_000), (7, 128, 1001)])
def test_ce_forward_is_deterministic(cuda, N, D, V, dtype):
    """Two calls of the forward (bf16, or exact fp32) on the same inputs
    give bit-identical (m, s, t): each split's partials are written once and
    merged in split order, each target logit by one thread, no atomics."""
    from jlm_tpu_torch.ops import softmax_ce as ce

    h, W, b, y, _ = _ce_case(cuda, 34, N, D, V, neg_every=4)
    first, again = (ce.ce_fwd_raw(h, W, b, y, dtype) for _ in range(2))
    for a, w, name in zip(first, again, "mst"):
        assert torch.equal(a, w), name


@pytest.mark.cuda
def test_ce_loss_fused_casts_w_once_a_step(cuda):
    """``ce_loss_fused`` in bf16: one ``cast_wt`` a step, its W^T read by
    the forward and kept for the backward, whose grads are bit-equal to
    ``ce_bwd`` casting W itself; the D-softmax fused CE casts once a block."""
    from jlm_tpu_torch.ops import softmax_ce as ce

    bf = torch.bfloat16
    h, W, b, y, g = _ce_case(cuda, 35, 300, 256, 5000, neg_every=5)
    leaves = [a.clone().requires_grad_(True) for a in (h, W, b)]
    counts = (ce.cast_wt.launches, ce.ce_fwd_raw.launches, ce.ce_bwd_dh.launches,
              ce.ce_bwd_dw.launches)
    loss = ce.ce_loss_fused(*leaves[:2], leaves[2], y, bf)
    grads = torch.autograd.grad(loss, leaves, g)
    assert (ce.cast_wt.launches, ce.ce_fwd_raw.launches, ce.ce_bwd_dh.launches,
            ce.ce_bwd_dw.launches) == tuple(n + 1 for n in counts)
    m, s, _ = ce.ce_fwd_raw(h, W, b, y, bf)
    want = ce.ce_bwd(h, W, b, y, m + torch.log(s), g, None, bf)
    for got, w, name in zip(grads, want, "hWb"):
        assert torch.equal(got, w), name
    blocks = [(torch.randn(d, n, device=cuda) * 0.05, torch.randn(n, device=cuda) * 0.1)
              for n, d in ((1000, 256), (3000, 128))]
    yd = torch.randint(0, 4000, (300,), device=cuda)
    c0 = ce.cast_wt.launches
    rows = ce.ce_loss_fused_dsoftmax(h.requires_grad_(True), [w for w, _ in blocks],
                                     [bb for _, bb in blocks], yd, (1000, 3000), (256, 128),
                                     "prefix", bf)
    torch.autograd.grad(rows.sum(), h)
    assert ce.cast_wt.launches == c0 + len(blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_cast_wt_kernel_vs_plain(cuda, wdtype):
    """cast_wt_kernel (the bf16 backward's transposing cast of W) is
    bit-equal to its plain version, zero columns past D included."""
    from jlm_tpu_torch.ops import softmax_ce as ce

    _, W, _, _, _ = _ce_case(cuda, 17, 8, 96, 1001)
    W = W.to(wdtype)
    assert torch.equal(ce.cast_wt(W, 128), ce.cast_wt(W.cpu(), 128).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,V", [(1024, 512, 50_000), (129, 1024, 3001)])
def test_ce_backward_is_deterministic(cuda, N, D, V):
    """Two calls of ce_bwd_dh and ce_bwd_dw in bf16 on the same inputs give
    bit-identical dh, dW and db (no atomics; split partials summed in
    split order)."""
    from jlm_tpu_torch.ops import softmax_ce as ce

    bf = torch.bfloat16
    h, W, b, y, g = _ce_case(cuda, 15, N, D, V, 5)
    m, s = ce.ce_fwd_raw_ref(h, W, b, y, bf)[:2]
    lse = m + torch.log(s)
    first = (ce.ce_bwd_dh(h, W, b, y, lse, g, -g, bf),) + ce.ce_bwd_dw(h, W, b, y, lse, g, -g, bf)
    again = (ce.ce_bwd_dh(h, W, b, y, lse, g, -g, bf),) + ce.ce_bwd_dw(h, W, b, y, lse, g, -g, bf)
    for a, b2, name in zip(first, again, ("dh", "dW", "db")):
        assert torch.equal(a, b2), name


@pytest.mark.cuda
def test_ce_fused_dsoftmax_block_slices_vs_plain(cuda):
    """ce_loss_fused_dsoftmax on the card (blocks project h[:, :d] slices of
    512, 256 and 128 dims) vs plain CE over head_logits: loss within 1e-3
    abs, grads within 1e-2 of their largest magnitude (bf16 compute against
    fp32 logits)."""
    from jlm_tpu_torch.config import Config, default_dsoftmax_blocks
    from jlm_tpu_torch.models.heads import full_softmax_loss

    cfg = Config(vocab_size=8000, hidden_size=512, head="dsoftmax", fused_ce=True,
                 dsoftmax=default_dsoftmax_blocks(8000, 512))
    rng = np.random.default_rng(14)
    blocks = [{"W": torch.from_numpy(rng.normal(0, 0.05, (d, s)).astype(np.float32)).to(cuda),
               "b": torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32)).to(cuda)}
              for s, d in zip(cfg.dsoftmax.block_sizes, cfg.dsoftmax.block_dims)]
    hs = torch.from_numpy(rng.uniform(-1, 1, (4, 64, 512)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.integers(0, 8000, (4, 64))).to(cuda)
    y[0, :3] = torch.tensor([0, 1279, 1280], device=cuda)  # block edges

    def run(c):
        leaves = [hs] + [blk[k] for blk in blocks for k in ("W", "b")]
        for leaf in leaves:
            leaf.grad = None
            leaf.requires_grad_(True)
        loss = full_softmax_loss({"head": {"blocks": blocks}}, c, hs, y)
        return (loss, *torch.autograd.grad(loss, leaves))

    got, want = run(cfg), run(cfg.replace(fused_ce=False))
    assert abs(got[0].item() - want[0].item()) <= 1e-3
    for a, w in zip(got[1:], want[1:]):
        assert _rel(a, w) <= 1e-2


def _scan_case(cuda, seed, B, T, E, H):
    rng = np.random.default_rng(seed)

    def t(*shape, scale):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale).to(cuda)

    return (t(B, T, E, scale=0.3), t(E + H, 4 * H, scale=0.05), t(4 * H, scale=0.1),
            t(B, H, scale=0.3), t(B, H, scale=0.3))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,E,H", [
    (32, 32, 256, 512),   # the training shape
    (40, 5, 64, 96),      # a second pass of batch rows, ragged
    (3, 7, 512, 512),     # a second layer's input width (E = H)
    (32, 4, 1024, 1024),  # H = E = 1,024: 8 units a block, Wh resident
    (5, 3, 2048, 512),    # E > H
])
def test_lstm_scan_kernels_vs_plain(cuda, B, T, E, H):
    """lstm_scan_fwd and lstm_scan_bwd vs their plain versions on the card,
    fp32 compute (exact fp32 products on both sides).  Bounds: hs, cs, c_T,
    h_T within 1e-5 abs (fp32 sums in another order); dz, dx, dc0, dh0
    within 2e-4 abs + 1e-4 rel (the reference tests' gradient bound).  The
    forward launches each of its two kernels once, the backward each of its
    three."""
    from jlm_tpu_torch.ops import lstm_scan as ls

    xs, W, b, c0, h0 = _scan_case(cuda, 21, B, T, E, H)
    n0 = (ls.lstm_scan_fwd.launches, ls.lstm_scan_bwd.launches)
    stages = (ls.scan_xw, ls.scan_fwd_recur, ls.scan_gates, ls.scan_recur, ls.scan_dx)
    s0 = [fn.launches for fn in stages]
    got = ls.lstm_scan_fwd(xs, W, b, c0, h0, 1.0)
    want = ls.lstm_scan_ref(xs, W, b, c0, h0, 1.0)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-5, rtol=0)
    hs, cs = want[0], want[1]
    rng = np.random.default_rng(22)
    d_hs, d_cf, d_hf = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)
                        for s in ((B, T, H), (B, H), (B, H)))
    got = ls.lstm_scan_bwd(xs, W, b, c0, h0, hs, cs, d_hs, d_cf, d_hf, 1.0)
    want = ls.lstm_scan_bwd_ref(xs, W, b, c0, h0, hs, cs, d_hs, d_cf, d_hf, 1.0)
    assert (ls.lstm_scan_fwd.launches, ls.lstm_scan_bwd.launches) == (n0[0] + 1, n0[1] + 1)
    assert [fn.launches for fn in stages] == [n + 1 for n in s0]
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=2e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("B,T,E,H", [
    (1, 3, 64, 96),      # one batch row: ragged GEMM tiles, a warp's rows past B
    (33, 3, 64, 96),     # a second pass of dh rows, ragged
    (200, 3, 128, 256),  # several passes; 200 rows of GEMM tiles
    (3, 4, 64, 2048),    # H = 2,048: Wh's rows read from the L2 each step
])
def test_lstm_scan_bwd_stages_vs_plain(cuda, B, T, E, H, dtype):
    """scan_gates, scan_recur and scan_dx vs their plain versions on the
    same inputs, one launch each.  Bounds: Z and dx within 1e-5 of their
    largest magnitude (the same rounded operands on both sides, products
    exact in fp32; sums in another order); dz, dc0, dh0 within 2e-4 abs +
    1e-4 rel (fp32) or 1e-2 of the largest magnitude (bf16: a flipped bf16
    rounding of dz is carried back through the window)."""
    from jlm_tpu_torch.ops import lstm_scan as ls

    cd = torch.float32 if dtype == "fp32" else torch.bfloat16
    xs, W, b, c0, h0 = _scan_case(cuda, 26, B, T, E, H)
    hs, cs = ls.lstm_scan_ref(xs, W, b, c0, h0, 1.0, cd)[:2]
    rng = np.random.default_rng(27)
    d_hs, d_cf, d_hf = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)
                        for s in ((B, T, H), (B, H), (B, H)))
    xh = torch.cat([xs, torch.cat([h0[:, None], hs[:, :-1]], dim=1)], dim=2)
    stages = (ls.scan_gates, ls.scan_recur, ls.scan_dx)
    n0 = [fn.launches for fn in stages]
    Z = ls.scan_gates(xh, W, b, cd)
    Zp = ls.scan_gates_ref(xh, W, b, cd)
    got = ls.scan_recur(Zp, W[E:], c0, cs, d_hs, d_cf, d_hf, 1.0, cd, out=torch.empty_like(Zp))
    want = ls.scan_recur_ref(Zp, W[E:], c0, cs, d_hs, d_cf, d_hf, 1.0, cd)
    dx = ls.scan_dx(want[0], W[:E], cd)
    assert [fn.launches for fn in stages] == [n + 1 for n in n0]
    torch.cuda.synchronize()
    assert _rel(Z, Zp) <= 1e-5
    assert _rel(dx, ls.scan_dx_ref(want[0], W[:E], cd)) <= 1e-5
    for a, w in zip(got, want):
        if dtype == "fp32":
            torch.testing.assert_close(a, w, atol=2e-4, rtol=1e-4)
        else:
            assert _rel(a, w) <= 1e-2


@pytest.mark.cuda
def test_lstm_scan_bf16_and_autograd_vs_plain(cuda):
    """bf16 compute: hs within 2e-3 abs of the plain bf16 scan (an fp32
    sum-order difference can flip one bf16 rounding of h_{t-1}, which later
    steps carry); and every input's gradient through the autograd Function
    (both kernels) vs autograd through the plain fp32 scan within 2e-4 abs
    + 1e-4 rel."""
    from jlm_tpu_torch.ops import lstm_scan as ls

    bf = torch.bfloat16
    xs, W, b, c0, h0 = _scan_case(cuda, 23, 32, 32, 256, 512)
    got = ls.lstm_scan_fwd(xs, W, b, c0, h0, 1.0, bf)[0]
    want = ls.lstm_scan_ref(xs, W, b, c0, h0, 1.0, bf)[0]
    torch.testing.assert_close(got, want, atol=2e-3, rtol=0)

    leaves = [t.clone().requires_grad_(True) for t in (xs, W, b, c0, h0)]
    rng = np.random.default_rng(24)
    wh = torch.from_numpy(rng.normal(size=(32, 32, 512)).astype(np.float32)).to(cuda)
    wc = torch.from_numpy(rng.normal(size=(32, 512)).astype(np.float32)).to(cuda)

    def grads(scan):
        hs, c_T, h_T = scan(*leaves)
        loss = (hs * wh).sum() + (c_T * wc).sum() + (h_T * wc).sum()
        return torch.autograd.grad(loss, leaves)

    got = grads(lambda *a: ls.lstm_scan(*a, 1.0))
    want = grads(lambda *a: [ls.lstm_scan_ref(*a, 1.0)[i] for i in (0, 2, 3)])
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=2e-4, rtol=1e-4)


@pytest.mark.cuda
def test_lstm_scan_refuses_what_it_cannot_take(cuda):
    """The shapes once refused launch and match the plain versions (the
    bounds of test_lstm_scan_kernels_vs_plain): 32 dx columns for 4 unit
    groups (E = 128, H = 16); H = E = 1,024 in bf16 (forward within 2e-3
    abs, backward within 1e-2 of max |plain|); and B = 16,384 at H = 1,024,
    which both directions take (their carries live in device memory): the
    forward within 1e-5 abs of ``lstm_scan_ref``, the backward within 2e-4
    abs + 1e-4 rel."""
    from jlm_tpu_torch.ops import lstm_scan as ls

    xs, W, b, c0, h0 = _scan_case(cuda, 25, 2, 3, 128, 16)
    hs, cs, _, _ = ls.lstm_scan_ref(xs, W, b, c0, h0)
    got = ls.lstm_scan_bwd(xs, W, b, c0, h0, hs, cs, hs, c0, h0)
    for a, w in zip(got, ls.lstm_scan_bwd_ref(xs, W, b, c0, h0, hs, cs, hs, c0, h0)):
        torch.testing.assert_close(a, w, atol=2e-4, rtol=1e-4)
    bf = torch.bfloat16
    xs, W, b, c0, h0 = _scan_case(cuda, 25, 32, 4, 1024, 1024)
    got = ls.lstm_scan_fwd(xs, W, b, c0, h0, 1.0, bf)
    want = ls.lstm_scan_ref(xs, W, b, c0, h0, 1.0, bf)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=2e-3, rtol=0)
    hs, cs = want[0], want[1]
    got = ls.lstm_scan_bwd(xs, W, b, c0, h0, hs, cs, hs, c0, h0, 1.0, bf)
    want = ls.lstm_scan_bwd_ref(xs, W, b, c0, h0, hs, cs, hs, c0, h0, 1.0, bf)
    for a, w in zip(got, want):
        assert _rel(a, w) <= 1e-2
    xs, W, b, c0, h0 = _scan_case(cuda, 25, 16384, 1, 16, 1024)
    got = ls.lstm_scan_fwd(xs, W, b, c0, h0)
    want = ls.lstm_scan_ref(xs, W, b, c0, h0)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-5, rtol=0)
    hs, cs, _, _ = want
    got = ls.lstm_scan_bwd(xs, W, b, c0, h0, hs, cs, hs, c0, h0)
    for a, w in zip(got, ls.lstm_scan_bwd_ref(xs, W, b, c0, h0, hs, cs, hs, c0, h0)):
        torch.testing.assert_close(a, w, atol=2e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("B,T,E,H", [
    (32, 8, 256, 512),    # the training width: 4 units a block
    (32, 4, 1024, 1024),  # H = E = 1,024: 8 units a block
    (40, 3, 64, 96),      # two tiles of batch rows, ragged; H not a multiple of 256
    (3, 4, 64, 2048),     # H = 2,048: Wh's columns read from the L2 each step
])
def test_lstm_scan_fwd_stages_vs_plain(cuda, B, T, E, H, dtype):
    """scan_xw and scan_fwd_recur vs their plain versions on the same
    inputs, one launch each.  Bounds: Zx within 1e-5 of its largest
    magnitude (the same rounded operands on both sides, products exact in
    fp32; sums in another order); hs, cs, c_T, h_T within 1e-5 abs (fp32)
    or 2e-3 abs (bf16: a flipped bf16 rounding of h_{t-1} is carried)."""
    from jlm_tpu_torch.ops import lstm_scan as ls

    cd = torch.float32 if dtype == "fp32" else torch.bfloat16
    xs, W, b, c0, h0 = _scan_case(cuda, 28, B, T, E, H)
    n0 = [fn.launches for fn in (ls.scan_xw, ls.scan_fwd_recur)]
    Zx = ls.scan_xw(xs, W[:E], cd)
    Zp = ls.scan_xw_ref(xs, W[:E], cd)
    got = ls.scan_fwd_recur(Zp, W[E:], b, c0, h0, 1.0, cd)
    want = ls.scan_fwd_recur_ref(Zp, W[E:], b, c0, h0, 1.0, cd)
    assert [fn.launches for fn in (ls.scan_xw, ls.scan_fwd_recur)] == [n + 1 for n in n0]
    torch.cuda.synchronize()
    assert _rel(Zx, Zp) <= 1e-5
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-5 if dtype == "fp32" else 2e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kn", [True, False])
@pytest.mark.parametrize("M,N,K", [
    (1024, 2048, 768),   # scan_gates at H = 512: K split in 2
    (1024, 4096, 2048),  # scan_gates at H = 1,024: no split
    (1024, 256, 2048),   # scan_dx at H = 512: K split in 16
    (1024, 1024, 4096),  # scan_dx at H = 1,024: K split in 4
    (200, 100, 36),      # ragged tiles, K off the 16-deep chunk
    (33, 8, 3000),       # one tile, K split with a ragged last range
])
def test_scan_gemm_split_k_vs_plain(cuda, M, N, K, kn):
    """The fp32 GEMM (``scan_gates`` for B [K, N] with its bias, ``scan_dx``
    for B given as [N, K]) at shapes that take and that skip the split of
    K, within 1e-5 of max |plain| (exact fp32 FMAs, sums in another
    order), with TF32 off on the plain side."""
    from jlm_tpu_torch.ops import lstm_scan as ls

    rng = np.random.default_rng(M + N + K)
    A = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(cuda)
    if kn:
        Wm = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32) * 0.05).to(cuda)
        b = torch.from_numpy(rng.normal(size=(N,)).astype(np.float32)).to(cuda)
        got, want = ls.scan_gates(A, Wm, b), ls.scan_gates_ref(A, Wm, b)
    else:
        Wm = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32) * 0.05).to(cuda)
        got, want = ls.scan_dx(A, Wm), ls.scan_dx_ref(A, Wm)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (M, N)
    assert _rel(got, want) <= 1e-5


@pytest.mark.cuda
def test_lstm_scan_pads_e_and_h(cuda):
    """E = H = 30 (not multiples of 4): the wrappers pad both to 32 and
    drop the padding; forward within 1e-5 abs and backward within 2e-4 abs
    + 1e-4 rel of the plain versions at the unpadded shapes, one launch of
    each kernel."""
    from jlm_tpu_torch.ops import lstm_scan as ls

    xs, W, b, c0, h0 = _scan_case(cuda, 29, 5, 6, 30, 30)
    n0 = (ls.lstm_scan_fwd.launches, ls.lstm_scan_bwd.launches)
    got = ls.lstm_scan_fwd(xs, W, b, c0, h0, 1.0)
    want = ls.lstm_scan_ref(xs, W, b, c0, h0, 1.0)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        torch.testing.assert_close(a, w, atol=1e-5, rtol=0)
    hs, cs = want[0], want[1]
    rng = np.random.default_rng(30)
    d_hs, d_cf, d_hf = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)
                        for s in ((5, 6, 30), (5, 30), (5, 30)))
    got = ls.lstm_scan_bwd(xs, W, b, c0, h0, hs, cs, d_hs, d_cf, d_hf, 1.0)
    want = ls.lstm_scan_bwd_ref(xs, W, b, c0, h0, hs, cs, d_hs, d_cf, d_hf, 1.0)
    assert (ls.lstm_scan_fwd.launches, ls.lstm_scan_bwd.launches) == (n0[0] + 1, n0[1] + 1)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        torch.testing.assert_close(a, w, atol=2e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,V,neg_every", [
    (1024, 512, 50_000, 0),   # the training shape
    (300, 256, 1000, 7),      # ragged rows and vocab tile, -1 targets
    (77, 128, 1001, 3),       # vocab not a multiple of 8
    (200, 640, 3001, 5),      # a slice over 512 (K chunks, dh/dW slices)
    (70, 1024, 2003, 4),      # H = 1,024
])
def test_ce_fp32_kernels_vs_plain(cuda, N, D, V, neg_every):
    """fp32 compute (``precision="highest"``): ce_fwd, ce_bwd_dh and
    ce_bwd_dw vs their plain fp32 versions, TF32 off on both sides.
    Bounds: m + log s and t within 1e-5 abs, dh, dW and db within 1e-5 of
    their largest magnitude (exact fp32 products; fp32 sums in another
    order)."""
    from jlm_tpu_torch.ops import softmax_ce as ce

    f32 = torch.float32
    h, W, b, y, g = _ce_case(cuda, 16, N, D, V, neg_every)
    n0 = (ce.ce_fwd_raw.launches, ce.ce_bwd_dh.launches, ce.ce_bwd_dw.launches)
    m, s, t = ce.ce_fwd_raw(h, W, b, y, f32)
    mp, sp, tp = ce.ce_fwd_raw_ref(h, W, b, y, f32)
    lse = mp + torch.log(sp)
    assert float((m + torch.log(s) - lse).abs().max()) <= 1e-5
    assert float((t - tp).abs().max()) <= 1e-5
    if neg_every:
        assert float(t[::neg_every].abs().max()) == 0.0
    dh = ce.ce_bwd_dh(h, W, b, y, lse, g, -g, f32)
    dW, db = ce.ce_bwd_dw(h, W, b, y, lse, g, -g, f32)
    assert (ce.ce_fwd_raw.launches, ce.ce_bwd_dh.launches, ce.ce_bwd_dw.launches) == \
        tuple(n + 1 for n in n0)
    torch.cuda.synchronize()
    assert _rel(dh, ce.ce_bwd_dh_ref(h, W, b, y, lse, g, -g, f32)) <= 1e-5
    dWp, dbp = ce.ce_bwd_dw_ref(h, W, b, y, lse, g, -g, f32)
    assert dW.shape == (D, V) and db.shape == (V,)
    assert _rel(dW, dWp) <= 1e-5 and _rel(db, dbp) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("N,V", [(77, 1001), (129, 5003), (300, 1001), (1000, 5003)])
def test_ce_fwd_fp32_ragged_vs_plain(cuda, N, V):
    """The fp32 forward at ragged shapes (N not a multiple of the 128-row
    block, V not of 4, so W is padded, nor of the 128-column tile) at a
    D-softmax block's width, D = 128, a third of the targets -1 and one
    target = V, on weights of scale 0.5 (a peaked softmax): m + log s and t
    within 1e-5 abs of the plain fp32 version with TF32 off (exact fp32
    products, sums in another order), t = 0 where no column owns the
    target, one launch a call."""
    from jlm_tpu_torch.ops import softmax_ce as ce

    f32 = torch.float32
    h, W, b, y, _ = _ce_case(cuda, 35, N, 128, V, neg_every=3, scale=0.5)
    y[1] = V
    n0 = ce.ce_fwd_raw.launches
    m, s, t = ce.ce_fwd_raw(h, W, b, y, f32)
    assert ce.ce_fwd_raw.launches == n0 + 1
    mp, sp, tp = ce.ce_fwd_raw_ref(h, W, b, y, f32)
    assert float((m + torch.log(s) - mp - torch.log(sp)).abs().max()) <= 1e-5
    assert float((t - tp).abs().max()) <= 1e-5
    assert float(t[::3].abs().max()) == 0.0 and float(t[1]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,V", [
    (77, 128, 1001),     # a D-softmax block's width: 256 rows a block
    (300, 256, 3001),    # 128 rows a block
    (129, 512, 5003),    # 64 rows: one row past two blocks; V not a multiple of 4
    (200, 640, 2003),    # 32 rows a block, 640 of the 1,024 columns a block can hold
    (70, 1024, 2003),    # H = 1,024: 32 rows a block, the logits over all of D
    (37, 2048, 300),     # past 1,024: two output slices, each forming the logits
])
def test_ce_fp32_backward_general_cotangent_vs_plain(cuda, N, D, V):
    """The fp32 backward (``ce_bwd_dh``, ``ce_bwd_dw``) with a general
    cotangent ``gp = ga p + gb onehot(y)`` (ga and gb independent), a third
    of the targets -1, on weights of scale 0.5, at ragged shapes (N not a
    multiple of a block's rows, V not of a tile's columns): dh, dW and db
    within 1e-4 of the largest magnitude of the plain fp32 versions (exact
    fp32 products, sums in another order)."""
    from jlm_tpu_torch.ops import softmax_ce as ce

    f32 = torch.float32
    h, W, b, y, ga = _ce_case(cuda, 21, N, D, V, neg_every=3, scale=0.5)
    gb = torch.from_numpy(np.random.default_rng(22).normal(size=N).astype(np.float32)).to(cuda)
    mp, sp, _ = ce.ce_fwd_raw_ref(h, W, b, y, f32)
    lse = mp + torch.log(sp)
    n0 = (ce.ce_bwd_dh.launches, ce.ce_bwd_dw.launches)
    dh = ce.ce_bwd_dh(h, W, b, y, lse, ga, gb, f32)
    dW, db = ce.ce_bwd_dw(h, W, b, y, lse, ga, gb, f32)
    torch.cuda.synchronize()
    assert (ce.ce_bwd_dh.launches, ce.ce_bwd_dw.launches) == (n0[0] + 1, n0[1] + 1)
    dWp, dbp = ce.ce_bwd_dw_ref(h, W, b, y, lse, ga, gb, f32)
    assert dh.shape == (N, D) and dW.shape == (D, V) and db.shape == (V,)
    assert _rel(dh, ce.ce_bwd_dh_ref(h, W, b, y, lse, ga, gb, f32)) <= 1e-4
    assert _rel(dW, dWp) <= 1e-4 and _rel(db, dbp) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,V", [(1024, 512, 50_000), (129, 1024, 3001)])
def test_ce_fp32_backward_is_deterministic(cuda, N, D, V):
    """Two calls of the fp32 ce_bwd_dh and ce_bwd_dw on the same inputs give
    bit-identical dh, dW and db (no atomics; dh's split partials and db's
    partial sums are added in a fixed order)."""
    from jlm_tpu_torch.ops import softmax_ce as ce

    f32 = torch.float32
    h, W, b, y, g = _ce_case(cuda, 23, N, D, V, 5)
    m, s = ce.ce_fwd_raw_ref(h, W, b, y, f32)[:2]
    lse = m + torch.log(s)
    first = (ce.ce_bwd_dh(h, W, b, y, lse, g, -g, f32),) + ce.ce_bwd_dw(h, W, b, y, lse, g, -g,
                                                                          f32)
    again = (ce.ce_bwd_dh(h, W, b, y, lse, g, -g, f32),) + ce.ce_bwd_dw(h, W, b, y, lse, g, -g,
                                                                          f32)
    for a, b2, name in zip(first, again, ("dh", "dW", "db")):
        assert torch.equal(a, b2), name


@pytest.mark.cuda
def test_ce_fp32_bounds_catch_tf32(cuda):
    """On weights of scale 0.5 (a peaked softmax, where an operand rounding
    moves the lse instead of averaging away), the plain fp32 version with h
    and W rounded to TF32 reads above each bound of
    ``test_ce_fp32_kernels_vs_plain`` while the kernels read within it."""
    from jlm_tpu_torch.ops import softmax_ce as ce

    f32 = torch.float32
    h, W, b, y, g = _ce_case(cuda, 17, 300, 256, 1000, scale=0.5)
    hr, Wr = _tf32(h), _tf32(W)
    mp, sp, tp = ce.ce_fwd_raw_ref(h, W, b, y, f32)
    lse = mp + torch.log(sp)
    mw, sw, tw = ce.ce_fwd_raw_ref(hr, Wr, b, y, f32)
    m, s, t = ce.ce_fwd_raw(h, W, b, y, f32)
    assert float((m + torch.log(s) - lse).abs().max()) <= 1e-5
    assert float((mw + torch.log(sw) - lse).abs().max()) > 1e-5
    dh_p = ce.ce_bwd_dh_ref(h, W, b, y, lse, g, -g, f32)
    assert _rel(ce.ce_bwd_dh(h, W, b, y, lse, g, -g, f32), dh_p) <= 1e-5
    assert _rel(ce.ce_bwd_dh_ref(hr, Wr, b, y, lse, g, -g, f32), dh_p) > 1e-5
    dW_p = ce.ce_bwd_dw_ref(h, W, b, y, lse, g, -g, f32)[0]
    assert _rel(ce.ce_bwd_dw(h, W, b, y, lse, g, -g, f32)[0], dW_p) <= 1e-5
    assert _rel(ce.ce_bwd_dw_ref(hr, Wr, b, y, lse, g, -g, f32)[0], dW_p) > 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("head", ["full", "dsoftmax"])
def test_fp32_fused_loss_vs_plain_log_softmax(cuda, head):
    """``full_softmax_loss(precision="highest")`` with ``fused_ce`` on the
    card (the fp32 CE kernels, per block for a D-softmax head with blocks
    of 512, 256 and 128 dims) vs the plain fp32 log-softmax route, TF32
    off: loss within 1e-5 abs, every gradient within 1e-5 of its largest
    magnitude; one launch of each CE kernel per block."""
    from jlm_tpu_torch.config import Config, default_dsoftmax_blocks
    from jlm_tpu_torch.models.heads import full_softmax_loss
    from jlm_tpu_torch.ops import softmax_ce as ce

    rng = np.random.default_rng(18)
    V = 8000
    cfg = Config(vocab_size=V, hidden_size=512, fused_ce=True)
    if head == "dsoftmax":
        cfg = cfg.replace(head="dsoftmax", dsoftmax=default_dsoftmax_blocks(V, 512))
        shapes = list(zip(cfg.dsoftmax.block_dims, cfg.dsoftmax.block_sizes))
    else:
        shapes = [(512, V)]
    blocks = [{"W": torch.from_numpy(rng.normal(0, 0.05, s).astype(np.float32)).to(cuda),
               "b": torch.from_numpy(rng.normal(0, 0.1, s[1]).astype(np.float32)).to(cuda)}
              for s in shapes]
    params = {"head": blocks[0] if head == "full" else {"blocks": blocks}}
    hs = torch.from_numpy(rng.uniform(-1, 1, (4, 64, 512)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.integers(0, V, (4, 64))).to(cuda)
    leaves = [hs] + [blk[k] for blk in blocks for k in ("W", "b")]
    for leaf in leaves:
        leaf.requires_grad_(True)

    def run(c):
        loss = full_softmax_loss(params, c, hs, y, precision="highest")
        return (loss, *torch.autograd.grad(loss, leaves))

    n0 = (ce.ce_fwd_raw.launches, ce.ce_bwd_dh.launches, ce.ce_bwd_dw.launches)
    got = run(cfg)
    assert (ce.ce_fwd_raw.launches, ce.ce_bwd_dh.launches, ce.ce_bwd_dw.launches) == \
        tuple(n + len(blocks) for n in n0)
    want = run(cfg.replace(fused_ce=False))
    assert abs(got[0].item() - want[0].item()) <= 1e-5
    for a, w in zip(got[1:], want[1:]):
        assert _rel(a, w) <= 1e-5


@pytest.mark.cuda
def test_ce_kernels_refuse_what_they_cannot_take(cuda):
    """A compute dtype other than bf16 or fp32 raises on the card; a hidden
    slice wider than 512, once refused, launches and matches the plain
    version (1e-5 abs on the lse in fp32)."""
    from jlm_tpu_torch.ops import softmax_ce as ce

    h, W, b, y, _ = _ce_case(cuda, 19, 8, 640, 300)
    m, s, _ = ce.ce_fwd_raw(h, W, b, y, torch.float32)
    mp, sp, _ = ce.ce_fwd_raw_ref(h, W, b, y, torch.float32)
    assert float((m + torch.log(s) - mp - torch.log(sp)).abs().max()) <= 1e-5
    h, W, b, y, _ = _ce_case(cuda, 19, 8, 128, 300)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        ce.ce_fwd_raw(h, W, b, y, torch.float16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ce_kernels_pad_a_narrow_hidden_slice(cuda, dtype):
    """D = 192 (and 96): the wrappers pad h and W to 256 (128) with zeros
    and drop the padding's dh rows and dW rows; the kernels within the
    bounds of test_ce_kernels_vs_plain / test_ce_fp32_kernels_vs_plain of
    the plain versions at the unpadded shapes."""
    from jlm_tpu_torch.ops import softmax_ce as ce

    fwd_tol, bwd_tol = (1e-4, 1e-3) if dtype == torch.bfloat16 else (1e-5, 1e-5)
    for D in (192, 96):
        h, W, b, y, g = _ce_case(cuda, 31, 300, D, 1001, neg_every=7)
        m, s, t = ce.ce_fwd_raw(h, W, b, y, dtype)
        mp, sp, tp = ce.ce_fwd_raw_ref(h, W, b, y, dtype)
        lse = mp + torch.log(sp)
        assert float((m + torch.log(s) - lse).abs().max()) <= fwd_tol
        assert float((t - tp).abs().max()) <= fwd_tol
        dh = ce.ce_bwd_dh(h, W, b, y, lse, g, -g, dtype)
        dW, db = ce.ce_bwd_dw(h, W, b, y, lse, g, -g, dtype)
        assert dh.shape == (300, D) and dW.shape == (D, 1001) and db.shape == (1001,)
        assert _rel(dh, ce.ce_bwd_dh_ref(h, W, b, y, lse, g, -g, dtype)) <= bwd_tol
        dWp, dbp = ce.ce_bwd_dw_ref(h, W, b, y, lse, g, -g, dtype)
        assert _rel(dW, dWp) <= bwd_tol and _rel(db, dbp) <= bwd_tol


def _cand_ids(rng, sizes, C=150):
    """C candidate ids over a vocab of blocks ``sizes``: every block edge,
    repeats, and -1 (no column)."""
    V = sum(sizes)
    edges = np.cumsum((0,) + tuple(sizes))
    ids = rng.integers(0, V, C)
    fixed = sorted({int(e) for e in edges[:-1]} | {int(e) - 1 for e in edges[1:]})
    ids[:len(fixed)] = fixed
    ids[len(fixed):len(fixed) + 3] = [fixed[0], fixed[-1], -1]
    return torch.from_numpy(ids.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("weights", list(_BLOCK_MODES))
@pytest.mark.parametrize("mode", ["full", "prefix", "disjoint"])
def test_project_candidates_kernel_vs_plain(cuda, mode, weights):
    """Candidate extraction in every weight mode on a full head and on
    D-softmax heads vs the plain versions on the card: 300 rows, ragged
    blocks, 150 ids with every block edge, repeats and -1.  Bound 1e-4
    abs (the lse's: fp32 sums in another order; each candidate's raw logit
    is the value the online lse takes).  On weights of scale 0.5 the plain
    version read one column to the right must read above it.  The
    candidate wrappers count their launches, one per block, and not
    project_lse's; an id of -1 gets -lse."""
    from jlm_tpu_torch.config import Config, DSoftmaxConfig
    from jlm_tpu_torch.ops.project import (
        project_candidates, project_candidates_dsoftmax, project_candidates_dsoftmax_ref,
        project_candidates_ref)

    cd, quantized, int8_mxu, bound = _BLOCK_MODES[weights]
    rng = np.random.default_rng(26)
    H, sizes = 256, (1000, 2000, 3001)
    dims = {"full": (H,), "prefix": (256, 128, 64), "disjoint": (128, 64, 64)}[mode]
    if mode == "full":
        sizes = (6001,)
    cfg = Config(vocab_size=sum(sizes), hidden_size=H, head="dsoftmax",
                 dsoftmax=DSoftmaxConfig(block_sizes=sizes, block_dims=dims,
                                         mode="disjoint" if mode == "disjoint" else "prefix"))
    blocks = []
    for n, d in zip(sizes, dims):
        w = rng.normal(size=(d, n)).astype(np.float32) * 0.5
        b = torch.from_numpy(rng.normal(size=n).astype(np.float32) * 0.01).to(cuda)
        if quantized:
            q = quantize_weight(w, axis=0)
            W = {"q": torch.from_numpy(q["q"]).to(cuda),
                 "scale": torch.from_numpy(q["scale"]).to(cuda)}
        else:
            W = torch.from_numpy(w).to(cuda).to(cd)
        blocks.append({"W": W, "b": b})
    h = torch.from_numpy(rng.normal(size=(300, H)).astype(np.float32)).to(cuda).to(cd)
    ids = _cand_ids(rng, sizes).to(cuda)
    shifted = torch.where(ids >= 0, (ids + 1) % sum(sizes), ids)
    kw = dict(compute_dtype=cd, int8_mxu=int8_mxu)
    if mode == "full":
        W, scale = ((blocks[0]["W"]["q"], blocks[0]["W"]["scale"]) if quantized
                    else (blocks[0]["W"], None))

        def run(fn, i):
            return fn(h, W, scale, blocks[0]["b"], i, **kw)

        kernel, plain = project_candidates, project_candidates_ref
    else:
        def run(fn, i):
            return fn(h, blocks, cfg, i, **kw)

        kernel, plain = project_candidates_dsoftmax, project_candidates_dsoftmax_ref
    n0 = (project_candidates.launches, project_lse.launches)
    got = run(kernel, ids)
    assert (project_candidates.launches, project_lse.launches) == (n0[0] + len(blocks), n0[1])
    assert got.shape == (300, ids.shape[0]) and got.dtype == torch.float32
    want = run(plain, ids)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=bound)
    assert float((run(plain, shifted) - want).abs().max()) > bound
    head = blocks[0] if mode == "full" else {"blocks": blocks}
    lse = project_lse(h, head, cfg, **kw)
    none = int((ids < 0).nonzero()[0, 0])
    np.testing.assert_allclose(got[:, none].cpu().numpy(), -lse[:, 0].cpu().numpy(), atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("want", ["lse", "cand"])
@pytest.mark.parametrize("D", [128, 256, 512, 1024])
@pytest.mark.parametrize("weights", ["fp32", "int8_dequant_fp32"])
def test_project_f32_widths_vs_plain(cuda, weights, D, want):
    """The fp32 head kernel (128-row blocks, 128-column tiles, K chunks of
    16) at each width a D-softmax block of the repo's configurations takes:
    a disjoint head whose D-wide block sits at column 40 of h (an unaligned
    slice, copied) beside a 40-wide one (padded to 64), 300 rows (not a
    multiple of 128), ragged last tiles (1,000 and 5,001 columns), and for
    the candidates 150 ids with every block edge, repeats and -1.  Bound
    1e-4 abs (fp32 sums in another order); on weights of scale 0.5 the
    plain version on operands rounded to TF32 must read above it."""
    from jlm_tpu_torch.config import Config, DSoftmaxConfig
    from jlm_tpu_torch.ops.project import (
        project_candidates_dsoftmax, project_candidates_dsoftmax_ref)

    cd, quantized, _, bound = _BLOCK_MODES[weights]
    rng = np.random.default_rng(30 + D)
    sizes, dims = (1000, 5001), (40, D)
    cfg = Config(vocab_size=sum(sizes), hidden_size=D + 40, head="dsoftmax",
                 dsoftmax=DSoftmaxConfig(block_sizes=sizes, block_dims=dims, mode="disjoint"))
    blocks, dense = [], []
    for n, d in zip(sizes, dims):
        w = rng.normal(size=(d, n)).astype(np.float32) * 0.5
        b = torch.from_numpy(rng.normal(size=n).astype(np.float32) * 0.01).to(cuda)
        if quantized:
            q = quantize_weight(w, axis=0)
            W = {"q": torch.from_numpy(q["q"]).to(cuda),
                 "scale": torch.from_numpy(q["scale"]).to(cuda)}
            dense.append({"W": W["q"].float() * W["scale"][None, :], "b": b})
        else:
            W = torch.from_numpy(w).to(cuda)
            dense.append({"W": W, "b": b})
        blocks.append({"W": W, "b": b})
    h = torch.from_numpy(rng.normal(size=(300, D + 40)).astype(np.float32)).to(cuda)
    rounded = [{"W": _tf32(blk["W"]), "b": blk["b"]} for blk in dense]
    if want == "lse":
        head = {"blocks": blocks}
        n0 = project_lse.launches
        got = project_lse(h, head, cfg, compute_dtype=cd)
        assert project_lse.launches == n0 + 2
        ref = project_lse_ref(h, head, cfg, compute_dtype=cd)
        wrong = project_lse_ref(_tf32(h), {"blocks": rounded}, cfg, compute_dtype=cd)
    else:
        ids = _cand_ids(rng, sizes).to(cuda)
        got = project_candidates_dsoftmax(h, blocks, cfg, ids, compute_dtype=cd)
        ref = project_candidates_dsoftmax_ref(h, blocks, cfg, ids, compute_dtype=cd)
        wrong = project_candidates_dsoftmax_ref(_tf32(h), rounded, cfg, ids, compute_dtype=cd)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=bound)
    assert float((wrong - ref).abs().max()) > bound


@pytest.mark.cuda
@pytest.mark.parametrize("c_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,B,E,H,C1", [
    (12, 10, 64, 128, 17),    # test_cell_cand_fused's shapes
    (4, 8, 32, 64, 9),
    (37, 16, 256, 512, 65),   # the widest sentence the kernel takes
    (345, 10, 256, 512, 65),  # the serving widths, a ragged last block
    (7, 10, 40, 24, 65),      # E, H multiples of 8, under one unit group
    (5, 10, 30, 20, 9),       # E, H off the multiple of 8: padded, sliced back
    (6, 1, 64, 128, 200),     # one row a sentence (128 a block), 200 candidates
])
def test_cell_cand_kernel_vs_plain(cuda, S, B, E, H, C1, c_dtype):
    """The fused cell + candidate kernel (bf16) vs its plain version on the
    card.  Bounds: c' within 1e-4 abs (fp32 sums of the same bf16 products
    in another order), h' within one bf16 rounding (8e-3 at |h'| < 1), the
    candidate logits within 1e-4 of the plain dot of the kernel's own h'
    (the dot alone) and within 1e-4 of the plain version beyond what the
    h' elements that the two round the other way explain (sum over them of
    |h'_k - h'_r| |cols|)."""
    from jlm_tpu_torch.ops.frame_step import cell_cand_ref, cell_cand_step

    bf = torch.bfloat16
    rng = np.random.default_rng(27)

    def t(*shape, scale, dtype=bf):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale).to(cuda).to(dtype)

    R = S * B
    x, h, c = t(R, E, scale=1.0), t(R, H, scale=0.1), t(R, H, scale=0.5, dtype=c_dtype)
    W, b = t(E + H, 4 * H, scale=0.05), t(4 * H, scale=0.01, dtype=torch.float32)
    cols, cbias = t(S, C1, H, scale=0.1), t(S, C1, scale=0.01, dtype=torch.float32)
    n0 = cell_cand_step.launches
    c_k, h_k, cand_k = cell_cand_step(x, h, c, W, b, cols, cbias, B, 1.0, compute_dtype=bf)
    assert cell_cand_step.launches == n0 + 1
    assert (c_k.dtype, h_k.dtype, cand_k.dtype) == (torch.float32, bf, torch.float32)
    c_r, h_r, cand_r = cell_cand_ref(x, h, c, W, b, cols, cbias, B, 1.0, compute_dtype=bf)
    np.testing.assert_allclose(c_k.cpu().numpy(), c_r.cpu().numpy(), atol=1e-4)
    np.testing.assert_allclose(h_k.float().cpu().numpy(), h_r.float().cpu().numpy(), atol=8e-3)
    own = torch.einsum("sbh,sch->sbc", h_k.float().reshape(S, B, H), cols.float()) \
        + cbias[:, None, :]
    np.testing.assert_allclose(cand_k.cpu().numpy(), own.cpu().numpy(), atol=1e-4)
    slack = torch.einsum("sbh,sch->sbc", (h_k.float() - h_r.float()).abs().reshape(S, B, H),
                         cols.float().abs())
    assert float(((cand_k - cand_r).abs() - slack).max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("c_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,B,E,H,C1", [
    (12, 10, 64, 128, 17),    # test_cell_cand_fused's shapes
    (4, 8, 32, 64, 9),
    (64, 8, 256, 512, 65),    # the fp32 parity run's frame (greedy, beam pad 8)
    (7, 10, 40, 24, 65),      # E, H padded to 64 and 32
    (5, 8, 30, 20, 9),
    (13, 10, 64, 128, 17),    # 6 sentences a block (60 of 64 row slots), a ragged last block
    (9, 16, 64, 96, 20),      # 4 sentences a block, S not a multiple of them; 3 unit groups
    (10, 8, 32, 48, 9),       # H off the unit group's 32: padded to 64
    (13, 8, 64, 128, 200),    # 1,600 cols rows a block: two pieces
])
def test_cell_cand_fp32_kernel_vs_plain(cuda, S, B, E, H, C1, c_dtype):
    """fp32 compute (exact fp32 FMAs, TF32 off): c', h' and the candidate
    logits within 1e-5 abs of the plain version (fp32 sums in another
    order); h' is fp32."""
    from jlm_tpu_torch.ops.frame_step import cell_cand_ref, cell_cand_step

    f32 = torch.float32
    rng = np.random.default_rng(28)

    def t(*shape, scale, dtype=f32):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale).to(cuda).to(dtype)

    R = S * B
    x, h, c = t(R, E, scale=1.0), t(R, H, scale=0.1), t(R, H, scale=0.5, dtype=c_dtype)
    W, b = t(E + H, 4 * H, scale=0.05), t(4 * H, scale=0.01)
    cols, cbias = t(S, C1, H, scale=0.1), t(S, C1, scale=0.01)
    n0 = cell_cand_step.launches
    got = cell_cand_step(x, h, c, W, b, cols, cbias, B, 1.0, compute_dtype=f32)
    assert cell_cand_step.launches == n0 + 1
    assert all(a.dtype == f32 for a in got)
    want = cell_cand_ref(x, h, c, W, b, cols, cbias, B, 1.0, compute_dtype=f32)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), w.cpu().numpy(), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cell_cand_kernel_is_deterministic(cuda, dtype):
    """The unit groups' partial candidate sums are added in group order by
    the last group block of each sentence block: two launches give the same
    logits bit for bit, and each leaves its counters zeroed."""
    from jlm_tpu_torch.ops import frame_step
    from jlm_tpu_torch.ops.frame_step import cell_cand_step

    rng = np.random.default_rng(29)
    S, B, E, H, C1 = 64, 8, 256, 512, 65

    def t(*shape, scale, dt=dtype):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale).to(cuda).to(dt)

    x, h, c = t(S * B, E, scale=1.0), t(S * B, H, scale=0.1), t(S * B, H, scale=0.5)
    W, b = t(E + H, 4 * H, scale=0.05), t(4 * H, scale=0.01, dt=torch.float32)
    cols, cbias = t(S, C1, H, scale=0.1), t(S, C1, scale=0.01, dt=torch.float32)
    runs = []
    for _ in range(2):
        runs.append(cell_cand_step(x, h, c, W, b, cols, cbias, B, 1.0, compute_dtype=dtype)[2])
        torch.cuda.synchronize()
        assert int(frame_step._done[cuda.index or 0].abs().sum()) == 0
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
def test_cell_cand_refuses_what_it_cannot_take(cuda):
    """fp16 compute, more candidate columns than one TMA box holds (bf16)
    and a cols slice of the wrong shape raise; widths off the kernels'
    multiples (E = 48, H = 96 in bf16; E = 48 in fp32) are padded and
    launch."""
    from jlm_tpu_torch.ops.frame_step import cell_cand_step

    bf = torch.bfloat16

    def args(S, B, E, H, C1, dtype=bf):
        z = lambda *s, dtype=dtype: torch.zeros(s, dtype=dtype, device=cuda)  # noqa: E731
        return (z(S * B, E), z(S * B, H), z(S * B, H, dtype=torch.float32), z(E + H, 4 * H),
                z(4 * H, dtype=torch.float32), z(S, C1, H), z(S, C1, dtype=torch.float32), B)

    with pytest.raises(ValueError, match="bf16 or fp32"):
        cell_cand_step(*args(2, 8, 32, 64, 9), compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="candidate columns"):
        cell_cand_step(*args(2, 8, 32, 64, 257), compute_dtype=bf)
    for shape, cd in (((2, 8, 48, 64, 9), bf), ((2, 8, 32, 96, 9), bf),
                      ((2, 8, 48, 64, 9), torch.float32)):
        c_new, h_new, cand = cell_cand_step(*args(*shape, dtype=cd), compute_dtype=cd)
        assert c_new.shape == h_new.shape == (16, shape[3]) and cand.shape == (2, 8, 9)
        assert float(cand.abs().max()) == 0.0 and float(h_new.float().abs().max()) == 0.0
    a = list(args(2, 8, 32, 64, 9))
    a[5] = a[5][:, :, :32]
    with pytest.raises(ValueError, match="cols"):
        cell_cand_step(*a, compute_dtype=bf)


@pytest.mark.cuda
def test_fused_frame_forward_on_the_card(cuda):
    """``BeamDecoder`` with ``make_fused_frame_forward`` (bf16, int8 head)
    on the card vs the default split forward: the same top-1 paths, scores
    within 1e-2 (the split frame rounds c' to bf16, the fused frame keeps
    it fp32); per forward one ``cell_cand_step`` and one ``project_lse``
    launch, no ``lstm_cell_step`` or ``cand_dot``."""
    from jlm_tpu_torch.config import Config
    from jlm_tpu_torch.data import Lexicon, build_vocab, generate_corpus, generate_test_set
    from jlm_tpu_torch.decoder.engine import BeamDecoder, make_fused_frame_forward
    from jlm_tpu_torch.models.params import init_params
    from jlm_tpu_torch.ops.frame_step import cell_cand_step
    from jlm_tpu_torch.ops.quant import quantize_params

    cfg = Config(vocab_size=2000, embed_size=64, hidden_size=128, beam_width=10,
                 n_best_max=1, seed=3)
    vocab = build_vocab(generate_corpus(800, seed=1234), cfg.vocab_size)
    lexicon = Lexicon.from_vocab(vocab)
    qp = quantize_params(init_params(cfg))
    kanas = [k for k, _ in generate_test_set(12, seed=777)]
    split = BeamDecoder(qp, lexicon, vocab, cfg, precision="default", device=cuda)
    want = split.decode_batch(kanas)
    fused = BeamDecoder(qp, lexicon, vocab, cfg, device=cuda,
                        forward_fn=make_fused_frame_forward(cfg))
    counters = (cell_cand_step, project_lse, lstm_cell_step, cand_dot)
    for fn in counters:
        fn.launches = 0
    got = fused.decode_batch(kanas)
    counts = [fn.launches for fn in counters]
    assert counts[0] > 0 and counts == [counts[0], counts[0], 0, 0]
    for g, w in zip(got, want):
        assert g[0].segments == w[0].segments
        assert abs(g[0].score - w[0].score) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("R,E,H,tiles", [
    (1000, 256, 512, True),   # the serving widths, tiles made first (the engine's way)
    (300, 64, 96, False),     # H not a multiple of the 64-unit block, tiles made by the call
    (77, 40, 24, True),       # E, H multiples of 8 only; fewer rows than a block
    (77, 30, 20, True),       # E, H off the multiple of 8: padded, sliced back
])
def test_lstm_cell_wgmma_kernel_shapes(cuda, R, E, H, tiles):
    """The bf16 cell kernel (wgmma + TMA) on ragged rows, units and K vs the
    plain version: c' fp32 within 1e-4 abs (fp32 sums of the same bf16
    products in another order), h' within one bf16 rounding (8e-3 at
    |h'| < 1); one launch."""
    from jlm_tpu_torch.ops.lstm_cell import cell_weight_tiles

    rng = np.random.default_rng(32)
    bf = torch.bfloat16

    def t(*shape, scale, dtype=bf):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale).to(cuda).to(dtype)

    x, h, c = t(R, E, scale=0.5), t(R, H, scale=0.5), t(R, H, scale=0.5)
    W, b = t(E + H, 4 * H, scale=0.1), t(4 * H, scale=0.1, dtype=torch.float32)
    if tiles:
        cell_weight_tiles(W, E, H)
    n0 = lstm_cell_step.launches
    c_k, h_k = lstm_cell_step(x, h, c, W, b, 1.0, compute_dtype=bf)
    assert lstm_cell_step.launches == n0 + 1
    assert W._cell_tiles[1] is cell_weight_tiles(W, E, H)  # kept on W
    c_r, h_r = lstm_cell_ref(x, h, c, W, b, 1.0)
    np.testing.assert_allclose(c_k.cpu().numpy(), c_r.cpu().numpy(), atol=1e-4)
    np.testing.assert_allclose(h_k.float().cpu().numpy(), h_r.cpu().numpy(), atol=8e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("R,H,V", [
    (1, 512, 5000),      # one row
    (257, 512, 3201),    # a row past the 256-row block; a ragged last vocab tile
    (300, 640, 3001),    # a slice over 512: 128-row blocks, 32-column tiles
    (130, 1024, 2000),   # the widest slice the kernel keeps resident
    (600, 80, 4999),     # a slice padded from 80 to 128
    (300, 1050, 3001),   # past 1,024: padded to 1,152, rows streamed with W^T
    (70, 1536, 1999),
    (129, 2048, 2000),
])
def test_project_int8_wgmma_kernel_edges(cuda, R, H, V):
    """The int8-MXU head (quantization pass + wgmma kernel) at ragged R, V
    and slice widths vs the plain version on weights of scale 0.5: lse and
    candidate log-probs within 1e-4 abs (exact int32 products, the logit
    rounded as the plain version rounds it, fp32 sums in another order); a
    candidate read from its neighbouring column reads above the bound."""
    from jlm_tpu_torch.ops.project import project_candidates, project_candidates_ref

    rng = np.random.default_rng(33)
    h = torch.from_numpy(rng.uniform(-1, 1, (R, H)).astype(np.float32)).to(cuda).to(torch.bfloat16)
    q = quantize_weight(rng.normal(0, 0.5, (H, V)).astype(np.float32), axis=0)
    W, scale = torch.from_numpy(q["q"]).to(cuda), torch.from_numpy(q["scale"]).to(cuda)
    b = torch.from_numpy(rng.normal(0, 0.1, V).astype(np.float32)).to(cuda)
    head = {"W": {"q": W, "scale": scale}, "b": b}
    kw = dict(compute_dtype=torch.bfloat16, int8_mxu=True)
    n0 = project_lse.launches
    got = project_lse(h, head, None, **kw)
    assert project_lse.launches == n0 + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               project_lse_ref(h, head, **kw).cpu().numpy(), atol=1e-4)
    ids = _cand_ids(rng, (V,), C=40).to(cuda)
    cand = project_candidates(h, W, scale, b, ids, **kw)
    want = project_candidates_ref(h, W, scale, b, ids, **kw)
    np.testing.assert_allclose(cand.cpu().numpy(), want.cpu().numpy(), atol=1e-4)
    shifted = torch.where(ids >= 0, (ids + 1) % V, ids)
    assert float((project_candidates_ref(h, W, scale, b, shifted, **kw) - want).abs().max()) > 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("weights", list(_BLOCK_MODES))
@pytest.mark.parametrize("mode", ["prefix", "disjoint"])
def test_project_pads_h192_dsoftmax_blocks(cuda, mode, weights):
    """scripts/eval_quality.py's D-softmax heads at H = 192 (dims 96/48/48;
    disjoint offsets 96 and 144): every weight mode pads the blocks to
    multiples of 32 and launches, within the bound of
    test_project_kernel_modes_vs_plain of the plain version, for the lse
    and the candidate log-probs."""
    from jlm_tpu_torch.config import Config, DSoftmaxConfig
    from jlm_tpu_torch.ops.project import (
        project_candidates_dsoftmax, project_candidates_dsoftmax_ref)

    cd, quantized, int8_mxu, bound = _BLOCK_MODES[weights]
    rng = np.random.default_rng(34)
    H, sizes, dims = 192, (700, 900, 1401), (96, 48, 48)
    cfg = Config(vocab_size=sum(sizes), hidden_size=H, head="dsoftmax",
                 dsoftmax=DSoftmaxConfig(block_sizes=sizes, block_dims=dims, mode=mode))
    blocks = []
    for n, d in zip(sizes, dims):
        w = rng.normal(size=(d, n)).astype(np.float32) * 0.5
        b = torch.from_numpy(rng.normal(size=n).astype(np.float32) * 0.01).to(cuda)
        if quantized:
            q = quantize_weight(w, axis=0)
            W = {"q": torch.from_numpy(q["q"]).to(cuda),
                 "scale": torch.from_numpy(q["scale"]).to(cuda)}
        else:
            W = torch.from_numpy(w).to(cuda).to(cd)
        blocks.append({"W": W, "b": b})
    h = torch.from_numpy(rng.normal(size=(300, H)).astype(np.float32)).to(cuda).to(cd)
    kw = dict(compute_dtype=cd, int8_mxu=int8_mxu)
    n0 = project_lse.launches
    got = project_lse(h, {"blocks": blocks}, cfg, **kw)
    assert project_lse.launches == n0 + 3
    np.testing.assert_allclose(got.cpu().numpy(),
                               project_lse_ref(h, {"blocks": blocks}, cfg, **kw).cpu().numpy(),
                               atol=bound)
    ids = _cand_ids(rng, sizes, C=60).to(cuda)
    np.testing.assert_allclose(
        project_candidates_dsoftmax(h, blocks, cfg, ids, **kw).cpu().numpy(),
        project_candidates_dsoftmax_ref(h, blocks, cfg, ids, **kw).cpu().numpy(), atol=bound)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_beams_go_in_groups_of_16(cuda, dtype):
    """B = 20 beam rows a sentence: cand_dot (and at H = 130, padded to 132)
    and cell_cand_step launch twice (rows 0-15, 16-19) and match their plain
    versions within the bounds of their own tests (cand 1e-4; the fused
    frame's c' 1e-4 and h' one bf16 rounding in bf16, 1e-5 in fp32)."""
    from jlm_tpu_torch.ops.frame_step import cell_cand_ref, cell_cand_step

    rng = np.random.default_rng(35)

    def t(*shape, scale, dt=dtype):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale).to(cuda).to(dt)

    S, B, C1 = 9, 20, 17
    for H in (128, 130):
        h3, cols = t(S, B, H, scale=0.3), t(S, C1, H, scale=0.3)
        bias = t(S, C1, scale=1.0, dt=torch.float32)
        n0 = cand_dot.launches
        got = cand_dot(h3, cols, bias)
        assert cand_dot.launches == n0 + 2 and got.shape == (S, B, C1)
        np.testing.assert_allclose(got.cpu().numpy(), cand_dot_ref(h3, cols, bias).cpu().numpy(),
                                   atol=1e-4)
    E, H = 64, 128
    x, h, c = t(S * B, E, scale=1.0), t(S * B, H, scale=0.1), t(S * B, H, scale=0.5)
    W, b = t(E + H, 4 * H, scale=0.05), t(4 * H, scale=0.01, dt=torch.float32)
    cols, cbias = t(S, C1, H, scale=0.1), t(S, C1, scale=0.01, dt=torch.float32)
    n0 = cell_cand_step.launches
    c_k, h_k, cand_k = cell_cand_step(x, h, c, W, b, cols, cbias, B, 1.0, compute_dtype=dtype)
    assert cell_cand_step.launches == n0 + 2
    c_r, h_r, cand_r = cell_cand_ref(x, h, c, W, b, cols, cbias, B, 1.0, compute_dtype=dtype)
    tol = 8e-3 if dtype == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(c_k.cpu().numpy(), c_r.cpu().numpy(), atol=1e-4 if tol > 1e-5 else tol)
    np.testing.assert_allclose(h_k.float().cpu().numpy(), h_r.float().cpu().numpy(), atol=tol)
    slack = torch.einsum("sbh,sch->sbc", (h_k.float() - h_r.float()).abs().reshape(S, B, H),
                         cols.float().abs())
    assert float(((cand_k - cand_r).abs() - slack).max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["bf16", "int8_dequant_bf16"])
@pytest.mark.parametrize("R,H,V", [
    (257, 128, 3001),    # ragged rows (a block's second warpgroup past R) and vocab
    (300, 256, 5000),
    (1000, 512, 4999),   # 8 K chunks a tile; a ragged last 256-column tile
    (200, 544, 3000),    # a K chunk half zero-filled; the first port's kernel refused > 576
    (130, 1024, 2000),   # 16 K chunks a tile
    (64, 1280, 700),     # wider than any slice kept resident: h is streamed too
])
def test_project_bf16_wgmma_kernel_edges(cuda, weights, R, H, V):
    """The bf16 and dequant-bf16 head (wgmma + TMA, h and W^T streamed in K
    chunks) at ragged R, V and slice widths vs the plain version: lse and
    candidate log-probs (repeated ids, the vocab edges, a -1) within the
    bound of test_project_kernel_modes_vs_plain; a candidate read from its
    neighbouring column reads above the bound."""
    from jlm_tpu_torch.ops import project as port

    cd, quantized, int8_mxu, bound = _BLOCK_MODES[weights]
    rng = np.random.default_rng(36)
    h = torch.from_numpy(rng.normal(size=(R, H)).astype(np.float32)).to(cuda).to(cd)
    w = rng.normal(0, 0.05, (H, V)).astype(np.float32)
    b = torch.from_numpy(rng.normal(0, 0.1, V).astype(np.float32)).to(cuda)
    if quantized:
        q = quantize_weight(w, axis=0)
        W, scale = torch.from_numpy(q["q"]).to(cuda), torch.from_numpy(q["scale"]).to(cuda)
    else:
        W, scale = torch.from_numpy(w).to(cuda).to(cd), None
    head = port._full_head(W, scale, b)
    kw = dict(compute_dtype=cd, int8_mxu=int8_mxu)
    n0 = project_lse.launches
    got = project_lse(h, head, None, **kw)
    assert project_lse.launches == n0 + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               project_lse_ref(h, head, **kw).cpu().numpy(), atol=bound)
    ids = _cand_ids(rng, (V,), C=40).to(cuda)  # edges, repeats and a -1
    cand = port.project_candidates(h, W, scale, b, ids, **kw)
    want = port.project_candidates_ref(h, W, scale, b, ids, **kw)
    np.testing.assert_allclose(cand.cpu().numpy(), want.cpu().numpy(), atol=bound)
    shifted = torch.where(ids >= 0, (ids + 1) % V, ids)
    assert float((port.project_candidates_ref(h, W, scale, b, shifted, **kw)
                  - want).abs().max()) > bound


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 10, 40, 640])
@pytest.mark.parametrize("weights", ["int8_mxu", "int8_dequant_fp32"])
def test_project_kernel_keystroke_rows(cuda, weights, R):
    """The head at the per-keystroke paths' rows (one row; a keystroke's
    beam; four speculated frames; the server at 64 events), each a partial
    row block, on a head prepared once as ``build_decode_head`` makes it
    (``"WT"`` kept, the plan cached): within the bound of
    test_project_kernel_modes_vs_plain, one launch a call; the last row
    read as zeros reads above it."""
    cd, _, int8_mxu, bound = _BLOCK_MODES[weights]
    rng = np.random.default_rng(17)
    H, V = 512, 5001
    q = quantize_weight(rng.normal(0, 0.5, (H, V)).astype(np.float32), axis=0)
    W = torch.from_numpy(q["q"]).to(cuda)
    head = {"W": {"q": W, "scale": torch.from_numpy(q["scale"]).to(cuda)},
            "b": torch.from_numpy(rng.normal(0, 0.1, V).astype(np.float32)).to(cuda),
            "WT": W.t().contiguous()}
    h = torch.from_numpy(rng.uniform(-1, 1, (R, H)).astype(np.float32)).to(cuda).to(cd)
    kw = dict(compute_dtype=cd, int8_mxu=int8_mxu)
    for _ in range(2):  # the second call runs on the cached plan
        n0 = project_lse.launches
        got = project_lse(h, head, None, **kw)
        assert project_lse.launches == n0 + 1
        ref = project_lse_ref(h, head, **kw)
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=bound)
    assert "_plan" in head
    wrong = h.clone()
    wrong[-1] = 0
    assert float((project_lse_ref(wrong, head, **kw) - ref).abs().max()) > bound


@pytest.mark.cuda
@pytest.mark.parametrize("R", [10, 640])
def test_project_dsoftmax_int8_keystroke_rows(cuda, R):
    """The int8-MXU D-softmax head (BASELINE config 5's three blocks of 512,
    256 and 128 dims, at 8,000 words) at a keystroke's rows and the
    server's, each block's launch on its own one-wave split plan, its
    partials merged from its own offset: within 1e-4 of the plain version,
    one launch a block a call, each counted at R rows; the last block's
    partials lost reads above."""
    from jlm_tpu_torch.config import Config, default_dsoftmax_blocks
    from jlm_tpu_torch.decoder.engine import build_decode_head

    cfg = Config(vocab_size=8000, hidden_size=512, head="dsoftmax",
                 dsoftmax=default_dsoftmax_blocks(8000, 512))
    rng = np.random.default_rng(18)
    blocks = []
    for s, d in zip(cfg.dsoftmax.block_sizes, cfg.dsoftmax.block_dims):
        q = quantize_weight(rng.normal(0, 0.5, (d, s)).astype(np.float32), axis=0)
        blocks.append({"W": {"q": torch.from_numpy(q["q"]).to(cuda),
                             "scale": torch.from_numpy(q["scale"]).to(cuda)},
                       "b": torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32)).to(cuda)})
    head = build_decode_head({"head": {"blocks": blocks}, "lstm": []}, cfg,
                             torch.bfloat16)["head_c"]
    h = torch.from_numpy(rng.uniform(-1, 1, (R, 512)).astype(np.float32)).to(cuda).bfloat16()
    kw = dict(compute_dtype=torch.bfloat16, int8_mxu=True)
    n0, r0 = project_lse.launches, project_lse.rows.get(R, 0)
    got = project_lse(h, head, cfg, **kw)
    assert project_lse.launches == n0 + 3 and project_lse.rows[R] == r0 + 3
    ref = project_lse_ref(h, head, cfg, **kw)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=1e-4)
    lost = {"blocks": head["blocks"][:2]}  # the last block's partials overwritten
    assert float((project_lse_ref(h, lost, cfg, **kw) - ref).abs().max()) > 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("head", ["full", "dsoftmax"])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_keystroke_decoders_on_card_match_cpu(cuda, precision, head):
    """IncrementalDecoder (plain and speculate=2) and SessionServer with the
    kernel head on the card give the CPU run's n-best at every keystroke
    (plain versions there), with a full head and with a D-softmax prefix
    head (one launch a block): segments equal, scores within the speed
    mode's int8-MXU tolerance 0.2, or 1e-3 in the parity mode."""
    from jlm_tpu_torch.config import Config, DSoftmaxConfig
    from jlm_tpu_torch.data import Lexicon, build_vocab, generate_corpus, generate_test_set
    from jlm_tpu_torch.decoder import IncrementalDecoder, SessionServer
    from jlm_tpu_torch.models.params import init_params
    from jlm_tpu_torch.ops.quant import quantize_params

    cfg = Config(vocab_size=2000, embed_size=32, hidden_size=64, beam_width=4,
                 max_kana_len=30, seed=3)
    if head == "dsoftmax":
        cfg = cfg.replace(head="dsoftmax", dsoftmax=DSoftmaxConfig(
            block_sizes=(400, 1600), block_dims=(64, 32), mode="prefix"))
    vocab = build_vocab(generate_corpus(800, seed=1234), cfg.vocab_size)
    lex = Lexicon.from_vocab(vocab)
    qp = quantize_params(init_params(cfg))
    tol = 0.2 if precision == "default" else 1e-3
    kanas = [k for k, _ in generate_test_set(4, seed=777)]

    def typed(device, **kw):
        dec = IncrementalDecoder(qp, lex, vocab, cfg, precision=precision, use_kernel=True,
                                 device=device, **kw)
        out = []
        for k in kanas:
            dec.reset()
            out += [dec.push(ch, n_best=2) for ch in k]
        return out

    def served(device):
        srv = SessionServer(qp, lex, vocab, cfg, max_sessions=4, precision=precision,
                            use_kernel=True, device=device)
        sids = [srv.open() for _ in kanas]
        for t in range(max(map(len, kanas))):
            srv.push([(s, k[t]) for s, k in zip(sids, kanas) if t < len(k)])
        return [srv.results(s, 2) for s in sids]

    for got, want in ((typed(cuda), typed("cpu")), (typed(cuda, speculate=2), typed("cpu")),
                      (served(cuda), served("cpu"))):
        for g, w in zip(got, want):
            assert [r.segments for r in g] == [r.segments for r in w]
            np.testing.assert_allclose([r.score for r in g], [r.score for r in w], atol=tol)


def _adam_leaves(cuda, sizes, scale, count, seed, unaligned=False):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda)

    buf = t(rng.normal(0, scale, sum(sizes) + 1))
    offs = np.cumsum([1] + list(sizes))
    g = [buf[o:o + s] if unaligned else buf[o:o + s].clone() for o, s in zip(offs, sizes)]
    p = [t(rng.uniform(-0.1, 0.1, s)) for s in sizes]
    mu = [t(rng.normal(0, 1e-3, s) * (count > 1)) for s in sizes]
    nu = [t(np.abs(rng.normal(0, 1e-6, s)) * (count > 1)) for s in sizes]
    return g, p, mu, nu


@pytest.mark.cuda
@pytest.mark.parametrize("unaligned", [False, True])
@pytest.mark.parametrize("scale", [1e-3, 0.1])  # norm under the clip's 5, and past it
@pytest.mark.parametrize("count", [1, 3])
def test_adam_kernels_vs_plain(cuda, count, scale, unaligned):
    """``sumsq_norm`` within 1e-6 of the plain norm and the same bits on a
    rerun; ``adam_clip`` given the plain norm: p, mu and nu the plain
    chain's (``train/optim.py`` on the card) to the bit, ragged sizes, a
    one-element leaf, gradients as unaligned slices of one buffer too."""
    from jlm_tpu_torch.ops import adam
    from jlm_tpu_torch.train import optim

    sizes = [1, 15, 4097, 12297, 3 * adam.CHUNK]
    g, p, mu, nu = _adam_leaves(cuda, sizes, scale, count, seed=count, unaligned=unaligned)
    plain_norm = optim.global_norm(g)
    norm = adam.sumsq_norm(g)
    assert torch.equal(norm, adam.sumsq_norm(g))
    assert abs(float(norm) / float(plain_norm) - 1) <= 1e-6
    assert (float(plain_norm) >= 5.0) == (scale == 0.1)
    keys = [str(i) for i in range(len(sizes))]
    state = optim.OptState(count=count - 1, mu={k: m.clone() for k, m in zip(keys, mu)},
                           nu={k: v.clone() for k, v in zip(keys, nu)}, acc={})
    updates = optim._adam(optim.clip_by_global_norm(g, 5.0, plain_norm), keys, state, 1e-3)
    want_p = [x + u for x, u in zip(p, updates)]
    n0 = adam.adam_clip.launches
    adam.adam_clip(p, g, mu, nu, plain_norm, count=count, lr=1e-3, max_norm=5.0, b1=optim.B1,
                   b2=optim.B2, eps=optim.EPS)
    assert adam.adam_clip.launches == n0 + 1
    for k, x, m, v, w in zip(keys, p, mu, nu, want_p):
        assert torch.equal(x, w) and torch.equal(m, state.mu[k]) and torch.equal(v, state.nu[k])


@pytest.mark.cuda
def test_trainer_steps_take_the_adam_kernels(cuda):
    """A CUDA trainer's optimizer calls launch each kernel once a step and
    count ``optim.kernel_calls`` (tracer on); the losses follow the CPU
    trainer's."""
    from jlm_tpu_torch.config import Config
    from jlm_tpu_torch.data import build_vocab, encode_corpus, generate_corpus
    from jlm_tpu_torch.models.params import init_params
    from jlm_tpu_torch.ops import adam
    from jlm_tpu_torch.train import Trainer
    from jlm_tpu_torch.utils import profiling

    lines = generate_corpus(200, seed=3)
    ids = np.asarray(encode_corpus(lines, build_vocab(lines, 256))[:2048])
    cfg = Config(vocab_size=256, embed_size=16, hidden_size=32, batch_size=4, num_steps=8,
                 seed=5)
    params = init_params(cfg)
    n0 = adam.sumsq_norm.launches, adam.adam_clip.launches
    profiling.reset()
    profiling.enable(True)
    try:
        got = [float(loss) for loss, _ in Trainer(cfg, params, device=cuda).train_steps(ids, 0)]
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.enable(False)
        profiling.reset()
    want = [float(loss) for loss, _ in Trainer(cfg, params, device="cpu").train_steps(ids, 0)]
    steps = len(got)
    assert (adam.sumsq_norm.launches - n0[0], adam.adam_clip.launches - n0[1]) == (steps, steps)
    assert counters.get("optim.kernel_calls") == steps and "optim.plain_calls" not in counters
    np.testing.assert_allclose(got, want, rtol=1e-4)
