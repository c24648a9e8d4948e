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
def test_lstm_cell_fp32_kernel_vs_plain(cuda):
    """fp32 compute (exact fp32 FMAs): c' and h' fp32 within 1e-5 of the
    plain version (sum order only), c read as fp32 or bf16."""
    rng = np.random.default_rng(9)
    R, E, H = 300, 64, 96

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


def _ce_case(cuda, seed, N, D, V, neg_every=0):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.uniform(-1, 1, (N, D)).astype(np.float32)).to(cuda)
    W = torch.from_numpy(rng.normal(0, 0.05, (D, V)).astype(np.float32)).to(cuda)
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
])
def test_lstm_scan_kernels_vs_plain(cuda, B, T, E, H):
    """lstm_scan_fwd and lstm_scan_bwd vs their plain versions on the card,
    fp32 compute (exact fp32 products on both sides).  Bounds: hs, cs, c_T,
    h_T within 1e-5 abs (fp32 sums in another order); dz, dx, dc0, dh0
    within 2e-4 abs + 1e-4 rel (the reference tests' gradient bound)."""
    from jlm_tpu_torch.ops import lstm_scan as ls

    xs, W, b, c0, h0 = _scan_case(cuda, 21, B, T, E, H)
    n0 = (ls.lstm_scan_fwd.launches, ls.lstm_scan_bwd.launches)
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
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=2e-4, rtol=1e-4)


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
    """H not a multiple of 4, or more dx columns per block than 4, raise."""
    from jlm_tpu_torch.ops import lstm_scan as ls

    xs, W, b, c0, h0 = _scan_case(cuda, 25, 2, 3, 8, 6)
    with pytest.raises(ValueError, match="H % 4"):
        ls.lstm_scan_fwd(xs, W, b, c0, h0)
    xs, W, b, c0, h0 = _scan_case(cuda, 25, 2, 3, 128, 16)
    hs, cs, _, _ = ls.lstm_scan_fwd(xs, W, b, c0, h0)
    with pytest.raises(ValueError, match="E <= 16"):
        ls.lstm_scan_bwd(xs, W, b, c0, h0, hs, cs, hs, c0, h0)
