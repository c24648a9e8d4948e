"""The hand-written CUDA kernels vs their plain PyTorch versions, on the card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
The file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from jlm_tpu.ops.quant import quantize_weight
from jlm_tpu_torch.ops.cand_dot import cand_dot, cand_dot_ref
from jlm_tpu_torch.ops.lstm_cell import lstm_cell_ref, lstm_cell_step
from jlm_tpu_torch.ops.project import project_lse, project_lse_ref, project_ms


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
    ref = project_lse_ref(h_t, W, scale, b_t, compute_dtype=act, int8_mxu=True)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=1e-4)
    m, s = project_ms(h_t, head, None, compute_dtype=act, int8_mxu=True)
    assert project_lse.launches == n0 + 2
    np.testing.assert_allclose((m + torch.log(s)).cpu().numpy(), got.cpu().numpy(), atol=1e-6)


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
    from jlm_tpu.config import Config, default_dsoftmax_blocks
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
