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
