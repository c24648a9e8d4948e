"""PyTorch port kernels' modules vs the JAX package, on the same inputs.

Inputs are numpy-seeded and go through the JAX function (its Pallas kernel
in interpret mode, as tests/test_kernels.py runs it) and the port's wrapper.
On the CPU the wrapper runs its plain version; tests/test_torch_kernels_cuda.py
compares each hand-written kernel with that plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jlm_tpu.config import Config
from jlm_tpu.ops.quant import quantize_weight
from jlm_tpu_torch.ops.cand_dot import cand_dot
from jlm_tpu_torch.ops.lstm_cell import lstm_cell_step
from jlm_tpu_torch.ops.project import project_lse, project_ms, quantize_rows

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_lstm_cell_step(dtype):
    """Mirrors test_kernels.py::test_lstm_cell_step: the port's cell vs the
    JAX Pallas cell.  Tolerance: 1e-5 in fp32 (sum order only); in bf16 the
    h' outputs are bf16 on both sides, so one bf16 rounding step (3e-2,
    the JAX test's bound)."""
    from jlm_tpu.ops.lstm_cell import lstm_cell_step as jax_cell

    jd, td = DTYPES[dtype]
    R, E, H = 48, 64, 96
    rng = np.random.default_rng(7)
    x = rng.normal(size=(R, E)).astype(np.float32) * 0.3
    h = rng.normal(size=(R, H)).astype(np.float32) * 0.3
    c = rng.normal(size=(R, H)).astype(np.float32) * 0.3
    W = rng.normal(size=(E + H, 4 * H)).astype(np.float32) * 0.1
    b = rng.normal(size=(4 * H,)).astype(np.float32) * 0.01
    c_j, h_j = jax_cell(*map(jnp.asarray, (x, h, c, W, b)), 1.0,
                        compute_dtype=jd, interpret=True)
    c_t, h_t = lstm_cell_step(*map(torch.from_numpy, (x, h, c, W, b)), 1.0,
                              compute_dtype=td)
    assert c_t.dtype == torch.float32 and h_t.dtype == td
    atol = 1e-5 if dtype == "fp32" else 3e-2
    np.testing.assert_allclose(_np(c_t), _np(c_j), atol=atol)
    np.testing.assert_allclose(_np(h_t), _np(h_j), atol=atol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_cand_dot(dtype):
    """Mirrors test_kernels.py::test_cand_dot.  Tolerance: 1e-4 in fp32; in
    bf16 both sides take the same bf16 inputs and accumulate in fp32, so
    1e-4 holds there too (tighter than the JAX test's 0.15 vs fp32)."""
    from jlm_tpu.ops.cand_dot import cand_dot as jax_cand

    jd, td = DTYPES[dtype]
    S, B, C1, H = 12, 10, 65, 128
    rng = np.random.default_rng(11)
    h3 = rng.normal(size=(S, B, H)).astype(np.float32) * 0.3
    cols = rng.normal(size=(S, C1, H)).astype(np.float32) * 0.3
    bias = rng.normal(size=(S, C1)).astype(np.float32) * 0.1
    out_j = jax_cand(jnp.asarray(h3, jd), jnp.asarray(cols, jd), jnp.asarray(bias),
                     gs=8, interpret=True)
    out_t = cand_dot(torch.from_numpy(h3).to(td), torch.from_numpy(cols).to(td),
                     torch.from_numpy(bias))
    assert out_t.shape == (S, B, C1) and out_t.dtype == torch.float32
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=1e-4)


def _lse_case(seed=4, B=8, H=256, V=2048):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, H)).astype(np.float32)
    w = rng.normal(size=(H, V)).astype(np.float32) * 0.05
    b = rng.normal(size=(V,)).astype(np.float32) * 0.01
    return h, w, b, Config(vocab_size=V, embed_size=64, hidden_size=H)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_project_lse_int8_mxu_matches_jax(dtype):
    """Mirrors test_kernels.py::test_project_lse_int8_mxu_matches_dequant:
    the native int8 x int8 head.  Activation quantization is bit-identical
    to JAX's and the int32 product exact, so only fp32 summation order
    differs: tolerance 1e-5."""
    from jlm_tpu.ops.project import project_lse as jax_lse

    jd, td = DTYPES[dtype]
    h, w, b, cfg = _lse_case()
    q = quantize_weight(w, axis=0)
    head_j = {"W": {"q": jnp.asarray(q["q"]), "scale": jnp.asarray(q["scale"])},
              "b": jnp.asarray(b)}
    head_t = {"W": {"q": torch.from_numpy(q["q"]), "scale": torch.from_numpy(q["scale"])},
              "b": torch.from_numpy(b)}
    lse_j = jax_lse(jnp.asarray(h), head_j, cfg, tile_v=512, compute_dtype=jd,
                    interpret=True, int8_mxu=True)
    lse_t = project_lse(torch.from_numpy(h), head_t, cfg, compute_dtype=td,
                        int8_mxu=True)
    assert lse_t.shape == (8, 1)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j), atol=1e-5)
    # and within the JAX test's 0.05 of the exact-dequant head
    lse_d = jax_lse(jnp.asarray(h), head_j, cfg, tile_v=512, interpret=True)
    np.testing.assert_allclose(_np(lse_t), _np(lse_d), atol=0.05)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_project_lse_fp_head_matches_jax(dtype):
    """fp32 and bf16 weights (fp32 accumulation) vs the JAX kernel; the
    bf16 weight is cast on both sides, so tolerance 1e-4 either way."""
    from jlm_tpu.ops.project import project_lse as jax_lse

    jd, td = DTYPES[dtype]
    h, w, b, cfg = _lse_case(seed=5, V=1000)  # ragged vocab tile
    lse_j = jax_lse(jnp.asarray(h), {"W": jnp.asarray(w, jd), "b": jnp.asarray(b)},
                    cfg, tile_v=512, compute_dtype=jd, interpret=True)
    head_t = {"W": torch.from_numpy(w).to(td), "b": torch.from_numpy(b)}
    lse_t = project_lse(torch.from_numpy(h), head_t, cfg, compute_dtype=td)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j), atol=1e-4)
    m, s = project_ms(torch.from_numpy(h), head_t, cfg, compute_dtype=td)
    np.testing.assert_allclose(_np(m + torch.log(s)), _np(lse_t), atol=1e-6)


def test_quantize_rows_bit_equal_to_jax():
    """The int8 activations and row scales equal JAX's (project.py:83-89:
    division, round half to even), including exact .5 ties and a zero row."""
    rng = np.random.default_rng(9)
    h = rng.normal(size=(16, 256)).astype(np.float32)
    h[3] = 0.0
    h[5, :4] = [127.0, 0.5, -0.5, 1.5]  # scale 1: exact ties 0.5, -0.5, 1.5
    h[5, 4:] = 0.0
    hj = jnp.asarray(h)
    s_j = jnp.maximum(jnp.max(jnp.abs(hj), axis=1, keepdims=True), 1e-30) / 127.0
    q_j = jnp.round(hj / s_j).astype(jnp.int8)
    q_t, s_t = quantize_rows(torch.from_numpy(h))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert list(q_t[5, :4]) == [127, 0, 0, 2]


def test_int8_plain_product_is_exact():
    """torch int8 @ int8 returns int8 (wraps); the plain version multiplies
    as fp32, which is exact for H <= 1040 — compare with an int64 matmul."""
    rng = np.random.default_rng(2)
    H, V = 1040, 64
    q = np.full((4, H), 127, np.int8)
    w = rng.integers(-127, 128, (H, V)).astype(np.int8)
    w[:, 0] = 127
    exact = q.astype(np.int64) @ w.astype(np.int64)
    got = torch.from_numpy(q).float() @ torch.from_numpy(w).float()
    np.testing.assert_array_equal(got.numpy().astype(np.int64), exact)


def test_cpu_wrappers_do_not_count_launches():
    """On CPU tensors the wrappers run the plain versions: no kernel, no
    launch counted, no build."""
    from jlm_tpu_torch.ops import _build

    before = (project_lse.launches, lstm_cell_step.launches, cand_dot.launches)
    h, w, b, cfg = _lse_case()
    project_lse(torch.from_numpy(h), {"W": torch.from_numpy(w), "b": torch.from_numpy(b)}, cfg)
    cand_dot(torch.zeros(2, 3, 8), torch.zeros(2, 5, 8), torch.zeros(2, 5))
    lstm_cell_step(torch.zeros(4, 32), torch.zeros(4, 32), torch.zeros(4, 32),
                   torch.zeros(64, 128), torch.zeros(128))
    assert (project_lse.launches, lstm_cell_step.launches, cand_dot.launches) == before
    assert _build._lib is None


def test_unported_modes_raise():
    """int8 dequant mode and the D-softmax head are not ported: both raise."""
    h, w, b, cfg = _lse_case()
    q = quantize_weight(w, axis=0)
    head = {"W": {"q": torch.from_numpy(q["q"]), "scale": torch.from_numpy(q["scale"])},
            "b": torch.from_numpy(b)}
    with pytest.raises(NotImplementedError):
        project_lse(torch.from_numpy(h), head, cfg, int8_mxu=False)
    with pytest.raises(NotImplementedError):
        project_lse(torch.from_numpy(h), {"blocks": []}, cfg)
