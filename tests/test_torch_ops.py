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

from jlm_tpu.config import Config, DSoftmaxConfig
from jlm_tpu.ops.quant import quantize_weight
from jlm_tpu_torch.ops.cand_dot import cand_dot
from jlm_tpu_torch.ops.lstm_cell import lstm_cell_step
from jlm_tpu_torch.ops.project import merge_ms, project_lse, project_ms, quantize_rows

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


def test_dequant_and_one_block_heads_run():
    """Two modes the port once refused run: the int8 dequant
    mode (``int8_mxu=False``) equals JAX's exact-dequant kernel (1e-5: the
    dequantized weight and the fp32 product are the same on both sides),
    and a D-softmax head of one full-width block equals the full head."""
    from jlm_tpu.ops.project import project_lse as jax_lse

    h, w, b, cfg = _lse_case()
    q = quantize_weight(w, axis=0)
    head = {"W": {"q": torch.from_numpy(q["q"]), "scale": torch.from_numpy(q["scale"])},
            "b": torch.from_numpy(b)}
    lse_t = project_lse(torch.from_numpy(h), head, cfg, int8_mxu=False)
    head_j = {"W": {"q": jnp.asarray(q["q"]), "scale": jnp.asarray(q["scale"])},
              "b": jnp.asarray(b)}
    lse_j = jax_lse(jnp.asarray(h), head_j, cfg, tile_v=512, interpret=True)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j), atol=1e-5)
    one = cfg.replace(head="dsoftmax", dsoftmax=DSoftmaxConfig(
        block_sizes=(cfg.vocab_size,), block_dims=(cfg.hidden_size,)))
    lse_b = project_lse(torch.from_numpy(h), {"blocks": [head]}, one, int8_mxu=False)
    np.testing.assert_array_equal(_np(lse_b), _np(lse_t))


# D-softmax heads at a TINY size: V = 600 over blocks of 100, 200 and 300
# words (ragged against the JAX kernel's 128-column tiles), H = 128.
_BLOCK_SIZES = (100, 200, 300)
_BLOCK_DIMS = {"prefix": (128, 64, 32), "disjoint": (64, 32, 32)}
# weight x compute: (JAX compute dtype, port compute dtype, quantized,
# int8_mxu, tolerance).  fp32: sum order only; bf16: both sides round the
# same bf16 operands, fp32 sums (the stated 1e-3); int8: exact int32
# products or one rounding of q * scale, fp32 sums.
_BLOCK_MODES = {
    "fp32": (jnp.float32, torch.float32, False, False, 1e-5),
    "bf16": (jnp.bfloat16, torch.bfloat16, False, False, 1e-3),
    "int8_mxu": (jnp.bfloat16, torch.bfloat16, True, True, 1e-4),
    "int8_dequant": (jnp.float32, torch.float32, True, False, 1e-4),
}


def _blocks_case(mode, seed=21, R=8):
    rng = np.random.default_rng(seed)
    dims = _BLOCK_DIMS[mode]
    H = 128
    cfg = Config(vocab_size=sum(_BLOCK_SIZES), embed_size=64, hidden_size=H,
                 head="dsoftmax", dsoftmax=DSoftmaxConfig(
                     block_sizes=_BLOCK_SIZES, block_dims=dims, mode=mode))
    h = rng.normal(size=(R, H)).astype(np.float32)
    blocks = [(rng.normal(size=(d, n)).astype(np.float32) * 0.05,
               rng.normal(size=(n,)).astype(np.float32) * 0.01)
              for n, d in zip(_BLOCK_SIZES, dims)]
    return h, blocks, cfg


def _heads(blocks, quantized, jd, td):
    """(JAX head, port head) of the same blocks; fp weights cast to the
    compute dtype on both sides, as build_decode_head does."""
    head_j, head_t = [], []
    for w, b in blocks:
        if quantized:
            q = quantize_weight(w, axis=0)
            head_j.append({"W": {"q": jnp.asarray(q["q"]), "scale": jnp.asarray(q["scale"])},
                           "b": jnp.asarray(b)})
            head_t.append({"W": {"q": torch.from_numpy(q["q"]),
                                 "scale": torch.from_numpy(q["scale"])},
                           "b": torch.from_numpy(b)})
        else:
            head_j.append({"W": jnp.asarray(w, jd), "b": jnp.asarray(b)})
            head_t.append({"W": torch.from_numpy(w).to(td), "b": torch.from_numpy(b)})
    return {"blocks": head_j}, {"blocks": head_t}


@pytest.mark.parametrize("weights", list(_BLOCK_MODES))
@pytest.mark.parametrize("mode", ["prefix", "disjoint"])
def test_project_lse_blocks_matches_jax(mode, weights):
    """A D-softmax head (one call per block on its slice of h, partials
    merged) vs jlm_tpu.ops.project.project_lse in interpret mode, for each
    weight mode; project_ms merges to the same lse."""
    from jlm_tpu.ops.project import project_lse as jax_lse

    jd, td, quantized, int8_mxu, tol = _BLOCK_MODES[weights]
    h, blocks, cfg = _blocks_case(mode)
    head_j, head_t = _heads(blocks, quantized, jd, td)
    lse_j = jax_lse(jnp.asarray(h), head_j, cfg, tile_v=128, compute_dtype=jd,
                    interpret=True, int8_mxu=int8_mxu)
    lse_t = project_lse(torch.from_numpy(h), head_t, cfg, compute_dtype=td,
                        int8_mxu=int8_mxu)
    assert lse_t.shape == (8, 1)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j), atol=tol)
    m, s = project_ms(torch.from_numpy(h), head_t, cfg, compute_dtype=td,
                      int8_mxu=int8_mxu)
    np.testing.assert_allclose(_np(m + torch.log(s)), _np(lse_t), atol=1e-6)


def test_int8_activation_scale_is_per_slice():
    """int8-MXU blocks quantize each row over the block's OWN slice of h
    (project.py:430 passes the slice to :83-89), not over all H: with the
    largest |h| outside every prefix but the first, the port equals JAX
    (1e-4), and a scale taken over all H reads far outside that bound."""
    from jlm_tpu.ops.project import project_lse as jax_lse

    h, blocks, cfg = _blocks_case("prefix", seed=22)
    h[:, 100] = 40.0  # column 100: inside block 0's 128, outside 64 and 32
    blocks[0][0][100] = 0.0  # so that block 0's logits do not swamp the lse
    head_j, head_t = _heads(blocks, True, jnp.float32, torch.float32)
    lse_j = jax_lse(jnp.asarray(h), head_j, cfg, tile_v=128, interpret=True,
                    int8_mxu=True)
    ht = torch.from_numpy(h)
    lse_t = project_lse(ht, head_t, cfg, int8_mxu=True)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j), atol=1e-4)

    _, s_all = quantize_rows(ht)  # the wrong rule: one scale over all H
    ms, ss = [], []
    for blk, d in zip(head_t["blocks"], cfg.dsoftmax.block_dims):
        q = torch.round(ht[:, :d] / s_all)
        logits = (q @ blk["W"]["q"].float()) * s_all * blk["W"]["scale"] + blk["b"]
        ms.append(logits.amax(1, keepdim=True))
        ss.append(torch.exp(logits - ms[-1]).sum(1, keepdim=True))
    m, s = merge_ms(ms, ss)
    assert float((m + torch.log(s) - lse_t).abs().max()) > 1e-3


def test_block_plan_is_kept_on_a_prepared_head():
    """The launch plan of a head whose every block carries "WT" (as
    build_decode_head makes it) is checked once and kept under "_plan";
    a head without "WT" is planned on every call; another mode plans
    anew; a tensor the kernel cannot read raises."""
    from jlm_tpu_torch.ops.project import DEQUANT_FP32, INT8_MXU, _block_plan

    _, blocks, cfg = _blocks_case("disjoint")
    _, head = _heads(blocks, True, jnp.float32, torch.float32)
    cpu = torch.device("cpu")
    plan = _block_plan(head, cfg, 128, cpu, torch.float32, False)
    assert "_plan" not in head
    assert [p[:2] + (p[3],) for p in plan] == [
        (0, 64, DEQUANT_FP32), (64, 32, DEQUANT_FP32), (96, 32, DEQUANT_FP32)]
    for blk in head["blocks"]:
        blk["WT"] = blk["W"]["q"].t().contiguous()
    plan = _block_plan(head, cfg, 128, cpu, torch.float32, False)
    assert head["_plan"][1] is plan
    assert _block_plan(head, cfg, 128, cpu, torch.float32, False) is plan
    mxu = _block_plan(head, cfg, 128, cpu, torch.bfloat16, True)
    assert mxu is not plan and {p[3] for p in mxu} == {INT8_MXU}
    bad = {"blocks": [dict(blk, b=blk["b"].double()) for blk in head["blocks"]]}
    with pytest.raises(ValueError, match="fp32"):
        _block_plan(bad, cfg, 128, cpu, torch.float32, False)
