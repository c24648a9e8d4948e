"""The port's candidate extraction vs the JAX package's, on the CPU.

``project_candidates`` and ``project_candidates_dsoftmax`` take numpy-seeded
inputs through the JAX functions (their Pallas kernel in interpret mode, as
tests/test_kernels.py runs it) and through the port's wrappers, which run
their plain versions on CPU tensors; tests/test_torch_kernels_cuda.py holds
the kernel's candidate epilogue to those plain versions on the card.
Tolerances: 1e-5 in fp32 (sum order only), 1e-4 for int8 weights (exact
int32 products or one rounding of q * scale; fp32 sums), 1e-3 where the
compute dtype is bf16 (both sides round the same bf16 operands).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jlm_tpu.config import Config, DSoftmaxConfig
from jlm_tpu.ops import project as jax_project
from jlm_tpu.ops.quant import quantize_weight
from jlm_tpu_torch.ops import project as port

# weights: (quantized, compute dtype JAX / port, int8_mxu, tolerance)
_MODES = {
    "fp32": (False, jnp.float32, torch.float32, False, 1e-5),
    "dequant_fp32": (True, jnp.float32, torch.float32, False, 1e-4),
    "dequant_bf16": (True, jnp.bfloat16, torch.bfloat16, False, 1e-3),
    "int8_mxu": (True, jnp.bfloat16, torch.bfloat16, True, 1e-4),
}


def _np(x):
    return np.asarray(x, np.float32)


def _clear_of_ties(h, widths):
    """True when the jitted JAX quantization of each row slice (bf16, as
    both kernels take it) equals the port's.  On the CPU, XLA divides by
    the reciprocal, so a ratio ``h / s`` of -63.499996 comes out -63.500004
    and rounds the other way; the port and its CUDA kernel divide exactly.
    The int8-MXU cases pick inputs clear of such ties."""
    quant = jax.jit(lambda x: jnp.round(x / (jnp.maximum(
        jnp.max(jnp.abs(x), axis=1, keepdims=True), 1e-30) / 127.0)))
    for off, d in widths:
        x = torch.from_numpy(h[:, off:off + d]).to(torch.bfloat16)
        q_j = np.asarray(quant(jnp.asarray(x.float().numpy())))
        if not np.array_equal(q_j, port.quantize_rows(x)[0].numpy()):
            return False
    return True


def _weights(w, quantized):
    """(JAX weight, scale), (port weight, scale) of the same fp32 w."""
    if not quantized:
        return (jnp.asarray(w), None), (torch.from_numpy(w), None)
    q = quantize_weight(w, axis=0)
    return ((jnp.asarray(q["q"]), jnp.asarray(q["scale"])),
            (torch.from_numpy(q["q"]), torch.from_numpy(q["scale"])))


@pytest.mark.parametrize("weights", list(_MODES))
def test_project_candidates_matches_jax(weights):
    """Full head, V = 1000 (ragged against the 512-column JAX tile and the
    kernel's 64-column tile), C = 150 > 128 with repeated ids, the vocab
    edges 0 and 999, and an id of -1 (no column: -lse on both sides)."""
    quantized, jd, td, mxu, tol = _MODES[weights]
    rng = np.random.default_rng(41)
    R, H, V = 16, 256, 1000
    h = rng.normal(size=(R, H)).astype(np.float32)
    assert not mxu or _clear_of_ties(h, [(0, H)])
    w = rng.normal(size=(H, V)).astype(np.float32) * 0.05
    b = rng.normal(size=(V,)).astype(np.float32) * 0.01
    cand = rng.integers(0, V, 150).astype(np.int32)
    cand[:6] = [0, 999, 500, 500, -1, 999]
    (wj, sj), (wt, st) = _weights(w, quantized)
    if not quantized:
        wj, wt = wj.astype(jd), wt.to(td)
    out_j = jax_project.project_candidates(
        jnp.asarray(h), wj, sj, jnp.asarray(b), jnp.asarray(cand), tile_v=512,
        compute_dtype=jd, interpret=True, int8_mxu=mxu)
    out_t = port.project_candidates(torch.from_numpy(h), wt, st, torch.from_numpy(b),
                                    torch.from_numpy(cand), compute_dtype=td, int8_mxu=mxu)
    assert out_t.shape == (R, 150) and out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), atol=tol)
    np.testing.assert_array_equal(out_t[:, 2].numpy(), out_t[:, 3].numpy())
    lse = port.project_lse(torch.from_numpy(h), port._full_head(wt, st, torch.from_numpy(b)),
                           compute_dtype=td, int8_mxu=mxu)
    np.testing.assert_allclose(out_t[:, 4].numpy(), -lse[:, 0].numpy(), atol=1e-6)


def test_project_candidates_normalization():
    """exp(logp) over every vocab id sums to 1: the lse is global
    (test_kernels.py::test_project_candidates_normalization)."""
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.normal(size=(2, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64, 256)).astype(np.float32) * 0.1)
    out = port.project_candidates(h, w, None, torch.zeros(256), torch.arange(256))
    np.testing.assert_allclose(out.exp().sum(dim=1).numpy(), 1.0, rtol=1e-5)


_SIZES = (100, 200, 300)
_DIMS = {"prefix": (128, 64, 32), "disjoint": (64, 32, 32)}


@pytest.mark.parametrize("weights", ["fp32", "int8_mxu"])
@pytest.mark.parametrize("mode", ["prefix", "disjoint"])
def test_project_candidates_dsoftmax_matches_jax(mode, weights):
    """A D-softmax head (blocks of 100, 200 and 300 words on their slices
    of H = 128) vs JAX's per-block calls with merged lse; ids at every
    block edge, repeated, and one of -1.  Inputs clear of int8 rounding
    ties (``_clear_of_ties``)."""
    quantized, jd, td, mxu, tol = _MODES[weights]
    rng = np.random.default_rng(45)
    cfg = Config(vocab_size=sum(_SIZES), embed_size=64, hidden_size=128, head="dsoftmax",
                 dsoftmax=DSoftmaxConfig(block_sizes=_SIZES, block_dims=_DIMS[mode],
                                         mode=mode))
    h = rng.normal(size=(12, 128)).astype(np.float32)
    offs = [0] * 3 if mode == "prefix" else [0, 64, 96]
    assert not mxu or _clear_of_ties(h, list(zip(offs, _DIMS[mode])))
    blocks_j, blocks_t = [], []
    for n, d in zip(_SIZES, _DIMS[mode]):
        w = rng.normal(size=(d, n)).astype(np.float32) * 0.05
        b = rng.normal(size=(n,)).astype(np.float32) * 0.01
        (wj, sj), (wt, st) = _weights(w, quantized)
        blocks_j.append({"W": wj if sj is None else {"q": wj, "scale": sj},
                         "b": jnp.asarray(b)})
        blocks_t.append({"W": wt if st is None else {"q": wt, "scale": st},
                         "b": torch.from_numpy(b)})
    cand = np.asarray([0, 99, 100, 299, 300, 599, 299, 42, -1, 450, 100], np.int32)
    out_j = jax_project.project_candidates_dsoftmax(
        jnp.asarray(h), blocks_j, cfg, jnp.asarray(cand), tile_v=128, compute_dtype=jd,
        interpret=True, int8_mxu=mxu)
    out_t = port.project_candidates_dsoftmax(torch.from_numpy(h), blocks_t, cfg,
                                             torch.from_numpy(cand), compute_dtype=td,
                                             int8_mxu=mxu)
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), atol=tol)
    lse = port.project_lse(torch.from_numpy(h), {"blocks": blocks_t}, cfg,
                           compute_dtype=td, int8_mxu=mxu)
    np.testing.assert_allclose(out_t[:, 8].numpy(), -lse[:, 0].numpy(), atol=1e-6)


def test_cpu_candidate_wrappers_do_not_count_launches():
    """On CPU tensors the candidate wrappers run their plain versions: no
    kernel, no launch counted (neither theirs nor project_lse's), no build."""
    from jlm_tpu_torch.ops import _build

    before = (port.project_candidates.launches, port.project_lse.launches)
    w = torch.zeros(64, 128)
    port.project_candidates(torch.ones(3, 64), w, None, torch.zeros(128), torch.arange(5))
    cfg = Config(vocab_size=128, hidden_size=64, head="dsoftmax",
                 dsoftmax=DSoftmaxConfig(block_sizes=(32, 96), block_dims=(64, 32)))
    port.project_candidates_dsoftmax(
        torch.ones(3, 64), [{"W": torch.zeros(64, 32), "b": torch.zeros(32)},
                            {"W": torch.zeros(32, 96), "b": torch.zeros(96)}],
        cfg, torch.arange(5))
    assert (port.project_candidates.launches, port.project_lse.launches) == before
    assert _build._lib is None
