"""The port's fused cell + candidate frame step vs the JAX package's, on the CPU.

``cell_cand_step`` takes numpy-seeded inputs through the JAX function (its
Pallas kernel in interpret mode, as tests/test_kernels.py runs it) and
through the port's wrapper, which runs its plain version on CPU tensors;
tests/test_torch_kernels_cuda.py holds the CUDA kernel to that plain
version on the card.  The fused forward ``make_fused_frame_forward`` goes
through the port's ``BeamDecoder`` and is held to the reference's
``fusedcand`` forward (scripts/profile_frame_combos.py) through the JAX
engine's ``jax.jit(_decode_scan)``, and to the numpy oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jlm_tpu.decoder import engine as jax_engine
from jlm_tpu.oracle import OracleDecoder, OracleLM
from jlm_tpu.ops.frame_step import cell_cand_step as jax_cell_cand
from jlm_tpu_torch.decoder.engine import BeamDecoder, make_fused_frame_forward
from jlm_tpu_torch.ops import frame_step as port

KANAS = ["きょうはいい", "はしをみる", "ゑ"]


def _case(rng, S, B, E, H, C1):
    """tests/test_kernels.py::test_cell_cand_fused's inputs."""
    R = S * B
    return (rng.normal(size=(R, E)).astype(np.float32),
            rng.normal(size=(R, H)).astype(np.float32) * 0.1,
            rng.normal(size=(R, H)).astype(np.float32) * 0.1,
            rng.normal(size=(E + H, 4 * H)).astype(np.float32) * 0.05,
            rng.normal(size=(4 * H,)).astype(np.float32) * 0.01,
            rng.normal(size=(S, C1, H)).astype(np.float32) * 0.1,
            rng.normal(size=(S, C1)).astype(np.float32) * 0.01)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("S,B,E,H,C1", [(12, 10, 64, 128, 17), (4, 8, 32, 64, 9)])
def test_cell_cand_step_matches_jax(S, B, E, H, C1, dtype):
    """test_cell_cand_fused's two shapes (beam pads 10 and 8).  fp32: c', h'
    within 1e-5 and the candidate logits within 1e-4 (the JAX test's
    bounds).  bf16: both sides round x, h, W and cols to bf16 and sum in
    fp32; c' within 1e-5, h' (bf16) within one bf16 rounding (4e-3 at
    |h'| < 1: a sum-order difference may round it the other way), and the
    candidate logits, which read that h', within 1e-3."""
    rng = np.random.default_rng(21)
    arrays = _case(rng, S, B, E, H, C1)
    jd, td = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    c_j, h_j, cand_j = jax_cell_cand(*map(jnp.asarray, arrays[:5]), jnp.asarray(arrays[5]),
                                     jnp.asarray(arrays[6]), B, 1.0, compute_dtype=jd,
                                     interpret=True)
    c_t, h_t, cand_t = port.cell_cand_step(*map(torch.from_numpy, arrays), B, 1.0,
                                           compute_dtype=td)
    assert c_t.dtype == torch.float32 and h_t.dtype == td and cand_t.dtype == torch.float32
    assert cand_t.shape == (S, B, C1)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-5)
    h_tol, cand_tol = (1e-5, 1e-4) if dtype == "fp32" else (4e-3, 1e-3)
    np.testing.assert_allclose(h_t.float().numpy(), np.asarray(h_j, np.float32), atol=h_tol)
    np.testing.assert_allclose(cand_t.numpy(), np.asarray(cand_j), atol=cand_tol)


def _jax_fusedcand_forward(config):
    """scripts/profile_frame_combos.py's ``fusedcand`` forward in fp32, its
    kernels in interpret mode."""
    from jlm_tpu.models.lstm import embed
    from jlm_tpu.ops.project import project_lse

    base = jax_engine.make_pallas_forward(config, tile_v=128)

    def forward(p, words, state, payload):
        S, B = words.shape
        x = embed(p, words.reshape(S * B))
        c, h = state
        layer = p["_decode"]["lstm_c"][0]
        c_l, h_top, raw = jax_cell_cand(
            x, h[0], c[0], layer["W"], layer["b"], payload["cols"], payload["bias"], B,
            config.forget_bias, compute_dtype=jnp.float32, interpret=True)
        lse = project_lse(h_top, p["_decode"]["head_c"], config, tile_v=128,
                          compute_dtype=jnp.float32, interpret=True)
        logp = raw - lse.reshape(S, B, 1)
        return logp[:, :, :-1], logp[:, :, -1], (c_l[None], h_top.astype(jnp.float32)[None])

    forward.prepare = base.prepare
    forward.compute_dtype = jnp.float32
    return forward


def test_fused_frame_forward_matches_jax(tiny_params, tiny_config, lexicon, vocab):
    """The port's BeamDecoder with ``make_fused_frame_forward(cfg, fp32)`` on
    the CPU vs the JAX engine with the reference's fusedcand forward and vs
    the numpy oracle, at the TINY config: identical top-1 paths, scores
    within 1e-4 of JAX's and 1e-3 of the oracle's (test_engine_modes'
    fp32 bound)."""
    cfg = tiny_config
    port_res = BeamDecoder(tiny_params, lexicon, vocab, cfg, device="cpu",
                           forward_fn=make_fused_frame_forward(cfg, torch.float32)
                           ).decode_batch(KANAS)
    jax_res = jax_engine.BeamDecoder(tiny_params, lexicon, vocab, cfg,
                                     forward_fn=_jax_fusedcand_forward(cfg)).decode_batch(KANAS)
    oracle = OracleDecoder(OracleLM(tiny_params, cfg), lexicon, vocab, cfg)
    for kana, r_t, r_j in zip(KANAS, port_res, jax_res):
        r_o = oracle.decode(kana)[0]
        assert r_t[0].segments == r_j[0].segments == r_o.segments, kana
        assert abs(r_t[0].score - r_j[0].score) <= 1e-4, kana
        assert abs(r_t[0].score - r_o.score) <= 1e-3, kana


def test_fused_frame_forward_takes_one_layer(tiny_config):
    """The fused frame is the reference variant's one-layer frame."""
    with pytest.raises(ValueError, match="one layer"):
        make_fused_frame_forward(tiny_config.replace(num_layers=2))
    fwd = make_fused_frame_forward(tiny_config)
    assert fwd.compute_dtype == torch.bfloat16 and fwd.prepare is not None


def test_cpu_cell_cand_does_not_count_launches():
    """On CPU tensors the wrapper runs its plain version: no kernel, no
    launch counted, no build."""
    from jlm_tpu_torch.ops import _build

    rng = np.random.default_rng(5)
    before = port.cell_cand_step.launches
    port.cell_cand_step(*map(torch.from_numpy, _case(rng, 3, 8, 32, 64, 9)), 8,
                        compute_dtype=torch.bfloat16)
    assert port.cell_cand_step.launches == before
    assert _build._lib is None
