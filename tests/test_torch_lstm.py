"""PyTorch port LM core (jlm_tpu_torch.models.lstm) vs jlm_tpu.models.lstm.

The port's plain functions are the fp32 parity forward and every kernel's
reference, so they are held to the JAX functions at fp32 ("highest")
precision: tolerance 1e-5 (fp32 summation order only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jlm_tpu.config import Config, DSoftmaxConfig
from jlm_tpu.models import init_params
from jlm_tpu.models import lstm as jax_lstm
from jlm_tpu.ops.quant import quantize_params
from jlm_tpu_torch.models import lstm as torch_lstm
from jlm_tpu_torch.models.params import params_to_torch

CFG = Config(vocab_size=256, embed_size=32, hidden_size=64, num_layers=2, seed=5)


@pytest.mark.parametrize("quantized", [False, True])
def test_step_logp_matches_jax(quantized):
    """Three LM steps from the initial state through both layers: log-probs
    and (c, h) equal JAX's, with int8 embedding/cell/head dequant included."""
    params = init_params(CFG)
    if quantized:
        params = quantize_params(params)
    tparams = params_to_torch(params, "cpu")
    rng = np.random.default_rng(3)
    state_j = jax_lstm.initial_state(CFG, 6)
    state_t = torch_lstm.initial_state(CFG, 6, "cpu")
    for a, b in zip(state_t, state_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for _ in range(3):
        ids = rng.integers(0, CFG.vocab_size, 6).astype(np.int32)
        logp_j, state_j = jax_lstm.step_logp(params, CFG, jnp.asarray(ids), state_j)
        logp_t, state_t = torch_lstm.step_logp(tparams, CFG, torch.from_numpy(ids).long(),
                                               state_t)
        np.testing.assert_allclose(logp_t.numpy(), np.asarray(logp_j), atol=1e-5)
        for a, b in zip(state_t, state_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_dsoftmax_head_raises():
    """The D-softmax decode head this test once saw refused is built now:
    ``build_decode_head`` on a blocks head, prefix and disjoint, fp32 and
    int8, equals JAX's ``head_T`` and ``bias`` bit for bit in fp32; the
    projection head keeps each block's weight (int8 dicts pass through)
    with its ``[s_k, d_k]`` transpose ``WT``.  (``head_logits`` takes the
    head too; tests/test_torch_train.py holds that to JAX.)"""
    from jlm_tpu.decoder.engine import build_decode_head as jax_head
    from jlm_tpu_torch.decoder.engine import build_decode_head

    for mode, dims in (("prefix", (64, 32)), ("disjoint", (32, 32))):
        cfg = Config(vocab_size=256, embed_size=32, hidden_size=64, head="dsoftmax",
                     dsoftmax=DSoftmaxConfig(block_sizes=(64, 192), block_dims=dims,
                                             mode=mode), seed=5)
        for params in (init_params(cfg), quantize_params(init_params(cfg))):
            tparams = params_to_torch(params, "cpu")
            got = build_decode_head(tparams, cfg)
            want = jax_head(params, cfg, jnp.float32)
            np.testing.assert_array_equal(got["head_T"].numpy(), np.asarray(want["head_T"]))
            np.testing.assert_array_equal(got["bias"].numpy(), np.asarray(want["bias"]))
            for blk, src, d in zip(got["head_c"]["blocks"], tparams["head"]["blocks"], dims):
                W = src["W"]
                q = W["q"] if isinstance(W, dict) else W
                assert blk["W"] is W if isinstance(W, dict) else torch.equal(blk["W"], W)
                assert blk["WT"].shape == (q.shape[1], d) and blk["WT"].is_contiguous()
                assert torch.equal(blk["WT"], q.t())
            assert torch_lstm.head_logits(tparams, cfg, torch.zeros(2, 64)).shape == (2, 256)
