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
    """The D-softmax head is not ported to the decode path yet: building
    its decode head raises (head_logits takes it; tests/test_torch_train.py
    holds that to JAX)."""
    from jlm_tpu_torch.decoder.engine import build_decode_head

    cfg = Config(vocab_size=256, embed_size=32, hidden_size=64, head="dsoftmax",
                 dsoftmax=DSoftmaxConfig(block_sizes=(64, 192), block_dims=(64, 32)), seed=5)
    tparams = params_to_torch(init_params(cfg), "cpu")
    with pytest.raises(NotImplementedError, match="D-softmax"):
        build_decode_head(tparams, cfg)
    assert torch_lstm.head_logits(tparams, cfg, torch.zeros(2, 64)).shape == (2, 256)
