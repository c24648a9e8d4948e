"""The port's kernel forward in its other modes vs the JAX engine and the
numpy oracle: D-softmax heads (prefix and disjoint; bf16 and int8-MXU
weights), fp32 compute, and the int8 dequant head.

Everything runs on the CPU: the port's kernel forward takes its plain
versions there, the JAX Pallas forward its kernels in interpret mode.
Tolerances follow tests/test_engine_parity.py: fp32 scores within 1e-3,
bf16 speed mode within 0.1, int8-MXU within 0.2.
"""

import inspect

import jax.numpy as jnp
import pytest
import torch

from jlm_tpu.config import Config, DSoftmaxConfig
from jlm_tpu.decoder import engine as jax_engine
from jlm_tpu.models import init_params
from jlm_tpu.oracle import OracleDecoder, OracleLM
from jlm_tpu.ops.quant import quantize_params
from jlm_tpu_torch.decoder.engine import BeamDecoder, make_kernel_forward

KANAS = ["きょうはいい", "はしをみる"]


def _dsoftmax_config(mode):
    """tests/test_engine_parity.py::test_dsoftmax_engine_parity's config;
    disjoint mode takes block dims that fit H = 64 end to end."""
    dims = (64, 32, 16) if mode == "prefix" else (32, 16, 16)
    return Config(vocab_size=256, embed_size=32, hidden_size=64, head="dsoftmax",
                  dsoftmax=DSoftmaxConfig(block_sizes=(64, 64, 128), block_dims=dims,
                                          mode=mode),
                  beam_width=4, max_kana_len=30, seed=42)


def _check(port, jax, oracle, tol):
    for kana, r_t, r_j, r_o in zip(KANAS, port, jax, oracle):
        assert r_t[0].segments == r_o.segments == r_j[0].segments, kana
        assert abs(r_t[0].score - r_o.score) < tol, kana
        assert abs(r_t[0].score - r_j[0].score) < tol, kana


@pytest.mark.parametrize("weights", ["bf16", "int8"])
@pytest.mark.parametrize("mode", ["prefix", "disjoint"])
def test_dsoftmax_speed_mode(lexicon, vocab, mode, weights):
    """BeamDecoder(precision="default") on a D-softmax head (the kernel
    forward in bf16: one projection per block, merged) vs the JAX Pallas
    bf16 engine and the oracle (int8: the native int8 x int8 head against
    the int8 oracle).  Top-1 equal to both; scores within 0.1 (bf16) or 0.2
    (int8)."""
    cfg = _dsoftmax_config(mode)
    params = init_params(cfg)
    if weights == "int8":
        params = quantize_params(params)
    port = BeamDecoder(params, lexicon, vocab, cfg, precision="default",
                       device="cpu").decode_batch(KANAS)
    fwd = jax_engine.make_pallas_forward(cfg, compute_dtype=jnp.bfloat16, tile_v=128,
                                         int8_mxu=weights == "int8")
    jx = jax_engine.BeamDecoder(params, lexicon, vocab, cfg, forward_fn=fwd).decode_batch(KANAS)
    orc = OracleDecoder(OracleLM(params, cfg), lexicon, vocab, cfg)
    _check(port, jx, [orc.decode(k)[0] for k in KANAS], 0.1 if weights == "bf16" else 0.2)


@pytest.mark.parametrize("head", ["full", "dsoftmax"])
def test_fp32_kernel_forward(tiny_params, tiny_config, lexicon, vocab, head):
    """make_kernel_forward(cfg, torch.float32) (exact fp32 cell, head and
    candidate dots) vs JAX make_pallas_forward's fp32 default and the
    oracle, as test_engine_parity.py::test_pallas_forward_top1_parity: top-1
    equal, scores within 1e-3.  The ring caches are fp32."""
    cfg, params = tiny_config, tiny_params
    if head == "dsoftmax":
        cfg = _dsoftmax_config("prefix")
        params = init_params(cfg)
    fwd_t = make_kernel_forward(cfg, torch.float32)
    assert fwd_t.compute_dtype == torch.float32
    port = BeamDecoder(params, lexicon, vocab, cfg, forward_fn=fwd_t,
                       device="cpu").decode_batch(KANAS)
    fwd = jax_engine.make_pallas_forward(cfg, tile_v=128)
    jx = jax_engine.BeamDecoder(params, lexicon, vocab, cfg, forward_fn=fwd).decode_batch(KANAS)
    orc = OracleDecoder(OracleLM(params, cfg), lexicon, vocab, cfg)
    _check(port, jx, [orc.decode(k)[0] for k in KANAS], 1e-3)


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_int8_dequant_forward(tiny_params, tiny_config, lexicon, vocab, compute):
    """The int8 dequant head (int8_mxu=False: q * scale rounded once to the
    compute dtype before the product) vs JAX make_pallas_forward(int8_mxu=
    False) and the int8 oracle.  fp32 compute mirrors test_engine_parity.py::
    test_pallas_forward_int8_parity (scores within 1e-3); bf16 compute is
    BASELINE config 4's engine, ``config.replace(int8_mxu=False)`` with
    precision="default" (within 0.1)."""
    qp = quantize_params(tiny_params)
    cfg = tiny_config.replace(int8_mxu=False)
    if compute == "fp32":
        port_eng = BeamDecoder(qp, lexicon, vocab, tiny_config, device="cpu",
                               forward_fn=make_kernel_forward(tiny_config, torch.float32,
                                                              int8_mxu=False))
        fwd = jax_engine.make_pallas_forward(tiny_config, tile_v=128, int8_mxu=False)
    else:
        port_eng = BeamDecoder(qp, lexicon, vocab, cfg, precision="default", device="cpu")
        fwd = jax_engine.make_pallas_forward(cfg, compute_dtype=jnp.bfloat16, tile_v=128)
    jx = jax_engine.BeamDecoder(qp, lexicon, vocab, cfg, forward_fn=fwd).decode_batch(KANAS)
    orc = OracleDecoder(OracleLM(qp, tiny_config), lexicon, vocab, tiny_config)
    _check(port_eng.decode_batch(KANAS), jx, [orc.decode(k)[0] for k in KANAS],
           1e-3 if compute == "fp32" else 0.1)


def test_entry_points_default_to_the_card(tiny_params, tiny_config, lexicon, vocab):
    """BeamDecoder, Trainer and train_lm take ``device="cuda"`` by default;
    without a card that raises rather than running on the CPU."""
    from jlm_tpu_torch.train import Trainer, train_lm

    for fn in (BeamDecoder.__init__, Trainer.__init__, train_lm):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            BeamDecoder(tiny_params, lexicon, vocab, tiny_config)
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(tiny_config)
