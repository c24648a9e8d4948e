"""The port's fused LSTM scan (jlm_tpu_torch.ops.lstm_scan) vs the JAX
package's (jlm_tpu.ops.lstm_scan), on the CPU.

The same numpy-seeded inputs go through JAX's ``lstm_scan`` (Pallas in
interpret mode) and the port's, which runs its plain versions on CPU
tensors.  Tolerances mirror tests/test_kernels.py: outputs 1e-5 abs, grads
2e-4 abs + 1e-4 rel (fp32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jlm_tpu.models import lstm as jax_lstm
from jlm_tpu.models.params import init_params
from jlm_tpu.ops.lstm_scan import lstm_scan as jax_scan
from jlm_tpu.ops.lstm_scan import lstm_scan_ref as jax_scan_ref
from jlm_tpu_torch.config import Config
from jlm_tpu_torch.models import lstm
from jlm_tpu_torch.models.params import params_to_torch
from jlm_tpu_torch.ops import lstm_scan as ls


def _inputs(seed, B, T, E, H):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(B, T, E)).astype(np.float32) * 0.1
    W = rng.normal(size=(E + H, 4 * H)).astype(np.float32) * 0.05
    b = rng.normal(size=(4 * H,)).astype(np.float32) * 0.01
    c0 = rng.normal(size=(B, H)).astype(np.float32) * 0.1
    h0 = rng.normal(size=(B, H)).astype(np.float32) * 0.1
    wh = rng.normal(size=(B, T, H)).astype(np.float32)
    wc = rng.normal(size=(B, H)).astype(np.float32)
    return (xs, W, b, c0, h0), wh, wc


def _jax_run(args, wh, wc, TB, cd):
    """JAX outputs and the grads of all five inputs from all three outputs."""
    def loss(*a):
        hs, cf, hf = jax_scan(*a, 1.0, TB, cd, True)
        return jnp.sum(hs * wh) + jnp.sum(cf * wc) + jnp.sum(hf * wc), (hs, cf, hf)

    (_, outs), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *map(jnp.asarray, args))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _port_run(args, wh, wc, cd):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    outs = ls.lstm_scan(*leaves, 1.0, cd)
    hs, cf, hf = outs
    loss = ((hs * torch.from_numpy(wh)).sum() + (cf * torch.from_numpy(wc)).sum()
            + (hf * torch.from_numpy(wc)).sum())
    grads = torch.autograd.grad(loss, leaves)
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


@pytest.mark.parametrize("B,T,E,H,TB", [(16, 8, 32, 64, 8), (4, 16, 32, 64, 8)])
def test_lstm_scan_matches_jax(B, T, E, H, TB):
    """hs, c_T, h_T within 1e-5; grads of xs, W, b, c0, h0 from all three
    outputs within 2e-4 abs + 1e-4 rel; no kernel launched on the CPU."""
    args, wh, wc = _inputs(11, B, T, E, H)
    n0 = (ls.lstm_scan_fwd.launches, ls.lstm_scan_bwd.launches)
    outs, grads = _port_run(args, wh, wc, torch.float32)
    assert (ls.lstm_scan_fwd.launches, ls.lstm_scan_bwd.launches) == n0
    outs_j, grads_j = _jax_run(args, wh, wc, TB, jnp.float32)
    for got, want in zip(outs, outs_j):
        np.testing.assert_allclose(got, want, atol=1e-5)
    for got, want, name in zip(grads, grads_j, ["xs", "W", "b", "c0", "h0"]):
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4, err_msg=name)


def test_lstm_scan_bf16_matches_jax():
    """bf16 compute on both sides: x, h and W (and dz, W in the backward)
    rounded to bf16 before each product, products exact in fp32, fp32 sums.
    Only the summation order differs, but that can flip one bf16 rounding of
    h_{t-1} (1 ulp = 2^-8 relative), which later steps carry: outputs
    within 1e-4, grads within 1e-3 abs + 1e-3 rel."""
    args, wh, wc = _inputs(12, 4, 16, 32, 64)
    outs, grads = _port_run(args, wh, wc, torch.bfloat16)
    outs_j, grads_j = _jax_run(args, wh, wc, 8, jnp.bfloat16)
    for got, want in zip(outs, outs_j):
        np.testing.assert_allclose(got, want, atol=1e-4)
    for got, want, name in zip(grads, grads_j, ["xs", "W", "b", "c0", "h0"]):
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3, err_msg=name)


def test_lstm_scan_state_carry_across_windows():
    """Two chained windows of the port == one double-length JAX reference
    scan: hs of the second window and c_T within 1e-5."""
    rng = np.random.default_rng(5)
    B, T, E, H = 4, 16, 32, 64
    xs = rng.normal(size=(B, 2 * T, E)).astype(np.float32) * 0.1
    W = rng.normal(size=(E + H, 4 * H)).astype(np.float32) * 0.05
    b = np.zeros((4 * H,), np.float32)
    z = np.zeros((B, H), np.float32)
    t = torch.from_numpy
    _, c1, h1 = ls.lstm_scan(t(xs[:, :T]), t(W), t(b), t(z), t(z))
    hs2, c2, h2 = ls.lstm_scan(t(xs[:, T:]), t(W), t(b), c1, h1)
    hs_r, cf_r, hf_r = jax_scan_ref(*map(jnp.asarray, (xs, W, b, z, z)))
    np.testing.assert_allclose(hs2.numpy(), np.asarray(hs_r[:, T:]), atol=1e-5)
    np.testing.assert_allclose(c2.numpy(), np.asarray(cf_r), atol=1e-5)
    np.testing.assert_allclose(h2.numpy(), np.asarray(hf_r), atol=1e-5)


def test_lstm_scan_bwd_ref_matches_autograd():
    """The plain backward (the kernel's algorithm: recompute z, carry dc and
    dh) vs autograd through the plain forward: dx, dc0, dh0, and dW and db
    formed from its dz, within 1e-5."""
    args, wh, wc = _inputs(13, 4, 8, 16, 32)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    hs, cs, c_T, h_T = ls.lstm_scan_ref(*leaves, 1.0)
    d_hs, d_c = torch.from_numpy(wh), torch.from_numpy(wc)
    loss = (hs * d_hs).sum() + (c_T * d_c).sum() + (h_T * d_c).sum()
    want = torch.autograd.grad(loss, leaves)
    xs, W, b, c0, h0 = (torch.from_numpy(a) for a in args)
    dz, dx, dc0, dh0 = ls.lstm_scan_bwd_ref(xs, W, b, c0, h0, hs.detach(), cs.detach(),
                                            d_hs, d_c, d_c, 1.0)
    h_prev = torch.cat([h0[:, None], hs.detach()[:, :-1]], dim=1)
    dW = torch.cat([xs, h_prev], dim=2).reshape(-1, W.shape[0]).t() @ dz.reshape(-1, W.shape[1])
    for got, w in zip((dx, dW, dz.sum(dim=(0, 1)), dc0, dh0), want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=1e-5)


def test_forward_hidden_scan_matches_jax_pallas():
    """Two layers: the port's forward_hidden_scan vs JAX's
    forward_hidden_pallas (interpret mode): hs and the carried state within
    1e-5."""
    cfg = Config(vocab_size=256, embed_size=16, hidden_size=32, num_layers=2, seed=5)
    params = init_params(cfg)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 256, (4, 8)).astype(np.int32)
    c0, h0 = (rng.normal(size=(2, 4, 32)).astype(np.float32) * 0.1 for _ in range(2))
    hs_j, (c_j, h_j) = jax_lstm.forward_hidden_pallas(
        params, cfg, jnp.asarray(ids), (jnp.asarray(c0), jnp.asarray(h0)),
        time_block=8, interpret=True)
    hs_t, (c_t, h_t) = lstm.forward_hidden_scan(
        params_to_torch(params, "cpu"), cfg, torch.from_numpy(ids.astype(np.int64)),
        (torch.from_numpy(c0), torch.from_numpy(h0)))
    for got, want in ((hs_t, hs_j), (c_t, c_j), (h_t, h_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
