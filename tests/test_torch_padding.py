"""The port's shape padding, on the CPU: each padding helper's operands give
the unpadded result (fp32, 1e-6 abs: only the order of a sum may change),
and the port at those shapes agrees with the JAX package.

The kernels take hidden widths in steps of 32 (the head), 128 (the CE
kernels), 4 (the scan and ``cand_dot``) and 64 units (the bf16 cell's gate
tiles), and at most 16 beam rows a sentence; the wrappers pad the
operands, or split the beam rows into groups, and then launch.  On the
card ``tests/test_torch_kernels_cuda.py`` runs the same shapes through the
kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jlm_tpu.config import Config as JConfig
from jlm_tpu.config import DSoftmaxConfig as JDSoftmaxConfig
from jlm_tpu.ops.quant import quantize_weight
from jlm_tpu_torch.config import Config, DSoftmaxConfig
from jlm_tpu_torch.ops import lstm_scan as ls
from jlm_tpu_torch.ops import project
from jlm_tpu_torch.ops import softmax_ce as ce
from jlm_tpu_torch.ops.cand_dot import beam_groups, cand_dot, cand_dot_ref
from jlm_tpu_torch.ops.frame_step import cell_cand_ref
from jlm_tpu_torch.ops.lstm_cell import cell_weight_tiles, lstm_cell_ref

# scripts/eval_quality.py:185-190's D-softmax head at its default H = 192
H192, SIZES192, DIMS192 = 192, (300, 500, 700), (96, 48, 48)


def _f(*shape, seed, scale=1.0):
    return torch.from_numpy(
        np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def _pad_h192_blocks(mode):
    """Each block of the H = 192 head padded as the plan and the launch pad
    it (``pad_cols``): its slice of h and its W^T to a multiple of 32, or
    for int8-MXU to ``int8_width``; every weight mode's logits and the int8
    row scale are unchanged."""
    cfg = Config(vocab_size=sum(SIZES192), hidden_size=H192, head="dsoftmax",
                 dsoftmax=DSoftmaxConfig(block_sizes=SIZES192, block_dims=DIMS192, mode=mode))
    h = _f(6, H192, seed=1)
    for k, (off, d, _) in enumerate(project.head_blocks(
            {"blocks": [{}] * 3}, cfg, H192)):
        assert project.padded_width(d) % 32 == 0 and project.padded_width(d) - d < 32
        assert project.int8_width(d) == 128
        w = _f(d, SIZES192[k], seed=10 + k, scale=0.5)
        q = quantize_weight(w.numpy(), axis=0)
        Wq, sq = torch.from_numpy(q["q"]), torch.from_numpy(q["scale"])
        b = _f(SIZES192[k], seed=20 + k)
        for W, scale, mxu in ((w, None, False), (Wq, sq, True), (Wq, sq, False)):
            dp = project.int8_width(d) if mxu else project.padded_width(d)
            hp, wtp = project.pad_cols(h[:, off:off + d], dp), project.pad_cols(W.t(), dp)
            _close(project._logits_ref(hp, wtp.t(), scale, b, torch.float32, mxu),
                   project._logits_ref(h[:, off:off + d], W, scale, b, torch.float32, mxu))
        _close(project.quantize_rows(hp)[1], project.quantize_rows(h[:, off:off + d])[1])


def _beam_groups_of_16():
    """B = 20 beam rows: groups (0, 16), (16, 20); the plain dots and the
    plain fused frame per group, put back together, equal the whole."""
    assert beam_groups(20) == [(0, 16), (16, 20)] and beam_groups(10) == [(0, 10)]
    S, B, C1, E, H = 3, 20, 7, 8, 30
    h3, cols, bias = _f(S, B, H, seed=2), _f(S, C1, H, seed=3), _f(S, C1, seed=4)
    whole = cand_dot_ref(h3, cols, bias)
    _close(torch.cat([cand_dot_ref(h3[:, b0:b1], cols, bias) for b0, b1 in beam_groups(B)],
                     dim=1), whole)
    hp, cp = project.pad_cols(h3, 32), project.pad_cols(cols, 32)  # H padded to a multiple of 4
    _close(cand_dot_ref(hp, cp, bias), whole)
    x, h, c = _f(S * B, E, seed=5), _f(S * B, H, seed=6), _f(S * B, H, seed=7)
    W, b = _f(E + H, 4 * H, seed=8, scale=0.1), _f(4 * H, seed=9)
    want = cell_cand_ref(x, h, c, W, b, cols, bias, B)

    def rows(t, b0, b1):
        return t.reshape(S, B, -1)[:, b0:b1].reshape(S * (b1 - b0), -1)

    parts = [cell_cand_ref(rows(x, *g), rows(h, *g), rows(c, *g), W, b, cols, bias, g[1] - g[0])
             for g in beam_groups(B)]
    for i in (0, 1):
        _close(torch.cat([p[i].reshape(S, g[1] - g[0], -1) for p, g in
                          zip(parts, beam_groups(B))], dim=1).reshape(S * B, -1), want[i])
    _close(torch.cat([p[2] for p in parts], dim=1), want[2])


def _ce_d192():
    """CE at D = 192: h with zero columns and W with zero rows up to 256
    give the same m, lse and t, dh's and dW's first 192 rows."""
    N, D, V = 10, 192, 300
    h, W, b = _f(N, D, seed=11), _f(D, V, seed=12, scale=0.1), _f(V, seed=13)
    y = torch.from_numpy(np.random.default_rng(14).integers(-1, V, N))
    hp, Wp = ce.pad_hidden(h, W)
    assert hp.shape == (N, 256) and Wp.shape == (256, V)
    (mp, sp, tp), (m, s, t) = ce.ce_fwd_raw_ref(hp, Wp, b, y), ce.ce_fwd_raw_ref(h, W, b, y)
    for got, want in ((mp, m), (mp + torch.log(sp), m + torch.log(s)), (tp, t)):
        _close(got, want)
    lse, ga = m + torch.log(s), _f(N, seed=15)
    args = (b, y, lse, ga, -ga)
    _close(ce.ce_bwd_dh_ref(hp, Wp, *args)[:, :D], ce.ce_bwd_dh_ref(h, W, *args))
    (dWp, dbp), (dW, db) = ce.ce_bwd_dw_ref(hp, Wp, *args), ce.ce_bwd_dw_ref(h, W, *args)
    _close(dWp[:D], dW)
    _close(dbp, db)


def _scan_e30_h30():
    """The scan at E = H = 30 padded to 32: the padded units stay at
    c = h = 0; outputs and gradients, padding dropped, equal the unpadded
    scan's."""
    B, T, E, H = 3, 5, 30, 30
    args = (_f(B, T, E, seed=16, scale=0.5), _f(E + H, 4 * H, seed=17, scale=0.2),
            _f(4 * H, seed=18, scale=0.1), _f(B, H, seed=19, scale=0.3),
            _f(B, H, seed=20, scale=0.3))
    padded = ls.pad_scan(*args)
    assert padded[0].shape == (B, T, 32) and padded[1].shape == (64, 128)
    got, want = ls.lstm_scan_ref(*padded), ls.lstm_scan_ref(*args)
    for g, w in zip(got, want):
        assert float(g[..., H:].abs().max()) == 0.0
        _close(g[..., :H], w)
    grads = [_f(B, T, H, seed=21), _f(B, H, seed=22), _f(B, H, seed=23)]
    pad = torch.nn.functional.pad
    gp = ls.lstm_scan_bwd_ref(*padded, *(pad(t, (0, 2)) for t in (got[0][..., :H], got[1][..., :H],
                                                                 grads[0], grads[1], grads[2])))
    gw = ls.lstm_scan_bwd_ref(*args, want[0], want[1], *grads)
    _close(ls.unpad_gates(gp[0], H), gw[0])
    _close(gp[1][..., :E], gw[1])
    _close(gp[2][:, :H], gw[2])
    _close(gp[3][:, :H], gw[3])


def _cell_gate_tiles():
    """The bf16 cell's gate-tiled weight at E = 40, H = 96 (neither a
    multiple of 64): [x | h] zero-padded to the tiles' K times the tiles
    gives every gate column of z, row ub*256 + g*64 + u for unit
    ub*64 + u."""
    R, E, H = 5, 40, 96
    x, h, W = _f(R, E, seed=24), _f(R, H, seed=25), _f(E + H, 4 * H, seed=26, scale=0.05)
    tiles = cell_weight_tiles(W, E, H)
    assert tiles.shape == (4 * 128, 64 + 128)
    pad = torch.nn.functional.pad
    z_t = torch.cat([pad(x, (0, 64 - E)), pad(h, (0, 128 - H))], dim=1) @ tiles.t()
    z = torch.cat([x, h], dim=1) @ W
    j = torch.arange(H)
    for g in range(4):
        _close(z_t[:, (j // 64) * 256 + g * 64 + j % 64], z[:, g * H + j])
    assert float(z_t.reshape(R, 2, 4, 64)[:, 1, :, H - 64:].abs().max()) == 0.0


@pytest.mark.parametrize("case", [
    "h192 prefix", "h192 disjoint", "beam 20", "ce d192", "scan e30 h30", "cell gate tiles"])
def test_padding_helpers_keep_the_result(case):
    {"h192 prefix": lambda: _pad_h192_blocks("prefix"),
     "h192 disjoint": lambda: _pad_h192_blocks("disjoint"),
     "beam 20": _beam_groups_of_16, "ce d192": _ce_d192, "scan e30 h30": _scan_e30_h30,
     "cell gate tiles": _cell_gate_tiles}[case]()



def test_cell_weight_tiles_kept_on_the_weight():
    """The gate-tiled copy is made once per weight and kept on it; an
    in-place change of the weight makes a new one, with the new values."""
    E, H = 40, 96
    W = _f(E + H, 4 * H, seed=27, scale=0.05)
    tiles = cell_weight_tiles(W, E, H)
    assert cell_weight_tiles(W, E, H) is tiles
    W.mul_(2.0)
    again = cell_weight_tiles(W, E, H)
    assert again is not tiles
    _close(again, 2.0 * tiles)

def test_block_plan_pads_the_h192_head():
    """The plan of the H = 192 head no longer refuses it: per block the
    padded width (96, 64, 64) and W^T padded with zero columns."""
    cfg = Config(vocab_size=sum(SIZES192), hidden_size=H192, head="dsoftmax",
                 dsoftmax=DSoftmaxConfig(block_sizes=SIZES192, block_dims=DIMS192,
                                         mode="disjoint"))
    blocks = [{"W": _f(d, n, seed=30 + d), "b": _f(n, seed=40 + d)}
              for n, d in zip(SIZES192, DIMS192)]
    plan = project._block_plan({"blocks": blocks}, cfg, H192, torch.device("cpu"),
                               torch.float32, False)
    assert [(p[0], p[1], p[7], tuple(p[2].shape)) for p in plan] == [
        (0, 96, 96, (300, 96)), (96, 48, 64, (500, 64)), (144, 48, 64, (700, 64))]
    assert float(plan[1][2][:, 48:].abs().max()) == 0.0


def test_int8_split_plan_fills_whole_waves():
    """The int8 and bf16 kernels' vocab splits: at the serving rows (80
    row blocks of 256, 782 tiles at 50k) the int8 split count wastes under
    10% of its waves of 132 blocks; a few rows (R = 800) spread the vocab
    over most of the card; every tile lies in exactly one split, whatever
    a block's fixed cost."""
    for rb, n_tiles, fixed in ((80, 782, 4), (4, 782, 4), (80, 250, 4), (1, 3, 4),
                               (160, 196, 1), (7, 196, 0)):
        sp, per = project.vocab_splits(n_tiles, rb, 132, fixed)
        assert (sp - 1) * per < n_tiles <= sp * per
    sp, _ = project.vocab_splits(782, 80, 132, project.INT8_BLOCK_TILES)
    assert 80 * sp / (-(-80 * sp // 132) * 132) >= 0.9
    sp, _ = project.vocab_splits(782, 4, 132, project.INT8_BLOCK_TILES)
    assert 4 * sp >= 66


@pytest.mark.parametrize("R,want", [
    (1, (131, 6)), (10, (131, 6)), (40, (131, 6)),  # one row block: a wave of 131
    (640, (44, 18)),      # the server at 64 events: 3 row blocks x 44
    (20_480, (8, 98)),    # the serving rows: the plan a cap of 64 gave
])
def test_int8_split_plan_at_keystroke_rows(R, want):
    """The int8 head's vocab splits at the per-keystroke paths' rows (50k,
    dp = 512, 132 SMs): one row block spreads the vocab over a whole wave
    (a cap of 64 splits left 71 SMs idle), and more row blocks keep the
    plans they had."""
    sp, per = project.block_splits(project.INT8_MXU, 512, 50_000, R, 132)
    assert (sp, per) == want
    assert (sp - 1) * per < 782 <= sp * per


@pytest.mark.parametrize("R,V,want", [
    (512, 50_000, (66, 6)),   # the fp32 parity run's rows at 50k: 4 x 66 = 264 blocks
    (512, 16_000, None),      # config 5's blocks
    (512, 34_000, None),
    (800, 50_000, (36, 11)),  # candidate extraction's rows (7 row blocks)
    (800, 16_000, None),
    (800, 34_000, None),
])
def test_fp32_split_plan_fills_whole_waves(R, V, want):
    """The fp32 head kernel's vocab splits (128 x 128 tiles, two blocks an
    SM): at the fp32 parity run's rows and at candidate extraction's, the
    row blocks x splits fill one wave of 2 x 132 blocks to at least 80%
    and lie in it, and every tile lies in exactly one split."""
    sp, per = project.block_splits(project.FP32, 512, V, R, 132)
    n_tiles, row_blocks = -(-V // 128), -(-R // 128)
    assert (sp - 1) * per < n_tiles <= sp * per
    assert 0.8 * 264 <= row_blocks * sp <= 264
    if want is not None:
        assert (sp, per) == want
    assert project.block_splits(project.DEQUANT_FP32, 128, V, R, 132) == (sp, per)


@pytest.mark.parametrize("S,B,H,C1,dtype,want", [
    (64, 8, 512, 65, torch.float32, (8, 16, 4160)),     # the fp32 parity frame: 128 blocks
    (64, 10, 512, 65, torch.float32, (11, 16, 3900)),   # 6 sentences (60 row slots) a block
    (9, 16, 96, 20, torch.float32, (3, 3, 1280)),
    (2048, 10, 512, 65, torch.bfloat16, (171, 8, 7800)),  # the serving frame
    (6, 1, 128, 200, torch.bfloat16, (1, 2, 25600)),
    (5, 3, 64, 7, torch.float32, (1, 2, 444)),           # 21 x 3 x 7 = 441 dots, whole float4s
])
def test_cell_cand_partial_sums_shape(S, B, H, C1, dtype, want):
    """The fused frame kernels' scratch of partial candidate sums: a slice
    of G B C1 dots (rounded up to float4s) for each unit group (32 units
    fp32, 64 bf16) of each block of G whole sentences (G = 64 // B fp32,
    128 // B bf16)."""
    from jlm_tpu_torch.ops.frame_step import partial_sums_shape

    assert partial_sums_shape(S, B, H, C1, dtype) == want


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("weights", ["fp32", "int8_mxu"])
@pytest.mark.parametrize("mode", ["prefix", "disjoint"])
def test_project_lse_h192_matches_jax(mode, weights):
    """The port's D-softmax head at H = 192 (96/48/48) vs
    jlm_tpu.ops.project.project_lse in interpret mode: fp32 within 1e-5
    (sum order), int8-MXU within 1e-4 (exact int32 products)."""
    from jlm_tpu.ops.project import project_lse as jax_lse

    rng = np.random.default_rng(50)
    jcfg = JConfig(vocab_size=sum(SIZES192), embed_size=64, hidden_size=H192, head="dsoftmax",
                   dsoftmax=JDSoftmaxConfig(block_sizes=SIZES192, block_dims=DIMS192, mode=mode))
    cfg = Config(vocab_size=sum(SIZES192), embed_size=64, hidden_size=H192, head="dsoftmax",
                 dsoftmax=DSoftmaxConfig(block_sizes=SIZES192, block_dims=DIMS192, mode=mode))
    h = rng.normal(size=(8, H192)).astype(np.float32)
    head_j, head_t = [], []
    for n, d in zip(SIZES192, DIMS192):
        w = rng.normal(size=(d, n)).astype(np.float32) * 0.05
        b = rng.normal(size=n).astype(np.float32) * 0.01
        if weights == "int8_mxu":
            q = quantize_weight(w, axis=0)
            head_j.append({"W": {"q": jnp.asarray(q["q"]), "scale": jnp.asarray(q["scale"])},
                           "b": jnp.asarray(b)})
            head_t.append({"W": {"q": torch.from_numpy(q["q"]),
                                 "scale": torch.from_numpy(q["scale"])}, "b": torch.from_numpy(b)})
        else:
            head_j.append({"W": jnp.asarray(w), "b": jnp.asarray(b)})
            head_t.append({"W": torch.from_numpy(w), "b": torch.from_numpy(b)})
    mxu = weights == "int8_mxu"
    jd, td = (jnp.bfloat16, torch.bfloat16) if mxu else (jnp.float32, torch.float32)
    lse_j = jax_lse(jnp.asarray(h), {"blocks": head_j}, jcfg, tile_v=128, compute_dtype=jd,
                    interpret=True, int8_mxu=mxu)
    lse_t = project.project_lse(torch.from_numpy(h), {"blocks": head_t}, cfg, compute_dtype=td,
                                int8_mxu=mxu)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j), atol=1e-4 if mxu else 1e-5)


def test_cand_dot_beam20_matches_jax():
    """cand_dot at B = 20 beam rows and H = 130 vs the JAX Pallas cand_dot
    in interpret mode: fp32, 1e-4 (sum order)."""
    from jlm_tpu.ops.cand_dot import cand_dot as jax_cand

    rng = np.random.default_rng(51)
    S, B, C1, H = 5, 20, 17, 130
    h3 = rng.normal(size=(S, B, H)).astype(np.float32) * 0.3
    cols = rng.normal(size=(S, C1, H)).astype(np.float32) * 0.3
    bias = rng.normal(size=(S, C1)).astype(np.float32) * 0.1
    out_j = jax_cand(jnp.asarray(h3), jnp.asarray(cols), jnp.asarray(bias), gs=8, interpret=True)
    out_t = cand_dot(*map(torch.from_numpy, (h3, cols, bias)))
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), atol=1e-4)


def test_ce_d192_matches_jax():
    """The fused CE at D = 192 vs jlm_tpu.ops.softmax_ce.ce_loss_fused in
    interpret mode: per-row loss 1e-5, grads of (h, W, b) 1e-4 abs/rel."""
    from jlm_tpu.ops import softmax_ce as jax_ce

    rng = np.random.default_rng(52)
    N, D, V = 12, 192, 700
    h = rng.normal(size=(N, D)).astype(np.float32)
    W = rng.normal(size=(D, V)).astype(np.float32) * 0.05
    b = rng.normal(size=V).astype(np.float32) * 0.01
    y = rng.integers(0, V, N).astype(np.int32)
    gw = rng.normal(size=N).astype(np.float32)

    def loss_j(h, W, b):
        return jnp.sum(jax_ce.ce_loss_fused(h, W, b, jnp.asarray(y), 512, jnp.float32, True) * gw)

    l_j, g_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, (h, W, b)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (h, W, b)]
    l_t = (ce.ce_loss_fused(*leaves, torch.from_numpy(y), torch.float32)
           * torch.from_numpy(gw)).sum()
    l_t.backward()
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-5)
    for leaf, want in zip(leaves, g_j):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_lstm_scan_e30_h30_matches_jax():
    """The scan at E = H = 30 vs jlm_tpu.ops.lstm_scan.lstm_scan in
    interpret mode: hs, c_T, h_T within 1e-5; grads of all five inputs
    within 2e-4 abs + 1e-4 rel."""
    from jlm_tpu.ops.lstm_scan import lstm_scan as jax_scan

    rng = np.random.default_rng(53)
    B, T, E, H = 4, 8, 30, 30
    args = (rng.normal(size=(B, T, E)).astype(np.float32) * 0.1,
            rng.normal(size=(E + H, 4 * H)).astype(np.float32) * 0.05,
            rng.normal(size=4 * H).astype(np.float32) * 0.01,
            rng.normal(size=(B, H)).astype(np.float32) * 0.1,
            rng.normal(size=(B, H)).astype(np.float32) * 0.1)
    wh = rng.normal(size=(B, T, H)).astype(np.float32)
    wc = rng.normal(size=(B, H)).astype(np.float32)

    def loss(*a):
        hs, cf, hf = jax_scan(*a, 1.0, 8, jnp.float32, True)
        return jnp.sum(hs * wh) + jnp.sum(cf * wc) + jnp.sum(hf * wc), (hs, cf, hf)

    (_, outs_j), grads_j = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    hs, cf, hf = ls.lstm_scan(*leaves, 1.0)
    l_t = ((hs * torch.from_numpy(wh)).sum() + (cf * torch.from_numpy(wc)).sum()
           + (hf * torch.from_numpy(wc)).sum())
    grads = torch.autograd.grad(l_t, leaves)
    for got, want in zip((hs, cf, hf), outs_j):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    for got, want in zip(grads, grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-4)


def test_cell_at_unaligned_widths_matches_jax():
    """The cell at E = 40, H = 24 (the bf16 kernel's smallest aligned
    widths, multiples of 8) vs the JAX Pallas cell: fp32, 1e-5."""
    from jlm_tpu.ops.lstm_cell import lstm_cell_step as jax_cell
    from jlm_tpu_torch.ops.lstm_cell import lstm_cell_step

    rng = np.random.default_rng(54)
    R, E, H = 9, 40, 24
    x, h, c = (rng.normal(size=s).astype(np.float32) * 0.3 for s in ((R, E), (R, H), (R, H)))
    W = rng.normal(size=(E + H, 4 * H)).astype(np.float32) * 0.1
    b = rng.normal(size=4 * H).astype(np.float32) * 0.01
    c_j, h_j = jax_cell(*map(jnp.asarray, (x, h, c, W, b)), 1.0, compute_dtype=jnp.float32,
                        interpret=True)
    c_t, h_t = lstm_cell_step(*map(torch.from_numpy, (x, h, c, W, b)), 1.0)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-5)
    c_r, h_r = lstm_cell_ref(*map(torch.from_numpy, (x, h, c, W, b)), 1.0)
    _close(c_t, c_r)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("B", [10, 20])
def test_cand_dot_h136_matches_jax(B, dtype):
    """cand_dot at S = 7, B = 10 and 20, C1 = 65, H = 136 vs the JAX Pallas
    cand_dot in interpret mode: the wrapper, and the plain version on h3
    and cols zero-padded to the kernel's K step (144 in bf16, 136 in fp32;
    ``pad_cols``), each within 1e-4 (fp32: sum order; bf16: both sides
    round h3 and cols to bf16 and sum exact products in fp32)."""
    from jlm_tpu.ops.cand_dot import cand_dot as jax_cand

    jd, td = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    rng = np.random.default_rng(57)
    S, C1, H = 7, 65, 136
    h3 = rng.normal(size=(S, B, H)).astype(np.float32) * 0.3
    cols = rng.normal(size=(S, C1, H)).astype(np.float32) * 0.3
    bias = rng.normal(size=(S, C1)).astype(np.float32) * 0.1
    out_j = _np(jax_cand(jnp.asarray(h3, jd), jnp.asarray(cols, jd), jnp.asarray(bias),
                         gs=8, interpret=True))
    h3_t, cols_t = torch.from_numpy(h3).to(td), torch.from_numpy(cols).to(td)
    bias_t = torch.from_numpy(bias)
    out_t = cand_dot(h3_t, cols_t, bias_t)
    assert out_t.shape == (S, B, C1) and out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=1e-4)
    Hp = 136 if dtype == "fp32" else 144
    padded = cand_dot_ref(project.pad_cols(h3_t, Hp), project.pad_cols(cols_t, Hp), bias_t)
    np.testing.assert_allclose(padded.numpy(), out_j, atol=1e-4)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("what", ["cell", "frame"])
@pytest.mark.parametrize("E,H", [(30, 20), (40, 24)])
def test_cell_padding_matches_jax(E, H, what, dtype):
    """The cells' width repair on the CPU: the operands zero-padded as the
    wrappers pad them for the card (``lstm_cell.pad_cell``; the fp32 cell
    to multiples of 32, the bf16 cell and frame to 8, the fp32 frame E to
    32 and H to 64; ``cols`` with zero columns), the plain version on the
    padded operands, sliced back, vs the JAX Pallas cell / fused frame in
    interpret mode (E = 40, H = 24 in bf16 is aligned: no padding).  The
    padded units stay exactly 0.  fp32: c', h' 1e-5 and
    the candidate logits 1e-4 (test_cell_cand_step_matches_jax's bounds);
    bf16: both sides round x, h, W and cols to bf16; c' 1e-5, h' one bf16
    rounding (4e-3), candidates 1e-3."""
    from jlm_tpu.ops.frame_step import cell_cand_step as jax_frame
    from jlm_tpu.ops.lstm_cell import lstm_cell_step as jax_cell
    from jlm_tpu_torch.ops.lstm_cell import pad_cell

    jd, td = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    rng = np.random.default_rng(58)
    S, B, C1 = 3, 10, 9
    R = S * B
    x, h, c = (rng.normal(size=s).astype(np.float32) * 0.5 for s in ((R, E), (R, H), (R, H)))
    W = rng.normal(size=(E + H, 4 * H)).astype(np.float32) * 0.1
    b = rng.normal(size=4 * H).astype(np.float32) * 0.1
    cols = rng.normal(size=(S, C1, H)).astype(np.float32) * 0.3
    cbias = rng.normal(size=(S, C1)).astype(np.float32) * 0.1
    if what == "cell" or dtype == "bf16":
        m_e = m_h = 32 if (dtype == "fp32") else 8
    else:
        m_e, m_h = 32, 64
    Ep, Hp = -(-E // m_e) * m_e, -(-H // m_h) * m_h
    t = [torch.from_numpy(a) for a in (x, h, c, W, b)]
    t[0], t[1], t[3] = (a.to(td) for a in (t[0], t[1], t[3]))
    xp, hp, cp, Wp, bp = pad_cell(*t, Ep, Hp)
    assert Wp.shape == (Ep + Hp, 4 * Hp) and bp.shape == (4 * Hp,)
    h_tol, cand_tol = (1e-5, 1e-4) if dtype == "fp32" else (4e-3, 1e-3)
    if what == "cell":
        c_j, h_j = jax_cell(*map(jnp.asarray, (x, h, c, W, b)), 1.0, compute_dtype=jd,
                            interpret=True)
        c_p, h_p = lstm_cell_ref(xp, hp, cp, Wp, bp, 1.0)
    else:
        c_j, h_j, cand_j = jax_frame(*map(jnp.asarray, (x, h, c, W, b, cols, cbias)), B, 1.0,
                                     compute_dtype=jd, interpret=True)
        colsp = project.pad_cols(torch.from_numpy(cols).to(td), Hp)
        c_p, h_p, cand_p = cell_cand_ref(xp, hp, cp, Wp, bp, colsp, torch.from_numpy(cbias), B,
                                         1.0, compute_dtype=td)
        np.testing.assert_allclose(cand_p.numpy(), _np(cand_j), atol=cand_tol)
    assert float(c_p[:, H:].abs().sum()) == 0.0 and float(h_p[:, H:].float().abs().sum()) == 0.0
    np.testing.assert_allclose(c_p[:, :H].numpy(), _np(c_j), atol=1e-5)
    np.testing.assert_allclose(h_p[:, :H].to(td).float().numpy(), _np(h_j), atol=h_tol)
