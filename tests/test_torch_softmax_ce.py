"""The port's fused softmax cross-entropy vs the JAX package's, on the CPU.

Inputs are numpy-seeded and go through the JAX functions (their Pallas
kernels in interpret mode, as tests/test_kernels.py runs them) and the
port's wrappers, which run their plain versions on CPU tensors;
tests/test_torch_kernels_cuda.py holds the CUDA kernels to those plain
versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jlm_tpu.config import Config, DSoftmaxConfig
from jlm_tpu.models.params import init_params
from jlm_tpu.ops import softmax_ce as jax_ce
from jlm_tpu_torch.models.heads import full_softmax_loss
from jlm_tpu_torch.models.params import params_to_torch
from jlm_tpu_torch.ops import softmax_ce as ce


def _case(seed, B, D, V):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, D)).astype(np.float32)
    W = rng.normal(size=(D, V)).astype(np.float32) * 0.05
    b = rng.normal(size=(V,)).astype(np.float32) * 0.01
    y = rng.integers(0, V, B).astype(np.int32)
    return rng, h, W, b, y


def _t(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("B,D,V", [(16, 128, 1000), (32, 256, 4096)])
def test_ce_forward_matches_jax(B, D, V):
    """Per-row fp32 loss; tolerance 1e-5 (fp32 summation order)."""
    _, h, W, b, y = _case(21, B, D, V)
    out_j = jax_ce.ce_loss_fused(*map(jnp.asarray, (h, W, b, y)), 512, jnp.float32, True)
    out_t = ce.ce_loss_fused(*_t(h, W, b, y), torch.float32)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    ref_t = ce.ce_loss_ref(*_t(h, W, b, y))
    np.testing.assert_allclose(ref_t.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_ce_grads_match_jax(dtype):
    """Grads of (h, W, b) under a random row weighting, V = 1000 (not a
    tile multiple).  fp32: atol/rtol 1e-4 (the JAX test's bound).  bf16
    compute: both sides round h, W and gp to bf16 and sum in fp32, so the
    loss agrees to 1e-5 and each grad to 1e-3 x its largest magnitude
    (a gp that lands on a bf16 rounding boundary may round either way)."""
    rng, h, W, b, y = _case(22, 24, 128, 1000)
    gw = rng.normal(size=(24,)).astype(np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)

    def loss_j(h, W, b):
        return jnp.sum(jax_ce.ce_loss_fused(h, W, b, jnp.asarray(y), 512, jd, True) * gw)

    l_j, g_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, (h, W, b)))
    ht, Wt, bt = _t(h, W, b, grad=True)
    l_t = (ce.ce_loss_fused(ht, Wt, bt, torch.from_numpy(y), td) * torch.from_numpy(gw)).sum()
    l_t.backward()
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-5)
    for got, want, name in zip((ht.grad, Wt.grad, bt.grad), g_j, "hWb"):
        want = np.asarray(want)
        if dtype == "fp32":
            np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4, err_msg=name)
        else:
            err = np.abs(got.numpy() - want).max() / np.abs(want).max()
            assert err <= 1e-3, (name, err)


@pytest.mark.parametrize("D,V,dtype", [
    (128, 1000, "fp32"),
    (96, 1001, "fp32"),   # ragged: a hidden slice and a vocab no tile divides
    (96, 1001, "bf16"),   # bf16 compute, as the wgmma forward computes
])
def test_ce_raw_partials_with_unowned_targets(D, V, dtype):
    """(m, s, t) of the per-block form: t = 0 where the target is -1 (every
    third row); tolerance 1e-5 abs and rel in either compute dtype (fp32
    sums in another order; in bf16 both sides round h and W to bf16 and
    sum the products in fp32).  A target past V also gives 0 in the port
    (the reference would read a padded column there)."""
    _, h, W, b, y = _case(23, 20, D, V)
    y[::3] = -1
    jd, td = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    past = y.copy()
    past[1] = V
    assert float(ce.ce_fwd_raw(*_t(h, W, b, past), td)[2][1]) == 0.0
    m_j, s_j, t_j = jax_ce._ce_fwd_raw(*map(jnp.asarray, (h, W)), None, jnp.asarray(b),
                                      jnp.asarray(y), tile_v=512, compute_dtype=jd,
                                      interpret=True)
    m_t, s_t, t_t = ce.ce_fwd_raw(*_t(h, W, b, y), td)
    assert float(t_t[::3].abs().max()) == 0.0
    for got, want in ((m_t, m_j), (s_t, s_j), (t_t, t_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ce_generalized_backward_matches_jax():
    """``gp = ga*p + gb*onehot`` with independent coefficients (the block-
    and vocab-partial form) vs ``_ce_bwd_impl``; -1 targets included.
    Tolerance 1e-5 absolute and relative (fp32 sums)."""
    rng, h, W, b, y = _case(24, 24, 128, 1000)
    y[::4] = -1
    ga = rng.normal(size=(24,)).astype(np.float32)
    gb = rng.normal(size=(24,)).astype(np.float32)
    lse = rng.normal(size=(24,)).astype(np.float32) + 7.0
    want = jax_ce._ce_bwd_impl(*map(jnp.asarray, (h, W)), None, jnp.asarray(b),
                               jnp.asarray(y), jnp.asarray(lse), jnp.asarray(ga),
                               jnp.asarray(gb), tile_v=512, compute_dtype=jnp.float32,
                               interpret=True)
    got = ce.ce_bwd(*_t(h, W, b, y, lse, ga, gb))
    for g, w, name in zip(got, want, ("dh", "dW", "db")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)
    # gb=None is the plain CE backward, gb = -ga
    got_plain = ce.ce_bwd(*_t(h, W, b, y, lse, ga), None)
    got_neg = ce.ce_bwd(*_t(h, W, b, y, lse, ga, -ga))
    for g, w in zip(got_plain, got_neg):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("mode", ["prefix", "disjoint"])
def test_ce_fused_dsoftmax_matches_jax(mode):
    """The D-softmax fused CE (per-block calls, merged lse) vs JAX's, loss
    and grads of every block and of hs, targets on block boundaries, as
    tests/test_kernels.py::test_ce_fused_dsoftmax_matches_ref.  Tolerance
    1e-5 on the loss, 1e-4 on the grads (the JAX test's)."""
    from jlm_tpu.models.heads import full_softmax_loss as jax_loss

    cfg = Config(vocab_size=768, embed_size=32, hidden_size=64, head="dsoftmax",
                 dsoftmax=DSoftmaxConfig(block_sizes=(128, 256, 384),
                                         block_dims=(64, 32, 16) if mode == "prefix"
                                         else (32, 16, 16), mode=mode),
                 fused_ce=True, seed=3)
    params = init_params(cfg)
    rng = np.random.default_rng(31)
    hs = rng.normal(size=(4, 6, 64)).astype(np.float32) * 0.3
    tgt = rng.integers(0, 768, (4, 6)).astype(np.int32)
    tgt[0, :4] = [0, 127, 128, 767]

    pj = jax.tree.map(jnp.asarray, params)
    l_j, (g_j, gh_j) = jax.value_and_grad(
        lambda p, x: jax_loss(p, cfg, x, jnp.asarray(tgt), precision="highest"),
        argnums=(0, 1))(pj, jnp.asarray(hs))

    pt = params_to_torch(params, "cpu")
    for blk in pt["head"]["blocks"]:
        blk["W"].requires_grad_(True)
        blk["b"].requires_grad_(True)
    ht = torch.from_numpy(hs).requires_grad_(True)
    l_t = full_softmax_loss(pt, cfg, ht, torch.from_numpy(tgt), precision="highest")
    l_t.backward()
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh_j), atol=1e-4, rtol=1e-4)
    for k, blk in enumerate(pt["head"]["blocks"]):
        for name in ("W", "b"):
            np.testing.assert_allclose(
                blk[name].grad.numpy(), np.asarray(g_j["head"]["blocks"][k][name]),
                atol=1e-4, rtol=1e-4, err_msg=f"{mode} d{name} block {k}")


def test_full_softmax_loss_highest_fused_matches_jax():
    """``full_softmax_loss(precision="highest")`` with ``fused_ce`` on a full
    head (the fp32 fused CE, kernels 4-6 in fp32) vs JAX's, loss and the
    grads of hs, W and b, as tests/test_kernels.py's fused-CE tests: loss
    within 1e-5, grads within 1e-4 abs and rel.  V = 1000 is not a tile
    multiple."""
    from jlm_tpu.models.heads import full_softmax_loss as jax_loss

    cfg = Config(vocab_size=1000, embed_size=32, hidden_size=128, fused_ce=True, seed=4)
    rng = np.random.default_rng(32)
    hs = rng.normal(size=(4, 6, 128)).astype(np.float32) * 0.3
    W = rng.normal(size=(128, 1000)).astype(np.float32) * 0.05
    b = rng.normal(size=(1000,)).astype(np.float32) * 0.01
    tgt = rng.integers(0, 1000, (4, 6)).astype(np.int32)
    tgt[0, :2] = [0, 999]

    l_j, g_j = jax.value_and_grad(
        lambda h, W, b: jax_loss({"head": {"W": W, "b": b}}, cfg, h, jnp.asarray(tgt),
                                 precision="highest"),
        argnums=(0, 1, 2))(*map(jnp.asarray, (hs, W, b)))
    ht, Wt, bt = _t(hs, W, b, grad=True)
    l_t = full_softmax_loss({"head": {"W": Wt, "b": bt}}, cfg, ht, torch.from_numpy(tgt),
                            precision="highest")
    l_t.backward()
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-5, atol=1e-5)
    for got, want, name in zip((ht.grad, Wt.grad, bt.grad), g_j, "hWb"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_ce_wrappers_do_not_count_launches(dtype):
    """On CPU tensors the CE wrappers run their plain versions in either
    compute dtype: no kernel (nor the cast of W^T), no launch counted, no
    build."""
    from jlm_tpu_torch.ops import _build

    _, h, W, b, y = _case(25, 8, 128, 64)
    def counts():
        return (ce.ce_fwd_raw.launches, ce.ce_bwd_dh.launches, ce.ce_bwd_dw.launches,
                ce.cast_wt.launches)

    before = counts()
    ht, Wt, bt = _t(h, W, b, grad=True)
    ce.ce_loss_fused(ht, Wt, bt, torch.from_numpy(y), dtype).sum().backward()
    assert counts() == before
    assert _build._lib is None


def _owners(n, tile, blocks, per_block):
    """How many (block, tile) pairs cover each of n indices."""
    count = np.zeros(n, np.int64)
    for blk in range(blocks):
        for t in range(blk * per_block, (blk + 1) * per_block):
            count[t * tile:min((t + 1) * tile, n)] += 1
    return count


@pytest.mark.parametrize("kind", ["dh", "dw"])
@pytest.mark.parametrize("N,D,V", [
    (1024, 512, 50_000),    # the training step's head (chip_smoke.py)
    (1024, 1024, 50_000),   # H = 1,024 (chip_smoke.py phase 5d)
    (1024, 512, 16_000),    # config 5's D-softmax blocks
    (1024, 256, 34_000),
    (1024, 128, 50_000),
    (129, 384, 8_003),      # ragged rows and vocab, a 384-wide slice
    (70, 640, 2_003),       # slices that 512 does not divide
    (8, 2048, 300),         # past what stays resident
])
def test_bwd_plan_covers_every_row_and_column(kind, N, D, V):
    """The bf16 backward's launch plan (a pure function of N, D, V and the
    SM count, here an H100's 132): every vocab column falls in exactly one
    split (dh) or vocab block (dW), every row in one row tile (dh) or in the
    row tiles every dW block walks, every column of D in one slice, the
    slots obey the kernel's rules, and shared memory stays within a
    block's 227 KB."""
    plan = ce.bwd_plan(kind, N, D, V, 132)
    assert plan["smem"] == ce.bwd_smem(plan["sw"], plan["n_own"], plan["n_pass"])
    assert plan["smem"] <= ce.SMEM_LIMIT == 227 * 1024
    sw, slices = plan["sw"], plan["slices"]
    assert sw % 128 == 0 and sw <= 512 and slices * sw == D
    passes = D > sw
    assert (2 if not passes else 1) <= plan["n_own"] <= 4
    assert (2 <= plan["n_pass"] <= 8) if passes else plan["n_pass"] == 0

    owners = _owners
    grid = plan["grid"]
    if kind == "dh":
        q_blocks, splits, zs = grid
        assert q_blocks * 64 >= N > (q_blocks - 1) * 64 and zs == slices
        assert splits == plan["splits"]
        assert q_blocks * splits * slices <= 132 or splits == 1
        np.testing.assert_array_equal(owners(V, 64, splits, plan["tiles_per_split"]), 1)
        np.testing.assert_array_equal(owners(N, 64, q_blocks, 1), 1)
    else:
        v_blocks, zs = grid
        assert zs == slices and plan["splits"] == 1
        np.testing.assert_array_equal(owners(V, 64, v_blocks, 1), 1)
        assert plan["tiles_per_split"] * 64 >= N > (plan["tiles_per_split"] - 1) * 64
    np.testing.assert_array_equal(owners(D, sw, slices, 1), 1)


@pytest.mark.parametrize("kind", ["dh", "dw"])
@pytest.mark.parametrize("V", [1, 100, 50_000])
@pytest.mark.parametrize("N", [1, 37, 1024])
@pytest.mark.parametrize("D", [128, 256, 512, 640, 1024])
def test_bwd_plan_f32_covers_every_row_column_and_chunk(kind, N, D, V):
    """The fp32 backward's launch plan (a pure function of N, D, V and the
    SM count, here an H100's 132): every row of h and every vocabulary
    column falls in exactly one (block, tile) pair, every column of D in
    one output slice (one slice up to D = 1,024: a tile's logits are formed
    once), K in whole chunks of 32 and a tile's kv in whole chunks of 8; a
    block's output (q rows x slice columns) fits the registers the kernel
    gives it, 128 floats a thread, beside its 32 logits a thread; shared
    memory stays within a block's 227 KB."""
    plan = ce.bwd_plan_f32(kind, N, D, V, 132)
    q, kv, sw, slices = plan["q"], plan["kv"], plan["sw"], plan["slices"]
    assert q in ce.F32_QS and q * kv == ce.F32_TILE
    assert q * sw <= ce.F32_OUT and (2 * q * sw > ce.F32_OUT or q == max(ce.F32_QS))
    assert q * sw // ce.F32_THREADS <= 128 and ce.F32_TILE // ce.F32_THREADS == 32
    assert sw % 128 == 0 and slices == 1 and sw == D
    assert plan["k_chunks"] * ce.F32_BK == D and plan["kv_chunks"] * ce.F32_BV == kv
    assert plan["kv_chunks"] >= 4  # a tile's terms load under its last chunks
    assert plan["smem"] == ce.bwd_smem_f32(kind, q, sw) <= ce.SMEM_LIMIT
    grid = plan["grid"]
    assert grid[2] == slices
    if kind == "dh":
        q_blocks, splits = grid[:2]
        assert splits == plan["splits"] and (q_blocks * splits <= 132 or splits == 1)
        np.testing.assert_array_equal(_owners(N, q, q_blocks, 1), 1)
        np.testing.assert_array_equal(_owners(V, kv, splits, plan["tiles_per_split"]), 1)
        assert (splits - 1) * plan["tiles_per_split"] * kv < V  # no split is empty
    else:
        v_blocks, one = grid[:2]
        assert one == 1 == plan["splits"]
        np.testing.assert_array_equal(_owners(V, q, v_blocks, 1), 1)
        np.testing.assert_array_equal(_owners(N, kv, 1, plan["tiles_per_split"]), 1)


@pytest.mark.parametrize("kind", ["dh", "dw"])
def test_bwd_plan_f32_shapes(kind):
    """64 rows (columns) a block at D = 512 and 32 at D = 1,024, one slice
    each; dh splits the vocabulary 8 and 4 ways at N = 1,024 (one wave of
    128 blocks); past D = 1,024 the output is cut into slices of at most
    1,024, multiples of 128, whose last may be narrower."""
    p512, p1024 = (ce.bwd_plan_f32(kind, 1024, d, 50_000, 132) for d in (512, 1024))
    assert (p512["q"], p512["sw"], p512["slices"]) == (64, 512, 1)
    assert (p1024["q"], p1024["sw"], p1024["slices"]) == (32, 1024, 1)
    if kind == "dh":
        assert (p512["splits"], p1024["splits"]) == (8, 4)
    for D, sw, slices in ((2048, 1024, 2), (1152, 640, 2), (3072, 1024, 3)):
        p = ce.bwd_plan_f32(kind, 70, D, 2003, 132)
        assert (p["sw"], p["slices"], p["grid"][2]) == (sw, slices, slices)
        cols = _owners(D, sw, slices, 1)
        np.testing.assert_array_equal(cols, 1)
    with pytest.raises(ValueError):
        ce.bwd_plan_f32(kind, 8, 192, 100, 132)


def test_bwd_plan_slots():
    """At D = 512 a block keeps two slots of a tile beside its rows (a
    tile's loads overlap the previous tile's products), four at D = 256;
    at D = 1,024 one slice slot and four pass slots."""
    p512, p256, p1024 = (ce.bwd_plan("dh", 1024, d, 50_000, 132) for d in (512, 256, 1024))
    assert (p512["n_own"], p512["n_pass"], p512["splits"]) == (2, 0, 8)
    assert (p256["n_own"], p256["n_pass"]) == (4, 0)
    assert (p1024["sw"], p1024["n_own"], p1024["n_pass"], p1024["splits"]) == (512, 1, 4, 4)


@pytest.mark.parametrize("N,D,V", [
    (1024, 512, 50_000),    # the training step's head
    (1024, 128, 50_000),    # config 5's 50,000 x 128 D-softmax block
    (77, 128, 1_001),       # rows and vocab under a wave, a ragged tile
    (129, 512, 5_003),      # one row past a block; V not a multiple of 4
    (1, 1_024, 300),        # one row, three tiles
])
def test_fwd_plan_f32_covers_every_row_and_column(N, D, V):
    """The fp32 forward's launch plan (a pure function of N, D, V and the
    SM count, here an H100's 132): every row in one 128-row block, every
    128-column vocab tile in exactly one split (so every row block x tile
    pair once), no split empty, and the grid at most one wave of two blocks
    an SM; at the training shape 8 row blocks x 33 splits of 12 tiles."""
    plan = ce.fwd_plan_f32(N, D, V, 132)
    q_blocks, splits = plan["grid"]
    rows, cols, per = plan["rows"], plan["cols"], plan["tiles_per_split"]
    assert rows == cols == 128 and splits == plan["splits"]
    assert q_blocks * splits <= 2 * 132
    np.testing.assert_array_equal(_owners(N, rows, q_blocks, 1), 1)
    n_tiles = -(-V // cols)
    np.testing.assert_array_equal(_owners(n_tiles, 1, splits, per), 1)
    np.testing.assert_array_equal(_owners(V, cols, splits, per), 1)
    assert (splits - 1) * per < n_tiles  # no split is empty
    if (N, V) == (1024, 50_000):
        assert (q_blocks, splits, per) == (8, 33, 12)
    with pytest.raises(ValueError):
        ce.fwd_plan_f32(N, 192, V, 132)


@pytest.mark.parametrize("N,D,V", [
    (1024, 512, 50_000),    # the training step's head
    (1024, 1024, 50_000),   # H = 1,024: half of K's q chunks streamed
    (1000, 128, 16_000),    # a D-softmax block's width, ragged rows
    (7, 128, 1001),         # rows and vocab under one block and tile
])
def test_fwd_plan_covers_every_row_and_column(N, D, V):
    """The bf16 forward's launch plan (a pure function of N, D, V and the
    SM count, here an H100's 132): every row in one 128-row block, every
    vocab column in exactly one split's 128-column tiles, at most one block
    an SM, the slots within the kernel's rules and shared memory within a
    block's 227 KB."""
    plan = ce.fwd_plan(N, D, V, 132)
    assert plan["smem"] == ce.fwd_smem(plan["n_res"], plan["n_sub"]) <= ce.SMEM_LIMIT
    nd = D // 64
    assert 0 <= plan["n_res"] <= nd
    assert (4 if plan["n_res"] < nd else 2) <= plan["n_sub"] <= 12
    q_blocks, splits = plan["grid"]
    rows, cols, per = plan["rows"], plan["cols"], plan["tiles_per_split"]
    assert splits == plan["splits"] and (q_blocks * splits <= 132 or splits == 1)
    count = np.zeros(V, np.int64)
    for k in range(splits):
        assert k * per * cols < V  # no split is empty
        count[k * per * cols:min((k + 1) * per * cols, V)] += 1
    np.testing.assert_array_equal(count, 1)
    row_count = np.zeros(N, np.int64)
    for q in range(q_blocks):
        row_count[q * rows:min((q + 1) * rows, N)] += 1
    np.testing.assert_array_equal(row_count, 1)


def test_fwd_plan_slots():
    """At D = 128 and 512 every q chunk of a block's rows stays resident
    beside at least two kv ring slots (five at 512, eleven at 128); at
    D = 1,024 six of sixteen stay and the ring keeps seven slots, so three
    streamed chunks (a kv and a q chunk each) fit in it."""
    p128, p512, p1024 = (ce.fwd_plan(1024, d, 50_000, 132) for d in (128, 512, 1024))
    assert (p128["n_res"], p128["n_sub"]) == (2, 11)
    assert (p512["n_res"], p512["n_sub"], p512["splits"]) == (8, 5, 16)
    assert (p1024["n_res"], p1024["n_sub"]) == (6, 7)
    for p in (p128, p512, p1024):
        assert p["n_sub"] >= 2 and p["smem"] <= 232_448


@pytest.mark.parametrize("D,Dp", [(128, 128), (96, 128)])
def test_cast_wt_is_the_transposed_bf16_cast(D, Dp):
    """``cast_wt`` (the bf16 backward's cast of W, transposed) on a CPU
    tensor: ``W^T`` rounded to bf16 as ``Tensor.to`` rounds, zero columns
    past D; bit-equal."""
    _, _, W, _, _ = _case(26, 4, D, 300)
    wt = ce.cast_wt(torch.from_numpy(W), Dp)
    assert wt.dtype == torch.bfloat16 and tuple(wt.shape) == (300, Dp)
    want = torch.from_numpy(W).t().to(torch.bfloat16)
    assert torch.equal(wt[:, :D], want) and not wt[:, D:].any()
