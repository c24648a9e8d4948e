"""The fused clip + Adam kernels' host side (``jlm_tpu_torch.ops.adam``) and
the optimizer's choice of path (``train.optim.apply_gradients``), on the
CPU: the chunk table, the wrappers' checks, the kernel's arithmetic as
numpy fp32 against the plain version, and CPU tensors on the plain path.
The kernels against the plain version on the card: ``chip_smoke.py``
phase 2 and ``tests/test_torch_kernels_cuda.py``."""

import numpy as np
import pytest
import torch

from jlm_tpu_torch.config import Config
from jlm_tpu_torch.ops import adam
from jlm_tpu_torch.train import optim
from jlm_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def tracer_off_after():
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


@pytest.mark.parametrize("sizes,chunk", [
    ((1,), adam.CHUNK),                            # one element
    ((1, 1, 1), adam.CHUNK),                       # one-element leaves
    ((3, 5, 7, 4099), adam.CHUNK),                 # ragged: not multiples of 4
    ((adam.CHUNK,), adam.CHUNK),                   # exactly one chunk
    ((3 * adam.CHUNK + 3, 1, 2 * adam.CHUNK), adam.CHUNK),  # leaves past a chunk
    ((0, 10, 0, 5), adam.CHUNK),                   # empty leaves get no chunk
    ((12_800_000, 1_572_864, 2_048, 25_600_000, 50_000), adam.CHUNK),  # the 50k step
    ((37, 64, 9), 8),                              # small chunks, many a leaf
])
def test_chunk_table_covers_every_element_once(sizes, chunk):
    table = adam.chunk_table(sizes, chunk)
    assert table.dtype == np.int64 and table.shape[1] == 3
    leaf, start, count = table.T
    assert np.all(np.diff(leaf) >= 0)  # leaves in order
    assert np.all((count >= 1) & (count <= chunk))
    assert np.all(start % chunk == 0)  # so a 16-byte aligned leaf's chunks are too
    for i, n in enumerate(sizes):
        covered = np.zeros(n, np.int64)
        for s, c in zip(start[leaf == i], count[leaf == i]):
            covered[s:s + c] += 1
        assert np.all(covered == 1), f"leaf {i}"
    assert int(count.sum()) == sum(sizes)


def _leaves(n=3, dtype=torch.float32):
    return [torch.zeros(5 + i, dtype=dtype) for i in range(n)]


def _bad(fault):
    """Three leaves, the second with ``fault``."""
    leaves = _leaves()
    if fault == "noncontiguous":
        leaves[1] = torch.zeros(6, 2)[:, 0]
    elif fault == "cpu":
        pass  # fp32 and contiguous, but not on a card
    else:
        leaves[1] = leaves[1].to(getattr(torch, fault))
    return leaves


_MESSAGES = {"float16": "fp32", "bfloat16": "fp32", "float64": "fp32",
             "noncontiguous": "contiguous", "cpu": "CUDA"}


@pytest.mark.parametrize("fault", list(_MESSAGES))
@pytest.mark.parametrize("wrapper", ["sumsq_norm", "adam_clip"])
def test_wrappers_refuse_what_the_kernels_cannot_take(wrapper, fault):
    """The checks run before anything touches a card: a leaf that is not
    fp32, not contiguous or not on a CUDA device raises, and nothing
    launches."""
    bad, ok = _bad(fault), _leaves()
    launches = adam.sumsq_norm.launches, adam.adam_clip.launches
    with pytest.raises(ValueError, match=_MESSAGES[fault]):
        if wrapper == "sumsq_norm":
            adam.sumsq_norm(bad)
        else:
            adam.adam_clip(ok, bad, ok, ok, torch.zeros(()), count=1, lr=1e-3, max_norm=5.0,
                           b1=optim.B1, b2=optim.B2, eps=optim.EPS)
    assert (adam.sumsq_norm.launches, adam.adam_clip.launches) == launches


@pytest.mark.parametrize("groups", ["sizes", "count", "too many"])
def test_adam_clip_refuses_mismatched_leaves(groups):
    g = _leaves()
    other = {"sizes": _leaves()[::-1], "count": _leaves(2)}.get(groups, g)
    if groups == "too many":
        g = other = [torch.zeros(1)] * (adam.MAX_LEAVES + 1)
    with pytest.raises(ValueError, match="leaves|elements"):
        adam.adam_clip(other, g, g, g, torch.zeros(()), count=1, lr=1e-3, max_norm=5.0,
                       b1=optim.B1, b2=optim.B2, eps=optim.EPS)


def _mirror(g, m, v, norm, scalars):
    """``csrc/adam.cu``'s ``adam_one`` in numpy fp32, one rounding a step:
    the update (which the kernel adds to p) and the moments."""
    max_norm, b1, c1, b2, c2, inv_bc1, inv_bc2, eps, neg_lr = (np.float32(s) for s in scalars)
    if not norm < max_norm:
        g = (g / norm) * max_norm
    m = m * b1 + g * c1
    v = v * b2 + (g * g) * c2
    return ((m * inv_bc1) / (np.sqrt(v * inv_bc2) + eps)) * neg_lr, m, v


def _ulps(a, b):
    """Distance of two fp32 arrays in units in the last place."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max())


@pytest.mark.parametrize("count", [1, 3, 1000])
@pytest.mark.parametrize("clip", [False, True])
def test_kernel_arithmetic_against_the_plain_version(clip, count):
    """The kernel's per-element steps with its fp32 scalars (numpy) against
    the plain functions on the CPU: the moments to the bit, the updates
    within 4 ulp (on the CPU PyTorch divides by ``1 - b**count`` where on
    the card it multiplies by the fp32 reciprocal, as the kernel does, and
    its vectorized sqrt is not always correctly rounded; on the card the
    two agree to the bit: ``chip_smoke.py`` phase 2)."""
    rng = np.random.default_rng(count + 10 * clip)
    sizes = (1000, 37, 4096)
    g = [rng.normal(0, 0.3 if clip else 0.01, n).astype(np.float32) for n in sizes]
    m = [rng.normal(0, 1e-3, n).astype(np.float32) * (count > 1) for n in sizes]
    v = [np.abs(rng.normal(0, 1e-5, n)).astype(np.float32) * (count > 1) for n in sizes]
    lr = 1e-3
    norm = optim.global_norm([torch.from_numpy(x) for x in g])
    assert (float(norm) >= 5.0) == clip
    keys = ["a", "b", "c"]
    state = optim.OptState(count=count - 1,
                           mu={k: torch.from_numpy(x.copy()) for k, x in zip(keys, m)},
                           nu={k: torch.from_numpy(x.copy()) for k, x in zip(keys, v)}, acc={})
    clipped = optim.clip_by_global_norm([torch.from_numpy(x) for x in g], 5.0, norm)
    updates = optim._adam(clipped, keys, state, lr)
    scalars = adam.adam_scalars(count, lr, 5.0, optim.B1, optim.B2, optim.EPS)
    for i, k in enumerate(keys):
        u_k, m_k, v_k = _mirror(g[i], m[i], v[i], np.float32(norm), scalars)
        assert _ulps(m_k, state.mu[k].numpy()) == 0
        assert _ulps(v_k, state.nu[k].numpy()) == 0
        assert _ulps(u_k, updates[i].numpy()) <= 4


def test_adam_scalars_round_each_python_scalar_to_fp32():
    s = adam.adam_scalars(3, 1e-3, 5.0, 0.9, 0.999, 1e-8)
    f = np.float32
    assert s[:5] == [5.0, float(f(0.9)), float(f(0.1)), float(f(0.999)), float(f(1 - 0.999))]
    # the reciprocals of the divisors, in double, then rounded (PyTorch's
    # CUDA division by a Python scalar); 1 / f32(1 - b2) in fp32 differs
    assert s[5] == float(f(1 / (1 - 0.9 ** 3))) and s[6] == float(f(1 / (1 - 0.999 ** 3)))
    assert adam.adam_scalars(1, 1e-3, 5.0, 0.9, 0.999, 1e-8)[6] != float(f(1) / f(1 - 0.999))
    assert s[7:] == [float(f(1e-8)), float(f(-1e-3))]
    assert all(float(f(x)) == x for x in s)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("with_norm_fn", [False, True])
@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_apply_gradients_on_cpu_takes_the_plain_path(optimizer, with_norm_fn, accum):
    """CPU tensors run the plain functions (``optim.plain_calls`` counts
    every call, accumulation steps too; the kernels never launch), and the
    parameters move as the plain chain moves them."""
    cfg = Config(optimizer=optimizer, grad_accum_steps=accum, max_grad_norm=1.0)
    rng = np.random.default_rng(accum + 2 * with_norm_fn)
    params = {k: torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32))
              for k, n in (("w", 50), ("b", 7))}
    grads = [{k: torch.from_numpy(rng.normal(0, 1.0, p.numel()).astype(np.float32))
              for k, p in params.items()} for _ in range(accum)]
    state = optim.init_state(cfg, params)
    seen = []
    norm_fn = (lambda gr: seen.append(1) or optim.global_norm([gr[k] for k in sorted(gr)])
               if with_norm_fn else None)
    want = {k: p.clone() for k, p in params.items()}
    mean = {k: sum(gr[k] for gr in grads) / accum for k in params}
    keys = sorted(params)
    clipped = optim.clip_by_global_norm([mean[k] for k in keys], cfg.max_grad_norm)
    ref_state = optim.init_state(cfg, want)
    steps = (optim._adam(clipped, keys, ref_state, 1e-2) if optimizer == "adam"
             else [c * -1e-2 for c in clipped])
    for k, u in zip(keys, steps):
        want[k] += u
    launches = adam.sumsq_norm.launches, adam.adam_clip.launches
    profiling.enable(True)
    for gr in grads:
        optim.apply_gradients(params, gr, state, cfg, 1e-2, norm_fn)
    profiling.enable(False)
    assert profiling.snapshot()["counters"] == {"optim.plain_calls": accum}
    assert (adam.sumsq_norm.launches, adam.adam_clip.launches) == launches
    assert len(seen) == with_norm_fn
    for k in params:
        torch.testing.assert_close(params[k], want[k], rtol=1e-6, atol=1e-7)
