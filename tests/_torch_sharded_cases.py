"""The cases of the port's sharded tests, and the (2, 4) world that runs
them.

tests/test_torch_sharded.py (serving) and tests/test_torch_sharded_train.py
(training) read their (2, 4) cases from one Gloo world of eight ranks
(:func:`world_24`), spawned once per test run: the first test process to
need it (under pytest-xdist, the first worker) runs it under a file lock
in the run's temporary directory and pickles the results there; the other
loads them.  The ranks run tests/_torch_dist_worker.py, which imports only
``jlm_tpu_torch``; the inputs are built here with the JAX package, and the
same numpy parameters go to both sides.
"""

import fcntl
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np

import _torch_dist_worker as worker
from jlm_tpu.config import Config, DSoftmaxConfig
from jlm_tpu.models import init_params
from jlm_tpu.models.lstm import forward_hidden, initial_state
from jlm_tpu.ops.quant import quantize_params
from jlm_tpu_torch.parallel.comm import spawn

BASE = dict(vocab_size=256, embed_size=32, hidden_size=64, beam_width=4, max_kana_len=30,
            seed=42)
DS = dict(BASE, head="dsoftmax", dsoftmax=((64, 64, 128), (64, 32, 16), "prefix"))
LONG_KANA = "きょうはいいてんきあめがふるよ"  # 15 kana: multi-chunk at max_kana_len 8
CONTEXTS = [[5, 6], [], [17, 3, 40, 2]]
TRAIN = dict(vocab_size=256, embed_size=16, hidden_size=32, batch_size=4, num_steps=8,
             learning_rate=5e-3, seed=5)
FAULTS = ("dh twice", "dh never")
# SGD at lr 1 with a clip that fires every step: the clip sets each update
CLIP = dict(TRAIN, optimizer="sgd", learning_rate=1.0, max_grad_norm=0.05)


def jcfg(kw, **mesh):
    kw = dict(kw, **mesh)
    if isinstance(kw.get("dsoftmax"), tuple):
        kw["dsoftmax"] = DSoftmaxConfig(*kw["dsoftmax"])
    return Config(**kw)


def fwd_inputs(seed, S, B, C, ds=False):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 256, (S, B)).astype(np.int32)
    cand = rng.integers(0, 256, (S, C)).astype(np.int32)
    look = rng.integers(0, 256, (S, 1, C)).astype(np.int32)
    h3 = rng.normal(size=(S, B, 64)).astype(np.float32)
    return words, cand, look, h3


def nll_inputs(kw, seed):
    """The params, hs and targets of test_sharded.py's CE cases."""
    cfg = jcfg(kw)
    params = init_params(cfg)
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (4, 6)).astype(np.int32)
    tgt = rng.integers(0, 256, (4, 6)).astype(np.int32)
    hs, _ = forward_hidden(jax.tree.map(jnp.asarray, params), cfg, jnp.asarray(ids),
                           initial_state(cfg, 4), precision="highest")
    return params, np.asarray(hs), tgt


NLL_CASES = {  # case id -> (config, rng seed, kernels, planted fault)
    "plain": (BASE, 1, False, None),
    "kernels_full": (BASE, 3, True, None),
    "kernels_dsoftmax": (DS, 3, True, None),
    **{f"kernels_{f}": (BASE, 3, True, f) for f in FAULTS},
    **{f"plain_{f}": (BASE, 1, False, f) for f in FAULTS},
}


def serving_cases(tiny):
    """``(case id, worker function, kwargs)`` of the serving cases."""
    words, cand, _, _ = fwd_inputs(5, 8, 2, 4)
    cand[0, :4] = [0, 5, 17, 255]
    ds_words = np.asarray([[1], [8], [3], [250], [7], [0], [12], [99]], np.int32)
    ds_cand = np.asarray([[0, 63, 64, 127, 128, 255], [255, 128, 127, 64, 63, 0]] * 4, np.int32)
    kw_words, _, kw_look, kw_h3 = fwd_inputs(5, 8, 2, 4)
    rng = np.random.default_rng(7)
    i8_words = rng.integers(0, 256, (8, 2)).astype(np.int32)
    i8_look = np.asarray([[[0, 63, 64, 127, 128, 255]]] * 8, np.int32)
    ds_q = quantize_params(init_params(jcfg(DS)))
    ties = np.random.default_rng(0).integers(0, 8, (3, 256)).astype(np.float32)
    cases = [
        ("mesh", "mesh_info", dict(cfg=BASE, params=tiny)),
        ("mesh_ds", "mesh_info", dict(cfg=DS, params=init_params(jcfg(DS)))),
        ("mesh_q", "mesh_info", dict(cfg=BASE, params=quantize_params(tiny))),
        ("forward", "forward", dict(cfg=BASE, params=tiny, words=words, cand=cand)),
        ("forward_ds", "forward", dict(cfg=DS, params=init_params(jcfg(DS)), words=ds_words,
                                       cand=ds_cand)),
        ("topk", "topk", dict(cfg=BASE, logits=ties, k=10)),
        ("topk_ds", "topk", dict(cfg=BASE, logits=ties, k=10, layout_cfg=DS)),
        ("decode", "decode", dict(cfg=BASE, params=tiny)),
        ("decode_kernels", "decode", dict(cfg=BASE, params=tiny, kernels=True)),
        ("decode_kernels_presharded", "decode", dict(cfg=BASE, params=tiny, kernels=True,
                                                     presharded=True)),
        ("decode_long", "decode", dict(cfg=dict(BASE, max_kana_len=8), params=tiny,
                                       kanas=[LONG_KANA])),
        ("decode_long_kernels", "decode", dict(cfg=dict(BASE, max_kana_len=8), params=tiny,
                                               kanas=[LONG_KANA], kernels=True)),
        ("suggest", "suggest", dict(cfg=BASE, params=tiny, contexts=CONTEXTS)),
        ("suggest_ds", "suggest", dict(cfg=DS, params=init_params(jcfg(DS)),
                                       contexts=CONTEXTS)),
    ]
    for quant in (False, True):
        cases.append((f"kernel_forward_{quant}", "forward", dict(
            cfg=BASE, params=quantize_params(tiny) if quant else tiny, words=kw_words,
            look=kw_look, h3=kw_h3, kernels=True)))
    for mxu in (False, True):
        cases.append((f"kernel_ds_int8_{mxu}", "forward", dict(
            cfg=DS, params=ds_q, words=i8_words, look=i8_look, kernels=True, int8_mxu=mxu)))
    return cases


def training_cases(encoded, exp):
    """``(case id, worker function, kwargs)`` of the training cases; the
    trainer case saves its state to ``exp``."""
    train, dev, _ = encoded
    cases = []
    for case, (kw, seed, kernels, fault) in NLL_CASES.items():
        params, hs, tgt = nll_inputs(kw, seed)
        cases.append((case, "nll", dict(cfg=kw, params=params, hs=hs, tgt=tgt,
                                        kernels=kernels, fault=fault)))
    return cases + [
        ("trainer", "train", dict(cfg=TRAIN, train_ids=train[:1600], dev_ids=dev[:400],
                                  exp=exp, sampled_vocab_cfg=dict(
                                      TRAIN, sampled_softmax_samples=32, mesh_data=2,
                                      mesh_vocab=4))),
        ("bf16_accum", "train", dict(cfg=dict(TRAIN, compute_dtype="bfloat16",
                                              grad_accum_steps=2),
                                     train_ids=train[:1000], dev_ids=dev[:400])),
        ("clip", "train", dict(cfg=CLIP, train_ids=train[:480], dev_ids=dev[:400])),
        ("clip_local_norm", "train", dict(cfg=CLIP, train_ids=train[:480], dev_ids=dev[:400],
                                          fault="local norm")),
    ]


def run_world(shape, cases):
    """Every case on a ``shape`` world of ranks on the CPU; each rank's
    ``{case id: result}``, after checking that no rank loaded a module of
    JAX or of ``jlm_tpu``."""
    out = spawn(worker.run, shape[0] * shape[1], device="cpu", args=(shape, cases))
    for r in out:
        assert r["_modules"] == [], r["_modules"]
    return out


def world_24(tmp_path_factory, tiny, encoded):
    """``(every rank's results, the trainer case's checkpoint directory)``
    of the serving and training cases on one (2, 4) world, run once per
    test run and shared by its test processes."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the run's directory, above every worker's own
    root = root / "torch_world_24"
    root.mkdir(exist_ok=True)
    exp, done = str(root / "exp"), root / "world.pkl"
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not done.exists():
            out = run_world((2, 4), serving_cases(tiny) + training_cases(encoded, exp))
            with open(root / "world.tmp", "wb") as f:
                pickle.dump(out, f)
            os.replace(root / "world.tmp", done)
    with open(done, "rb") as f:
        return pickle.load(f), exp
