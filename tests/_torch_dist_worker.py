"""The port's side of the sharded tests, run in every rank of a Gloo world
on the CPU (``jlm_tpu_torch.parallel.comm.spawn``).

This module imports only ``jlm_tpu_torch`` (a spawned child imports the
module of the function it runs, so the JAX side stays in the test files).
:func:`run` (a ``(data, vocab)`` mesh) and :func:`run_seq` (a ``('seq',)``
mesh) take a list of ``(case id, function name, kwargs)`` and return, for
this rank, ``{case id: result}`` with numpy leaves; the test files read
every case from one world.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from jlm_tpu_torch.config import Config, DSoftmaxConfig
from jlm_tpu_torch.models.params import params_to_torch
from jlm_tpu_torch.parallel import (comm, make_mesh, make_seq_mesh, make_sharded_forward,
                                    sharded_topk)
from jlm_tpu_torch.parallel import sharded_head, train_step
from jlm_tpu_torch.parallel.sharded_head import local_ids, shard_params, vocab_parallel_nll

KANAS = ["きょうはいいてんき", "あめがふる", "かみとかわ", "はしをみる"]


def config(**kw) -> Config:
    if isinstance(kw.get("dsoftmax"), tuple):
        kw["dsoftmax"] = DSoftmaxConfig(*kw["dsoftmax"])
    return Config(**kw)


def _data():
    from jlm_tpu_torch.data import Lexicon, build_vocab, generate_corpus

    vocab = build_vocab(generate_corpus(800, seed=1234), 256)
    return vocab, Lexicon.from_vocab(vocab)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x


def _own(x: np.ndarray, mesh) -> np.ndarray:
    """This rank's sentence rows (rows shard over data x vocab)."""
    n = x.shape[0] // mesh.world
    return x[mesh.rank * n:(mesh.rank + 1) * n]


@contextlib.contextmanager
def _fault(name):
    """A planted fault of the vocab-parallel CE: ``dh`` summed over the
    vocab group twice, or not at all."""
    keep = sharded_head._reduce_dh
    if name == "dh twice":
        sharded_head._reduce_dh = lambda dh, g: comm.all_reduce_sum(comm.all_reduce_sum(dh, g), g)
    elif name == "dh never":
        sharded_head._reduce_dh = lambda dh, g: dh
    elif name is not None:
        raise ValueError(name)
    try:
        yield
    finally:
        sharded_head._reduce_dh = keep


# ------------------------------------------------------------------ cases

def mesh_info(mesh, cfg, params=None):
    """The mesh's shape and this rank's coordinates; with ``params`` the
    leaves this rank keeps of them (``shard_params``)."""
    out = {"shape": mesh.shape, "rank": mesh.rank,
           "coords": (mesh.data_index, mesh.vocab_index)}
    if params is not None:
        out["params"] = _np(shard_params(params_to_torch(params, mesh.device), cfg, mesh))
    return out


def forward(mesh, cfg, params, words, cand=None, look=None, h3=None, kernels=False,
            int8_mxu=False):
    """One sharded forward on this rank's rows (and ``score_hidden`` on
    ``h3``'s); the plain forward on candidate ids, the kernel forward
    (fp32 compute) on ``look`` through ``prepare``."""
    dev = mesh.device
    fwd = make_sharded_forward(mesh, cfg, use_kernels=kernels, compute_dtype=torch.float32,
                               int8_mxu=int8_mxu)
    p = fwd.place_params(params_to_torch(params, dev))
    w = torch.from_numpy(_own(words, mesh)).long()
    S_l, B = w.shape
    L, H = cfg.num_layers, cfg.hidden_size
    state = (torch.zeros(L, S_l * B, H), torch.zeros(L, S_l * B, H))
    if kernels:
        pay = {k: v[0] for k, v in fwd.prepare(p, torch.from_numpy(_own(look, mesh))).items()}
    else:
        pay = torch.from_numpy(_own(cand, mesh)).long()
    c, e, st = fwd(p, w, state, pay)
    out = {"cand": c, "eos": e, "c": st[0], "h": st[1]}
    if h3 is not None:
        out["score"] = fwd.score_hidden(p, torch.from_numpy(_own(h3, mesh)), pay)
    return _np(out)


def decode(mesh, cfg, params, kanas=KANAS, kernels=False, int8_mxu=None, n_best=1,
           single=False, presharded=False):
    """``BeamDecoder.decode_batch`` through the sharded forward (fp32
    compute), given the full params or (``presharded``) this rank's
    ``shard_params``; with ``single`` also the one-rank kernel forward's."""
    from jlm_tpu_torch.decoder.engine import BeamDecoder, make_kernel_forward

    vocab, lexicon = _data()
    if presharded:
        params = shard_params(params_to_torch(params, mesh.device), cfg, mesh)
    fwd = make_sharded_forward(mesh, cfg, use_kernels=kernels, compute_dtype=torch.float32,
                               int8_mxu=int8_mxu)
    eng = BeamDecoder(params, lexicon, vocab, cfg, forward_fn=fwd, device=mesh.device)
    res = {"sharded": [[(r.segments, r.score) for r in rs]
                       for rs in eng.decode_batch(list(kanas), n_best=n_best)]}
    if single:
        one = BeamDecoder(params, lexicon, vocab, cfg, device=mesh.device,
                          forward_fn=make_kernel_forward(cfg, torch.float32, int8_mxu))
        res["single"] = [[(r.segments, r.score) for r in rs]
                         for rs in one.decode_batch(list(kanas), n_best=n_best)]
    return res


def topk(mesh, cfg, logits, k, layout_cfg=None):
    """``sharded_topk`` over this rank's columns: contiguous shards, or
    ``layout_cfg``'s D-softmax layout (every block's slice) with its ids."""
    full = torch.from_numpy(logits)
    if layout_cfg is None:
        vl = full.shape[1] // mesh.vocab
        v, i = sharded_topk(mesh, full[:, mesh.vocab_index * vl:(mesh.vocab_index + 1) * vl], k)
    else:
        ids = local_ids(layout_cfg, mesh)
        v, i = sharded_topk(mesh, full[:, ids], k, ids)
    return {"vals": v.numpy(), "idx": i.numpy()}


def nll(mesh, cfg, params, hs, tgt, kernels=False, fault=None):
    """The vocab-parallel CE on this rank's data rows (fp32, precision
    "highest"): the local-mean loss and the gradients of the local head
    leaves and of this rank's rows of ``hs``."""
    p = shard_params(params_to_torch(params, mesh.device), cfg, mesh)
    blocks = p["head"]["blocks"] if "blocks" in p["head"] else [p["head"]]
    leaves = [t.requires_grad_(True) for blk in blocks for t in (blk["W"], blk["b"])]
    h = torch.from_numpy(train_step.local_rows(torch.from_numpy(hs), mesh).numpy())
    h.requires_grad_(True)
    y = train_step.local_rows(torch.from_numpy(tgt), mesh)
    with _fault(fault):
        loss = vocab_parallel_nll(mesh, cfg, precision="highest", use_kernels=kernels)(p, h, y)
        grads = torch.autograd.grad(loss, leaves + [h])
    return {"loss": float(loss.detach()), "head": [g.numpy() for g in grads[:-1]], "dh": grads[-1].numpy()}


def suggest(mesh, cfg, params, contexts, k=5):
    from jlm_tpu_torch.decoder.suggest import Suggester

    vocab, _ = _data()
    s = Suggester(params, vocab, cfg, mesh=mesh, device=mesh.device)
    return [s.top_k(c, k) for c in contexts]


@contextlib.contextmanager
def _norm_fault(name):
    """A planted fault of the sharded step: the clip on each rank's own
    leaves' norm instead of the whole tree's."""
    from jlm_tpu_torch.train import optim

    keep = train_step.global_norm
    if name == "local norm":
        train_step.global_norm = lambda g, mesh: optim.global_norm([g[k] for k in sorted(g)])
    elif name is not None:
        raise ValueError(name)
    try:
        yield
    finally:
        train_step.global_norm = keep


def train(mesh, cfg, train_ids, dev_ids, exp=None, sampled_vocab_cfg=None, fault=None):
    """One epoch of ``Trainer(cfg, mesh=mesh)``: dev PPL before and after,
    the params (head gathered); with ``exp`` the state saved there, then
    loaded by a fresh trainer on the mesh.  ``sampled_vocab_cfg``: what
    constructing a trainer of that config raises."""
    from jlm_tpu_torch.train import Trainer

    out = {}
    if sampled_vocab_cfg is not None:
        try:
            Trainer(sampled_vocab_cfg, mesh=mesh, device=mesh.device)
            out["sampled_vocab"] = "no error"
        except ValueError as e:
            out["sampled_vocab"] = str(e)
    tr = Trainer(cfg, mesh=mesh, device=mesh.device)
    out["ppl0"] = tr.evaluate_ppl(dev_ids)
    with _norm_fault(fault):
        out["train_ppl"] = tr.run_epoch(train_ids, 0)
    out["params"] = _np(train_step.gather_head(tr.flat, mesh))
    out["dev_ppl"] = tr.evaluate_ppl(dev_ids)
    if exp is not None:
        tr.save_state(exp, epoch=0)
        tr2 = Trainer(cfg, mesh=mesh, device=mesh.device)
        out["resumed_epoch"] = tr2.load_state(exp)
        out["resumed_ppl"] = tr2.evaluate_ppl(dev_ids)
        out["resumed_equal"] = all(torch.equal(tr.flat[k].detach(), tr2.flat[k].detach())
                                   for k in tr.flat)
    return out


def run(device, mesh_shape, cases):
    """Every case on this rank; ``{case id: result}``, and which modules
    of JAX or of ``jlm_tpu`` the rank loaded (none)."""
    cfg_mesh = Config(mesh_data=mesh_shape[0], mesh_vocab=mesh_shape[1])
    mesh = make_mesh(cfg_mesh, device)
    out = {}
    for case_id, fn, kw in cases:
        kw = dict(kw)
        cfg = config(**{**kw.pop("cfg"), "mesh_data": mesh_shape[0], "mesh_vocab": mesh_shape[1]})
        for key in ("sampled_vocab_cfg", "layout_cfg"):
            if key in kw:
                kw[key] = config(**kw[key])
        import time as _t; _c = _t.process_time()
        out[case_id] = globals()[fn](mesh, cfg, **kw)
        out.setdefault("_cpu", {})[case_id] = _t.process_time() - _c
    out["_modules"] = sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib", "optax", "jlm_tpu"))
    return out


# ------------------------------------------------------- the seq pipeline

def pipeline(mesh, xs, layers, c0, h0, g_hs, g_c, g_h):
    """``make_seq_pipeline_scan`` on this rank's time block of ``xs``: the
    block's ``hs``, the final carries and the VJP of every input (each
    rank's share summed over the group) under the cotangents ``g_hs`` (on
    each rank its block) and ``g_c``, ``g_h`` (every rank holds the final
    carries; each takes 1/P of their term, so the ranks' terms sum to
    one)."""
    from jlm_tpu_torch.parallel.seq_pipeline import make_seq_pipeline_scan

    P, p = mesh.seq, mesh.rank
    TB = xs.shape[2] // P
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in [xs, c0, h0] + [t for W_b in layers for t in W_b]]
    pairs = [(leaves[3 + 2 * l], leaves[4 + 2 * l]) for l in range(len(layers))]
    block = slice(p * TB, (p + 1) * TB)
    fn = make_seq_pipeline_scan(mesh, num_layers=len(layers))
    hs, c_T, h_T = fn(leaves[0][:, :, block], pairs, leaves[1], leaves[2])
    term = ((hs * torch.from_numpy(g_hs[:, :, block])).sum()
            + ((c_T * torch.from_numpy(g_c)).sum() + (h_T * torch.from_numpy(g_h)).sum()) / P)
    grads = [comm.all_reduce_sum(g) for g in torch.autograd.grad(term, leaves)]
    return {"hs": _np(hs), "c": _np(c_T), "h": _np(h_T), "grads": _np(grads)}


def seq_train(mesh, cfg, train_ids, dev_ids, exp=None):
    """One epoch of ``Trainer(cfg, mesh=mesh)`` on the seq mesh: dev PPL
    before and after, the params; with ``exp`` the state saved there and
    loaded by a fresh trainer."""
    from jlm_tpu_torch.train import Trainer

    tr = Trainer(cfg, mesh=mesh, device=mesh.device)
    out = {"ppl0": tr.evaluate_ppl(dev_ids), "train_ppl": tr.run_epoch(train_ids, 0)}
    out["params"] = _np(tr.params)
    out["dev_ppl"] = tr.evaluate_ppl(dev_ids)
    if exp is not None:
        tr.save_state(exp, epoch=0)
        tr2 = Trainer(cfg, mesh=mesh, device=mesh.device)
        out["resumed_epoch"] = tr2.load_state(exp)
        out["resumed_equal"] = all(torch.equal(tr.flat[k].detach(), tr2.flat[k].detach())
                                   for k in tr.flat)
    return out


def run_seq(device, P, cases):
    """Every case on this rank of a ``('seq',)`` mesh of ``P`` ranks, as
    :func:`run`."""
    mesh = make_seq_mesh(Config(mesh_seq=P), device)
    out = {}
    for case_id, fn, kw in cases:
        kw = dict(kw)
        if "cfg" in kw:
            kw["cfg"] = config(**{**kw["cfg"], "mesh_seq": P})
        out[case_id] = globals()[fn](mesh, **kw)
    out["_modules"] = sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib", "optax", "jlm_tpu"))
    return out
