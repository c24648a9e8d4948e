"""Experiment directories in the reference's checkpoint format.

The format of ``jlm_tpu/train/checkpoint.py``, written and read without
JAX: ``config.json`` (the full ``Config``, written once per directory),
``ckpt-<tag>.npz`` (flat ``a/0/b`` keys, one array per parameter leaf)
and ``log.jsonl`` (one JSON record per epoch).  Either package loads the
other's weights.

The port's optimizer state goes in ``opt_state_torch.npz`` with named
arrays (``m/<path>``, ``v/<path>``, ``acc/<path>``, ``count``,
``mini_step``, ``epoch``), never in the reference's ``opt_state.npz``,
whose unnamed leaves follow optax's tree order: a JAX resume of a port
directory starts fresh moments instead of misreading them.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from jlm_tpu.config import Config
from jlm_tpu_torch.models.params import load_npz_params
from jlm_tpu_torch.train.optim import OptState

OPT_STATE_FILE = "opt_state_torch.npz"


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Leaves of a parameter pytree by flat path (``lstm/0/W``)."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_checkpoint(exp_dir: str, params: Any, config: Config, tag: str = "latest") -> str:
    os.makedirs(exp_dir, exist_ok=True)
    cfg_path = os.path.join(exp_dir, "config.json")
    if not os.path.exists(cfg_path):
        with open(cfg_path, "w") as f:
            f.write(config.to_json())
    path = os.path.join(exp_dir, f"ckpt-{tag}.npz")
    np.savez(path, **{k: _host(v) for k, v in flatten(params).items()})
    return path


def load_checkpoint(exp_dir: str, tag: str = "latest") -> Tuple[Any, Optional[Config]]:
    """``(numpy parameter pytree, Config or None)``."""
    params = load_npz_params(os.path.join(exp_dir, f"ckpt-{tag}.npz"))
    cfg_path = os.path.join(exp_dir, "config.json")
    config = None
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            config = Config.from_json(f.read())
    return params, config


def append_log(exp_dir: str, record: Dict[str, Any]) -> None:
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "log.jsonl"), "a") as f:
        f.write(json.dumps(record) + "\n")


def read_log(exp_dir: str) -> List[Dict[str, Any]]:
    path = os.path.join(exp_dir, "log.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def truncate_log(exp_dir: str, last_epoch: int) -> None:
    """Drop the records of epochs after ``last_epoch``: a resumed run
    re-runs them, and must not leave two records of one epoch."""
    records = read_log(exp_dir)
    kept = [r for r in records if r.get("epoch", -1) <= last_epoch]
    if len(kept) != len(records):
        with open(os.path.join(exp_dir, "log.jsonl"), "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in kept)


def save_opt_state(exp_dir: str, state: OptState, epoch: int) -> str:
    arrays = {"count": np.int64(state.count), "mini_step": np.int64(state.mini_step),
              "epoch": np.int64(epoch)}
    for name, moments in (("m", state.mu), ("v", state.nu), ("acc", state.acc)):
        arrays.update({f"{name}/{k}": _host(t) for k, t in moments.items()})
    path = os.path.join(exp_dir, OPT_STATE_FILE)
    np.savez(path, **arrays)
    return path


def load_opt_state(exp_dir: str, device) -> Optional[Tuple[OptState, int]]:
    """``(state, epoch)`` from ``opt_state_torch.npz``, or None without one."""
    path = os.path.join(exp_dir, OPT_STATE_FILE)
    if not os.path.exists(path):
        return None
    moments: Dict[str, Dict[str, torch.Tensor]] = {"m": {}, "v": {}, "acc": {}}
    with np.load(path) as z:
        for key in z.files:
            name, _, leaf = key.partition("/")
            if leaf:
                moments[name][leaf] = torch.from_numpy(z[key]).to(device)
        state = OptState(count=int(z["count"]), mu=moments["m"], nu=moments["v"],
                         acc=moments["acc"], mini_step=int(z["mini_step"]))
        return state, int(z["epoch"])
