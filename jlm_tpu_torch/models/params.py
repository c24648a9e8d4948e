"""Parameter bridge: the numpy weight spec -> torch tensors on a device.

The parameter pytree is the one :func:`jlm_tpu.models.params.init_params`
builds (``{"embedding", "lstm": [{"W", "b"}], "head": {"W", "b"}}``), or
:func:`jlm_tpu.ops.quant.quantize_params` makes from it, where a weight is
an int8 ``{"q", "scale"}`` dict.  Leaves keep their dtypes: int8 ``q``
stays int8 and its scale fp32.

Checkpoints are the ``ckpt-*.npz`` archives of
``jlm_tpu/train/checkpoint.py`` — flat ``a/0/b`` keys — read here directly,
since ``jlm_tpu.train`` imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no GPU
    is present.  Nothing here falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def params_to_torch(params: Any, device) -> Any:
    """Copy a parameter pytree (numpy or torch leaves) onto ``device``."""
    dev = resolve_device(device)

    def walk(p):
        if isinstance(p, dict):
            return {k: walk(v) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return [walk(v) for v in p]
        if isinstance(p, torch.Tensor):
            return p.to(dev)
        return torch.from_numpy(np.ascontiguousarray(p)).to(dev)

    return walk(params)


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    """Nested pytree from flat ``a/0/b`` keys; all-digit levels become lists."""
    root: Dict = {}
    for name, arr in flat.items():
        node = root
        *parents, leaf = name.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = arr

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_npz_params(path: str) -> Any:
    """Read a ``ckpt-*.npz`` weight archive into a numpy parameter pytree."""
    with np.load(path) as z:
        return _unflatten({k: z[k] for k in z.files})

