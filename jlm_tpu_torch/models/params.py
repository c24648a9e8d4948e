"""Parameter pytree: initialization, the weight spec, and the bridge to torch.

``init_params`` and ``param_spec`` are the port's copies of
:mod:`jlm_tpu.models.params` (numpy-seeded, so both packages build the same
weights bit for bit from a seed).  The layout::

    {
      "embedding": f32[V, E],
      "lstm": [ {"W": f32[in_l + H, 4H], "b": f32[4H]} ],   # in_0 = E, in_l = H
      "head": {"W": f32[H, V], "b": f32[V]}                       # full softmax
            | {"blocks": [{"W": f32[d_k, s_k], "b": f32[s_k]}]}   # D-softmax
    }

Gate order inside the fused ``4H`` dimension is ``i, j, f, o``; the forget
bias is applied at run time (``config.forget_bias``), not baked into ``b``.
:func:`jlm_tpu_torch.ops.quant.quantize_params` turns a weight into an
int8 ``{"q", "scale"}`` dict; the bridge keeps its dtypes (int8 ``q``
stays int8 and its scale fp32).

Checkpoints are the ``ckpt-*.npz`` archives of
``jlm_tpu/train/checkpoint.py`` — flat ``a/0/b`` keys — read here directly.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from jlm_tpu_torch.config import Config

INIT_SCALE = 0.05  # PTB-style uniform init


def init_params(config: Config, seed: int | None = None) -> Dict[str, Any]:
    rng = np.random.default_rng(config.seed if seed is None else seed)

    def u(*shape):
        return rng.uniform(-INIT_SCALE, INIT_SCALE, size=shape).astype(np.float32)

    V, E, H = config.vocab_size, config.embed_size, config.hidden_size
    lstm: List[Dict[str, np.ndarray]] = []
    for layer in range(config.num_layers):
        in_dim = E if layer == 0 else H
        lstm.append({"W": u(in_dim + H, 4 * H), "b": np.zeros(4 * H, np.float32)})

    if config.head == "dsoftmax":
        assert config.dsoftmax is not None, "dsoftmax config required"
        assert sum(config.dsoftmax.block_sizes) == V, (
            f"dsoftmax blocks {config.dsoftmax.block_sizes} must sum to vocab {V}"
        )
        if config.dsoftmax.mode == "disjoint":
            assert sum(config.dsoftmax.block_dims) <= H
        blocks = [
            {"W": u(d, s), "b": np.zeros(s, np.float32)}
            for s, d in zip(config.dsoftmax.block_sizes, config.dsoftmax.block_dims)
        ]
        head: Dict[str, Any] = {"blocks": blocks}
    else:
        head = {"W": u(H, V), "b": np.zeros(V, np.float32)}

    return {"embedding": u(V, E), "lstm": lstm, "head": head}


def param_spec(params: Dict[str, Any]) -> Dict[str, Any]:
    """Names/shapes/dtypes of every leaf — the trainer<->engine contract."""

    def walk(p, prefix=""):
        out = {}
        if isinstance(p, dict):
            for k, v in p.items():
                out.update(walk(v, f"{prefix}{k}/"))
        elif isinstance(p, (list, tuple)):
            for i, v in enumerate(p):
                out.update(walk(v, f"{prefix}{i}/"))
        else:
            arr = np.asarray(p)
            out[prefix[:-1]] = {"shape": tuple(arr.shape), "dtype": str(arr.dtype)}
        return out

    return walk(params)


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


def params_to_numpy(params: Any) -> Any:
    """A parameter pytree (torch or numpy leaves) as numpy arrays on the
    host, for the numpy oracle."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    if isinstance(params, torch.Tensor):
        return params.detach().cpu().numpy()
    return np.asarray(params)


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

