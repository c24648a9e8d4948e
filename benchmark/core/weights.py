"""Model weights made from the seed on the card, and the int8 weight format.

The weights are the benchmark's input: one ``torch.Generator`` on the
device draws every fp32 leaf in one call, each leaf scaled to the uniform
range its configuration file gives under ``weights``.  Which leaves there
are, and which are int8 on which axis, is the model family's table
(:class:`Leaf`).  The int8 format is BASELINE config 4's (symmetric, an fp32
scale per slice along the leaf's axis: per output column of a matmul weight,
per row of an embedding), computed here from the fp32 weights so that both
the program and the reference are handed the same int8 leaves.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

Params = Dict[str, Any]


class Leaf(NamedTuple):
    """One leaf of a model family's parameter tree (``families/<family>.py``'s
    ``leaves``): its ``a/0/b`` name and shape in the program's layout, its key
    into the configuration's ``weights`` scales, and the axis its int8 scale
    reduces over in the served format (None: the leaf stays fp32)."""

    name: str
    shape: Tuple[int, ...]
    scale: str
    int8_axis: Optional[int]


def make_weights(leaves: Sequence[Leaf], scales: Dict[str, float], seed: int,
                 device) -> Params:
    """fp32 weights ``U(-a, a)`` per leaf, ``a = scales[leaf.scale]``, drawn in
    the leaves' order by one generator on ``device`` in one call; nested as the
    program lays them out."""
    total = sum(int(torch.Size(lf.shape).numel()) for lf in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    flat.mul_(2.0).sub_(1.0)
    out, off = {}, 0
    for lf in leaves:
        n = int(torch.Size(lf.shape).numel())
        out[lf.name] = flat[off:off + n].view(lf.shape).mul_(scales[lf.scale])
        off += n
    return unflatten(out)


def unflatten(flat: Dict[str, torch.Tensor]) -> Params:
    root: Dict[str, Any] = {}
    for name, t in flat.items():
        node = root
        *parents, leaf = name.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = t

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``a/0/b`` keyed leaves of a nested tree (a quantized leaf stays a dict)."""
    if isinstance(tree, dict) and not ("q" in tree and "scale" in tree):
        out: Dict[str, Any] = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def quantize(w: torch.Tensor, axis: int, bits: int = 8) -> Dict[str, torch.Tensor]:
    """Symmetric quantization reducing over ``axis``: ``scale = max|w| / qmax``,
    ``q = clip(round(w / scale))`` (``qmax`` 127 for int8, 7 for int4)."""
    qmax = (1 << (bits - 1)) - 1
    scale = (w.abs().amax(dim=axis).clamp_min(1e-8) / qmax).float()
    q = torch.clamp(torch.round(w / scale.unsqueeze(axis)), -qmax, qmax)
    return {"q": q.to(torch.int8), "scale": scale}


def dequantize(leaf: Dict[str, torch.Tensor], axis: int) -> torch.Tensor:
    return leaf["q"].float() * leaf["scale"].unsqueeze(axis)


def quantize_params(params: Params, leaves: Sequence[Leaf], bits: int = 8) -> Params:
    """Each leaf with an ``int8_axis`` quantized over that axis; the others
    stay fp32."""
    axis = {lf.name: lf.int8_axis for lf in leaves}
    out = {}
    for name, t in flatten(params).items():
        out[name] = t if axis[name] is None else quantize(t, axis[name], bits)
    return unflatten(out)


def dequantize_params(params: Params, leaves: Sequence[Leaf]) -> Params:
    """fp32 weights of a quantized tree (an fp32 tree passes through)."""
    axis = {lf.name: lf.int8_axis for lf in leaves}
    out = {}
    for name, t in flatten(params).items():
        out[name] = dequantize(t, axis[name]) if isinstance(t, dict) else t
    return unflatten(out)
