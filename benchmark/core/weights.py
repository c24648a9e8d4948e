"""Model weights made from the seed on the card, and the int8 weight format.

The weights are the benchmark's input: one ``torch.Generator`` on the
device draws every fp32 leaf in one call, each leaf scaled to the uniform
range its configuration file gives under ``weights``.  The int8 format is
BASELINE config 4's (symmetric, an fp32 scale per output column of a matmul
weight and per row of the embedding), computed here from the fp32 weights so
that both the program and the reference are handed the same int8 leaves.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

Params = Dict[str, Any]


def leaf_shapes(model: Dict[str, Any]) -> List[Tuple[str, Tuple[int, ...]]]:
    """``(name, shape)`` of every leaf in the program's parameter layout."""
    V, E, H, L = (model["vocab_size"], model["embed_size"], model["hidden_size"],
                  model["num_layers"])
    out: List[Tuple[str, Tuple[int, ...]]] = [("embedding", (V, E))]
    for l in range(L):
        out += [(f"lstm/{l}/W", ((E if l == 0 else H) + H, 4 * H)), (f"lstm/{l}/b", (4 * H,))]
    if model["head"] == "dsoftmax":
        ds = model["dsoftmax"]
        for k, (s, d) in enumerate(zip(ds["block_sizes"], ds["block_dims"])):
            out += [(f"head/blocks/{k}/W", (d, s)), (f"head/blocks/{k}/b", (s,))]
    else:
        out += [("head/W", (H, V)), ("head/b", (V,))]
    return out


def _scale_key(name: str) -> str:
    kind = name.rsplit("/", 1)[-1]
    if name == "embedding":
        return "embedding"
    return ("lstm_" if name.startswith("lstm") else "head_") + kind


def make_weights(model: Dict[str, Any], scales: Dict[str, float], seed: int,
                 device) -> Params:
    """fp32 weights ``U(-a, a)`` per leaf, ``a = scales[...]``, drawn by one
    generator on ``device`` in one call; nested as the program lays them out."""
    shapes = leaf_shapes(model)
    total = sum(int(torch.Size(s).numel()) for _, s in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    flat.mul_(2.0).sub_(1.0)
    leaves, off = {}, 0
    for name, shape in shapes:
        n = int(torch.Size(shape).numel())
        leaves[name] = flat[off:off + n].view(shape).mul_(scales[_scale_key(name)])
        off += n
    return unflatten(leaves)


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


def quantize_params(params: Params, bits: int = 8) -> Params:
    """Every weight quantized (the embedding per row, matmul weights per
    column); biases stay fp32."""
    out = {}
    for name, t in flatten(params).items():
        if name == "embedding":
            out[name] = quantize(t, 1, bits)
        elif name.endswith("/W"):
            out[name] = quantize(t, 0, bits)
        else:
            out[name] = t
    return unflatten(out)


def dequantize_params(params: Params) -> Params:
    """fp32 weights of a quantized tree (an fp32 tree passes through)."""
    out = {}
    for name, t in flatten(params).items():
        if isinstance(t, dict):
            out[name] = dequantize(t, 1 if name == "embedding" else 0)
        else:
            out[name] = t
    return unflatten(out)
