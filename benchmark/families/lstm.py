"""Model family ``lstm``: the JLM LSTM language model (an embedding, L LSTM
layers, a full or D-softmax head) served by ``BeamDecoder`` and trained by
``Trainer``.  What each name gives the shared code is set out in
``core/registry.py``; the reference is ``reference/lstm.py``."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from benchmark.core.serve import lookahead_counts
from benchmark.core.weights import Leaf
from benchmark.reference import lstm as ref


def head_blocks(model: Dict[str, Any]) -> List[Tuple[int, int]]:
    """``(D, V)`` of each head block: the full head one, D-softmax's each."""
    if model["head"] == "dsoftmax":
        ds = model["dsoftmax"]
        return list(zip(ds["block_dims"], ds["block_sizes"]))
    return [(model["hidden_size"], model["vocab_size"])]


def leaves(model: Dict[str, Any]) -> List[Leaf]:
    """Every leaf in the program's layout.  int8: the embedding per row, the
    matmul weights per output column; biases fp32."""
    V, E, H, L = (model["vocab_size"], model["embed_size"], model["hidden_size"],
                  model["num_layers"])
    out = [Leaf("embedding", (V, E), "embedding", 1)]
    for l in range(L):
        out += [Leaf(f"lstm/{l}/W", ((E if l == 0 else H) + H, 4 * H), "lstm_W", 0),
                Leaf(f"lstm/{l}/b", (4 * H,), "lstm_b", None)]
    if model["head"] == "dsoftmax":
        for k, (d, s) in enumerate(head_blocks(model)):
            out += [Leaf(f"head/blocks/{k}/W", (d, s), "head_W", 0),
                    Leaf(f"head/blocks/{k}/b", (s,), "head_b", None)]
    else:
        out += [Leaf("head/W", (H, V), "head_W", 0), Leaf("head/b", (V,), "head_b", None)]
    return out


# -- the program adapter: the program is imported inside these functions only


def make_config(model: Dict[str, Any], section: Dict[str, Any], **extra):
    """The program's ``Config`` for a configuration file's ``model`` section
    and its ``serve`` or ``train`` section."""
    from jlm_tpu_torch.config import Config, DSoftmaxConfig

    fields = {k: v for k, v in model.items() if k != "dsoftmax"}
    if model.get("dsoftmax"):
        ds = model["dsoftmax"]
        fields["dsoftmax"] = DSoftmaxConfig(block_sizes=tuple(ds["block_sizes"]),
                                            block_dims=tuple(ds["block_dims"]),
                                            mode=ds["mode"])
    program = {k: v for k, v in section.items() if k != "precision"}
    return Config(**fields, **program, **extra)


def make_decoder(params, lex, config, precision: str, device):
    from benchmark.core.program import make_vocab
    from jlm_tpu_torch.decoder.engine import BeamDecoder

    vocab, lexicon = make_vocab(lex)
    return BeamDecoder(params, lexicon, vocab, config, precision=precision, device=device)


def make_trainer(config, params, device):
    from jlm_tpu_torch.train.trainer import Trainer

    return Trainer(config, params, device=device)


def flat_params(trainer) -> Dict[str, Any]:
    """The trainer's leaves by ``a/0/b`` path (the tensors it updates)."""
    return trainer.flat


def first_moments(trainer) -> Dict[str, Any]:
    return trainer.opt_state.mu


def _rows(x, *args, **kwargs):
    return int(x.shape[0])


def _cell_shape(x, h, *args, **kwargs):
    return (int(x.shape[0]), int(x.shape[1]), int(h.shape[1]))


def _ce_shape(tag):
    def shape(h, W, *args, **kwargs):
        return (tag, int(h.shape[0]), int(h.shape[1]), int(W.shape[1]))
    return shape


def _scan_shape(tag):
    def shape(xs, W, b, c0, h0, *args, **kwargs):
        return (tag, int(xs.shape[0]), int(xs.shape[1]), int(xs.shape[2]), int(h0.shape[-1]))
    return shape


def serve_patch_points():
    """``(owner, attribute, layer label, shape of a call or None)`` the serve
    wrappers replace."""
    from jlm_tpu_torch.decoder import engine

    return [(engine.BeamDecoder, "_pack", "pack", None),
            (engine.BeamDecoder, "materialize", "materialize", None),
            (engine, "_decode_scan", "decode_scan", None),
            (engine, "project_lse", "project_lse", _rows),
            (engine, "lstm_cell_step", "lstm_cell", _cell_shape),
            (engine, "cand_dot", "cand_dot", None)]


def train_patch_points():
    from jlm_tpu_torch.models import heads
    from jlm_tpu_torch.ops import lstm_scan, softmax_ce
    from jlm_tpu_torch.train import optim, trainer

    return [(trainer.Trainer, "_train_step", "train_step", None),
            (trainer.Trainer, "_loss", "forward", None),
            (heads, "ce_loss_fused", "softmax_ce", _ce_shape("fwd")),
            (softmax_ce, "ce_bwd", "softmax_ce", _ce_shape("bwd")),
            (lstm_scan, "lstm_scan_fwd", "lstm_scan", _scan_shape("fwd")),
            (lstm_scan, "lstm_scan_bwd", "lstm_scan", _scan_shape("bwd")),
            (optim, "apply_gradients", "optimizer", None)]


# -- the reference


def reference_lm(params, model: Dict[str, Any]) -> ref.RefLM:
    return ref.RefLM(params, model)


def control_lm(weights, model: Dict[str, Any]) -> ref.RefLM:
    """The serve control: the reference one precision below the served int8,
    int4 weights (the int8 format's axes) and fp8 activations."""
    import torch

    from benchmark.core.weights import dequantize_params, quantize_params
    from benchmark.reference.precision import round_to

    lv = leaves(model)
    return ref.RefLM(dequantize_params(quantize_params(weights, lv, 4), lv), model,
                     operand=round_to(torch.float8_e4m3fn))


reference_steps = ref.reference_steps


def train_controls() -> Dict[str, Dict[str, Any]]:
    """``reference_steps`` keywords of the training control (bf16 cell
    products, fp8 head products) and of the planted fault "half of the
    batch left out"."""
    import torch

    from benchmark.reference.precision import round_to

    return {"control": dict(scan_operand=round_to(torch.bfloat16),
                            ce_operand=round_to(torch.float8_e4m3fn)),
            "half_batch": dict(half_batch=True)}


# -- useful operations, by precision (``mfu.serve``, ``mfu.train``)


def serve_ops(kanas: List[str], model: Dict[str, Any], serve: Dict[str, Any],
              by_reading: Dict[str, List[int]], max_word_len: int) -> Dict[str, float]:
    """Operations the inputs need, by precision: per sentence of T kana, T + 1
    forwards (the root's and one a position) of ``beam_width`` rows through
    every layer's cell (bf16) and the head (int8 with int8 weights, else
    bf16), and per row the candidate dots of the words starting there and
    ``<eos>`` (bf16)."""
    E, H, L = model["embed_size"], model["hidden_size"], model["num_layers"]
    B = serve["beam_width"]
    cell = sum(2 * ((E if l == 0 else H) + H) * 4 * H for l in range(L))
    head = sum(2 * d * s for d, s in head_blocks(model))
    head_kind = "int8" if serve.get("quantize") and serve.get("int8_mxu", True) else "bf16"
    M = min(max_word_len, max(len(r) for r in by_reading))
    out = {"bf16": 0.0, head_kind: 0.0}
    for kana in kanas:
        rows = (len(kana) + 1) * B
        cands = sum(c + 1 for c in lookahead_counts(kana, by_reading, M)) + 1
        out["bf16"] += rows * cell + B * cands * 2 * H
        out[head_kind] += rows * head
    return out


def train_ops(model: Dict[str, Any], tp: Dict[str, Any], steps: int) -> Dict[str, float]:
    """A step's forward and backward of every layer's cell over the window
    (fp32: the forward's product, the backward's dx/dh and dW) and of the
    head (bf16: the logits, dh and dW once each)."""
    E, H, L, V = (model["embed_size"], model["hidden_size"], model["num_layers"],
                  model["vocab_size"])
    N = tp["batch"] * tp["window"]
    cell = sum(3 * 2 * N * ((E if l == 0 else H) + H) * 4 * H for l in range(L))
    return {"fp32": float(cell * steps), "bf16": float(3 * 2 * N * H * V * steps)}
