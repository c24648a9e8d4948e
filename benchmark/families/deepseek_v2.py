"""Model family ``deepseek_v2``: DeepSeek-V2 (MLA attention, routed and
shared experts) as the lattice search's word LM, served by ``BeamDecoder``
through the forward of ``jlm_tpu_torch.models.deepseek_v2`` (its path state
the latent path cache).  What each name gives the shared code is set out in
``core/registry.py``; the reference is ``reference/deepseek_v2.py``.  No
training cell: ``reference_steps``, ``train_controls`` and the training
adapter are None."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from benchmark.core.serve import lookahead_counts
from benchmark.core.weights import Leaf
from benchmark.reference import deepseek_v2 as ref

# published settings the program implements as fixed (make_config refuses others)
FIXED = {"q_lora_rank": None, "attention_bias": False, "hidden_act": "silu",
         "scoring_func": "softmax", "topk_method": "greedy", "n_group": 1, "topk_group": 1,
         "moe_layer_freq": 1, "tie_word_embeddings": False}


def head_blocks(model: Dict[str, Any]) -> List[Tuple[int, int]]:
    """The untied head: one ``(D, V)`` block."""
    return [(model["hidden_size"], model["vocab_size"])]


def leaves(model: Dict[str, Any]) -> List[Leaf]:
    """Every leaf in the program's layout (matmul weights ``[in, out]``,
    experts ``[E, in, out]``).  Only the head is int8, per output column."""
    V, D, L = model["vocab_size"], model["hidden_size"], model["num_hidden_layers"]
    H, dn, dr, dv, c = (model["num_attention_heads"], model["qk_nope_head_dim"],
                        model["qk_rope_head_dim"], model["v_head_dim"], model["kv_lora_rank"])
    I, Ie, E = (model["intermediate_size"], model["moe_intermediate_size"],
                model["n_routed_experts"])
    Is = Ie * model["n_shared_experts"]
    out = [Leaf("embed", (V, D), "embed", None)]
    for l in range(L):
        p = f"layers/{l}/"
        out += [Leaf(p + "attn_norm", (D,), "norm", None),
                Leaf(p + "q_proj", (D, H * (dn + dr)), "q_proj", None),
                Leaf(p + "kv_a_proj", (D, c + dr), "kv_a_proj", None),
                Leaf(p + "kv_norm", (c,), "norm", None),
                Leaf(p + "kv_b_proj", (c, H * (dn + dv)), "kv_b_proj", None),
                Leaf(p + "o_proj", (H * dv, D), "o_proj", None),
                Leaf(p + "mlp_norm", (D,), "norm", None)]
        if l < model["first_k_dense_replace"]:
            out += [Leaf(p + "mlp/gate", (D, I), "mlp_in", None),
                    Leaf(p + "mlp/up", (D, I), "mlp_in", None),
                    Leaf(p + "mlp/down", (I, D), "dense_down", None)]
        else:
            out += [Leaf(p + "moe/router", (D, E), "router", None),
                    Leaf(p + "moe/experts/gate", (E, D, Ie), "mlp_in", None),
                    Leaf(p + "moe/experts/up", (E, D, Ie), "mlp_in", None),
                    Leaf(p + "moe/experts/down", (E, Ie, D), "expert_down", None),
                    Leaf(p + "moe/shared/gate", (D, Is), "mlp_in", None),
                    Leaf(p + "moe/shared/up", (D, Is), "mlp_in", None),
                    Leaf(p + "moe/shared/down", (Is, D), "shared_down", None)]
    return out + [Leaf("norm", (D,), "norm", None), Leaf("head/W", (D, V), "head_W", 0)]


# -- the program adapter: the program is imported inside these functions only


def make_config(model: Dict[str, Any], section: Dict[str, Any], **extra):
    """The program's ``DeepseekV2Config`` for a configuration file's
    ``model`` section and its ``serve`` section (the first call a cell
    makes: a program without the family fails here, before any weight)."""
    try:
        from jlm_tpu_torch.models.deepseek_v2 import DeepseekV2Config
    except ImportError as e:
        raise RuntimeError("the program under test has no model family 'deepseek_v2' "
                           f"({e})") from e

    for key, want in FIXED.items():
        if model.get(key, want) != want:
            raise ValueError(f"the program implements {key}={want!r}, not {model[key]!r}")
    rs = model["rope_scaling"]
    if rs["type"] != "yarn":
        raise ValueError(f"the program implements YaRN RoPE, not {rs['type']!r}")
    keys = ("vocab_size", "hidden_size", "num_hidden_layers", "first_k_dense_replace",
            "intermediate_size", "moe_intermediate_size", "n_routed_experts",
            "n_shared_experts", "num_experts_per_tok", "norm_topk_prob",
            "routed_scaling_factor", "num_attention_heads", "kv_lora_rank",
            "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "rms_norm_eps", "rope_theta")
    rope = {"rope_factor": rs["factor"], "rope_mscale": rs["mscale"],
            "rope_mscale_all_dim": rs["mscale_all_dim"], "rope_beta_fast": rs["beta_fast"],
            "rope_beta_slow": rs["beta_slow"],
            "rope_original_max_position": rs["original_max_position_embeddings"]}
    serve = {k: v for k, v in section.items() if k != "precision"}
    return DeepseekV2Config(**{k: model[k] for k in keys}, **rope, **serve, **extra)


def make_decoder(params, lex, config, precision: str, device):
    import torch

    from benchmark.core.program import make_vocab
    from jlm_tpu_torch.decoder.engine import BeamDecoder
    from jlm_tpu_torch.models.deepseek_v2 import make_forward

    vocab, lexicon = make_vocab(lex)
    dtype = {"default": torch.bfloat16, "highest": torch.float32}[precision]
    return BeamDecoder(params, lexicon, vocab, config, forward_fn=make_forward(config, dtype),
                       device=device)


make_trainer = flat_params = first_moments = train_patch_points = None


def _rows(x, *args, **kwargs):
    return int(x.shape[0])


def _mla_shape(x, layer, rows, index, config, *args, **kwargs):
    """``(R, pos, max_word_len, D, heads, d_nope, d_rope, d_v, kv_lora_rank)``."""
    return (int(x.shape[0]), rows.pos, config.max_word_len, config.hidden_size,
            config.num_attention_heads, config.qk_nope_head_dim, config.qk_rope_head_dim,
            config.v_head_dim, config.kv_lora_rank)


def _moe_shape(x, layer, rows, index, config, *args, **kwargs):
    """``(R, D, experts, experts a row, expert width, shared width)``."""
    return (int(x.shape[0]), config.hidden_size, config.n_routed_experts,
            config.num_experts_per_tok, config.moe_intermediate_size,
            config.moe_intermediate_size * config.n_shared_experts)


def serve_patch_points():
    """``(owner, attribute, layer label, shape of a call or None)`` the serve
    wrappers replace."""
    from jlm_tpu_torch.decoder import engine
    from jlm_tpu_torch.models import deepseek_v2 as model

    return [(engine.BeamDecoder, "_pack", "pack", None),
            (engine.BeamDecoder, "materialize", "materialize", None),
            (engine, "_decode_scan", "decode_scan", None),
            (model, "project_lse", "project_lse", _rows),
            (model, "cand_dot", "cand_dot", None),
            (model, "mla_attention", "mla_attention", _mla_shape),
            (model, "moe", "moe", _moe_shape)]


# -- the reference


def reference_lm(params, model: Dict[str, Any]) -> ref.RefLM:
    return ref.RefLM(params, model)


def control_lm(weights, model: Dict[str, Any]) -> ref.RefLM:
    """The serve control: the reference one precision below the served
    configuration: e4m3 operands in every product of the blocks (bf16
    served) and an int4 head (int8 served), the int8 format's axes."""
    import torch

    from benchmark.core.weights import dequantize_params, quantize_params
    from benchmark.reference.precision import round_to

    lv = leaves(model)
    return ref.RefLM(dequantize_params(quantize_params(weights, lv, 4), lv), model,
                     operand=round_to(torch.float8_e4m3fn))


reference_steps = train_controls = train_ops = None


# -- useful operations, by precision (``mfu.serve``)


def attention_ops(model: Dict[str, Any], ancestors: int) -> Tuple[float, float]:
    """(projection, attention) operations of one row through one layer's
    MLA: ``q``, ``[c_kv | k_pe]``, the per-head ``W_kv_b`` products of the
    row's own latent (absorbed or not, the same count) and ``W_o``; then
    scores and values over ``ancestors`` words (the row included), each
    head ``d_nope + d_rope`` and ``d_v`` wide (the decompressed form, the
    smaller)."""
    D, H = model["hidden_size"], model["num_attention_heads"]
    dn, dr, dv, c = (model["qk_nope_head_dim"], model["qk_rope_head_dim"],
                     model["v_head_dim"], model["kv_lora_rank"])
    proj = 2 * (D * H * (dn + dr) + D * (c + dr) + c * H * (dn + dv) + H * dv * D)
    return float(proj), float(2 * ancestors * H * (dn + dr + dv))


def ffn_ops(model: Dict[str, Any], dense: bool) -> Tuple[float, float]:
    """(bf16, fp32) operations of one row through one layer's MLP: the
    dense SiLU-gated MLP, or the routed experts a row picks, the shared
    experts and (fp32) the router."""
    D = model["hidden_size"]
    if dense:
        return float(6 * D * model["intermediate_size"]), 0.0
    Ie = model["moe_intermediate_size"]
    bf16 = 6 * D * Ie * (model["num_experts_per_tok"] + model["n_shared_experts"])
    return float(bf16), float(2 * D * model["n_routed_experts"])


def min_ancestors(pos: int, max_word_len: int) -> int:
    """The fewest words a path at position ``pos`` attends, itself and the
    root included: ``ceil(pos / max_word_len) + 1``."""
    return -(-pos // max_word_len) + 1


def serve_ops(kanas: List[str], model: Dict[str, Any], serve: Dict[str, Any],
              by_reading: Dict[str, List[int]], max_word_len: int) -> Dict[str, float]:
    """A lower bound of the operations the inputs need, by precision: per
    sentence of T kana, ``beam_width`` rows at each position 0..T through
    every layer (the projections, the attention over the fewest ancestors a
    path there has, the dense MLP or the routed and shared experts in bf16,
    the router in fp32) and the head (int8 with int8 weights, else bf16),
    and per row the candidate dots of the words starting there and
    ``<eos>`` (bf16), as the LSTM family counts them."""
    D, L, B = model["hidden_size"], model["num_hidden_layers"], serve["beam_width"]
    k = model["first_k_dense_replace"]
    head = sum(2 * d * s for d, s in head_blocks(model))
    head_kind = "int8" if serve.get("quantize") and serve.get("int8_mxu", True) else "bf16"
    dense_bf, _ = ffn_ops(model, True)
    moe_bf, moe_fp = ffn_ops(model, False)
    M = min(max_word_len, max(len(r) for r in by_reading))
    out = {"bf16": 0.0, "fp32": 0.0, head_kind: 0.0}
    for kana in kanas:
        T = len(kana)
        for pos in range(T + 1):
            proj, att = attention_ops(model, min_ancestors(pos, max_word_len))
            out["bf16"] += B * (L * (proj + att) + k * dense_bf + (L - k) * moe_bf)
            out["fp32"] += B * (L - k) * moe_fp
        cands = sum(c + 1 for c in lookahead_counts(kana, by_reading, M)) + 1
        out["bf16"] += B * cands * 2 * D
        out[head_kind] += (T + 1) * B * head
    return out

