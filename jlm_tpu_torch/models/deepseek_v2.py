"""DeepSeek-V2 as the lattice search's word LM: one decode step for R rows.

The layer equations are the published ones (``modeling_deepseek.py`` of
deepseek-ai/DeepSeek-V2-Lite).  Each row feeds its path's next word at
position = its depth (the root ``<eos>`` is position 0):

- ``x = embed(word)``;
- per layer ``h = x + MLA(RMSNorm(x))``, ``x = h + F(RMSNorm(h))``, with F
  the dense SiLU-gated MLP in the first ``first_k_dense_replace`` layers and
  the MoE after them;
- MLA without q-LoRA: ``q = W_q x`` (per head ``[nope | pe]``), ``[c_kv |
  k_pe] = W_kv_a x``, ``c_kv = RMSNorm_kv(c_kv)``, per head ``[k_nope | v] =
  W_kv_b c_kv``; ``q_pe`` and ``k_pe`` rotated by YaRN RoPE in the
  published layout (interleaved pairs de-interleaved, then
  ``rotate_half``); softmax scale ``(d_nope + d_rope)^-1/2 m^2``, ``m = 0.1
  mscale_all_dim ln(factor) + 1``; the softmax in fp32 over the row's
  ancestors and itself; the output through ``W_o``;
- the MoE (:mod:`jlm_tpu_torch.ops.moe`): the fp32 gate's softmax and
  greedy top-k, ``y = sum w_i E_i(x) + S(x)`` with S the shared experts as
  one MLP;
- the final RMSNorm, then the untied head: ``project_lse`` (the int8 x
  int8 normaliser) and ``cand_dot`` over the chunk's candidate columns, as
  the LSTM's kernel forward uses them.

The program computes MLA absorbed: ``q_nope`` goes through ``W_UK`` into
the ``kv_lora_rank``-wide latent, the scores are ``[q_lat | q_pe] .
[c_kv | k_pe]`` over each row's ancestors' stored latents, and the
latent-space output goes through ``W_UV``; the ancestors come from the
latent path cache (:mod:`jlm_tpu_torch.decoder.path_cache`).  RoPE's
de-interleave is folded into ``W_q``'s and ``W_kv_a``'s rope columns once
(the same values, in the order ``rotate_half`` takes), and its cos/sin
tables are made once.  Departures from the published code: the absorbed
form (the same sums in another order), and the attention scores and the
combine of the routed experts computed in the order this module fixes.
Blocks run in ``compute_dtype`` (bf16 as published, or fp32); the router,
the softmaxes, the RMSNorm statistics and the head's logsumexp in fp32.

``mla_attention`` and ``moe`` are the attention and expert sublayers, and
the step calls them (and ``project_lse``, ``cand_dot``) through this
module's globals, so a wrapper set on the module sees every call.  While the
tracer of :mod:`jlm_tpu_torch.utils.profiling` is on they are the spans
``model.mla`` and ``model.moe``, ``moe`` counts ``moe.rows`` (rows x k a
call) and the path cache the chunk's device counters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from jlm_tpu_torch.decoder.engine import prepare_candidates
from jlm_tpu_torch.decoder.path_cache import LatentPaths, PathRows
from jlm_tpu_torch.ops import moe as moe_ops
from jlm_tpu_torch.ops.cand_dot import cand_dot
from jlm_tpu_torch.ops.project import project_lse
from jlm_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    """The model (the published ``config.json``'s keys; ``rope_scaling``'s
    YaRN settings flattened) and the search's serving settings."""

    family = "deepseek_v2"  # not a field: which path state the engine serves

    vocab_size: int = 102400
    hidden_size: int = 2048
    num_hidden_layers: int = 27
    first_k_dense_replace: int = 1
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_original_max_position: int = 4096

    # --- serving (the engine's fields, as in jlm_tpu_torch.config.Config) ---
    quantize: bool = True
    int8_mxu: bool = True
    beam_width: int = 10
    n_best_max: int = 4
    max_word_len: int = 5
    max_kana_len: int = 62
    max_nodes_per_frame: int = 16
    max_lookahead: int = 64
    t_bucket_multiple: int = 1
    node_overflow: str = "warn"

    @property
    def beam_pad(self) -> int:
        """The beam padded as ``Config.beam_pad`` pads it."""
        return max(8, self.beam_width + (self.beam_width % 2))

    @property
    def moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace

    @property
    def latent_width(self) -> int:
        """Values a word and layer in the path cache: ``c_kv`` and ``k_pe``."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    def replace(self, **kw) -> "DeepseekV2Config":
        return dataclasses.replace(self, **kw)


# ---- YaRN RoPE (DeepseekV2YarnRotaryEmbedding) -----------------------------

def _yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def softmax_scale(config) -> float:
    """``(d_nope + d_rope)^-1/2 m^2``, ``m`` YaRN's ``mscale_all_dim`` factor."""
    m = _yarn_mscale(config.rope_factor, config.rope_mscale_all_dim)
    return (config.qk_nope_head_dim + config.qk_rope_head_dim) ** -0.5 * m * m


def rope_inv_freq(config) -> torch.Tensor:
    """YaRN's ``inv_freq`` [d_rope / 2] (fp32)."""
    dim, base = config.qk_rope_head_dim, config.rope_theta
    factor, orig = config.rope_factor, config.rope_original_max_position

    def correction_dim(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(correction_dim(config.rope_beta_fast)), 0)
    high = min(math.ceil(correction_dim(config.rope_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    inter = extra / factor
    keep = 1.0 - ramp  # 1: the extrapolated (unscaled) frequency
    return inter * (1 - keep) + extra * keep


def rope_tables(config, positions: int, dtype, device):
    """``(cos, sin)`` ``[positions, d_rope]`` of ``[f, f]`` (fp32, times
    YaRN's ``mscale / mscale_all_dim`` factor, then cast to ``dtype`` as
    published)."""
    factor = (_yarn_mscale(config.rope_factor, config.rope_mscale)
              / _yarn_mscale(config.rope_factor, config.rope_mscale_all_dim))
    freqs = torch.arange(positions, dtype=torch.float32)[:, None] * rope_inv_freq(config)
    emb = torch.cat([freqs, freqs], dim=-1)
    return ((emb.cos() * factor).to(dtype).to(device),
            (emb.sin() * factor).to(dtype).to(device))


def deinterleave(d: int) -> torch.Tensor:
    """The column order that turns interleaved pairs into evens then odds:
    folded into ``W_q``'s and ``W_kv_a``'s rope columns once, so the step
    rotates with ``rotate_half`` alone."""
    return torch.cat([torch.arange(0, d, 2), torch.arange(1, d, 2)])


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x cos + rotate_half(x) sin`` over the last axis (``x`` de-interleaved;
    ``cos``, ``sin`` broadcast over the axes between the rows and it)."""
    d = x.shape[-1]
    return x * cos + torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1) * sin


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """``w * (x / rms(x))`` as published: the statistic and the product in
    fp32 (``torch.nn.functional.rms_norm``), rounded to ``x``'s dtype, then
    times ``w``."""
    return w * torch.nn.functional.rms_norm(x, (x.shape[-1],), eps=eps)


# ---- the decode-side weights -----------------------------------------------

def build_decode_params(params: Dict[str, Any], config: DeepseekV2Config,
                        compute_dtype=torch.bfloat16) -> Dict[str, Any]:
    """The step's weights in ``compute_dtype``, made once (``params`` stays
    as given): per layer the MLA weights with ``W_kv_b`` split per head into
    ``W_UK [H, d_nope, c]`` and ``W_UV [H, c, d_v]``, the MLPs' gate and up
    products side by side, the router in fp32; the head as ``project_lse``
    reads it (int8 leaves pass through with their transposed ``"WT"``, a
    zero bias) and ``head_T [V, D]``, the candidate rows ``prepare``
    gathers (dequantized, in ``compute_dtype``)."""
    cd = compute_dtype
    H, dn, dv, c = (config.num_attention_heads, config.qk_nope_head_dim,
                    config.v_head_dim, config.kv_lora_rank)

    def cast(t):
        return t.to(cd).contiguous()

    dr = config.qk_rope_head_dim
    perm = deinterleave(dr)
    q_cols = torch.arange(H * (dn + dr)).reshape(H, dn + dr)
    q_cols = torch.cat([q_cols[:, :dn], q_cols[:, dn:][:, perm]], dim=1).reshape(-1)
    kv_cols = torch.cat([torch.arange(c), c + perm])
    layers = []
    for l, p in enumerate(params["layers"]):
        kv_b = p["kv_b_proj"].reshape(c, H, dn + dv)
        layer = {"attn_norm": cast(p["attn_norm"]),
                 "q_proj": cast(p["q_proj"][:, q_cols.to(p["q_proj"].device)]),
                 "kv_a_proj": cast(p["kv_a_proj"][:, kv_cols.to(p["kv_a_proj"].device)]),
                 "kv_norm": cast(p["kv_norm"]),
                 "W_UK": cast(kv_b[:, :, :dn].permute(1, 2, 0)),
                 "W_UV": cast(kv_b[:, :, dn:].permute(1, 0, 2)),
                 "o_proj": cast(p["o_proj"]), "mlp_norm": cast(p["mlp_norm"])}
        if l < config.first_k_dense_replace:
            m = p["mlp"]
            layer["mlp"] = {"gate_up": cast(torch.cat([m["gate"], m["up"]], dim=1)),
                            "down": cast(m["down"])}
        else:
            m = p["moe"]
            ex, sh = m["experts"], m["shared"]
            layer["moe"] = {"router": m["router"].float().contiguous(),
                            "gate_up": cast(torch.cat([ex["gate"], ex["up"]], dim=2)),
                            "down": cast(ex["down"]),
                            "shared_gate_up": cast(torch.cat([sh["gate"], sh["up"]], dim=1)),
                            "shared_down": cast(sh["down"])}
        layers.append(layer)
    W = params["head"]["W"]
    if isinstance(W, dict):
        dense = W["q"].float() * W["scale"][None, :]
        head_c = {"W": W, "WT": W["q"].t().contiguous()}
    else:
        dense = W
        head_c = {"W": cast(W), "WT": cast(W.t())}
    head_c["b"] = torch.zeros(dense.shape[1], dtype=torch.float32, device=dense.device)
    cos, sin = rope_tables(config, config.max_kana_len + 1, cd, dense.device)
    return {"embed": cast(params["embed"]), "layers": layers, "norm": cast(params["norm"]),
            "head_c": head_c, "head_T": cast(dense.t()), "bias": head_c["b"],
            "cos": cos, "sin": sin}


# ---- the sublayers (module globals: the step calls them through here) ------

def mla_attention(x: torch.Tensor, layer: Dict[str, Any], rows: PathRows, index: int,
                  config: DeepseekV2Config, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """MLA of the normed rows ``x [R, D]`` fed at ``rows.pos``, absorbed:
    the rows' latents go into the path cache at layer ``index``, then each
    row attends over its path's latents.  ``cos``, ``sin`` ``[R, d_rope]``:
    the rows' RoPE at their depths."""
    with profiling.span("model.mla"):
        R = x.shape[0]
        H, dn, c = config.num_attention_heads, config.qk_nope_head_dim, config.kv_lora_rank
        q = (x @ layer["q_proj"]).reshape(R, H, -1)
        kv = x @ layer["kv_a_proj"]  # [R, c + dr]
        c_kv = rms_norm(kv[:, :c], layer["kv_norm"], config.rms_norm_eps)
        rows.write(index, torch.cat([c_kv, rotate(kv[:, c:], cos, sin)], dim=1))
        q_pe = rotate(q[:, :, dn:], cos[:, None, :], sin[:, None, :])
        q_lat = torch.bmm(q[:, :, :dn].transpose(0, 1), layer["W_UK"]).transpose(0, 1)
        q_all = torch.cat([q_lat, q_pe], dim=2)  # [R, H, c + dr]
        lat = rows.gather(index)  # [R, A, c + dr]
        scores = torch.bmm(q_all, lat.transpose(1, 2)).float() * softmax_scale(config)
        scores = scores.masked_fill(rows.masked[:, None, :], float("-inf"))
        p = torch.softmax(scores, dim=-1).to(x.dtype)  # [R, H, A]
        o_lat = torch.bmm(p, lat[:, :, :c])  # [R, H, c]
        o = torch.bmm(o_lat.transpose(0, 1), layer["W_UV"]).transpose(0, 1)  # [R, H, dv]
        return o.reshape(R, -1) @ layer["o_proj"]


def moe(x: torch.Tensor, layer: Dict[str, Any], rows: PathRows, index: int,
        config: DeepseekV2Config) -> torch.Tensor:
    """The expert sublayer of the normed rows ``x [R, D]``: the routed
    experts' weighted sum plus the shared experts.  ``index`` counts the
    MoE layers."""
    with profiling.span("model.moe"):
        k = config.num_experts_per_tok
        w, idx = moe_ops.route(x, layer["router"], k, config.norm_topk_prob,
                               config.routed_scaling_factor)
        profiling.count("moe.rows", x.shape[0] * k)
        rows.count_experts(index, idx, config.n_routed_experts)
        y = moe_ops.experts(x, w, idx, layer["gate_up"], layer["down"])
        return y + moe_ops.mlp(x, layer["shared_gate_up"], layer["shared_down"])


def step_hidden(dec: Dict[str, Any], config: DeepseekV2Config, words: torch.Tensor,
                rows: PathRows) -> torch.Tensor:
    """The final normed hidden rows ``[R, D]`` of ``words [R]`` fed at
    ``rows.pos`` (their latents written to the path cache on the way)."""
    eps = config.rms_norm_eps
    x = dec["embed"][words]
    depth = rows.depth.reshape(-1)
    cos, sin = dec["cos"][depth], dec["sin"][depth]
    for l, layer in enumerate(dec["layers"]):
        x = x + mla_attention(rms_norm(x, layer["attn_norm"], eps), layer, rows, l, config,
                              cos, sin)
        hn = rms_norm(x, layer["mlp_norm"], eps)
        if l < config.first_k_dense_replace:
            x = x + moe_ops.mlp(hn, layer["mlp"]["gate_up"], layer["mlp"]["down"])
        else:
            x = x + moe(hn, layer["moe"], rows, l - config.first_k_dense_replace, config)
    return rms_norm(x, dec["norm"], eps)


def make_forward(config: DeepseekV2Config, compute_dtype=torch.bfloat16,
                 int8_mxu: Optional[bool] = None):
    """The engine's forward for DeepSeek-V2: ``forward(params, words [S, B],
    rows, payload) -> (cand_logp [S, B, C], eos_logp [S, B], rows)``, with
    the hooks ``prepare`` (the candidate columns,
    :func:`~jlm_tpu_torch.decoder.engine.prepare_candidates`), ``build_head``
    (:func:`build_decode_params`) and ``path_state`` (a :class:`LatentPaths`
    a chunk)."""
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"compute_dtype must be bf16 or fp32, not {compute_dtype}")
    if int8_mxu is None:
        int8_mxu = config.int8_mxu

    def forward(params, words, rows, payload):
        S, B = words.shape
        dec = params["_decode"]
        x = step_hidden(dec, config, words.reshape(S * B), rows)
        lse = project_lse(x, dec["head_c"], None, compute_dtype=compute_dtype,
                          int8_mxu=int8_mxu)  # [S*B, 1]
        raw = cand_dot(x.reshape(S, B, -1), payload["cols"], payload["bias"])
        logp = raw - lse.reshape(S, B, 1)
        return logp[:, :, :-1], logp[:, :, -1], rows

    def path_state(params, S, B, T_max, device):
        return LatentPaths(S, B, T_max, config.num_hidden_layers, config.latent_width,
                           compute_dtype, device, config.moe_layers,
                           config.n_routed_experts, counting=profiling.enabled())

    forward.prepare = prepare_candidates
    forward.build_head = build_decode_params
    forward.path_state = path_state
    forward.compute_dtype = compute_dtype
    return forward
