"""Plain PyTorch DeepSeek-V2 word LM: the ``deepseek_v2`` family's reference.

Written from the published layer equations (``modeling_deepseek.py`` of
deepseek-ai/DeepSeek-V2-Lite), independent of the program: per layer ``h =
x + MLA(RMSNorm(x))``, ``x = h + F(RMSNorm(h))`` (F the dense SiLU-gated MLP
in the first ``first_k_dense_replace`` layers, else the MoE), the final
RMSNorm, the untied head and a log-softmax.  MLA without q-LoRA, as
published and not absorbed: ``q = W_q x`` (per head ``[nope | pe]``),
``[c_kv | k_pe] = W_kv_a x``, ``c_kv = RMSNorm(c_kv)``, K and V
decompressed per head from every word's ``c_kv`` (``[k_nope | v] = W_kv_b
c_kv``), ``q_pe`` and ``k_pe`` rotated by YaRN RoPE at each word's
position (interleaved pairs de-interleaved, then ``rotate_half``), the
softmax scale ``192^-1/2 m^2``, the output through ``W_o``.  The MoE: the
gate's fp32 softmax over the experts, the greedy top k, weights not
renormalised (``norm_topk_prob`` false) times ``routed_scaling_factor``,
each expert run over the rows that picked it, plus the shared experts as
one MLP.  Everything in fp32 with TF32 off.

The state is each row's fp32 history: every word's ``c_kv`` and raw
``k_pe`` per layer (``[L, rows, n, c + d_rope]``, slots past a row's depth
unused) and its depth (the words after the root ``<eos>``, the row's
position).  ``select`` gathers whole histories, ``step`` appends the fed
word's and attends over the row's history and itself: no cache tricks.

``operand`` rounds both operands of every product of the blocks (the
control runs the reference one precision lower: e4m3); None keeps fp32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch

from benchmark.reference.precision import Rounding, fp32_products

State = Dict[str, torch.Tensor]  # {"lat": [L, rows, n, c + dr], "depth": [rows]}


def yarn_inv_freq(model: Dict[str, Any]) -> torch.Tensor:
    """``DeepseekV2YarnRotaryEmbedding``'s ``inv_freq`` (fp32)."""
    rs = model["rope_scaling"]
    dim, base = model["qk_rope_head_dim"], float(model["rope_theta"])
    factor, orig = float(rs["factor"]), rs["original_max_position_embeddings"]

    def corr(n_rot):
        return (dim * math.log(orig / (n_rot * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


class RefLM:
    """``params``: the fp32 tree (``embed``, ``layers``, ``norm``, ``head``);
    ``model``: the configuration's ``model`` section (the published keys)."""

    def __init__(self, params: Dict[str, Any], model: Dict[str, Any],
                 operand: Rounding = None):
        fp32_products()
        self.p = params
        self.m = model
        self.rnd = operand or (lambda t: t)
        rs = model["rope_scaling"]
        self.H = model["num_attention_heads"]
        self.dn, self.dr = model["qk_nope_head_dim"], model["qk_rope_head_dim"]
        self.dv, self.c = model["v_head_dim"], model["kv_lora_rank"]
        self.eps = model["rms_norm_eps"]
        self.inv_freq = yarn_inv_freq(model)
        self.cos_factor = (yarn_mscale(rs["factor"], rs["mscale"])
                           / yarn_mscale(rs["factor"], rs["mscale_all_dim"]))
        m = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
        self.scale = (self.dn + self.dr) ** -0.5 * m * m

    def mm(self, x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
        return self.rnd(x) @ self.rnd(W)

    def norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps))

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """``x [..., d]`` at positions ``pos`` (broadcast over x's leading
        dims): de-interleave, then ``x cos + rotate_half(x) sin``."""
        d = x.shape[-1]
        x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
        freqs = pos.float()[..., None] * self.inv_freq.to(x.device)
        emb = torch.cat([freqs, freqs], dim=-1)
        cos, sin = emb.cos() * self.cos_factor, emb.sin() * self.cos_factor
        half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
        return x * cos + half * sin

    def initial_state(self, rows: int, device) -> State:
        L = self.m["num_hidden_layers"]
        return {"lat": torch.zeros((L, rows, 0, self.c + self.dr), device=device),
                "depth": torch.full((rows,), -1, dtype=torch.long, device=device)}

    def select(self, states: Sequence[State], pos: torch.Tensor, rows: torch.Tensor) -> State:
        """The state whose row k is row ``rows[k]`` of ``states[pos[k]]``
        (histories zero-padded to the longest)."""
        L, n = states[0]["lat"].shape[0], max(s["lat"].shape[2] for s in states)
        lat = torch.zeros((L, rows.shape[0], n, self.c + self.dr), device=rows.device)
        depth = torch.zeros(rows.shape[0], dtype=torch.long, device=rows.device)
        for p, s in enumerate(states):
            k = (pos == p).nonzero(as_tuple=True)[0]
            if k.numel():
                lat[:, k, :s["lat"].shape[2]] = s["lat"][:, rows[k]]
                depth[k] = s["depth"][rows[k]]
        return {"lat": lat, "depth": depth}

    def attention(self, x: torch.Tensor, p: Dict[str, Any], hist: torch.Tensor,
                  depth: torch.Tensor) -> torch.Tensor:
        """MLA of normed rows ``x [R, D]`` over ``hist [R, n, c + dr]``
        (slots ``0..depth``: the path's words, this row's last)."""
        R, n = x.shape[0], hist.shape[1]
        H, dn, dr, dv, c = self.H, self.dn, self.dr, self.dv, self.c
        q = self.mm(x, p["q_proj"]).reshape(R, H, dn + dr)
        slots = torch.arange(n, device=x.device)
        kv = self.mm(hist[..., :c], p["kv_b_proj"]).reshape(R, n, H, dn + dv)
        k_pe = self.rope(hist[..., c:], slots[None, :].expand(R, n))  # [R, n, dr]
        k = torch.cat([kv[..., :dn], k_pe[:, :, None, :].expand(R, n, H, dr)], dim=-1)
        q = torch.cat([q[..., :dn], self.rope(q[..., dn:], depth[:, None].expand(R, H))], -1)
        scores = torch.einsum("rhd,rnhd->rhn", self.rnd(q), self.rnd(k)) * self.scale
        scores = scores.masked_fill((slots[None, :] > depth[:, None])[:, None, :],
                                    float("-inf"))
        o = torch.einsum("rhn,rnhd->rhd", self.rnd(torch.softmax(scores, dim=-1)),
                         self.rnd(kv[..., dn:]))
        return self.mm(o.reshape(R, H * dv), p["o_proj"])

    def mlp(self, x: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
        a = torch.nn.functional.silu(self.mm(x, p["gate"])) * self.mm(x, p["up"])
        return self.mm(a, p["down"])

    def moe(self, x: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
        m = self.m
        scores = torch.softmax(x @ p["router"], dim=-1)
        w, idx = torch.topk(scores, m["num_experts_per_tok"], dim=-1)
        if m["norm_topk_prob"]:
            w = w / w.sum(dim=-1, keepdim=True)
        else:
            w = w * m["routed_scaling_factor"]
        ex = p["experts"]
        y = torch.zeros_like(x)
        for e in range(m["n_routed_experts"]):
            rows, pick = (idx == e).nonzero(as_tuple=True)
            if rows.numel():
                part = {k: ex[k][e] for k in ("gate", "up", "down")}
                y[rows] += w[rows, pick][:, None] * self.mlp(x[rows], part)
        return y + self.mlp(x, p["shared"])

    def step(self, words: torch.Tensor, state: State):
        """Feed ``words [R]``: ``(logp [R, V], state with the words appended)``."""
        c = self.c
        depth = state["depth"] + 1
        R = words.shape[0]
        lat = torch.nn.functional.pad(state["lat"], (0, 0, 0, 1))
        x = self.p["embed"][words]
        row = torch.arange(R, device=words.device)
        for l, p in enumerate(self.p["layers"]):
            hn = self.norm(x, p["attn_norm"])
            kv_a = self.mm(hn, p["kv_a_proj"])
            new = torch.cat([self.norm(kv_a[:, :c], p["kv_norm"]), kv_a[:, c:]], dim=1)
            lat[l, row, depth] = new
            x = x + self.attention(hn, p, lat[l], depth)
            hn = self.norm(x, p["mlp_norm"])
            x = x + (self.mlp(hn, p["mlp"]) if "mlp" in p else self.moe(hn, p["moe"]))
        x = self.norm(x, self.p["norm"])
        logits = x @ self.p["head"]["W"]
        return torch.log_softmax(logits, dim=-1), {"lat": lat, "depth": depth}
