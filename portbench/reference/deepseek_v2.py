"""DeepSeek-V2's layer equations in plain float32 PyTorch, one sequence at
a time.

As DeepSeek-V2-Lite and its Hugging Face code (``modeling_deepseek.py``:
``DeepseekV2Attention`` without a query latent,
``DeepseekV2YarnRotaryEmbedding``, ``MoEGate`` and ``DeepseekV2MoE``)
define them, on the normed rows y of a layer (RMSNorm ``x * rsqrt(mean(x²)
+ eps) * w``):

- ``q = y @ wq`` [T, H, Dn + Dr], split into ``q_nope`` and ``q_pe``;
  ``[c, k_pe] = y @ w_kva``, ``c`` RMS-normed (``kv_norm``) and expanded,
  ``[k_nope, v] = c @ w_kvb`` [T, H, Dn + Dv]; ``k_pe`` is one head,
  broadcast to all;
- rope on ``q_pe`` and ``k_pe`` only: each pair ``(x[2i], x[2i+1])``
  de-interleaved (``view(..., d/2, 2).transpose``), then halves rotated,
  with YaRN's frequencies (``f_inter·(1 − m) + f_extra·m``, ``m`` one less
  a linear ramp over the correction range) and cos and sin times
  ``mscale(factor, mscale) / mscale(factor, mscale_all_dim)``;
- causal attention of ``[q_nope, q_pe]`` over ``[k_nope, k_pe]``, scaled
  by ``(Dn + Dr)^-1/2 · mscale(factor, mscale_all_dim)²``, the output
  [T, H·Dv] times ``wo``;
- layers below ``first_k_dense_replace``: ``down(silu(gate(y)) * up(y))``;
  the others: the f32 softmax of the router's logits ``y @ w_router``
  [E], its k most probable experts with their probabilities (not
  renormalised where ``norm_topk_prob`` is false; ``routed_scaling_factor``
  is 1, the only value ``mla_shape`` admits), Σ pᵢ ·
  ``down_i(silu(gate_i(y)) * up_i(y))`` over them, plus the shared
  experts' SwiGLU over every row;
- a final RMSNorm and an untied LM head. Weights are ``[in, out]``,
  experts stacked ``[E, in, out]``.

Departures, none in the equations: ties between probabilities go to the
lower expert index (a stable sort; HF's ``topk(sorted=False)`` promises
no order); each expert runs on the rows routed to it, gathered, and its
terms are added back in expert order; attention is computed in blocks of
queries and the dense MLP in blocks of rows, which changes no value
beyond the order of float32 sums.

``logits_at`` runs many sequences layer by layer, so that one layer's
float32 weights are made and held at a time. Its keyword arguments plant
what the benchmark's controls need: ``precision="fp8"`` rounds every
product's operands (the router's too) to float8 e4m3; ``k`` other than
the model's routes to fewer experts; ``yarn=False`` rotates with the
plain frequencies ``theta^(-2i/Dr)``; ``mscale=False`` scales the scores
by ``(Dn + Dr)^-1/2`` alone; ``shared=False`` leaves the shared experts
out.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.nn import functional as F

from portbench.reference.llama import MLP_BLOCK_ROWS, SCORE_BLOCK_BYTES, \
    full_f32, mm, rms_norm


def yarn_find_correction_dim(rotations: float, dim: int, base: float,
                             max_positions: float) -> float:
    return dim * math.log(max_positions / (rotations * 2 * math.pi)) \
        / (2 * math.log(base))


def yarn_find_correction_range(low_rot: float, high_rot: float, dim: int,
                               base: float, max_positions: float) -> tuple:
    low = math.floor(yarn_find_correction_dim(low_rot, dim, base,
                                              max_positions))
    high = math.ceil(yarn_find_correction_dim(high_rot, dim, base,
                                              max_positions))
    return max(low, 0), min(high, dim - 1)


def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_linear_ramp_mask(low: float, high: float, dim: int,
                          device) -> torch.Tensor:
    if low == high:
        high += 0.001
    ramp = (torch.arange(dim, dtype=torch.float32, device=device) - low) \
        / (high - low)
    return torch.clamp(ramp, 0, 1)


def softmax_scale(m, mscale: bool = True) -> float:
    """The scores' scale: ``(Dn + Dr)^-1/2``, times YaRN's
    ``mscale(factor, mscale_all_dim)²`` where the model has YaRN."""
    scale = m.qk_head ** -0.5
    yarn = m.yarn_args()
    if mscale and yarn is not None and yarn["mscale_all_dim"]:
        s = yarn_get_mscale(yarn["factor"], yarn["mscale_all_dim"])
        scale = scale * s * s
    return scale


def rotary(m, t: int, device, yarn: bool = True) -> tuple:
    """(cos, sin) [T, Dr] at positions 0..T-1, as
    ``DeepseekV2YarnRotaryEmbedding`` caches them (``yarn=False``: the
    plain frequencies, no YaRN)."""
    dim, base = m.qk_rope, m.rope_theta
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / (base ** exps)
    args = m.yarn_args() if yarn else None
    factor = 1.0
    if args is None:
        inv_freq = freq_extra
    else:
        factor = args["factor"]
        freq_inter = 1.0 / (factor * base ** exps)
        low, high = yarn_find_correction_range(
            args["beta_fast"], args["beta_slow"], dim, base,
            args["original_max_position_embeddings"])
        mask = 1.0 - yarn_linear_ramp_mask(low, high, dim // 2, device)
        inv_freq = freq_inter * (1 - mask) + freq_extra * mask
    freqs = torch.outer(torch.arange(t, dtype=torch.float32, device=device),
                        inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    scale = 1.0 if args is None else \
        yarn_get_mscale(factor, args["mscale"]) \
        / yarn_get_mscale(factor, args["mscale_all_dim"])
    return emb.cos() * scale, emb.sin() * scale


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x[..., :x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x [T, H, Dr]: pairs de-interleaved, then halves rotated."""
    t, h, d = x.shape
    x = x.view(t, h, d // 2, 2).transpose(3, 2).reshape(t, h, d)
    return x * cos[:, None, :] + rotate_half(x) * sin[:, None, :]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q0: int,
              scale: float) -> torch.Tensor:
    """Causal attention of queries at positions q0.. over keys 0..;
    q [Tq, H, D], k [Tk, H, D], v [Tk, H, Dv] -> [Tq, H*Dv]."""
    tq, h, _ = q.shape
    tk = k.shape[0]
    scores = (q.permute(1, 0, 2) @ k.permute(1, 2, 0)) * scale  # [H,Tq,Tk]
    rows = torch.arange(q0, q0 + tq, device=q.device)[:, None]
    cols = torch.arange(tk, device=q.device)[None, :]
    scores = scores.masked_fill(cols > rows, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ v.permute(1, 0, 2)   # [H,Tq,Dv]
    return out.permute(1, 0, 2).reshape(tq, h * v.shape[-1])


def swiglu(y: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
           down: torch.Tensor, precision: str) -> torch.Tensor:
    return mm(F.silu(mm(y, gate, precision)) * mm(y, up, precision), down,
              precision)


def route(y: torch.Tensor, w_router: torch.Tensor, m, k: int,
          precision: str = "f32") -> tuple:
    """(weights [T, k], experts [T, k]) of the rows y [T, h]."""
    probs = torch.softmax(mm(y, w_router, precision), dim=-1)
    top, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, experts = top[:, :k], experts[:, :k]
    if m.norm_topk_prob:
        top = top / (top.sum(dim=-1, keepdim=True) + 1e-20)
    return top, experts


def experts_block(y: torch.Tensor, lw: dict, m, k: int,
                  precision: str = "f32", shared: bool = True) -> tuple:
    """(the expert layer's output [T, h], the experts chosen [T, k])."""
    weights, experts = route(y, lw["w_router"], m, k, precision)
    out = torch.zeros_like(y)
    for e in range(lw["w_router"].shape[1]):
        rows, slot = torch.nonzero(experts == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        out.index_add_(0, rows, swiglu(y[rows], lw["w_gate"][e],
                                       lw["w_up"][e], lw["w_down"][e],
                                       precision)
                       * weights[rows, slot, None])
    if shared:
        out = out + swiglu(y, lw["shared_gate"], lw["shared_up"],
                           lw["shared_down"], precision)
    return out, experts


def layer(x: torch.Tensor, lw: dict, m, i: int, k: int | None = None,
          precision: str = "f32", yarn: bool = True, mscale: bool = True,
          shared: bool = True) -> tuple:
    """Decoder layer i over a whole sequence x [T, h]: (its output, the
    experts each row chose, None in a dense layer)."""
    t = x.shape[0]
    h, dn, dr, r = m.heads, m.qk_nope, m.qk_rope, m.kv_lora_rank
    y = rms_norm(x, lw["attn_norm"], m.norm_eps)
    q = mm(y, lw["wq"], precision).view(t, h, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    kva = mm(y, lw["w_kva"], precision)
    c, k_pe = kva[:, :r], kva[:, r:]
    kv = mm(rms_norm(c, lw["kv_norm"], m.norm_eps), lw["w_kvb"],
            precision).view(t, h, dn + m.v_head)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    cos, sin = rotary(m, t, x.device, yarn)
    q = torch.cat([q_nope, apply_rotary(q_pe, cos, sin)], dim=-1)
    keys = torch.cat([k_nope, apply_rotary(k_pe[:, None, :], cos, sin)
                      .expand(t, h, dr)], dim=-1)
    del y, kva, kv, q_pe, q_nope, k_nope
    scale = softmax_scale(m, mscale)
    block = max(1, min(t, SCORE_BLOCK_BYTES // (4 * h * t)))
    attn = torch.cat([attention(q[q0:q0 + block], keys[:q0 + block],
                                v[:q0 + block], q0, scale)
                      for q0 in range(0, t, block)])
    del q, keys, v
    x = x + mm(attn, lw["wo"], precision)
    del attn
    y = rms_norm(x, lw["mlp_norm"], m.norm_eps)
    if i < m.dense_layers:
        out = torch.cat([swiglu(y[r0:r0 + MLP_BLOCK_ROWS], lw["mlp_gate"],
                                lw["mlp_up"], lw["mlp_down"], precision)
                         for r0 in range(0, t, MLP_BLOCK_ROWS)])
        return x + out, None
    out, experts = experts_block(y, lw, m, m.per_token if k is None else k,
                                 precision, shared)
    return x + out, experts


def logits_at(m, top: dict, layer_weights: Callable[[int], dict],
              sequences: list, variants: tuple = ({},)) -> list:
    """For each variant (keyword arguments of ``layer``), the logits
    [len(positions), vocab] of each sequence ``(tokens [T], positions)``
    at its positions, and the experts each expert layer chose there
    [expert layers, len(positions), k]: a list, a variant, of (logits,
    experts) lists.

    ``top`` holds the f32 ``embed``, ``final_norm`` and ``lm_head``;
    ``layer_weights(i)`` makes layer i's f32 weights, once: every sequence
    of every variant passes through a layer before the next is made."""
    with torch.no_grad(), full_f32():
        states = [[top["embed"][tokens] for tokens, _ in sequences]
                  for _ in variants]
        chosen = [[[] for _ in sequences] for _ in variants]
        for i in range(m.layers):
            lw = layer_weights(i)
            for v, kw in enumerate(variants):
                for s, (_, positions) in enumerate(sequences):
                    states[v][s], experts = layer(states[v][s], lw, m, i,
                                                  **kw)
                    if experts is not None:
                        chosen[v][s].append(experts[positions])
            del lw
        out = []
        for v, kw in enumerate(variants):
            precision = kw.get("precision", "f32")
            logits = [mm(rms_norm(x[positions], top["final_norm"],
                                  m.norm_eps), top["lm_head"], precision)
                      for x, (_, positions) in zip(states[v], sequences)]
            out.append([(got, torch.stack(c)) for got, c
                        in zip(logits, chosen[v])])
        return out
