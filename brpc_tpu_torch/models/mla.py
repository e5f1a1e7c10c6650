"""Multi-head latent attention (MLA), the attention of DeepSeek-V2's block,
which ``models.llama`` runs in place of grouped-query attention for a
config with ``kv_lora_rank`` > 0.

On the normed rows y of a layer, as DeepSeek-V2's Hugging Face code
(``DeepseekV2Attention``, no query latent) writes it:

- ``q = y @ wq``, ``[B,T,H,Dn + Dr]``: a non-rope part of ``Dn``
  (``qk_nope_head_dim``) and a rope part of ``Dr`` (``qk_rope_head_dim``);
- ``[c, k_pe] = y @ w_kva``, the latent c of ``kv_lora_rank`` and one
  rope key of ``Dr`` that every head shares; ``c`` is RMS-normed
  (``kv_norm``) and expanded, ``[k_nope, v] = c @ w_kvb``, ``[B,T,H,Dn +
  Dv]``;
- rope on ``q_pe`` and ``k_pe`` alone, with YaRN's frequencies where the
  config has ``rope_scaling`` (``Yarn``);
- ``softmax(q·kᵀ·s + causal)·v`` with ``q = [q_nope, q_pe]``, ``k =
  [k_nope, k_pe]`` and ``s = softmax_scale(cfg)``, by the caller's
  ``attend`` (K1 at q/k head dim 192 and v head dim 128 when serving).

The published code de-interleaves each rope part's pairs
(``x.view(..., d/2, 2).transpose``) and then rotates halves. Rotating the
pairs where they lie (``rope_pairs``) gives the same rotated values with
the de-interleave undone, the same permutation on q's and on k's rope
dims, which leaves every score ``q·k`` as it is: the published layout with
the permutation folded into ``wq``'s and ``w_kva``'s rope columns, and no
copy.

While the program is traced, each call records the marked span
``mla.latent`` around the projections, the latent norm, the expansion
and the rope, counting ``rows`` (B·T).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from brpc_tpu_torch.models.norm import rms_norm
from brpc_tpu_torch.obs import rpcz

#: The counter of an ``mla.latent`` span: the rows (B·T) it projected.
ROWS_COUNTER = "rows"


@dataclasses.dataclass(frozen=True)
class Yarn:
    """YaRN's rope scaling (``rope_scaling`` with ``type: yarn``)."""
    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


def correction_range(yarn: Yarn, dim: int, base: float) -> tuple:
    """YaRN's (low, high) rope pair indices (``yarn_find_correction_range``):
    pairs below low keep their frequency, pairs above high are
    interpolated by ``factor``, a linear ramp between."""

    def at(rotations):
        return dim * math.log(yarn.original_max_position_embeddings
                              / (rotations * 2 * math.pi)) \
            / (2 * math.log(base))

    low = math.floor(at(yarn.beta_fast))
    high = math.ceil(at(yarn.beta_slow))
    return max(low, 0), min(high, dim - 1)


def get_mscale(scale: float, mscale: float = 1.0) -> float:
    """YaRN's attention scale (``yarn_get_mscale``)."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def softmax_scale(cfg) -> float:
    """The scores' scale: ``(Dn + Dr)**-0.5``, times YaRN's
    ``get_mscale(factor, mscale_all_dim)`` squared where it is given."""
    s = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    yarn = cfg.rope_scaling
    if yarn is not None and yarn.mscale_all_dim:
        m = get_mscale(yarn.factor, yarn.mscale_all_dim)
        s = s * m * m
    return s


def cos_sin_scale(cfg) -> float:
    """The factor on YaRN's cos and sin: ``get_mscale(factor, mscale) /
    get_mscale(factor, mscale_all_dim)``; 1 without YaRN."""
    yarn = cfg.rope_scaling
    if yarn is None:
        return 1.0
    return get_mscale(yarn.factor, yarn.mscale) \
        / get_mscale(yarn.factor, yarn.mscale_all_dim)


def inv_freq(cfg, device) -> torch.Tensor:
    """The rope pairs' frequencies [Dr/2], f32, as
    ``DeepseekV2YarnRotaryEmbedding`` computes them: ``theta^(-2i/Dr)``,
    and with YaRN that over ``factor`` past the correction range, a linear
    ramp between."""
    d = cfg.qk_rope_head_dim
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    extra = 1.0 / (cfg.rope_theta ** exps)
    yarn = cfg.rope_scaling
    if yarn is None:
        return extra
    inter = 1.0 / (yarn.factor * cfg.rope_theta ** exps)
    low, high = correction_range(yarn, d, cfg.rope_theta)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def rope_pairs(x: torch.Tensor, positions: torch.Tensor, freqs: torch.Tensor,
               mscale: float = 1.0) -> torch.Tensor:
    """x [B,T,H,D] with each pair (x[2i], x[2i+1]) rotated by
    ``positions · freqs[i]`` where it lies, in f32, cos and sin times
    ``mscale``; positions [B,T]."""
    angles = positions[..., None].float() * freqs            # [B,T,D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    x1, x2 = x.float().unflatten(-1, (-1, 2)).unbind(-1)
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.flatten(-2).to(x.dtype)


def layer_shapes(cfg) -> dict:
    """One layer's attention leaves: ``wq`` [h, H·(Dn+Dr)], ``w_kva`` [h,
    r + Dr], ``kv_norm`` [r], ``w_kvb`` [r, H·(Dn+Dv)], ``wo`` [H·Dv, h]."""
    h, heads, r = cfg.hidden, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {"wq": (h, heads * (dn + dr)), "w_kva": (h, r + dr),
            "kv_norm": (r,), "w_kvb": (r, heads * (dn + dv)),
            "wo": (heads * dv, h)}


def attention(cfg, y: torch.Tensor, lp: dict, positions: torch.Tensor,
              attend: Callable) -> torch.Tensor:
    """The attention of the rows y [B,T,h] before ``wo``, [B,T,H·Dv]:
    ``attend(q, k, v, scale=softmax_scale(cfg))`` on the latent
    projections."""
    b, t, _ = y.shape
    heads, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    with rpcz.trace("mla", "latent", mark=y) as sp:
        q = (y @ lp["wq"]).view(b, t, heads, dn + dr)
        kva = y @ lp["w_kva"]
        c = rms_norm(kva[..., :r], lp["kv_norm"], cfg.norm_eps)
        kv = (c @ lp["w_kvb"]).view(b, t, heads, -1)
        freqs, mscale = inv_freq(cfg, y.device), cos_sin_scale(cfg)
        q_pe = rope_pairs(q[..., dn:], positions, freqs, mscale)
        k_pe = rope_pairs(kva[:, :, None, r:], positions, freqs, mscale)
        q = torch.cat([q[..., :dn], q_pe], dim=-1)
        k = torch.cat([kv[..., :dn], k_pe.expand(b, t, heads, dr)], dim=-1)
        v = kv[..., dn:].contiguous()
        if sp is not None:
            sp.count(ROWS_COUNTER, b * t)
    return attend(q, k, v, scale=softmax_scale(cfg))
