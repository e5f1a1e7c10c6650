"""The frozen counts of a DeepSeek-V2 model (``mla_config.MlaShape``): its
parameters, the active-parameter model FLOPs of a request, and the least
time K1 and the expert products can take, from shapes alone, at the peaks
of ``counts``."""

from __future__ import annotations

from portbench import counts
from portbench.mla_config import MlaShape

BF16_BYTES = 2


def attention_weights(m: MlaShape) -> int:
    """One layer's ``W_q``, ``W_kva``, ``W_kvb`` and ``W_o``."""
    h, heads, r = m.hidden, m.heads, m.kv_lora_rank
    return h * heads * m.qk_head + h * (r + m.qk_rope) \
        + r * heads * (m.qk_nope + m.v_head) + heads * m.v_head * h


def expert_weights(m: MlaShape, width: int) -> int:
    """One SwiGLU's gate, up and down products at ``width``."""
    return 3 * m.hidden * width


def n_params(m: MlaShape) -> int:
    """Every parameter: attention, norms, the dense layers' MLP, routers,
    routed and shared experts, the embedding, the final norm and the
    head."""
    h = m.hidden
    per_layer = attention_weights(m) + m.kv_lora_rank + 2 * h
    expert_layer = h * m.experts \
        + m.experts * expert_weights(m, m.expert_intermediate) \
        + expert_weights(m, m.shared_intermediate)
    return m.layers * per_layer \
        + m.dense_layers * expert_weights(m, m.intermediate) \
        + m.expert_layers * expert_layer + 2 * m.vocab * h + h


def active_weights(m: MlaShape) -> int:
    """Product weights one token meets: every layer's attention, the dense
    layers' MLP, each expert layer's router, its ``per_token`` routed
    experts and the shared experts, and the LM head."""
    expert_layer = m.hidden * m.experts \
        + m.per_token * expert_weights(m, m.expert_intermediate) \
        + expert_weights(m, m.shared_intermediate)
    return m.layers * attention_weights(m) \
        + m.dense_layers * expert_weights(m, m.intermediate) \
        + m.expert_layers * expert_layer + m.hidden * m.vocab


def attention_flops(m: MlaShape, b: int, t: int) -> int:
    """One layer's causal attention: 2·Hq·(Dqk + Dv) a kept pair."""
    return 2 * b * m.heads * (m.qk_head + m.v_head) * counts.kept_pairs(t)


def prefill_flops(m: MlaShape, b: int, t: int) -> int:
    """2 FLOPs an active product weight a token, and every layer's
    attention."""
    return 2 * active_weights(m) * b * t + m.layers * attention_flops(m, b, t)


def attention_bound_s(m: MlaShape, b: int, t: int) -> float:
    """The least time one layer's K1 launch can take: its operations at
    the bf16 peak, or q and k (Dqk) and v and o (Dv) moved once at the HBM
    rate, whichever is longer."""
    nbytes = 2 * b * t * m.heads * (m.qk_head + m.v_head) * BF16_BYTES
    return max(attention_flops(m, b, t) / counts.PEAK_BF16_FLOPS,
               nbytes / counts.HBM_BYTES_PER_S)


def experts_bound_s(m: MlaShape, pairs: int, held: int,
                    shared_rows: int) -> float:
    """The least time one expert layer's products can take for ``pairs``
    (token, expert) pairs over ``held`` routed experts and ``shared_rows``
    rows of the shared experts: 2 FLOPs a weight a pair or row at the
    bf16 peak, or the bf16 weights the pairs can reach (at most one expert
    a pair) and the shared experts' read once at the HBM rate, whichever is
    longer."""
    routed = expert_weights(m, m.expert_intermediate)
    shared = expert_weights(m, m.shared_intermediate)
    ops = 2 * (pairs * routed + shared_rows * shared)
    nbytes = (min(held, pairs) * routed + (shared if shared_rows else 0)) \
        * BF16_BYTES
    return max(ops / counts.PEAK_BF16_FLOPS, nbytes / counts.HBM_BYTES_PER_S)
