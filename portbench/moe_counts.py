"""The frozen counts of an expert model (``moe_config.MoeShape``): its
parameters, the active-parameter model FLOPs of a request and the least
time its expert products can take, from shapes alone, at the peaks of
``counts``."""

from __future__ import annotations

from portbench import counts
from portbench.moe_config import MoeShape

BF16_BYTES = 2


def expert_weights(m: MoeShape) -> int:
    """One expert's gate, up and down products."""
    return 3 * m.hidden * m.intermediate


def attention_weights(m: MoeShape) -> int:
    """One layer's Q, K, V and O products."""
    return m.hidden * (m.q_out + 2 * m.kv_out) + m.q_out * m.hidden


def layer_params(m: MoeShape) -> int:
    """One layer: attention, the router, every expert and the two norms."""
    return attention_weights(m) + m.hidden * m.experts \
        + m.experts * expert_weights(m) + 2 * m.hidden


def n_params(m: MoeShape) -> int:
    """Every parameter: the layers, the embedding, the final norm and the
    LM head."""
    return m.layers * layer_params(m) + 2 * m.vocab * m.hidden + m.hidden


def active_layer_weights(m: MoeShape) -> int:
    """Product weights one token meets in a layer: attention, the router
    and its ``per_token`` experts."""
    return attention_weights(m) + m.hidden * m.experts \
        + m.per_token * expert_weights(m)


def prefill_flops(m: MoeShape, b: int, t: int) -> int:
    """2 FLOPs an active product weight a token (every layer's and the LM
    head's), and 4·Hq·D a kept (query, key) pair a layer."""
    weights = m.layers * active_layer_weights(m) + m.hidden * m.vocab
    return 2 * weights * b * t \
        + 4 * m.q_out * counts.kept_pairs(t) * b * m.layers


def experts_bound_s(m: MoeShape, pairs: int, held: int) -> float:
    """The least time one layer's expert products can take for ``pairs``
    (token, expert) pairs over ``held`` experts: 2 FLOPs a weight a pair
    at the bf16 peak, or the bf16 weights of the experts the pairs can
    reach (at most one an expert a pair) read once at the HBM rate,
    whichever is longer."""
    ops = 2 * pairs * expert_weights(m)
    nbytes = min(held, pairs) * expert_weights(m) * BF16_BYTES
    return max(ops / counts.PEAK_BF16_FLOPS, nbytes / counts.HBM_BYTES_PER_S)
