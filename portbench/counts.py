"""The benchmark's frozen counts: model FLOPs, kernel bounds and the peaks.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, at the 700 W limit);
a share is stated against them with the card's power limit beside it.
Operations and bytes come from the shapes of the work alone, never from
the program, so that a change to the program cannot move the yardstick.
"""

from __future__ import annotations

from portbench.model_config import ModelShape

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 450e9  # to the other cards, each way
# AdamW reads the param, its gradient and both moments and writes the param
# and both moments, all f32.
ADAMW_BYTES_PER_PARAM = 28
F32_BYTES = 4


def layer_matmul_weights(m: ModelShape) -> int:
    """Weights of one decoder layer's products: Q, K, V, O and the MLP's
    three."""
    h = m.hidden
    return h * (m.q_out + 2 * m.kv_out) + m.q_out * h \
        + 3 * h * m.intermediate


def matmul_weights(m: ModelShape) -> int:
    """Weights a token meets in products: every layer's and the LM head's.
    The embedding is a gather and counts nothing."""
    return m.layers * layer_matmul_weights(m) + m.hidden * m.vocab


def n_params(m: ModelShape) -> int:
    """Every parameter: products, embedding and norms."""
    return matmul_weights(m) + m.vocab * m.hidden \
        + (2 * m.layers + 1) * m.hidden


def kept_pairs(t: int) -> int:
    """(query, key) pairs a causal mask keeps in a sequence of t."""
    return t * (t + 1) // 2


def prefill_flops(m: ModelShape, b: int, t: int) -> int:
    """2 FLOPs a matmul weight a token, and 4·Hq·D a kept pair a layer."""
    return 2 * matmul_weights(m) * b * t \
        + 4 * m.q_out * kept_pairs(t) * b * m.layers


def train_flops(m: ModelShape, b: int, t: int) -> int:
    """6 FLOPs a matmul weight a token (forward 2, backward 4), and
    12·Hq·D a kept pair a layer: counted over the pairs the mask keeps,
    whatever computes them."""
    return 6 * matmul_weights(m) * b * t \
        + 12 * m.q_out * kept_pairs(t) * b * m.layers


def attention_bound_s(b: int, t: int, heads: int, kv_heads: int,
                      head_dim: int, itemsize: int = 2) -> float:
    """The least time one causal attention launch can take: its kept
    pairs' 4·B·Hq·D operations at the bf16 peak, or q, k, v and o moved
    once at the HBM rate, whichever is longer."""
    ops = 4 * b * heads * head_dim * kept_pairs(t)
    nbytes = (2 * b * t * heads * head_dim
              + 2 * b * t * kv_heads * head_dim) * itemsize
    return max(ops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def adamw_bound_s(params: int) -> float:
    """The least time one AdamW step over ``params`` f32 params can take."""
    return ADAMW_BYTES_PER_PARAM * params / HBM_BYTES_PER_S


def all_reduce_bound_s(n: int, replicas: int) -> float:
    """The least time an all-reduce of n f32 over ``replicas`` cards can
    take on the slowest card: its input read and its output written once
    at the HBM rate, or the least a card must receive, 2·(R-1)/R of the
    vector, at the NVLink rate, whichever is longer."""
    hbm = 2 * F32_BYTES * n
    link = 2 * (replicas - 1) / replicas * F32_BYTES * n
    return max(hbm / HBM_BYTES_PER_S, link / NVLINK_BYTES_PER_S)


def buckets(n: int, bucket: int) -> list:
    """``[begin, end)`` of each bucket of ``bucket`` floats over ``[0, n)``,
    the rest in a last, shorter one."""
    return [(b, min(b + bucket, n)) for b in range(0, n, bucket)]
