"""Active-parameter model FLOPs of the window's requests over its seconds
and the card's bf16 peak, in %: 2 a product weight a token over the
attention's products, the router, the token's k experts and the LM head,
and 4·Hq·D a kept (query, key) pair a layer
(``moe_counts.prefill_flops``)."""

LAYER = "Model step"
UNIT = "%"
MOVES = "prefill_tokens_per_s"
SOURCE = "host_clock"

from portbench import counts, moe_counts  # noqa: E402
from portbench.moe_config import moe_shape  # noqa: E402


def read(w):
    m = moe_shape(w.cell.config)
    flops = sum(moe_counts.prefill_flops(m, u["b"], u["t"]) for u in w.units)
    return 100 * flops / (w.window_s * counts.PEAK_BF16_FLOPS)
