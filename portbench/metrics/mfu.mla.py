"""Active-parameter model FLOPs of the window's requests over its seconds
and the card's bf16 peak, in %: 2 a product weight a token over the
latent attention's products, the dense layers' MLP, the router, the
token's k routed experts, the shared experts and the LM head, and
2·Hq·(Dqk + Dv) a kept (query, key) pair a layer
(``mla_counts.prefill_flops``)."""

LAYER = "Model step"
UNIT = "%"
MOVES = "prefill_tokens_per_s"
SOURCE = "host_clock"

from portbench import counts, mla_counts  # noqa: E402
from portbench.mla_config import mla_shape  # noqa: E402


def read(w):
    m = mla_shape(w.cell.config)
    flops = sum(mla_counts.prefill_flops(m, u["b"], u["t"]) for u in w.units)
    return 100 * flops / (w.window_s * counts.PEAK_BF16_FLOPS)
