"""Model FLOPs of the window's requests over its seconds and the card's
bf16 peak, in %: 2 a matmul weight a token (the LM head's too) and
4·Hq·D a kept (query, key) pair a layer (``counts.prefill_flops``)."""

LAYER = "Model step"
UNIT = "%"
MOVES = "prefill_tokens_per_s"
SOURCE = "host_clock"

from portbench import counts  # noqa: E402
from portbench.model_config import model_shape  # noqa: E402


def read(w):
    m = model_shape(w.cell.config)
    flops = sum(counts.prefill_flops(m, u["b"], u["t"]) for u in w.units)
    return 100 * flops / (w.window_s * counts.PEAK_BF16_FLOPS)
