"""Model FLOPs of the window's steps over its seconds and the card's bf16
peak, in %: 6 a matmul weight a token and 12·Hq·D a kept (query, key)
pair a layer (``counts.train_flops``), whatever computes them."""

LAYER = "Model step"
UNIT = "%"
MOVES = "train_tokens_per_s"
SOURCE = "host_clock"

from portbench import counts  # noqa: E402
from portbench.model_config import model_shape  # noqa: E402


def read(w):
    m = model_shape(w.cell.config)
    flops = sum(counts.train_flops(m, u["b"], u["t"]) for u in w.units)
    return 100 * flops / (w.window_s * counts.PEAK_BF16_FLOPS)
