"""K1's share of its roofline in training, in %: the attention part of the
window's model FLOPs (``counts.train_flops``' 12·Hq·D a kept pair a layer:
the forward's two products and the backward's four) at the bf16 peak,
over the summed device time of the kernels named ``flash_fwd`` or
``flash_bwd``. It counts model FLOPs, not what the kernels recompute. A
program whose train step launches no such kernel gives None."""

LAYER = "Attention kernel K1"
UNIT = "%"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"

import re  # noqa: E402

from portbench import counts  # noqa: E402
from portbench.model_config import model_shape  # noqa: E402

K1_TRAIN = re.compile(r"flash_(fwd|bwd)")


def read(w):
    m = model_shape(w.cell.config)
    t = w.trace
    spent = sum(sum(t.durations(K1_TRAIN, d)) for d in t.devices)
    if spent == 0:
        return None
    flops = sum(12 * m.q_out * counts.kept_pairs(u["t"]) * u["b"] * m.layers
                for u in w.units)
    return 100 * flops / counts.PEAK_BF16_FLOPS / spent
