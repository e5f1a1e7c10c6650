"""K1's share of its roofline at latent attention's head dims, in %: the
least time its launches could take (``mla_counts.attention_bound_s``:
2·B·Hq·(Dqk + Dv) a kept pair at the bf16 peak, or q and k at Dqk and v
and o at Dv moved once, one launch a layer a request at the request's
shape) over the summed device time of ``flash_fwd``."""

LAYER = "Attention kernel K1"
UNIT = "%"
MOVES = "prefill_tokens_per_s"
SOURCE = "device_trace"

from portbench import kinds, mla_counts  # noqa: E402
from portbench.mla_config import mla_shape  # noqa: E402


def read(w):
    m = mla_shape(w.cell.config)
    t = w.trace
    spent = sum(sum(t.durations(kinds.K1, d)) for d in t.devices)
    if spent == 0:
        return None
    bound = sum(m.layers * mla_counts.attention_bound_s(m, u["b"], u["t"])
                for u in w.units)
    return 100 * bound / spent
