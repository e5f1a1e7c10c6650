"""K1's share of its roofline, in %: the least time its launches could
take (``counts.attention_bound_s``, one launch a layer a request at the
request's shape) over its summed device time."""

LAYER = "Attention kernel K1"
UNIT = "%"
MOVES = "prefill_tokens_per_s"
SOURCE = "device_trace"

from portbench import counts, kinds  # noqa: E402
from portbench.model_config import model_shape  # noqa: E402


def read(w):
    m = model_shape(w.cell.config)
    t = w.trace
    spent = sum(sum(t.durations(kinds.K1, d)) for d in t.devices)
    if spent == 0:
        return None
    bound = sum(m.layers * counts.attention_bound_s(
        u["b"], u["t"], m.heads, m.kv_heads, m.head_dim) for u in w.units)
    return 100 * bound / spent
