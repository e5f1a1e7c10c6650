"""The optimizer's share of its roofline, in %: 28 B a parameter a step at
the HBM rate (``counts.adamw_bound_s``) over the device time of the
optimizer's kernels."""

LAYER = "Optimizer"
UNIT = "%"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"

from portbench import counts, kinds  # noqa: E402
from portbench.model_config import model_shape  # noqa: E402


def read(w):
    t = w.trace
    spent = sum((end - start) / 1e9 for _, name, start, end in t.kernels
                if kinds.kind(name) == "optimizer")
    if spent == 0:
        return None
    params = counts.n_params(model_shape(w.cell.config))
    return 100 * len(w.units) * counts.adamw_bound_s(params) / spent
