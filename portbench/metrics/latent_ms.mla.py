"""Device-busy ms a request inside the program's ``mla.latent`` spans: the
latent attention's projections, latent norm, expansion and rope, by the
union of the operations that belong to each span, a layer's average
times the layers."""

LAYER = "Model step"
UNIT = "ms"
MOVES = "prefill_tokens_per_s"
SOURCE = "program_span"

from portbench import program_spans  # noqa: E402
from portbench.mla_config import mla_shape  # noqa: E402


def read(w):
    per_span = program_spans.busy_ms_per_span(w, "mla.latent")
    if per_span is None:
        return None
    return mla_shape(w.cell.config).layers * per_span
