"""Device-busy ms a request inside the program's ``moe.route`` and
``moe.combine`` spans: the routing, the sort by expert, the gather of the
rows and their offsets, and the weighted combine back into token order,
by the union of the operations that belong to each span, a layer's
average times the layers."""

LAYER = "Expert layer"
UNIT = "ms"
MOVES = "prefill_ms_p95"
SOURCE = "program_span"

from portbench import program_spans  # noqa: E402
from portbench.moe_config import moe_shape  # noqa: E402


def read(w):
    route = program_spans.busy_ms_per_span(w, "moe.route")
    combine = program_spans.busy_ms_per_span(w, "moe.combine")
    if route is None or combine is None:
        return None
    return moe_shape(w.cell.config).layers * (route + combine)
