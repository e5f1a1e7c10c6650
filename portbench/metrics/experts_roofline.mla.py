"""The expert products' share of their roofline, routed and shared
experts together, in %: for each expert layer of each request, the least
time its products can take (``mla_counts.experts_bound_s``: the (token,
expert) pairs and the experts held that the program's ``moe.route`` span
counts, and the rows the ``moe.experts`` span counts as ``shared``),
summed, over the device time of the operations inside those
``moe.experts`` spans. None where the program counts no ``shared``."""

LAYER = "Expert layer"
UNIT = "%"
MOVES = "prefill_tokens_per_s"
SOURCE = "program_span"

import bisect  # noqa: E402

from portbench import mla_counts, program_spans  # noqa: E402
from portbench.mla_config import mla_shape  # noqa: E402


def read(w):
    found = program_spans.marked(w, "moe.experts")
    routes = program_spans.spans(w, "moe.route")
    if found is None or routes is None:
        return None
    siblings = {}  # the routes under each parent span, by start
    for r in sorted(routes, key=lambda r: r.start_ns):
        siblings.setdefault(r.parent_id, []).append(r)
    m = mla_shape(w.cell.config)
    bound = spent = 0.0
    for s in found:
        if "shared" not in s.counts:
            return None
        before = siblings.get(s.parent_id, [])
        i = bisect.bisect_right([r.start_ns for r in before], s.start_ns)
        if i == 0:
            continue
        counted = before[i - 1].counts
        bound += mla_counts.experts_bound_s(
            m, counted["pairs"], counted["experts"], s.counts["shared"])
        spent += sum(end - start
                     for start, end in program_spans.inside(w, s)) / 1e9
    if spent == 0:
        return None
    return 100 * bound / spent
