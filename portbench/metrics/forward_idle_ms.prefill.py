"""Device ms a request in which the card idles inside the device interval
of the program's ``llama.forward`` span: the interval less the union of
the operations that belong to it."""

LAYER = "Device"
UNIT = "ms"
MOVES = "prefill_tokens_per_s"
SOURCE = "program_span"

from portbench import program_spans  # noqa: E402


def read(w):
    found = program_spans.marked(w, "llama.forward")
    if found is None:
        return None
    idle = sum(s.device_end_ns - s.device_start_ns - program_spans.busy_ns(
        program_spans.inside(w, s), s.device_start_ns, s.device_end_ns)
        for s in found)
    return idle / len(found) / 1e6
