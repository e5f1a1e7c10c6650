"""Device operations a request inside the device interval of the
program's ``llama.forward`` span: the kernels (and copies) one request
launches, the same for every run of a fixed mix."""

LAYER = "Model step"
UNIT = "kernels"
MOVES = "prefill_tokens_per_s"
SOURCE = "program_span"

from portbench import program_spans  # noqa: E402


def read(w):
    found = program_spans.marked(w, "llama.forward")
    if found is None:
        return None
    return sum(len(program_spans.inside(w, s)) for s in found) / len(found)
