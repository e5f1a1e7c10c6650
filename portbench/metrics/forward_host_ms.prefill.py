"""Host ms a request inside the program's ``llama.forward`` span: the time
the host takes to issue a request's kernels, from the embedding to the
f32 logits."""

LAYER = "Model step"
UNIT = "ms"
MOVES = "prefill_tokens_per_s"
SOURCE = "program_span"

from portbench import program_spans  # noqa: E402


def read(w):
    found = program_spans.spans(w, "llama.forward")
    if found is None:
        return None
    return sum(s.end_ns - s.start_ns for s in found) / len(found) / 1e6
