"""The share of the program's ``llama.forward`` spans in the traced window
that replayed a CUDA graph (counted the port's ``GRAPH_COUNTER``), in %:
how often ``LlamaModel`` serves a request from its graph rather than
launching each kernel from the host. A program whose model has no such
counter gives None."""

LAYER = "Model step"
UNIT = "%"
MOVES = "prefill_tokens_per_s"
SOURCE = "program_counter"

from portbench import program_spans  # noqa: E402


def _counter():
    try:
        from brpc_tpu_torch.models import llama
    except ImportError:
        return None
    return getattr(llama, "GRAPH_COUNTER", None)


def read(w):
    counter = _counter()
    found = program_spans.spans(w, "llama.forward")
    if counter is None or found is None:
        return None
    return 100 * sum(1 for s in found if s.counts.get(counter)) / len(found)
