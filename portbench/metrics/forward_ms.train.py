"""Device-busy ms a step inside the device interval of the program's
``train.forward`` span: the loss from the batch (the model's forward, the
LM head and the cross-entropy), by the union of the operations that
belong to it."""

LAYER = "Model step"
UNIT = "ms"
MOVES = "train_tokens_per_s"
SOURCE = "program_span"

from portbench import program_spans  # noqa: E402


def read(w):
    return program_spans.busy_ms_per_span(w, "train.forward")
