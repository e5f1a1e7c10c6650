"""Device-busy ms a step inside the device interval of the program's
``train.optimizer`` span: the optimizer's update of every parameter, by
the union of the operations that belong to it."""

LAYER = "Optimizer"
UNIT = "ms"
MOVES = "train_tokens_per_s"
SOURCE = "program_span"

from portbench import program_spans  # noqa: E402


def read(w):
    return program_spans.busy_ms_per_span(w, "train.optimizer")
