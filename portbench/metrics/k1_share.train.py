"""The share of the window's train-step decoder layers whose attention ran
K1's forward and backward, in %: the layers counted on the program's
``train.forward`` spans (the port's ``K1_TRAIN_COUNTER``) over the spans
times the configuration's layers. A program whose model has no such
counter gives None."""

LAYER = "Attention kernel K1"
UNIT = "%"
MOVES = "train_tokens_per_s"
SOURCE = "program_counter"

from portbench import program_spans  # noqa: E402
from portbench.model_config import model_shape  # noqa: E402


def _counter():
    try:
        from brpc_tpu_torch.models import llama
    except ImportError:
        return None
    return getattr(llama, "K1_TRAIN_COUNTER", None)


def read(w):
    counter = _counter()
    found = program_spans.spans(w, "train.forward")
    if counter is None or found is None:
        return None
    layers = model_shape(w.cell.config).layers
    return 100 * sum(s.counts.get(counter, 0) for s in found) \
        / (len(found) * layers)
