"""Device ms a request of copy and cast kernels (the per-layer f32 to
bf16 weight casts among them), by the kernel classifier."""

LAYER = "Model step"
UNIT = "ms"
MOVES = "prefill_ms_p95"
SOURCE = "device_trace"

from portbench import kinds  # noqa: E402


def read(w):
    t = w.trace
    seconds = sum((end - start) / 1e9 for _, name, start, end in t.kernels
                  if kinds.kind(name) == "copy_cast")
    if not w.units or seconds == 0:
        return None
    return 1e3 * seconds / len(w.units)
