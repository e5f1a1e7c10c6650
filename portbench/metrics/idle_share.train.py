"""The share of the traced window in which no operation runs on the card,
by the union of the device's intervals, in %; across cards the highest."""

LAYER = "Device"
UNIT = "%"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"


def read(w):
    t = w.trace
    if not t.kernels:
        return None
    return 100 * max(t.idle_share(d) for d in t.devices)
