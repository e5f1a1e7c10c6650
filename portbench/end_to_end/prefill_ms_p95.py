"""The 95th percentile of every request's latency in the window (time to
the first token), in ms, by the nearest rank."""

import math


def read(w):
    latencies = sorted(u["latency_s"] for u in w.units)
    return 1e3 * latencies[math.ceil(0.95 * len(latencies)) - 1]
