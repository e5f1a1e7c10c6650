"""Algorithm bandwidth, as nccl-tests counts it: the bytes of one card's
gradient summed by every all-reduce call the window completed, over the
window's seconds, in GB/s."""

from portbench.counts import F32_BYTES


def read(w):
    return sum(F32_BYTES * u["n"] for u in w.units) / w.window_s / 1e9
