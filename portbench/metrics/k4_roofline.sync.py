"""K4's share of its roofline, in %: the least time each all-reduce call
could take (``counts.all_reduce_bound_s``) over the device time of the
slowest card's kernel for that call, summed over the calls."""

LAYER = "Fabric kernel K4"
UNIT = "%"
MOVES = "allreduce_GBps"
SOURCE = "device_trace"

from portbench import counts, kinds  # noqa: E402


def read(w):
    t = w.trace
    per_card = [t.durations(kinds.K4_ALL_REDUCE, d) for d in t.devices]
    calls = min(len(times) for times in per_card)
    if calls == 0:
        return None
    slowest = sum(max(times[i] for times in per_card) for i in range(calls))
    replicas = len(t.devices)
    bound = sum(counts.all_reduce_bound_s(u["n"], replicas)
                for u in w.units[:calls])
    return 100 * bound / slowest
