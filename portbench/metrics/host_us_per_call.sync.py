"""Host microseconds a call of the fabric's ``all_reduce_sum`` takes to
return (events, outputs, waits and launches), from the harness's span
around each call."""

LAYER = "Fabric wrapper"
UNIT = "us"
MOVES = "allreduce_GBps"
SOURCE = "host_clock"


def read(w):
    calls = [end - start for name, start, end in w.cell.spans.records
             if name == "all_reduce_sum"]
    if not calls:
        return None
    return sum(calls) / len(calls) / 1e3
