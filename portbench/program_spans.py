"""The program's own spans in a traced window, for the readers of source
``program_span`` and ``program_counter``.

While ``torch.profiler`` runs, the port records spans on its model path
(``brpc_tpu_torch.obs.rpcz``: ``llama.forward``, ``llama.cast``,
``train.forward`` and the rest), stamped on the host's real-time clock
like the harness's window, and a marked span launches marker kernels at
its edges. The harness profiles a traced run's window, so this module
reads the spans there through ``rpcz.captured(*w.trace.window,
kernels)``, which puts each marked span's interval on the trace's
timeline, around the kernels launched inside it. A program that records no such spans, or
has no capture store, gives None, and so does every reader.

A device interval of the trace, markers aside, belongs to a marked span
when its midpoint lies in the span's interval on the span's device.
"""

from __future__ import annotations

import bisect


def _rpcz():
    try:
        from brpc_tpu_torch.obs import rpcz
    except ImportError:
        return None
    return rpcz if hasattr(rpcz, "captured") else None


def spans(w, name: str):
    """The window's spans called ``name`` (``service.method``), or None."""
    rpcz = _rpcz()
    if w.trace is None or rpcz is None:
        return None
    found = [s for s in rpcz.captured(*w.trace.window,
                                      kernels=w.trace.kernels)
             if f"{s.service}.{s.method}" == name]
    return found or None


def marked(w, name: str):
    """The window's spans called ``name`` that have a device interval, or
    None."""
    found = [s for s in spans(w, name) or ()
             if getattr(s, "device_start_ns", None) is not None]
    return found or None


_index = (None, None)  # (trace, {device: (midpoints, intervals)})


def _by_device(trace) -> dict:
    """The trace's intervals other than markers, by device, sorted by
    midpoint; computed once a trace."""
    global _index
    if _index[0] is not trace:
        rpcz, kept = _rpcz(), {}
        for device, name, start, end in trace.kernels:
            if not rpcz.is_marker(name):
                kept.setdefault(device, []).append(((start + end) / 2,
                                                    (start, end)))
        index = {}
        for device, found in kept.items():
            found.sort()
            index[device] = ([m for m, _ in found], [k for _, k in found])
        _index = (trace, index)
    return _index[1]


def inside(w, s) -> list:
    """``(start_ns, end_ns)`` of each device interval, markers aside, that
    belongs to the marked span ``s``."""
    mids, intervals = _by_device(w.trace).get(s.device, ((), ()))
    lo = bisect.bisect_left(mids, s.device_start_ns)
    hi = bisect.bisect_right(mids, s.device_end_ns)
    return list(intervals[lo:hi])


def busy_ns(intervals, lo=None, hi=None) -> int:
    """The length of the union of ``intervals``, clipped to ``[lo, hi]``
    where given."""
    total, edge = 0, None
    for start, end in sorted(intervals):
        if lo is not None:
            start = max(start, lo)
        if hi is not None:
            end = min(end, hi)
        if edge is not None:
            start = max(start, edge)
        if end > start:
            total += end - start
        edge = end if edge is None else max(edge, end)
    return total


def busy_ms_per_span(w, name: str):
    """Device-busy ms inside each span called ``name``, on average: the
    union of the intervals that belong to it."""
    found = marked(w, name)
    if found is None:
        return None
    return sum(busy_ns(inside(w, s)) for s in found) / len(found) / 1e6
