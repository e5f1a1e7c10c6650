"""The traced run's device intervals, and what the metrics read of them.

``capture`` runs the measured window under ``torch.profiler`` with CUDA
activity only, so that the profiler adds no record of its own to each
host operation. The harness's spans are taken on the host's real-time
clock (``time.time_ns``), the clock the profiler stamps device intervals
with, so a device interval and the span the host was in line up.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
import time
from collections import defaultdict

import torch

OUTSIDE = "harness"  # a gap no span covers
TOP = 10


@dataclasses.dataclass
class Trace:
    """Device intervals ``(device, name, start_ns, end_ns)``, the host's
    spans ``(name, start_ns, end_ns)`` and the window ``(start_ns,
    end_ns)``, over the cell's ``devices``."""
    kernels: list
    spans: list
    window: tuple
    devices: list

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def on(self, device: int) -> list:
        return sorted((k for k in self.kernels if k[0] == device),
                      key=lambda k: k[2])

    def busy(self, device: int) -> list:
        """The union of ``device``'s intervals within the window, merged."""
        lo, hi = self.window
        merged = []
        for _, _, start, end in self.on(device):
            start, end = max(start, lo), min(end, hi)
            if end <= start:
                continue
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return merged

    def busy_s(self, device: int) -> float:
        return sum(end - start for start, end in self.busy(device)) / 1e9

    def idle_share(self, device: int) -> float:
        return 1.0 - self.busy_s(device) / self.window_s

    def durations(self, pattern: re.Pattern, device: int) -> list:
        """Seconds of each of ``device``'s intervals whose name matches,
        in order of start."""
        return [(end - start) / 1e9 for _, name, start, end in self.on(device)
                if pattern.search(name)]

    def device_ops(self) -> list:
        """The operations that took most device time, seconds a card."""
        total = defaultdict(float)
        for _, name, start, end in self.kernels:
            total[name] += (end - start) / 1e9 / len(self.devices)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name[:200], seconds] for name, seconds in ranked]

    def idle_gaps(self) -> list:
        """Idle time on the cards, by the innermost span the host was in
        when each gap began, seconds a card."""
        # by start, the longer first, so that the last to start is the
        # innermost
        spans = sorted(self.spans, key=lambda s: (s[1], -s[2]))
        starts = [s[1] for s in spans]
        total, count = defaultdict(float), defaultdict(int)
        lo, hi = self.window
        for device in self.devices:
            edge = lo
            for start, end in [*self.busy(device), [hi, hi]]:
                if start > edge:
                    label = _innermost(spans, starts, edge)
                    total[label] += (start - edge) / 1e9 / len(self.devices)
                    count[label] += 1
                edge = max(edge, end)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
        return [[f"{label} ({count[label]} gaps)", seconds]
                for label, seconds in ranked]


def _innermost(spans: list, starts: list, t: int) -> str:
    """The latest-starting span that covers t."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        name, start, end = spans[i]
        if start <= t < end:
            return name
    return OUTSIDE


class Capture:
    """Profiles the window: ``with capture: ...``, then ``.trace(spans)``."""

    def __init__(self, devices: list):
        self.cuda = [d for d in devices if d.type == "cuda"]
        self.devices = [d.index if d.type == "cuda" else 0 for d in devices]
        self._prof = None
        self.window = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA] if self.cuda
                             else [ProfilerActivity.CPU])
        self._prof.__enter__()
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        for d in self.cuda:
            torch.cuda.synchronize(d)
        self.window = (self._start, time.time_ns())
        self._prof.__exit__(*exc)
        return False

    def trace(self, spans: list) -> Trace:
        from torch.autograd import DeviceType

        kernels = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
                continue
            kernels.append((e.device_index(), e.name(), e.start_ns(),
                            e.end_ns()))
        return Trace(kernels, spans, self.window, self.devices)


@contextlib.contextmanager
def nothing():
    yield None
