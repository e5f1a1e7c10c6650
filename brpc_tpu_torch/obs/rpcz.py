"""rpcz-style per-call tracing (reference src/brpc/builtin/rpcz_service.cpp,
src/brpc/span.cpp): the port's one span system.

Every instrumented call — client-side ``Channel.call``, server-side
handler dispatch, PS lookups, user code under ``span(...)`` — appends one
``Span`` to a bounded ring buffer.  ``dump_rpcz`` answers the /rpcz
queries: most-recent-first, filterable by service/method/side/errors.
The ring is deliberately small and lossy: under heavy traffic old spans
fall off the back, which is exactly the reference's behaviour (rpcz keeps
a time-bounded window, not a full log).

A span carries a trace id, its own id and its parent's.  A span opened
inside another (``span``, ``trace``, or one recorded in its block) is its
child, through a ``contextvars`` stack; one opened outside every other
starts a new trace.  Ids are unique within the process.  ``counts`` holds
named integers that the code inside a span adds to, so a count is kept at
the same boundary as the time.  Every host stamp comes from
``clock_ns()``, the real-time clock (``time.time_ns``), on which
``torch.profiler`` also stamps its host window.

The model path's spans (``trace(...)``) are recorded only while the
program is traced: while a ``torch.profiler`` session runs in the process
(``profiling()``) and observability is enabled (``enabled()``, the one
switch, which ``obs`` re-exports).  Otherwise ``trace`` reads two flags
and returns a shared null context: it makes no ``Span``, no dict and
launches nothing.  While the profiler runs, every span recorded (the
RPC's and the user's too) also goes to an unbounded capture store beside
the ring; ``captured(start_ns, end_ns)`` returns them and ends the
capture.  A span opened with ``mark=`` a CUDA tensor launches a marker
kernel (``MARKER_KERNEL``, about 2 us) on the current stream at its
start, and at its end unless it counts the ``kernels`` it launched.  The
profiler stamps the markers on its own timeline with every other kernel,
and kernels of one stream run in launch order, so given the trace's
kernels ``captured`` puts each marked span's ``device_start_ns`` and
``device_end_ns``, on the trace's timeline, around exactly the kernels
launched inside it.  No other clock has to agree with the trace's: on an
H100 CUDA events drifted 12–62 us from it over 0.2–5 s, not linearly,
and the host clock sat up to 4.7 ms off it in a session, either enough
to put a layer's smallest casts on the wrong side of a span's edge.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import os
import sys
import time
from collections import deque
from typing import Dict, List, Optional

from brpc_tpu_torch.analysis.race import checked_lock

__all__ = ["Span", "SpanRing", "default_ring", "record_span", "span",
           "trace", "captured", "clock_ns", "enabled", "set_enabled",
           "profiling", "is_marker", "MARKER_KERNEL", "dump_rpcz",
           "set_capacity", "clear"]

DEFAULT_CAPACITY = 1024


#: Every host stamp of a span: the real-time clock, which the profiler's
#: device intervals are stamped with.
clock_ns = time.time_ns

_new_id = itertools.count(1).__next__
#: The innermost open span of this thread or task.
_current: contextvars.ContextVar = contextvars.ContextVar("rpcz_span",
                                                          default=None)


def _trace_id() -> int:
    parent = _current.get()
    return _new_id() if parent is None else parent.trace_id


def _parent_id() -> int:
    parent = _current.get()
    return 0 if parent is None else parent.span_id


@dataclasses.dataclass
class Span:
    service: str
    method: str
    side: str = "client"            # "client" | "server" | "user"
    peer: str = ""                  # remote address when known
    request_bytes: int = 0
    response_bytes: int = 0
    start_ns: int = 0               # clock_ns()
    end_ns: int = 0
    wall_time: float = 0.0          # epoch seconds at start (display)
    error_code: int = 0
    error_text: str = ""
    annotations: List[str] = dataclasses.field(default_factory=list)
    # the enclosing span's trace, or a new one; 0 for a root's parent
    trace_id: int = dataclasses.field(default_factory=_trace_id)
    span_id: int = dataclasses.field(default_factory=_new_id)
    parent_id: int = dataclasses.field(default_factory=_parent_id)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    # a marked span's CUDA device and its interval there, on the
    # profiler trace's timeline
    device: Optional[int] = None
    device_start_ns: Optional[int] = None
    device_end_ns: Optional[int] = None

    @property
    def name(self) -> str:
        return f"{self.service}.{self.method}"

    def count(self, name: str, n: int) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    @property
    def latency_us(self) -> float:
        return (self.end_ns - self.start_ns) / 1e3

    def annotate(self, text: str) -> None:
        self.annotations.append(text)

    def to_dict(self) -> Dict[str, object]:
        return {
            "service": self.service,
            "method": self.method,
            "side": self.side,
            "peer": self.peer,
            "request_bytes": self.request_bytes,
            "response_bytes": self.response_bytes,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "wall_time": self.wall_time,
            "latency_us": round(self.latency_us, 3),
            "error_code": self.error_code,
            "error_text": self.error_text,
            "annotations": list(self.annotations),
        }


class SpanRing:
    """Bounded, thread-safe span store."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._mu = checked_lock("obs.rpcz_ring")
        self._ring: deque = deque(maxlen=capacity)

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    def set_capacity(self, capacity: int) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        with self._mu:
            self._ring = deque(self._ring, maxlen=capacity)

    def append(self, s: Span) -> None:
        with self._mu:
            self._ring.append(s)

    def __len__(self) -> int:
        with self._mu:
            return len(self._ring)

    def clear(self) -> None:
        with self._mu:
            self._ring.clear()

    def dump(self, limit: int = 50, service: Optional[str] = None,
             method: Optional[str] = None, side: Optional[str] = None,
             errors_only: bool = False) -> List[Dict[str, object]]:
        """Most-recent-first span dicts matching the filters."""
        with self._mu:
            snapshot = list(self._ring)
        out: List[Dict[str, object]] = []
        for s in reversed(snapshot):
            if service is not None and s.service != service:
                continue
            if method is not None and s.method != method:
                continue
            if side is not None and s.side != side:
                continue
            if errors_only and s.error_code == 0:
                continue
            out.append(s.to_dict())
            if len(out) >= limit:
                break
        return out


_default_ring = SpanRing()


def default_ring() -> SpanRing:
    return _default_ring


def set_capacity(capacity: int) -> None:
    _default_ring.set_capacity(capacity)


def clear() -> None:
    """Empties the ring and drops the capture store."""
    global _capture
    _default_ring.clear()
    with _capture_mu:
        _capture = None


def record_span(s: Span, ring: Optional[SpanRing] = None) -> None:
    # "ring or _default_ring" would misroute: an EMPTY SpanRing is falsy
    # through __len__.
    (_default_ring if ring is None else ring).append(s)
    if profiling():
        _open_capture().add(s)


def dump_rpcz(limit: int = 50, service: Optional[str] = None,
              method: Optional[str] = None, side: Optional[str] = None,
              errors_only: bool = False) -> List[Dict[str, object]]:
    return _default_ring.dump(limit=limit, service=service, method=method,
                              side=side, errors_only=errors_only)


@contextlib.contextmanager
def span(service: str, method: str, side: str = "user", peer: str = "",
         request_bytes: int = 0, ring: Optional[SpanRing] = None,
         mark=None):
    """Trace a block of user code:

        with obs.span("Trainer", "step") as sp:
            ...
            sp.annotate("compiled")

    An exception inside the block marks the span failed (code 2001) and
    re-raises; the span is recorded either way.  Spans opened in the block
    are its children.

    ``mark``: a tensor.  While the program is traced and it lies on a CUDA
    device, the span launches a marker kernel on the current device's
    current stream at its start, and at its end unless the block counts
    the ``kernels`` it launched there (``sp.count("kernels", n)``); then
    its interval ends with the n-th kernel after the first marker.
    ``captured`` gives the span that interval on the trace's timeline.
    """
    start = clock_ns()
    s = Span(service=service, method=method, side=side, peer=peer,
             request_bytes=request_bytes, wall_time=start / 1e9,
             start_ns=start)
    first = None
    if mark is not None and mark.is_cuda and profiling():
        first = _open_capture().mark_start(s)
    token = _current.set(s)
    try:
        yield s
    except Exception as e:  # noqa: BLE001
        s.error_code = s.error_code or 2001
        s.error_text = s.error_text or str(e)
        raise
    finally:
        _current.reset(token)
        if first is not None:
            first[0].mark_end(s, first[1])
        s.end_ns = clock_ns()
        record_span(s, ring)


# ---------------------------------------------------------------------------
# spans of a traced program: the gate, the capture store, device markers
# ---------------------------------------------------------------------------

_enabled = os.environ.get("BRPC_TPU_OBS", "1") not in ("0", "false", "off")
_profiler = None      # torch.autograd.profiler, once torch is loaded


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    """Global observability switch; instrumentation hooks become no-ops
    when off (they check this before touching any recorder)."""
    global _enabled
    _enabled = bool(on)


def profiling() -> bool:
    """True while a ``torch.profiler`` session runs in this process: torch's
    own module flag (it never imports torch)."""
    global _profiler
    if _profiler is None:
        _profiler = sys.modules.get("torch.autograd.profiler")
        if _profiler is None:
            return False
    return _profiler._is_profiler_enabled


#: The device marker: torch's one-thread spin kernel (``torch.cuda._sleep``)
#: with no cycles to spin, about 2 us on the card, launched by nothing else.
MARKER_KERNEL = "spin_kernel"


def is_marker(kernel_name: str) -> bool:
    return MARKER_KERNEL in kernel_name


class _Capture:
    """The spans of one profiler session, kept whole, and the marker
    kernels its marked spans launched, counted by device."""

    def __init__(self):
        self.spans: List[Span] = []
        self.marks: list = []         # (span, first ordinal, last or None)
        self.launched: Dict[int, int] = {}
        self.open = True

    def add(self, s: Span) -> None:
        with _capture_mu:
            self.spans.append(s)

    def _mark(self, device: int) -> int:
        """Launches a marker kernel on the current stream; returns its
        ordinal among the capture's markers on ``device``."""
        sys.modules["torch"].cuda._sleep(0)
        with _capture_mu:
            n = self.launched[device] = self.launched.get(device, 0) + 1
        return n - 1

    def mark_start(self, s: Span) -> tuple:
        s.device = sys.modules["torch"].cuda.current_device()
        return self, self._mark(s.device)

    def mark_end(self, s: Span, first: int) -> None:
        last = None if "kernels" in s.counts else self._mark(s.device)
        with _capture_mu:
            self.marks.append((s, first, last))

    def resolve(self, kernels) -> None:
        """Gives each marked span its device interval from the trace's
        ``(device, name, start_ns, end_ns)``, kernels of one stream
        running in launch order: from the end of its first marker kernel
        to the start of its last, or to the end of the n-th kernel after
        the first where it counted n ``kernels``.

        The profiler can lose the records of a session's first kernels
        (on an H100, the first 1 to 9 launches in 2 of 18 sessions), so
        the markers found are lined up with the last launches, and a span
        whose markers were lost gets no interval.  A device with more
        markers than launches gets none, and so does a counted span whose
        n kernels run into a marker or past the trace."""
        found: Dict[int, list] = {}
        for device, name, start, end in kernels:
            found.setdefault(device, []).append((start, end, is_marker(name)))
        with _capture_mu:
            marks, launched = list(self.marks), dict(self.launched)
        for device, n in launched.items():
            ops = sorted(found.get(device, ()))
            at = [i for i, op in enumerate(ops) if op[2]]
            lost = n - len(at)
            for s, first, last in marks:
                if s.device != device:
                    continue
                s.device_start_ns = s.device_end_ns = None
                if not 0 <= lost <= first:
                    continue
                i = at[first - lost]
                if last is not None:
                    end = ops[at[last - lost]][0]
                else:
                    run = ops[i + 1:i + 1 + s.counts["kernels"]]
                    if len(run) < s.counts["kernels"] \
                            or any(op[2] for op in run):
                        continue
                    end = run[-1][1] if run else ops[i][1]
                s.device_start_ns, s.device_end_ns = ops[i][1], end


_capture_mu = checked_lock("obs.rpcz_capture")
_capture: Optional[_Capture] = None


def _open_capture() -> _Capture:
    """The open capture, or a new one where the last has been read."""
    global _capture
    with _capture_mu:
        if _capture is None or not _capture.open:
            _capture = _Capture()
        return _capture


def captured(start_ns: Optional[int] = None, end_ns: Optional[int] = None,
             kernels=None) -> List[Span]:
    """The spans of the last capture that lie within ``[start_ns, end_ns]``
    on ``clock_ns()``.  With ``kernels``, the device intervals ``(device,
    name, start_ns, end_ns)`` of the profiler's trace of that session,
    each marked span gets ``device_start_ns`` and ``device_end_ns`` on the
    trace's timeline.  The first call after a profiler session ends that
    capture; the next traced span opens a new one.
    """
    with _capture_mu:
        cap = _capture
        if cap is None:
            return []
        cap.open = False
        spans = list(cap.spans)
    if kernels is not None:
        cap.resolve(kernels)
    return [s for s in spans
            if (start_ns is None or s.start_ns >= start_ns)
            and (end_ns is None or s.end_ns <= end_ns)]


_UNTRACED = contextlib.nullcontext()


def trace(service: str, method: str, mark=None):
    """A span of the model path (``span`` with ``mark``), recorded only
    while the program is traced (observability on and ``profiling()``);
    otherwise a shared null context whose ``as`` target is None::

        with rpcz.trace("moe", "experts", mark=x) as sp:
            ...
            if sp is not None:
                sp.count("kernels", n)
    """
    if not (_enabled and profiling()):
        return _UNTRACED
    return span(service, method, mark=mark)


def format_rpcz(spans: List[Dict[str, object]]) -> str:
    """Text rendering in the /rpcz style, one line per span."""
    lines = []
    for d in spans:
        err = (f" error={d['error_code']}({d['error_text']})"
               if d["error_code"] else "")
        lines.append(
            f"{d['side']:6s} {d['service']}.{d['method']} "
            f"peer={d['peer'] or '-'} req={d['request_bytes']}B "
            f"rsp={d['response_bytes']}B lat={d['latency_us']:.1f}us{err}")
    return "\n".join(lines)
