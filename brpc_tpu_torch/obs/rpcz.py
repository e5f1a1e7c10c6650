"""rpcz-style per-call tracing (reference src/brpc/builtin/rpcz_service.cpp,
src/brpc/span.cpp).

Every instrumented call — client-side ``Channel.call``, server-side
handler dispatch, PS lookups, user code under ``span(...)`` — appends one
``Span`` to a bounded ring buffer.  ``dump_rpcz`` answers the /rpcz
queries: most-recent-first, filterable by service/method/side/errors.
The ring is deliberately small and lossy: under heavy traffic old spans
fall off the back, which is exactly the reference's behaviour (rpcz keeps
a time-bounded window, not a full log).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

from brpc_tpu_torch.analysis.race import checked_lock

__all__ = ["Span", "SpanRing", "default_ring", "record_span", "span",
           "dump_rpcz", "set_capacity", "clear"]

DEFAULT_CAPACITY = 1024


@dataclasses.dataclass
class Span:
    service: str
    method: str
    side: str = "client"            # "client" | "server" | "user"
    peer: str = ""                  # remote address when known
    request_bytes: int = 0
    response_bytes: int = 0
    start_ns: int = 0               # monotonic ns
    end_ns: int = 0
    wall_time: float = 0.0          # epoch seconds at start (display)
    error_code: int = 0
    error_text: str = ""
    annotations: List[str] = dataclasses.field(default_factory=list)

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
    _default_ring.clear()


def record_span(s: Span, ring: Optional[SpanRing] = None) -> None:
    # "ring or _default_ring" would misroute: an EMPTY SpanRing is falsy
    # through __len__.
    (_default_ring if ring is None else ring).append(s)


def dump_rpcz(limit: int = 50, service: Optional[str] = None,
              method: Optional[str] = None, side: Optional[str] = None,
              errors_only: bool = False) -> List[Dict[str, object]]:
    return _default_ring.dump(limit=limit, service=service, method=method,
                              side=side, errors_only=errors_only)


@contextlib.contextmanager
def span(service: str, method: str, side: str = "user", peer: str = "",
         request_bytes: int = 0, ring: Optional[SpanRing] = None):
    """Trace a block of user code:

        with obs.span("Trainer", "step") as sp:
            ...
            sp.annotate("compiled")

    An exception inside the block marks the span failed (code 2001) and
    re-raises; the span is recorded either way.
    """
    s = Span(service=service, method=method, side=side, peer=peer,
             request_bytes=request_bytes, wall_time=time.time(),
             start_ns=time.monotonic_ns())
    try:
        yield s
    except Exception as e:  # noqa: BLE001
        s.error_code = s.error_code or 2001
        s.error_text = s.error_text or str(e)
        raise
    finally:
        s.end_ns = time.monotonic_ns()
        record_span(s, ring)


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
