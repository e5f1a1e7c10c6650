"""brpc_tpu_torch.obs — observability: bvar-style metrics + rpcz tracing.

Two layers, both pure Python/numpy (no native build required):

- :mod:`brpc_tpu_torch.obs.vars` — the metrics core: ``Adder``/``Maxer``/
  ``Miner`` thread-local-agent reducers, ``PassiveStatus``, ``Window`` /
  ``PerSecond`` time-windowed views, ``LatencyRecorder`` (count/qps/avg +
  log-bucket percentiles), and a global ``Registry`` behind
  ``expose`` / ``dump_exposed`` (the /vars page).
- :mod:`brpc_tpu_torch.obs.rpcz` — the port's one span system: per-call
  ``Span`` records (trace, span and parent ids, named ``counts``, stamps
  on ``clock_ns()``, the profiler's real-time clock) in a bounded ring
  (``dump_rpcz``, the /rpcz page), a ``span(...)`` context manager for
  user code, and ``rpcz.trace(...)`` for the model path.

The RPC/PS fabric (``brpc_tpu_torch.rpc``, ``brpc_tpu_torch.ps_remote``,
``brpc_tpu_torch.parallel.collective_channel``) is instrumented through the
cached helpers here (:func:`recorder`, :func:`counter`); every hook
checks :func:`enabled` first and degrades to a no-op when observability
is switched off (``set_enabled(False)`` or env
``BRPC_TPU_OBS=0``).  ``Server.add_status_service()`` serves both dumps
over the RPC fabric itself so a remote ``Channel`` can scrape any node
(:mod:`brpc_tpu_torch.obs.status_service`).

The switch lives in :mod:`~brpc_tpu_torch.obs.rpcz`, re-exported here.
The model path (``models/llama.py``: ``llama.forward``,
``train.forward`` / ``backward`` / ``optimizer``; ``models/moe.py``:
``moe.*``) has a second gate: its spans are recorded only while a
``torch.profiler`` session runs in the process and :func:`enabled`
holds.  Otherwise each of its hooks reads two
flags and makes nothing.  While the profiler runs, every span also goes to an
unbounded capture store beside the lossy ring, which
``rpcz.captured(start_ns, end_ns, kernels)`` returns, marked spans with
their interval on the device (``rpcz`` says how).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from brpc_tpu_torch.analysis.race import checked_lock

from brpc_tpu_torch.obs.vars import (  # noqa: F401
    Adder,
    LatencyRecorder,
    Maxer,
    Miner,
    PassiveStatus,
    PerSecond,
    Registry,
    Variable,
    Window,
    default_registry,
    dump_exposed,
    dump_exposed_dict,
    expose,
)
from brpc_tpu_torch.obs.rpcz import (  # noqa: F401
    Span,
    SpanRing,
    default_ring,
    dump_rpcz,
    format_rpcz,
    clock_ns,
    enabled,
    record_span,
    set_enabled,
    span,
)

__all__ = [
    # vars
    "Adder", "Maxer", "Miner", "PassiveStatus", "Window", "PerSecond",
    "LatencyRecorder", "Registry", "Variable", "default_registry",
    "expose", "dump_exposed", "dump_exposed_dict",
    # rpcz
    "Span", "SpanRing", "default_ring", "dump_rpcz", "format_rpcz",
    "record_span", "span", "clock_ns",
    # gate + cached fabric helpers
    "enabled", "set_enabled", "recorder", "counter", "maxer", "gauge",
    "drop_var", "reset_fabric_vars",
]

# Cached, auto-exposed fabric variables.  Instrumented call sites resolve
# their recorder by name on every call; the dict hit is the steady-state
# cost, and creation (+ expose) happens once per distinct name.
_fabric_mu = checked_lock("obs.fabric")
_recorders: Dict[str, LatencyRecorder] = {}
_counters: Dict[str, Adder] = {}
_maxers: Dict[str, Maxer] = {}
_gauges: Dict[str, PassiveStatus] = {}


def recorder(name: str, window_size: int = 10) -> LatencyRecorder:
    """The process-wide LatencyRecorder exposed under ``name``."""
    rec = _recorders.get(name)
    if rec is None:
        with _fabric_mu:
            rec = _recorders.get(name)
            if rec is None:
                rec = LatencyRecorder(window_size=window_size)
                rec.expose(name)
                _recorders[name] = rec
    return rec


def counter(name: str) -> Adder:
    """The process-wide Adder exposed under ``name``."""
    c = _counters.get(name)
    if c is None:
        with _fabric_mu:
            c = _counters.get(name)
            if c is None:
                c = Adder()
                c.expose(name)
                _counters[name] = c
    return c


def maxer(name: str) -> Maxer:
    """The process-wide Maxer exposed under ``name`` (high-water marks:
    combine-queue depth, window occupancy)."""
    m = _maxers.get(name)
    if m is None:
        with _fabric_mu:
            m = _maxers.get(name)
            if m is None:
                m = Maxer()
                m.expose(name)
                _maxers[name] = m
    return m


def gauge(name: str, fn: Callable[[], object]) -> PassiveStatus:
    """Exposes (or replaces) a :class:`PassiveStatus` under ``name`` —
    a value computed on read (live inflight, the adaptive limiter's
    current max_concurrency).  Components with a lifetime (a shard
    server's overload gauges) pair this with :func:`drop_var` at
    teardown."""
    g = PassiveStatus(fn)
    with _fabric_mu:
        g.expose(name)
        _gauges[name] = g
    return g


def drop_var(name: str) -> None:
    """Hide one fabric variable (any kind) and drop its cache entry —
    the teardown half of per-component gauges."""
    with _fabric_mu:
        default_registry().hide(name)
        _recorders.pop(name, None)
        _counters.pop(name, None)
        _maxers.pop(name, None)
        _gauges.pop(name, None)


def reset_fabric_vars() -> None:
    """Drop all cached fabric recorders/counters and their registry
    entries (test isolation)."""
    with _fabric_mu:
        for name in list(_recorders) + list(_counters) + list(_maxers) \
                + list(_gauges):
            default_registry().hide(name)
        _recorders.clear()
        _counters.clear()
        _maxers.clear()
        _gauges.clear()
