"""Dynamic native-handle ledger for the C ABI.

Every ``brt_*`` object the Python tier creates over ctypes — servers,
channels, in-flight calls, call groups, PS shards, events, streams,
device clients/executables — must be explicitly destroyed; a dropped
handle is native memory (and often a fiber, a socket, a snapshot chain)
leaked until process exit.  Under ``BRPC_TPU_HANDLECHECK=1``,
``rpc._load()`` wraps every ``brt_*_new``/``_destroy`` pair so each live
handle is recorded here with its creation stack (the LeakSanitizer
shape, aware of our ABI), and the stream tier records its
receiver-registry entries the same way.

The ledger is BOOKKEEPING, not ground truth: the native side counts live
objects itself (``brt_debug_handle_counts()`` in ``cpp/capi``), and
``rpc.debug_handle_counts()`` exposes that table so tests cross-check
the two — a leak shows up in both; a ledger/native disagreement means a
wrapper lost track.

Stack capture is the dominant cost (same profile as RACECHECK), so
sampling reuses the RACECHECK machinery verbatim:
``BRPC_TPU_RACECHECK_SAMPLE=N`` / :func:`race.set_sample` capture every
Nth creation's stack per handle kind — the FIRST creation of a kind is
always captured, later sampled-out creations carry a placeholder.  The
ledger itself (the dict insert/remove) always runs, so live counts stay
exact; only stack *context* degrades.  With ``BRPC_TPU_HANDLECHECK``
unset nothing is wrapped at all — the steady-state ABI carries zero
overhead (asserted by ``bench_analysis.py``).

Stdlib-only, below ``rpc`` in the import order (``rpc._load`` imports
this module).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import traceback
from typing import Dict, List, Optional, Tuple

from brpc_tpu_torch.analysis import race

__all__ = [
    "enabled", "set_enabled", "note_create", "note_destroy", "live",
    "live_counts", "clear", "report", "HandleRecord", "SAMPLED_OUT",
]

_override: Optional[bool] = None

#: creation-stack placeholder for handles whose capture was sampled out
SAMPLED_OUT = ("<creation stack not captured: sampled out — lower "
               "BRPC_TPU_RACECHECK_SAMPLE for full context>\n")


def enabled() -> bool:
    """True when handle tracking is on (``set_enabled`` override first,
    else the ``BRPC_TPU_HANDLECHECK`` env var).  ``rpc._load()`` consults
    this ONCE, at load time — flipping it later does not re-wrap an
    already-loaded ABI."""
    if _override is not None:
        return _override
    return os.environ.get("BRPC_TPU_HANDLECHECK", "") not in (
        "", "0", "false", "off")


def set_enabled(on: Optional[bool]) -> None:
    """Force tracking on/off for this process (``None`` restores the env
    var's verdict).  Must be set before the first ``rpc._load()`` to
    affect the ABI wrappers; the ledger functions themselves honor it
    immediately."""
    global _override
    _override = on


@dataclasses.dataclass
class HandleRecord:
    kind: str          # "server" | "channel" | "call" | ...
    handle: int        # the native pointer/id value
    stack: str         # creation stack (or SAMPLED_OUT)
    seq: int           # kind-local creation sequence number

    def format(self) -> str:
        out = [f"[{self.kind}] handle 0x{self.handle:x} (#{self.seq}) "
               f"created here:"]
        out.extend("  " + ln for ln in self.stack.rstrip().splitlines())
        return "\n".join(out)


# One plain lock; nothing inside its critical sections can re-enter the
# ledger (stack formatting happens before acquiring it).
_mu = threading.Lock()
_live: Dict[Tuple[str, int], HandleRecord] = {}
_created: Dict[str, int] = {}        # kind -> creations seen
_destroyed: Dict[str, int] = {}      # kind -> destroys matched
_unknown_destroys: Dict[str, int] = {}  # destroys of handles never seen


def _coerce(handle) -> Optional[int]:
    """Native handle as an int: ctypes c_void_p / byref'd out-params and
    plain ints all normalize; NULL/0/None (failed constructors) to
    None — a creation that failed owns nothing."""
    value = getattr(handle, "value", handle)
    if value in (None, 0):
        return None
    try:
        return int(value)
    except (TypeError, ValueError):
        return None


def note_create(kind: str, handle) -> None:
    """Record a live handle.  The first creation of each kind always
    captures its stack; later ones follow the RACECHECK sampling period
    (see module docstring)."""
    if not enabled():
        return
    h = _coerce(handle)
    if h is None:
        return
    n = race.sample_every()
    with _mu:
        seq = _created.get(kind, 0) + 1
        _created[kind] = seq
    # Capture OUTSIDE the lock: format_stack is the whole cost.
    if n <= 1 or seq % n == 1 or seq == 1:
        stack = "".join(traceback.format_stack()[:-1])
    else:
        stack = SAMPLED_OUT
    with _mu:
        _live[(kind, h)] = HandleRecord(kind=kind, handle=h, stack=stack,
                                        seq=seq)


def note_destroy(kind: str, handle) -> None:
    """Record a handle's release.  Destroys of handles the ledger never
    saw (created before tracking was enabled, or out-params the wrapper
    cannot see) are counted separately, never underflow."""
    if not enabled():
        return
    h = _coerce(handle)
    if h is None:
        return
    with _mu:
        if _live.pop((kind, h), None) is None:
            _unknown_destroys[kind] = _unknown_destroys.get(kind, 0) + 1
        else:
            _destroyed[kind] = _destroyed.get(kind, 0) + 1


def live(kind: Optional[str] = None) -> List[HandleRecord]:
    """Live handle records (optionally one kind), creation order."""
    with _mu:
        recs = [r for r in _live.values()
                if kind is None or r.kind == kind]
    return sorted(recs, key=lambda r: (r.kind, r.seq))


def live_counts() -> Dict[str, int]:
    """Live handles per kind (only kinds with nonzero counts)."""
    counts: Dict[str, int] = {}
    with _mu:
        for (kind, _h) in _live:
            counts[kind] = counts.get(kind, 0) + 1
    return counts


def stats() -> Dict[str, Dict[str, int]]:
    """Per-kind created/destroyed/unknown-destroy totals (diagnostics)."""
    with _mu:
        kinds = set(_created) | set(_destroyed) | set(_unknown_destroys)
        return {k: {"created": _created.get(k, 0),
                    "destroyed": _destroyed.get(k, 0),
                    "unknown_destroys": _unknown_destroys.get(k, 0)}
                for k in sorted(kinds)}


def clear() -> None:
    """Drop all records and counters (test isolation)."""
    with _mu:
        _live.clear()
        _created.clear()
        _destroyed.clear()
        _unknown_destroys.clear()


def report() -> str:
    """Human-readable leak report: every live handle with its creation
    stack (the LeakSanitizer output shape)."""
    recs = live()
    if not recs:
        return "handlecheck: no live handles"
    counts = live_counts()
    head = "handlecheck: live handles: " + ", ".join(
        f"{k}={v}" for k, v in sorted(counts.items()))
    return "\n\n".join([head] + [r.format() for r in recs])
