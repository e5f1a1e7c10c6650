"""Dynamic lock-order race detector for the fiber/RPC fabric.

The reference ships runtime concurrency tooling alongside its scheduler —
the contention profiler (/contention), bthread diagnostics, sanitizer
annotations in the fiber runtime.  This module is the Python tier's
equivalent: every lock in ``rpc``, ``ps_remote``, and ``obs`` is created
through :func:`checked_lock`, and under ``BRPC_TPU_RACECHECK=1`` each one
becomes a :class:`CheckedLock` that feeds a per-process lock-order graph.

What the harness reports (``findings()`` / ``report()``):

- **lock-inversion** — acquiring lock ``B`` while holding ``A`` records the
  edge ``A→B``; if the graph already carries a path ``B→…→A`` the two
  orders can deadlock under the right interleaving, and the finding
  captures the acquisition stacks of BOTH edges.
- **blocking-call** — the native call sites (``Channel.call``, device
  staging/fetch/execute) report into :func:`note_blocking`; if the calling
  thread holds any checked lock at that point, the lock is serialized
  across a fiber-parking native call, which collapses handler concurrency.

When ``BRPC_TPU_RACECHECK`` is unset, :func:`checked_lock` returns a plain
``threading.Lock`` — the steady-state fabric carries zero extra overhead
(asserted by ``bench_analysis.py`` / ``tests/test_race_harness.py``).

Ordering edges are keyed by lock *name*, not instance: the fabric creates
many instances per name (every reducer has a ``_mu``), and it is the
cross-site ordering discipline that prevents deadlock.  Same-name nesting
is therefore not recorded as an edge.  Stacks are captured at FIRST
observation of an edge; repeat acquisitions only bump a counter.

:func:`checked_rwlock` is the readers/writer companion (used by the PS
read-parallel serving path): off mode returns a plain :class:`RWLock`
(``with rw.read():`` shares, ``with rw.write():`` excludes), checked mode
a :class:`CheckedRWLock` whose BOTH sides feed the order graph and the
blocking-call report under the lock's one name — a read-side hold across
an inverted write-side hold deadlocks just the same.

**Sampling mode** (``BRPC_TPU_RACECHECK_SAMPLE=N`` or
:func:`set_sample`): the checked-mode cost per acquire is almost all
stack capture.  Under sampling only every Nth acquisition per lock
captures its stack eagerly — but the FIRST observation of a new ordering
edge always captures the acquiring stack (lazily, at edge-record time),
so the order graph itself stays exact: sampling degrades stack
*context* on repeat acquisitions (shown as a placeholder), never edge or
cycle detection.  ``bench_analysis.py`` records the sampled overhead.

This module imports only the stdlib — it sits below ``obs`` and ``rpc``
in the dependency order, never above.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "checked_lock", "checked_rwlock", "enabled", "set_enabled",
    "CheckedLock", "CheckedRWLock", "RWLock", "note_blocking", "findings",
    "clear", "report", "Finding", "sample_every", "set_sample",
]

_override: Optional[bool] = None
_sample_override: Optional[int] = None

#: held-stack placeholder for acquisitions whose capture was sampled out
SAMPLED_OUT = ("<stack not captured: sampled out — lower "
               "BRPC_TPU_RACECHECK_SAMPLE for full context>\n")


def enabled() -> bool:
    """True when lock checking is on (``set_enabled`` override first,
    else the ``BRPC_TPU_RACECHECK`` env var)."""
    if _override is not None:
        return _override
    return os.environ.get("BRPC_TPU_RACECHECK", "") not in (
        "", "0", "false", "off")


def set_enabled(on: Optional[bool]) -> None:
    """Force checking on/off for this process (``None`` restores the env
    var's verdict).  Affects locks created AFTER the call."""
    global _override
    _override = on


_sample_env_cache: Optional[int] = None


def sample_every() -> int:
    """Stack-capture sampling period: 1 = capture every acquisition
    (full-fidelity), N>1 = capture every Nth per lock
    (``set_sample`` override first, else ``BRPC_TPU_RACECHECK_SAMPLE``).
    The env var is parsed once and cached — this runs on every
    acquisition."""
    global _sample_env_cache
    if _sample_override is not None:
        return max(_sample_override, 1)
    if _sample_env_cache is None:
        try:
            _sample_env_cache = max(
                int(os.environ.get("BRPC_TPU_RACECHECK_SAMPLE", "1")), 1)
        except ValueError:
            _sample_env_cache = 1
    return _sample_env_cache


def set_sample(n: Optional[int]) -> None:
    """Force the sampling period for this process (``None`` restores the
    env var's verdict and re-reads it).  Takes effect on the next
    acquisition."""
    global _sample_override, _sample_env_cache
    _sample_override = n
    _sample_env_cache = None


@dataclasses.dataclass
class Finding:
    kind: str                 # "lock-inversion" | "blocking-call"
    locks: List[str]          # cycle path, or held locks at a blocking call
    message: str
    stacks: Dict[str, str]    # label -> formatted acquisition stack

    def format(self) -> str:
        out = [f"[{self.kind}] {self.message}"]
        for label, stack in self.stacks.items():
            out.append(f"  --- {label} ---")
            out.extend("  " + ln for ln in stack.rstrip().splitlines())
        return "\n".join(out)


# Graph state.  _state_mu is a plain lock and the ONLY lock the harness
# itself takes; nothing inside its critical sections can re-enter the
# checked path.
_state_mu = threading.Lock()
_adj: Dict[str, Set[str]] = {}
_edge_stacks: Dict[Tuple[str, str], Tuple[str, str]] = {}
_findings: List[Finding] = []
_tls = threading.local()


def _held() -> List[Tuple[str, str]]:
    """This thread's (lock name, acquisition stack) list, outermost first."""
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _stack(skip: int = 2) -> str:
    return "".join(traceback.format_stack()[:-skip])


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """DFS path src -> dst in the order graph (None when unreachable)."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _adj.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _note_acquire_intent(name: str,
                         acq_stack: Optional[str]) -> Optional[str]:
    """Record ordering edges BEFORE blocking on the lock, so a real
    deadlock still gets its inversion reported.  ``acq_stack`` is None
    when this acquisition was sampled out; a NEW edge then captures the
    stack lazily (first observation of an edge is always captured).
    Returns the stack actually recorded (still None when nothing needed
    it)."""
    held = _held()
    if not held:
        return acq_stack
    with _state_mu:
        for held_name, held_stack in held:
            if held_name == name:
                continue  # sibling instances of one name: not an ordering
            edge = (held_name, name)
            if edge in _edge_stacks:
                continue
            if acq_stack is None:
                # sampled out, but this edge is new: capture after all
                acq_stack = _stack(skip=3)
            # New edge: does the reverse direction already exist?
            cycle = _find_path(name, held_name)
            _adj.setdefault(held_name, set()).add(name)
            _edge_stacks[edge] = (held_stack, acq_stack)
            if cycle is None:
                continue
            rev_stacks = _edge_stacks.get(
                (cycle[0], cycle[1]), ("<unrecorded>", "<unrecorded>"))
            _findings.append(Finding(
                kind="lock-inversion",
                locks=[held_name] + cycle,
                message=(
                    f"acquiring '{name}' while holding '{held_name}' "
                    f"closes the lock-order cycle "
                    f"{' -> '.join([held_name] + cycle)} (potential "
                    f"deadlock)"),
                stacks={
                    f"'{held_name}' held here": held_stack,
                    f"'{name}' acquired here (this order)": acq_stack,
                    f"'{cycle[0]}' held here (opposite order)":
                        rev_stacks[0],
                    f"'{cycle[1]}' acquired here (opposite order)":
                        rev_stacks[1],
                },
            ))
    return acq_stack


class CheckedLock:
    """``threading.Lock`` work-alike that feeds the lock-order graph."""

    __slots__ = ("name", "_lock", "_acquires")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._acquires = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        n = sample_every()
        self._acquires += 1
        # Stack capture is ~the whole checked-mode cost; under sampling
        # only every Nth acquisition (and the first) pays it eagerly.
        acq_stack = _stack(skip=2) if n <= 1 or \
            self._acquires % n == 1 else None
        acq_stack = _note_acquire_intent(self.name, acq_stack)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _held().append((self.name,
                            acq_stack if acq_stack is not None
                            else SAMPLED_OUT))
        return ok

    def release(self) -> None:
        self._lock.release()
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == self.name:
                del held[i]
                break

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "CheckedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<CheckedLock {self.name!r} locked={self.locked()}>"


def checked_lock(name: str):
    """The fabric's lock factory.  Plain ``threading.Lock`` when checking
    is off (zero steady-state overhead); a named :class:`CheckedLock`
    under ``BRPC_TPU_RACECHECK=1``."""
    if not enabled():
        return threading.Lock()
    return CheckedLock(name)


class _ReaderSide:
    """Reusable ``with rw.read():`` context (state-free: safe to share
    across concurrent holders)."""

    __slots__ = ("_rw",)

    def __init__(self, rw: "RWLock"):
        self._rw = rw

    def __enter__(self) -> "_ReaderSide":
        self._rw.acquire_read()
        return self

    def __exit__(self, *exc) -> None:
        self._rw.release_read()


class _WriterSide:
    __slots__ = ("_rw",)

    def __init__(self, rw: "RWLock"):
        self._rw = rw

    def __enter__(self) -> "_WriterSide":
        self._rw.acquire_write()
        return self

    def __exit__(self, *exc) -> None:
        self._rw.release_write()


class RWLock:
    """Write-preferring readers/writer lock — the Python-tier analog of
    ``cpp/fiber/sync.h`` FiberRWLock.  ``with rw.read():`` shares with
    other readers; ``with rw.write():`` excludes everyone.  Pending
    writers block NEW readers so a read stream cannot starve a writer.
    Non-reentrant on both sides, like ``threading.Lock``."""

    __slots__ = ("_cond", "_readers", "_writer", "_wwaiters", "_r", "_w")

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._readers = 0
        self._writer = False
        self._wwaiters = 0
        self._r = _ReaderSide(self)
        self._w = _WriterSide(self)

    def read(self) -> _ReaderSide:
        return self._r

    def write(self) -> _WriterSide:
        return self._w

    def acquire_read(self) -> None:
        with self._cond:
            while self._writer or self._wwaiters:
                self._cond.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if not self._readers:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            self._wwaiters += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._wwaiters -= 1
            self._writer = True

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()


class _CheckedSide:
    """One side of a :class:`CheckedRWLock` (state-free, shared)."""

    __slots__ = ("_owner", "_write")

    def __init__(self, owner: "CheckedRWLock", write: bool):
        self._owner = owner
        self._write = write

    def __enter__(self) -> "_CheckedSide":
        self._owner._enter(self._write)
        return self

    def __exit__(self, *exc) -> None:
        self._owner._exit(self._write)


class CheckedRWLock:
    """:class:`RWLock` work-alike whose read AND write sides feed the
    lock-order graph under the lock's one name — ordering edges are keyed
    by name (see module docstring), and splitting the sides would hide
    inversions between a reader and a writer of the same lock.  Sampling
    behaves exactly as on :class:`CheckedLock`."""

    __slots__ = ("name", "_rw", "_acquires")

    def __init__(self, name: str):
        self.name = name
        self._rw = RWLock()
        self._acquires = 0

    def read(self) -> _CheckedSide:
        return _CheckedSide(self, False)

    def write(self) -> _CheckedSide:
        return _CheckedSide(self, True)

    def _enter(self, write: bool) -> None:
        n = sample_every()
        self._acquires += 1
        acq_stack = _stack(skip=3) if n <= 1 or \
            self._acquires % n == 1 else None
        acq_stack = _note_acquire_intent(self.name, acq_stack)
        if write:
            self._rw.acquire_write()
        else:
            self._rw.acquire_read()
        _held().append((self.name,
                        acq_stack if acq_stack is not None
                        else SAMPLED_OUT))

    def _exit(self, write: bool) -> None:
        if write:
            self._rw.release_write()
        else:
            self._rw.release_read()
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == self.name:
                del held[i]
                break

    def __repr__(self) -> str:
        return f"<CheckedRWLock {self.name!r}>"


def checked_rwlock(name: str):
    """Readers/writer companion of :func:`checked_lock`: a plain
    :class:`RWLock` when checking is off, a named :class:`CheckedRWLock`
    under ``BRPC_TPU_RACECHECK=1``.  Both sides participate in the order
    graph and in :func:`note_blocking` held-lock reporting."""
    if not enabled():
        return RWLock()
    return CheckedRWLock(name)


def note_blocking(what: str) -> None:
    """Called by native-boundary call sites (``brt_*`` wrappers) under
    RACECHECK: flags any checked lock held across the blocking call —
    the fiber worker parks inside the native core while every other
    handler contends on the held lock."""
    held = _held()
    if not held:
        return
    names = [n for n, _ in held]
    site = _stack(skip=2)
    with _state_mu:
        for f in _findings:
            # One finding per (call, held-set) shape keeps reruns bounded.
            if f.kind == "blocking-call" and f.locks == names \
                    and what in f.message:
                return
        _findings.append(Finding(
            kind="blocking-call",
            locks=list(names),
            message=(f"lock(s) {names} held across blocking native call "
                     f"{what} — serializes fiber workers"),
            stacks={f"{what} called here": site,
                    f"'{names[-1]}' held here": held[-1][1]},
        ))


def findings() -> List[Finding]:
    with _state_mu:
        return list(_findings)


def clear() -> None:
    """Drop the order graph and findings (test isolation). Held-lock
    tracking in live threads is untouched."""
    with _state_mu:
        _adj.clear()
        _edge_stacks.clear()
        _findings.clear()


def report() -> str:
    fs = findings()
    if not fs:
        return "racecheck: no findings"
    return "\n\n".join(f.format() for f in fs)
