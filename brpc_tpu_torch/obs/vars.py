"""bvar-semantics metrics core (reference src/bvar/, SURVEY §2.3).

The reference's bvar layer is write-mostly optimized: each writer thread
mutates a thread-local agent with no synchronization, and readers combine
agents on demand (``Reducer::get_value`` walks the agent list).  The same
shape here: ``Adder``/``Maxer``/``Miner`` write to a per-thread cell (a
one-element list — plain attribute stores under the GIL, no lock on the
hot path) and fold across cells on read.

Windowed views (``Window``, ``PerSecond``) mirror bvar's sampler: one
sample per second of the underlying reducer, kept in a bounded deque.
Instead of a sampler thread, samples are taken lazily on read against an
injectable ``clock`` (tests drive a fake clock; production uses
``time.monotonic``).  For invertible ops (Adder) the window value is
``newest - oldest``; for non-invertible ops (Maxer/Miner) each sample is
taken with get-and-reset and the window folds the per-second samples, the
reference's ReducerSampler behaviour for ops without an inverse.

``LatencyRecorder`` is the composite the reference ships for RPC paths:
count, qps, average, max, and p50/p90/p99/p999 from a fixed log-scale
bucket histogram — ``record()`` does one log10 and one slot increment, no
per-sample allocation.

Everything is pure Python + numpy: importable and testable with no native
build present.
"""

from __future__ import annotations

import fnmatch
import itertools
import math
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from brpc_tpu_torch.analysis.race import checked_lock

__all__ = [
    "Variable", "Adder", "Maxer", "Miner", "PassiveStatus", "Window",
    "PerSecond", "LatencyRecorder", "Registry", "default_registry",
    "expose", "dump_exposed", "dump_exposed_dict",
]


class Variable:
    """Anything dumpable by name (reference src/bvar/variable.h:83)."""

    def get_value(self):
        raise NotImplementedError

    def describe(self) -> str:
        v = self.get_value()
        if isinstance(v, float):
            return f"{v:.6g}"
        return str(v)

    def expose(self, name: str, registry: "Optional[Registry]" = None
               ) -> "Variable":
        (registry or default_registry()).expose(name, self)
        return self


class _TlsReducer(Variable):
    """Thread-local-agent reducer: writes touch only this thread's cell."""

    #: fold across agent cells (and across window samples)
    _OP: Callable = None
    #: value of a cell no thread has written yet
    _IDENTITY = 0
    #: True when _OP has an inverse (window value = newest - oldest)
    _INVERTIBLE = False

    def __init__(self):
        self._local = threading.local()
        self._mu = checked_lock("obs.reducer")
        self._cells: List[list] = []        # all threads' [value] cells
        self._retired = self._IDENTITY      # folded cells of reset() epochs

    def _cell(self) -> list:
        cell = getattr(self._local, "cell", None)
        if cell is None:
            cell = [self._IDENTITY]
            with self._mu:
                self._cells.append(cell)
            self._local.cell = cell
        return cell

    def get_value(self):
        with self._mu:
            acc = self._retired
            for cell in self._cells:
                acc = self._OP(acc, cell[0])
        return acc

    def reset(self):
        """Zero the reducer (best-effort under concurrent writers)."""
        with self._mu:
            self._retired = self._IDENTITY
            for cell in self._cells:
                cell[0] = self._IDENTITY

    def _take_window_sample(self):
        """One per-second sample for Window.

        Invertible ops return the running value (Window subtracts);
        non-invertible ops return value-and-reset (Window folds samples),
        matching the reference sampler split on ``Op::has_inverse``.
        """
        if self._INVERTIBLE:
            return self.get_value()
        with self._mu:
            acc = self._retired
            self._retired = self._IDENTITY
            for cell in self._cells:
                acc = self._OP(acc, cell[0])
                cell[0] = self._IDENTITY
        return acc


class Adder(_TlsReducer):
    """Cumulative sum (bvar::Adder). ``add``/``<<`` are the hot path."""

    _OP = staticmethod(lambda a, b: a + b)
    _IDENTITY = 0
    _INVERTIBLE = True

    def add(self, v=1):
        cell = getattr(self._local, "cell", None) or self._cell()
        cell[0] += v

    def __lshift__(self, v):
        self.add(v)
        return self


class Maxer(_TlsReducer):
    """Running maximum (bvar::Maxer)."""

    _OP = staticmethod(max)
    _IDENTITY = float("-inf")
    _INVERTIBLE = False

    def update(self, v):
        cell = getattr(self._local, "cell", None) or self._cell()
        if v > cell[0]:
            cell[0] = v

    __lshift__ = update

    def get_value(self):
        v = super().get_value()
        return 0 if v == float("-inf") else v


class Miner(_TlsReducer):
    """Running minimum (bvar::Miner)."""

    _OP = staticmethod(min)
    _IDENTITY = float("inf")
    _INVERTIBLE = False

    def update(self, v):
        cell = getattr(self._local, "cell", None) or self._cell()
        if v < cell[0]:
            cell[0] = v

    __lshift__ = update

    def get_value(self):
        v = super().get_value()
        return 0 if v == float("inf") else v


class PassiveStatus(Variable):
    """Value computed on read (bvar::PassiveStatus) — e.g. queue depth."""

    def __init__(self, fn: Callable[[], object]):
        self._fn = fn

    def get_value(self):
        return self._fn()


class Window(Variable):
    """Value of a reducer over the last ``window_size`` seconds.

    Samples lazily on read: every whole second elapsed on ``clock`` since
    the last read pushes one sample.  A read gap longer than the window
    attributes the gap's activity to its final second — the price of not
    running a sampler thread; heavy paths read at least once per dump.
    """

    def __init__(self, reducer: _TlsReducer, window_size: int = 10,
                 clock: Callable[[], float] = time.monotonic):
        if window_size <= 0:
            raise ValueError("window_size must be positive")
        self._reducer = reducer
        self.window_size = window_size
        self._clock = clock
        self._mu = checked_lock("obs.window")
        # invertible: cumulative samples, newest-oldest is the window value;
        # keep window_size+1 so the diff spans exactly window_size seconds.
        self._samples: deque = deque(maxlen=window_size + 1)
        self._last = clock()
        self._samples.append(reducer._take_window_sample())

    def _catch_up(self):
        now = self._clock()
        missed = int(now - self._last)
        if missed <= 0:
            return
        self._last += missed
        sample = self._reducer._take_window_sample()
        if self._reducer._INVERTIBLE:
            for _ in range(min(missed, self._samples.maxlen)):
                self._samples.append(sample)
        else:
            # Identity-pad the quiet seconds first so the real sample lands
            # in the newest slot and survives a gap longer than the window.
            for _ in range(min(missed, self._samples.maxlen) - 1):
                self._samples.append(self._reducer._IDENTITY)
            self._samples.append(sample)

    def get_value(self):
        with self._mu:
            self._catch_up()
            if self._reducer._INVERTIBLE:
                return self._samples[-1] - self._samples[0]
            acc = self._reducer._IDENTITY
            for s in itertools.islice(self._samples, 1, None):
                acc = self._reducer._OP(acc, s)
            if acc == self._reducer._IDENTITY and not isinstance(acc, int):
                return 0  # Maxer/Miner with no samples in window
            return acc

    def elapsed(self) -> float:
        """Seconds actually covered by the stored samples (≤ window_size)."""
        with self._mu:
            self._catch_up()
            return max(len(self._samples) - 1, 1)


class PerSecond(Window):
    """Windowed rate: window delta divided by seconds covered
    (bvar::PerSecond — qps when the reducer counts calls)."""

    def get_value(self):
        covered = self.elapsed()
        with self._mu:
            if self._reducer._INVERTIBLE:
                delta = self._samples[-1] - self._samples[0]
            else:
                raise TypeError("PerSecond requires an invertible reducer")
        return delta / covered


# ---------------------------------------------------------------------------
# Latency recorder: log-scale fixed-bucket histogram
# ---------------------------------------------------------------------------

_BUCKETS_PER_DECADE = 20
_DECADES = 9            # 0.1us .. 10^8 us (100 s)
_NBUCKETS = _BUCKETS_PER_DECADE * _DECADES
_LOG_MIN = -1.0         # log10(0.1us)
# Geometric midpoint of each bucket, in microseconds (for percentiles).
_BUCKET_MID_US = np.power(
    10.0, _LOG_MIN + (np.arange(_NBUCKETS) + 0.5) / _BUCKETS_PER_DECADE)


class LatencyRecorder(Variable):
    """count / qps / avg / max / p50 p90 p99 p999 for one timed path.

    ``record(seconds)`` is the hot path: one log10, one histogram slot
    increment, two adder writes — no allocation.  Latencies are reported
    in microseconds (the reference's unit).  Relative percentile error is
    bounded by the bucket width: 10^(1/20) ≈ ±12%.
    """

    def __init__(self, window_size: int = 10,
                 clock: Callable[[], float] = time.monotonic):
        self._count = Adder()
        self._sum_us = Adder()
        self._max = Maxer()
        self._qps = PerSecond(self._count, window_size, clock)
        # plain list, not numpy: a scalar ndarray increment is ~3x the cost
        # of a list slot increment, and this is the hot path
        self._hist = [0] * _NBUCKETS
        self._hmu = checked_lock("obs.latency_hist")

    def record(self, seconds: float):
        us = seconds * 1e6
        if us < 0.1:
            idx = 0
        else:
            idx = int((math.log10(us) - _LOG_MIN) * _BUCKETS_PER_DECADE)
            if idx >= _NBUCKETS:
                idx = _NBUCKETS - 1
        with self._hmu:
            self._hist[idx] += 1
        self._count.add(1)
        self._sum_us.add(us)
        self._max.update(us)

    def record_bulk(self, seconds: float, n: int):
        """Fold ``n`` samples of the same latency in one shot.  For
        draining counters maintained OUTSIDE Python (e.g. the native
        Lookup path's sum/count pair): the per-sample distribution is
        gone by then, so all ``n`` land in one bucket at their mean."""
        if n <= 0:
            return
        us = seconds * 1e6
        if us < 0.1:
            idx = 0
        else:
            idx = int((math.log10(us) - _LOG_MIN) * _BUCKETS_PER_DECADE)
            if idx >= _NBUCKETS:
                idx = _NBUCKETS - 1
        with self._hmu:
            self._hist[idx] += n
        self._count.add(n)
        self._sum_us.add(us * n)
        self._max.update(us)

    @property
    def count(self) -> int:
        return self._count.get_value()

    @property
    def qps(self) -> float:
        return self._qps.get_value()

    @property
    def avg_us(self) -> float:
        n = self._count.get_value()
        return self._sum_us.get_value() / n if n else 0.0

    @property
    def max_us(self) -> float:
        return self._max.get_value()

    def percentile(self, q: float) -> float:
        """q in (0, 1]; returns the bucket-midpoint latency in us."""
        with self._hmu:
            hist = np.asarray(self._hist)
        total = int(hist.sum())
        if total == 0:
            return 0.0
        rank = max(int(math.ceil(q * total)), 1)
        cdf = np.cumsum(hist)
        idx = int(np.searchsorted(cdf, rank))
        return float(_BUCKET_MID_US[idx])

    def get_value(self):
        return {
            "count": self.count,
            "qps": round(self.qps, 3),
            "avg_us": round(self.avg_us, 3),
            "max_us": round(self.max_us, 3),
            "p50_us": round(self.percentile(0.50), 3),
            "p90_us": round(self.percentile(0.90), 3),
            "p99_us": round(self.percentile(0.99), 3),
            "p999_us": round(self.percentile(0.999), 3),
        }

    def describe(self) -> str:
        v = self.get_value()
        return (f"count={v['count']} qps={v['qps']} avg_us={v['avg_us']} "
                f"max_us={v['max_us']} p50={v['p50_us']} p90={v['p90_us']} "
                f"p99={v['p99_us']} p999={v['p999_us']}")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

class Registry:
    """Named, exposed variables — the ``/vars`` page's backing store
    (reference Variable::expose + dump_exposed, src/bvar/variable.cpp)."""

    def __init__(self):
        self._mu = checked_lock("obs.registry")
        self._vars: Dict[str, Variable] = {}

    def expose(self, name: str, var: Variable) -> Variable:
        with self._mu:
            self._vars[name] = var
        return var

    def hide(self, name: str) -> None:
        with self._mu:
            self._vars.pop(name, None)

    def clear(self) -> None:
        with self._mu:
            self._vars.clear()

    def _select(self, filter) -> List[Tuple[str, Variable]]:
        with self._mu:
            items = sorted(self._vars.items())
        if filter is None or filter == "":
            return items
        if callable(filter):
            return [(n, v) for n, v in items if filter(n)]
        if any(ch in filter for ch in "*?["):
            return [(n, v) for n, v in items if fnmatch.fnmatch(n, filter)]
        return [(n, v) for n, v in items if filter in n]

    def dump_exposed(self, filter=None) -> str:
        """bRPC /vars text: one ``name : value`` line per variable.
        ``filter``: None (all), substring, glob, or predicate."""
        return "\n".join(f"{n} : {v.describe()}"
                         for n, v in self._select(filter))

    def dump_exposed_dict(self, filter=None) -> Dict[str, object]:
        return {n: v.get_value() for n, v in self._select(filter)}

    def __contains__(self, name: str) -> bool:
        with self._mu:
            return name in self._vars

    def names(self) -> List[str]:
        with self._mu:
            return sorted(self._vars)


_default_registry = Registry()


def default_registry() -> Registry:
    return _default_registry


def expose(name: str, var: Variable) -> Variable:
    return _default_registry.expose(name, var)


def dump_exposed(filter=None) -> str:
    return _default_registry.dump_exposed(filter)


def dump_exposed_dict(filter=None) -> Dict[str, object]:
    return _default_registry.dump_exposed_dict(filter)
