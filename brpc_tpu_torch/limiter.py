"""Server-side overload control: per-method adaptive concurrency
limiting.

The reference treats overload as a first-class server concern: every
method carries a ``MethodStatus`` whose ``OnRequested`` consults a
pluggable ``ConcurrencyLimiter`` — ``constant`` (a fixed
max_concurrency) or ``auto`` (the gradient/Vegas adaptive policy,
policy/auto_concurrency_limiter.cpp + docs/cn/auto_concurrency_limiter.md)
— and a request refused there answers ``ELIMIT`` (2004) WITHOUT touching
the handler (SURVEY §2.6).  This module is the Python tier's port,
mirrored field-for-field from the native scaffold
(``cpp/rpc/concurrency_limiter.h``) so both tiers shed by the same
policy:

- :class:`ConstantLimiter` — admit while inflight <= max.
- :class:`AutoLimiter` — sampled response windows estimate a no-load
  latency floor (EMA downward) and a peak qps (jump up, decay slowly);
  Little's law (``floor_latency x peak_qps``) times an explore ratio
  that widens while latency hugs the floor and narrows under queueing
  sets the limit; a randomized remeasure interval periodically pulls
  load down and re-measures the floor; an all-failed window halves the
  limit.  The clock is injectable (``clock_us``) so the whole state
  machine is testable without wall time.
- :class:`MethodGate` — one method's inflight counter + limiter + shed
  accounting: the ``MethodStatus::OnRequested`` analog the server
  trampolines call around every dispatch.
- :class:`ServerLimiter` — the per-method gate map a server installs
  (``rpc.Server.set_concurrency_limiter``); gates are created lazily
  per method (or restricted to an explicit method list), and every
  shed feeds ``<prefix>_shed`` / ``<prefix>_shed_<Method>`` counters
  so rejected traffic shows up in ``_status`` instead of vanishing.

The client-side story (mandatory backoff on ``ELIMIT``, breaker feeding
so sustained shedding trips the redirect path, deadline stamping) lives
in :mod:`brpc_tpu_torch.resilience` / :mod:`brpc_tpu_torch.ps_remote`; the traffic
harness that proves the whole loop is :mod:`brpc_tpu.press`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence

from brpc_tpu_torch import obs
from brpc_tpu_torch.analysis.race import checked_lock

__all__ = [
    "ELIMIT", "ConcurrencyLimiter", "ConstantLimiter", "AutoLimiter",
    "AutoOptions", "MethodGate", "ServerLimiter", "make_limiter",
]

#: concurrency limit reached (native errors.h) — the shed answer;
#: retriable WITH mandatory backoff (brpc_tpu_torch.resilience.RetryPolicy)
ELIMIT = 2004
#: deadline budget exhausted before the handler ran (EDEADLINE) —
#: shed outcomes are not a load signal, the limiter ignores both
_EDEADLINE = 2014


def _monotonic_us() -> int:
    return time.monotonic_ns() // 1000


class ConcurrencyLimiter:
    """Admission policy: ``on_requested(current)`` is consulted with the
    would-be inflight count (the caller has already incremented);
    ``on_responded`` feeds one completed request back."""

    def on_requested(self, current: int) -> bool:
        raise NotImplementedError

    def on_responded(self, error_code: int, latency_us: int) -> None:
        pass

    @property
    def max_concurrency(self) -> int:
        raise NotImplementedError


class ConstantLimiter(ConcurrencyLimiter):
    """Fixed ceiling (reference ``constant`` policy): ``max <= 0`` means
    unlimited (the off mode kept constructible for config tables)."""

    def __init__(self, max_concurrency: int):
        self._max = int(max_concurrency)

    def on_requested(self, current: int) -> bool:
        return self._max <= 0 or current <= self._max

    @property
    def max_concurrency(self) -> int:
        return self._max


@dataclasses.dataclass(frozen=True)
class AutoOptions:
    """Mirrors ``AutoLimiter::Options`` in
    cpp/rpc/concurrency_limiter.h (reference defaults,
    policy/auto_concurrency_limiter.cpp)."""

    initial_limit: int = 40          # warm-up ceiling
    min_limit: int = 4
    window_us: int = 1_000_000       # sample window duration
    min_samples: int = 20            # discard smaller windows
    max_samples: int = 200           # close early past this
    sample_interval_us: int = 100    # <=1 sample per interval
    ema_alpha: float = 0.1           # latency-floor smoothing
    max_explore: float = 0.3
    min_explore: float = 0.06
    explore_step: float = 0.02
    fail_punish: float = 1.0         # failed-latency weight
    remeasure_interval_us: int = 50 * 1_000_000
    remeasure_reduce: float = 0.9


class AutoLimiter(ConcurrencyLimiter):
    """Gradient/Vegas adaptive limiter — the Python twin of the native
    ``AutoLimiter`` (cpp/rpc/concurrency_limiter.h), same estimator,
    same windows, with an injectable microsecond clock so tests drive
    the state machine deterministically.

    The loop: responses are SAMPLED (at most one per
    ``sample_interval_us``) into a window that closes after
    ``window_us`` or ``max_samples`` and is discarded below
    ``min_samples``.  Each closed window updates a no-load latency
    floor (EMA, downward only) and a peak-qps estimate (jump up, decay
    slowly), then sets ``limit = floor_latency x peak_qps x
    (1 + explore)`` — Little's law with an explore ratio that walks up
    while the window's latency stays near the floor (probe for more)
    and down under queueing.  Periodically (randomized in [T/2, T)) the
    limit is pulled to ``remeasure_reduce x`` the estimate and the
    floor is re-measured at the resulting low load.  An all-failed
    window halves the limit.  Shed outcomes (``ELIMIT``/``EDEADLINE``)
    are the limiter's OWN output and never enter the estimator."""

    def __init__(self, options: Optional[AutoOptions] = None,
                 clock_us: Callable[[], int] = _monotonic_us):
        self.opt = options or AutoOptions()
        self._clock_us = clock_us
        self._limit = int(self.opt.initial_limit)
        self._explore = self.opt.max_explore
        self._mu = checked_lock("limiter.auto")
        self._last_sample_us = 0
        self._total_succ = 0
        self._win_start_us = 0
        self._win_succ = 0
        self._win_fail = 0
        self._win_succ_lat_us = 0
        self._win_fail_lat_us = 0
        self._min_latency_us = -1
        self._ema_max_qps = -1.0
        self._reset_at_us = 0
        self._remeasure_at_us = self._next_remeasure(clock_us())

    # -- admission (lock-free read: a stale limit admits/refuses one
    # request late, same contract as the native atomics) ---------------

    def on_requested(self, current: int) -> bool:
        return current <= self._limit

    @property
    def max_concurrency(self) -> int:
        return self._limit

    # -- feedback ------------------------------------------------------

    def on_responded(self, error_code: int, latency_us: int) -> None:
        if error_code in (ELIMIT, _EDEADLINE):
            return  # our own sheds are not a load signal
        now = self._clock_us()
        with self._mu:
            if error_code == 0:
                self._total_succ += 1
            # sampling interval: at most one response per interval
            # enters the window (bounds estimator work at high qps)
            if self._last_sample_us != 0 and \
                    now - self._last_sample_us < \
                    self.opt.sample_interval_us:
                return
            self._last_sample_us = now
            self._add_sample_locked(error_code, latency_us, now)

    # -- estimator (all under the lock) --------------------------------

    def _next_remeasure(self, now: int) -> int:
        # randomized in [T/2, T): herds of servers must not re-probe in
        # sync (the reference uses the same now-derived jitter)
        half = self.opt.remeasure_interval_us // 2
        return now + half + (now % (half if half > 0 else 1))

    def _add_sample_locked(self, error_code: int, latency_us: int,
                           now: int) -> None:
        if self._reset_at_us != 0:
            if self._reset_at_us > now:
                return  # draining to low load: ignore
            # low load reached: re-measure the floor from scratch
            self._min_latency_us = -1
            self._reset_at_us = 0
            self._remeasure_at_us = self._next_remeasure(now)
            self._reset_window(now)
        if self._win_start_us == 0:
            self._win_start_us = now
        if error_code != 0:
            self._win_fail += 1
            self._win_fail_lat_us += latency_us
        else:
            self._win_succ += 1
            self._win_succ_lat_us += latency_us
        n = self._win_succ + self._win_fail
        if n < self.opt.min_samples:
            if now - self._win_start_us >= self.opt.window_us:
                self._reset_window(now)
            return  # window too small (yet)
        if now - self._win_start_us < self.opt.window_us and \
                n < self.opt.max_samples:
            return  # window still open
        if self._win_succ > 0:
            self._update(now)
        else:
            self._set_limit(self._limit // 2)  # all failed
        self._reset_window(now)

    def _reset_window(self, now: int) -> None:
        self._total_succ = 0
        self._win_start_us = now
        self._win_succ = self._win_fail = 0
        self._win_succ_lat_us = self._win_fail_lat_us = 0

    def _set_limit(self, v: int) -> None:
        self._limit = max(self.opt.min_limit, int(v))

    def _update(self, now: int) -> None:
        punished = (float(self._win_fail_lat_us) * self.opt.fail_punish
                    + float(self._win_succ_lat_us))
        avg_lat = int(punished / float(self._win_succ)) + 1
        elapsed = max(1, now - self._win_start_us)
        qps = 1e6 * float(self._total_succ) / float(elapsed)
        # latency floor: EMA downward only
        if self._min_latency_us <= 0:
            self._min_latency_us = avg_lat
        elif avg_lat < self._min_latency_us:
            self._min_latency_us = int(
                float(avg_lat) * self.opt.ema_alpha
                + float(self._min_latency_us) * (1 - self.opt.ema_alpha))
        # peak qps: jump up, decay slowly
        if qps >= self._ema_max_qps:
            self._ema_max_qps = qps
        else:
            a = self.opt.ema_alpha / 10
            self._ema_max_qps = qps * a + self._ema_max_qps * (1 - a)
        if self._remeasure_at_us <= now:
            # pull load down and re-measure the floor once drained
            self._reset_at_us = now + avg_lat * 2
            self._set_limit(int(self._ema_max_qps
                                * float(self._min_latency_us) / 1e6
                                * self.opt.remeasure_reduce) + 1)
            return
        # explore walk: widen while latency hugs the floor (or qps sits
        # below peak — not limit-bound), narrow under queueing
        if float(avg_lat) <= float(self._min_latency_us) \
                * (1.0 + self.opt.min_explore) or \
                qps <= self._ema_max_qps / (1.0 + self.opt.min_explore):
            self._explore = min(self.opt.max_explore,
                                self._explore + self.opt.explore_step)
        else:
            self._explore = max(self.opt.min_explore,
                                self._explore - self.opt.explore_step)
        self._set_limit(int(float(self._min_latency_us)
                            * self._ema_max_qps / 1e6
                            * (1 + self._explore)) + 1)


def make_limiter(spec: Optional[str], *,
                 options: Optional[AutoOptions] = None,
                 clock_us: Callable[[], int] = _monotonic_us
                 ) -> Optional[ConcurrencyLimiter]:
    """Limiter factory over the config vocabulary shared with the
    native tier (``CreateConcurrencyLimiter``): ``"auto"``,
    ``"constant:<n>"``, and ``""``/``"none"``/``None`` → no limiter
    (unlimited).  A bare ``"constant"`` with no bound is the off mode
    too — a constant limiter needs its constant."""
    if spec is None or spec in ("", "none", "off"):
        return None
    if spec == "auto":
        return AutoLimiter(options, clock_us=clock_us)
    if spec.startswith("constant"):
        _, _, arg = spec.partition(":")
        maxc = int(arg) if arg else 0
        return ConstantLimiter(maxc) if maxc > 0 else None
    raise ValueError(f"unknown concurrency limiter spec {spec!r} "
                     f"(want 'auto', 'constant:<n>', or 'none')")


class MethodGate:
    """One method's admission gate: inflight counter + limiter + shed
    accounting (the ``MethodStatus`` analog).  ``admit()`` increments
    inflight and consults the limiter — a refusal decrements back and
    counts one shed; every admitted request must pair with exactly one
    ``on_responded`` carrying the outcome and handler latency."""

    __slots__ = ("method", "limiter", "_mu", "_inflight", "_shed",
                 "_prefix")

    def __init__(self, method: str, limiter: ConcurrencyLimiter,
                 counter_prefix: str = "rpc_server"):
        self.method = method
        self.limiter = limiter
        self._mu = checked_lock("limiter.gate")
        self._inflight = 0
        self._shed = 0
        self._prefix = counter_prefix

    def admit(self) -> bool:
        with self._mu:
            self._inflight += 1
            c = self._inflight
        if self.limiter.on_requested(c):
            return True
        with self._mu:
            self._inflight -= 1
            self._shed += 1
        if obs.enabled():
            obs.counter(f"{self._prefix}_shed").add(1)
            obs.counter(f"{self._prefix}_shed_{self.method}").add(1)
        return False

    def on_responded(self, error_code: int, latency_us: int) -> None:
        with self._mu:
            self._inflight -= 1
        self.limiter.on_responded(error_code, latency_us)

    @property
    def inflight(self) -> int:
        return self._inflight

    @property
    def shed(self) -> int:
        return self._shed

    @property
    def max_concurrency(self) -> int:
        return self.limiter.max_concurrency


class ServerLimiter:
    """The per-method gate map a server enforces (installed via
    ``rpc.Server.set_concurrency_limiter``).

    ``spec`` names the policy (``"auto"`` / ``"constant:<n>"``); each
    method gets its OWN limiter instance (per-method limiting, the
    reference's ``MethodStatus`` shape) created lazily on first
    dispatch — or restricted to ``methods`` when given, leaving
    everything else ungated (the PS servers gate the data plane and
    leave failover/migration control traffic admissible under
    overload).  ``counter_prefix`` names the shed counters
    (``ps_shed[_<Method>]`` on the shard servers)."""

    def __init__(self, spec: str = "auto", *,
                 methods: Optional[Sequence[str]] = None,
                 options: Optional[AutoOptions] = None,
                 clock_us: Callable[[], int] = _monotonic_us,
                 counter_prefix: str = "rpc_server"):
        make_limiter(spec, options=options, clock_us=clock_us)  # validate
        self.spec = spec
        self._options = options
        self._clock_us = clock_us
        self._methods = frozenset(methods) if methods is not None else None
        self._prefix = counter_prefix
        self._mu = checked_lock("limiter.server")
        self._gates: Dict[str, MethodGate] = {}

    def gate(self, method: str) -> Optional[MethodGate]:
        """The gate for ``method`` (None = ungated).  Lazy creation is
        double-checked so the steady state is one dict hit."""
        g = self._gates.get(method)
        if g is not None:
            return g
        if self._methods is not None and method not in self._methods:
            return None
        with self._mu:
            g = self._gates.get(method)
            if g is None:
                lim = make_limiter(self.spec, options=self._options,
                                   clock_us=self._clock_us)
                if lim is None:
                    return None
                g = MethodGate(method, lim, self._prefix)
                self._gates[method] = g
        return g

    def total_inflight(self) -> int:
        """Live admitted requests across every gate (the
        ``ps_inflight`` PassiveStatus)."""
        return sum(g.inflight for g in list(self._gates.values()))

    def max_concurrency(self) -> Dict[str, int]:
        """Current per-method limit (the adaptive gauge)."""
        return {m: g.max_concurrency
                for m, g in sorted(self._gates.items())}

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        return {m: {"inflight": g.inflight, "shed": g.shed,
                    "max_concurrency": g.max_concurrency}
                for m, g in sorted(self._gates.items())}
