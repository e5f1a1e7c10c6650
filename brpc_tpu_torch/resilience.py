"""Fault-tolerance tier: retry policy, backup requests, circuit breaker,
health-check revival.

The reference treats failure handling as a first-class RPC concern —
``RetryPolicy::DoRetry`` with excluded-server backoff (retry_policy.h:28),
timer-fired backup requests (controller.cpp:337), per-node
``CircuitBreaker`` EMA windows feeding ``ExcludedServers``
(circuit_breaker.h:25-48) with a ``ClusterRecoverPolicy`` safety valve,
and periodic health-check revival (details/health_check.cpp:146).  This
module is the Python tier's equivalent, layered over the native fabric:

- :class:`Backoff` — exponential backoff with DETERMINISTIC jitter (a
  seeded hash, not ``random``): the same seed yields the same delay
  sequence, so tests and fault-injection runs are reproducible.  It is
  also the package's one sanctioned blocking-sleep site
  (:func:`sleep_ms`) — the ``fiber-blocking-sleep`` lint check flags bare
  ``time.sleep`` anywhere handler-reachable and points here.
- :class:`RetryPolicy` + :func:`call_with_retry` — retriable-error
  classification over the native error space (transport/timeout errors
  retry, application errors don't) under a per-call *deadline budget*:
  every attempt's native timeout is the REMAINING budget, and backoff
  sleeps are capped by it, so the retry loop can never exceed the
  caller's total deadline.
- :func:`backup_call` — hedged requests: if the primary attempt has not
  answered within ``backup_ms``, a second attempt is started; the first
  completion wins and the loser is cancelled via the native
  ``brt_call_cancel`` (reference ``StartCancel``).  A completed-but-
  failed attempt yields to the other one (hedging is for availability,
  not fail-fast).
- :class:`CircuitBreaker` / :class:`BreakerRegistry` — per-endpoint
  long+short EMA error windows over an injectable clock;
  open / half-open / closed states; isolation duration doubles with
  consecutive isolations; the registry's cluster-recover guard refuses
  an isolation that would leave fewer than ``min_working`` endpoints
  serving (never isolate every shard).
- :class:`HealthProber` — a background fiber probing isolated endpoints
  through the ``_status`` builtin's ``health`` method and reviving them
  on success (``probe_once()`` is public so tests drive it
  deterministically).

This module never imports :mod:`brpc_tpu_torch.rpc` at module level — ``rpc``
imports it for ``Channel.call``'s resilience kwargs, so the dependency
points downward; ``RpcError`` is imported lazily inside functions.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from brpc_tpu_torch import obs
from brpc_tpu_torch import wire as _wire
from brpc_tpu_torch.analysis import race as _race
from brpc_tpu_torch.analysis.race import checked_lock

__all__ = [
    "Backoff", "sleep_ms", "RetryPolicy", "RETRIABLE_CODES",
    "EBREAKEROPEN", "ENOTPRIMARY", "EFENCED", "EMIGRATING",
    "ESCHEMEMOVED", "EBADFRAME", "ELIMIT", "EDEADLINE",
    "call_with_retry",
    "backup_call", "resilient_call", "BreakerOptions", "CircuitBreaker",
    "BreakerRegistry", "HealthProber", "ReplicaScorer",
    "default_registry", "set_default_registry", "health_components",
]

#: python-side error code for a breaker fast-fail (outside the native
#: errors.h space — the call never reached the wire)
EBREAKEROPEN = 2008
#: a write reached a replica that is not (or no longer) the primary for
#: its row range — the caller should re-resolve/promote and re-route
ENOTPRIMARY = 2009
#: a replication message carried a stale fencing epoch: a newer primary
#: exists and the sender must demote itself (never retriable — retrying
#: the same epoch yields the same rejection)
EFENCED = 2010
#: the shard is still IMPORTING its row range (a resharding migration
#: destination before cutover completes): reads should fall back to
#: another partition scheme, writes should wait out the cutover window
EMIGRATING = 2011
#: the shard's partition scheme was retired by a fenced cutover: the
#: caller holds a stale scheme and must refresh its routing (the
#: redirect error that drives client scheme refresh during a live
#: reshard — never retriable against the same scheme)
ESCHEMEMOVED = 2012
#: a malformed frame was rejected by a wire-contract guard before any
#: allocation or state mutation (:mod:`brpc_tpu_torch.wire`) — never
#: retriable: the same bytes parse the same way twice
EBADFRAME = _wire.EBADFRAME
#: the server's concurrency limiter shed the request before the handler
#: ran (native errors.h ELIMIT; brpc_tpu_torch.limiter) — transient by
#: definition, but retriable ONLY with a mandatory backoff: an
#: immediate re-issue lands straight back in the overload that shed it
ELIMIT = 2004
#: the request's propagated deadline budget was exhausted before the
#: handler started (the server shed queued work it could no longer
#: finish in time) — never retriable: the caller's budget is gone, and
#: the answer the retry would fetch is already too late
EDEADLINE = 2014

#: native error codes worth retrying: the request may never have reached
#: the server, or the failure is transient by construction.  Application
#: errors (EINTERNAL 2001, EREQUEST, ENOSERVICE/ENOMETHOD, EAUTH,
#: ERESPONSE, EHTTP), cancellation (2005) and breaker fast-fails are NOT
#: retriable — repeating them burns budget for the same answer.
RETRIABLE_CODES = frozenset({
    -1,     # local transport failure before an error code existed
    1005,   # ETOOMANYFAILS (combo sub-channel failures)
    1008,   # ERPCTIMEDOUT
    1009,   # EFAILEDSOCKET (connection broke mid-call)
    1011,   # EOVERCROWDED (buffered-write pressure)
    2003,   # ELOGOFF (server stopping — another endpoint may serve)
    2004,   # ELIMIT (concurrency limit — transient by definition)
})


def _rpc_error(code: int, text: str):
    from brpc_tpu_torch.rpc import RpcError  # lazy: rpc imports this module
    return RpcError(code, text)


# ---------------------------------------------------------------------------
# backoff (the shared, deterministic-jitter helper)
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def _hash01(seed: int, n: int) -> float:
    """Deterministic uniform-ish [0,1) from (seed, n) — splitmix64
    finalizer, no ``random`` state anywhere."""
    h = (seed * 0x9E3779B97F4A7C15 + (n + 1) * 0xBF58476D1CE4E5B9) & _MASK64
    h ^= h >> 30
    h = (h * 0xBF58476D1CE4E5B9) & _MASK64
    h ^= h >> 27
    h = (h * 0x94D049BB133111EB) & _MASK64
    h ^= h >> 31
    return (h % 1_000_000) / 1_000_000.0


@dataclasses.dataclass(frozen=True)
class Backoff:
    """Exponential backoff with deterministic downward jitter.

    ``delay_ms(attempt)`` is a pure function of ``(seed, attempt)``:
    ``min(max_ms, base_ms * multiplier**attempt)`` scaled into
    ``[1 - jitter, 1]`` by the seeded hash.  Jitter only ever SHRINKS the
    delay, so ``delay_ms`` is also an upper bound — deadline-budget
    arithmetic stays simple.
    """

    base_ms: float = 20.0
    multiplier: float = 2.0
    max_ms: float = 2000.0
    jitter: float = 0.5
    seed: int = 0

    def delay_ms(self, attempt: int) -> float:
        raw = min(self.max_ms, self.base_ms * self.multiplier ** attempt)
        if self.jitter <= 0.0:
            return raw
        return raw * (1.0 - self.jitter * _hash01(self.seed, attempt))


def sleep_ms(ms: float, *, sleep: Callable[[float], None] = time.sleep
             ) -> None:
    """The sanctioned blocking sleep for backoff waits (injectable for
    tests; the ``fiber-blocking-sleep`` lint check routes handler-
    reachable sleeps here)."""
    if ms > 0:
        sleep(ms / 1000.0)


# ---------------------------------------------------------------------------
# retry policy + deadline-budget retry loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retriable-error classification + backoff schedule (reference
    ``RetryPolicy::DoRetry``, retry_policy.h:28).  ``max_attempts``
    counts the first try: 3 means at most 2 retries.

    ``attempt_timeout_ms`` caps any SINGLE attempt's native timeout
    below the total deadline budget — without it, one black-holed
    attempt (lost request, dead peer) eats the whole budget and the
    retries the budget was supposed to buy never run.

    ``limit_backoff_floor_ms`` is the MANDATORY minimum backoff before
    retrying an ``ELIMIT`` shed: a limiter rejection is proof the
    server is past capacity right now, and an immediate re-issue (a
    zero-base backoff, a jittered-to-nothing delay) just feeds the
    overload it bounced off.  The floor still yields to the caller's
    total deadline budget — it raises the sleep, never the deadline."""

    max_attempts: int = 3
    retriable: frozenset = RETRIABLE_CODES
    backoff: Backoff = Backoff()
    attempt_timeout_ms: Optional[float] = None
    limit_backoff_floor_ms: float = 5.0

    def retry_delay_ms(self, exc: BaseException, attempt: int) -> float:
        """The backoff before retrying ``attempt``'s failure: the
        schedule's delay, floored at ``limit_backoff_floor_ms`` for
        ``ELIMIT`` sheds (counted in ``rpc_limit_backoffs``)."""
        delay = self.backoff.delay_ms(attempt)
        if getattr(exc, "code", None) == ELIMIT:
            delay = max(delay, self.limit_backoff_floor_ms)
            if obs.enabled():
                obs.counter("rpc_limit_backoffs").add(1)
        return delay

    def cap_attempt_timeout(
            self, timeout_ms: Optional[int]) -> Optional[int]:
        if self.attempt_timeout_ms is None:
            return timeout_ms
        cap = max(1, int(self.attempt_timeout_ms))
        return cap if timeout_ms is None else min(timeout_ms, cap)

    def do_retry(self, exc: BaseException, attempt: int) -> bool:
        """True when ``exc`` (the failure of 0-based ``attempt``) should
        be retried."""
        if attempt + 1 >= self.max_attempts:
            return False
        return getattr(exc, "code", None) in self.retriable


def call_with_retry(channel, service: str, method: str,
                    request: bytes = b"", *,
                    policy: Optional[RetryPolicy] = None,
                    deadline_ms: Optional[float] = None,
                    breaker: "Optional[CircuitBreaker]" = None,
                    backup_ms: Optional[float] = None,
                    clock: Callable[[], float] = time.monotonic,
                    sleep: Callable[[float], None] = time.sleep) -> bytes:
    """Retrying call under a deadline budget.

    Each attempt's native per-call timeout is the budget still remaining,
    and backoff sleeps are capped so a final attempt always gets >=1ms —
    total wall time across every attempt and sleep stays <= deadline_ms.
    Without ``deadline_ms`` the channel's own timeout bounds each attempt
    (but not the sum).  ``breaker`` (per-endpoint) fast-fails while open
    and is fed every outcome; ``backup_ms`` hedges each attempt via
    :func:`backup_call`.
    """
    policy = policy or RetryPolicy()
    deadline = clock() + deadline_ms / 1000.0 \
        if deadline_ms is not None else None
    attempt = 0
    while True:
        if breaker is not None and breaker.isolated():
            if obs.enabled():
                obs.counter("rpc_breaker_fastfail").add(1)
            raise _rpc_error(
                EBREAKEROPEN,
                f"circuit breaker open for {getattr(breaker, 'name', '?')}"
                f" (fail-fast, no attempt made)")
        attempt_timeout: Optional[int] = None
        if deadline is not None:
            remaining_ms = (deadline - clock()) * 1000.0
            if remaining_ms < 1.0:
                raise _rpc_error(
                    1008, f"deadline budget exhausted after {attempt} "
                          f"attempt(s) of {service}.{method}")
            attempt_timeout = max(1, int(remaining_ms))
        attempt_timeout = policy.cap_attempt_timeout(attempt_timeout)
        try:
            tag = f"attempt={attempt}"
            if backup_ms is not None:
                out = backup_call(channel, service, method, request,
                                  backup_ms=backup_ms,
                                  timeout_ms=attempt_timeout, tag=tag)
            else:
                out = channel.call_async(service, method, request,
                                         timeout_ms=attempt_timeout,
                                         tag=tag).join()
        except Exception as e:  # noqa: BLE001 — classified below
            code = getattr(e, "code", None)
            if code is None:
                raise  # not an RPC failure (programming error): no retry
            if breaker is not None:
                breaker.on_call_end(code)
            if not policy.do_retry(e, attempt):
                if obs.enabled() and attempt > 0:
                    obs.counter("rpc_retry_give_up").add(1)
                raise
            delay = policy.retry_delay_ms(e, attempt)
            if deadline is not None:
                remaining_ms = (deadline - clock()) * 1000.0
                if remaining_ms < 2.0:
                    raise  # no room for a sleep AND an attempt
                # leave at least 1ms of budget for the next attempt
                delay = min(delay, remaining_ms - 1.0)
            if obs.enabled():
                obs.counter("rpc_retries").add(1)
            sleep_ms(delay, sleep=sleep)
            attempt += 1
            continue
        if breaker is not None:
            breaker.on_call_end(0)
        return out


# ---------------------------------------------------------------------------
# backup requests (hedging over call_async + native cancel)
# ---------------------------------------------------------------------------

def backup_call(channel, service: str, method: str, request: bytes = b"",
                *, backup_ms: float, timeout_ms: Optional[int] = None,
                tag: Optional[str] = None, primary=None) -> bytes:
    """Hedged call: start the primary; if it has not completed within
    ``backup_ms``, start a second identical attempt.  The FIRST
    completion wins and the loser is cancelled (native ``StartCancel``)
    then reaped.  An attempt that completes with an error yields to the
    other attempt; only when both fail does the first error propagate.

    ``primary`` may be an already-started PendingCall for the same
    request (the PS fan-out hedges its in-flight shard calls this way);
    it is always consumed — joined, or cancelled and reaped.

    The reference arms this with a timer inside the controller
    (controller.cpp:337); here the hedge rides the native call-group
    fan-in (``rpc.CallGroup``): both attempts signal one CountdownEvent
    and every ``wait_any`` wakes on EXACTLY one completion — no
    ``brt_call_wait`` polling slices anywhere in the loop.  The
    ``rpc_hedge_waits`` counter tracks completions consumed (at most one
    per attempt), not elapsed time — the exactness contract the tests
    assert.
    """
    rec = obs.enabled()

    def _tagged(label: str) -> str:
        return f"{tag},{label}" if tag else label

    if primary is None:
        primary = channel.call_async(service, method, request,
                                     timeout_ms=timeout_ms,
                                     tag=_tagged("hedge=primary"))
    # The arming window: ONE bounded wait on the primary's own completion
    # latch (level-triggered, not a poll loop).
    if primary.wait(backup_ms / 1000.0):
        return primary.join()
    if rec:
        obs.counter("rpc_backup_fired").add(1)
    from brpc_tpu_torch import rpc as _rpc  # lazy: rpc imports this module
    pending: List[Tuple[str, object]] = [("primary", primary)]
    group = _rpc.CallGroup()
    try:
        group.add(primary)
        try:
            backup = channel.call_async(service, method, request,
                                        timeout_ms=timeout_ms,
                                        tag=_tagged("hedge=backup"))
            # hedge registry: the finally reaps every entry not joined
            pending.append(("backup", backup))  # lint: allow-handle-escape
            group.add(backup)
        except Exception as e:  # noqa: BLE001 — hedge must not lose the
            if getattr(e, "code", None) is None:  # primary to a failed
                raise                             # backup start
        first_exc: Optional[Exception] = None
        while pending:
            if rec:
                obs.counter("rpc_hedge_waits").add(1)
            group.wait_any()  # parks until one attempt completes; exact
            done_idx = next((i for i, (_, pc) in enumerate(pending)
                             if pc.wait(0.0)), None)
            if done_idx is None:  # pragma: no cover — wait_any contract
                continue
            label, pc = pending.pop(done_idx)
            try:
                out = pc.join()
            except Exception as e:  # noqa: BLE001 — yield to the hedge
                if getattr(e, "code", None) is None:
                    raise
                if first_exc is None:
                    first_exc = e
                continue
            if rec and label == "backup":
                obs.counter("rpc_backup_wins").add(1)
            return out
        raise first_exc  # both attempts completed, both failed
    finally:
        group.close()
        # Winner path: cancel the loser so it stops consuming the server
        # and the fabric, then reap.  Error paths reap whatever is left.
        for _, pc in pending:
            pc.cancel()
            pc.close()


def resilient_call(channel, service: str, method: str,
                   request: bytes = b"", *,
                   retry: Optional[RetryPolicy] = None,
                   deadline_ms: Optional[float] = None,
                   backup_ms: Optional[float] = None,
                   breaker: "Optional[CircuitBreaker]" = None,
                   timeout_ms: Optional[int] = None) -> bytes:
    """Dispatch for ``Channel.call``'s resilience kwargs: the minimal
    machinery for what was asked.  A bare ``backup_ms`` skips the retry
    loop; anything involving retry/deadline/breaker goes through
    :func:`call_with_retry`."""
    if retry is None and deadline_ms is None and breaker is None:
        if backup_ms is not None:
            return backup_call(channel, service, method, request,
                               backup_ms=backup_ms, timeout_ms=timeout_ms)
        return channel.call_async(service, method, request,
                                  timeout_ms=timeout_ms).join()
    if deadline_ms is None and timeout_ms is not None:
        deadline_ms = timeout_ms  # a per-call timeout IS the budget
    return call_with_retry(channel, service, method, request,
                           policy=retry, deadline_ms=deadline_ms,
                           breaker=breaker, backup_ms=backup_ms)


# ---------------------------------------------------------------------------
# circuit breaker (per-endpoint EMA windows, injectable clock)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BreakerOptions:
    """Defaults mirror the reference flags (circuit_breaker.h:25-48):
    1% tolerated error rate over the long window, 5% over the short."""

    long_window: int = 1024
    short_window: int = 128
    long_max_error_rate: float = 0.01
    short_max_error_rate: float = 0.05
    min_isolation_ms: float = 100.0
    max_isolation_ms: float = 30_000.0
    #: samples required before the windows may trip (0 = short_window/4)
    min_samples: int = 0

    def effective_min_samples(self) -> int:
        return self.min_samples or max(1, self.short_window // 4)


class CircuitBreaker:
    """Per-endpoint breaker: long+short EMA error windows; tripping
    isolates the endpoint for a duration that doubles with consecutive
    isolations (capped); successful traffic after recovery decays the
    backoff.  ``clock`` is injectable (monotonic seconds) so the state
    machine is testable without wall time.

    States (:meth:`state`): ``closed`` (serving), ``open`` (isolated —
    callers fail fast), ``half_open`` (isolation expired, awaiting the
    first success or probe).  ``isolate_guard``, when set, is consulted
    OUTSIDE the breaker lock before tripping — the registry binds the
    cluster-recover check here.
    """

    def __init__(self, options: Optional[BreakerOptions] = None,
                 clock: Callable[[], float] = time.monotonic,
                 isolate_guard: Optional[Callable[[], bool]] = None,
                 name: str = ""):
        self.opt = options or BreakerOptions()
        self.name = name
        self._clock = clock
        self._isolate_guard = isolate_guard
        self._mu = checked_lock("resilience.breaker")
        # fixed-point EMAs (error rate x10000), like the reference
        self._long_ema = 0
        self._short_ema = 0
        self._samples = 0
        self._isolation_count = 0
        # read lock-free by isolated()/state(): a stale read is benign
        # (one extra call slips through or fast-fails a moment late)
        self._isolated_until = 0.0
        self._probation = False

    # -- lock-free reads ---------------------------------------------------

    def isolated(self) -> bool:
        return self._clock() < self._isolated_until

    def state(self) -> str:
        if self.isolated():
            return "open"
        if self._probation:
            return "half_open"
        return "closed"

    # -- state transitions -------------------------------------------------

    def _update_ema(self, prev: int, err: float, window: int) -> int:
        return prev + (int(err * 10000) - prev) // window

    def on_call_end(self, error_code: int) -> bool:
        """Feed one call outcome.  Returns False when the endpoint is
        (or just became) isolated — the caller should exclude it."""
        if self.isolated():
            return False
        trip = False
        with self._mu:
            err = 0.0 if error_code == 0 else 1.0
            self._long_ema = self._update_ema(
                self._long_ema, err, self.opt.long_window)
            self._short_ema = self._update_ema(
                self._short_ema, err, self.opt.short_window)
            self._samples += 1
            if error_code == 0 and self._probation:
                # first success after isolation: close, decay the backoff
                self._probation = False
                if self._isolation_count > 0:
                    self._isolation_count -= 1
            elif error_code != 0 and self._probation:
                # half-open probe failed: reopen immediately, don't wait
                # for the windows to refill past the sample gate
                trip = True
            if not trip and \
                    self._samples >= self.opt.effective_min_samples() and (
                    self._long_ema > self.opt.long_max_error_rate * 10000
                    or self._short_ema >
                    self.opt.short_max_error_rate * 10000):
                trip = True
        if not trip:
            return True
        # Guard consulted outside the breaker lock: it reads sibling
        # breakers (lock-free) via the registry and must never nest
        # inside this one.
        if self._isolate_guard is not None and not self._isolate_guard():
            if obs.enabled():
                obs.counter("rpc_breaker_guard_skips").add(1)
            with self._mu:
                self._reset_windows_locked()
            return True
        self.isolate()
        return False

    def isolate(self) -> None:
        with self._mu:
            self._isolation_count = min(self._isolation_count + 1, 8)
            dur_ms = min(
                self.opt.min_isolation_ms * (1 << (self._isolation_count
                                                   - 1)),
                self.opt.max_isolation_ms)
            self._isolated_until = self._clock() + dur_ms / 1000.0
            self._probation = True
            self._reset_windows_locked()
        if obs.enabled():
            obs.counter("rpc_breaker_open").add(1)

    def _reset_windows_locked(self) -> None:
        self._long_ema = 0
        self._short_ema = 0
        self._samples = 0

    def revive(self) -> None:
        """Health probe verified the endpoint: lift isolation now
        (reference HealthCheckTask revival)."""
        with self._mu:
            self._isolated_until = 0.0
            self._probation = False
        if obs.enabled():
            obs.counter("rpc_breaker_revived").add(1)

    def snapshot(self) -> Dict[str, object]:
        return {
            "state": self.state(),
            "isolation_count": self._isolation_count,
            "samples": self._samples,
            "long_error_rate": self._long_ema / 10000.0,
            "short_error_rate": self._short_ema / 10000.0,
        }


class BreakerRegistry:
    """Per-endpoint breakers plus the cluster-recover guard: an
    isolation is refused when it would leave fewer than ``min_working``
    endpoints un-isolated (reference cluster_recover_policy.h — a dying
    cluster must keep taking traffic rather than excluding everyone).

    ``redirect=True`` declares the REDIRECT policy for components that
    route over replica groups (the PS fan-out): an open breaker re-routes
    the call to the next live replica instead of raising ``BreakerOpen``
    — availability over fail-fast (SelectiveChannel's "retry picks a
    different sub-channel", selective_channel.cpp).  The registry only
    CARRIES the flag (routing lives with the router); with a single
    replica there is nowhere to redirect and open still means reject."""

    def __init__(self, options: Optional[BreakerOptions] = None,
                 clock: Callable[[], float] = time.monotonic,
                 min_working: int = 1, redirect: bool = False):
        self.options = options or BreakerOptions()
        self.min_working = min_working
        self.redirect = bool(redirect)
        self._clock = clock
        self._mu = checked_lock("resilience.breakers")
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._probes: Dict[str, Dict[str, object]] = {}

    def breaker_for(self, endpoint: str) -> CircuitBreaker:
        b = self._breakers.get(endpoint)
        if b is None:
            with self._mu:
                b = self._breakers.get(endpoint)
                if b is None:
                    b = CircuitBreaker(
                        self.options, clock=self._clock,
                        isolate_guard=self._allow_isolate, name=endpoint)
                    self._breakers[endpoint] = b
        return b

    def _allow_isolate(self) -> bool:
        """True when at least ``min_working`` endpoints would remain
        serving after one more isolation (reads sibling breakers
        lock-free — see CircuitBreaker.isolated)."""
        with self._mu:
            breakers = list(self._breakers.values())
        working = sum(1 for b in breakers if not b.isolated())
        return working - 1 >= self.min_working

    def on_call_end(self, endpoint: str, error_code: int) -> bool:
        return self.breaker_for(endpoint).on_call_end(error_code)

    def isolated(self, endpoint: str) -> bool:
        b = self._breakers.get(endpoint)
        return b is not None and b.isolated()

    def isolated_endpoints(self) -> List[str]:
        with self._mu:
            items = list(self._breakers.items())
        return [ep for ep, b in items if b.isolated()]

    def note_probe(self, endpoint: str, ok: bool, detail: str = "") -> None:
        with self._mu:
            self._probes[endpoint] = {
                "ok": ok, "at": self._clock(), "detail": detail}

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        with self._mu:
            items = list(self._breakers.items())
            probes = dict(self._probes)
        out: Dict[str, Dict[str, object]] = {}
        for ep, b in items:
            d = b.snapshot()
            if ep in probes:
                p = dict(probes[ep])
                p["age_s"] = round(self._clock() - float(p.pop("at")), 3)
                d["last_probe"] = p
            out[ep] = d
        return out


# ---------------------------------------------------------------------------
# replica scoring (the locality-aware LB analog: latency x inflight)
# ---------------------------------------------------------------------------

class ReplicaScorer:
    """Per-endpoint latency+inflight scoring for replica selection (the
    reference's ``la`` locality-aware load balancer,
    locality_aware_load_balancer.cpp / docs/cn/lalb.md, reduced to the
    two signals that matter for a read fan-out): an endpoint's score is
    ``ewma_latency * (inflight + 1)`` — expected queueing-adjusted
    completion time — and the router picks the minimum among live
    replicas.  An endpoint nothing is known about scores as the OPTIMIST
    (``prior_ms`` with its real inflight), so fresh/revived replicas get
    probed by real traffic instead of starving forever behind a warm
    sibling.

    ``note_start``/``note_end`` bracket every routed call; failures count
    as a latency PENALTY (``fail_penalty_ms`` fed to the EWMA) so a
    flapping replica scores itself out of the rotation even before its
    breaker trips.  All state is per-endpoint ints/floats under one lock;
    reads take the same lock (selection is per-batch, not per-byte)."""

    def __init__(self, alpha: float = 0.25, prior_ms: float = 1.0,
                 fail_penalty_ms: float = 100.0):
        self.alpha = alpha
        self.prior_ms = prior_ms
        self.fail_penalty_ms = fail_penalty_ms
        self._mu = checked_lock("resilience.scorer")
        self._ewma_ms: Dict[str, float] = {}
        self._inflight: Dict[str, int] = {}

    def note_start(self, endpoint: str) -> None:
        with self._mu:
            self._inflight[endpoint] = self._inflight.get(endpoint, 0) + 1

    def note_end(self, endpoint: str, latency_s: Optional[float],
                 ok: bool) -> None:
        """One routed call finished.  ``latency_s`` may be None when the
        caller could not measure (start-failure); failures feed the
        penalty either way."""
        sample_ms = (latency_s or 0.0) * 1000.0
        if not ok:
            sample_ms = max(sample_ms, self.fail_penalty_ms)
        with self._mu:
            n = self._inflight.get(endpoint, 0)
            if n > 0:
                self._inflight[endpoint] = n - 1
            prev = self._ewma_ms.get(endpoint)
            if prev is None:
                self._ewma_ms[endpoint] = sample_ms
            else:
                self._ewma_ms[endpoint] = \
                    prev + self.alpha * (sample_ms - prev)

    def score(self, endpoint: str) -> float:
        with self._mu:
            lat = self._ewma_ms.get(endpoint, self.prior_ms)
            inflight = self._inflight.get(endpoint, 0)
        return max(lat, 0.001) * (inflight + 1)

    def pick(self, candidates: List[str]) -> Optional[str]:
        """The lowest-scoring candidate (ties break by order, so a
        deterministic candidate list yields deterministic routing)."""
        best, best_score = None, None
        for ep in candidates:
            s = self.score(ep)
            if best_score is None or s < best_score:
                best, best_score = ep, s
        return best

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._mu:
            eps = set(self._ewma_ms) | set(self._inflight)
            return {ep: {"ewma_ms": round(self._ewma_ms.get(
                             ep, self.prior_ms), 3),
                         "inflight": self._inflight.get(ep, 0)}
                    for ep in sorted(eps)}

    def scoped(self, namespace: str) -> "ReplicaScorer":
        """A view of this scorer whose bookkeeping keys are prefixed
        with ``namespace`` — per-SCHEME replica scoring during a live
        reshard (the same address serving two partition schemes scores
        independently per scheme, so one scheme's routing state can
        drain without poisoning the other's).  An empty namespace is
        this scorer itself."""
        if not namespace:
            return self
        return _ScopedScorer(self, namespace)


class _ScopedScorer:
    """Key-prefixing facade over a shared :class:`ReplicaScorer` (see
    :meth:`ReplicaScorer.scoped`).  ``pick`` accepts and returns RAW
    addresses; only the score bookkeeping is namespaced."""

    __slots__ = ("_base", "_ns")

    def __init__(self, base: ReplicaScorer, namespace: str):
        self._base = base
        self._ns = namespace + "|"

    def note_start(self, endpoint: str) -> None:
        self._base.note_start(self._ns + endpoint)

    def note_end(self, endpoint: str, latency_s: Optional[float],
                 ok: bool) -> None:
        self._base.note_end(self._ns + endpoint, latency_s, ok)

    def score(self, endpoint: str) -> float:
        return self._base.score(self._ns + endpoint)

    def pick(self, candidates: List[str]) -> Optional[str]:
        best, best_score = None, None
        for ep in candidates:
            s = self.score(ep)
            if best_score is None or s < best_score:
                best, best_score = ep, s
        return best

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        full = self._base.snapshot()
        return {ep[len(self._ns):]: d for ep, d in full.items()
                if ep.startswith(self._ns)}


# ---------------------------------------------------------------------------
# health-check prober (background revival fiber)
# ---------------------------------------------------------------------------

class HealthProber:
    """Probes ISOLATED endpoints via the ``_status`` builtin's ``health``
    method and revives their breaker on success (reference
    details/health_check.cpp:146 — failed sockets get a background
    health-check loop, not permanent exile).

    ``probe_once()`` is the testable unit: snapshot the isolated set,
    probe each OUTSIDE every lock, revive on success.  ``start()`` runs
    it on a daemon thread every ``interval_ms`` (deterministically
    jittered via :class:`Backoff` so a fleet of probers doesn't
    synchronize).  Channels are cached per endpoint across probes — the
    native channel reconnects under the hood, so a probe failure does
    not invalidate it.
    """

    def __init__(self, registry: BreakerRegistry,
                 make_channel: Optional[Callable[[str], object]] = None,
                 interval_ms: float = 200.0,
                 probe_timeout_ms: int = 200):
        self.registry = registry
        self._make_channel = make_channel or self._default_channel
        self.interval_ms = interval_ms
        self.probe_timeout_ms = probe_timeout_ms
        self._backoff = Backoff(base_ms=interval_ms, multiplier=1.0,
                                max_ms=interval_ms, jitter=0.25)
        self._mu = checked_lock("resilience.prober")
        self._channels: Dict[str, object] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ticks = 0

    def _default_channel(self, endpoint: str):
        from brpc_tpu_torch import rpc  # lazy: see module docstring
        return rpc.Channel(endpoint, timeout_ms=self.probe_timeout_ms)

    def _channel_for(self, endpoint: str):
        ch = self._channels.get(endpoint)
        if ch is not None:
            return ch
        new = self._make_channel(endpoint)
        with self._mu:
            cur = self._channels.setdefault(endpoint, new)
        if cur is not new:  # lost a creation race: keep the winner
            new.close()
        return cur

    def probe_once(self) -> Dict[str, bool]:
        """One revival sweep; returns {endpoint: probe_ok} for every
        endpoint that was isolated when the sweep started."""
        results: Dict[str, bool] = {}
        for ep in self.registry.isolated_endpoints():
            try:
                self._channel_for(ep).call("_status", "health")
                ok, detail = True, ""
            except Exception as e:  # noqa: BLE001 — any failure = down
                ok, detail = False, f"{type(e).__name__}: {e}"[:200]
            results[ep] = ok
            self.registry.note_probe(ep, ok, detail)
            if ok:
                self.registry.breaker_for(ep).revive()
            elif obs.enabled():
                obs.counter("rpc_health_probe_failures").add(1)
        return results

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="brt-health-prober")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._ticks += 1
            # Event.wait is the loop's cadence (interruptible by stop()),
            # jittered deterministically per tick.
            if self._stop.wait(
                    self._backoff.delay_ms(self._ticks) / 1000.0):
                break
            try:
                self.probe_once()
            except Exception:  # noqa: BLE001 — prober must never die
                if obs.enabled():
                    obs.counter("rpc_health_probe_errors").add(1)

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)
        with self._mu:
            channels = list(self._channels.values())
            self._channels.clear()
        for ch in channels:
            try:
                ch.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass

    def status(self) -> Dict[str, object]:
        return {
            "running": self._thread is not None,
            "ticks": self._ticks,
            "interval_ms": self.interval_ms,
        }


# ---------------------------------------------------------------------------
# process-wide default registry (the _status health surface)
# ---------------------------------------------------------------------------

_default_mu = checked_lock("resilience.default")
_default_registry: Optional[BreakerRegistry] = None
_default_prober: Optional[HealthProber] = None


def default_registry() -> BreakerRegistry:
    """The process-wide registry (created on first use); components that
    don't pass their own BreakerRegistry share this one, and the
    ``_status`` ``health`` method reports it."""
    global _default_registry
    if _default_registry is None:
        with _default_mu:
            if _default_registry is None:
                _default_registry = BreakerRegistry()
    return _default_registry


def set_default_registry(reg: Optional[BreakerRegistry],
                         prober: Optional[HealthProber] = None) -> None:
    """Install (or clear, with None) the process-wide registry/prober
    pair the health surface reports."""
    global _default_registry, _default_prober
    with _default_mu:
        _default_registry = reg
        _default_prober = prober


def health_components() -> Dict[str, object]:
    """Structured per-component health for the ``_status`` builtin's
    ``health`` method: breaker states per endpoint + last probe results.
    ``status`` degrades to ``"degraded"`` whenever any breaker is open."""
    with _default_mu:
        reg, prober = _default_registry, _default_prober
    breakers = reg.snapshot() if reg is not None else {}
    degraded = any(d.get("state") == "open" for d in breakers.values())
    out: Dict[str, object] = {
        "status": "degraded" if degraded else "ok",
        "components": {
            "breakers": breakers,
            "racecheck": {"enabled": _race.enabled()},
            "obs": {"enabled": obs.enabled()},
        },
    }
    if prober is not None:
        out["components"]["prober"] = prober.status()
    return out
