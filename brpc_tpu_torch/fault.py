"""Deterministic fault injection for the RPC/PS fabric.

Every fault-tolerance behavior in :mod:`brpc_tpu_torch.resilience` is proven
against INJECTED failures, not real network flakiness: a seeded
:class:`FaultPlan` decides — per (side, service, method, endpoint) and
per call sequence number — whether a call errors, is delayed, or is
dropped.  Decisions are a pure function of ``(seed, rule index, hit
counter)``, so the same plan replays the same failure schedule every
run (the fault-injection analog of :class:`resilience.Backoff`'s
deterministic jitter).

Hook points (both no-ops when no plan is installed — one module-global
``is None`` check):

- **server trampoline** (``rpc.Server.add_service`` /
  ``add_async_service``): :func:`server_intercept` runs before the user
  handler — an ``error`` rule raises (the trampoline's normal error path
  responds with the injected code), a ``delay`` rule sleeps on the fiber
  worker (exactly what a slow shard does to the fabric).
- **client call path** (``rpc.Channel.call`` / ``call_async``):
  :func:`client_intercept` — ``error`` raises before the wire,
  ``delay`` stalls the caller, ``drop`` burns the call's timeout budget
  and raises ERPCTIMEDOUT (a lost request seen from the client).
- **native pre-dispatch hook** (``brt_set_drop_hook``, installed by
  :func:`install` when a plan carries SERVER-side ``drop`` rules):
  :func:`server_drop_intercept` runs inside the native request path
  after the meta is parsed but before dispatch — a firing rule discards
  the request silently, NO response is ever written, and the client
  exercises its REAL timeout machinery (native deadline timer, retry
  budget, hedging), unlike the client-side ``drop`` which simulates the
  cost without touching the wire.  Needs the native core.

Rules (programmatic or ``BRPC_TPU_FAULTS`` env, JSON list)::

    [{"side": "server", "service": "Ps", "method": "Lookup",
      "action": "delay", "delay_ms": 40, "probability": 0.3},
     {"side": "client", "endpoint": "127.0.0.1:7001",
      "action": "error", "error_code": 1009, "max_hits": 2}]

Match keys (``service``/``method``/``endpoint``) are exact strings;
omitted keys match anything.  ``probability`` is evaluated by the seeded
hash per hit; ``after`` skips the first N matching calls and
``max_hits`` stops injecting after N injections (both make "fails the
first attempt, then recovers" schedules trivial).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

from brpc_tpu_torch import obs
from brpc_tpu_torch.analysis.race import checked_lock
from brpc_tpu_torch.resilience import _hash01, sleep_ms

__all__ = [
    "FaultRule", "FaultPlan", "install", "install_from_env", "clear",
    "current", "active", "server_intercept", "server_drop_intercept",
    "client_intercept", "kill_rules", "partition_rules", "FAULTS_ENV",
]

FAULTS_ENV = "BRPC_TPU_FAULTS"

_ACTIONS = ("error", "delay", "drop")
_SIDES = ("server", "client")


@dataclasses.dataclass
class FaultRule:
    """One injection rule.  ``action``: ``error`` (respond/raise
    ``error_code``/``error_text``), ``delay`` (sleep ``delay_ms`` then
    proceed), ``drop`` — client-side: consume the call's timeout and
    raise ERPCTIMEDOUT; server-side: the native pre-dispatch hook
    discards the parsed request silently (no response — the client's
    real timeout machinery runs)."""

    action: str
    side: str = "server"
    service: Optional[str] = None
    method: Optional[str] = None
    endpoint: Optional[str] = None
    error_code: int = 2001
    error_text: str = "injected fault"
    delay_ms: float = 0.0
    probability: float = 1.0
    #: skip the first N matching calls before injecting at all
    after: int = 0
    #: stop injecting after N injections (None = forever)
    max_hits: Optional[int] = None

    def __post_init__(self) -> None:
        if self.action not in _ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}; "
                             f"valid: {', '.join(_ACTIONS)}")
        if self.side not in _SIDES:
            raise ValueError(f"unknown fault side {self.side!r}; "
                             f"valid: {', '.join(_SIDES)}")
        # Server-side drop rules fire in the NATIVE pre-dispatch hook
        # (the session never exists, so "respond exactly once" is moot);
        # client-side drop burns the caller's timeout budget locally.

    def matches(self, side: str, service: str, method: str,
                endpoint: Optional[str]) -> bool:
        if self.side != side:
            return False
        if self.service is not None and self.service != service:
            return False
        if self.method is not None and self.method != method:
            return False
        if self.endpoint is not None and self.endpoint != endpoint:
            return False
        return True


def kill_rules(*endpoints: str, code: int = 1009,
               text: str = "injected kill",
               probability: float = 1.0,
               max_hits: Optional[int] = None) -> "List[FaultRule]":
    """Rules that make ``endpoints`` DEAD: every client call to the
    address fails before the wire and every request still reaching the
    server (a peer's replication Sync, a prober's health check) errors
    — the deterministic kill-primary / kill-replica lever for the
    replication tests and benches.  The default code (EFAILEDSOCKET
    1009) is retriable and breaker-feeding, so the fabric's failover
    machinery — redirect, promotion, revival once the rules clear —
    is what gets exercised, not a special-cased error path."""
    rules: List[FaultRule] = []
    for ep in endpoints:
        for side in _SIDES:
            rules.append(FaultRule(
                action="error", side=side, endpoint=ep,
                error_code=code, error_text=f"{text} ({ep})",
                probability=probability, max_hits=max_hits))
    return rules


#: the state-propagation control/data plane between servers: replication
#: sync + delta streams and migration sync + delta streams.  Severing
#: exactly these (and nothing else) is how tests create a server that
#: SERVES clients but cannot receive peer state — the control-plane
#: partition behind stale-primary and mid-migration failure scenarios.
PROPAGATION_METHODS = ("Sync", "ReplicaApply", "MigrateSync",
                       "MigrateApply")


def partition_rules(*endpoints: str, code: int = 1009,
                    methods: Tuple[str, ...] = PROPAGATION_METHODS,
                    max_hits: Optional[int] = None) -> "List[FaultRule]":
    """Rules that sever ``endpoints``' replication/migration
    PROPAGATION plane only: Sync/ReplicaApply (replication) and
    MigrateSync/MigrateApply (resharding handoff) fail — on BOTH sides,
    like :func:`kill_rules`, because a server-only rule is silently
    absorbed by the native channel's transparent retry (max_retry
    attempts per call each consume one hit) — while client data
    traffic still flows: the deterministic "partitioned but serving"
    lever (a stale primary that cannot be informed; a migration
    destination the source cannot reach mid-stream).  With the
    client-side rule, ``max_hits`` counts logical peer calls."""
    rules: List[FaultRule] = []
    for ep in endpoints:
        for method in methods:
            for side in _SIDES:
                rules.append(FaultRule(
                    action="error", side=side, service="Ps",
                    method=method, endpoint=ep, error_code=code,
                    error_text=f"injected partition ({ep} {method})",
                    max_hits=max_hits))
    return rules


class FaultPlan:
    """A seeded list of rules plus per-rule hit counters.  ``decide``
    is the only stateful operation (counters advance under a lock);
    everything else is pure, so a plan's schedule is reproducible from
    ``(seed, rules, call order)``."""

    def __init__(self, rules: List[FaultRule], seed: int = 0):
        self.rules = list(rules)
        self.seed = seed
        self._mu = checked_lock("fault.plan")
        self._seen = [0] * len(self.rules)   # matching calls per rule
        self._hits = [0] * len(self.rules)   # injections per rule

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        data = json.loads(text)
        if isinstance(data, dict):
            seed = int(data.get("seed", 0))
            rules = data.get("rules", [])
        else:
            seed, rules = 0, data
        return cls([FaultRule(**r) for r in rules], seed=seed)

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "rules": [dataclasses.asdict(r) for r in self.rules],
        })

    def has_server_drop_rules(self) -> bool:
        """True when any rule needs the native pre-dispatch drop hook."""
        return any(r.side == "server" and r.action == "drop"
                   for r in self.rules)

    def decide(self, side: str, service: str, method: str,
               endpoint: Optional[str] = None,
               actions: Optional[Tuple[str, ...]] = None
               ) -> Optional[FaultRule]:
        """The first rule that matches AND fires for this call (counters
        advance for every matching rule either way).  ``actions`` filters
        which rules this decision point CONSIDERS — rules outside it are
        skipped entirely, counters untouched: server-side ``drop`` rules
        are decided by the native pre-dispatch hook (which sees every
        request), ``error``/``delay`` by the trampoline (which never sees
        a dropped request), and the two decision points must not consume
        each other's hit sequence."""
        fired: Optional[FaultRule] = None
        with self._mu:
            for i, rule in enumerate(self.rules):
                if actions is not None and rule.action not in actions:
                    continue
                if not rule.matches(side, service, method, endpoint):
                    continue
                seq = self._seen[i]
                self._seen[i] += 1
                if fired is not None:
                    continue  # counters still advance on later rules
                if seq < rule.after:
                    continue
                if rule.max_hits is not None and \
                        self._hits[i] >= rule.max_hits:
                    continue
                if rule.probability < 1.0 and _hash01(
                        self.seed * 1000003 + i, seq) >= rule.probability:
                    continue
                self._hits[i] += 1
                fired = rule
        return fired

    def hits(self) -> List[int]:
        with self._mu:
            return list(self._hits)


# ---------------------------------------------------------------------------
# process-global plan + the two hook points
# ---------------------------------------------------------------------------

_plan: Optional[FaultPlan] = None


def active() -> bool:
    """Fast gate for the hot hook sites (one global read)."""
    return _plan is not None


def install(plan: Optional[FaultPlan]) -> None:
    global _plan
    if plan is not None and plan.has_server_drop_rules():
        # Server-side drop needs the native pre-dispatch hook (raises
        # NativeCoreUnavailable without the toolchain/.so).  The hook
        # stays installed after clear() — it gates on active() and costs
        # one atomic load when no plan is live.
        from brpc_tpu_torch import rpc
        rpc.install_drop_hook()
    _plan = plan


def clear() -> None:
    install(None)


def current() -> Optional[FaultPlan]:
    return _plan


def install_from_env(env: Optional[Dict[str, str]] = None) -> bool:
    """Install a plan from ``BRPC_TPU_FAULTS`` (inline JSON, or
    ``@/path/to/plan.json``).  Returns True when a plan was installed."""
    raw = (env or os.environ).get(FAULTS_ENV, "")
    if not raw:
        return False
    if raw.startswith("@"):
        with open(raw[1:], "r", encoding="utf-8") as f:
            raw = f.read()
    install(FaultPlan.from_json(raw))
    return True


def _injected_error(rule: FaultRule):
    from brpc_tpu_torch.rpc import RpcError  # lazy: rpc imports this module
    return RpcError(rule.error_code, rule.error_text)


def server_intercept(service: str, method: str,
                     endpoint: Optional[str] = None) -> None:
    """Called by the server trampolines before the user handler.  Raises
    to fail the call with the injected code; sleeps for ``delay`` rules
    (on the fiber worker — a faithful slow handler).  ``endpoint`` is the
    server's own listen address, so a plan can make ONE shard of a
    fleet slow or failing."""
    plan = _plan
    if plan is None:
        return
    # drop rules belong to the native pre-dispatch hook: a dropped
    # request never reaches this trampoline, so considering them here
    # would double-consume their hit sequence.
    rule = plan.decide("server", service, method, endpoint,
                       actions=("error", "delay"))
    if rule is None:
        return
    if rule.action == "delay":
        if obs.enabled():
            obs.counter("fault_injected_delays").add(1)
        sleep_ms(rule.delay_ms)
        return
    if obs.enabled():
        obs.counter("fault_injected_errors").add(1)
    raise _injected_error(rule)


def server_drop_intercept(service: str, method: str,
                          endpoint: Optional[str] = None) -> bool:
    """Called by the NATIVE pre-dispatch hook (``brt_set_drop_hook`` →
    ``rpc.install_drop_hook``) for every parsed request.  True = discard
    the request silently (no response; the client's real timeout path
    runs).  Only server-side ``drop`` rules are considered — their hit
    counters advance here, pre-dispatch, where every request is seen."""
    plan = _plan
    if plan is None:
        return False
    rule = plan.decide("server", service, method, endpoint,
                       actions=("drop",))
    if rule is None:
        return False
    if obs.enabled():
        obs.counter("fault_injected_drops").add(1)
    return True


def client_intercept(service: str, method: str, endpoint: str,
                     timeout_ms: Optional[float] = None) -> None:
    """Called by ``Channel.call``/``call_async`` before the native call.
    ``drop`` consumes the effective timeout then raises ERPCTIMEDOUT —
    exactly what a lost request costs the caller."""
    plan = _plan
    if plan is None:
        return
    rule = plan.decide("client", service, method, endpoint)
    if rule is None:
        return
    if rule.action == "delay":
        if obs.enabled():
            obs.counter("fault_injected_delays").add(1)
        sleep_ms(rule.delay_ms)
        return
    if rule.action == "drop":
        if obs.enabled():
            obs.counter("fault_injected_drops").add(1)
        sleep_ms(timeout_ms if timeout_ms is not None else rule.delay_ms)
        from brpc_tpu_torch.rpc import RpcError  # lazy
        raise RpcError(1008, f"injected drop of {service}.{method} "
                             f"to {endpoint}")
    if obs.enabled():
        obs.counter("fault_injected_errors").add(1)
    raise _injected_error(rule)
