"""Self-driving elasticity: the automatic rebalancer.

The reference's dynamic-partition fabric is *self-managing* — the
``DynamicPartitionChannel`` re-routes as partitions move and the
balancer decides WHEN they move (SURVEY §2.7).  Our fabric can fail
over (replication), split live (``reshard``) and re-drive a migration
through a source failover (this tier) — but until here every one of those was an
operator decision.  This module closes the loop:

- :class:`RebalancePolicy` is the DECISION function, deliberately
  separated from the plumbing: it consumes per-shard observations
  (read+write rate, primary placement) over an injectable clock and
  answers at most one :class:`Decision` — ``split`` (double the shard
  count), ``merge`` (halve it), or ``failback`` (promote the declared
  primary back after a revival).  Hysteresis is structural: a signal
  must SUSTAIN for ``sustain_s`` before it may act, split/merge
  thresholds are required to be far apart, and ``min_interval_s``
  separates consecutive topology actions — the policy can be proven
  flap-free with a fake clock, no servers anywhere (tier-1's
  ``tests/test_rebalance.py``).
- :class:`Rebalancer` is the daemon: it watches the naming registry
  for the active :class:`~brpc_tpu_torch.naming.PartitionScheme` and the
  primary claims riding the shard heartbeats, polls each shard's
  ``SchemeInfo`` for rate signals, feeds the policy, and EXECUTES
  decisions through exactly the machinery the operator path uses — a
  :class:`~brpc_tpu_torch.reshard.MigrationDriver` for splits/merges (new
  servers come from the injected ``provisioner``) and a fenced
  ``Promote`` for failbacks.  Nothing here holds a data path; a dead
  rebalancer degrades to the operator-driven fabric, never to an
  outage.
"""

from __future__ import annotations

import dataclasses
import json
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from brpc_tpu_torch import obs, resilience, rpc
from brpc_tpu_torch.naming import (NamingClient, PartitionScheme,
                                   parse_claims, parse_schemes)
from brpc_tpu_torch.reshard import MigrationDriver

__all__ = ["RebalanceOptions", "Decision", "RebalancePolicy",
           "Rebalancer"]


@dataclasses.dataclass(frozen=True)
class RebalanceOptions:
    """Policy knobs.  ``split_qps`` / ``merge_qps`` are PER-SHARD
    rates (reads + applied write batches per second); the gap between
    them is the hysteresis band — a load level that triggers a split
    must sit far above the level that triggers the merge back, or the
    pair would flap.  ``sustain_s`` is how long a signal must hold
    continuously before it may act; ``min_interval_s`` separates
    consecutive topology changes (a migration's cost is amortized over
    at least this long).  ``failback_sustain_s`` is deliberately
    shorter — promoting the declared primary back moves no data.

    ``split_p99_ms`` / ``split_shed_per_s`` are the TAIL-PRESSURE
    inputs (0.0 = disabled): a shard whose data-plane p99 or shed rate
    (deadline admission + limiter gates, from ``SchemeInfo``) sustains
    above the threshold splits even when its raw qps sits below
    ``split_qps`` — saturation shows up as latency and sheds first.
    Tail pressure also VETOES a merge: a shard can be slow precisely
    because it is starved of capacity, and halving capacity on a
    low-qps-high-latency signal would be the wrong direction."""

    split_qps: float = 200.0
    merge_qps: float = 20.0
    sustain_s: float = 1.0
    min_interval_s: float = 5.0
    max_shards: int = 16
    min_shards: int = 1
    failback: bool = True
    failback_sustain_s: float = 0.5
    split_p99_ms: float = 0.0
    split_shed_per_s: float = 0.0

    def __post_init__(self):
        if self.merge_qps * 2 > self.split_qps:
            raise ValueError(
                f"hysteresis band too narrow: merge_qps "
                f"{self.merge_qps} must sit at or below half of "
                f"split_qps {self.split_qps} or split→merge flaps")
        if self.min_shards < 1 or self.max_shards < self.min_shards:
            raise ValueError(
                f"shard bounds [{self.min_shards}, {self.max_shards}] "
                f"are not a range")


@dataclasses.dataclass(frozen=True)
class Decision:
    """One action the policy wants taken: ``kind`` is ``"split"`` /
    ``"merge"`` (with ``num_shards`` the TARGET shard count) or
    ``"failback"`` (with ``shard`` + ``addr`` the declared primary to
    promote back)."""

    kind: str
    num_shards: int = 0
    shard: int = -1
    addr: str = ""
    reason: str = ""


class RebalancePolicy:
    """The pure decision half: feed it per-shard rates (and primary
    placement) via :meth:`decide`; it answers at most one
    :class:`Decision`, with sustain/hysteresis/min-interval guards
    evaluated against the injected ``clock``.  Call
    :meth:`note_action` when a decision was actually executed — the
    min-interval window starts there, not at decision time."""

    def __init__(self, options: Optional[RebalanceOptions] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.opt = options or RebalanceOptions()
        self._clock = clock
        #: condition key -> the instant it became (and stayed) true
        self._since: Dict[str, float] = {}
        self._last_action: Optional[float] = None

    # -- guards ------------------------------------------------------------

    def _sustained(self, key: str, cond: bool, need_s: float) -> bool:
        """True once ``cond`` has held continuously for ``need_s``.
        Any gap resets the window — a flapping signal never acts."""
        now = self._clock()
        if not cond:
            self._since.pop(key, None)
            return False
        since = self._since.setdefault(key, now)
        return now - since >= need_s

    def _in_cooldown(self) -> bool:
        return (self._last_action is not None
                and self._clock() - self._last_action
                < self.opt.min_interval_s)

    def note_action(self) -> None:
        """An action was executed: open the min-interval window and
        drop accumulated sustain state (the topology the signals were
        measured against is gone)."""
        self._last_action = self._clock()
        self._since.clear()

    # -- the decision function --------------------------------------------

    def decide(self, num_shards: int, shard_qps: Sequence[float], *,
               misplaced: Sequence[Tuple[int, str]] = (),
               shard_p99_ms: Sequence[float] = (),
               shed_per_s: Sequence[float] = ()
               ) -> Optional[Decision]:
        """``shard_qps[s]`` is shard ``s``'s observed rate;
        ``misplaced`` lists ``(shard, declared_primary_addr)`` pairs
        whose current primary is NOT the declared one and whose
        declared one is caught up (the daemon verifies reachability
        and generation before reporting one).  ``shard_p99_ms`` /
        ``shed_per_s`` are the optional tail-pressure signals (worst
        replica data-plane p99 per shard, shed rate per shard) — only
        consulted when the corresponding option threshold is set.
        Priority: failback (cheap, no data moves) over split over
        merge."""
        opt = self.opt
        if opt.failback and misplaced:
            s, addr = misplaced[0]
            if self._sustained(f"failback:{s}:{addr}", True,
                               opt.failback_sustain_s):
                return Decision("failback", shard=s, addr=addr,
                                reason=f"declared primary {addr} is "
                                       f"healthy and caught up")
        else:
            # no misplaced shard: forget partial failback sustain
            for k in [k for k in self._since
                      if k.startswith("failback:")]:
                self._since.pop(k)
        hot = max(shard_qps, default=0.0)
        hot_p99 = max(shard_p99_ms, default=0.0)
        hot_shed = max(shed_per_s, default=0.0)
        pressure = ((opt.split_p99_ms > 0.0
                     and hot_p99 > opt.split_p99_ms)
                    or (opt.split_shed_per_s > 0.0
                        and hot_shed > opt.split_shed_per_s))
        split_cond = (num_shards * 2 <= opt.max_shards
                      and (hot > opt.split_qps or pressure))
        split_due = self._sustained("split", split_cond, opt.sustain_s)
        cold = max(shard_qps, default=0.0)
        merge_cond = (num_shards > opt.min_shards
                      and num_shards % 2 == 0
                      and cold < opt.merge_qps
                      and not pressure)
        merge_due = self._sustained("merge", merge_cond, opt.sustain_s)
        if self._in_cooldown():
            return None
        if split_due:
            if hot > opt.split_qps:
                why = (f"hottest shard at {hot:.1f}/s > split "
                       f"threshold {opt.split_qps}")
            else:
                why = (f"tail pressure: p99 {hot_p99:.1f}ms / shed "
                       f"{hot_shed:.1f}/s over thresholds "
                       f"(p99>{opt.split_p99_ms}ms, "
                       f"shed>{opt.split_shed_per_s}/s)")
            return Decision("split", num_shards=num_shards * 2,
                            reason=why)
        if merge_due:
            return Decision("merge", num_shards=num_shards // 2,
                            reason=f"every shard below "
                                   f"{opt.merge_qps}/s (peak "
                                   f"{cold:.1f}/s)")
        return None


class Rebalancer(threading.Thread):
    """The daemon half: observe → decide → execute, on a cadence.

    ``provisioner(version, num_shards) -> PartitionScheme`` is the only
    thing the rebalancer cannot do itself — bringing up the successor
    scheme's (importing) servers is the owner's business; the returned
    scheme must be registered/replicated and ready to import.  The
    contract is TIER-AGNOSTIC: a provisioner that builds
    :class:`~brpc_tpu_torch.ps_remote.DevicePsShardServer` rows gets live
    DEVICE splits and failbacks for free — every action here is a wire
    call (``ReplicaState``/``Promote``/the migration driver) that the
    device tier answers identically, staging/folding its HBM table at
    the promotion/demotion edges itself
    (tests/test_ps_device.py::test_device_rebalancer_failback_restages_declared_primary).
    ``on_retired(scheme)`` fires after a retiring scheme drains so the
    owner can close its servers (the handle-release half of
    retirement).  Both callbacks run on the rebalancer thread.

    :meth:`step` is one full observe→decide→execute cycle and is public
    so tests (and the churn bench) can drive it deterministically; the
    thread just calls it on a loop.  Every action is also counted
    (``ps_rebalance_splits`` / ``ps_rebalance_merges`` /
    ``ps_failbacks`` / ``ps_rebalance_errors``)."""

    def __init__(self, registry_addr: str, cluster: str, vocab: int, *,
                 policy: Optional[RebalancePolicy] = None,
                 provisioner: Optional[Callable[[int, int],
                                               PartitionScheme]] = None,
                 on_retired: Optional[Callable[[PartitionScheme],
                                               None]] = None,
                 interval_ms: float = 200.0, timeout_ms: int = 2000,
                 migrate_deadline_s: float = 30.0,
                 drain_deadline_s: float = 10.0,
                 ramp_steps: Optional[Sequence[float]] = None,
                 checkpoint_stores=None):
        super().__init__(daemon=True, name="brt-rebalancer")
        self.registry_addr = registry_addr
        self.cluster = cluster
        self.vocab = vocab
        self.policy = policy or RebalancePolicy()
        self.provisioner = provisioner
        self.on_retired = on_retired
        self.interval_ms = interval_ms
        self.timeout_ms = timeout_ms
        self.migrate_deadline_s = migrate_deadline_s
        self.drain_deadline_s = drain_deadline_s
        self.ramp_steps = ramp_steps
        #: source-shard checkpoint stores for split/merge destination
        #: seeding: a ``{shard_index: CheckpointStore}`` map over the
        #: ACTIVE scheme, or a callable ``(scheme, shard) -> store``
        #: (indices shift across versions — a callable tracks them).
        #: When a source has one, every decided migration seeds its
        #: destinations from the on-disk base BEFORE the copy phase,
        #: so the live source ships only the delta tail.
        self.checkpoint_stores = checkpoint_stores
        self._reg = NamingClient(registry_addr)
        # All mutable state below is owned by the rebalancer thread
        # (step() from tests runs before start() or after stop()).
        self._chans: Dict[str, rpc.Channel] = {}
        self._halt = threading.Event()
        #: last (reads+gen, monotonic instant) sample per (version,
        #: shard) — rate signals are deltas between polls
        self._samples: Dict[tuple, Tuple[int, float]] = {}
        #: last (shed total, monotonic instant) per (version, shard) —
        #: the shed-rate half of the tail-pressure signal
        self._shed_samples: Dict[tuple, Tuple[int, float]] = {}
        self.actions: List[Decision] = []
        #: failed executions, newest last (bounded) — the observable
        #: trail behind ps_rebalance_errors
        self.errors: List[str] = []
        #: decision trail (bounded): what was decided, on which scheme,
        #: off which rates — the churn bench's post-mortem surface
        self.log: List[str] = []

    # -- plumbing ----------------------------------------------------------

    def _chan(self, addr: str) -> rpc.Channel:
        ch = self._chans.get(addr)
        if ch is None:
            ch = rpc.Channel(addr, timeout_ms=self.timeout_ms)
            self._chans[addr] = ch
        return ch

    def _state_of(self, addr: str) -> Optional[dict]:
        try:
            return json.loads(self._chan(addr).call(
                "Ps", "ReplicaState", b"", timeout_ms=self.timeout_ms))
        except rpc.RpcError:
            return None

    def _primary_of(self, scheme: PartitionScheme, s: int,
                    claims: dict) -> Optional[str]:
        """The shard's CURRENT primary: the registry claim when one
        exists (scheme-scoped first), else a ReplicaState sweep."""
        rs = scheme.replica_sets[s]
        claim = claims.get((scheme.version, scheme.num_shards, s)) \
            or claims.get((None, scheme.num_shards, s))
        if claim is not None and claim[1] in rs.addresses:
            return claim[1]
        best = None
        for a in rs.addresses:
            st = self._state_of(a)
            if st and st.get("primary") and \
                    (best is None or st["epoch"] > best[0]):
                best = (st["epoch"], a)
        return best[1] if best else None

    # -- one observe→decide→execute cycle ----------------------------------

    def observe(self) -> Optional[dict]:
        """Collect the active scheme, per-shard rates, and misplaced
        primaries.  Returns ``None`` when the cluster is not in a
        steady observable state (no active scheme, or a migration
        already in flight — a PREPARING scheme published)."""
        try:
            nodes, _ = self._reg.list(self.cluster)
        except Exception:  # noqa: BLE001 — registry outage: skip tick
            return None
        schemes = parse_schemes(nodes)
        live = [sc for sc in schemes.values() if sc.state != "retired"]
        active = [sc for sc in live if sc.state == "active"]
        if not active:
            return None
        if any(sc.state == "preparing" for sc in live):
            return None   # a migration is already in flight
        scheme = max(active, key=lambda sc: sc.version)
        claims = parse_claims(nodes)
        rates: List[float] = []
        p99s: List[float] = []
        sheds: List[float] = []
        misplaced: List[Tuple[int, str]] = []
        now = time.monotonic()
        for s in range(scheme.num_shards):
            cur = self._primary_of(scheme, s, claims)
            # reads route to ANY replica by score: the shard's rate is
            # the SUM of its replicas' read counters (plus the applied
            # write batches, visible as the max generation)
            reads = 0
            gen = 0
            reachable = 0
            p99_us = 0.0
            shed_total = 0
            for a in scheme.replica_sets[s].addresses:
                try:
                    info = json.loads(self._chan(a).call(
                        "Ps", "SchemeInfo", b"",
                        timeout_ms=self.timeout_ms))
                except rpc.RpcError:
                    continue
                reachable += 1
                reads += int(info.get("reads", 0))
                gen = max(gen, int(info.get("gen", 0)))
                # worst replica's data-plane p99 + the shard's total
                # shed count: the tail-pressure inputs
                p99_us = max(p99_us, float(info.get("p99_us", 0.0)))
                shed_total += int(info.get("shed", 0))
            if not reachable:
                rates.append(0.0)
                p99s.append(0.0)
                sheds.append(0.0)
                continue
            total = reads + gen
            key = (scheme.version, s)
            prev = self._samples.get(key)
            self._samples[key] = (total, now)
            if prev is None or now <= prev[1] or total < prev[0]:
                rates.append(0.0)
            else:
                rates.append((total - prev[0]) / (now - prev[1]))
            p99s.append(p99_us / 1000.0)
            sprev = self._shed_samples.get(key)
            self._shed_samples[key] = (shed_total, now)
            if sprev is None or now <= sprev[1] or \
                    shed_total < sprev[0]:
                sheds.append(0.0)
            else:
                sheds.append((shed_total - sprev[0]) / (now - sprev[1]))
            declared = scheme.replica_sets[s].addresses[
                scheme.replica_sets[s].primary]
            if cur is not None and cur != declared:
                # Sample the USURPER first: under continuous quorum
                # writes its gen advances between the two reads, so
                # declared.gen(t2) >= cur.gen(t1) is exactly "the
                # declared replica acked everything the usurper held a
                # moment ago" — sampled the other way round, a busy
                # shard never looks caught up and failback starves.
                cur_st = self._state_of(cur)
                st = self._state_of(declared)
                if st is not None and cur_st is not None and \
                        not st.get("primary") and \
                        int(st["gen"]) >= int(cur_st["gen"]):
                    # the declared primary is back, demoted, and holds
                    # everything the usurper holds: safe to fail back
                    misplaced.append((s, declared))
        return {"scheme": scheme, "rates": rates, "p99s": p99s,
                "sheds": sheds, "misplaced": misplaced,
                "claims": claims}

    def step(self) -> Optional[Decision]:
        """One full cycle; returns the executed decision, if any."""
        view = self.observe()
        if view is None:
            return None
        scheme: PartitionScheme = view["scheme"]
        decision = self.policy.decide(scheme.num_shards, view["rates"],
                                      misplaced=view["misplaced"],
                                      shard_p99_ms=view["p99s"],
                                      shed_per_s=view["sheds"])
        if decision is None:
            return None
        self.log.append(
            f"decide {decision.kind} on v{scheme.version} "
            f"({scheme.num_shards} shards) rates="
            f"{[round(r, 1) for r in view['rates']]} "
            f"misplaced={view['misplaced']}")
        del self.log[:-30]
        try:
            self._execute(scheme, decision, view)
        except Exception as e:  # noqa: BLE001 — an action failing must
            # not kill the loop; the fabric stays in its pre-action
            # state (MigrationDriver.abort rolled fences back and
            # retired the stillborn successor record) and the next
            # tick re-decides.
            if obs.enabled():
                obs.counter("ps_rebalance_errors").add(1)
            self.errors.append(
                f"{decision.kind}->{decision.num_shards or decision.addr}"
                f": {type(e).__name__}: {e}"[:300])
            del self.errors[:-20]
            return None
        self.policy.note_action()
        self.actions.append(decision)
        return decision

    def _execute(self, scheme: PartitionScheme, decision: Decision,
                 view: dict) -> None:
        if decision.kind == "failback":
            self._failback(scheme, decision, view["claims"])
            return
        if self.provisioner is None:
            raise RuntimeError(
                "split/merge decided but no provisioner was given")
        successor = self.provisioner(scheme.version + 1,
                                     decision.num_shards)
        drv = MigrationDriver(scheme, successor, self.vocab,
                              registry_addr=self.registry_addr,
                              cluster=self.cluster,
                              timeout_ms=self.timeout_ms)
        try:
            self._auto_hydrate(scheme, drv)
            try:
                drv.run(deadline_s=self.migrate_deadline_s,
                        ramp_steps=self.ramp_steps)
            except Exception:
                drv.abort()   # leave the old scheme serving untouched
                raise
            if obs.enabled():
                obs.counter("ps_rebalance_splits"
                            if decision.kind == "split"
                            else "ps_rebalance_merges").add(1)
            # The topology change is DONE (successor active, sources
            # fenced): drain/retire are housekeeping and their failure
            # must not read as a failed action (and must not suppress
            # the cooldown) — but retire MUST still be published, or
            # the old scheme lingers draining and its servers never
            # release.
            try:
                drv.wait_drained(idle_s=0.3,
                                 deadline_s=self.drain_deadline_s)
            except Exception as e:  # noqa: BLE001 — drained-ness is
                # a read-counter heuristic; retirement proceeds
                self.errors.append(
                    f"drain v{scheme.version}: "
                    f"{type(e).__name__}: {e}"[:200])
            drv.retire()
            if self.on_retired is not None:
                self.on_retired(scheme)
        finally:
            drv.close()

    def _auto_hydrate(self, scheme: PartitionScheme,
                      drv: MigrationDriver) -> None:
        """Seed every destination of the decided migration from the
        source's attached checkpoint store, before the copy phase: the
        destination records the seeded watermark, so the live source's
        shipper (hydrate-first mode) ships only the delta tail instead
        of a wholesale range snapshot.  Strictly best-effort — any
        failure leaves the destination unseeded and the shipper's
        wholesale path converges exactly as without a store."""
        if self.checkpoint_stores is None:
            return
        from brpc_tpu_torch import durable
        for s in range(scheme.num_shards):
            store = (self.checkpoint_stores(scheme, s)
                     if callable(self.checkpoint_stores)
                     else self.checkpoint_stores.get(s))
            if store is None:
                continue
            try:
                src_addr = drv._live_primary(scheme, s)
                olo, _ = scheme.shard_bounds(s, self.vocab)
                for t in drv.targets_for(s):
                    durable.hydrate_destination(
                        store, t["addr"], drv.new.version, src_addr,
                        olo, t["base"], t["rows"],
                        timeout_ms=self.timeout_ms)
                    if obs.enabled():
                        obs.counter("ps_rebalance_hydrations").add(1)
            except (rpc.RpcError, ValueError, OSError) as e:
                if obs.enabled():
                    obs.counter("ps_rebalance_hydrate_errors").add(1)
                self.errors.append(
                    f"hydrate s{s}: {type(e).__name__}: {e}"[:200])
                del self.errors[:-20]

    def _failback(self, scheme: PartitionScheme, decision: Decision,
                  claims: dict) -> None:
        """Promote the declared primary back into its role: a fenced
        Promote with an epoch above everything observed — the usurper
        demotes on its next propagation, clients converge through
        claims/ENOTPRIMARY exactly as in a failure-driven failover."""
        rs = scheme.replica_sets[decision.shard]
        epochs = [0]
        for a in rs.addresses:
            st = self._state_of(a)
            if st is not None:
                epochs.append(int(st["epoch"]))
        claim = claims.get((scheme.version, scheme.num_shards,
                            decision.shard))
        if claim is not None:
            epochs.append(int(claim[0]))
        try:
            self._chan(decision.addr).call(
                "Ps", "Promote", struct.pack("<q", max(epochs) + 1),
                timeout_ms=self.timeout_ms)
        except rpc.RpcError as e:
            if e.code == resilience.EFENCED:
                # Lost a Promote race: a client failover (or another
                # rebalancer) claimed a higher epoch between our epoch
                # sweep and the call.  Benign — the next tick
                # re-observes placement against the winner's epoch —
                # so re-resolve QUIETLY behind a counter instead of
                # surfacing an error (PR-13 residue).
                if obs.enabled():
                    obs.counter("ps_promote_races").add(1)
                return
            raise
        if obs.enabled():
            obs.counter("ps_failbacks").add(1)

    # -- the daemon loop ---------------------------------------------------

    def run(self) -> None:
        backoff = resilience.Backoff(base_ms=self.interval_ms,
                                     multiplier=1.0,
                                     max_ms=self.interval_ms,
                                     jitter=0.25)
        tick = 0
        while not self._halt.is_set():
            tick += 1
            if self._halt.wait(backoff.delay_ms(tick) / 1000.0):
                break
            try:
                self.step()
            except Exception:  # noqa: BLE001 — the loop must survive
                if obs.enabled():
                    obs.counter("ps_rebalance_errors").add(1)

    def stop(self) -> None:
        self._halt.set()
        if self.is_alive():
            self.join(timeout=max(5.0, self.migrate_deadline_s
                                  + self.drain_deadline_s + 5.0))
        self._reg.close()
        for ch in self._chans.values():
            ch.close()
        self._chans.clear()
