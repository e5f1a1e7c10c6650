"""Elastic resharding: live shard split/merge under traffic.

The DynamicPartitionChannel analog over the naming registry (SURVEY
§2.7 — multiple partitioning schemes live *simultaneously*, traffic
weighted by capacity; reference ``partition_channel.h:136`` /
``dynpart_load_balancer.cpp``): a table's partitioning is a versioned
:class:`brpc_tpu_torch.naming.PartitionScheme`, and growing (or shrinking)
the shard count is a RUNTIME operation, not a redeploy:

1. **Copy** — every source shard (the retiring scheme's primaries)
   streams its rows to the successor scheme's shards: a
   :class:`MigrationShipper` per source ships a range-filtered
   ``MigrateSync`` (rows pinned at one generation — the PR-4/PR-6
   handle-generation discipline) and then every APPLIED batch over the
   same ``ReplicaApply`` framing as replication, per-writer dedup
   windows riding along so replay stays idempotent across the scheme
   boundary.  Writes keep landing on the source the whole time.
2. **Cutover** — ``SchemeFence``: the source stops admitting writes
   (stale-scheme writers get ``ESCHEMEMOVED``, the redirect error that
   triggers client scheme refresh — the PR-9 EFENCED machinery one
   level up), drains what it already admitted, and flushes the final
   generation to every destination.  Then ``CompleteImport`` opens the
   destinations (which until now answered ``EMIGRATING`` so reads fell
   back to the source scheme) and the registry publishes the successor
   as the active scheme.
3. **Drain & retire** — the retired scheme keeps serving READS (its
   tables are frozen at exactly the cutover state, so they stay
   correct) while clients refresh and its traffic weight decays to
   zero; once its shards go idle the scheme is retired and its servers
   released.

:class:`MigrationDriver` orchestrates the phases over plain control
RPCs — it holds no data path and can run anywhere.  The shipper runs
INSIDE the source server process (installed by the ``MigrateStart``
control), because only the source can enqueue applied batches under
its own write lock in apply order.
"""

from __future__ import annotations

import collections
import json
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from brpc_tpu_torch import obs, resilience, rpc, wire
from brpc_tpu_torch.analysis.race import checked_lock
from brpc_tpu_torch.naming import (NamingClient, PartitionScheme,
                             publish_scheme)
from brpc_tpu_torch.ps_remote import (_pack_apply_req, _pack_stream_frame,
                                _pack_stream_frame_iobuf, _pack_windows,
                                _reject_frame, _unpack_apply,
                                _unpack_windows, zerocopy_enabled)


class _ShipperAckReceiver:
    """Source-side read half of a migration stream: collects the
    destination's per-frame watermark acks."""

    __slots__ = ("_shipper", "_addr")

    def __init__(self, shipper, addr: str):
        self._shipper = shipper
        self._addr = addr

    def on_data(self, data: bytes) -> None:
        if len(data) < 8:
            _reject_frame("MigrateAck")
            return
        (gen,) = struct.unpack_from("<q", data, 0)
        self._shipper._note_ack(self._addr, gen)

    def on_closed(self) -> None:
        self._shipper._note_closed(self._addr)


class _TargetState:
    """One destination shard's handoff state (owned by its worker
    thread; queue/ack fields shared under the shipper lock)."""

    __slots__ = ("addr", "base", "rows", "replicas", "queue", "wake",
                 "stream", "synced_gen", "acked_gen", "last_gen",
                 "need_sync", "down", "refused")

    def __init__(self, addr: str, base: int, rows: int, replicas=()):
        self.addr = addr
        self.base = base
        self.rows = rows
        #: the destination's full replica group (spec "replicas"): a
        #: dead destination PRIMARY is re-resolved against it instead
        #: of stranding the worker on the spec's fixed address
        self.replicas = tuple(replicas)
        self.queue: collections.deque = collections.deque()
        self.wake = threading.Event()
        self.stream: "Optional[rpc.Stream]" = None
        self.synced_gen = -1
        self.acked_gen = -1
        #: highest source generation that actually SHIPPED something to
        #: this target (batches with no ids in the target's range skip
        #: the queue; the flush barrier waits on this, not the raw gen)
        self.last_gen = -1
        self.need_sync = True
        self.down = False
        #: terminal: the destination refused (import already completed)
        self.refused = False


class MigrationShipper:
    """Source-side row-range handoff: one worker thread per destination
    ships a consistent range Sync (rows + windows pinned at one
    generation under the read lock) and then every applied batch,
    range-filtered, in apply order, over a persistent ``MigrateApply``
    stream.  ``ship`` is an append under the shipper lock — the
    applying writer never blocks on a slow destination; a destination
    more than ``max_queue`` batches behind is resynced wholesale.
    ``flush(target_gen)`` is the cutover barrier: it returns only once
    EVERY destination holds everything shipped up to ``target_gen`` —
    unlike the replication flush, an unreachable destination is waited
    for (and times out loudly), never skipped: cutover must not
    complete with a hole."""

    def __init__(self, server, targets: List[dict], scheme: int,
                 max_queue: int = 1024, timeout_ms: int = 5000):
        self._server = server
        self.scheme = int(scheme)
        self.max_queue = max_queue
        self.timeout_ms = timeout_ms
        self._mu = checked_lock("ps.migrate")
        self._stop = threading.Event()
        self._ack_ev = threading.Event()
        self._chans: Dict[str, rpc.Channel] = {}
        self._targets = [_TargetState(t["addr"], int(t["base"]),
                                      int(t["rows"]),
                                      t.get("replicas") or ())
                         for t in targets]
        self._threads: List[threading.Thread] = []

    def start(self) -> None:
        """Spawn the per-destination workers.  MUST be called only
        after this shipper is INSTALLED as the server's migrator: the
        workers' range snapshots race the apply path otherwise — a
        batch applied between a worker's snapshot and the installation
        would neither be in the snapshot nor shipped (a silently lost
        update, found the hard way)."""
        if self._threads:
            return
        for t in self._targets:
            th = threading.Thread(target=self._worker, args=(t,),
                                  daemon=True,
                                  name=f"brt-migrate-{t.addr}")
            th.start()
            self._threads.append(th)

    # -- the apply path's side (non-blocking, under the shard write lock)

    def ship(self, gen: int, gids: np.ndarray, grads: np.ndarray,
             windows: Dict[str, int]) -> None:
        """Enqueue one applied batch (GLOBAL ids) for every destination
        whose range it touches.  Batches are filtered per target — an
        untouched target's watermark is advanced by the flush barrier's
        ``last_gen`` accounting instead of an empty frame."""
        wire_windows = _pack_windows(windows)
        shipped = 0
        for t in self._targets:
            mask = (gids >= t.base) & (gids < t.base + t.rows)
            if not mask.any():
                continue
            body = wire_windows + bytes(
                _pack_apply_req(gids[mask], grads[mask]))
            frame = bytes(_pack_stream_frame(gen, self.scheme, gen,
                                             body))
            with self._mu:
                t.queue.append((gen, frame))
                t.last_gen = gen
                if len(t.queue) > self.max_queue:
                    # Hopelessly behind: resync wholesale on reconnect
                    # rather than holding every batch in memory.
                    t.queue.clear()
                    t.need_sync = True
            t.wake.set()
            shipped += 1
        if shipped and obs.enabled():
            obs.counter("ps_migrate_frames").add(shipped)

    # -- ack plumbing ------------------------------------------------------

    def _note_ack(self, addr: str, gen: int) -> None:
        with self._mu:
            for t in self._targets:
                if t.addr == addr and gen > t.acked_gen:
                    t.acked_gen = gen
        self._ack_ev.set()

    def _note_closed(self, addr: str) -> None:
        with self._mu:
            for t in self._targets:
                if t.addr == addr:
                    t.need_sync = True
        self._ack_ev.set()

    def state(self) -> Dict[str, dict]:
        with self._mu:
            return {t.addr: {
                "acked": t.acked_gen, "pending": len(t.queue),
                "synced": t.stream is not None and not t.need_sync,
                "down": t.down, "refused": t.refused,
            } for t in self._targets}

    def flush(self, target_gen: int, timeout_s: float = 5.0) -> None:
        """Returns once every destination holds everything shipped at
        or below ``target_gen``: its sync landed, its queue drained,
        and its last relevant frame was acked.  Raises ERPCTIMEDOUT
        naming the laggard (also when the shipper is STOPPED before the
        wait settles — an abort racing the fence), or ESCHEMEMOVED if a
        destination refused (completed import) — all mean the cutover
        must not proceed as if the handoff were complete."""
        deadline = time.monotonic() + timeout_s
        for t in self._targets:
            while True:
                with self._mu:
                    live = (t.stream is not None and not t.need_sync
                            and not t.down)
                    settled = (live and not t.queue
                               and t.acked_gen >= min(t.last_gen,
                                                      target_gen)
                               and t.synced_gen >= 0)
                    refused = t.refused
                if refused:
                    raise rpc.RpcError(
                        resilience.ESCHEMEMOVED,
                        f"destination {t.addr} refused the handoff "
                        f"(import already completed)")
                if settled:
                    break
                if self._stop.is_set():
                    # A stop/abort racing the cutover flush must fail
                    # it loudly: returning would let the fence report
                    # success without every destination holding the
                    # final generation.
                    raise rpc.RpcError(
                        1008,
                        f"migration shipper stopped before destination "
                        f"{t.addr} confirmed gen {target_gen} "
                        f"(acked {t.acked_gen})")
                if time.monotonic() > deadline:
                    raise rpc.RpcError(
                        1008,
                        f"destination {t.addr} did not settle at gen "
                        f"{target_gen} within {timeout_s:.1f}s "
                        f"(acked {t.acked_gen}, pending "
                        f"{len(t.queue)}, down={t.down})")
                self._ack_ev.clear()
                self._ack_ev.wait(0.005)

    # -- per-destination worker -------------------------------------------

    def _channel(self, addr: str) -> "Optional[rpc.Channel]":
        """None once the shipper stopped — a worker racing ``stop``
        must not recreate a channel behind the closed set."""
        with self._mu:
            if self._stop.is_set():
                return None
            ch = self._chans.get(addr)
            if ch is None:
                ch = rpc.Channel(addr, timeout_ms=self.timeout_ms)
                self._chans[addr] = ch
            return ch

    def _connect(self, t: _TargetState) -> bool:
        """Range handoff then a fresh delta stream: ``MigrateSync``
        ships a consistent (gen, rows, windows) slice — the destination
        installs it wholesale — and the stream resumes from that
        generation (queued frames at or below it are ship-skipped)."""
        gen, rows, windows = self._server._migration_snapshot(
            t.base, t.rows)
        src = self._server.address.encode()
        ch = self._channel(t.addr)
        if ch is None:
            return False
        try:
            ch.call("Ps", "MigrateSync",
                    struct.pack("<qqqq", self.scheme, gen, t.base,
                                t.rows)
                    + struct.pack("<i", len(src)) + src
                    + rows + _pack_windows(windows),
                    timeout_ms=self.timeout_ms)
            st = ch.stream("Ps", "MigrateApply",
                           struct.pack("<q", self.scheme)
                           + struct.pack("<i", len(src)) + src,
                           receiver=_ShipperAckReceiver(self, t.addr))
        except rpc.RpcError as e:
            if e.code == resilience.ESCHEMEMOVED:
                with self._mu:
                    t.refused = True
                self._ack_ev.set()
                return False
            with self._mu:
                t.down = True
            self._ack_ev.set()
            if obs.enabled():
                obs.counter("ps_migrate_connect_errors").add(1)
            return False
        with self._mu:
            t.stream = st
            t.synced_gen = gen
            t.need_sync = False
            t.down = False
            if gen > t.acked_gen:
                t.acked_gen = gen   # the Sync response IS the ack
            if gen > t.last_gen:
                t.last_gen = gen
        self._ack_ev.set()
        if obs.enabled():
            obs.counter("ps_migrate_syncs_out").add(1)
            obs.counter("ps_migrate_sync_bytes").add(len(rows))
        return True

    def _try_hydrate(self, t: _TargetState) -> Optional[bool]:
        """Hydrate-first (re)connect: a destination already seeded from
        the source's checkpoint store (``durable.hydrate_destination``)
        — or surviving a stream blip — advertises its per-source
        watermark in the ``MigrateApply`` setup answer; when that
        watermark sits inside the store's delta window, ship only the
        range-filtered TAIL from disk instead of snapshotting and
        wholesaling the live rows.  Returns True on success, False on a
        hard failure, None to fall through to the wholesale
        ``_connect``."""
        store = getattr(self._server, "_durable", None)
        if store is None:
            return None
        src = self._server.address.encode()
        ch = self._channel(t.addr)
        if ch is None:
            return False
        try:
            st = ch.stream("Ps", "MigrateApply",
                           struct.pack("<q", self.scheme)
                           + struct.pack("<i", len(src)) + src,
                           receiver=_ShipperAckReceiver(self, t.addr))
        except rpc.RpcError as e:
            if e.code == resilience.ESCHEMEMOVED:
                with self._mu:
                    t.refused = True
                self._ack_ev.set()
                return False
            with self._mu:
                t.down = True
            self._ack_ev.set()
            if obs.enabled():
                obs.counter("ps_migrate_connect_errors").add(1)
            return False
        try:
            (mark,) = wire.read("<q", st.response, 0,
                                "MigrateApply.rsp")
        except wire.WireError:
            st.close()
            return None
        if mark < 0:
            st.close()
            return None   # never seeded: only the wholesale path may
        deltas = store.tail_since(mark)
        if deltas is None or mark > store.last_gen:
            st.close()
            return None   # watermark outside the delta window
        # Delta bodies carry GLOBAL ids across the whole source shard;
        # parse against the source range, then re-filter per target —
        # the destination's parser rejects out-of-range ids.
        glast = mark        # last source gen RELEVANT to this target
        slast = mark        # last source gen covered (relevant or not)
        tail_bytes = 0
        batch = []          # zero-copy mode: whole tail in one writev
        try:
            for gen, body in deltas:
                windows, off = _unpack_windows(body)
                gids, grads = _unpack_apply(
                    memoryview(body)[off:], 0,
                    self._server.base + self._server.rows_per,
                    self._server.dim)
                slast = gen
                mask = (gids >= t.base) & (gids < t.base + t.rows)
                if not mask.any():
                    continue
                filtered = (_pack_windows(windows)
                            + bytes(_pack_apply_req(
                                gids[mask].astype(np.int32),
                                grads[mask])))
                if zerocopy_enabled():
                    batch.append(_pack_stream_frame_iobuf(
                        gen, self.scheme, gen, filtered))
                    tail_bytes += len(batch[-1])
                else:
                    frame = bytes(_pack_stream_frame(
                        gen, self.scheme, gen, filtered))
                    st.write(frame)
                    tail_bytes += len(frame)
                glast = gen
            if batch:
                st.writev(batch)
        except (rpc.RpcError, wire.WireError):
            st.close()
            return None   # bad tail or dead stream: wholesale converges
        finally:
            for io in batch:
                io.close()
        with self._mu:
            t.stream = st
            t.synced_gen = slast
            t.need_sync = False
            t.down = False
            if mark > t.acked_gen:
                t.acked_gen = mark   # the seed watermark IS an ack
            if glast > t.last_gen:
                t.last_gen = glast
        self._ack_ev.set()
        if obs.enabled():
            obs.counter("ps_migrate_hydrates").add(1)
            obs.counter("ps_migrate_hydrate_tail_bytes").add(tail_bytes)
        return True

    def _retarget(self, t: _TargetState) -> bool:
        """A destination PRIMARY died mid-copy and the spec's fixed
        address strands the worker (the PR-13 residue): sweep the
        destination's replica group for the CURRENT primary — the same
        ``ReplicaState`` highest-claiming-epoch discipline the driver
        uses — and re-point the worker at it.  The next connect
        re-issues the handoff against the survivor (hydrate-first,
        wholesale fallback: a promoted backup that never saw
        ``MigrateApply`` answers watermark -1 and resyncs wholesale).
        Returns True when the worker was re-pointed somewhere new."""
        best: "Optional[tuple]" = None
        for a in t.replicas:
            ch = self._channel(a)
            if ch is None:
                return False    # shipper stopping
            try:
                st = json.loads(ch.call(
                    "Ps", "ReplicaState", b"",
                    timeout_ms=min(self.timeout_ms, 1000)))
            except (rpc.RpcError, ValueError):
                continue
            if st.get("primary") and (best is None
                                      or int(st["epoch"]) > best[0]):
                best = (int(st["epoch"]), a)
        if best is None or best[1] == t.addr:
            return False
        with self._mu:
            t.addr = best[1]
            t.need_sync = True
            t.down = False
        self._ack_ev.set()
        if obs.enabled():
            obs.counter("ps_migration_retargets").add(1)
        return True

    def _worker(self, t: _TargetState) -> None:
        backoff = resilience.Backoff(base_ms=5.0, max_ms=200.0)
        fails = 0
        while not self._stop.is_set():
            with self._mu:
                refused = t.refused
                item = t.queue[0] if (t.queue and not t.need_sync
                                      and t.stream is not None) else None
                need_connect = (not refused
                                and (t.need_sync or t.stream is None))
            if refused:
                return
            if need_connect:
                old, t.stream = t.stream, None
                if old is not None:
                    old.close()   # rx stream: close (abort strands relay)
                ok = self._try_hydrate(t)
                if ok is None:
                    ok = self._connect(t)
                if ok:
                    fails = 0
                else:
                    if self._stop.is_set() or t.refused:
                        return
                    fails += 1
                    # Two straight connect failures against a
                    # replicated destination: stop hammering the dead
                    # address and chase the promoted primary.
                    if fails >= 2 and t.replicas and self._retarget(t):
                        fails = 0
                        continue
                    resilience.sleep_ms(backoff.delay_ms(min(fails, 6)))
                continue
            if item is None:
                t.wake.wait(0.05)
                t.wake.clear()
                continue
            gen, frame = item
            if gen <= t.synced_gen:
                with self._mu:
                    if t.queue and t.queue[0] is item:
                        t.queue.popleft()
                continue
            if zerocopy_enabled():
                # Batch the eligible head run through one writev —
                # queue gens are append-ordered, so once the head
                # clears ``synced_gen`` the whole run does.
                with self._mu:
                    batch = []
                    for it in t.queue:
                        if it[0] <= t.synced_gen:
                            break
                        batch.append(it)
                        if len(batch) >= 64:
                            break
                try:
                    t.stream.writev([it[1] for it in batch])
                except rpc.RpcError as e:
                    nw = getattr(e, "frames_written", 0)
                    st, t.stream = t.stream, None
                    if st is not None:
                        st.close()
                    with self._mu:
                        for it in batch[:nw]:
                            if t.queue and t.queue[0] is it:
                                t.queue.popleft()
                        t.need_sync = True
                    continue
                with self._mu:
                    for it in batch:
                        if t.queue and t.queue[0] is it:
                            t.queue.popleft()
                continue
            try:
                t.stream.write(frame)
            except rpc.RpcError:
                st, t.stream = t.stream, None
                if st is not None:
                    st.close()
                with self._mu:
                    t.need_sync = True
                continue  # frame stays queued; resync covers ordering
            with self._mu:
                if t.queue and t.queue[0] is item:
                    t.queue.popleft()

    def stop(self, join: bool = True) -> None:
        self._stop.set()
        self._ack_ev.set()
        for t in self._targets:
            t.wake.set()
        if join:
            for th in self._threads:
                th.join(timeout=5)
        for t in self._targets:
            st, t.stream = t.stream, None
            if st is not None:
                st.close()
        for ch in self._chans.values():
            ch.close()
        self._chans.clear()


# ---------------------------------------------------------------------------
# the migration driver (control plane only — runs anywhere)
# ---------------------------------------------------------------------------

def _overlaps(lo_a: int, hi_a: int, lo_b: int, hi_b: int) -> bool:
    return lo_a < hi_b and lo_b < hi_a


class MigrationDriver:
    """Drives one live reshard ``old_scheme -> new_scheme`` end to end
    over control RPCs:

    - :meth:`start` installs a :class:`MigrationShipper` on every
      source primary (``MigrateStart`` with its overlapping
      destinations);
    - :meth:`wait_caught_up` polls ``MigrateState`` until every
      destination synced and drained its queue;
    - :meth:`cutover` fences every source (``SchemeFence`` — the write
      redirect + final flush), then opens every destination
      (``CompleteImport``), then publishes the scheme transition to the
      registry (successor active, retiring scheme draining at weight
      0);
    - :meth:`wait_drained` watches the retiring shards' read counters
      until traffic stops; :meth:`retire` publishes the retired state
      (the owner then closes the old servers, releasing their tables);
    - :meth:`abort` tears the shippers down and leaves the old scheme
      exactly as it was (the untouched write path) — the destination
      servers stay importing and can simply be closed.

    ``run()`` chains copy → catch-up → cutover and returns a summary.
    The driver never touches row data; a lost driver can re-run any
    phase (every control is idempotent)."""

    def __init__(self, old_scheme: PartitionScheme,
                 new_scheme: PartitionScheme, vocab: int, *,
                 registry_addr: Optional[str] = None,
                 cluster: Optional[str] = None,
                 timeout_ms: int = 10_000):
        if new_scheme.version <= old_scheme.version:
            raise ValueError(
                f"successor version {new_scheme.version} must exceed "
                f"{old_scheme.version}")
        self.old = old_scheme
        self.new = new_scheme
        self.vocab = vocab
        self.registry_addr = registry_addr
        self.cluster = cluster
        self.timeout_ms = timeout_ms
        self._chans: Dict[str, rpc.Channel] = {}
        #: resolved live primaries, keyed (scheme version, shard)
        self._primaries: Dict[tuple, str] = {}
        self._registry: Optional[NamingClient] = None

    # -- plumbing ----------------------------------------------------------

    def _chan(self, addr: str) -> rpc.Channel:
        ch = self._chans.get(addr)
        if ch is None:
            ch = rpc.Channel(addr, timeout_ms=self.timeout_ms)
            self._chans[addr] = ch
        return ch

    def _naming(self) -> Optional[NamingClient]:
        if self.registry_addr is None:
            return None
        if self._registry is None:
            self._registry = NamingClient(self.registry_addr)
        return self._registry

    @staticmethod
    def _primary(scheme: PartitionScheme, s: int) -> str:
        rs = scheme.replica_sets[s]
        return rs.addresses[rs.primary]

    def _live_primary(self, scheme: PartitionScheme, s: int,
                      refresh: bool = False) -> str:
        """The CURRENT primary of shard ``s`` — for replicated sources
        the boot primary may have died mid-migration and a promoted
        backup (which re-drove the shipper from its replicated spec)
        now owns the range.  Resolved by a ``ReplicaState`` sweep
        (highest claiming epoch wins), cached per (scheme, shard), and
        re-resolved when a cached answer fails (``refresh=True``).
        Single-replica shards short-circuit to the declared address."""
        rs = scheme.replica_sets[s]
        if len(rs.addresses) == 1:
            return rs.addresses[rs.primary]
        key = (scheme.version, s)
        if not refresh:
            cached = self._primaries.get(key)
            if cached is not None:
                return cached
        best: "Optional[tuple]" = None
        for a in rs.addresses:
            try:
                st = json.loads(self._chan(a).call(
                    "Ps", "ReplicaState", b"",
                    timeout_ms=min(self.timeout_ms, 1000)))
            except rpc.RpcError:
                continue
            if st.get("primary") and (best is None
                                      or int(st["epoch"]) > best[0]):
                best = (int(st["epoch"]), a)
        addr = best[1] if best is not None else rs.addresses[rs.primary]
        self._primaries[key] = addr
        return addr

    def _call_shard(self, scheme: PartitionScheme, s: int, method: str,
                    payload: bytes) -> bytes:
        """One control call to shard ``s``'s live primary, re-resolving
        once when the cached primary fails (died, or answered
        ENOTPRIMARY after a failover)."""
        try:
            return self._chan(self._live_primary(scheme, s)).call(
                "Ps", method, payload, timeout_ms=self.timeout_ms)
        except rpc.RpcError:
            addr = self._live_primary(scheme, s, refresh=True)
            return self._chan(addr).call(
                "Ps", method, payload, timeout_ms=self.timeout_ms)

    def targets_for(self, s: int) -> List[dict]:
        """The successor shards overlapping source shard ``s``, each
        with the INTERSECTION row range it receives from this source
        (a merge destination collects slices from several sources)."""
        olo, ohi = self.old.shard_bounds(s, self.vocab)
        out = []
        for d in range(self.new.num_shards):
            nlo, nhi = self.new.shard_bounds(d, self.vocab)
            if _overlaps(olo, ohi, nlo, nhi):
                lo, hi = max(olo, nlo), min(ohi, nhi)
                # Resolve the LIVE destination primary (the declared
                # one may already have failed over) and ship the full
                # replica group along so the shipper can re-resolve on
                # its own when the destination primary dies mid-copy.
                out.append({"addr": self._live_primary(self.new, d),
                            "base": lo, "rows": hi - lo,
                            "replicas": list(
                                self.new.replica_sets[d].addresses)})
        return out

    # -- phases ------------------------------------------------------------

    def start(self) -> Dict[int, int]:
        """Install the shippers; returns each source's generation at
        start time.  Idempotent: re-issuing replaces the shipper and
        the destinations resync wholesale.  With a registry, the
        successor is published as PREPARING first — a writer fenced in
        the cutover-to-publication gap already finds its redirect
        target.  On a REPLICATED source the spec is also distributed to
        every backup (``MigrateSpec``): a backup promoted after the
        primary dies mid-copy re-installs the shipper from its copy —
        the automatic re-drive, no manual ``MigrateStart``."""
        reg = self._naming()
        if reg is not None and self.cluster is not None:
            publish_scheme(reg, self.cluster,
                           self.new.with_(state="preparing"))
        gens: Dict[int, int] = {}
        for s in range(self.old.num_shards):
            spec = json.dumps({"scheme": self.new.version,
                               "targets": self.targets_for(s)}).encode()
            rsp = self._call_shard(self.old, s, "MigrateStart", spec)
            gens[s] = wire.read("<q", rsp, 0, "MigrateStart.rsp")[0]
            primary = self._live_primary(self.old, s)
            for a in self.old.replica_sets[s].addresses:
                if a == primary:
                    continue
                try:
                    self._chan(a).call("Ps", "MigrateSpec", spec,
                                       timeout_ms=self.timeout_ms)
                except rpc.RpcError:
                    # a dead backup just cannot re-drive if promoted
                    # later; the migration itself is unaffected
                    if obs.enabled():
                        obs.counter("ps_migrate_spec_errors").add(1)
        return gens

    def migrate_state(self, s: int) -> dict:
        return json.loads(self._call_shard(self.old, s, "MigrateState",
                                           b""))

    def wait_caught_up(self, deadline_s: float = 30.0,
                       poll_ms: float = 20.0) -> None:
        """Blocks until every destination of every source is synced
        with an empty ship queue (the copy phase is done and deltas
        flow at wire rate — cutover will only have the in-flight tail
        to flush).  An unreachable source counts as lagging, not fatal:
        a source primary dying mid-copy is survived by its promoted
        backup re-driving the shipper, and this poll keeps waiting for
        that to converge instead of aborting the migration."""
        deadline = time.monotonic() + deadline_s
        while True:
            lagging = []
            for s in range(self.old.num_shards):
                try:
                    st = self.migrate_state(s)
                except rpc.RpcError:
                    self._live_primary(self.old, s, refresh=True)
                    lagging.append((s, "unreachable"))
                    continue
                if not st["active"]:
                    lagging.append((s, "no shipper"))
                    continue
                for addr, t in st["targets"].items():
                    if t["refused"]:
                        raise rpc.RpcError(
                            resilience.ESCHEMEMOVED,
                            f"destination {addr} refused shard {s}'s "
                            f"handoff")
                    if not t["synced"] or t["pending"] or t["down"]:
                        lagging.append((s, addr))
            if not lagging:
                return
            if time.monotonic() > deadline:
                raise rpc.RpcError(
                    1008, f"copy phase did not catch up within "
                          f"{deadline_s:.1f}s; lagging: {lagging}")
            resilience.sleep_ms(poll_ms)

    def cutover(self) -> Dict[int, int]:
        """The fenced scheme switch: fence every source (writes start
        redirecting, final generations flush to the destinations), then
        open every destination — the live primary FIRST (its failure is
        fatal), then its backups (best-effort: a dead backup stays
        importing and opens on a later retry, its reconnect Sync
        carries the data) — then publish the transition.  Returns each
        source's FINAL generation.  Only after every fence succeeded
        are destinations opened — a half-fenced cutover never exposes a
        destination that could still receive source syncs."""
        final: Dict[int, int] = {}
        for s in range(self.old.num_shards):
            rsp = self._call_shard(self.old, s, "SchemeFence",
                                   struct.pack("<q", self.new.version))
            final[s] = wire.read("<q", rsp, 0, "SchemeFence.rsp")[0]
        for d in range(self.new.num_shards):
            primary = self._live_primary(self.new, d)
            self._chan(primary).call("Ps", "CompleteImport", b"",
                                     timeout_ms=self.timeout_ms)
            for a in self.new.replica_sets[d].addresses:
                if a == primary:
                    continue
                try:
                    self._chan(a).call("Ps", "CompleteImport", b"",
                                       timeout_ms=self.timeout_ms)
                except rpc.RpcError:
                    if obs.enabled():
                        obs.counter("ps_import_open_errors").add(1)
        if obs.enabled():
            obs.counter("reshard_cutovers").add(1)
        self.publish()
        return final

    def ramp_weights(self, steps: "Sequence[float]" = (0.25, 0.5,
                                                       0.75, 1.0),
                     interval_s: float = 0.5) -> None:
        """GRADUAL capacity-weighted scheme shift — replaces the binary
        1→0 read cutover.  Call after :meth:`cutover`: each step
        re-publishes the successor ACTIVE at weight ``w`` and the
        retiring scheme still ACTIVE at ``1 - w``, so the weighted read
        pick moves traffic over in increments (writes already moved at
        the fence — the successor is the newest active scheme).  The
        final step publishes the retiring scheme DRAINING at weight 0,
        exactly the binary cutover's end state.  No-op without a
        registry."""
        reg = self._naming()
        if reg is None or self.cluster is None:
            return
        for i, w in enumerate(steps):
            w = min(max(float(w), 0.0), 1.0)
            last = i + 1 == len(steps)
            publish_scheme(reg, self.cluster,
                           self.new.with_(state="active", weight=w))
            if last or w >= 1.0:
                publish_scheme(
                    reg, self.cluster,
                    self.old.with_(state="draining", weight=0.0))
                if obs.enabled():
                    obs.counter("reshard_ramp_steps").add(1)
                break
            publish_scheme(
                reg, self.cluster,
                self.old.with_(state="active", weight=1.0 - w))
            if obs.enabled():
                obs.counter("reshard_ramp_steps").add(1)
            resilience.sleep_ms(interval_s * 1000.0)

    def publish(self) -> None:
        """Publish the post-cutover scheme records: the successor
        ACTIVE at its declared weight, the retiring scheme DRAINING at
        weight 0 (reads may still fall back to it; no new traffic is
        weighted onto it).  No-op without a registry."""
        reg = self._naming()
        if reg is None or self.cluster is None:
            return
        publish_scheme(reg, self.cluster,
                       self.new.with_(state="active"))
        publish_scheme(reg, self.cluster,
                       self.old.with_(state="draining", weight=0.0))

    def run(self, deadline_s: float = 60.0, *,
            ramp_steps: "Optional[Sequence[float]]" = None,
            ramp_interval_s: float = 0.5) -> Dict[str, object]:
        """copy → catch-up → cutover (→ optional weight ramp); returns
        a summary."""
        t0 = time.monotonic()
        start_gens = self.start()
        self.wait_caught_up(deadline_s=deadline_s)
        final = self.cutover()
        if ramp_steps:
            self.ramp_weights(ramp_steps, interval_s=ramp_interval_s)
        return {
            "old_version": self.old.version,
            "new_version": self.new.version,
            "start_gens": start_gens,
            "final_gens": final,
            "wall_s": round(time.monotonic() - t0, 3),
        }

    # -- drain & retire ----------------------------------------------------

    def reads(self) -> int:
        """Total reads ever served by the RETIRING scheme's shards."""
        total = 0
        for s in range(self.old.num_shards):
            info = json.loads(self._call_shard(self.old, s,
                                               "SchemeInfo", b""))
            total += int(info.get("reads", 0))
        return total

    def wait_drained(self, idle_s: float = 0.5,
                     deadline_s: float = 30.0) -> bool:
        """True once the retiring shards served NO read for ``idle_s``
        — the observable form of "the old scheme's traffic weight
        drained to zero"."""
        deadline = time.monotonic() + deadline_s
        last = self.reads()
        while time.monotonic() <= deadline:
            resilience.sleep_ms(idle_s * 1000.0)
            cur = self.reads()
            if cur == last:
                return True
            last = cur
        return False

    def retire(self) -> None:
        """Publish the retiring scheme as RETIRED (clients must drop
        it).  The owner of the old servers closes them afterwards —
        that close releases their native tables, which is the handle-
        ledger half of the retirement proof."""
        reg = self._naming()
        if reg is not None and self.cluster is not None:
            publish_scheme(reg, self.cluster,
                           self.old.with_(state="retired", weight=0.0))
        if obs.enabled():
            obs.counter("reshard_retired").add(1)

    def abort(self) -> None:
        """Stop every shipper AND unfence every source, so the old
        scheme keeps serving exactly as before: a cutover that fenced
        some sources and then failed (laggard destination, driver
        crash) would otherwise leave them refusing writes forever with
        no successor ever published.  The importing destinations are
        left for their owner to close.  Must not be called after a
        COMPLETED cutover — the destinations are open and own the
        ranges then."""
        for s in range(self.old.num_shards):
            try:
                self._call_shard(self.old, s, "MigrateStop", b"")
                self._call_shard(self.old, s, "SchemeUnfence", b"")
            except rpc.RpcError:
                pass  # a dead source has nothing left to roll back
            # backups forget the replicated spec too — a promotion
            # after an abort must not resurrect the migration
            for a in self.old.replica_sets[s].addresses:
                try:
                    self._chan(a).call("Ps", "MigrateStop", b"",
                                       timeout_ms=self.timeout_ms)
                except rpc.RpcError:
                    pass
        reg = self._naming()
        if reg is not None and self.cluster is not None:
            # the stillborn successor's PREPARING record must not
            # linger: watchers (the rebalancer included) treat a
            # preparing scheme as a migration in flight and would
            # never decide again
            try:
                publish_scheme(reg, self.cluster,
                               self.new.with_(state="retired",
                                              weight=0.0))
            except Exception:  # noqa: BLE001 — registry outage
                pass
        if obs.enabled():
            obs.counter("reshard_aborts").add(1)

    def close(self) -> None:
        for ch in self._chans.values():
            ch.close()
        self._chans.clear()
        if self._registry is not None:
            self._registry.close()
            self._registry = None
