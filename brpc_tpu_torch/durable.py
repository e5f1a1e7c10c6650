"""Durable fabric: per-shard incremental checkpoint/restore.

Quorum replication keeps a shard alive through node death, but nothing
survived a FULL fleet restart: every table lived only in process
memory.  The observation this module is built on is that the
replication stream is already a write-ahead log — every applied batch
leaves the primary as a ``replica_apply_body`` frame (writer dedup
windows ++ global-id apply_req), in apply order, under the table write
lock.  Teeing that exact framing to disk gives an incremental
checkpoint for free:

* **base snapshot** (``base-<gen>.snap``): a gen-stamped, crc-guarded
  image of the whole table plus the writer dedup windows at that
  generation (schema ``ckpt_snap``).  Written to a temp file and
  ``os.replace``'d, so a crash mid-write never damages the previous
  base.
* **delta log** (``delta-<gen>.log``, named for the base it extends):
  one ``ckpt_delta`` record per applied generation, containing the
  verbatim ``replica_apply_body`` bytes.  Log order IS apply order;
  the dedup windows ride along in each body, so writer-retry
  semantics survive a cold start too.
* **compaction marker** (``compact.marker``): an advisory
  ``ckpt_marker`` naming the newest base; stale after a crash
  mid-compaction and tolerated (restore trusts the scan, not the
  marker).

Restore scans for the newest VALID base (falling back past a torn or
bit-flipped one), then replays delta records in strict
``base_gen+1, +2, ...`` chain order, stopping cleanly at the first
torn, corrupt or out-of-chain record — the exact acked generation at
the moment of death is recovered, never a byte more or less.  The
server side (``PsShardServer.attach_checkpoint``) replays those bodies
through the SAME parse + ``np.subtract.at`` arithmetic as the live
apply path, so the zero-lost-acked-update ledger extends across the
cold start bit for bit.

The store also powers **snapshot-hydrated provisioning**: a new
replica (``hydrate_replica``) or split destination
(``hydrate_destination``) is seeded from the on-disk base, and the
live source then ships only the delta TAIL over the existing
ReplicaApply/MigrateApply streams (the hydrate-first modes in
``ps_remote._Replicator`` and ``reshard.MigrationShipper``) instead of
a wholesale Sync taxing a serving primary.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from brpc_tpu_torch import obs, rpc, wire
from brpc_tpu_torch.analysis.race import checked_lock
from brpc_tpu_torch.ps_remote import _pack_windows, _unpack_windows

__all__ = [
    "CheckpointStore", "RestorePoint", "hydrate_replica",
    "hydrate_destination",
]

#: on-disk format version stamped into every snapshot and marker.
#: v2 added the ``seeded`` flag to the snapshot header: a gen-0 base
#: written by a chain-seeded server is now distinguishable from a
#: fresh (never-synced) table, so first-boot backups can hydrate the
#: delta tail instead of always falling back to a wholesale Sync.
CKPT_VERSION = 2

_SNAP_HDR = struct.calcsize("<iiqqiiiqq")   # 52
_DELTA_HDR = struct.calcsize("<iqqi")       # 24
_MARKER_LEN = struct.calcsize("<iiq")       # 16


# ---------------------------------------------------------------------------
# on-disk frame parsers (schemas ckpt_snap / ckpt_delta / ckpt_marker)
# ---------------------------------------------------------------------------

def _pack_snapshot(epoch: int, gen: int, table: np.ndarray,
                   windows: Dict[str, int],
                   seeded: bool = False) -> bytes:
    """Pack one base snapshot file (schema ``ckpt_snap``).

    ``seeded`` records whether the writing server's table was
    established by the replication chain (primary, or a backup that
    received a wholesale Sync) — without it a gen-0 base is
    indistinguishable from a fresh random-init table."""
    table = np.ascontiguousarray(table, dtype=np.float32)
    rows, dim = table.shape
    body = table.tobytes() + _pack_windows(windows)
    return struct.pack("<iiqqiiiqq", wire.CKPT_SNAP_MAGIC, CKPT_VERSION,
                       epoch, gen, rows, dim, 1 if seeded else 0,
                       zlib.crc32(body), rows * dim) + body


def _unpack_snapshot(payload):
    """Parse one base snapshot file; returns
    ``(epoch, gen, table, windows, seeded)``.

    The crc covers EVERYTHING after the header (table ++ windows), so a
    bit flip anywhere in the body — or junk appended past the windows —
    rejects before any value is trusted."""
    magic, version, epoch, gen, rows, dim, seeded, crc, count = wire.read(
        "<iiqqiiiqq", payload, 0, "ckpt_snap.hdr")
    if magic != wire.CKPT_SNAP_MAGIC:
        raise wire.WireError("ckpt_snap: bad magic 0x%x" % (magic & 0xffffffff))
    if version != CKPT_VERSION:
        raise wire.WireError("ckpt_snap: unsupported version %d" % version)
    rows = wire.check_count(rows, wire.MAX_WIRE_COUNT, "ckpt_snap.rows")
    dim = wire.check_count(dim, wire.MAX_WIRE_COUNT, "ckpt_snap.dim")
    n = wire.check_count(count, max(0, (len(payload) - _SNAP_HDR) // 4),
                         "ckpt_snap.count")
    if n != rows * dim:
        raise wire.WireError("ckpt_snap: count %d != rows*dim %d"
                             % (n, rows * dim))
    body = bytes(payload[_SNAP_HDR:])
    if zlib.crc32(body) != crc:
        raise wire.WireError("ckpt_snap: checksum mismatch")
    wire.need(payload, _SNAP_HDR, n * 4, "ckpt_snap.table")
    table = np.frombuffer(payload, np.float32, n,
                          _SNAP_HDR).reshape(rows, dim).copy()
    windows, _ = _unpack_windows(payload, _SNAP_HDR + n * 4)
    return epoch, gen, table, windows, bool(seeded)


def _pack_delta(gen: int, body: bytes) -> bytes:
    """Pack one delta-log record (schema ``ckpt_delta``): a verbatim
    ``replica_apply_body`` under a crc-guarded length header."""
    body = bytes(body)
    return struct.pack("<iqqi", wire.CKPT_DELTA_MAGIC, gen,
                       zlib.crc32(body), len(body)) + body


def _unpack_delta(payload, offset: int = 0):
    """Parse one delta record at ``offset``; returns
    ``(gen, body, end_offset)``.  A torn tail (record cut mid-write)
    raises cleanly — the crc only covers the body, so a flipped ``gen``
    is instead caught by the restore chain check (the record falls out
    of the ``base+1, +2, ...`` sequence and replay stops there)."""
    magic, gen, crc, blen = wire.read("<iqqi", payload, offset,
                                      "ckpt_delta.hdr")
    if magic != wire.CKPT_DELTA_MAGIC:
        raise wire.WireError("ckpt_delta: bad magic 0x%x"
                             % (magic & 0xffffffff))
    off = offset + _DELTA_HDR
    blen = wire.check_count(blen, max(0, len(payload) - off),
                            "ckpt_delta.blen")
    wire.need(payload, off, blen, "ckpt_delta.body")
    body = bytes(payload[off:off + blen])
    if zlib.crc32(body) != crc:
        raise wire.WireError("ckpt_delta: checksum mismatch")
    return gen, body, off + blen


def _pack_marker(base_gen: int) -> bytes:
    """Pack the compaction marker file (schema ``ckpt_marker``)."""
    return struct.pack("<iiq", wire.CKPT_MARKER_MAGIC, CKPT_VERSION,
                       base_gen)


def _unpack_marker(payload) -> int:
    """Parse the compaction marker; returns the advertised base gen."""
    magic, version, base_gen = wire.read("<iiq", payload, 0,
                                         "ckpt_marker")
    if magic != wire.CKPT_MARKER_MAGIC:
        raise wire.WireError("ckpt_marker: bad magic 0x%x"
                             % (magic & 0xffffffff))
    if version != CKPT_VERSION:
        raise wire.WireError("ckpt_marker: unsupported version %d"
                             % version)
    return base_gen


# ---------------------------------------------------------------------------
# the per-shard store
# ---------------------------------------------------------------------------

@dataclass
class RestorePoint:
    """What :meth:`CheckpointStore.restore` recovered: the base image
    plus the chained delta tail, ending at the exact last durable
    generation.  ``deltas`` are verbatim ``replica_apply_body`` bytes —
    the server replays them through its live apply arithmetic."""
    epoch: int
    base_gen: int
    gen: int                       # base_gen + len(deltas)
    table: np.ndarray
    windows: Dict[str, int]
    deltas: List[Tuple[int, bytes]] = field(default_factory=list)
    seeded: bool = False           # base written by a chain-seeded server


class CheckpointStore:
    """One shard's durable checkpoint: base snapshot + delta log.

    Thread-safe; ``append_delta`` is designed to be called under the
    shard's table write lock (that is what makes log order == apply
    order), everything else from anywhere.  The store is deliberately
    arithmetic-free: it moves bytes, the server owns the math.

    ``fsync=False`` (the default) rides the OS page cache — that is
    durable across process death, which is the failure mode the bench
    kills with; power-loss durability costs ``fsync=True`` per record.
    """

    def __init__(self, root: str, *, fsync: bool = False,
                 compact_bytes: int = 16 << 20, keep_bases: int = 2):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.fsync = bool(fsync)
        self.compact_bytes = int(compact_bytes)
        self.keep_bases = max(1, int(keep_bases))
        self._mu = checked_lock("ps.ckpt")
        self._base_gen = -1          # no base yet: appends refused
        self._epoch = 0
        self._last_gen = -1
        self._seg_f = None           # open segment, None until a base lands
        self._tail: List[Tuple[int, bytes]] = []
        self._delta_bytes = 0

    # -- paths --------------------------------------------------------------

    def _base_paths(self):
        """``(gen, path)`` for every base file, newest first."""
        out = []
        for name in os.listdir(self.root):
            if name.startswith("base-") and name.endswith(".snap"):
                try:
                    g = int(name[5:-5])
                except ValueError:
                    continue
                out.append((g, os.path.join(self.root, name)))
        out.sort(reverse=True)
        return out

    def _seg_paths(self):
        """``(base_gen, path)`` for every delta segment, ascending —
        segment N holds gens ``N+1 .. next_base``, so an ascending scan
        chains contiguously from WHICHEVER base restore lands on."""
        out = []
        for name in os.listdir(self.root):
            if name.startswith("delta-") and name.endswith(".log"):
                try:
                    g = int(name[6:-4])
                except ValueError:
                    continue
                out.append((g, os.path.join(self.root, name)))
        out.sort()
        return out

    def _write_atomic(self, path: str, payload: bytes) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)

    # -- write path ---------------------------------------------------------

    def save_snapshot(self, epoch: int, gen: int, table: np.ndarray,
                      windows: Dict[str, int], *,
                      seeded: bool = False) -> None:
        """Write a new base at ``gen``, open a fresh segment for its
        tail, and retire everything older than the ``keep_bases``
        newest bases (compaction: the previous tail is now folded into
        this base)."""
        payload = _pack_snapshot(epoch, gen, table, windows or {}, seeded)
        with self._mu:
            compacting = self._base_gen >= 0
            self._write_atomic(
                os.path.join(self.root, "base-%016d.snap" % gen), payload)
            if self._seg_f is not None:
                self._seg_f.close()
            self._seg_f = open(
                os.path.join(self.root, "delta-%016d.log" % gen), "wb")
            self._write_atomic(os.path.join(self.root, "compact.marker"),
                               _pack_marker(gen))
            bases = self._base_paths()
            kept = [g for g, _ in bases[:self.keep_bases]]
            oldest_kept = min(kept) if kept else gen
            for _, path in bases[self.keep_bases:]:
                try:
                    os.unlink(path)
                except OSError:
                    pass
            for g, path in self._seg_paths():
                if g < oldest_kept:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
            self._base_gen = gen
            self._epoch = epoch
            self._last_gen = gen
            self._tail = []
            self._delta_bytes = 0
        if obs.enabled():
            obs.counter("ps_ckpt_snapshots").add(1)
            obs.counter("ps_ckpt_snapshot_bytes").add(len(payload))
            if compacting:
                obs.counter("ps_ckpt_compactions").add(1)

    def append_delta(self, gen: int, body: bytes,
                     epoch: Optional[int] = None) -> bool:
        """Tee one applied generation to the open segment.  Returns
        False when the record cannot extend the log — no base yet,
        ``gen`` is not the next link in the chain (a wholesale install
        jumped the generation), or ``epoch`` (when given) differs from
        the epoch the open base was written under (a promotion bumped
        the epoch WITHOUT an install: the generation chain continued,
        but a restore of the old base would resurrect the stale epoch
        and un-fence retired writers) — in each case the caller
        re-bases via :meth:`save_snapshot` instead."""
        body = bytes(body)
        with self._mu:
            if self._seg_f is None or self._base_gen < 0:
                return False
            if gen != self._last_gen + 1:
                return False
            if epoch is not None and epoch != self._epoch:
                return False
            rec = _pack_delta(gen, body)
            self._seg_f.write(rec)
            self._seg_f.flush()
            if self.fsync:
                os.fsync(self._seg_f.fileno())
            self._tail.append((gen, body))
            self._delta_bytes += len(rec)
            self._last_gen = gen
        if obs.enabled():
            obs.counter("ps_ckpt_deltas").add(1)
            obs.counter("ps_ckpt_delta_bytes").add(len(rec))
        return True

    def should_compact(self) -> bool:
        """True once the open tail outweighs ``compact_bytes`` — the
        caller folds it into a fresh base via :meth:`save_snapshot`."""
        with self._mu:
            return (self._base_gen >= 0
                    and self._delta_bytes >= self.compact_bytes)

    # -- read path ----------------------------------------------------------

    def tail_since(self, after_gen: int):
        """Delta bodies for gens ``> after_gen``, or None when
        ``after_gen`` predates the current base (the caller must fall
        back to a wholesale transfer)."""
        with self._mu:
            if self._base_gen < 0 or after_gen < self._base_gen:
                return None
            return [(g, b) for g, b in self._tail if g > after_gen]

    def load_base(self):
        """Newest VALID base as ``(epoch, gen, table, windows,
        seeded)``, or None.  Lock-free: base files are immutable once
        renamed into place, so provisioning reads race nothing."""
        for g, path in self._base_paths():
            try:
                with open(path, "rb") as f:
                    parsed = _unpack_snapshot(f.read())
            except (OSError, wire.WireError):
                continue
            if parsed[1] != g:
                continue            # filename lies about the content
            return parsed
        return None

    def restore(self) -> Optional[RestorePoint]:
        """Recover the exact durable state: newest valid base, then the
        delta chain replayed in ``base+1, +2, ...`` order across the
        retained segments, stopping at the first torn / corrupt /
        out-of-chain record.  Returns None when no usable base exists.

        Also resets the in-memory write state: the next
        :meth:`append_delta` returns False until a fresh
        :meth:`save_snapshot` re-anchors the log (a recovered tail is
        never appended to in place — it may be torn)."""
        with self._mu:
            if self._seg_f is not None:
                self._seg_f.close()
                self._seg_f = None
            self._base_gen = -1
            self._last_gen = -1
            self._tail = []
            self._delta_bytes = 0
            chosen = None
            for g, path in self._base_paths():
                try:
                    with open(path, "rb") as f:
                        chosen = _unpack_snapshot(f.read())
                except (OSError, wire.WireError):
                    continue
                if chosen[1] != g:
                    chosen = None
                    continue
                break
            if chosen is None:
                return None
            epoch, base_gen, table, windows, seeded = chosen
            records: List[Tuple[int, bytes]] = []
            for _, path in self._seg_paths():
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                except OSError:
                    continue
                off = 0
                while off < len(data):
                    try:
                        gen, body, off = _unpack_delta(data, off)
                    except wire.WireError:
                        break       # torn tail: last complete record wins
                    records.append((gen, body))
            deltas: List[Tuple[int, bytes]] = []
            expect = base_gen + 1
            for gen, body in records:
                if gen < expect:
                    continue        # already folded into the base
                if gen > expect:
                    break           # chain gap: nothing past it is safe
                deltas.append((gen, body))
                expect += 1
            self._base_gen = base_gen
            self._epoch = epoch
            self._last_gen = base_gen + len(deltas)
            self._tail = list(deltas)
        if obs.enabled():
            obs.counter("ps_ckpt_restores").add(1)
            obs.counter("ps_ckpt_restore_deltas").add(len(deltas))
        return RestorePoint(epoch=epoch, base_gen=base_gen,
                            gen=base_gen + len(deltas), table=table,
                            windows=windows, deltas=deltas, seeded=seeded)

    # -- introspection ------------------------------------------------------

    @property
    def base_gen(self) -> int:
        with self._mu:
            return self._base_gen

    @property
    def last_gen(self) -> int:
        with self._mu:
            return self._last_gen

    def delta_bytes(self) -> int:
        with self._mu:
            return self._delta_bytes

    def close(self) -> None:
        with self._mu:
            if self._seg_f is not None:
                self._seg_f.close()
                self._seg_f = None


# ---------------------------------------------------------------------------
# snapshot-hydrated provisioning
# ---------------------------------------------------------------------------

def hydrate_replica(store: CheckpointStore, addr: str, *,
                    timeout_ms: int = 5000) -> int:
    """Seed a NEW backup replica from the checkpoint store instead of
    the live primary: ship the on-disk base over the normal Sync
    control frame.  The destination must already have replication
    configured (so it answers Sync as a backup); when the primary's
    replicator later connects, its hydrate-first mode finds the
    backup's generation inside the delta window and ships only the
    tail.  Returns the generation the replica was seeded at."""
    base = store.load_base()
    if base is None:
        raise ValueError("durable: no usable base snapshot to hydrate from")
    epoch, gen, table, windows, _seeded = base
    payload = (struct.pack("<qqq", epoch, gen, table.size)
               + np.ascontiguousarray(table, np.float32).tobytes()
               + _pack_windows(windows))
    ch = rpc.Channel(addr, timeout_ms=timeout_ms)
    try:
        ch.call("Ps", "Sync", payload, timeout_ms=timeout_ms)
    finally:
        ch.close()
    if obs.enabled():
        obs.counter("ps_replica_hydrate_seeds").add(1)
    return gen


def hydrate_destination(store: CheckpointStore, addr: str, scheme: int,
                        src_addr: str, src_base: int, row0: int,
                        rows: int, *, timeout_ms: int = 5000) -> int:
    """Seed a split/migration DESTINATION (an ``importing`` server)
    with its row range from the checkpoint store, over the normal
    MigrateSync control frame.  ``row0`` is GLOBAL; ``src_base`` is the
    source shard's first global row (the store itself is
    position-blind).  The destination records the source watermark, so
    the live source's MigrationShipper hydrate-first mode then ships
    only the delta tail.  Returns the seeded generation."""
    base = store.load_base()
    if base is None:
        raise ValueError("durable: no usable base snapshot to hydrate from")
    epoch, gen, table, windows, _seeded = base
    lo = row0 - src_base
    if lo < 0 or lo + rows > table.shape[0]:
        raise ValueError("durable: rows [%d, %d) outside snapshot range"
                         % (row0, row0 + rows))
    src = src_addr.encode()
    payload = (struct.pack("<qqqq", scheme, gen, row0, rows)
               + struct.pack("<i", len(src)) + src
               + np.ascontiguousarray(table[lo:lo + rows],
                                      np.float32).tobytes()
               + _pack_windows(windows))
    ch = rpc.Channel(addr, timeout_ms=timeout_ms)
    try:
        ch.call("Ps", "MigrateSync", payload, timeout_ms=timeout_ms)
    finally:
        ch.close()
    if obs.enabled():
        obs.counter("ps_migrate_hydrate_seeds").add(1)
    return gen
