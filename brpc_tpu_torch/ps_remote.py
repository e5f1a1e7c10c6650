"""Remote parameter-server tier: embedding shards served over the native
RPC fabric, driven from JAX training loops.

This is the DCN tier of the BASELINE #5 workload ("param-server serving
embedding shards, allreduce grads"): each shard is a native Server
(cpp/rpc) holding rows [i*rows_per, (i+1)*rows_per); the client routes ids
to owners (the PartitionChannel "i/N" contract, cpp/cluster/
partition_channel.*) and runs Lookup / ApplyGrad calls. The intra-pod tier
— where the table fits in pod HBM — is brpc_tpu.ps (compiled collectives).

Wire format (little-endian): Lookup req = int32 count ++ int32 ids;
rsp = float32 rows [count, dim]. ApplyGrad req = int32 count ++ int32 ids
++ float32 grads [count, dim]; rsp = empty.  The streaming push
(``StreamApply``) reuses the ApplyGrad framing: the setup RPC carries the
writer's id (empty = the legacy unframed mode) and every stream FRAME is
one ``(seq, epoch, gen)`` int64 header + framed delta — no per-frame
response; application order/completion ride the stream close, and the
server's per-writer seq window makes reconnect replay IDEMPOTENT (a
frame whose write failed may still have reached the server; replaying it
dedups instead of double-applying).

Replication (this tier's availability story): a :class:`naming.ReplicaSet`
per shard range declares primary+backups.  Reads route to any live
replica by latency+inflight score; writes go to the primary, which
propagates every APPLIED batch to its backups over the same stream
framing (``ReplicaApply``), generation-tagged so a backup installing
gen N+1 is byte-identical to the primary.  Promotion is fenced by an
epoch: a stale primary's propagation is rejected (EFENCED) and demotes
itself.  See the "Replication & failover" README section.

In this package ``rpc.DeviceClient`` is the torch client of
``brpc_tpu_torch.device``: ``DevicePsShardServer`` keeps its table in a
CUDA tensor, and its gather / scatter-sub programs are the kernels of
``brpc_tpu_torch.ops.embedding_rows``.
"""

from __future__ import annotations

import collections
import itertools
import json
import struct
import threading
import time
import uuid
from typing import Dict, List, Optional, Sequence

import numpy as np

from brpc_tpu_torch import obs, resilience, rpc, wire
from brpc_tpu_torch.analysis.race import checked_lock, checked_rwlock
from brpc_tpu_torch.limiter import ServerLimiter
from brpc_tpu_torch.naming import (PartitionScheme, ReplicaSet, parse_claims,
                             parse_schemes, parse_shard_tag)


def _reject_frame(method: str) -> None:
    """Count one malformed-frame rejection (``ps_parse_rejects`` total +
    per method) — fuzz runs and hostile real traffic both show up in the
    ``_status`` vars instead of vanishing into generic errors."""
    if obs.enabled():
        obs.counter("ps_parse_rejects").add(1)
        obs.counter(f"ps_parse_rejects_{method}").add(1)


def _record_ps_server(shard_index: int, method: str, count: int,
                      req_len: int, rsp_len: int, t0: int) -> None:
    """PS-side counters: keys/s, bytes in/out, per-shard handler latency
    (the ``add_service`` trampoline separately records the full RPC
    latency; this recorder isolates the table work)."""
    obs.recorder(f"ps_server_shard{shard_index}_{method}").record(
        (time.monotonic_ns() - t0) / 1e9)
    obs.counter("ps_server_keys").add(count)
    obs.counter("ps_server_bytes_in").add(req_len)
    obs.counter("ps_server_bytes_out").add(rsp_len)


class _ExclusiveAsRw:
    """Presents a plain mutex through the ``read()``/``write()`` surface
    (the pre-parallel single-lock serving model — kept as the bench
    baseline for ``bench_ps.py``'s mutex-vs-rwlock comparison)."""

    __slots__ = ("_lock",)

    def __init__(self, lock):
        self._lock = lock

    def read(self):
        return self._lock

    def write(self):
        return self._lock


def _pack_lookup_req(owned: np.ndarray) -> bytearray:
    """Frame a Lookup request into ONE pre-sized buffer, written in place
    (the old ``struct.pack + tobytes + concat`` built three intermediate
    buffers per shard — measurable at 8-client fan-out even after the
    native read path).  The native call paths accept writable buffers
    zero-copy (:func:`rpc._req_ptr`)."""
    req = bytearray(4 + 4 * owned.size)
    struct.pack_into("<i", req, 0, owned.size)
    np.frombuffer(req, np.int32, owned.size, 4)[:] = owned
    return req


def _pack_apply_req(owned: np.ndarray, grads: np.ndarray) -> bytearray:
    """Frame an ApplyGrad request (count ++ ids ++ grads) into one
    pre-sized buffer — same discipline as :func:`_pack_lookup_req`."""
    n = owned.size
    req = bytearray(4 + 4 * n + 4 * grads.size)
    struct.pack_into("<i", req, 0, n)
    np.frombuffer(req, np.int32, n, 4)[:] = owned
    np.frombuffer(req, np.float32, grads.size, 4 + 4 * n)[:] = \
        grads.reshape(-1)
    return req


def _pack_deadline(deadline_us: int, body) -> bytearray:
    """Prefix a data-plane request with its deadline header (wire
    schema ``deadline_hdr``): magic ++ absolute wall-clock deadline in
    microseconds ++ the original body.  The magic sits above any
    legitimate count/length field, so stamped and bare framings never
    collide; servers (Python AND the native Lookup handler) peel it and
    shed expired work before touching the table."""
    out = bytearray(12 + len(body))
    struct.pack_into("<iq", out, 0, wire.DEADLINE_MAGIC, deadline_us)
    out[12:] = body
    return out


def _pack_deadline_rel(budget_us: int, body) -> bytearray:
    """The v2 deadline header (wire schema ``deadline_hdr_v2``):
    magic ++ RELATIVE budget in microseconds ++ the original body.
    Unlike the absolute-us form this makes no same-host/NTP wall-clock
    assumption — the server stamps ARRIVAL with its own clock and
    computes expiry as ``local_arrival + budget``, so only transit
    time (not clock skew) eats into the budget."""
    out = bytearray(12 + len(body))
    struct.pack_into("<iq", out, 0, wire.DEADLINE_MAGIC2, budget_us)
    out[12:] = body
    return out


def _peel_deadline_rel(payload):
    """Server half of the v2 header: read the relative budget and
    convert it to an ABSOLUTE local deadline at arrival time (the
    arrival stamp).  Downstream admission/drain checks then compare
    against the same local clock the stamp came from."""
    (budget_us,) = wire.read("<q", payload, 4, "deadline.budget")
    deadline_us = int(time.time() * 1e6) + budget_us
    return bytes(memoryview(payload)[12:]), deadline_us


def _unpack_deadline(payload):
    """Inverse of :func:`_pack_deadline`: returns ``(body,
    deadline_us)`` — ``(payload, 0)`` when no header is present.  A
    frame that DOES open with the magic must carry the full 12-byte
    header (guarded: truncation is a hostile frame, not a legacy
    one — no legitimate count field equals the magic).  The v2 magic
    (relative budget) dispatches to :func:`_peel_deadline_rel`, which
    arrival-stamps with the LOCAL clock."""
    if len(payload) < 4:
        return payload, 0
    (magic,) = struct.unpack_from("<i", payload, 0)
    if magic == wire.DEADLINE_MAGIC2:
        return _peel_deadline_rel(payload)
    if magic != wire.DEADLINE_MAGIC:
        return payload, 0
    (deadline_us,) = wire.read("<q", payload, 4, "deadline.us")
    return bytes(memoryview(payload)[12:]), deadline_us


def _admit_deadline(method: str, payload: bytes):
    """Deadline admission for one request: peel the optional header
    (absolute v1 or relative arrival-stamped v2) and SHED work whose
    propagated budget is already exhausted — before any parse, any
    lock, any table touch (``EDEADLINE``; the acceptance contract of
    the overload tier).  Counted per method in
    ``ps_deadline_drops[_<Method>]``; the server span carries a
    ``shed=deadline`` rpcz tag via the trampoline.  Returns ``(body,
    deadline_us)`` — the surviving LOCAL absolute deadline rides into
    the combiner so work whose budget dies in the combine queue sheds
    again at drain time."""
    body, deadline_us = _unpack_deadline(payload)
    if deadline_us > 0 and time.time() * 1e6 > deadline_us:
        if obs.enabled():
            obs.counter("ps_deadline_drops").add(1)
            obs.counter(f"ps_deadline_drops_{method}").add(1)
        raise rpc.RpcError(
            resilience.EDEADLINE,
            f"{method}: propagated deadline budget exhausted before "
            f"the handler started")
    return body, deadline_us


#: stream frame header: (seq, epoch, gen) int64 — StreamApply uses seq
#: (per-writer dedup window), ReplicaApply uses epoch (fencing) + gen
#: (in-order install / dedup); unused fields are 0.
_FRAME_HDR = struct.Struct("<qqq")


def _pack_stream_frame(seq: int, epoch: int, gen: int,
                       body) -> bytearray:
    """One framed stream message: header + ApplyGrad-framed body, built
    into a single pre-sized buffer (same discipline as the request
    packers)."""
    out = bytearray(_FRAME_HDR.size + len(body))
    _FRAME_HDR.pack_into(out, 0, seq, epoch, gen)
    out[_FRAME_HDR.size:] = body
    return out


# --- zero-copy framings (brt_iobuf) ------------------------------------
# Byte-identical on the wire to the bytearray packers above (the
# wire-contract registry claims them under the same schemas), but the
# payload rides as BORROWED blocks: the few-byte header is the only copy.
# Runtime-switchable so the zerocopy bench can measure the copy path as
# its baseline in the same process.

_zerocopy = [True]


#: borrow-path engagement floor: below this payload size the per-call
#: handle lifecycle (new/pin/destroy + finalizers) costs more than the
#: memcpys it saves (bench_zerocopy's 16-byte cell measures the
#: crossover), so small unary legs stay on the bytes path.  The RPC
#: tier enforces the same floor for explicit IOBuf callers
#: (rpc.IOBUF_MIN_BYTES routes sub-floor payloads to the bytes twin),
#: so the two crossovers are one constant.
_ZC_MIN_BYTES = rpc.IOBUF_MIN_BYTES


def zerocopy_enabled() -> bool:
    """True when the PS hot paths frame through borrowed IOBuf blocks
    instead of copying into request buffers."""
    return _zerocopy[0] and rpc.native_core_available()


def set_zerocopy(on: bool) -> bool:
    """Flips the zero-copy hot paths (returns the previous setting) —
    the A/B switch for ``bench_zerocopy``."""
    prev = _zerocopy[0]
    _zerocopy[0] = bool(on)
    return prev


def _pack_lookup_req_iobuf(owned: np.ndarray) -> "rpc.IOBuf":
    """Zero-copy ``lookup_req`` framing: the 4-byte count header is the
    only copied byte span — the ids array itself is appended as a
    borrowed block (pinned until the wire write drains)."""
    ids = np.ascontiguousarray(owned, np.int32)
    io = rpc.IOBuf()
    io.append(struct.pack("<i", ids.size))
    io.append_pinned(ids)
    return io


def _pack_apply_req_iobuf(owned: np.ndarray,
                          grads: np.ndarray) -> "rpc.IOBuf":
    """Zero-copy ``apply_req`` framing: count header owned, ids and
    grads borrowed."""
    ids = np.ascontiguousarray(owned, np.int32)
    g = np.ascontiguousarray(grads, np.float32).reshape(-1)
    io = rpc.IOBuf()
    io.append(struct.pack("<i", ids.size))
    io.append_pinned(ids)
    io.append_pinned(g)
    return io


def _pack_stream_frame_iobuf(seq: int, epoch: int, gen: int,
                             body) -> "rpc.IOBuf":
    """Zero-copy ``stream_frame`` framing: 24-byte header owned, body
    borrowed (bytes) or block-shared (:class:`rpc.IOBuf`)."""
    io = rpc.IOBuf()
    io.append(struct.pack("<qqq", seq, epoch, gen))
    if isinstance(body, rpc.IOBuf):
        io.append_iobuf(body)
    elif len(body):
        io.append_pinned(body)
    return io


def _pack_deadline_iobuf(deadline_us: int, body) -> "rpc.IOBuf":
    """Zero-copy ``deadline_hdr`` framing: the 12-byte header becomes a
    PREPENDED owned block and the body's blocks are shared — stamping a
    deadline no longer re-copies the whole request."""
    io = rpc.IOBuf()
    io.append(struct.pack("<iq", wire.DEADLINE_MAGIC, deadline_us))
    if isinstance(body, rpc.IOBuf):
        io.append_iobuf(body)
    elif len(body):
        io.append_pinned(body)
    return io


def _pack_deadline_rel_iobuf(budget_us: int, body) -> "rpc.IOBuf":
    """Zero-copy ``deadline_hdr_v2`` framing (relative budget): header
    owned, body shared/borrowed."""
    io = rpc.IOBuf()
    io.append(struct.pack("<iq", wire.DEADLINE_MAGIC2, budget_us))
    if isinstance(body, rpc.IOBuf):
        io.append_iobuf(body)
    elif len(body):
        io.append_pinned(body)
    return io


def _pack_windows(windows: Dict[str, int]) -> bytes:
    """Writer seq high-water map on the wire: ``int32 count`` ++ per
    entry ``int32 len ++ writer utf8 ++ int64 seq``.  Rides every
    ``ReplicaApply`` frame and the ``Sync`` payload so a promoted backup
    inherits the dedup window — replay idempotence must survive
    failover, not just reconnect-to-the-same-primary."""
    parts = [struct.pack("<i", len(windows))]
    for w, seq in windows.items():
        wb = w.encode()
        parts.append(struct.pack("<i", len(wb)) + wb
                     + struct.pack("<q", seq))
    return b"".join(parts)


def _unpack_windows(payload, offset: int = 0):
    """Inverse of :func:`_pack_windows`: returns ``(windows, end)``.
    Guarded (wire schema ``windows``): the entry count is bounded by the
    bytes actually present (min 12/entry) and every writer length is
    span-checked, so a hostile count can neither drive an unbounded loop
    nor walk the read off the payload."""
    (count,) = wire.read("<i", payload, offset, "windows.count")
    offset += 4
    wire.check_count(count, (len(payload) - offset) // 12,
                     "windows.count")
    windows: Dict[str, int] = {}
    for _ in range(count):
        (wlen,) = wire.read("<i", payload, offset, "windows.wlen")
        offset += 4
        # check_count, not need: a NEGATIVE length passes a `wlen + 8`
        # span check and walks the offset backwards
        wire.check_count(wlen, len(payload) - offset - 8,
                         "windows.wlen")
        w = bytes(payload[offset:offset + wlen]).decode(errors="replace")
        offset += wlen
        (seq,) = struct.unpack_from("<q", payload, offset)
        offset += 8
        windows[w] = seq
    return windows, offset


def _pack_apply_id_req(writer: str, seq: int, guards, owned: np.ndarray,
                       grads: np.ndarray) -> bytearray:
    """Frame an ``ApplyGradId`` request: the idempotent unary write.
    Header = writer key + per-(writer, shard) monotonic seq (the same
    high-water machinery as the framed push — a timed-out-but-applied
    attempt that retries is dropped server-side) + optional GUARDS:
    each names a superseded frame ``(key, seq)`` from a retired
    partition scheme that fully contained this delta — if the server's
    inherited applied window already covers a guard, the delta migrated
    here with the old shard's data and must not apply twice."""
    wb = writer.encode()
    guards = list(guards or ())
    gsz = sum(4 + len(k.encode()) + 8 for k, _ in guards)
    body = _pack_apply_req(owned, grads)
    req = bytearray(4 + len(wb) + 8 + 4 + gsz + len(body))
    struct.pack_into("<i", req, 0, len(wb))
    off = 4
    req[off:off + len(wb)] = wb
    off += len(wb)
    struct.pack_into("<qi", req, off, seq, len(guards))
    off += 12
    for k, q in guards:
        kb = k.encode()
        struct.pack_into("<i", req, off, len(kb))
        off += 4
        req[off:off + len(kb)] = kb
        off += len(kb)
        struct.pack_into("<q", req, off, q)
        off += 8
    req[off:] = body
    return req


def _unpack_apply_id(payload):
    """Inverse of :func:`_pack_apply_id_req`: returns
    ``(writer, seq, guards, apply_body)``.  Guarded (wire schema
    ``apply_id_req``): writer/guard-key lengths are span-checked and the
    guard count is bounded by the bytes present (min 12/guard) before
    any loop runs."""
    (wlen,) = wire.read("<i", payload, 0, "apply_id.wlen")
    off = 4
    wire.check_count(wlen, len(payload) - off - 12, "apply_id.wlen")
    writer = bytes(payload[off:off + wlen]).decode(errors="replace")
    off += wlen
    seq, nguards = struct.unpack_from("<qi", payload, off)
    off += 12
    wire.check_count(nguards, (len(payload) - off) // 12,
                     "apply_id.nguards")
    guards = []
    for _ in range(nguards):
        (klen,) = wire.read("<i", payload, off, "apply_id.klen")
        off += 4
        wire.check_count(klen, len(payload) - off - 8, "apply_id.klen")
        key = bytes(payload[off:off + klen]).decode(errors="replace")
        off += klen
        (q,) = struct.unpack_from("<q", payload, off)
        off += 8
        guards.append((key, q))
    return writer, seq, guards, memoryview(payload)[off:]


def _unpack_apply(payload: bytes, base: int, rows_per: int, dim: int):
    """Parse + validate one ApplyGrad-framed delta (unary request body or
    stream frame): returns ``(local_ids, grads[count, dim])``.  Raises
    ``ValueError`` on out-of-range ids BEFORE anything is enqueued, so a
    bad contribution can never poison a combined batch.  The count is
    guarded first (wire schema ``apply_req``): a negative count would
    make ``np.frombuffer`` silently re-interpret the whole payload
    (``count=-1`` means "read everything" to numpy — garbage ids AND
    garbage grads that can pass the range check), and an oversized one
    must reject cleanly instead of surfacing numpy internals."""
    (count,) = wire.read("<i", payload, 0, "apply.count")
    wire.check_count(count, (len(payload) - 4) // (4 + 4 * dim),
                     "apply.count")
    ids = np.frombuffer(payload, np.int32, count, 4) - base
    if ids.size and (ids.min() < 0 or ids.max() >= rows_per):
        raise ValueError(
            f"ids outside shard [{base}, {base + rows_per}) "
            f"for shard base {base}")
    grads = np.frombuffer(payload, np.float32, count * dim, 4 + 4 * count)
    return ids, grads.reshape(count, dim)


class GradCombiner:
    """Per-shard server-side write combiner (the execution-queue
    write-combining shape, cpp/fiber/execution_queue.h, applied to
    gradient application).

    ApplyGrad contributions ENQUEUE here instead of applying
    individually; whoever finds the combiner idle becomes the LEADER and
    drains every pending contribution into ONE concatenated application
    per drained batch — ``apply_fn`` runs once per batch, so write-lock
    hold time, snapshot installs (CPU shard) and scatter launches (device
    shard) are paid per BATCH, not per request.  Duplicate-id
    contributions sum exactly: both ``np.subtract.at`` and the device
    scatter (``unique_indices = false``) accumulate repeated indices, so
    concatenation IS the combine — commutative, order-independent up to
    float addition order.

    ``add(wait=True)`` (unary handlers) blocks until the caller's batch
    is applied and re-raises the batch's failure; ``add(wait=False)``
    (stream frames — no per-frame response exists) returns immediately,
    and :meth:`flush` provides the "everything before this point is
    applied" barrier by riding the queue as an empty contribution.
    Followers never lead and the leader never waits on followers, so
    there is no circular wait even on a single worker."""

    __slots__ = ("_apply", "_dim", "_mu", "_q", "_draining", "_shut",
                 "_pass_meta", "last_error")

    def __init__(self, apply_fn, dim: int, pass_meta: bool = False):
        self._apply = apply_fn          # apply_fn(local_ids, grads): ONE
        self._dim = dim                 # combined application
        self._mu = checked_lock("ps.combine")
        self._q: list = []
        self._draining = False
        self._shut = False
        # pass_meta: apply_fn(ids, grads, metas) — the drained batch's
        # per-contribution (writer, seq) tags ride along, so a
        # replicated shard can propagate its applied dedup window with
        # the batch it belongs to (never ahead of the data).
        self._pass_meta = bool(pass_meta)
        self.last_error: Optional[BaseException] = None

    def add(self, ids: np.ndarray, grads: np.ndarray,
            wait: bool = True, meta=None, deadline_us: int = 0) -> None:
        # [ids, grads, done-event, error, meta, deadline_us] — error is
        # filled by whichever leader applies the batch this entry lands
        # in.  deadline_us > 0 re-checks at DRAIN time: a contribution
        # whose propagated budget died while queued behind a slow batch
        # is dropped, not applied (the admission check alone cannot see
        # queueing inside the combiner — the PR-12 deferral).
        entry = [ids, grads, threading.Event() if wait else None, None,
                 meta, deadline_us]
        with self._mu:
            if self._shut:
                # Server teardown: late contributions (a dead client's
                # stream receiver being torn down by the socket-failure
                # hook, frames still in its delivery queue) are dropped —
                # the shard/device behind apply_fn may already be gone.
                return
            self._q.append(entry)
            leader = not self._draining
            if leader:
                self._draining = True
        if not leader:
            ev = entry[2]
            if ev is not None:
                ev.wait()
                if entry[3] is not None:
                    raise entry[3]
            return
        self._drain()
        if entry[3] is not None:
            raise entry[3]

    def _drain(self) -> None:
        """Leader loop: drain batches until the queue is empty (entries
        enqueued while a batch applies land in the next one)."""
        while True:
            with self._mu:
                batch = self._q
                if not batch:
                    self._draining = False
                    return
                self._q = []
            # Drain-time deadline shedding: a deadline that expired
            # while the entry sat in the combine queue must not apply —
            # its caller's budget is gone and a late mutation is worse
            # than a clean EDEADLINE (the answer is already too late,
            # the write would still burn the lock/snapshot).
            now_us = time.time() * 1e6
            expired = []
            live = []
            for e in batch:
                (expired if 0 < e[5] < now_us else live).append(e)
            if expired:
                batch = live
                if obs.enabled():
                    obs.counter("ps_deadline_drops").add(len(expired))
                    obs.counter("ps_deadline_drops_Drain").add(
                        len(expired))
                shed_err = rpc.RpcError(
                    resilience.EDEADLINE,
                    "propagated deadline budget exhausted in the "
                    "combine queue; contribution shed at drain")
                for e_ in expired:
                    e_[3] = shed_err
                    if e_[2] is not None:
                        e_[2].set()
                if not batch:
                    continue
            err: Optional[BaseException] = None
            try:
                if len(batch) == 1:
                    ids, grads = batch[0][0], batch[0][1]
                else:
                    ids = np.concatenate([e[0] for e in batch])
                    grads = np.concatenate([e[1] for e in batch])
                if ids.size:
                    if self._pass_meta:
                        self._apply(ids, grads,
                                    [e[4] for e in batch
                                     if e[4] is not None])
                    else:
                        self._apply(ids, grads)
                    if obs.enabled():
                        obs.counter("ps_combined_applies").add(1)
                        obs.counter("ps_combined_keys").add(int(ids.size))
                        obs.maxer("ps_combine_depth").update(len(batch))
            except Exception as e:  # noqa: BLE001 — delivered per entry
                err = e
                with self._mu:
                    self.last_error = e
                if obs.enabled():
                    obs.counter("ps_combine_errors").add(1)
            for e_ in batch:
                e_[3] = err
                if e_[2] is not None:
                    e_[2].set()

    def flush(self) -> None:
        """Returns once every contribution enqueued BEFORE this call has
        been applied (the stream-close barrier).  Raises the failure of
        the flush batch, if any.  A no-op after :meth:`shutdown`."""
        self.add(np.empty(0, np.int32),
                 np.empty((0, self._dim), np.float32), wait=True)

    def shutdown(self) -> None:
        """Stops accepting contributions and waits for any in-flight
        drain to finish.  Server close paths call this BEFORE destroying
        the table/shard/device behind ``apply_fn``, so a drain can never
        race resource teardown — late frames from dying streams are
        dropped instead of applied to freed state."""
        with self._mu:
            self._shut = True
            draining = self._draining
        while draining:
            time.sleep(0.001)
            with self._mu:
                draining = self._draining


class _ApplyStreamReceiver:
    """Server half of the streaming gradient push: each frame is one
    ApplyGrad-framed delta fed straight into the shard's combiner (no
    per-frame response).  Runs serialized on the stream's native
    delivery fiber — a combiner drain happening here delays the
    consumed-bytes feedback, which is exactly how server-side apply cost
    back-pressures the pushing trainer.  ``on_closed`` flushes the
    combiner (and, on a replicated primary, waits for backup acks)
    BEFORE the server's half closes, so a client's ``close(); join()``
    is an "every pushed delta is applied everywhere" barrier.

    ``writer`` non-empty = the framed mode: every frame carries a
    ``(seq, 0, 0)`` header and the server's per-writer monotonic seq
    window drops replays (reconnect-after-partial-write ships the same
    frame twice at most; the window makes the second a no-op instead of
    a double apply).  Empty writer = the legacy unframed mode.

    FENCING is re-checked per frame, not just at stream setup: a
    primary demoted while a push stream is up must not keep applying
    frames locally (the new primary's Sync would overwrite them — an
    acked-then-lost write).  A frame landing on a demoted server is
    DROPPED without reserving its seq, a fence notification (a negative
    int64) is written on the reply half, and the reply closes to break
    the stream — the pushing client fails over and replays; the dropped
    frame's seq stays below every replica's window so the replay
    applies."""

    __slots__ = ("_server", "_writer", "reply", "_fenced")

    def __init__(self, server, writer: str = ""):
        self._server = server
        self._writer = writer
        self.reply: "Optional[rpc.Stream]" = None
        self._fenced = False

    def _demoted(self) -> bool:
        fenced = getattr(self._server, "_stream_write_fenced", None)
        return fenced is not None and fenced()

    def _fence(self) -> None:
        """Mark this stream fenced and tell the client: a negative ack
        frame (-1 = replica demotion, -2 = the partition scheme was
        retired by a cutover), then break the stream so the next write
        fails over / refreshes its scheme."""
        if self._fenced:
            return
        self._fenced = True
        if obs.enabled():
            obs.counter("ps_stream_fenced").add(1)
        if self.reply is not None:
            code = -2 if getattr(self._server, "_scheme_fenced", False) \
                else -1
            try:
                self.reply.write(struct.pack("<q", code))
            except rpc.RpcError:
                pass   # client gone; its reconnect pays ENOTPRIMARY
            self.reply.close()

    def on_data(self, data: bytes) -> None:
        if self._fenced:
            return
        if self._demoted():
            self._fence()
            return
        try:
            if not self._writer:
                self._server._apply_frame(data)
                return
            if len(data) < _FRAME_HDR.size:
                raise wire.WireError(
                    f"stream frame shorter than its header "
                    f"({len(data)} < {_FRAME_HDR.size})")
            seq, _epoch, _gen = _FRAME_HDR.unpack_from(data, 0)
            if not self._server._reserve_seq(self._writer, seq):
                if obs.enabled():
                    obs.counter("ps_stream_dedup_drops").add(1)
                return
            self._server._apply_frame(memoryview(data)[_FRAME_HDR.size:],
                                      (self._writer, seq))
        except wire.WireError:
            # Frames have no response channel: a malformed frame is
            # counted and DROPPED — it must not kill the receiver or
            # poison the combiner.
            _reject_frame("StreamApply")

    def on_closed(self) -> None:
        try:
            self._server._combiner.flush()
            self._server.flush_replication()
        except rpc.RpcError:
            # ENOTPRIMARY from a demotion racing the drain, or EFENCED
            # from the replication barrier: the close must not read as
            # an "applied everywhere" ack.
            self._fence()
            return
        if self._demoted():
            self._fence()


class _ReplicaStreamReceiver:
    """Backup half of primary→backup delta propagation: each frame is
    one applied batch, epoch-fenced and generation-tagged.  Frames apply
    IN ORDER (the stream is ordered and this receiver is serialized), so
    after any prefix the backup's table is byte-identical to the
    primary's table at that generation — same concatenated batches, same
    ``subtract.at`` order, same float ops.  ``reply`` is the server half
    of the stream: every processed frame acks the backup's current
    generation back to the primary (the server→client direction), which
    is what the primary's flush barrier waits on."""

    __slots__ = ("_server", "reply")

    def __init__(self, server):
        self._server = server
        self.reply: "Optional[rpc.Stream]" = None

    def on_data(self, data: bytes) -> None:
        try:
            if len(data) < _FRAME_HDR.size:
                raise wire.WireError(
                    f"ReplicaApply frame shorter than its header "
                    f"({len(data)} < {_FRAME_HDR.size})")
            _seq, epoch, gen = _FRAME_HDR.unpack_from(data, 0)
            acked = self._server._apply_replica_frame(
                epoch, gen, memoryview(data)[_FRAME_HDR.size:])
        except wire.WireError:
            # A malformed propagation frame means the stream itself is
            # corrupt: count it and break the stream so the primary
            # reconnects through a full Sync (same treatment as a gap).
            _reject_frame("ReplicaApply")
            acked = None
        if acked is None:
            # Gap: break the stream so the primary reconnects through a
            # full sync instead of streaming into divergence.
            if self.reply is not None:
                self.reply.close()
            return
        if self.reply is not None:
            try:
                # negative = FENCE notification (acked is -epoch): the
                # sender is stale — tell it synchronously so an
                # in-flight flush fails with EFENCED instead of a
                # write being acked by a zombie, then break the stream.
                self.reply.write(struct.pack("<q", acked))
            except rpc.RpcError:
                pass  # primary gone; its reconnect re-learns the gen
            if acked < 0:
                self.reply.close()

    def on_closed(self) -> None:
        pass


class _ReplicaAckReceiver:
    """Primary-side read half of a propagation stream: collects the
    backup's per-frame generation acks."""

    __slots__ = ("_replicator", "_addr")

    def __init__(self, replicator, addr: str):
        self._replicator = replicator
        self._addr = addr

    def on_data(self, data: bytes) -> None:
        if len(data) < 8:
            _reject_frame("ReplicaAck")
            return
        (gen,) = struct.unpack_from("<q", data, 0)
        if gen < 0:   # fence notification: a newer primary exists
            self._replicator._note_fenced(self._addr)
            return
        self._replicator._note_ack(self._addr, gen)

    def on_closed(self) -> None:
        self._replicator._note_closed(self._addr)


class _MigrateStreamReceiver:
    """Import half of a live reshard on the DESTINATION shard: each
    frame is one source-shard applied batch FILTERED to this shard's
    row range (global ids; the ``ReplicaApply`` framing with the
    source's generation in the header), applied in arrival order —
    the stream is ordered and this receiver serialized, so per source
    the destination replays the source's exact float ops on the
    migrated rows.  Every processed frame acks the source-generation
    watermark back on the reply half (what the source's cutover flush
    waits on); a frame arriving after the import completed is refused
    (``None``) and the stream breaks — the source's resync attempt
    then fails loudly with ESCHEMEMOVED instead of silently diverging."""

    __slots__ = ("_server", "_src", "reply")

    def __init__(self, server, src: str):
        self._server = server
        self._src = src
        self.reply: "Optional[rpc.Stream]" = None

    def on_data(self, data: bytes) -> None:
        try:
            if len(data) < _FRAME_HDR.size:
                raise wire.WireError(
                    f"MigrateApply frame shorter than its header "
                    f"({len(data)} < {_FRAME_HDR.size})")
            gen, _scheme, _gen2 = _FRAME_HDR.unpack_from(data, 0)
            acked = self._server._apply_migrate_frame(
                self._src, gen, memoryview(data)[_FRAME_HDR.size:])
        except wire.WireError:
            # Same contract as the replica receiver: a malformed handoff
            # frame breaks the stream so the source resyncs wholesale.
            _reject_frame("MigrateApply")
            acked = None
        if acked is None:
            if self.reply is not None:
                self.reply.close()
            return
        if self.reply is not None:
            try:
                self.reply.write(struct.pack("<q", acked))
            except rpc.RpcError:
                pass  # source gone; its reconnect re-syncs the range

    def on_closed(self) -> None:
        pass


class _PeerState:
    """One backup's propagation state (owned by its worker thread; the
    queue/ack fields are shared under the replicator lock)."""

    __slots__ = ("addr", "queue", "wake", "stream", "synced_gen",
                 "acked_gen", "need_sync", "fenced", "down")

    def __init__(self, addr: str):
        self.addr = addr
        self.queue: collections.deque = collections.deque()
        self.wake = threading.Event()
        self.stream: "Optional[rpc.Stream]" = None
        self.synced_gen = -1     # -1 = never connected
        self.acked_gen = 0
        self.need_sync = True
        self.fenced = False
        # True after a failed connect attempt (network, not fencing):
        # the ack barrier skips an unreachable peer — its eventual
        # reconnect resyncs the FULL table, so nothing shipped while it
        # was down can be lost, only delayed.
        self.down = False


class _Replicator:
    """Primary-side delta propagation: one worker thread per backup
    ships every applied batch, in generation order, over a persistent
    ``ReplicaApply`` stream (reconnect → full ``Sync`` first, so a gap
    can never stream into divergence).  ``ship`` is an append under the
    lock — the applying writer never blocks on a slow backup; a backup
    that falls more than ``max_queue`` batches behind is resynced
    wholesale instead of queueing unboundedly.  ``flush(target_gen)``
    waits until every un-fenced backup has ACKED ``target_gen`` (acks
    ride the server→client half of the stream) — the zero-lost-updates
    barrier.  An EFENCED from any backup means a newer primary exists:
    the owner demotes itself and every worker stops.

    QUORUM mode (``quorum`` = the total number of replicas, primary
    included, that must hold a write before it acks): ``flush`` waits
    until ``quorum - 1`` backups acked ``target_gen`` — and unlike the
    legacy connected-only barrier it does NOT skip a disconnected peer:
    a bootstrap write blocks until real acks exist, which is what
    closes the PR-9 single-fault loss window (an acked write on
    ``quorum`` replicas intersects every majority promotion sweep, so
    the client's acked-gen floor becomes a guarantee instead of a
    refusal heuristic)."""

    def __init__(self, server, peers: Sequence[str], epoch: int,
                 max_queue: int = 512, timeout_ms: int = 5000,
                 quorum: Optional[int] = None):
        self._server = server
        self.epoch = epoch
        self.max_queue = max_queue
        self.timeout_ms = timeout_ms
        if quorum is not None and not 1 <= quorum <= len(peers) + 1:
            raise ValueError(
                f"quorum {quorum} outside [1, {len(peers) + 1}] for "
                f"{len(peers)} backup(s)")
        self.quorum = quorum
        #: hydrate-first (re)connect: when the owning server has a
        #: checkpoint store attached, a peer already inside the store's
        #: delta window gets the TAIL instead of a wholesale Sync
        self.hydrate = True
        self._mu = checked_lock("ps.replicate")
        self._stop = threading.Event()
        # True when stopped BECAUSE of a fence/demotion: an in-flight
        # flush must raise EFENCED (the new primary's Sync will wipe the
        # batch), never break out as success.
        self._demoted = False
        self._ack_ev = threading.Event()
        self._chans: Dict[str, rpc.Channel] = {}
        self._peers = [_PeerState(a) for a in peers]
        self._threads: List[threading.Thread] = []
        for p in self._peers:
            t = threading.Thread(target=self._worker, args=(p,),
                                 daemon=True,
                                 name=f"brt-replicate-{p.addr}")
            t.start()
            self._threads.append(t)

    # -- the apply path's side (non-blocking) -----------------------------

    def ship(self, gen: int, body) -> None:
        """Enqueue one applied batch (already ApplyGrad-framed with
        GLOBAL ids) for every backup.  Called under the shard write lock
        — append-only, never blocks on the network."""
        frame = bytes(_pack_stream_frame(gen, self.epoch, gen, body))
        with self._mu:
            for p in self._peers:
                p.queue.append((gen, frame))
                if len(p.queue) > self.max_queue:
                    # Hopelessly behind: resync wholesale on reconnect
                    # rather than holding every batch in memory.
                    p.queue.clear()
                    p.need_sync = True
        for p in self._peers:
            p.wake.set()
        if obs.enabled():
            obs.counter("ps_replica_frames").add(len(self._peers))
            obs.counter("ps_replica_bytes").add(
                len(frame) * len(self._peers))

    # -- ack plumbing ------------------------------------------------------

    def _note_ack(self, addr: str, gen: int) -> None:
        with self._mu:
            for p in self._peers:
                if p.addr == addr and gen > p.acked_gen:
                    p.acked_gen = gen
        self._ack_ev.set()

    def _note_closed(self, addr: str) -> None:
        with self._mu:
            for p in self._peers:
                if p.addr == addr:
                    p.need_sync = True
        self._ack_ev.set()

    def _note_fenced(self, addr: str) -> None:
        """A backup refused a frame with a FENCE notification: a newer
        primary exists.  Fail any in-flight flush with EFENCED and
        demote the owner."""
        with self._mu:
            for p in self._peers:
                if p.addr == addr:
                    p.fenced = True
        self._ack_ev.set()
        self._server._demote_on_fence()

    def acked_gens(self) -> Dict[str, int]:
        with self._mu:
            return {p.addr: p.acked_gen for p in self._peers}

    def resync_peers(self, hydrate: Optional[bool] = None) -> None:
        """Force every backup through a resync.  With a checkpoint
        store attached (and ``hydrate`` mode on) the reconnect tries
        hydrate-first: a backup whose generation still sits inside the
        store's delta window receives only the tail; anyone else — and
        every backup after a ``MigrateSync`` range install, which
        re-bases the store — falls through to the full-table ``Sync``
        of the current state.  ``hydrate`` (when not None) stickily
        switches the mode."""
        if hydrate is not None:
            self.hydrate = bool(hydrate)
        with self._mu:
            for p in self._peers:
                p.queue.clear()
                p.need_sync = True
        for p in self._peers:
            p.wake.set()

    def flush(self, target_gen: int, timeout_s: float = 5.0) -> None:
        """The ack barrier.  QUORUM mode (``quorum`` set): returns once
        this primary plus ``quorum - 1`` backups hold ``target_gen`` —
        a disconnected peer is NOT skipped, the write waits for real
        acks (or fails loudly).  Legacy mode: returns once every
        CONNECTED backup acked ``target_gen``; a peer without an
        established delta stream (never synced, mid resync, or
        unreachable) is skipped — its (re)connect starts with a full
        ``Sync`` of the current table, so skipping delays its copy
        without losing updates.  Raises ERPCTIMEDOUT naming the laggard
        on timeout, EFENCED if a newer primary fenced this one
        mid-flush."""
        if self.quorum is not None:
            self._flush_quorum(target_gen, timeout_s)
            return
        deadline = time.monotonic() + timeout_s
        for p in self._peers:
            while True:
                with self._mu:
                    acked, fenced = p.acked_gen, p.fenced
                    live = (p.stream is not None and not p.need_sync
                            and not p.down)
                if fenced or self._demoted:
                    raise rpc.RpcError(
                        resilience.EFENCED,
                        f"fenced by a newer primary while flushing "
                        f"to {p.addr}")
                if acked >= target_gen or not live or \
                        self._stop.is_set():
                    break
                if time.monotonic() > deadline:
                    raise rpc.RpcError(
                        1008, f"replica {p.addr} acked gen {acked} < "
                              f"{target_gen} within {timeout_s:.1f}s")
                self._ack_ev.clear()
                with self._mu:
                    if p.acked_gen >= target_gen:
                        break
                self._ack_ev.wait(0.005)

    def _flush_quorum(self, target_gen: int, timeout_s: float) -> None:
        """Majority-ack barrier: blocks until ``quorum - 1`` backups
        acked ``target_gen`` (this primary is the remaining voter).
        Never skips a disconnected peer — with the quorum unreachable
        the write FAILS after ``timeout_s`` instead of acking on the
        primary alone (loud unavailability over silent loss)."""
        need = self.quorum - 1
        deadline = time.monotonic() + timeout_s
        while True:
            with self._mu:
                acked = sum(1 for p in self._peers
                            if p.acked_gen >= target_gen)
                fenced = any(p.fenced for p in self._peers)
            if fenced or self._demoted:
                raise rpc.RpcError(
                    resilience.EFENCED,
                    f"fenced by a newer primary while awaiting quorum "
                    f"for gen {target_gen}")
            if acked >= need:
                return
            if self._stop.is_set():
                raise rpc.RpcError(
                    1008,
                    f"replicator stopped before gen {target_gen} "
                    f"reached quorum ({acked + 1}/{self.quorum})")
            if time.monotonic() > deadline:
                raise rpc.RpcError(
                    1008,
                    f"quorum {self.quorum} not reached for gen "
                    f"{target_gen} within {timeout_s:.1f}s "
                    f"({acked + 1}/{self.quorum} hold it; acked "
                    f"{self.acked_gens()})")
            self._ack_ev.clear()
            with self._mu:
                if sum(1 for p in self._peers
                       if p.acked_gen >= target_gen) >= need:
                    return
            self._ack_ev.wait(0.005)

    # -- per-backup worker -------------------------------------------------

    def _channel(self, addr: str) -> rpc.Channel:
        ch = self._chans.get(addr)
        if ch is None:
            ch = rpc.Channel(addr, timeout_ms=self.timeout_ms)
            self._chans[addr] = ch
        return ch

    def _connect(self, p: _PeerState) -> bool:
        """Full-state handoff then a fresh delta stream: ``Sync`` ships
        a consistent (epoch, gen, table) snapshot — the backup installs
        it wholesale — and the stream resumes from that generation, so
        queued frames at or below it are ship-skipped (the backup would
        dedup them anyway)."""
        epoch, gen, table, windows = \
            self._server._replication_snapshot()
        ch = self._channel(p.addr)
        try:
            ch.call("Ps", "Sync",
                    struct.pack("<qqq", epoch, gen,
                                len(table) // 4) + table
                    + _pack_windows(windows),
                    timeout_ms=self.timeout_ms)
            st = ch.stream("Ps", "ReplicaApply",
                           struct.pack("<q", epoch),
                           receiver=_ReplicaAckReceiver(self, p.addr))
        except rpc.RpcError as e:
            if e.code == resilience.EFENCED:
                with self._mu:
                    p.fenced = True
                self._ack_ev.set()
                self._server._demote_on_fence()
                return False
            with self._mu:
                p.down = True   # unreachable: the ack barrier skips it
            self._ack_ev.set()
            if obs.enabled():
                obs.counter("ps_replica_connect_errors").add(1)
            return False
        with self._mu:
            p.stream = st
            p.synced_gen = gen
            p.need_sync = False
            p.down = False
            if gen > p.acked_gen:
                p.acked_gen = gen   # the Sync response IS the ack
        self._ack_ev.set()
        if obs.enabled():
            obs.counter("ps_replica_syncs").add(1)
            obs.counter("ps_replica_sync_bytes").add(len(table))
        return True

    def _try_hydrate(self, p: _PeerState) -> Optional[bool]:
        """Hydrate-first (re)connect: when the backup's current
        generation sits inside the checkpoint store's delta window,
        open the delta stream and ship only the missing TAIL from disk
        — the live table is never snapshotted or shipped.  Safe because
        within one epoch the generation sequence is a function of the
        primary's apply chain (the stream setup adopts our epoch or
        fences us), and a ``Promote``/wholesale install always re-bases
        the store, pushing any possibly-divergent peer out of the
        window.  Returns True on success, False on a hard failure
        (fenced/unreachable — the caller backs off), None to fall
        through to the wholesale ``_connect``."""
        store = getattr(self._server, "_durable", None)
        if store is None or not self.hydrate:
            return None
        ch = self._channel(p.addr)
        try:
            st = ch.stream("Ps", "ReplicaApply",
                           struct.pack("<q", self.epoch),
                           receiver=_ReplicaAckReceiver(self, p.addr))
        except rpc.RpcError as e:
            if e.code == resilience.EFENCED:
                with self._mu:
                    p.fenced = True
                self._ack_ev.set()
                self._server._demote_on_fence()
                return False
            with self._mu:
                p.down = True
            self._ack_ev.set()
            if obs.enabled():
                obs.counter("ps_replica_connect_errors").add(1)
            return False
        try:
            _peer_epoch, peer_gen, peer_seeded = wire.read(
                "<qqq", st.response, 0, "ReplicaApply.rsp")
        except wire.WireError:
            st.close()
            return None
        if peer_gen < 0 or (peer_gen == 0 and not peer_seeded):
            # A fresh backup's seed table is not provably this chain's
            # gen-0 image — only a wholesale Sync (or a restored
            # seeded checkpoint base, which the setup response's
            # seeded flag attests) may establish it.
            st.close()
            return None
        deltas = store.tail_since(peer_gen)
        if deltas is None or peer_gen > store.last_gen:
            # The peer predates the base — or claims a generation the
            # log never recorded (a divergent history): wholesale.
            st.close()
            return None
        last = peer_gen
        tail_bytes = 0
        if zerocopy_enabled():
            # Whole tail in one batched native crossing, delta bodies
            # borrowed rather than copied into frame bytes.
            batch = []
            try:
                for gen, body in deltas:
                    batch.append(_pack_stream_frame_iobuf(
                        gen, self.epoch, gen, body))
                    tail_bytes += len(batch[-1])
                    last = gen
                try:
                    st.writev(batch)
                except rpc.RpcError:
                    st.close()
                    return None   # died mid-tail: wholesale converges
            finally:
                for io in batch:
                    io.close()
        else:
            try:
                for gen, body in deltas:
                    frame = bytes(_pack_stream_frame(gen, self.epoch,
                                                     gen, body))
                    st.write(frame)
                    tail_bytes += len(frame)
                    last = gen
            except rpc.RpcError:
                st.close()
                return None   # stream died mid-tail: wholesale converges
        with self._mu:
            p.stream = st
            p.synced_gen = last
            p.need_sync = False
            p.down = False
            if peer_gen > p.acked_gen:
                p.acked_gen = peer_gen
        self._ack_ev.set()
        if obs.enabled():
            obs.counter("ps_replica_hydrates").add(1)
            obs.counter("ps_replica_hydrate_tail_bytes").add(tail_bytes)
        return True

    def _worker(self, p: _PeerState) -> None:
        backoff = resilience.Backoff(base_ms=5.0, max_ms=200.0)
        fails = 0
        while not self._stop.is_set():
            with self._mu:
                fenced = p.fenced
                item = p.queue[0] if (p.queue and not p.need_sync
                                      and p.stream is not None) else None
                # Eager: (re)connect whether or not anything is queued —
                # backups sync at boot/recovery time, not first-write
                # time, which shrinks the window where the ack barrier
                # has no established stream to wait on.
                need_connect = (not fenced
                                and (p.need_sync or p.stream is None))
            if fenced:
                return
            if need_connect:
                old, p.stream = p.stream, None
                if old is not None:
                    old.close()   # rx stream: close (abort strands relay)
                ok = self._try_hydrate(p)
                if ok is None:
                    ok = self._connect(p)
                if ok:
                    fails = 0
                else:
                    if self._stop.is_set() or p.fenced:
                        return
                    fails += 1
                    resilience.sleep_ms(backoff.delay_ms(min(fails, 6)))
                continue
            if item is None:
                p.wake.wait(0.05)
                p.wake.clear()
                continue
            gen, frame = item
            if gen <= p.synced_gen:
                with self._mu:
                    if p.queue and p.queue[0] is item:
                        p.queue.popleft()
                continue
            if zerocopy_enabled():
                # Drain the eligible head run in ONE native crossing —
                # queue gens are append-ordered, so once the head
                # clears ``synced_gen`` the whole run does.  Frame
                # bytes are pinned (not copied) by ``writev``.
                with self._mu:
                    batch = []
                    for it in p.queue:
                        if it[0] <= p.synced_gen:
                            break
                        batch.append(it)
                        if len(batch) >= 64:
                            break
                try:
                    p.stream.writev([it[1] for it in batch])
                except rpc.RpcError as e:
                    # frames before the break ARE on the wire: pop
                    # them so the resync does not re-ship
                    nw = getattr(e, "frames_written", 0)
                    st, p.stream = p.stream, None
                    if st is not None:
                        st.close()
                    with self._mu:
                        for it in batch[:nw]:
                            if p.queue and p.queue[0] is it:
                                p.queue.popleft()
                        p.need_sync = True
                    continue
                with self._mu:
                    for it in batch:
                        if p.queue and p.queue[0] is it:
                            p.queue.popleft()
                continue
            try:
                p.stream.write(frame)
            except rpc.RpcError:
                st, p.stream = p.stream, None
                if st is not None:
                    st.close()
                with self._mu:
                    p.need_sync = True
                continue  # frame stays queued; resync covers ordering
            with self._mu:
                if p.queue and p.queue[0] is item:
                    p.queue.popleft()

    def stop(self, join: bool = True, fenced: bool = False) -> None:
        """Stop propagation.  Channels/streams are closed only AFTER
        every worker exited: a worker can be mid-``ch.call`` on one of
        them, and closing the native channel under it is a
        use-after-free (the bring-up crash the churn bench found — a
        fence-driven ``stop(join=False)`` used to close the channel
        set while a sibling worker's Sync was still on the wire).
        ``join=False`` (and any call from a worker/receiver thread —
        ``_demote_on_fence`` runs on both) defers the teardown to a
        reaper thread instead of blocking the caller."""
        if fenced:
            self._demoted = True
        self._stop.set()
        self._ack_ev.set()
        for p in self._peers:
            p.wake.set()
        if join and threading.current_thread() not in self._threads:
            for t in self._threads:
                t.join(timeout=5)
            self.close()
        else:
            threading.Thread(target=self._reap, daemon=True,
                             name="brt-replicator-reaper").start()

    def _reap(self) -> None:
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=5)
        self.close()

    def close(self) -> None:
        """Release the peer streams and channels.  Only safe once the
        workers exited — ``stop``/``_reap`` are the callers."""
        for p in self._peers:
            st, p.stream = p.stream, None
            if st is not None:
                st.close()
        for ch in self._chans.values():
            ch.close()
        self._chans.clear()


#: process-unique suffix for per-SERVER obs variables (two servers with
#: the same shard_index — a primary and its backup — must not pool their
#: tail-pressure signals)
_server_seq = itertools.count()


class PsShardServer:
    """One embedding shard behind a native RPC server.

    ``native_read=True`` serves ``Lookup`` with ZERO Python in the loop:
    a native generation-versioned shard (:class:`rpc.PsShard`) is
    attached to the same service, and the Python tier keeps the whole
    write path — ``ApplyGrad`` mutates the numpy table under the write
    lock, then publishes an immutable snapshot via ``install``.  Both
    paths serve ONE table; reads never see a torn row because snapshots
    are immutable and generation-pinned (the device shard's
    handle-generation scheme, moved into the native core).  Note that
    server-side fault injection and obs hooks live in the Python
    trampoline, so with ``native_read`` they apply to the write path
    only — the reference's position (SURVEY §3.1) is that the read hot
    path IS the native handler.

    Write-path scale (the read path's mirror image):

    - ``combine=True`` routes unary ApplyGrad through a
      :class:`GradCombiner` — concurrent writers' grads coalesce and the
      write lock / snapshot install is paid once per DRAINED BATCH
      instead of once per request (the dominant unary cost under
      ``native_read``, where every apply memcpy's the whole table).
    - ``stream=True`` additionally serves ``StreamApply``: a client
      opens an ordered flow-controlled stream (``Channel.stream`` /
      ``RemoteEmbedding.push_gradients``) and ships framed deltas at
      wire rate, no per-call dispatch; frames feed the combiner
      directly and the client's ``close(); join()`` barrier guarantees
      application.  Because the combiner sums duplicate ids exactly and
      float addition is commutative here, unary / combined / streamed
      orderings land byte-identical tables for exactly-representable
      gradients (proven in tests/test_ps_stream.py)."""

    #: data-plane methods gated by a spec-string limiter; control
    #: traffic (failover, migration, flush barriers) stays admissible
    #: under overload — shedding a Promote would turn an overload into
    #: an availability incident
    LIMITED_METHODS = ("Lookup", "ApplyGrad", "ApplyGradId")

    def __init__(self, vocab: int, dim: int, shard_index: int,
                 num_shards: int, lr: float = 0.1, seed: int = 0,
                 lock_mode: str = "rw", native_read: bool = False,
                 combine: bool = False, stream: bool = False,
                 importing: bool = False, scheme_version: int = 0,
                 limiter=None):
        if vocab % num_shards:
            raise ValueError("num_shards must divide vocab")
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.rows_per = vocab // num_shards
        self.base = shard_index * self.rows_per
        self.dim = dim
        self.lr = lr
        rng = np.random.default_rng(seed + shard_index)
        self.table = (rng.standard_normal((self.rows_per, dim)) * 0.02
                      ).astype(np.float32)
        # Handlers run concurrently on fiber workers (the trampoline
        # releases the GIL, and numpy releases it again for big ops): a
        # Lookup gather racing an ApplyGrad scatter-sub on overlapping
        # rows reads torn updates.  Reads share, writes exclude: hot read
        # loads gather in parallel while ApplyGrad takes the write side.
        # lock_mode="mutex" restores the old fully-serialized model (the
        # bench baseline).
        if lock_mode == "rw":
            self._mu = checked_rwlock("ps.shard")
        elif lock_mode == "mutex":
            self._mu = _ExclusiveAsRw(checked_lock("ps.shard"))
        else:
            raise ValueError(f"unknown lock_mode {lock_mode!r}")
        self.native_read = bool(native_read)
        self.combine = bool(combine)
        self.stream = bool(stream)
        self._shard: "Optional[rpc.PsShard]" = None
        self._install_gen = 0
        # Replication state (configure_replication): fencing epoch,
        # whether THIS replica owns writes, the declared replica set, and
        # the primary-side propagation machinery.
        self._epoch = 0
        self._primary_flag = True
        self._replica_set: Optional[ReplicaSet] = None
        self._replica_index = 0
        self._replicator: Optional[_Replicator] = None
        #: resolved write-quorum size (replicas, primary included, that
        #: must hold a write before it acks); None = the legacy
        #: connected-backups-only barrier
        self._quorum: Optional[int] = None
        #: replicated migration spec (MigrateStart payload): a promoted
        #: source re-installs its shipper from this — the automatic
        #: re-drive that replaces the manual re-issued MigrateStart
        self._pending_migration: Optional[dict] = None
        #: attached checkpoint store (brpc_tpu_torch.durable.CheckpointStore;
        #: None = volatile).  The apply paths tee every generation into
        #: it UNDER the table write lock — log order is apply order —
        #: and replica reconnects go hydrate-first through its tail.
        self._durable = None
        #: whether this table was established by the replication chain
        #: (a wholesale Sync landed, a seeded checkpoint base restored,
        #: or this node was promoted).  A PRIMARY is implicitly seeded
        #: — its table IS the chain origin — so consumers read
        #: ``self._seeded or self._primary_flag``.  This is what makes
        #: a gen-0 backup hydratable: without it, gen 0 could mean
        #: "fresh random-init table" just as well as "the chain's
        #: exact gen-0 image" (the PR-16 first-boot residue).
        self._seeded = False
        self._repl_mu = checked_lock("ps.repl_state")
        # Elastic-resharding state: which partition scheme this shard
        # belongs to, whether it is still IMPORTING its row range (a
        # split/merge destination before cutover — data paths answer
        # EMIGRATING until CompleteImport), whether its scheme was
        # retired by a fenced cutover (writes answer ESCHEMEMOVED — the
        # redirect that drives client scheme refresh), and the
        # primary-side migration shipper streaming this shard's rows to
        # the successor scheme (brpc_tpu_torch.reshard.MigrationShipper).
        self.scheme_version = int(scheme_version)
        self._importing = bool(importing)
        self._scheme_fenced = False
        self._next_scheme: Optional[int] = None
        self._migrator = None
        #: per-source migration watermark: the source shard's generation
        #: covered by this import so far (guarded by the table WRITE
        #: lock — every mutation happens inside an apply/sync install)
        self._import_gens: Dict[str, int] = {}
        self._read_count = 0
        #: per-SERVER tail-pressure signals surfaced through SchemeInfo
        #: (uniquely named on purpose: the process-wide per-shard-index
        #: recorders blur same-index servers across schemes/replicas);
        #: dropped at close alongside the limiter gauges
        sid = next(_server_seq)
        self._sig_names = (f"ps_p99_shard{shard_index}_{sid}",
                           f"ps_sheds_shard{shard_index}_{sid}")
        self._lat = obs.recorder(self._sig_names[0])
        self._sheds = obs.counter(self._sig_names[1])
        #: last (sum_us, count) folded from the native Lookup path into
        #: self._lat — zero-Python reads never cross the Python recorder,
        #: so SchemeInfo drains the native counters (PsShard.lookup_stats)
        #: into it incrementally before reporting p99
        self._native_lat_seen = (0, 0)
        #: how long a replicated apply waits for backup acks before
        #: failing the write (sync replication among reachable replicas)
        self.repl_ack_timeout_s = 5.0
        #: per-call timeout for replication control traffic (Sync /
        #: stream setup to backups) — bounds how long a blackholed
        #: backup can stall the first flush before it is marked down
        self.repl_timeout_ms = 2000
        # Per-writer monotonic seq windows for idempotent stream replay:
        # _writer_seqs is the ADMISSION window (reserved at enqueue —
        # dedups replays on this server); _writer_applied trails it at
        # APPLY time and is what replication propagates (Sync +
        # per-frame), so a promoted backup inherits a window that never
        # claims a seq whose data it does not hold.
        self._seq_mu = checked_lock("ps.writer_seq")
        self._writer_seqs: Dict[str, int] = {}
        self._writer_applied: Dict[str, int] = {}
        # The combiner exists whenever anything feeds it: unary combining
        # (combine) or streamed deltas (stream — frames ALWAYS combine,
        # they have no per-frame response to serialize on).
        self._combiner: Optional[GradCombiner] = (
            GradCombiner(self._apply_batch, dim, pass_meta=True)
            if (self.combine or self.stream) else None)
        self.server = rpc.Server()
        # Overload control (brpc_tpu_torch.limiter): a spec string ("auto" /
        # "constant:<n>") gates the DATA-PLANE methods with per-method
        # adaptive admission, and — under native_read — installs the
        # same policy as the NATIVE server-wide limiter so the
        # zero-Python Lookup path sheds too (both answer ELIMIT).  A
        # ready-built ServerLimiter passes through as-is (callers pick
        # their own method set / options / clock).
        self.limiter: Optional[ServerLimiter] = None
        self._gauge_names: tuple = ()
        if limiter is not None:
            if isinstance(limiter, str):
                self.limiter = ServerLimiter(
                    limiter, methods=self.LIMITED_METHODS,
                    counter_prefix="ps")
                if self.native_read:
                    name, _, arg = limiter.partition(":")
                    self.server.set_native_concurrency_limiter(
                        name, int(arg) if arg else 0)
            else:
                self.limiter = limiter
            self.server.set_concurrency_limiter(self.limiter)
            if obs.enabled():
                lim = self.limiter
                self._gauge_names = (
                    f"ps_inflight_shard{shard_index}",
                    f"ps_max_concurrency_shard{shard_index}")
                obs.gauge(self._gauge_names[0], lim.total_inflight)
                obs.gauge(self._gauge_names[1],
                          lambda: max(lim.max_concurrency().values(),
                                      default=0))
        # The trampoline is ALWAYS stream-capable: replica delta
        # propagation (ReplicaApply) rides a stream whether or not the
        # client-facing StreamApply mode is on.
        if self.native_read:
            self._shard = rpc.PsShard(vocab, dim, shard_index, num_shards)
            if not self._importing:
                self._shard.install(self.table, 0)
            # An IMPORTING destination defers its first install to
            # CompleteImport: until then the native handler answers
            # Lookup with "no table generation installed" (EINTERNAL) —
            # never unmigrated garbage — and scheme-aware clients fall
            # back to the source scheme.
            self.server.add_ps_service(
                "Ps", self._shard, self._handle_stream, stream=True)
        else:
            self.server.add_stream_handler("Ps", self._handle_stream)
        # `_status` rides along so the health-check prober can revive
        # this shard after a circuit-breaker isolation (resilience tier).
        self.server.add_status_service()
        self.port = self.server.start("127.0.0.1:0")

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    # -- replication surface ----------------------------------------------

    def configure_replication(self, replica_set: ReplicaSet,
                              replica_index: int, *,
                              timeout_ms: Optional[int] = None,
                              ack_timeout_s: Optional[float] = None,
                              quorum: "int | str | None" = "auto"
                              ) -> None:
        """Declares this server's place in its range's replica group
        (call after every replica has started — addresses are only known
        then).  The replica at ``replica_set.primary`` owns writes and
        starts propagating applied batches to the others; everyone else
        serves reads and applies ``ReplicaApply`` deltas.
        ``timeout_ms``/``ack_timeout_s`` tune the propagation control
        timeout and the per-apply ack wait.

        ``quorum`` is the write-ack quorum (replicas, primary included,
        that must HOLD a write before it acks): ``"auto"`` (the
        default) takes the majority for groups of three or more and the
        legacy connected-backups barrier for pairs; ``"majority"``
        forces the majority; an int passes through; ``None`` forces the
        legacy barrier.  With a quorum, the bootstrap loss window is
        closed — the first write blocks until a backup really holds it
        — and a majority promotion sweep provably intersects every
        acked write."""
        if replica_set.addresses[replica_index] != self.address:
            raise ValueError(
                f"replica_index {replica_index} is "
                f"{replica_set.addresses[replica_index]}, not this "
                f"server ({self.address})")
        if timeout_ms is not None:
            self.repl_timeout_ms = int(timeout_ms)
        if ack_timeout_s is not None:
            self.repl_ack_timeout_s = float(ack_timeout_s)
        n = len(replica_set.addresses)
        if quorum == "auto":
            quorum = n // 2 + 1 if n >= 3 else None
        elif quorum == "majority":
            quorum = n // 2 + 1
        elif quorum is not None:
            quorum = int(quorum)
            if not 1 <= quorum <= n:
                raise ValueError(
                    f"quorum {quorum} outside [1, {n}]")
        with self._repl_mu:
            self._replica_set = replica_set
            self._replica_index = replica_index
            self._quorum = quorum
            self._primary_flag = replica_index == replica_set.primary
            if self._primary_flag and len(replica_set.addresses) > 1:
                self._replicator = _Replicator(
                    self, [a for a in replica_set.addresses
                           if a != self.address], epoch=self._epoch,
                    timeout_ms=self.repl_timeout_ms,
                    quorum=self._quorum)

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def is_primary(self) -> bool:
        """True when this replica owns writes (always true without a
        configured replica set — the legacy single-owner mode)."""
        return self._primary_flag

    def _peers(self) -> List[str]:
        rs = self._replica_set
        if rs is None:
            return []
        return [a for a in rs.addresses if a != self.address]

    def _check_primary(self) -> None:
        if not self._primary_flag:
            raise rpc.RpcError(
                resilience.ENOTPRIMARY,
                f"shard {self.shard_index} replica {self._replica_index} "
                f"({self.address}) is not the primary (epoch "
                f"{self._epoch})")

    def _check_repl_epoch(self, epoch: int) -> None:
        """Fencing: a replication message (Sync / ReplicaApply setup)
        carrying a stale epoch is rejected; a NEWER epoch means a newer
        primary exists — adopt it and demote if this node thought it was
        primary."""
        demote = None
        with self._repl_mu:
            if self._replica_set is None:
                # Bring-up race: this server has not been configured
                # into its replica group yet, so it cannot judge epochs
                # — and it must NOT answer the equal-epoch EFENCED
                # meant for stale primaries (an eager-connecting real
                # primary would demote itself off it).  Reject
                # retriably; the sender backs off and resyncs once
                # configuration lands.
                raise rpc.RpcError(
                    2001,
                    f"shard {self.shard_index} ({self.address}) has no "
                    f"replica group configured yet; retry the sync")
            if epoch < self._epoch or (epoch == self._epoch
                                       and self._primary_flag):
                if obs.enabled():
                    obs.counter("ps_replica_fenced").add(1)
                raise rpc.RpcError(
                    resilience.EFENCED,
                    f"stale replication epoch {epoch} (current "
                    f"{self._epoch}, primary={self._primary_flag})")
            if epoch > self._epoch:
                self._epoch = epoch
                if self._primary_flag:
                    self._primary_flag = False
                    demote, self._replicator = self._replicator, None
        if demote is not None:
            demote.stop(join=False, fenced=True)

    def _demote_on_fence(self) -> None:
        """A backup rejected our propagation with EFENCED: a newer
        primary exists.  Stop propagating and stop accepting writes; the
        new primary's Sync will overwrite any divergence."""
        demote = None
        with self._repl_mu:
            if self._primary_flag:
                self._primary_flag = False
                demote, self._replicator = self._replicator, None
                if obs.enabled():
                    obs.counter("ps_replica_demotions").add(1)
        if demote is not None:
            demote.stop(join=False, fenced=True)

    def _stream_write_fenced(self) -> bool:
        """True when streamed writes must be refused: this replica was
        demoted (or never was primary) while carrying a push stream, or
        its partition scheme was retired by a cutover."""
        return self._scheme_fenced or (
            self._replica_set is not None and not self._primary_flag)

    def _check_scheme(self) -> None:
        """Scheme gate for the WRITE paths (+ the importing half for
        reads): a cutover-fenced shard redirects writers to the
        successor scheme; an importing destination asks callers to wait
        out (writes) or fall back across schemes (reads)."""
        if self._scheme_fenced:
            nxt = f" (successor scheme v{self._next_scheme})" \
                if self._next_scheme is not None else ""
            raise rpc.RpcError(
                resilience.ESCHEMEMOVED,
                f"shard {self.shard_index} scheme "
                f"v{self.scheme_version} was retired by a fenced "
                f"cutover{nxt}; refresh the partition scheme")
        if self._importing:
            raise rpc.RpcError(
                resilience.EMIGRATING,
                f"shard {self.shard_index} scheme "
                f"v{self.scheme_version} is still importing rows "
                f"[{self.base}, {self.base + self.rows_per})")

    def claim_tag(self) -> str:
        """This replica's shard tag WITH its live primary/epoch claim —
        pass as ``tag_fn=`` to :meth:`naming.NamingClient.register` so
        every heartbeat publishes failover state into the registry
        (clients adopt the claimed primary instead of sweeping)."""
        from brpc_tpu_torch import naming
        return naming.shard_tag(self.shard_index, self.num_shards,
                                self._replica_index, epoch=self._epoch,
                                primary=self._primary_flag,
                                scheme=self.scheme_version)

    def _reads(self) -> int:
        """Total reads ever served (Python + native path) — the drain
        signal: a retiring scheme's shards are idle once this stops
        moving."""
        with self._seq_mu:
            n = self._read_count
        return n + self.native_lookups

    def _fold_native_latency(self) -> None:
        """Drain the native Lookup latency counters into ``self._lat``.

        The zero-Python read path (ps_shard.cc ServeLookup) stamps a
        sum/count pair instead of calling the Python recorder; folding
        the delta since the last poll (as its mean, via record_bulk)
        makes SchemeInfo's p99 — and with it RebalancePolicy's
        tail-pressure input — see native-served traffic too."""
        shard = self._shard
        if shard is None:
            return
        sum_us, count = shard.lookup_stats()
        seen_sum, seen_count = self._native_lat_seen
        dn = count - seen_count
        if dn <= 0:
            return
        self._native_lat_seen = (sum_us, count)
        self._lat.record_bulk(max(sum_us - seen_sum, 0) / dn / 1e6, dn)

    def _install_full(self, gen: int) -> None:
        """One wholesale table establishment landed — checkpoint
        restore, replication Sync, a propagated ReplicaApply install,
        or CompleteImport opening the import: publish it to the native
        read path.  Called under the table WRITE lock.  The device
        subclass hooks here to stage the fresh host image into HBM
        when this replica is the serving primary."""
        if self._shard is not None and not self._importing:
            self._shard.install(self.table, gen)

    def _on_promoted(self) -> None:
        """Subclass hook: runs once per Promote, after the replicator
        swap and before the migration re-drive / durable re-base.  The
        device tier stages its host mirror into HBM here (backups hold
        the cheap host mirror; HBM is paid only on promotion)."""

    def _replication_snapshot(self):
        """Consistent ``(epoch, gen, table bytes, applied windows)`` for
        a full-state Sync.  Epoch is read under ``_repl_mu`` (it is
        mutated there — Promote/fence adoption), THEN the table read
        lock pins (gen, table, windows) together: a concurrent promotion
        can no longer pair a stale epoch with a fresh table.  Lock order
        is repl_mu → shard → writer_seq everywhere."""
        with self._repl_mu:
            epoch = self._epoch
            with self._mu.read():
                with self._seq_mu:
                    windows = dict(self._writer_applied)
                return (epoch, self._install_gen, self.table.tobytes(),
                        windows)

    # -- durable checkpoint (brpc_tpu_torch.durable) ----------------------------

    def attach_checkpoint(self, store, *, recover: bool = True):
        """Attach a :class:`brpc_tpu_torch.durable.CheckpointStore`: from here
        on every applied generation is teed into its delta log under
        the table write lock, wholesale installs and promotions fold
        into fresh base snapshots, and replica reconnects go
        hydrate-first through its tail.

        With ``recover=True`` (the default) the store's on-disk state
        is restored FIRST — base installed, delta bodies replayed
        through the exact live-apply parse and arithmetic
        (``_unpack_apply`` + ``subtract.at`` with this server's ``lr``),
        writer windows merged — so the acked ledger continues bit for
        bit across a cold start.  Either way a fresh base is snapshotted
        before the tee arms: the delta chain always extends a base this
        process wrote.  Returns the ``durable.RestorePoint`` (or None
        when nothing was recovered)."""
        point = store.restore() if recover else None
        if point is not None:
            if point.table.shape != (self.rows_per, self.dim):
                raise ValueError(
                    f"checkpoint geometry {point.table.shape} does not "
                    f"match shard ({self.rows_per}, {self.dim})")
            with self._repl_mu:
                if point.epoch > self._epoch:
                    self._epoch = point.epoch
                if point.seeded:
                    self._seeded = True
                with self._mu.write():
                    self.table[:] = point.table
                    with self._seq_mu:
                        for w, q in point.windows.items():
                            if q > self._writer_seqs.get(w, 0):
                                self._writer_seqs[w] = q
                            if q > self._writer_applied.get(w, 0):
                                self._writer_applied[w] = q
                    for _gen, body in point.deltas:
                        windows, off = _unpack_windows(body)
                        ids, grads = _unpack_apply(
                            memoryview(body)[off:], self.base,
                            self.rows_per, self.dim)
                        if ids.size:
                            np.subtract.at(self.table, ids,
                                           self.lr * grads)
                        if windows:
                            with self._seq_mu:
                                for w, q in windows.items():
                                    if q > self._writer_seqs.get(w, 0):
                                        self._writer_seqs[w] = q
                                    if q > self._writer_applied.get(
                                            w, 0):
                                        self._writer_applied[w] = q
                    self._install_gen = point.gen
                    self._install_full(self._install_gen)
        epoch, gen, table, windows = self._replication_snapshot()
        store.save_snapshot(
            epoch, gen,
            np.frombuffer(table, np.float32).reshape(self.rows_per,
                                                     self.dim),
            windows, seeded=self._seeded or self._primary_flag)
        self._durable = store
        return point

    def _tee_delta(self, dur, gen: int, body: bytes) -> None:
        """Tee one applied generation into the checkpoint store.
        Called under the table WRITE lock, so log order is apply order.
        A refused append — generation jump the delta framing cannot
        express, or an epoch bump (promotion without install) the open
        base predates — or a compaction-due tail folds the current
        state into a fresh base instead."""
        if (not dur.append_delta(gen, body, epoch=self._epoch)
                or dur.should_compact()):
            self._snapshot_to(dur, gen)

    def _snapshot_to(self, dur, gen: int) -> None:
        """Fold the CURRENT table into a new base.  Must run under the
        table write lock — (gen, table, windows) are pinned; the epoch
        is a racy read and a concurrent Promote re-snapshots on its own
        once it lands."""
        with self._seq_mu:
            windows = dict(self._writer_applied)
        dur.save_snapshot(self._epoch, gen, self.table, windows,
                          seeded=self._seeded or self._primary_flag)

    def flush_replication(self, timeout_s: float = 5.0) -> None:
        """Blocks until every backup has ACKED everything applied so far
        (no-op for an unreplicated or backup server) — the zero-lost-
        updates half of the flush barrier."""
        rep = self._replicator
        if rep is None:
            return
        with self._mu.read():
            target = self._install_gen
        rep.flush(target, timeout_s)

    def _migration_snapshot(self, row0: int, count: int):
        """Consistent ``(gen, rows bytes, applied windows)`` for one
        destination's row-range handoff: the read lock pins the triple
        together (the PR-4/PR-6 generation-pinning discipline — the
        shipped rows are exactly the table at ``gen`` and the windows
        cover exactly the frames applied by then)."""
        lo = row0 - self.base
        if lo < 0 or row0 + count > self.base + self.rows_per:
            raise ValueError(
                f"migration range [{row0}, {row0 + count}) outside "
                f"shard [{self.base}, {self.base + self.rows_per})")
        with self._mu.read():
            with self._seq_mu:
                windows = dict(self._writer_applied)
            return (self._install_gen,
                    self.table[lo:lo + count].tobytes(), windows)

    def _apply_migrate_frame(self, src: str, gen: int,
                             body) -> Optional[int]:
        """One source-shard batch (filtered to this shard's range)
        during import: applied in arrival order, deduped by the
        per-source generation watermark (a resync replays from its
        sync point; anything at or below the watermark is already
        here).  Returns the watermark to ack, or ``None`` once the
        import has completed — late frames must break the stream, not
        mutate a live table.

        On a REPLICATED destination the batch propagates to this
        shard's backups (the same ``ReplicaApply`` framing, enqueued
        under the write lock = apply order) and the watermark is acked
        only once the ack barrier holds — a destination primary dying
        right after cutover can then promote a backup that already
        holds every migrated row."""
        windows, off = _unpack_windows(body)
        ids, grads = _unpack_apply(memoryview(body)[off:], self.base,
                                   self.rows_per, self.dim)
        rep = None
        new_gen = 0
        with self._mu.write():
            if not self._importing:
                return None
            last = self._import_gens.get(src, -1)
            if gen <= last:
                return last   # duplicate after resync: ack, don't apply
            if ids.size:
                np.subtract.at(self.table, ids, self.lr * grads)
                self._install_gen += 1
                new_gen = self._install_gen
                rep = self._replicator
                dur = self._durable
                if rep is not None or dur is not None:
                    gids = (ids + self.base).astype(np.int32)
                    rbody = _pack_windows(windows) + bytes(
                        _pack_apply_req(gids, grads))
                if rep is not None:
                    rep.ship(new_gen, rbody)
                if dur is not None:
                    self._tee_delta(dur, new_gen, rbody)
            self._import_gens[src] = gen
            if windows:
                with self._seq_mu:
                    for w, q in windows.items():
                        if q > self._writer_seqs.get(w, 0):
                            self._writer_seqs[w] = q
                        if q > self._writer_applied.get(w, 0):
                            self._writer_applied[w] = q
            if obs.enabled():
                obs.counter("ps_migrate_frames_in").add(1)
        if rep is not None:
            try:
                rep.flush(new_gen, timeout_s=self.repl_ack_timeout_s)
            except rpc.RpcError:
                # Backups did not confirm: the watermark must NOT ack
                # (the source's cutover flush would count rows safe
                # that only this process holds).  Breaking the stream
                # forces a wholesale resync, which converges.
                return None
        return gen

    @staticmethod
    def _parse_migration_spec(payload, what: str) -> dict:
        """Validate one MigrateStart/MigrateSpec JSON spec — hostile
        input like every control payload."""
        try:
            spec = json.loads(payload)
            targets = spec["targets"]
            int(spec["scheme"])
            if not isinstance(targets, list) or not all(
                    isinstance(t, dict)
                    and isinstance(t.get("addr"), str)
                    and int(t["base"]) >= 0 and int(t["rows"]) > 0
                    and isinstance(t.get("replicas", []), list)
                    and all(isinstance(a, str)
                            for a in t.get("replicas", []))
                    for t in targets):
                raise ValueError("bad targets")
        except (ValueError, KeyError, TypeError,
                RecursionError) as e:
            raise wire.WireError(
                f"malformed {what} spec: {e}") from e
        return spec

    def _install_migrator(self, spec: dict) -> None:
        """Install (or replace) the migration shipper described by
        ``spec`` and remember the spec — a later promotion of a backup
        re-drives from its replicated copy."""
        from brpc_tpu_torch import reshard  # lazy: reshard imports us
        with self._repl_mu:
            if self._scheme_fenced or self._importing:
                raise rpc.RpcError(
                    resilience.ESCHEMEMOVED,
                    f"shard {self.shard_index} cannot source a "
                    f"migration (fenced={self._scheme_fenced}, "
                    f"importing={self._importing})")
            old, self._migrator = self._migrator, None
        if old is not None:
            old.stop()
        shipper = reshard.MigrationShipper(
            self, spec["targets"], int(spec["scheme"]),
            timeout_ms=self.repl_timeout_ms)
        with self._repl_mu:
            self._migrator = shipper
            self._pending_migration = spec
        # Workers start only once the apply path sees the shipper:
        # every batch from here on either ships or predates the
        # workers' range snapshots — never neither.
        shipper.start()

    def _reserve_seq(self, writer: str, seq: int) -> bool:
        """True exactly once per (writer, seq): the server-side dedup
        window that makes reconnect replay idempotent.  Monotonic per
        writer — the stream is ordered, so a lower-or-equal seq can only
        be a replay of something already enqueued."""
        with self._seq_mu:
            if seq <= self._writer_seqs.get(writer, 0):
                return False
            self._writer_seqs[writer] = seq
            return True

    def _apply_replica_frame(self, epoch: int, gen: int,
                             body) -> Optional[int]:
        """One propagated batch from the primary: fence-checked,
        applied only when it is the NEXT generation (duplicates ack the
        current gen; a gap returns None so the receiver breaks the
        stream and forces a full resync).  Returns the gen to ack, or a
        NEGATIVE value (-epoch) when the sender is fenced — the
        receiver relays it as an explicit fence notification."""
        if epoch < self._epoch:
            if obs.enabled():
                obs.counter("ps_replica_fenced").add(1)
            return -self._epoch
        windows, off = _unpack_windows(body)
        ids, grads = _unpack_apply(memoryview(body)[off:], self.base,
                                   self.rows_per, self.dim)
        with self._mu.write():
            if gen <= self._install_gen:
                return self._install_gen   # duplicate: ack, don't apply
            if gen != self._install_gen + 1:
                if obs.enabled():
                    obs.counter("ps_replica_gaps").add(1)
                return None
            np.subtract.at(self.table, ids, self.lr * grads)
            self._install_gen = gen
            # An importing destination's backup defers its first
            # native snapshot to CompleteImport — the native read
            # path must never serve unmigrated rows.
            self._install_full(gen)
            if windows:
                # Inherit the primary's dedup window WITH the batch it
                # covers: on promotion, a replayed frame at or below
                # this mark dedups instead of double-applying.
                with self._seq_mu:
                    for w, q in windows.items():
                        if q > self._writer_seqs.get(w, 0):
                            self._writer_seqs[w] = q
                        if q > self._writer_applied.get(w, 0):
                            self._writer_applied[w] = q
            dur = self._durable
            if dur is not None:
                # A backup's checkpoint tees the propagated frames
                # verbatim: a promoted backup restarts with the same
                # durable ledger the primary had.
                self._tee_delta(dur, gen, bytes(body))
            return gen

    # -- request handling --------------------------------------------------

    @staticmethod
    def _payload_keys(method: str, payload: bytes) -> int:
        """Key count of one data-path request (0 for control traffic)."""
        if method in ("Lookup", "ApplyGrad"):
            return struct.unpack_from("<i", payload, 0)[0]
        if method == "ApplyGradId":
            body = _unpack_apply_id(payload)[3]
            return struct.unpack_from("<i", body, 0)[0]
        return 0

    def _handle(self, method: str, payload: bytes) -> bytes:
        try:
            # Deadline admission FIRST: expired queued work sheds here
            # (EDEADLINE), before any parse or table touch.
            payload, deadline_us = _admit_deadline(method, payload)
            if not obs.enabled():
                return self._serve(method, payload, deadline_us)
            t0 = time.monotonic_ns()
            rsp = self._serve(method, payload, deadline_us)
        except wire.WireError:
            _reject_frame(method)
            raise
        except rpc.RpcError as e:
            if e.code == resilience.EDEADLINE:
                # Per-SERVER shed mark: SchemeInfo reports it alongside
                # the limiter gate sheds as the rebalancer's
                # tail-pressure input.
                self._sheds.add(1)
            raise
        if method in self.LIMITED_METHODS:
            # Per-server data-plane latency — the SchemeInfo p99 the
            # rebalancer consumes (per server, unlike the process-wide
            # per-shard-index recorders above).
            self._lat.record((time.monotonic_ns() - t0) / 1e9)
        _record_ps_server(self.shard_index, method,
                          self._payload_keys(method, payload),
                          len(payload), len(rsp), t0)
        return rsp

    def _handle_stream(self, method: str, payload: bytes, accept) -> bytes:
        """Stream-capable trampoline target: ``StreamApply`` binds a
        client's push stream to this shard's combiner (primary only;
        a non-empty setup request is the writer id for the idempotent
        framed mode and answers with that writer's seq high-water mark);
        ``ReplicaApply`` binds the primary's delta stream to this
        backup's table; everything else is the plain :meth:`_handle`
        contract."""
        if method in ("StreamApply", "MigrateApply", "ReplicaApply"):
            try:
                return self._serve_stream_setup(method, payload, accept)
            except wire.WireError:
                _reject_frame(method)
                raise
        return self._handle(method, payload)

    def _serve_stream_setup(self, method: str, payload: bytes,
                            accept) -> bytes:
        if method == "StreamApply":
            if not self.stream:
                raise ValueError(f"unknown method {method}")
            self._check_primary()
            self._check_scheme()
            writer = payload.decode(errors="replace") if payload else ""
            recv = _ApplyStreamReceiver(self, writer)
            # The reply half carries the fence notification (a demotion
            # mid-stream must fail the client's flush, not silently
            # drop into a zombie's table).
            recv.reply = accept(recv)
            if writer:
                with self._seq_mu:
                    last = self._writer_seqs.get(writer, 0)
                return struct.pack("<q", last)
            return b""
        if method == "MigrateApply":
            # A migration source binds its delta stream to this
            # importing destination; the setup answers the per-source
            # watermark so a resync can skip already-covered frames.
            _scheme, alen = wire.read("<qi", payload, 0,
                                      "MigrateApply.setup")
            wire.need(payload, 12, alen, "MigrateApply.src")
            src = bytes(payload[12:12 + alen]).decode(errors="replace")
            with self._mu.read():
                if not self._importing:
                    raise rpc.RpcError(
                        resilience.ESCHEMEMOVED,
                        f"shard {self.shard_index} completed its "
                        f"import; late migration streams are refused")
                last = self._import_gens.get(src, -1)
            recv = _MigrateStreamReceiver(self, src)
            recv.reply = accept(recv)
            return struct.pack("<q", last)
        if method == "ReplicaApply":
            (epoch,) = wire.read("<q", payload, 0, "ReplicaApply.setup")
            self._check_repl_epoch(epoch)
            recv = _ReplicaStreamReceiver(self)
            recv.reply = accept(recv)
            # Schema replica_setup_rsp: the seeded flag is what lets a
            # gen-0 backup that holds the chain's exact gen-0 image
            # (Sync'd, or restored from a seeded base) hydrate the
            # delta tail instead of forcing another wholesale Sync.
            return struct.pack(
                "<qqq", self._epoch, self._install_gen,
                1 if (self._seeded or self._primary_flag) else 0)
        raise ValueError(f"unknown stream method {method}")

    def _apply_frame(self, payload, meta=None) -> None:
        """One streamed delta: parse/validate, enqueue without waiting
        (frames have no response; the close barrier flushes).  ``meta``
        is the frame's (writer, seq) tag — it rides the combiner into
        :meth:`_apply_batch` so the applied window propagates with the
        batch that covers it."""
        t0 = time.monotonic_ns() if obs.enabled() else 0
        ids, grads = _unpack_apply(payload, self.base, self.rows_per,
                                   self.dim)
        self._combiner.add(ids, grads, wait=False, meta=meta)
        if t0:
            _record_ps_server(self.shard_index, "StreamApply",
                              int(ids.size), len(payload), 0, t0)

    def _apply_batch(self, ids: np.ndarray, grads: np.ndarray,
                     metas=()) -> None:
        """ONE combined application for a drained batch: a single
        unbuffered ``subtract.at`` (duplicate ids sum exactly), a
        generation bump, under ``native_read`` a single snapshot
        install — and, on a replicated primary, ONE propagation frame
        shipped to every backup (enqueued under the write lock so
        backups see batches in exactly the apply order).  A DEMOTED
        replica refuses outright: applying here would land updates only
        the new primary's next Sync erases."""
        if not ids.size:
            return   # nothing applied: no generation, nothing to ship
        with self._repl_mu:
            if self._replica_set is not None and not self._primary_flag:
                raise rpc.RpcError(
                    resilience.ENOTPRIMARY,
                    f"shard {self.shard_index} replica "
                    f"{self._replica_index} was demoted (epoch "
                    f"{self._epoch}); refusing the apply")
        updates: Dict[str, int] = {}
        for m in metas:
            if m[1] > updates.get(m[0], 0):
                updates[m[0]] = m[1]
        with self._mu.write():
            # Re-checked INSIDE the write lock: SchemeFence reads its
            # final generation under this lock after setting the flag,
            # so an apply that raced the fence either finished (its gen
            # is covered by the cutover flush) or refuses here and the
            # caller re-routes — an acked-but-unmigrated write cannot
            # exist.
            if self._scheme_fenced:
                raise rpc.RpcError(
                    resilience.ESCHEMEMOVED,
                    f"shard {self.shard_index} scheme "
                    f"v{self.scheme_version} was fenced mid-apply; "
                    f"refusing the write")
            np.subtract.at(self.table, ids, self.lr * grads)
            self._install_gen += 1
            gen = self._install_gen
            if self._shard is not None:
                self._shard.install(self.table, gen)
            if updates:
                with self._seq_mu:
                    for w, q in updates.items():
                        if q > self._writer_applied.get(w, 0):
                            self._writer_applied[w] = q
            rep = self._replicator
            mig = self._migrator
            dur = self._durable
            if rep is not None or mig is not None or dur is not None:
                gids = (ids + self.base).astype(np.int32)
            if rep is not None or dur is not None:
                body = _pack_windows(updates) + bytes(
                    _pack_apply_req(gids, grads))
            if rep is not None:
                rep.ship(gen, body)
            if dur is not None:
                self._tee_delta(dur, gen, body)
            if mig is not None:
                # Live reshard: the successor scheme's shards subscribe
                # to this shard's applied batches (range-filtered by the
                # shipper) — enqueued under the write lock so the
                # destinations see batches in exactly the apply order.
                mig.ship(gen, gids, grads, updates)
        # Synchronous replication: the apply (and therefore the unary
        # response / combiner barrier riding it) completes only once
        # every CONNECTED backup acked this batch — a write acked to
        # the client can never be lost to a failover among synced
        # replicas.  Disconnected backups are skipped (their reconnect
        # starts with a full-table Sync, so nothing is lost, only
        # delayed); the wait happens OUTSIDE the write lock so reads
        # keep flowing.
        if rep is not None:
            rep.flush(gen, timeout_s=self.repl_ack_timeout_s)

    def _serve_apply_id(self, payload, deadline_us: int = 0) -> bytes:
        """Idempotent unary write (``ApplyGradId``): the per-(writer,
        shard) seq window drops a timed-out-but-APPLIED attempt's retry
        server-side (exactly-once against this shard), and a GUARD
        naming a superseded frame from a retired scheme drops a
        re-split delta whose content already migrated here with the
        old shard's rows.  Always answers the covering install gen."""
        self._check_primary()
        self._check_scheme()
        writer, seq, guards, body = _unpack_apply_id(payload)
        ids, grads = _unpack_apply(body, self.base, self.rows_per,
                                   self.dim)
        apply = True
        if guards:
            with self._seq_mu:
                covered = any(self._writer_applied.get(k, 0) >= q
                              for k, q in guards)
            if covered:
                apply = False
                if obs.enabled():
                    obs.counter("ps_scheme_guard_drops").add(1)
        if apply and not self._reserve_seq(writer, seq):
            # an earlier attempt of this exact request was admitted:
            # the retry is a replay, not a new write
            apply = False
            if obs.enabled():
                obs.counter("ps_unary_dedup_drops").add(1)
        if apply and ids.size:
            if self.combine:
                self._combiner.add(ids, grads, meta=(writer, seq),
                                   deadline_us=deadline_us)
            else:
                self._apply_batch(ids, grads, metas=[(writer, seq)])
        with self._mu.read():
            return struct.pack("<q", self._install_gen)

    def _serve_control(self, method: str, payload: bytes) -> bytes:
        """Replication control plane (unary, tiny, off the data path)."""
        if method == "ReplicaState":
            return json.dumps({
                "epoch": self._epoch, "gen": self._install_gen,
                "primary": self._primary_flag,
                "replica_index": self._replica_index,
                "addr": self.address,
            }).encode()
        if method == "Promote":
            (epoch,) = wire.read("<q", payload, 0, "Promote.epoch")
            with self._repl_mu:
                if epoch <= self._epoch:
                    raise rpc.RpcError(
                        resilience.EFENCED,
                        f"promote epoch {epoch} <= current "
                        f"{self._epoch}")
                self._epoch = epoch
                self._primary_flag = True
                # The promoted table is the chain from here on — it
                # stays provably chain-established across a later
                # demotion too.
                self._seeded = True
                # Reserved-but-never-applied seqs (enqueued on a
                # since-demoted run, failed with the demotion) must not
                # survive into the new reign's admission window — they
                # would dedup a replay whose data this table lacks.
                with self._seq_mu:
                    self._writer_seqs = dict(self._writer_applied)
                old, self._replicator = self._replicator, None
                peers = self._peers()
                if peers:
                    self._replicator = _Replicator(
                        self, peers, epoch=epoch,
                        timeout_ms=self.repl_timeout_ms,
                        quorum=self._quorum)
                pending = self._pending_migration
            if old is not None:
                old.stop(join=False)
            if obs.enabled():
                obs.counter("ps_replica_promotions").add(1)
            self._on_promoted()
            if pending is not None and not self._scheme_fenced \
                    and not self._importing:
                # Automatic re-drive: the dead primary carried an
                # in-flight migration whose spec was replicated here.
                # The fresh shipper resyncs every destination wholesale
                # from THIS table (byte-identical at its generation) and
                # resumes deltas — no manual MigrateStart; destinations
                # key their watermarks per source ADDRESS, so the new
                # source starts its own watermark and the old one goes
                # quiet.
                self._install_migrator(pending)
                if obs.enabled():
                    obs.counter("ps_migration_redrives").add(1)
            dur = self._durable
            if dur is not None:
                # Make the new reign durable: an epoch-only change has
                # no delta record, so fold it into a fresh base.  This
                # also re-bases the store, which pushes any peer with a
                # possibly-divergent history out of the hydrate window.
                e2, g2, tbl, w2 = self._replication_snapshot()
                dur.save_snapshot(
                    e2, g2,
                    np.frombuffer(tbl, np.float32).reshape(
                        self.rows_per, self.dim), w2, seeded=True)
            return struct.pack("<qq", self._epoch, self._install_gen)
        if method == "Sync":
            epoch, gen, count = wire.read("<qqq", payload, 0, "Sync.hdr")
            self._check_repl_epoch(epoch)
            if count != self.rows_per * self.dim:
                raise ValueError(
                    f"sync size {count} != shard table "
                    f"{self.rows_per * self.dim}")
            wire.need(payload, 24, count * 4, "Sync.table")
            table = np.frombuffer(payload, np.float32, count,
                                  24).reshape(self.rows_per, self.dim)
            tbl_end = 24 + count * 4
            windows = _unpack_windows(payload, tbl_end)[0] \
                if len(payload) > tbl_end else {}
            with self._repl_mu:
                # Re-verify under the epoch's own lock: a Promote that
                # slipped in between the fence check and this install
                # must not let a now-stale Sync overwrite the new
                # primary's table.
                if epoch < self._epoch or self._primary_flag:
                    raise rpc.RpcError(
                        resilience.EFENCED,
                        f"stale sync epoch {epoch} (current "
                        f"{self._epoch}, primary={self._primary_flag})")
                with self._mu.write():
                    self.table[:] = table
                    self._install_gen = gen
                    # A wholesale Sync IS chain establishment: even at
                    # gen 0 this table is now provably the chain's
                    # image, so later hydrates may trust it.
                    self._seeded = True
                    self._install_full(gen)
                    # Full-state handoff: the received (table, gen,
                    # windows) triple is authoritative — local window
                    # history refers to a table this install replaces.
                    with self._seq_mu:
                        self._writer_seqs = dict(windows)
                        self._writer_applied = dict(windows)
                    dur = self._durable
                    if dur is not None:
                        # A wholesale install jumps the generation — the
                        # delta framing cannot express it, so re-base.
                        self._snapshot_to(dur, gen)
            return b""
        if method == "WriterSeq":
            # Applied high-water for one writer + current gen: the
            # client's flush barrier verifies against the PRIMARY's
            # applied window (a zombie answers ENOTPRIMARY and the
            # client re-resolves).
            self._check_primary()
            writer = payload.decode(errors="replace")
            with self._seq_mu:
                applied = self._writer_applied.get(writer, 0)
            with self._mu.read():
                gen = self._install_gen
            return struct.pack("<qq", applied, gen)
        if method == "Flush":
            if self._combiner is not None:
                self._combiner.flush()
            self.flush_replication()
            return struct.pack("<q", self._install_gen)
        if method == "SchemeInfo":
            with self._mu.read():
                gen = self._install_gen
            self._fold_native_latency()
            shed = int(self._sheds.get_value())
            lim = self.limiter
            if lim is not None:
                shed += sum(int(g.get("shed", 0))
                            for g in lim.snapshot().values())
            return json.dumps({
                "scheme": self.scheme_version,
                "importing": self._importing,
                "fenced": self._scheme_fenced,
                "next_scheme": self._next_scheme,
                "gen": gen,
                "reads": self._reads(),
                "primary": self._primary_flag,
                "epoch": self._epoch,
                "addr": self.address,
                "table_bytes": self.rows_per * self.dim * 4,
                # Tail-pressure inputs (RebalancePolicy): data-plane
                # handler p99 on THIS server and its cumulative shed
                # count (deadline admission + limiter gates).
                "p99_us": self._lat.percentile(0.99),
                "shed": shed,
            }).encode()
        if method == "MigrateStart":
            # Begin streaming this shard's rows to the successor
            # scheme's shards: one shipper per overlapping destination
            # (range-filtered Sync at a pinned generation, then every
            # applied batch).  Idempotent — a re-issued start replaces
            # the shipper and the destinations resync wholesale.
            self._check_primary()
            spec = self._parse_migration_spec(payload, "MigrateStart")
            self._install_migrator(spec)
            with self._mu.read():
                return struct.pack("<q", self._install_gen)
        if method == "MigrateSpec":
            # The re-drive half of fault-tolerant migration: a source
            # BACKUP stores the in-flight migration's spec; if it is
            # later promoted (the source primary died mid-copy), the
            # Promote handler re-installs the shipper from it — no
            # manual MigrateStart.  The driver distributes this to
            # every non-primary source replica at start().
            spec = self._parse_migration_spec(payload, "MigrateSpec")
            with self._repl_mu:
                self._pending_migration = spec
            return b""
        if method == "MigrateState":
            mig = self._migrator
            with self._mu.read():
                gen = self._install_gen
            return json.dumps({
                "gen": gen, "active": mig is not None,
                "fenced": self._scheme_fenced,
                "targets": mig.state() if mig is not None else {},
            }).encode()
        if method == "MigrateStop":
            # Abort path: stop shipping, forget the successor AND the
            # replicated spec (a later promotion must not re-drive an
            # aborted migration).  The destinations stay importing
            # (their owner closes them).
            with self._repl_mu:
                mig, self._migrator = self._migrator, None
                self._pending_migration = None
            if mig is not None:
                # join the workers BEFORE the channel set closes — an
                # aborted migration must leave no native handle behind
                mig.stop()
            return b""
        if method == "SchemeFence":
            # The CUTOVER write fence: no new writes are admitted under
            # the retiring scheme (they answer ESCHEMEMOVED and the
            # client refreshes its routing), already-admitted writes
            # drain, and the final migration flush waits until every
            # destination acked the final generation — after this
            # returns, the successor shards hold every acked update.
            (ver,) = wire.read("<q", payload, 0, "SchemeFence.ver")
            with self._repl_mu:
                if self._importing:
                    raise rpc.RpcError(
                        resilience.EMIGRATING,
                        f"shard {self.shard_index} is importing; an "
                        f"importing destination cannot be fenced")
                was_fenced = self._scheme_fenced
                prev_next = self._next_scheme
                self._scheme_fenced = True
                self._next_scheme = int(ver)
            try:
                if self._combiner is not None:
                    # Drain what was admitted before the flag: entries
                    # that lost the race bounce with ESCHEMEMOVED
                    # (their callers re-route with guards) — expected,
                    # not a fence failure.
                    try:
                        self._combiner.flush()
                    except rpc.RpcError as e:
                        if e.code != resilience.ESCHEMEMOVED:
                            raise
                self.flush_replication()
                mig = self._migrator
                # The WRITE lock is the fence barrier: any apply that
                # passed the admission check before the flag has either
                # bumped the generation (covered by the flush below) or
                # will refuse inside the lock after we release it.
                with self._mu.write():
                    gen = self._install_gen
                if mig is not None:
                    mig.flush(gen, timeout_s=self.repl_ack_timeout_s)
            except BaseException:
                # A fence that cannot PROVE the handoff must not stick:
                # with no successor ever published, a stuck flag would
                # refuse every write forever while no scheme owns the
                # range.  Roll back (unless a previous fence already
                # completed — a failed re-issue must not unfence a
                # cut-over shard) and let the driver retry or abort.
                if not was_fenced:
                    with self._repl_mu:
                        self._scheme_fenced = False
                        self._next_scheme = prev_next
                raise
            if obs.enabled():
                obs.counter("ps_scheme_fences").add(1)
            with self._repl_mu:
                # cutover complete for this source: a later promotion
                # must not re-drive the finished migration
                self._pending_migration = None
            return struct.pack("<q", gen)
        if method == "SchemeUnfence":
            # Abort-path rollback (MigrationDriver.abort): a cutover
            # that fenced SOME sources and then failed leaves them
            # refusing writes with no successor ever published; this
            # control readmits writes under the retiring scheme.  Must
            # not be issued after a COMPLETED cutover (the destinations
            # are open and own the ranges).
            with self._repl_mu:
                self._scheme_fenced = False
                self._next_scheme = None
            if obs.enabled():
                obs.counter("ps_scheme_unfences").add(1)
            return b""
        if method == "MigrateSync":
            # Range handoff: install the source's rows for (a slice of)
            # this shard's range wholesale, at the source's pinned
            # generation, windows included — the import-side mirror of
            # the replication Sync.
            scheme, src_gen, row0, count, alen = wire.read(
                "<qqqqi", payload, 0, "MigrateSync.hdr")
            wire.need(payload, 36, alen, "MigrateSync.src")
            src = bytes(payload[36:36 + alen]).decode(errors="replace")
            off = 36 + alen
            wire.check_count(count, self.rows_per, "MigrateSync.count")
            lo = row0 - self.base
            if lo < 0 or row0 + count > self.base + self.rows_per:
                raise ValueError(
                    f"sync range [{row0}, {row0 + count}) outside "
                    f"shard [{self.base}, {self.base + self.rows_per})")
            wire.need(payload, off, count * self.dim * 4,
                      "MigrateSync.rows")
            rows = np.frombuffer(payload, np.float32, count * self.dim,
                                 off).reshape(count, self.dim)
            windows = _unpack_windows(
                payload, off + count * self.dim * 4)[0]
            rep = None
            with self._mu.write():
                if not self._importing:
                    raise rpc.RpcError(
                        resilience.ESCHEMEMOVED,
                        f"shard {self.shard_index} completed its "
                        f"import; a late source sync must not "
                        f"overwrite a live table")
                self.table[lo:lo + count] = rows
                self._import_gens[src] = src_gen
                self._install_gen += 1
                sync_gen = self._install_gen
                rep = self._replicator
                if windows:
                    with self._seq_mu:
                        for w, q in windows.items():
                            if q > self._writer_seqs.get(w, 0):
                                self._writer_seqs[w] = q
                            if q > self._writer_applied.get(w, 0):
                                self._writer_applied[w] = q
                dur = self._durable
                if dur is not None:
                    # The range overwrite jumped the generation: re-base
                    # the checkpoint (which also pushes this shard's
                    # backups out of the hydrate window — they really do
                    # need the wholesale resync below).
                    self._snapshot_to(dur, sync_gen)
            if rep is not None:
                # A wholesale range overwrite is inexpressible in the
                # delta framing: force this destination's backups
                # through a full-table Sync and hold the source's
                # response until the ack barrier covers it — the Sync
                # response IS the source's ack that this slice is safe.
                rep.resync_peers()
                rep.flush(sync_gen, timeout_s=self.repl_ack_timeout_s)
            if obs.enabled():
                obs.counter("ps_migrate_syncs").add(1)
            return b""
        if method == "CompleteImport":
            # The import is byte-complete (every source fenced and
            # flushed): open for business.  Publishes the first native
            # snapshot — until here the native read path answered
            # errors, never unmigrated rows.
            with self._repl_mu:
                backup = (self._replica_set is not None
                          and not self._primary_flag)
                with self._mu.write():
                    was = self._importing
                    if was and backup and self._install_gen == 0:
                        # A destination backup that never received its
                        # primary's Sync holds seed garbage — opening
                        # it would serve unmigrated rows.  Stay
                        # importing; the reconnect Sync brings the data
                        # and the driver's retry opens it then.
                        raise rpc.RpcError(
                            resilience.EMIGRATING,
                            f"shard {self.shard_index} backup has no "
                            f"replicated state yet; refusing to open "
                            f"an empty import")
                    self._importing = False
                    gen = self._install_gen
                    if was:
                        self._install_full(gen)
                rep = self._replicator
            if was and rep is not None:
                # Open the backups too: force a fresh full-table Sync
                # (one may have lagged the import propagation) and
                # clear their import flags — a destination backup that
                # missed the driver's open would otherwise answer
                # EMIGRATING until restarted.  The unary fan-out runs
                # on its OWN thread: a native call from inside this
                # fiber-served handler would park the fiber and resume
                # it on another pthread (the PyGILState crash) — the
                # same rule that keeps replicator/shipper traffic on
                # dedicated threads.
                rep.resync_peers()
                peers = self._peers()
                timeout_ms = self.repl_timeout_ms
                ack_s = self.repl_ack_timeout_s

                def _open_backups() -> None:
                    try:
                        rep.flush(gen, timeout_s=ack_s)
                    except rpc.RpcError:
                        pass   # a dead backup stays importing; reads
                        #        route around it (replica-level miss)
                    for a in peers:
                        ch = rpc.Channel(a, timeout_ms=timeout_ms)
                        try:
                            ch.call("Ps", "CompleteImport", b"",
                                    timeout_ms=timeout_ms)
                        except rpc.RpcError:
                            if obs.enabled():
                                obs.counter(
                                    "ps_import_open_errors").add(1)
                        finally:
                            ch.close()

                threading.Thread(target=_open_backups, daemon=True,
                                 name="brt-import-open").start()
            if obs.enabled() and was:
                obs.counter("ps_imports_completed").add(1)
            return struct.pack("<q", gen)
        raise ValueError(f"unknown method {method}")

    def _serve(self, method: str, payload: bytes,
               deadline_us: int = 0) -> bytes:
        if method in ("ReplicaState", "Promote", "Sync", "WriterSeq",
                      "Flush", "SchemeInfo", "MigrateStart",
                      "MigrateSpec", "MigrateState", "MigrateStop",
                      "SchemeFence", "SchemeUnfence", "MigrateSync",
                      "CompleteImport"):
            return self._serve_control(method, payload)
        if method == "ApplyGradId":
            return self._serve_apply_id(payload, deadline_us)
        if method not in ("Lookup", "ApplyGrad"):
            raise ValueError(f"unknown method {method}")
        # Guarded header (wire schemas lookup_req/apply_req): a negative
        # count would make frombuffer re-interpret the whole payload; an
        # oversized one must reject cleanly, and Lookup mirrors the
        # native handler's EXACT-length contract (ps_shard.cc).
        (count,) = wire.read("<i", payload, 0, f"{method}.count")
        wire.check_count(count, (len(payload) - 4) // 4,
                         f"{method}.count")
        if method == "Lookup" and len(payload) != 4 + 4 * count:
            raise wire.WireError(
                f"Lookup request length mismatch (count={count}, "
                f"{len(payload)} bytes)")
        if method == "ApplyGrad":
            wire.need(payload, 4 + 4 * count, count * self.dim * 4,
                      "ApplyGrad.grads")
        ids = np.frombuffer(payload, np.int32, count, 4) - self.base
        if ids.size and (ids.min() < 0 or ids.max() >= self.rows_per):
            # Out-of-range ids would wrap to wrong rows via negative indexing.
            raise ValueError(
                f"ids outside shard [{self.base}, "
                f"{self.base + self.rows_per}) for shard base {self.base}"
            )
        if method == "Lookup":
            if self._importing:
                # The range is still streaming in: answer a scheme-aware
                # miss so the client falls back to the source scheme.
                self._check_scheme()
            with self._seq_mu:
                self._read_count += 1
            with self._mu.read():
                gathered = self.table[ids]
            # The gather above is the ONE unavoidable copy (fancy
            # indexing materializes the rows); zero-copy mode responds
            # with the gathered array pinned as a borrowed block instead
            # of paying tobytes + the respond append on top of it.
            if zerocopy_enabled() and gathered.nbytes >= _ZC_MIN_BYTES:
                out = rpc.IOBuf()
                out.append_pinned(gathered)
                return out
            return gathered.tobytes()
        if method == "ApplyGrad":
            # Writes belong to the primary: a demoted/backup replica
            # rejects so the client re-resolves and fails over.  A
            # cutover-fenced or importing shard redirects instead.
            self._check_primary()
            self._check_scheme()
            grads = np.frombuffer(payload, np.float32,
                                  count * self.dim, 4 + 4 * count)
            if self.combine:
                # Combined write path: enqueue and wait for the batch —
                # the combiner's leader applies once per drained batch.
                self._combiner.add(ids,
                                   grads.reshape(count, self.dim),
                                   deadline_us=deadline_us)
            else:
                self._apply_batch(ids, grads.reshape(count, self.dim))
            if self._replica_set is not None:
                # Replicated: answer the gen this write is covered by
                # (>= the batch it landed in).  The client records it as
                # its acked floor — failover refuses any candidate whose
                # gen is behind it, so "acked then lost" becomes "acked
                # or loudly refused".
                with self._mu.read():
                    return struct.pack("<q", self._install_gen)
            return b""
        raise ValueError(f"unknown method {method}")

    @property
    def native_lookups(self) -> int:
        """Lookups served with zero Python in the loop (0 unless
        ``native_read``)."""
        return 0 if self._shard is None else self._shard.native_lookups

    def close(self):
        # Replicator first (stop shipping; its streams point at OTHER
        # servers).  Then the server: its native Lookup handlers gather
        # from the shard's snapshots and must drain before the shard
        # dies.  Then the combiner: a dying stream's receiver teardown
        # can still flush into it after Join (its delivery queue outlives
        # the connection), and an applying drain must not race shard
        # death.
        with self._repl_mu:
            rep, self._replicator = self._replicator, None
            mig, self._migrator = self._migrator, None
        if rep is not None:
            rep.stop()
        if mig is not None:
            mig.stop()
        self.server.close()
        if self._combiner is not None:
            self._combiner.shutdown()
        if self._shard is not None:
            self._shard.close()
            self._shard = None
        for name in self._gauge_names:
            obs.drop_var(name)
        self._gauge_names = ()
        for name in self._sig_names:
            obs.drop_var(name)
        self._sig_names = ()


class _TableGen:
    """One generation of the device-resident table: the buffer handle plus
    the pins keeping it alive.  A retired generation's handle is released
    when the last pin drops (never while a Lookup gathers from it)."""

    __slots__ = ("handle", "pins", "retired")

    def __init__(self, handle: int):
        self.handle = handle
        self.pins = 0
        self.retired = False


class DevicePsShardServer(PsShardServer):
    """Embedding shard whose SERVING table is RESIDENT IN DEVICE HBM —
    and a first-class citizen of the CPU tier's
    replication / migration / rebalance machinery: it subclasses
    :class:`PsShardServer` and reuses its wire contracts verbatim
    (``ReplicaApply`` framing, ``Promote``/``EFENCED`` fencing, the
    ``MigrateSync``/``MigrateApply`` handoff, the ``CheckpointStore``
    delta tee), so ``configure_replication(quorum=)``, failover,
    live splits and cold-restart replay all behave identically on the
    device tier.

    The table keeps living behind a native device-buffer handle (the
    RDMA-lkey analog, cpp/device/pjrt_device.h); Lookup/ApplyGrad are
    compiled gather / scatter-sub launches (cpp/device/
    pjrt_executable.cc).  Request ids and gradients DMA host->HBM
    through the registered block pool; looked-up rows DMA back into
    pooled blocks.  No JAX anywhere in the serving path — this is the
    reference's "transport swap is invisible above Socket" contract
    with PJRT as the transport (docs/en/rdma.md:34 analog).

    **Two serving modes.**  A PRIMARY that is open for business serves
    from HBM (``_dev_serving``): updates are functional on-device
    (scatter-sub emits a fresh table buffer), so the tiny
    ``ps.device_shard`` leaf lock guards only the pin map; Lookup pins
    the current buffer, gathers/fetches OUTSIDE the locks, unpins.
    Everyone else — backups, importing split destinations, demoted
    ex-primaries — runs the inherited CPU paths against the cheap HOST
    MIRROR (``_host_table``): ReplicaApply deltas, Sync installs,
    MigrateSync range writes and checkpoint replay all mutate it in
    place exactly as on the CPU tier.  Mode flips happen under the
    table write lock: promotion (and CompleteImport on a primary)
    stages the mirror into HBM (``_on_promoted`` /
    ``_install_full``); demotion and fence adoption DMA the live
    table down into the mirror first (``_mirror_down``) so nothing
    applied on-device is lost.

    **Replication off the write path**: the serving ``_apply_batch``
    launches the scatter outside the table lock against a pinned
    buffer, then — under the write lock, exactly like the CPU tier —
    installs the new handle and tees ONE ``replica_apply_body`` frame
    (ids + grads + writer windows, NOT the table) to the replicator,
    the checkpoint delta log and any migration shipper, so backups and
    the durable ledger see device batches in apply order.  Snapshot
    reads (Sync wholesale, MigrateSync range handoffs, checkpoint
    re-bases) pin one generation under the lock and DMA it down
    OUTSIDE the lock — no blocking ``brt_device_*`` call ever runs
    under a checked lock (RACECHECK-clean by construction).

    The optimistic install keeps its pre-parity cost model under write
    FAN-IN: k racing writers scatter k candidate tables but only one
    installs — the rest discard and redo (``ps_device_wasted_launches``
    counts them).  ``combine=True`` routes ApplyGrad through the
    inherited :class:`GradCombiner` so the leader launches ONE scatter
    per drained batch; ``stream=True`` serves ``StreamApply`` into the
    same combiner.
    """

    def __init__(self, vocab: int, dim: int, shard_index: int,
                 num_shards: int, lr: float = 0.1, seed: int = 0,
                 device_client: "rpc.DeviceClient | None" = None,
                 device_index: int = 0, combine: bool = False,
                 stream: bool = False, importing: bool = False,
                 scheme_version: int = 0, limiter=None):
        self._owns_dev = device_client is None
        self.dev = device_client or rpc.DeviceClient()
        self.device_index = device_index
        # Device state must exist before the base constructor runs: it
        # assigns ``self.table`` (routed through the property setter
        # into the host mirror) and starts the server — early requests
        # simply serve from the mirror until the stage-up below.
        self._dev_mu = checked_lock("ps.device_shard")
        self._dev_serving = False
        self._dev_cur: Optional[int] = None
        self._dev_seq = 0
        self._tables: Dict[int, _TableGen] = {}
        self._host_table: Optional[np.ndarray] = None
        self._rebase_pending = False
        self._gather = {}   # bucket size -> compiled gather executable
        self._scatter = {}  # bucket size -> compiled scatter-sub exe
        # Guards the executable caches; held across the (cold,
        # per-bucket) compile but never across execute/fetch.
        self._exe_mu = checked_lock("ps.device_shard.exe")
        self.lr_h = 0
        super().__init__(vocab, dim, shard_index, num_shards, lr=lr,
                         seed=seed, lock_mode="rw", native_read=False,
                         combine=combine, stream=stream,
                         importing=importing,
                         scheme_version=scheme_version,
                         limiter=limiter)
        # Resident lr scalar: scatter_sub's 4th operand (stays in HBM).
        self.lr_h = self.dev.stage(np.array(lr, np.float32),
                                   device_index)
        if not self._importing:
            # Open for business from HBM immediately (a server starts
            # in the legacy single-owner primary mode); an importing
            # split destination stays on the host mirror until
            # CompleteImport opens it.
            with self._mu.write():
                self._stage_up_locked()

    # -- pin map / serving-mode machinery ---------------------------------

    def _pin_current(self):
        """Pin the live device table: ``(key, handle)`` with the handle
        guaranteed alive until the matching :meth:`_unpin`, or None
        when the shard is not serving from HBM.  Pin under the table
        read (or write) lock whenever the pinned buffer must
        correspond to ``_install_gen`` — installs hold the write lock,
        so the pair is consistent there."""
        with self._dev_mu:
            key = self._dev_cur
            if key is None:
                return None
            entry = self._tables[key]
            entry.pins += 1
            return key, entry.handle

    def _unpin(self, key: int) -> None:
        release = 0
        with self._dev_mu:
            entry = self._tables[key]
            entry.pins -= 1
            if entry.retired and entry.pins == 0:
                del self._tables[key]
                release = entry.handle
        if release:
            self.dev.release(release)

    def _stage_up_locked(self) -> None:
        """Stage the host mirror into HBM and serve from it.  Caller
        holds the table WRITE lock.  Already serving: the fresh host
        image replaces the resident table (a wholesale install landed
        while staged, e.g. a re-issued checkpoint restore)."""
        handle = self.dev.stage(self._host_table, self.device_index)
        if self._dev_serving:
            self._swap_dev_locked(handle)
            return
        with self._dev_mu:
            self._dev_seq += 1
            self._dev_cur = self._dev_seq
            self._tables[self._dev_cur] = _TableGen(handle)
        self._dev_serving = True

    def _swap_dev_locked(self, handle: int) -> None:
        """Install a fresh table buffer as the current generation.
        Caller holds the table WRITE lock; the retiring buffer is
        released once its last pin drops."""
        release = 0
        with self._dev_mu:
            old = self._tables[self._dev_cur]
            old.retired = True
            if old.pins == 0:
                del self._tables[self._dev_cur]
                release = old.handle
            self._dev_seq += 1
            self._dev_cur = self._dev_seq
            self._tables[self._dev_cur] = _TableGen(handle)
        if release:
            self.dev.release(release)

    def _retire_dev_locked(self) -> None:
        """Retire every device generation (mirror-down / close).
        Caller holds the table write lock; pinned entries release when
        their last pin drops."""
        release = []
        with self._dev_mu:
            self._dev_cur = None
            for k in list(self._tables):
                entry = self._tables[k]
                entry.retired = True
                if entry.pins == 0:
                    del self._tables[k]
                    release.append(entry.handle)
        for h in release:
            self.dev.release(h)

    def _mirror_down(self) -> None:
        """Leave HBM-serving mode: DMA the live table into the host
        mirror and retire every device generation, so the inherited
        CPU paths (Sync installs, ReplicaApply deltas, checkpoint
        replay) mutate a live array again.  The fetch runs OUTSIDE the
        lock against a pinned buffer; an install racing the fetch
        restarts it — the loop terminates because callers mirror down
        exactly when writes are stopping (demotion, fence adoption, a
        checkpoint attach serializing with appliers)."""
        while True:
            with self._mu.write():
                if not self._dev_serving:
                    return
                pinned = self._pin_current()
            key, table_h = pinned
            raw = None
            try:
                raw = self.dev.fetch(table_h)
            finally:
                if raw is None:
                    self._unpin(key)
            with self._mu.write():
                if not self._dev_serving:
                    self._unpin(key)
                    return
                with self._dev_mu:
                    moved = self._dev_cur != key
                if moved:
                    self._unpin(key)
                    continue
                self._host_table[:] = np.frombuffer(
                    raw, np.float32).reshape(self.rows_per, self.dim)
                self._dev_serving = False
                self._retire_dev_locked()
            self._unpin(key)
            if obs.enabled():
                obs.counter("ps_device_mirror_downs").add(1)
            return

    @property
    def table(self) -> np.ndarray:
        """Host view of the table.  In host-mirror mode (backup /
        importing / demoted) this IS the live mutable array — the base
        class applies into it in place under the write lock.  In
        HBM-serving mode it is a pinned DMA snapshot COPY (test/debug
        use; never called on a locked path while serving)."""
        if not self._dev_serving:
            return self._host_table
        pinned = self._pin_current()
        if pinned is None:
            return self._host_table
        key, table_h = pinned
        try:
            raw = self.dev.fetch(table_h)
        finally:
            self._unpin(key)
        return np.frombuffer(raw, np.float32).reshape(self.rows_per,
                                                      self.dim).copy()

    @table.setter
    def table(self, value: np.ndarray) -> None:
        self._host_table = value

    def _gather_exe(self, k: int):
        with self._exe_mu:
            exe = self._gather.get(k)
            if exe is None:
                mlir = self.dev.mlir("gather_rows", self.rows_per,
                                     self.dim, k)
                exe = self._gather[k] = self.dev.compile(mlir)
            return exe

    def _scatter_exe(self, k: int):
        with self._exe_mu:
            exe = self._scatter.get(k)
            if exe is None:
                mlir = self.dev.mlir("scatter_sub", self.rows_per,
                                     self.dim, k)
                exe = self._scatter[k] = self.dev.compile(mlir)
            return exe

    @staticmethod
    def _bucket(count: int) -> int:
        """Round the batch size up to a power of two so the executable
        cache stays log-bounded instead of compiling per distinct count
        (padding: extra ids hit row 0 with zero gradients — a no-op)."""
        return 1 << max(0, count - 1).bit_length()

    # -- replication / migration / durability parity ----------------------

    def _install_full(self, gen: int) -> None:
        """A wholesale host-image install landed (under the write
        lock).  On the device tier 'publish' means stage the fresh
        host mirror into HBM — but only for a PRIMARY that is open for
        business; backups and importing split destinations keep the
        cheap host mirror (promotion / CompleteImport stages later)."""
        super()._install_full(gen)
        if self._primary_flag and not self._importing:
            self._stage_up_locked()

    def _on_promoted(self) -> None:
        """Promotion point: the backup's host mirror (hydrated by the
        ReplicaApply stream) becomes the serving table — stage it into
        HBM before the promote response releases clients to retry."""
        staged = False
        with self._mu.write():
            if not self._dev_serving and not self._importing:
                self._stage_up_locked()
                staged = True
        if staged and obs.enabled():
            obs.counter("ps_device_promote_stages").add(1)

    def configure_replication(self, replica_set: ReplicaSet,
                              replica_index: int, *,
                              timeout_ms: Optional[int] = None,
                              ack_timeout_s: Optional[float] = None,
                              quorum: "int | str | None" = "auto"
                              ) -> None:
        super().configure_replication(replica_set, replica_index,
                                      timeout_ms=timeout_ms,
                                      ack_timeout_s=ack_timeout_s,
                                      quorum=quorum)
        if not self._primary_flag:
            # Demoted to backup: fold the live HBM table into the host
            # mirror so the inherited Sync/ReplicaApply paths mutate a
            # live array.
            self._mirror_down()

    def _check_repl_epoch(self, epoch: int) -> None:
        super()._check_repl_epoch(epoch)
        if not self._primary_flag:
            # Adopted a newer epoch (self-demotion): same fold as an
            # explicit demotion.  Runs lock-free, exactly like the
            # base's demote.stop() at this point.
            self._mirror_down()

    def _demote_on_fence(self) -> None:
        super()._demote_on_fence()
        if not self._primary_flag:
            self._mirror_down()

    def attach_checkpoint(self, store, *, recover: bool = True):
        """Attach the checkpoint store, device edition: restore/replay
        mutate the host image in place, so leave HBM-serving mode for
        the duration (the mirror-down folds the live table into the
        host mirror first — nothing applied before the attach is
        lost).  The restore's install hook re-stages a primary; a
        shard with nothing to recover re-stages here."""
        self._mirror_down()
        point = super().attach_checkpoint(store, recover=recover)
        with self._repl_mu:
            with self._mu.write():
                if (not self._dev_serving and not self._importing
                        and self._primary_flag):
                    self._stage_up_locked()
        return point

    def _tee_delta(self, dur, gen: int, body: bytes) -> None:
        if not self._dev_serving:
            return super()._tee_delta(dur, gen, body)
        if (not dur.append_delta(gen, body, epoch=self._epoch)
                or dur.should_compact()):
            # The base helper folds the table into a fresh base HERE,
            # under the write lock — but this table is in HBM and the
            # DMA must not run under a checked lock.  Defer: the
            # applier re-bases outside the lock before acking.
            self._rebase_pending = True

    def _maybe_device_rebase(self) -> None:
        """Perform a deferred checkpoint re-base (set by the serving
        tee): capture (epoch, gen, windows) + a pin under the write
        lock, DMA the table down outside it, write the base.
        Concurrent appliers may interleave re-bases out of order; the
        store converges — restore picks the NEWEST valid base and the
        chain check skips deltas already folded in — and every acked
        batch runs this before its ack, so the durable image always
        covers the acked generation."""
        dur = self._durable
        if dur is None or not self._rebase_pending:
            return
        with self._mu.write():
            if not self._rebase_pending:
                return
            self._rebase_pending = False
            if not self._dev_serving:
                self._snapshot_to(dur, self._install_gen)
                return
            epoch = self._epoch
            gen = self._install_gen
            with self._seq_mu:
                windows = dict(self._writer_applied)
            key, table_h = self._pin_current()
        try:
            raw = self.dev.fetch(table_h)
        finally:
            self._unpin(key)
        dur.save_snapshot(
            epoch, gen,
            np.frombuffer(raw, np.float32).reshape(self.rows_per,
                                                   self.dim),
            windows, seeded=self._seeded or self._primary_flag)

    def _replication_snapshot(self):
        """Device-aware Sync snapshot: (epoch, gen, table bytes,
        windows), consistent because installs hold the table write
        lock.  In HBM-serving mode the generation is pinned under the
        locks and FETCHED OUTSIDE them (a blocking DMA under a checked
        lock is a RACECHECK violation) — safe because a pinned
        buffer is immutable (updates are functional) and the pin keeps
        it alive across the fetch."""
        with self._repl_mu:
            epoch = self._epoch
            with self._mu.read():
                with self._seq_mu:
                    windows = dict(self._writer_applied)
                gen = self._install_gen
                if not self._dev_serving:
                    return (epoch, gen, self._host_table.tobytes(),
                            windows)
                key, table_h = self._pin_current()
        try:
            raw = self.dev.fetch(table_h)
        finally:
            self._unpin(key)
        return (epoch, gen, bytes(raw), windows)

    def _migration_snapshot(self, row0: int, count: int):
        """Generation-pinned MigrateSync source read: pin one table
        generation under the read lock, DMA it down outside the lock,
        slice the requested range host-side.  Fetching the WHOLE table
        per range sync is an honest cost (no range-gather launch yet —
        see ROADMAP residue); correctness matches the CPU tier: the
        (gen, rows, windows) triple is consistent because installs
        hold the write lock."""
        lo = row0 - self.base
        if lo < 0 or row0 + count > self.base + self.rows_per:
            raise ValueError(
                f"migration range [{row0}, {row0 + count}) outside "
                f"shard [{self.base}, {self.base + self.rows_per})")
        with self._mu.read():
            with self._seq_mu:
                windows = dict(self._writer_applied)
            gen = self._install_gen
            if not self._dev_serving:
                return (gen,
                        self._host_table[lo:lo + count].tobytes(),
                        windows)
            key, table_h = self._pin_current()
        try:
            raw = self.dev.fetch(table_h)
        finally:
            self._unpin(key)
        rows = np.frombuffer(raw, np.float32).reshape(
            self.rows_per, self.dim)[lo:lo + count]
        return (gen, rows.tobytes(), windows)

    def _apply_batch(self, ids: np.ndarray, grads: np.ndarray,
                     metas=()) -> None:
        """ONE combined application for a drained batch, device
        edition: the scatter-sub launches OUTSIDE the table lock
        against a pinned generation; the install + the replication /
        durability / migration tee run under the write lock — so
        backups, the delta log and migration shippers see device
        batches in exactly apply order, framed identically to the CPU
        tier (schema replica_apply_body).  The on-chip scatter sums
        duplicate ids, so the concatenated batch applies exactly;
        padding ids hit row 0 with zero grads (a no-op).

        The launch races other appliers exactly like the pre-parity
        optimistic loop: a lost install discards the candidate table
        and redoes the scatter (``ps_device_wasted_launches``); the
        combiner exists to keep that counter flat under fan-in.  When
        the shard is NOT serving from HBM (backup host mirror,
        importing destination, demoted), the inherited CPU-tier apply
        runs unchanged against the host mirror."""
        if not ids.size:
            return
        with self._repl_mu:
            if self._replica_set is not None and not self._primary_flag:
                raise rpc.RpcError(
                    resilience.ENOTPRIMARY,
                    f"shard {self.shard_index} replica "
                    f"{self._replica_index} was demoted (epoch "
                    f"{self._epoch}); refusing the apply")
        if not self._dev_serving:
            return super()._apply_batch(ids, grads, metas=metas)
        updates: Dict[str, int] = {}
        for m in metas:
            if m[1] > updates.get(m[0], 0):
                updates[m[0]] = m[1]
        bucket = self._bucket(int(ids.size))
        padded_ids = np.zeros(bucket, np.int32)
        padded_ids[:ids.size] = ids
        padded_g = np.zeros((bucket, self.dim), np.float32)
        padded_g[:ids.size] = grads
        rep = mig = dur = None
        gen = 0
        ids_h = self.dev.stage(padded_ids, self.device_index)
        try:
            g_h = self.dev.stage(padded_g, self.device_index)
            try:
                while True:
                    pinned = self._pin_current()
                    if pinned is None:
                        # Raced a mirror-down (demotion / checkpoint
                        # attach): the host path owns the table now.
                        return super()._apply_batch(ids, grads,
                                                    metas=metas)
                    key, table_h = pinned
                    try:
                        # scatter_sub scales by the resident lr scalar
                        # on-chip: out = table - scatter(lr * grads);
                        # functional — the output is a CANDIDATE table.
                        outs = self._scatter_exe(bucket).execute(
                            [table_h, ids_h, g_h, self.lr_h])
                    finally:
                        self._unpin(key)
                    new_table = outs[0][0]
                    installed = False
                    serving = True
                    with self._mu.write():
                        # Same fence discipline as the CPU tier: an
                        # apply that raced SchemeFence refuses inside
                        # the lock and the caller re-resolves.
                        if self._scheme_fenced:
                            self.dev.release(new_table)
                            raise rpc.RpcError(
                                resilience.ESCHEMEMOVED,
                                f"shard {self.shard_index} scheme "
                                f"v{self.scheme_version} was fenced "
                                f"mid-apply; refusing the write")
                        serving = self._dev_serving
                        if serving:
                            with self._dev_mu:
                                stale = self._dev_cur != key
                            if not stale:
                                self._install_gen += 1
                                gen = self._install_gen
                                self._swap_dev_locked(new_table)
                                if updates:
                                    with self._seq_mu:
                                        for w, q in updates.items():
                                            if q > self._writer_applied\
                                                    .get(w, 0):
                                                self._writer_applied[
                                                    w] = q
                                rep = self._replicator
                                mig = self._migrator
                                dur = self._durable
                                if (rep is not None or mig is not None
                                        or dur is not None):
                                    gids = (ids + self.base).astype(
                                        np.int32)
                                if rep is not None or dur is not None:
                                    body = _pack_windows(
                                        updates) + bytes(
                                        _pack_apply_req(gids, grads))
                                if rep is not None:
                                    rep.ship(gen, body)
                                if dur is not None:
                                    self._tee_delta(dur, gen, body)
                                if mig is not None:
                                    mig.ship(gen, gids, grads, updates)
                                installed = True
                    if installed:
                        break
                    self.dev.release(new_table)
                    if not serving:
                        return super()._apply_batch(ids, grads,
                                                    metas=metas)
                    # Install race lost: a concurrent applier swapped
                    # first and our output was computed against a
                    # stale table.  Discard and redo — the winner made
                    # progress, so this terminates.
                    if obs.enabled():
                        obs.counter("ps_device_wasted_launches").add(1)
            finally:
                self.dev.release(g_h)
        finally:
            self.dev.release(ids_h)
        # Durability before the ack: a pending re-base (refused append
        # or compaction threshold) folds the HBM table into a fresh
        # base now, outside the lock, before the replication barrier
        # releases the caller.
        self._maybe_device_rebase()
        if rep is not None:
            rep.flush(gen, timeout_s=self.repl_ack_timeout_s)

    def _serve(self, method: str, payload: bytes,
               deadline_us: int = 0) -> bytes:
        # Control plane (Sync / Promote / MigrateSync / ApplyGradId /
        # WriterSeq / ...) is the inherited CPU machinery verbatim —
        # it mutates the host mirror and the shared replication state.
        if method not in ("Lookup", "ApplyGrad"):
            return super()._serve(method, payload, deadline_us)
        # Same wire guards as the CPU shard (schemas lookup_req /
        # apply_req): counts bounded by the bytes present BEFORE any
        # staging allocation or device launch.
        (count,) = wire.read("<i", payload, 0, f"{method}.count")
        wire.check_count(count, (len(payload) - 4) // 4,
                         f"{method}.count")
        if method == "Lookup" and len(payload) != 4 + 4 * count:
            raise wire.WireError(
                f"Lookup request length mismatch (count={count}, "
                f"{len(payload)} bytes)")
        if method == "ApplyGrad":
            wire.need(payload, 4 + 4 * count, count * self.dim * 4,
                      "ApplyGrad.grads")
        ids = np.frombuffer(payload, np.int32, count, 4) - self.base
        if ids.size and (ids.min() < 0 or ids.max() >= self.rows_per):
            raise ValueError(
                f"ids outside shard [{self.base}, "
                f"{self.base + self.rows_per}) for shard base {self.base}"
            )
        if method == "Lookup":
            if self._importing:
                self._check_scheme()
            with self._seq_mu:
                self._read_count += 1
            pinned = None
            with self._mu.read():
                if self._dev_serving:
                    pinned = self._pin_current()
                else:
                    gathered = self._host_table[ids]
            if pinned is None:
                # Host-mirror read (backup serving a failover window /
                # importing destination): identical to the CPU tier.
                if zerocopy_enabled() and \
                        gathered.nbytes >= _ZC_MIN_BYTES:
                    out = rpc.IOBuf()
                    out.append_pinned(gathered)
                    return out
                return gathered.tobytes()
            key, table_h = pinned
            bucket = self._bucket(count)
            padded_ids = np.zeros(bucket, np.int32)
            padded_ids[:count] = ids
            ids_h = self.dev.stage(padded_ids, self.device_index)
            try:
                outs = self._gather_exe(bucket).execute(
                    [table_h, ids_h])
            finally:
                self.dev.release(ids_h)
                self._unpin(key)
            rows_h = outs[0][0]
            try:
                raw = self.dev.fetch(rows_h)
            finally:
                self.dev.release(rows_h)
            if zerocopy_enabled() and \
                    count * self.dim * 4 >= _ZC_MIN_BYTES:
                # Borrow the fetched bytes (pinning them) instead of
                # slicing off a truncated copy + the respond append.
                out = rpc.IOBuf()
                out.append_pinned(
                    memoryview(raw)[:count * self.dim * 4])
                return out
            return raw[:count * self.dim * 4]
        # ApplyGrad: writes belong to the primary of the current
        # scheme, identical contract to the CPU tier.
        self._check_primary()
        self._check_scheme()
        grads = np.frombuffer(payload, np.float32, count * self.dim,
                              4 + 4 * count)
        if self.combine:
            # Combined write path: no per-request staging/launch — the
            # combiner's leader stages and launches once per batch.
            self._combiner.add(ids, grads.reshape(count, self.dim),
                               deadline_us=deadline_us)
        else:
            self._apply_batch(ids, grads.reshape(count, self.dim))
        if self._replica_set is not None:
            with self._mu.read():
                return struct.pack("<q", self._install_gen)
        return b""

    def close(self):
        # Server + combiner + replicator/migrator latch first (the
        # inherited close), so late frames drop instead of scattering
        # into released buffers; device teardown after.
        super().close()
        for exe in list(self._gather.values()) + list(
                self._scatter.values()):
            exe.close()
        self._gather = {}
        self._scatter = {}
        with self._mu.write():
            self._dev_serving = False
            self._retire_dev_locked()
        if self.lr_h:
            self.dev.release(self.lr_h)
            self.lr_h = 0
        if self._owns_dev:
            self.dev.close()


class _PushStreamReceiver:
    """Client read half of a gradient push stream: the only frame the
    server ever writes back is a FENCE notification (a negative int64 —
    -1: the primary was demoted mid-stream and dropped frames; -2: the
    partition scheme was retired by a cutover).  Seeing it flips
    ``fenced`` so the pusher fails over (or refreshes its scheme)
    instead of trusting the close barrier."""

    __slots__ = ("fenced", "scheme_moved")

    def __init__(self):
        self.fenced = False
        self.scheme_moved = False

    def on_data(self, data: bytes) -> None:
        if len(data) >= 8:
            (val,) = struct.unpack_from("<q", data, 0)
            if val < 0:
                self.fenced = True
                if val == -2:
                    self.scheme_moved = True

    def on_closed(self) -> None:
        pass


class _SchemeMovedError(Exception):
    """A write batch hit a scheme boundary mid-flight (cutover fence or
    a still-importing destination): ``remainder`` holds the UNAPPLIED
    units ``(global_ids, grads, guards)`` to re-route once the write
    view settles; everything else in the batch is already acked."""

    def __init__(self, code: int, remainder):
        super().__init__(f"partition scheme moved (code {code})")
        self.code = code
        self.remainder = remainder


class _SchemeView:
    """Per-scheme routing state inside :class:`RemoteEmbedding`: the
    scheme's replica sets plus everything the router tracks per shard —
    believed primary, observed fencing epochs, acked-gen floors, unary
    write seq counters — and a scheme-scoped scorer so one scheme's
    latency history never poisons another's (the design goal "breaker/
    scorer keyed per scheme-replica").  Usually one view exists; during
    a live reshard two serve reads side by side with traffic weighted
    by ``scheme.weight``."""

    __slots__ = ("scheme", "version", "replica_sets", "n", "rows_per",
                 "bounds", "weight", "state", "addresses", "scorer",
                 "useq", "_primary_idx", "_epoch_seen", "_gen_seen")

    def __init__(self, emb: "RemoteEmbedding", scheme: PartitionScheme):
        self.scheme = scheme
        self.version = scheme.version
        self.replica_sets: List[ReplicaSet] = list(scheme.replica_sets)
        self.n = len(self.replica_sets)
        if scheme.bounds is not None:
            if scheme.bounds[-1] != emb.vocab:
                raise ValueError(
                    f"scheme v{scheme.version} bounds end at "
                    f"{scheme.bounds[-1]}, vocab is {emb.vocab}")
            self.bounds = np.asarray(scheme.bounds, np.int64)
            self.rows_per = 0
        else:
            if emb.vocab % self.n:
                raise ValueError(
                    f"scheme v{scheme.version}: {self.n} shards must "
                    f"divide vocab {emb.vocab} (or carry bounds)")
            self.bounds = None
            self.rows_per = emb.vocab // self.n
        self.weight = float(scheme.weight)
        self.state = scheme.state
        #: boot-time primary addresses (the legacy per-shard surface)
        self.addresses = [rs.addresses[rs.primary]
                          for rs in self.replica_sets]
        self.scorer = emb.scorer.scoped(
            "" if scheme.version == 0 else f"v{scheme.version}")
        #: per-shard unary write seq counters (ApplyGradId windows)
        self.useq: Dict[int, int] = {}
        self._primary_idx = [rs.primary for rs in self.replica_sets]
        self._epoch_seen = [0] * self.n
        self._gen_seen = [0] * self.n

    def update(self, scheme: PartitionScheme) -> None:
        """Adopt a re-published record's weight/state (the topology of
        a version never changes — a new topology is a new version)."""
        self.scheme = scheme
        self.weight = float(scheme.weight)
        self.state = scheme.state

    def shard_bounds(self, s: int, vocab: int):
        return self.scheme.shard_bounds(s, vocab)


class _SchemeWatcher(threading.Thread):
    """Registry watcher feeding a :class:`RemoteEmbedding`: blocks on
    the cluster's version and ingests scheme records (weight/state
    transitions drive the dual-scheme read router) and primary/epoch
    claims (failover adopts the claimed primary instead of sweeping).
    ``refresh()`` is the synchronous poke used by the scheme-moved
    write path — it lists the cluster on the CALLER's thread (the
    NamingClient keeps one connection per thread), so a redirect error
    converges without waiting out the watch cadence."""

    def __init__(self, emb: "RemoteEmbedding", registry_addr: str,
                 cluster: str, wait_ms: int = 2000):
        super().__init__(daemon=True, name="brt-scheme-watcher")
        from brpc_tpu_torch.naming import NamingClient
        self._emb = emb
        self._cluster = cluster
        self._wait_ms = wait_ms
        self._reg = NamingClient(registry_addr)
        self._stop = threading.Event()

    def run(self) -> None:
        version = 0
        while not self._stop.is_set():
            try:
                nodes, version = self._reg.watch(
                    self._cluster, known_version=version,
                    wait_ms=self._wait_ms)
            except Exception:  # noqa: BLE001 — registry outage: retry
                if self._stop.wait(0.2):
                    break
                continue
            try:
                self._emb._ingest_nodes(nodes)
            except Exception:  # noqa: BLE001 — a bad published record
                # must not kill the watch loop: the client would then
                # silently miss every later cutover/retire/claim.
                if obs.enabled():
                    obs.counter("ps_scheme_ingest_errors").add(1)

    def refresh(self) -> None:
        try:
            nodes, _ = self._reg.list(self._cluster)
            self._emb._ingest_nodes(nodes)
        except Exception:  # noqa: BLE001 — caller keeps its stale view
            return

    def stop(self) -> None:
        self._stop.set()
        self._reg.close()


class RemoteEmbedding:
    """Client view of a sharded remote table (owner-routed access).

    Per-shard requests fan out CONCURRENTLY via ``Channel.call_async``
    (the ParallelChannel-over-PartitionChannel shape, cpp/cluster/
    parallel_channel.* + partition_channel.*): whole-batch latency is
    max(shard RTT) instead of sum(shard RTT).  ``parallel=False``
    restores the sequential per-shard loop (the bench baseline).

    Fault tolerance (brpc_tpu_torch.resilience) is per shard:

    - ``retry`` — a failed shard attempt is retried with backoff under
      the batch's remaining ``deadline_ms`` budget while the other
      shards' responses are already in; a batch completes despite a
      shard failing its first attempt.
    - ``backup_ms`` — a shard that has not answered in N ms gets a
      hedged second attempt; the first completion wins and the loser is
      cancelled natively.
    - ``breakers`` — a BreakerRegistry keyed by shard address: open
      shards fail fast instead of burning the timeout, every outcome
      feeds the shard's EMA windows, and ``health_check=True`` runs a
      background prober that revives isolated shards via their
      ``_status.health`` builtin.
    - On a non-retriable partial failure the batch abandons its
      straggler shards: still-pending calls are CANCELLED (native
      ``StartCancel``) before being reaped, so the error surfaces at
      max(shard) latency, not sum.
    - Retries of k failed shards re-fan CONCURRENTLY (one backoff sleep,
      one native call group per round), so retry latency is max(shard).

    REPLICATION (availability over fail-fast): pass
    :class:`naming.ReplicaSet` entries (or address sequences) instead of
    bare addresses and the embedding becomes replica-aware — reads route
    to any live replica by latency+inflight score
    (:class:`resilience.ReplicaScorer`), an open breaker REDIRECTS to a
    sibling instead of raising ``BreakerOpen``, and writes follow the
    primary: a failed/demoted primary triggers client-driven failover
    (``ReplicaState`` sweep, fenced ``Promote`` of the freshest backup).
    A non-redirect ``BreakerRegistry(redirect=False)`` restores
    fail-fast.  The health prober revives isolated replicas back into
    the read set.

    The WRITE path additionally has a streaming mode:
    :meth:`push_gradients` ships framed deltas over one persistent
    ordered flow-controlled stream per owner shard (feeding the server's
    gradient combiner directly — no per-call dispatch), with
    :meth:`flush_gradients` as the applied-everything barrier and
    reconnect-under-the-retry-budget on stream breakage.  The unary
    :meth:`apply_gradients` stays as the synchronous path."""

    @classmethod
    def from_registry(cls, registry_addr: str, cluster: str, vocab: int,
                      dim: int, timeout_ms: int = 2000,
                      wait_ms: int = 5000, watch: bool = False,
                      **kwargs) -> "RemoteEmbedding":
        """Resolves the shard topology from the native naming registry
        (brpc_tpu_torch.naming).  PREFERRED form: the cluster carries
        :class:`naming.PartitionScheme` records (``scheme#<version>``
        nodes) — every published scheme becomes a routing view, so a
        client booted mid-reshard serves both schemes immediately.
        Legacy form: shards register with tag "<shard>/<num>" (the boot
        primary) or "<shard>/<num>/<replica>" (backups), and the watch
        blocks until a CONSISTENT full set is present.  ``watch=True``
        attaches a registry watcher after construction: scheme
        transitions (cutover, drain, retire) and primary/epoch claims
        flow into the router live.  ``kwargs`` pass through to the
        constructor (retry/breakers/...)."""
        from brpc_tpu_torch.naming import NamingClient
        reg = NamingClient(registry_addr)
        deadline = time.monotonic() + wait_ms / 1000.0
        version = 0
        groups: dict = {}
        # Each watch IS the poll; its blocking window follows the shared
        # backoff helper (exponential + deterministic jitter, capped by
        # the remaining deadline) instead of a fixed interval — early
        # polls catch a cluster mid-registration fast, later ones stop
        # hammering a registry that clearly isn't filling up.  The
        # NamingClient reuses one connection per thread across polls.
        backoff = resilience.Backoff(base_ms=100.0, multiplier=2.0,
                                     max_ms=2000.0, jitter=0.5)
        poll = 0
        emb: "Optional[RemoteEmbedding]" = None
        while True:
            remaining_ms = (deadline - time.monotonic()) * 1000.0
            watch_ms = max(1, int(min(backoff.delay_ms(poll),
                                      max(remaining_ms, 1.0))))
            poll += 1
            nodes, version = reg.watch(cluster, known_version=version,
                                       wait_ms=watch_ms)
            schemes = parse_schemes(nodes)
            live = [sc for sc in schemes.values()
                    if sc.state != "retired"]
            if any(sc.state == "active" for sc in live):
                emb = cls(sorted(live, key=lambda sc: sc.version),
                          vocab, dim, timeout_ms=timeout_ms, **kwargs)
                break
            # Group by the tag's "/num" so a stale entry from an old
            # sharding cannot block a complete consistent new set.
            groups = {}
            for n in nodes:
                parsed = parse_shard_tag(n.get("tag", ""))
                if parsed is None:
                    continue
                sh, nm, rep = parsed
                # Duplicate (shard, replica) within one sharding: a
                # restarted shard's fresh registration supersedes a
                # TTL-lingering stale one; the registry lists entries in
                # registration order, so the LAST occurrence is newest.
                groups.setdefault(nm, {}).setdefault(sh, {})[rep] = \
                    n["addr"]
            for num, shard_map in sorted(groups.items(), reverse=True):
                if num > 0 and len(shard_map) == num and \
                        all(i in shard_map and 0 in shard_map[i]
                            for i in range(num)):
                    sets = []
                    for i in range(num):
                        reps = shard_map[i]
                        sets.append(ReplicaSet(
                            tuple(reps[r] for r in sorted(reps)),
                            primary=sorted(reps).index(0)))
                    emb = cls(sets, vocab, dim, timeout_ms=timeout_ms,
                              **kwargs)
                    break
            if emb is not None:
                break
            if time.monotonic() > deadline:
                reg.close()
                raise TimeoutError(
                    f"cluster '{cluster}' has no complete sharding: "
                    f"{ {nm: sorted(m) for nm, m in groups.items()} }")
        emb._ingest_nodes(nodes)
        reg.close()
        if watch:
            emb.attach_registry(registry_addr, cluster)
        return emb

    def __init__(self, addresses: Sequence, vocab: int, dim: int,
                 timeout_ms: int = 2000, parallel: bool = True, *,
                 retry: "Optional[resilience.RetryPolicy]" = None,
                 deadline_ms: Optional[float] = None,
                 backup_ms: Optional[float] = None,
                 breakers: "Optional[resilience.BreakerRegistry]" = None,
                 health_check: bool = False,
                 health_interval_ms: float = 200.0,
                 push_window_bytes: int = 0,
                 scorer: "Optional[resilience.ReplicaScorer]" = None,
                 propagate_deadline: bool = True,
                 deadline_mode: str = "absolute"):
        self.vocab = vocab
        self.dim = dim
        self.parallel = parallel
        self.timeout_ms = timeout_ms
        #: deadline propagation: with a ``deadline_ms`` budget set,
        #: every data-plane request (and every retry/hedge leg,
        #: re-stamped at issue time) carries its REMAINING budget as a
        #: wall-clock deadline header, so servers shed queued work that
        #: can no longer answer in time (EDEADLINE) instead of
        #: executing it into a void.  Same-host clocks agree exactly;
        #: cross-host the "absolute" form assumes NTP-grade wall-clock
        #: agreement while "relative" (the v2 header) drops it — the
        #: server arrival-stamps the remaining budget with its own
        #: clock.
        self.propagate_deadline = bool(propagate_deadline)
        if deadline_mode not in ("absolute", "relative"):
            raise ValueError(
                f"deadline_mode {deadline_mode!r}: expected "
                f"'absolute' or 'relative'")
        self.deadline_mode = deadline_mode
        #: per-shard unconsumed-bytes window for push streams (0 = the
        #: native 2MB default) — the backpressure knob of push_gradients
        self.push_window_bytes = push_window_bytes
        self._push_streams: dict = {}
        self._push_addr: Dict[int, str] = {}
        self._push_recv: Dict[int, "_PushStreamReceiver"] = {}
        # Framed idempotent push: one stable writer identity; the wire
        # writer KEYS are per (scheme, shard) so seq spaces from
        # different schemes/shards never collide in a migrated window
        # (see _stream_writer_key / _unary_writer_key).
        self._writer_id = f"w{uuid.uuid4().hex[:12]}"
        self._push_seq: Dict[int, int] = {}
        #: highest seq written to the CURRENT stream per shard (reset to
        #: the server's high-water on every (re)connect — the replay
        #: cursor)
        self._push_sent: Dict[int, int] = {}
        #: frames pushed since the last successful flush barrier, per
        #: shard: (seq, body) in order.  A failover mid-window replays
        #: these above the new primary's inherited high-water — pushed-
        #: but-unflushed deltas survive the primary, not just the
        #: stream.  Cleared only when the flush barrier confirms.  A
        #: SCHEME move re-routes them as guarded unary writes.
        self._push_unacked: Dict[int, List[tuple]] = {}
        #: transfer units (ids, grads, guards) that survived a FAILED
        #: scheme-boundary transfer: the guards make re-driving them
        #: idempotent, and the next flush/transfer must drain them
        #: before it may report success — a failed transfer never
        #: silently drops pushed deltas.
        self._push_carry: List[tuple] = []
        self.retry = retry
        self.deadline_ms = deadline_ms
        self.backup_ms = backup_ms
        self.scorer = scorer or resilience.ReplicaScorer()
        # Partition-scheme views (the DynamicPartitionChannel shape):
        # `addresses` is either the legacy form — one entry per shard
        # range (bare address / ReplicaSet / address sequence), wrapped
        # into scheme version 0 — or a sequence of PartitionScheme
        # records (a client booted mid-reshard serves them all).
        items = list(addresses)
        if items and all(isinstance(a, PartitionScheme) for a in items):
            schemes = sorted(items, key=lambda sc: sc.version)
        else:
            schemes = [PartitionScheme(
                version=0,
                replica_sets=tuple(ReplicaSet.of(a) for a in items))]
        self._view_mu = checked_lock("ps.views")
        self._views: List[_SchemeView] = []
        self._claims: Dict[tuple, tuple] = {}
        self._watcher: Optional[_SchemeWatcher] = None
        self._read_seq = 0
        self._chans: Dict[str, rpc.Channel] = {}
        views = [_SchemeView(self, sc) for sc in schemes]
        self.replicated = any(len(rs.addresses) > 1
                              for v in views for rs in v.replica_sets)
        self.breakers = breakers
        if health_check and breakers is None:
            self.breakers = breakers = resilience.BreakerRegistry(
                redirect=self.replicated)
        # REDIRECT mode (the SelectiveChannel behavior): reads route to
        # any live replica by latency+inflight score, an open breaker
        # re-routes instead of rejecting, and a failed/isolated primary
        # fails WRITES over via fenced promotion.  On by default when
        # replicas exist, unless a non-redirect BreakerRegistry
        # explicitly asks for fail-fast.
        self._redirect = self.replicated and (
            self.breakers is None or self.breakers.redirect)
        for v in views:
            self._admit_view(v)
        with self._view_mu:
            self._views = views
            # newest ACTIVE scheme owns writes
            act = [v for v in views if v.state == "active"] or views
            self._wv = max(act, key=lambda v: v.version)
        self._prober: "Optional[resilience.HealthProber]" = None
        if health_check:
            self._prober = resilience.HealthProber(
                self.breakers, interval_ms=health_interval_ms)
            self._prober.start()

    def _admit_view(self, view: _SchemeView) -> None:
        """Channels + breakers for every replica of a (new) view: the
        cluster-recover guard counts working endpoints, so the breaker
        registry must know the full cluster up front."""
        for rs in view.replica_sets:
            for a in rs.addresses:
                if a not in self._chans:
                    self._chans[a] = rpc.Channel(
                        a, timeout_ms=self.timeout_ms)
                if self.breakers is not None:
                    self.breakers.breaker_for(a)

    # -- legacy single-scheme surface (delegates to the write view) -------

    @property
    def _wview(self) -> _SchemeView:
        return self._wv

    @property
    def replica_sets(self) -> List[ReplicaSet]:
        return self._wv.replica_sets

    @property
    def n(self) -> int:
        return self._wv.n

    @property
    def rows_per(self) -> int:
        return self._wv.rows_per

    @property
    def addresses(self) -> List[str]:
        return self._wv.addresses

    @property
    def channels(self) -> List[rpc.Channel]:
        return [self._chans[a] for a in self._wv.addresses]

    @property
    def _primary_idx(self) -> List[int]:
        return self._wv._primary_idx

    @property
    def _epoch_seen(self) -> List[int]:
        return self._wv._epoch_seen

    @property
    def _gen_seen(self) -> List[int]:
        return self._wv._gen_seen

    # -- scheme lifecycle (the dual-scheme router's control surface) ------

    def schemes(self) -> List[PartitionScheme]:
        with self._view_mu:
            return [v.scheme for v in self._views]

    def set_schemes(self, schemes: Sequence[PartitionScheme],
                    strict: bool = True) -> None:
        """Adopt the given scheme records: known versions take the new
        weight/state (topology per version is immutable), unknown ones
        become routing views, RETIRED ones are dropped — after which no
        read or write ever routes to them again.  Safe to call from a
        watcher thread; the write view itself only switches on the
        writer's thread (see ``_write_view``).  With ``strict=False``
        (the registry-ingest path) a record this client cannot build a
        view for is skipped instead of raising, so one bad publication
        never blocks the usable ones."""
        by_ver = {sc.version: sc for sc in schemes}
        fresh: List[_SchemeView] = []
        with self._view_mu:
            known = {v.version: v for v in self._views}
            for ver, sc in by_ver.items():
                if ver in known:
                    known[ver].update(sc)
                elif sc.state != "retired":
                    try:
                        fresh.append(_SchemeView(self, sc))
                    except ValueError:
                        if strict:
                            raise
                        if obs.enabled():
                            obs.counter("ps_scheme_rejects").add(1)
        for v in fresh:
            self._admit_view(v)
            if obs.enabled():
                obs.counter("ps_scheme_refreshes").add(1)
        with self._view_mu:
            allv = self._views + fresh
            cur = self._wv
            if cur.state == "retired" and not any(
                    self._push_unacked.values()):
                # a read-only client's write view never moves through
                # _write_view(); when its scheme retires with no push
                # window pending, hop to the successor here so the
                # retired view can actually drop
                act = [v for v in allv if v.state == "active"] or allv
                cur = self._wv = max(act, key=lambda v: v.version)
            self._views = [v for v in allv
                           if v.state != "retired" or v is cur]
            self.replicated = self.replicated or any(
                len(rs.addresses) > 1
                for v in fresh for rs in v.replica_sets)
            self._redirect = self.replicated and (
                self.breakers is None or self.breakers.redirect)

    def add_scheme(self, scheme: PartitionScheme) -> None:
        self.set_schemes([scheme])

    def attach_registry(self, registry_addr: str, cluster: str,
                        wait_ms: int = 2000) -> None:
        """Start watching the naming registry: published scheme
        transitions and primary/epoch claims flow into this router
        live (cutover redirects then only pay one refresh round
        trip)."""
        if self._watcher is not None:
            return
        self._watcher = _SchemeWatcher(self, registry_addr, cluster,
                                       wait_ms=wait_ms)
        self._watcher.start()

    def _ingest_nodes(self, nodes) -> None:
        """Registry listing → scheme views + primary claims.  Ingest is
        non-strict: a published scheme this client cannot route (bounds
        not ending at its vocab, shard count not dividing it) is
        counted and skipped — the watcher must keep consuming the
        records it CAN use."""
        schemes = parse_schemes(nodes)
        if schemes:
            self.set_schemes(list(schemes.values()), strict=False)
        claims = parse_claims(nodes)
        if claims:
            with self._view_mu:
                self._claims.update(claims)

    def _claim_for(self, view: _SchemeView, s: int):
        """This view's claim for shard ``s`` — claims are keyed per
        scheme VERSION so coexisting schemes with equal shard counts
        never mask each other; a legacy unscoped claim (``scheme``
        ``None``) is accepted only when no scoped one exists."""
        with self._view_mu:
            claim = self._claims.get((view.version, view.n, s))
            if claim is None:
                claim = self._claims.get((None, view.n, s))
            return claim

    def _write_view(self) -> _SchemeView:
        """The view owning WRITES: the newest active scheme.  Switching
        away from a view transfers its unacked push window onto the
        successor (guarded unary re-splits — exactly-once across the
        scheme boundary) before any new write routes there."""
        while True:
            with self._view_mu:
                act = [v for v in self._views if v.state == "active"] \
                    or list(self._views)
                best = max(act, key=lambda v: v.version)
                cur = self._wv
                if best is cur:
                    return cur
                self._wv = best
            if obs.enabled():
                obs.counter("ps_scheme_switches").add(1)
            self._transfer_pushes(cur, best)

    def _on_stale_scheme(self, view: _SchemeView,
                         err: BaseException) -> None:
        """A write was redirected with ESCHEMEMOVED.  The redirect is
        AUTHORITATIVE: the server declared this scheme fenced, so
        demote the view locally (the write view moves even before the
        registry publication lands) and poke the registry for the
        successor; with nothing newer known the redirect error
        propagates (a stale client with no discovery path must fail
        loudly, not spin)."""
        with self._view_mu:
            if view.state == "active":
                view.state = "draining"
        if self._watcher is not None:
            self._watcher.refresh()
        with self._view_mu:
            newest = max(self._views, key=lambda v: v.version)
        if newest.version <= view.version:
            raise err

    def _stream_writer_key(self, view: _SchemeView, s: int) -> str:
        """Per-(client, scheme, shard) stream writer key: seq spaces
        from different schemes/shards must never collide inside a
        migrated dedup window (a merge destination inherits windows
        from several sources)."""
        return f"{self._writer_id}/s{view.version}.{s}"

    def _unary_writer_key(self, view: _SchemeView, s: int) -> str:
        return f"{self._writer_id}/u{view.version}.{s}"

    # -- replica routing (SelectiveChannel / locality-aware LB analog) ----

    def _chan(self, addr: str) -> rpc.Channel:
        ch = self._chans.get(addr)
        if ch is None:
            ch = self._chans[addr] = rpc.Channel(
                addr, timeout_ms=self.timeout_ms)
        return ch

    def _addr_breaker(self, addr: str
                      ) -> "Optional[resilience.CircuitBreaker]":
        if self.breakers is None:
            return None
        return self.breakers.breaker_for(addr)

    def _isolated(self, addr: str) -> bool:
        if self.breakers is None:
            return False
        return self.breakers.breaker_for(addr).isolated()

    def _breaker(self, view: _SchemeView, s: int
                 ) -> "Optional[resilience.CircuitBreaker]":
        if self.breakers is None:
            return None
        return self.breakers.breaker_for(view.addresses[s])

    def _ctl_timeout_ms(self) -> int:
        """Control-plane calls (ReplicaState/Promote) stay snappy: they
        run inside a failing data call's recovery path."""
        return max(50, min(self.timeout_ms, 1000))

    def _route_read(self, view: _SchemeView, s: int,
                    exclude=frozenset()) -> str:
        """Pick the replica serving shard ``s``'s next READ under
        ``view``: in redirect mode, the lowest latency*(inflight+1)
        score among live (not isolated, not just-failed) replicas — an
        open breaker on one replica REDIRECTS traffic to its siblings;
        only when every replica is isolated does the shard fail fast.
        Outside redirect mode reads stick to the primary (the legacy
        reject behavior)."""
        rs = view.replica_sets[s]
        if len(rs.addresses) > 1 and self._redirect:
            cands = [a for a in rs.addresses if a not in exclude]
            if not cands:
                cands = list(rs.addresses)   # tried everyone: start over
            live = [a for a in cands if not self._isolated(a)]
            if not live:
                raise rpc.RpcError(
                    resilience.EBREAKEROPEN,
                    f"shard {s}: every replica isolated by circuit "
                    f"breaker ({', '.join(rs.addresses)})")
            if len(live) < len(cands) and obs.enabled():
                # an open breaker pushed this read to a sibling —
                # redirected, not rejected
                obs.counter("rpc_breaker_redirects").add(1)
            return view.scorer.pick(live)
        return self._route_write(view, s, exclude)

    def _route_write(self, view: _SchemeView, s: int,
                     exclude=frozenset()) -> str:
        """WRITES go to the primary.  In redirect mode a failed or
        breaker-isolated primary triggers failover (fenced promotion of
        a backup); otherwise an isolated primary rejects, exactly the
        single-owner behavior."""
        rs = view.replica_sets[s]
        addr = rs.addresses[view._primary_idx[s]]
        if len(rs.addresses) > 1 and self._redirect and \
                (addr in exclude or self._isolated(addr)):
            return self._failover(view, s, exclude)
        if self._isolated(addr):
            raise rpc.RpcError(
                resilience.EBREAKEROPEN,
                f"shard {s} ({addr}) isolated by circuit breaker")
        return addr

    def _adopt_claim(self, view: _SchemeView, s: int,
                     exclude=frozenset()) -> Optional[str]:
        """The registry-claim fast path (PR-9 deferral): when the
        naming heartbeat carries a primary claim for this range at or
        above every epoch we've seen, verify it with ONE ReplicaState
        call and adopt — no replica sweep, no promote race.  Returns
        the adopted address or None (fall back to sweeping)."""
        claim = self._claim_for(view, s)
        if claim is None:
            return None
        epoch_c, addr = claim
        rs = view.replica_sets[s]
        if addr not in rs.addresses or addr in exclude or \
                epoch_c < view._epoch_seen[s] or self._isolated(addr):
            return None
        try:
            st = json.loads(self._chan(addr).call(
                "Ps", "ReplicaState", b"",
                timeout_ms=self._ctl_timeout_ms()))
        except rpc.RpcError:
            return None
        if not st.get("primary") or st["epoch"] < epoch_c or \
                st["gen"] < view._gen_seen[s]:
            return None
        view._epoch_seen[s] = max(view._epoch_seen[s], int(st["epoch"]))
        view._primary_idx[s] = rs.addresses.index(addr)
        if obs.enabled():
            obs.counter("ps_claim_adoptions").add(1)
        return addr

    def _failover(self, view: _SchemeView, s: int,
                  exclude=frozenset()) -> str:
        """Re-resolve — and, when nobody owns the range, PROMOTE — shard
        ``s``'s primary among reachable replicas.  A primary claim
        published through the registry heartbeat short-circuits the
        sweep.  Promotion carries a fencing epoch above every epoch
        observed in the sweep, so a concurrent stale primary is fenced
        the moment it next touches a fenced replica; losing a promote
        race (EFENCED back) just re-resolves.  Returns the new
        primary's address."""
        adopted = self._adopt_claim(view, s, exclude)
        if adopted is not None:
            if obs.enabled():
                obs.counter("ps_client_failovers").add(1)
            return adopted
        rs = view.replica_sets[s]
        last_err: Optional[rpc.RpcError] = None
        for _ in range(3):
            states: Dict[str, dict] = {}
            for a in rs.addresses:
                if a in exclude or self._isolated(a):
                    continue
                try:
                    states[a] = json.loads(self._chan(a).call(
                        "Ps", "ReplicaState", b"",
                        timeout_ms=self._ctl_timeout_ms()))
                except rpc.RpcError as e:
                    last_err = e
            if not states:
                raise rpc.RpcError(
                    resilience.EBREAKEROPEN,
                    f"shard {s}: no reachable replica to fail over to "
                    f"(candidates {', '.join(rs.addresses)}; last error: "
                    f"{last_err})")
            seen = max([view._epoch_seen[s]]
                       + [st["epoch"] for st in states.values()])
            view._epoch_seen[s] = seen
            # Claims and candidates BEHIND the highest epoch this client
            # has observed are stale — a blackholed new primary must not
            # be undercut by its demoted predecessor (that would lose
            # acked updates).
            claims = [(st["epoch"], a) for a, st in states.items()
                      if st.get("primary") and st["epoch"] >= seen]
            if claims:
                _, addr = max(claims)
                if states[addr]["gen"] < view._gen_seen[s]:
                    # A primary whose table is behind writes this client
                    # was ACKED can only exist through a lossy promotion
                    # elsewhere — refuse to adopt it silently.
                    raise rpc.RpcError(
                        resilience.EBREAKEROPEN,
                        f"shard {s}: claimed primary {addr} is at gen "
                        f"{states[addr]['gen']} < acked gen "
                        f"{view._gen_seen[s]} — acked updates are "
                        f"missing, refusing the lossy adoption")
            else:
                # Quorum intersection: for >=3-replica groups a
                # promotion may only happen off a MAJORITY sweep — an
                # acked write holds on a write quorum, and any majority
                # of replicas intersects that quorum in at least one
                # member, so the freshest candidate of a majority sweep
                # provably carries every acked update.  A sub-majority
                # sweep refuses loudly instead of guessing.
                majority = len(rs.addresses) // 2 + 1
                if len(rs.addresses) >= 3 and len(states) < majority:
                    raise rpc.RpcError(
                        resilience.EBREAKEROPEN,
                        f"shard {s}: only {len(states)} of "
                        f"{len(rs.addresses)} replicas reachable — a "
                        f"majority sweep is required before promoting "
                        f"(acked quorum writes must intersect it)")
                cands = {a: st for a, st in states.items()
                         if st["epoch"] >= seen
                         and st["gen"] >= view._gen_seen[s]}
                if not cands:
                    raise rpc.RpcError(
                        resilience.EBREAKEROPEN,
                        f"shard {s}: every reachable replica is behind "
                        f"epoch {seen} or acked gen "
                        f"{view._gen_seen[s]} — the authoritative "
                        f"replica is unreachable, refusing a lossy "
                        f"promotion")
                # Nobody owns the range: promote the freshest current-
                # epoch replica (highest generation; index breaks ties
                # deterministically) with a fencing epoch above all.
                addr = max(cands, key=lambda a: (
                    cands[a]["gen"], -rs.addresses.index(a)))
                epoch = seen + 1
                try:
                    self._chan(addr).call(
                        "Ps", "Promote", struct.pack("<q", epoch),
                        timeout_ms=self._ctl_timeout_ms())
                except rpc.RpcError as e:
                    if e.code != resilience.EFENCED:
                        raise
                    continue   # promote race lost: re-resolve
                view._epoch_seen[s] = epoch
                if obs.enabled():
                    obs.counter("ps_client_promotes").add(1)
            view._primary_idx[s] = rs.addresses.index(addr)
            if obs.enabled():
                obs.counter("ps_client_failovers").add(1)
            return addr
        raise rpc.RpcError(
            resilience.EFENCED,
            f"shard {s}: lost the promote race on every attempt")

    def _note_acked_gen(self, view: _SchemeView, s: int, rsp) -> None:
        """A replicated shard answers writes with the covering gen —
        the client's acked floor for failover's lossy-promotion guard."""
        if rsp is not None and len(rsp) >= 8:
            (gen,) = struct.unpack_from("<q", rsp, 0)
            if gen > view._gen_seen[s]:
                view._gen_seen[s] = gen

    def _stamp(self, req, deadline: Optional[float]):
        """Deadline propagation for one request LEG: prefix ``req``
        with the batch's remaining budget (``deadline`` is the batch's
        ``time.monotonic`` instant).  Called per attempt — a retry or
        hedge leg carries what is left NOW, not the original budget.
        ``deadline_mode="absolute"`` converts to a wall-clock deadline
        (same-host/NTP assumption); ``"relative"`` ships the remaining
        budget itself (v2 header) and the server arrival-stamps with
        its own clock — no cross-host wall-clock agreement needed."""
        if deadline is None or not self.propagate_deadline:
            return req
        remaining_s = deadline - time.monotonic()
        if isinstance(req, rpc.IOBuf):
            # Zero-copy stamp: the 12-byte header rides as a prepended
            # owned block and the body's blocks are SHARED — the old
            # path re-copied the whole request to prepend 12 bytes.
            # The caller closes the stamped wrapper after the leg
            # starts (_close_stamped); `req` itself stays intact for
            # further attempts.
            if self.deadline_mode == "relative":
                return _pack_deadline_rel_iobuf(int(remaining_s * 1e6),
                                                req)
            return _pack_deadline_iobuf(
                int((time.time() + remaining_s) * 1e6), req)
        if self.deadline_mode == "relative":
            return _pack_deadline_rel(int(remaining_s * 1e6), req)
        return _pack_deadline(int((time.time() + remaining_s) * 1e6),
                              req)

    @staticmethod
    def _close_stamped(req, stamped) -> None:
        """Release a per-leg stamped IOBuf once its call has started or
        finished — the native request shares the blocks, so the wrapper
        handle is no longer needed (and ``req`` is untouched)."""
        if stamped is not req and isinstance(stamped, rpc.IOBuf):
            stamped.close()

    def _reroutable(self, view: _SchemeView, s: int,
                    exc: rpc.RpcError) -> bool:
        """True for routing-correction errors (the write reached a
        demoted/fenced replica) that re-route via failover immediately,
        outside the retry policy's attempt budget."""
        return exc.code in (resilience.ENOTPRIMARY, resilience.EFENCED) \
            and len(view.replica_sets[s].addresses) > 1

    @staticmethod
    def _scheme_miss(exc: rpc.RpcError) -> bool:
        """A scheme-boundary error: the shard exists and answered, but
        the SCHEME this client routed under is stale (fenced cutover)
        or not yet open (importing destination)."""
        return exc.code in (resilience.ESCHEMEMOVED,
                            resilience.EMIGRATING)

    def _retry_shard(self, view: _SchemeView, s: int, method: str,
                     req: bytes, exc: rpc.RpcError,
                     deadline: Optional[float],
                     tried: Optional[set] = None) -> bytes:
        """A shard's attempt failed on the hedged/sequential path:
        classify, back off, re-route (a replica that just failed is
        excluded, so the retry lands on a SIBLING when one exists), and
        retry under the batch's remaining budget.  Scheme-boundary
        errors escape immediately — they are view-level, not
        replica-level."""
        read = method == "Lookup"
        tried = set() if tried is None else tried
        e = exc
        attempt = 0
        reroutes = 0
        while True:
            # a READ answered EMIGRATING with siblings untried is a
            # replica-level miss (a lagging destination backup): route
            # around it; only an all-replicas miss is a view miss
            miss_reroute = (read and e.code == resilience.EMIGRATING
                            and len(tried)
                            < len(view.replica_sets[s].addresses))
            if self._scheme_miss(e) and not miss_reroute:
                raise e
            reroute = miss_reroute or (
                not read and self._reroutable(view, s, e))
            if reroute:
                reroutes += 1
                if reroutes > len(view.replica_sets[s].addresses) + 1:
                    raise e
            else:
                policy = self.retry
                if policy is None or not policy.do_retry(e, attempt):
                    raise e
            remaining_ms: Optional[float] = None
            if deadline is not None:
                remaining_ms = (deadline - time.monotonic()) * 1000.0
                if remaining_ms < 2.0:
                    raise e
            if not reroute:
                # ELIMIT sheds take the MANDATORY backoff floor
                # (retry_delay_ms): never re-issue immediately into the
                # overload that just shed us.
                delay = policy.retry_delay_ms(e, attempt)
                if remaining_ms is not None:
                    delay = min(delay, remaining_ms - 1.0)
                resilience.sleep_ms(delay)
                attempt += 1
                if obs.enabled():
                    obs.counter("rpc_retries").add(1)
            addr = self._route_read(view, s, tried) if read \
                else self._route_write(view, s, tried)
            tried.add(addr)
            t = None
            if deadline is not None:
                t = max(1, int((deadline - time.monotonic()) * 1000.0))
            if self.retry is not None:
                t = self.retry.cap_attempt_timeout(t)
            b = self._addr_breaker(addr)
            view.scorer.note_start(addr)
            t0 = time.monotonic()
            stamped = self._stamp(req, deadline)
            try:
                rsp = self._chan(addr).call(
                    "Ps", method, stamped,
                    timeout_ms=t, backup_ms=self.backup_ms)
            except rpc.RpcError as e2:
                routing = e2.code in (resilience.ENOTPRIMARY,
                                      resilience.EFENCED,
                                      resilience.EMIGRATING,
                                      resilience.ESCHEMEMOVED)
                view.scorer.note_end(addr, time.monotonic() - t0,
                                     routing)
                if b is not None:
                    b.on_call_end(0 if routing else e2.code)
                e = e2
                continue
            finally:
                self._close_stamped(req, stamped)
            view.scorer.note_end(addr, time.monotonic() - t0, True)
            if b is not None:
                b.on_call_end(0)
            return rsp

    def _fan_out(self, view: _SchemeView, method: str,
                 items: List[tuple], on_done=None) -> List[bytes]:
        """Issue every (shard, req) concurrently under ``view`` — each
        routed to a replica (reads: best live score; writes: the
        primary) — then collect with the resilience policy applied per
        shard.  Responses align with ``items``; ``on_done(i, rsp)``
        fires as each lands, so a caller interrupted by a scheme
        boundary knows exactly which items are acked.  Failed shards
        retry as a CONCURRENT re-fan: each round re-issues the whole
        failed subset as one native call group after a single backoff
        sleep, so k failing shards pay max(shard) retry latency, not
        sum — and each retry is re-routed AWAY from the replica that
        just failed.  On an unrecoverable shard failure the remaining
        in-flight calls are cancelled (straggler abandonment) before
        the error propagates."""
        deadline = time.monotonic() + self.deadline_ms / 1000.0 \
            if self.deadline_ms is not None else None
        read = method == "Lookup"

        def _budget() -> Optional[int]:
            t = None
            if deadline is not None:
                t = max(1, int((deadline - time.monotonic()) * 1000.0))
            if self.retry is not None:
                t = self.retry.cap_attempt_timeout(t)
            return t

        # per item: a PendingCall in flight, an RpcError whose start
        # failed (client fault / local transport error — handled like a
        # failed attempt in the join phase), or None once consumed
        pending: List[object] = [None] * len(items)
        addrs: List[Optional[str]] = [None] * len(items)
        t0s: List[float] = [0.0] * len(items)
        tried: List[set] = [set() for _ in items]
        attempts: List[int] = [0] * len(items)
        reroutes: List[int] = [0] * len(items)
        out: List[Optional[bytes]] = [None] * len(items)
        group: "Optional[rpc.CallGroup]" = None

        def _start(i: int, s: int, req) -> None:
            """Route item i and start its call; a start failure parks
            the RpcError in pending[i] for classification."""
            addr = self._route_read(view, s, tried[i]) if read \
                else self._route_write(view, s, tried[i])
            addrs[i] = addr
            tried[i].add(addr)
            view.scorer.note_start(addr)
            t0s[i] = time.monotonic()
            stamped = self._stamp(req, deadline)
            try:
                # managed fan-out set: every entry is joined or
                # cancelled+closed in the finally below; each leg is
                # stamped with the budget remaining at ITS issue
                pending[i] = self._chan(addr).call_async(  # lint: allow-handle-escape
                    "Ps", method, stamped,
                    timeout_ms=_budget(), tag=f"attempt={attempts[i]}")
            except rpc.RpcError as e:
                pending[i] = e
            finally:
                # the started call shares the blocks; the stamped
                # wrapper handle is done its job
                self._close_stamped(req, stamped)

        def _settle(i: int, pc: object, ok: bool, code: int = 0) -> None:
            """Feed one finished attempt to the scorer + breaker.
            Routing corrections (ENOTPRIMARY/EFENCED) and scheme
            boundaries (EMIGRATING/ESCHEMEMOVED) are PROOF the endpoint
            is alive — they must not open its breaker or poison its
            latency score."""
            addr = addrs[i]
            routing = code in (resilience.ENOTPRIMARY,
                               resilience.EFENCED,
                               resilience.EMIGRATING,
                               resilience.ESCHEMEMOVED)
            lat = time.monotonic() - t0s[i] \
                if isinstance(pc, rpc.PendingCall) else None
            view.scorer.note_end(addr, lat, ok or routing)
            b = self._addr_breaker(addr)
            if b is not None:
                b.on_call_end(0 if routing else code)

        try:
            for i, (s, req) in enumerate(items):
                _start(i, s, req)
            if self.backup_ms is not None:
                # Hedged path: ordered per-shard collection — each hedge
                # arms backup_ms on its in-flight primary and waits on its
                # OWN native call group inside backup_call (exact wakes,
                # no polling slices).
                for i, (s, req) in enumerate(items):
                    pc, pending[i] = pending[i], None
                    try:
                        if isinstance(pc, rpc.RpcError):
                            raise pc
                        # the hedge leg re-stamps: a backup fired
                        # backup_ms late carries the budget left THEN
                        stamped = self._stamp(req, deadline)
                        try:
                            rsp = resilience.backup_call(
                                self._chan(addrs[i]), "Ps", method,
                                stamped,
                                backup_ms=self.backup_ms,
                                timeout_ms=_budget(), primary=pc)
                        finally:
                            self._close_stamped(req, stamped)
                    except rpc.RpcError as e:
                        _settle(i, pc, False, e.code)
                        rsp = self._retry_shard(view, s, method, req,
                                                e, deadline, tried[i])
                    else:
                        _settle(i, pc, True)
                    out[i] = rsp
                    if on_done is not None:
                        on_done(i, rsp)
                return out  # type: ignore[return-value]
            # Unhedged path: completion-ORDER collection over one native
            # fan-in group (the ParallelChannel CountdownEvent shape).
            # Every wait_any wakes on exactly one shard completing — no
            # time slices.  Failures collect into `failed` and re-fan
            # concurrently once the round drains; non-retriable errors
            # abort the batch the moment they surface.
            group = rpc.CallGroup()
            waiting: List[int] = []
            failed: List[int] = []
            excs: List[Optional[rpc.RpcError]] = [None] * len(items)

            def _classify(i: int, e: rpc.RpcError) -> None:
                """Queue item i for the next re-fan round, or abort.
                Scheme-boundary errors abort immediately — the caller
                re-routes the remainder through the successor view.
                Exception: a READ answered EMIGRATING with sibling
                replicas untried is a REPLICA-level miss (a destination
                backup that lagged the cutover open), not a view-level
                one — try a sibling before declaring the view a miss."""
                s = items[i][0]
                if self._scheme_miss(e):
                    if read and e.code == resilience.EMIGRATING and \
                            len(tried[i]) < len(
                                view.replica_sets[s].addresses):
                        reroutes[i] += 1
                        excs[i] = e
                        failed.append(i)
                        return
                    raise e
                if not read and self._reroutable(view, s, e):
                    reroutes[i] += 1
                    if reroutes[i] <= \
                            len(view.replica_sets[s].addresses) + 1:
                        excs[i] = e
                        failed.append(i)
                        return
                    raise e
                policy = self.retry
                if policy is None or not policy.do_retry(e, attempts[i]):
                    raise e
                excs[i] = e
                failed.append(i)

            def _enqueue(i: int) -> None:
                pc = pending[i]
                if isinstance(pc, rpc.PendingCall):
                    group.add(pc)
                    waiting.append(i)
                else:   # start failure: already complete — classify now
                    e: rpc.RpcError = pc  # type: ignore[assignment]
                    pending[i] = None
                    _settle(i, pc, False, e.code)
                    _classify(i, e)

            for i in range(len(items)):
                _enqueue(i)
            while waiting or failed:
                while waiting:
                    group.wait_any()
                    done_i = next((i for i in waiting
                                   if pending[i].wait(0.0)), None)
                    if done_i is None:  # pragma: no cover — wait_any
                        continue
                    waiting.remove(done_i)
                    pc, pending[done_i] = pending[done_i], None
                    try:
                        rsp = pc.join()
                    except rpc.RpcError as e:
                        _settle(done_i, pc, False, e.code)
                        _classify(done_i, e)
                    else:
                        _settle(done_i, pc, True)
                        out[done_i] = rsp
                        if on_done is not None:
                            on_done(done_i, rsp)
                if not failed:
                    break
                # ---- concurrent re-fan of the failed subset: ONE
                # backoff sleep (the max of the round's delays, capped
                # by the remaining budget), then every failed shard
                # re-issues together and collects by completion order —
                # retry latency is max(shard), not sum(shard).
                refan, failed = failed, []
                round_delay = 0.0
                for i in refan:
                    s = items[i][0]
                    if self._scheme_miss(excs[i]) or (
                            not read
                            and self._reroutable(view, s, excs[i])):
                        continue   # routing correction: no backoff
                    # retry_delay_ms floors ELIMIT sheds (mandatory
                    # backoff — never re-fan straight into overload)
                    round_delay = max(round_delay,
                                      self.retry.retry_delay_ms(
                                          excs[i], attempts[i]))
                if deadline is not None:
                    remaining_ms = (deadline
                                    - time.monotonic()) * 1000.0
                    if remaining_ms < 2.0:
                        raise excs[refan[0]]  # type: ignore[misc]
                    round_delay = min(round_delay, remaining_ms - 1.0)
                if round_delay > 0:
                    resilience.sleep_ms(round_delay)
                for i in refan:
                    s, req = items[i]
                    if not (self._scheme_miss(excs[i])
                            or (not read and self._reroutable(
                                view, s, excs[i]))):
                        attempts[i] += 1
                        if obs.enabled():
                            obs.counter("rpc_retries").add(1)
                    _start(i, s, req)
                    _enqueue(i)
            return out  # type: ignore[return-value]
        except BaseException:
            # Aborted batch: the caller never sees `out`, so close any
            # already-collected IOBuf responses — the propagating
            # traceback pins this frame (and with it `out`), which
            # would otherwise hold the handles past the test/leak
            # ledger's horizon.  With on_done the caller owns delivered
            # responses and closes them itself.
            if on_done is None:
                for rsp in out:
                    if isinstance(rsp, rpc.IOBuf):
                        rsp.close()
            raise
        finally:
            if group is not None:
                group.close()
            # Partial failure: cancel the stragglers so close() reaps
            # them at cancel speed, not at their full timeout.
            for pc in pending:
                if isinstance(pc, rpc.PendingCall):
                    pc.cancel()
                    pc.close()

    def _call_shard(self, view: _SchemeView, s: int, method: str,
                    req: bytes) -> bytes:
        """Sequential-path shard call with the same per-shard policy
        (routed; a routing-correction error fails over once)."""
        deadline = time.monotonic() + self.deadline_ms / 1000.0 \
            if self.deadline_ms is not None else None
        addr = self._route_read(view, s) if method == "Lookup" \
            else self._route_write(view, s)
        stamped = self._stamp(req, deadline)
        try:
            return self._chan(addr).call(
                "Ps", method, stamped,
                retry=self.retry, deadline_ms=self.deadline_ms,
                backup_ms=self.backup_ms,
                breaker=self._addr_breaker(addr))
        except rpc.RpcError as e:
            if method != "Lookup" and not self._scheme_miss(e) and \
                    self._reroutable(view, s, e):
                addr = self._route_write(view, s, {addr})
                restamped = self._stamp(req, deadline)
                try:
                    return self._chan(addr).call(
                        "Ps", method, restamped,
                        retry=self.retry, deadline_ms=self.deadline_ms,
                        backup_ms=self.backup_ms,
                        breaker=self._addr_breaker(addr))
                finally:
                    self._close_stamped(req, restamped)
            raise
        finally:
            self._close_stamped(req, stamped)

    def _owner_split(self, view: _SchemeView, flat_ids: np.ndarray):
        if flat_ids.size and (flat_ids.min() < 0
                              or flat_ids.max() >= self.vocab):
            # An out-of-range id matches no shard: lookup() would otherwise
            # return uninitialized rows for it.
            raise ValueError(
                f"ids must be in [0, {self.vocab}); got "
                f"[{flat_ids.min()}, {flat_ids.max()}]"
            )
        if view.bounds is None:
            owners = flat_ids // view.rows_per
        else:
            # Explicit row-range map: bounds[s] <= id < bounds[s+1].
            owners = np.searchsorted(view.bounds, flat_ids,
                                     side="right") - 1
        for s in range(view.n):
            mask = owners == s
            if mask.any():
                yield s, np.nonzero(mask)[0], flat_ids[mask]

    def _read_views(self) -> List[_SchemeView]:
        """Read routing order: the weighted pick first (traffic share
        follows each scheme's live capacity weight — the dynpart load
        balancer's contract), then every other non-retired view newest
        first as FALLBACKS — a miss on the picked scheme (importing
        destination, dead retiring shard) re-runs the batch on the
        next view instead of failing the read."""
        with self._view_mu:
            views = [v for v in self._views if v.state != "retired"]
            self._read_seq += 1
            seq = self._read_seq
        order = sorted(views, key=lambda v: -v.version)
        if len(order) <= 1:
            return order
        # only ACTIVE schemes join the weighted pick; preparing (still
        # importing) and draining schemes serve as fallbacks only
        active = [v for v in order if v.state == "active"]
        total = sum(v.weight for v in active)
        if total <= 0:
            return order
        r = resilience._hash01(0x5EED, seq) * total
        pick = active[0]
        for v in active:
            if r < v.weight:
                pick = v
                break
            r -= v.weight
        return [pick] + [v for v in order if v is not pick]

    def _lookup_view(self, view: _SchemeView, flat: np.ndarray,
                     out: np.ndarray):
        """One whole-batch lookup under one scheme view.  Returns
        ``(bytes_out, bytes_in)``; raises on any shard miss (the caller
        falls back across schemes)."""
        nbytes_in = 0
        nbytes_out = 0
        zc = zerocopy_enabled()

        def _consume(rsp, owned):
            """Response rows as float32 — zero-copy for single-block
            IOBuf replies (one gather for multi-block), plain
            frombuffer for the bytes path."""
            if isinstance(rsp, rpc.IOBuf):
                try:
                    return np.frombuffer(rsp.as_memoryview(),
                                         np.float32).reshape(
                                             owned.size, self.dim)
                finally:
                    # A live view defers actual destruction; the rows
                    # are copied into `out` before the array dies.
                    rsp.close()
            return np.frombuffer(rsp, np.float32).reshape(
                owned.size, self.dim)

        if self.parallel:
            # Start every owner-shard call before joining any: the
            # shards serve concurrently and the batch pays max(shard),
            # not sum(shard).  _fan_out applies the per-shard
            # resilience policy (retry/hedge/breaker) and cancels
            # stragglers on an unrecoverable partial failure.
            split = list(self._owner_split(view, flat))
            items = []
            rsps: List[object] = []
            try:
                for s, positions, owned in split:
                    req = _pack_lookup_req_iobuf(owned) \
                        if zc and owned.nbytes >= _ZC_MIN_BYTES \
                        else _pack_lookup_req(owned)
                    nbytes_out += len(req)
                    items.append((s, req))
                rsps = self._fan_out(view, "Lookup", items)
                for (s, positions, owned), rsp in zip(split, rsps):
                    nbytes_in += len(rsp)
                    out[positions] = _consume(rsp, owned)
            finally:
                for _, req in items:
                    if isinstance(req, rpc.IOBuf):
                        req.close()
                # a consume interrupted mid-batch must not strand the
                # remaining response handles (close() is idempotent)
                for rsp in rsps:
                    if isinstance(rsp, rpc.IOBuf):
                        rsp.close()
        else:
            for s, positions, owned in self._owner_split(view, flat):
                req = _pack_lookup_req_iobuf(owned) \
                    if zc and owned.nbytes >= _ZC_MIN_BYTES \
                    else _pack_lookup_req(owned)
                nbytes_out += len(req)
                try:
                    rsp = self._call_shard(view, s, "Lookup", req)
                finally:
                    if isinstance(req, rpc.IOBuf):
                        req.close()
                nbytes_in += len(rsp)
                out[positions] = _consume(rsp, owned)
        return nbytes_out, nbytes_in

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        rec = obs.enabled()
        if rec:
            t0 = time.monotonic_ns()
        flat = np.asarray(ids, np.int32).reshape(-1)
        out = np.empty((flat.size, self.dim), np.float32)
        # Dual-scheme reads: weighted pick, then fall back across the
        # remaining schemes on ANY failure — during a live reshard the
        # other scheme holds the same rows (an importing destination
        # answers EMIGRATING; a draining scheme's tables are frozen at
        # exactly the cutover state, so its answers stay correct).
        views = self._read_views()
        nbytes_out = nbytes_in = 0
        for i, view in enumerate(views):
            try:
                nbytes_out, nbytes_in = self._lookup_view(view, flat,
                                                          out)
                break
            except rpc.RpcError:
                if i + 1 >= len(views):
                    raise
                if obs.enabled():
                    obs.counter("ps_scheme_fallback_reads").add(1)
        if rec:
            # Whole-batch latency across all owner shards (each per-shard
            # RPC is additionally recorded by Channel.call/call_async).
            obs.recorder("ps_client_lookup").record(
                (time.monotonic_ns() - t0) / 1e9)
            obs.counter("ps_client_lookup_keys").add(int(flat.size))
            obs.counter("ps_client_bytes_out").add(nbytes_out)
            obs.counter("ps_client_bytes_in").add(nbytes_in)
        return out.reshape(*np.shape(ids), self.dim)

    def _apply_unit(self, view: _SchemeView, uids: np.ndarray,
                    ugrads: np.ndarray, guards: tuple) -> int:
        """Apply one write unit (global ids + grads + scheme guards)
        under ``view`` via idempotent ``ApplyGradId`` items, one per
        owner shard.  Returns bytes sent.  A scheme boundary raises
        :class:`_SchemeMovedError` carrying the UNAPPLIED remainder —
        each unacked item becomes a unit whose guard chain grows by its
        own (writer key, seq), so re-routing it through the successor
        scheme can never double-apply content that already migrated."""
        split = list(self._owner_split(view, uids))
        items = []
        meta = []
        nbytes = 0
        for s, positions, owned in split:
            wkey = self._unary_writer_key(view, s)
            seq = view.useq.get(s, 0) + 1
            view.useq[s] = seq
            item_guards = guards + ((wkey, seq),)
            req = bytes(_pack_apply_id_req(wkey, seq, guards, owned,
                                           ugrads[positions]))
            nbytes += len(req)
            items.append((s, req))
            meta.append((owned, ugrads[positions], item_guards))
        done: List[Optional[bytes]] = [None] * len(items)

        def _on_done(i: int, rsp) -> None:
            done[i] = rsp
            self._note_acked_gen(view, items[i][0], rsp)

        try:
            if self.parallel:
                self._fan_out(view, "ApplyGradId", items,
                              on_done=_on_done)
            else:
                for i, (s, req) in enumerate(items):
                    _on_done(i, self._call_shard(view, s, "ApplyGradId",
                                                 req))
        except rpc.RpcError as e:
            if not self._scheme_miss(e):
                raise
            remainder = [(meta[i][0], meta[i][1], meta[i][2])
                         for i in range(len(items)) if done[i] is None]
            raise _SchemeMovedError(e.code, remainder) from e
        return nbytes

    def _apply_units(self, units: List[tuple]) -> int:
        """Drive write units to completion across scheme moves: a unit
        interrupted by a cutover re-splits through the refreshed write
        view (guard chain intact), an EMIGRATING unit waits out the
        fence→open window with bounded backoff.  Units issue
        SEQUENTIALLY so per-(scheme, shard) seqs stay in arrival order
        (one batch normally is one unit — the fan-out inside it is
        still concurrent)."""
        nbytes = 0
        moves = 0
        backoff = resilience.Backoff(base_ms=5.0, max_ms=100.0)
        queue = list(units)
        while queue:
            view = self._write_view()
            uids, ugrads, guards = queue[0]
            try:
                nbytes += self._apply_unit(view, uids, ugrads, guards)
            except _SchemeMovedError as e:
                moves += 1
                if moves > 16:
                    raise rpc.RpcError(
                        e.code, "write could not settle across the "
                                "scheme cutover (16 rounds)") from e
                queue[0:1] = e.remainder
                if e.code == resilience.ESCHEMEMOVED:
                    if obs.enabled():
                        obs.counter("ps_scheme_moved_writes").add(1)
                    self._on_stale_scheme(view, e.__cause__ or e)
                else:
                    # cutover window: destinations fenced open shortly
                    resilience.sleep_ms(backoff.delay_ms(min(moves, 6)))
                continue
            queue.pop(0)
        return nbytes

    def apply_gradients(self, ids: np.ndarray, grads: np.ndarray) -> None:
        rec = obs.enabled()
        if rec:
            t0 = time.monotonic_ns()
        flat = np.asarray(ids, np.int32).reshape(-1)
        g = np.asarray(grads, np.float32).reshape(flat.size, self.dim)
        nbytes_out = self._apply_units([(flat, g, ())])
        if rec:
            obs.recorder("ps_client_apply").record(
                (time.monotonic_ns() - t0) / 1e9)
            obs.counter("ps_client_apply_keys").add(int(flat.size))
            obs.counter("ps_client_bytes_out").add(nbytes_out)

    # -- streaming gradient push (the write-path mirror of the native
    # -- read path: framed deltas over one ordered flow-controlled
    # -- stream per owner shard, feeding the server combiner directly)

    def _push_stream(self, view: _SchemeView, s: int,
                     exclude=frozenset()) -> "rpc.Stream":
        st = self._push_streams.get(s)
        if st is None:
            addr = self._route_write(view, s, exclude)
            # The setup request carries the writer key (scheme- and
            # shard-qualified): the server opens (or re-opens) this
            # writer's monotonic seq window and answers its high-water
            # mark — the replay cursor.  The receiver is the fence
            # channel: a primary demoted (or scheme-fenced) while this
            # stream is up notifies instead of silently dropping.
            recv = _PushStreamReceiver()
            st = self._chan(addr).stream(
                "Ps", "StreamApply",
                self._stream_writer_key(view, s).encode(),
                max_buf_size=self.push_window_bytes, receiver=recv)
            self._push_streams[s] = st
            self._push_addr[s] = addr
            self._push_recv[s] = recv
            high = 0
            if len(st.response) >= 8:
                (high,) = struct.unpack_from("<q", st.response, 0)
            self._push_sent[s] = high
            if obs.enabled():
                # frames this server already holds (the write that
                # "failed" reached it before the break) are not resent
                nskip = sum(1 for q, _ in self._push_unacked.get(s, ())
                            if q <= high)
                if nskip:
                    obs.counter("ps_stream_replay_skips").add(nskip)
        return st

    def _drop_push_stream(self, s: int) -> Optional[str]:
        """Tear down shard ``s``'s push stream state (reconnect/error
        path).  Returns the address it was bound to, if any."""
        st = self._push_streams.pop(s, None)
        if st is not None:
            # rx stream: close, never abort (the closed callback is
            # what frees the native read relay)
            st.close()
        self._push_recv.pop(s, None)
        self._push_sent.pop(s, None)
        return self._push_addr.pop(s, None)

    def _fence_code(self, recv) -> int:
        return resilience.ESCHEMEMOVED \
            if recv is not None and recv.scheme_moved \
            else resilience.ENOTPRIMARY

    def _push_frames(self, view: _SchemeView, s: int) -> None:
        """Write every unacked frame past the replay cursor to shard
        ``s``'s push stream, RECONNECTING under the embedding's retry
        policy on error: the broken stream is torn down, a fresh one is
        created (the setup RPC pays the shard's real state — timeouts
        included), and the unacked TAIL above the server's high-water
        mark is replayed on it.  The per-writer seq in every frame makes
        replay IDEMPOTENT (the server's window drops anything at or
        below its mark), and because the window a promoted backup
        inherits covers exactly the frames whose data it holds, the same
        replay is also LOSSLESS across failover.  A failed or demoted
        primary re-routes: ENOTPRIMARY/EFENCED (including the fence
        notification on the stream's reply half) fails over immediately;
        a dead endpoint is excluded from the reconnect's routing
        (redirect mode).  A SCHEME fence (cutover) raises ESCHEMEMOVED
        to the caller — the unacked window transfers to the successor
        scheme instead of replaying here."""
        attempt = 0
        fails = 0
        exclude: set = set()
        while True:
            try:
                st = self._push_stream(view, s, exclude)
                recv = self._push_recv.get(s)
                sent = self._push_sent.get(s, 0)
                frames = self._push_unacked.get(s, [])
                # seqs are contiguous per shard: the unsent tail starts
                # right past the cursor
                start = max(0, sent - frames[0][0] + 1) if frames else 0
                if zerocopy_enabled():
                    # Batched zero-copy replay: every eligible frame in
                    # ONE native crossing (header blocks owned, bodies
                    # borrowed).  The fence check moves to batch
                    # granularity — a fence landing mid-batch is the
                    # same race the per-frame path had between check
                    # and write.
                    if recv is not None and recv.fenced:
                        raise rpc.RpcError(
                            self._fence_code(recv),
                            f"shard {s} push stream fenced")
                    seqs = []
                    batch = []
                    try:
                        for seq, body in frames[start:]:
                            if seq <= sent:
                                continue
                            seqs.append(seq)
                            batch.append(
                                _pack_stream_frame_iobuf(seq, 0, 0,
                                                         body))
                        if batch:
                            try:
                                st.writev(batch)
                            except rpc.RpcError as e:
                                nw = getattr(e, "frames_written", 0)
                                if nw:
                                    # frames before the break ARE on
                                    # the wire: advance the cursor so
                                    # the reconnect replays the tail
                                    self._push_sent[s] = sent = \
                                        seqs[nw - 1]
                                raise
                            self._push_sent[s] = sent = seqs[-1]
                    finally:
                        for io in batch:
                            io.close()
                else:
                    for seq, body in frames[start:]:
                        if recv is not None and recv.fenced:
                            raise rpc.RpcError(
                                self._fence_code(recv),
                                f"shard {s} push stream fenced")
                        if seq <= sent:
                            continue
                        st.write(_pack_stream_frame(seq, 0, 0, body))
                        self._push_sent[s] = sent = seq
                if recv is not None and recv.fenced:
                    raise rpc.RpcError(
                        self._fence_code(recv),
                        f"shard {s} push stream fenced")
                return
            except rpc.RpcError as e:
                addr = self._drop_push_stream(s)
                if e.code == resilience.ESCHEMEMOVED:
                    raise   # cutover: the caller transfers the window
                rs = view.replica_sets[s]
                if self._reroutable(view, s, e):
                    fails += 1
                    if fails > len(rs.addresses) + 1:
                        raise
                    self._failover(view, s)
                    continue
                policy = self.retry
                # Stream breakage (EPIPE/EINVAL/EFAILEDSOCKET) means
                # reconnect regardless of the unary retriable set; an
                # EMIGRATING destination (cutover still opening) also
                # retries under the same budget.  The policy still owns
                # the ATTEMPT budget and backoff.
                reconnectable = e.code in (32, 22, 1009,
                                           resilience.EMIGRATING) or \
                    (policy is not None and
                     e.code in policy.retriable)
                if policy is None or not reconnectable or \
                        not attempt + 1 < policy.max_attempts:
                    raise
                if addr is not None and len(rs.addresses) > 1 \
                        and self._redirect:
                    exclude.add(addr)   # prefer a surviving replica
                if obs.enabled():
                    obs.counter("ps_stream_reconnects").add(1)
                resilience.sleep_ms(policy.backoff.delay_ms(attempt))
                attempt += 1

    def push_gradients(self, ids: np.ndarray, grads: np.ndarray) -> None:
        """Streaming gradient push: ships this batch's per-owner-shard
        deltas as ONE framed message per shard over a persistent
        ordered stream (opened lazily, kept across batches) — no unary
        dispatch/response per apply, and a shard whose combiner falls
        behind back-pressures THIS call through the stream's
        flow-control window (``push_window_bytes``;
        ``stream_stall_ms`` counts the stalls).  Fire-and-forget:
        application is guaranteed only after :meth:`flush_gradients`.
        Requires shards serving ``StreamApply``
        (``PsShardServer(stream=True)``); the unary
        :meth:`apply_gradients` remains the synchronous/fallback path.

        Across a live reshard: a cutover fence (``ESCHEMEMOVED``, as a
        setup rejection or a -2 fence frame) transfers the ENTIRE
        unacked window — this batch included — onto the successor
        scheme as guarded unary writes (exactly-once either side of the
        boundary), after which pushes stream to the new shards."""
        rec = obs.enabled()
        if rec:
            t0 = time.monotonic_ns()
        flat = np.asarray(ids, np.int32).reshape(-1)
        g = np.asarray(grads, np.float32).reshape(flat.size, self.dim)
        view = self._write_view()
        nbytes_out = 0
        shards = []
        # Frame every owner shard FIRST: a scheme fence hit while
        # writing shard k must transfer the whole batch, not a prefix.
        for s, positions, owned in self._owner_split(view, flat):
            body = bytes(_pack_apply_req(owned, g[positions]))
            nbytes_out += len(body)
            seq = self._push_seq.get(s, 0) + 1
            self._push_seq[s] = seq
            # Unacked until the flush barrier confirms: the window is
            # what a mid-push failover replays onto the new primary.
            self._push_unacked.setdefault(s, []).append((seq, body))
            shards.append(s)
        try:
            for s in shards:
                self._push_frames(view, s)
        except rpc.RpcError as e:
            if e.code != resilience.ESCHEMEMOVED:
                raise
            self._transfer_pushes(view, None)
        if rec:
            obs.recorder("ps_client_push").record(
                (time.monotonic_ns() - t0) / 1e9)
            obs.counter("ps_client_push_keys").add(int(flat.size))
            obs.counter("ps_client_bytes_out").add(nbytes_out)

    def _transfer_pushes(self, old_view: _SchemeView,
                         new_view: Optional[_SchemeView]) -> None:
        """Carry the unacked push window across a scheme boundary: for
        every shard, ask the OLD primary's applied window (WriterSeq —
        a scheme-fenced primary still answers; its data is frozen and
        complete) and drop the acked prefix; whatever remains — or the
        whole window when the old primary is unreachable — re-routes
        through the successor scheme as GUARDED unary writes: each
        frame's guard names its (stream writer key, seq), and the
        destinations inherited the old windows with the migrated rows,
        so a frame that DID land (and migrated) is dropped server-side
        while a frame that died with the fence applies exactly once.

        FAILURE SAFETY: the unacked window is consumed only once a
        successor view is known, and the transfer units re-stash into
        ``_push_carry`` if applying them fails partway — either way a
        later :meth:`flush_gradients` still holds (and must drain) the
        full window, so a failed transfer can never turn into a
        vacuously successful flush over dropped deltas."""
        # The fenced streams are dead either way; the unacked WINDOW is
        # the source of truth and must survive any failure below.
        for s in list(self._push_streams):
            self._drop_push_stream(s)
        if new_view is None:
            # Resolve a successor BEFORE consuming the window: with no
            # discovery path this raises (window intact — the caller
            # retries once a successor is published).
            self._on_stale_scheme(
                old_view, rpc.RpcError(
                    resilience.ESCHEMEMOVED,
                    f"scheme v{old_view.version} fenced with no known "
                    f"successor"))
        # units from a PREVIOUS failed transfer re-drive first (guards
        # keep them exactly-once)
        tails: List[tuple] = self._push_carry   # (ids, grads, guards)
        self._push_carry = []
        for s, frames in sorted(self._push_unacked.items()):
            if not frames:
                continue
            wkey = self._stream_writer_key(old_view, s)
            applied = None
            try:
                rs = old_view.replica_sets[s]
                addr = rs.addresses[old_view._primary_idx[s]]
                rsp = self._chan(addr).call(
                    "Ps", "WriterSeq", wkey.encode(),
                    timeout_ms=self._ctl_timeout_ms())
                applied = struct.unpack_from("<qq", rsp, 0)[0]
            except rpc.RpcError:
                applied = None   # unreachable: transfer guarded, blind
            for seq, body in frames:
                if applied is not None and seq <= applied:
                    continue
                # our own unacked window, but the same guarded parse as
                # the servers — a corrupt stash must fail loudly, not
                # re-split garbage through numpy's count=-1 semantics
                (count,) = wire.read("<i", body, 0, "transfer.count")
                wire.check_count(count,
                                 (len(body) - 4) // (4 + 4 * self.dim),
                                 "transfer.count")
                gids = np.frombuffer(body, np.int32, count, 4)
                grads = np.frombuffer(
                    body, np.float32, count * self.dim,
                    4 + 4 * count).reshape(count, self.dim)
                tails.append((gids, grads, ((wkey, seq),)))
        self._push_unacked.clear()
        self._push_seq.clear()
        self._push_sent.clear()
        if tails:
            if obs.enabled():
                obs.counter("ps_push_transfers").add(len(tails))
            try:
                self._apply_units(tails)
            except BaseException:
                # Re-stash the WHOLE batch (applied units are dropped
                # server-side by their guards) so the next flush
                # re-drives it instead of succeeding over a hole.
                self._push_carry = tails
                raise

    def flush_gradients(self) -> None:
        """Closes every push stream and waits until each shard has
        consumed AND applied everything pushed so far (the server
        flushes its combiner before answering the close).  On a
        REPLICATED shard the close barrier alone is not trusted: a
        primary demoted mid-stream drops frames, so the barrier then
        verifies the CURRENT primary's applied window covers the last
        pushed seq, replaying the unacked tail (failover included) on a
        shortfall — a flush that returns means every pushed delta is
        applied on the live primary and its synced backups; a flush
        that cannot prove it raises.  A scheme CUTOVER racing the flush
        transfers the unacked window to the successor scheme instead
        (guarded — exactly-once).  The next :meth:`push_gradients`
        opens fresh streams.  Raises :class:`rpc.RpcError`
        (ERPCTIMEDOUT) if a shard fails to drain within the embedding's
        timeout."""
        view = self._wv
        streams, self._push_streams = self._push_streams, {}
        push_addr, self._push_addr = self._push_addr, {}
        recvs, self._push_recv = self._push_recv, {}
        self._push_sent.clear()
        for st in streams.values():
            st.close()
        deadline_s = max(1.0, self.timeout_ms / 1000.0)
        moved = any(r.scheme_moved for r in recvs.values())
        for s, st in streams.items():
            drained = st.join(timeout_s=deadline_s)
            replicated = len(view.replica_sets[s].addresses) > 1
            if not drained and not replicated and not moved:
                raise rpc.RpcError(
                    1008, f"shard {s} ({push_addr.get(s, '?')}) did not "
                          f"drain its push stream within {deadline_s:.1f}s")
            # a wedged/fenced stream is recovered below — the verify
            # barrier replays onto the live primary / successor scheme
        if moved:
            self._transfer_pushes(view, None)
            return
        for s in sorted(set(streams) | set(self._push_unacked)):
            # EVERY pushed shard verifies the applied window — the
            # close barrier alone cannot be trusted even unreplicated:
            # a scheme fence racing the close drops frames server-side
            # and its -2 notification can land after the client's full
            # close (discarded); the WriterSeq shortfall is what
            # reliably routes the tail to the successor scheme.  Shards
            # holding unacked frames with NO live stream (a transfer
            # that failed before consuming the window) verify too —
            # their replay is what re-drives the stranded window.
            self._confirm_push(view, s)
            self._push_unacked.pop(s, None)
        self._drain_carry()

    def _drain_carry(self) -> None:
        """Re-drive transfer units stranded by a FAILED scheme-boundary
        transfer.  Part of the flush barrier: a flush may only report
        success once the carry is empty (the guards make a re-drive of
        already-applied units exactly-once)."""
        if not self._push_carry:
            return
        tails, self._push_carry = self._push_carry, []
        try:
            self._apply_units(tails)
        except BaseException:
            self._push_carry = tails
            raise

    def _confirm_push(self, view: _SchemeView, s: int) -> None:
        """The zero-lost-acked half of the push barrier on a replicated
        shard: the CURRENT primary's applied window for this writer must
        reach the last pushed seq.  A shortfall means frames died with a
        demoted primary — replay the unacked tail (the reconnect routes
        through failover) and run the close barrier again.  Raises when
        the window cannot be confirmed within the retry budget; the
        caller's push window stays intact for a later retry.  A scheme
        cutover discovered here transfers the window instead."""
        last = self._push_seq.get(s, 0)
        if not last:
            return
        wkey = self._stream_writer_key(view, s)
        policy = self.retry
        rounds = max(2, policy.max_attempts if policy is not None else 2)
        err: Optional[rpc.RpcError] = None
        for _ in range(rounds):
            addr = None
            try:
                addr = self._route_write(view, s)
                rsp = self._chan(addr).call(
                    "Ps", "WriterSeq", wkey.encode(),
                    timeout_ms=self._ctl_timeout_ms())
            except rpc.RpcError as e:
                err = e
                if e.code == resilience.ESCHEMEMOVED:
                    self._transfer_pushes(view, None)
                    return
                if len(view.replica_sets[s].addresses) > 1 and \
                        self._redirect:
                    # demoted (reroutable) or dead primary: re-resolve;
                    # a dead endpoint is excluded from the sweep
                    exclude = frozenset()
                    if addr is not None and \
                            not self._reroutable(view, s, e):
                        exclude = frozenset({addr})
                    self._failover(view, s, exclude)
                    continue
                raise
            applied, gen = struct.unpack_from("<qq", rsp, 0)
            if applied >= last:
                # confirmed on the live primary — NOW the covering gen
                # is an acked floor for the lossy-promotion guard
                if gen > view._gen_seen[s]:
                    view._gen_seen[s] = gen
                return
            if obs.enabled():
                obs.counter("ps_push_replays").add(1)
            err = rpc.RpcError(
                resilience.ENOTPRIMARY,
                f"shard {s}: applied window {applied} < last pushed "
                f"seq {last} after the close barrier")
            try:
                self._push_frames(view, s)   # replay tail, failover-aware
            except rpc.RpcError as e:
                if e.code != resilience.ESCHEMEMOVED:
                    raise
                self._transfer_pushes(view, None)
                return
            st = self._push_streams.pop(s, None)
            self._push_addr.pop(s, None)
            self._push_recv.pop(s, None)
            self._push_sent.pop(s, None)
            if st is not None:
                st.close()
                st.join(timeout_s=max(1.0, self.timeout_ms / 1000.0))
        raise err  # type: ignore[misc]

    def close(self):
        if self._watcher is not None:
            self._watcher.stop()
            self._watcher = None
        if self._prober is not None:
            self._prober.stop()
            self._prober = None
        for st in self._push_streams.values():
            # Teardown, not a flush barrier — callers wanting the
            # guarantee use flush_gradients() first.  close(), not
            # abort(): these carry a read half whose native relay is
            # freed by the close handshake.
            st.close()
        self._push_streams.clear()
        self._push_addr.clear()
        self._push_recv.clear()
        self._push_sent.clear()
        self._push_unacked.clear()
        self._push_carry.clear()
        for c in self._chans.values():
            c.close()
        self._chans.clear()
