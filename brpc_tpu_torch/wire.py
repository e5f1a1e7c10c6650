"""Wire contracts: the declarative frame-schema registry for the PS
fabric's hand-rolled framings.

Every binary framing that crosses the wire — Lookup/ApplyGrad requests,
the stream frame header, writer-seq windows, ``ApplyGradId`` with its
guards, replication ``Sync``, the migration handoff payloads — is
declared here ONCE as named fields with explicit type, width and
endianness, plus the length-prefix relationships between them.  The
hand-rolled ``_pack_*``/``_unpack_*`` sites in ``ps_remote.py`` /
``reshard.py`` stay (they are the measured hot path), but they are no
longer the only statement of the format:

- the ``wire-contract`` lint check (:mod:`brpc_tpu.analysis.lint`)
  cross-checks every registered site's struct format strings against
  the schema it claims to implement, flags pack/unpack drift, and flags
  count/length reads on parse paths that never reach a bounds check;
- the structure-aware fuzzer (:mod:`brpc_tpu.analysis.fuzz`) derives
  its mutation points (field boundaries, length fields, string fields)
  from the same schemas, so every declared framing is fuzzed;
- :func:`FrameSchema.pack`/:func:`FrameSchema.unpack` are the reference
  implementations the hand-rolled sites are tested against
  (``tests/test_wire.py`` parity tests).

The guard helpers (:func:`need`, :func:`check_count`, :func:`read`) are
the sanctioned bounds-validation vocabulary: hostile input must raise
:class:`WireError` — a clean, non-retriable ``EBADFRAME`` on the wire —
before any unbounded allocation, loop, or table mutation.  The
reference framework treats every protocol parser as hostile-input
surface and fuzzes each one (SURVEY §2.5, §4); this module is the
contract those fuzzers and lints enforce.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "EBADFRAME", "WireError", "need", "check_count", "read",
    "Int", "Bytes", "Array", "Group", "Tail", "FrameSchema",
    "REGISTRY", "TEXT_PARSERS", "schema",
]

#: error code for a malformed frame rejected by a wire-contract guard
#: (outside the native errors.h space, beside EBREAKEROPEN..ESCHEMEMOVED
#: in :mod:`brpc_tpu_torch.resilience`).  Never retriable: the same bytes
#: parse the same way twice.
EBADFRAME = 2013

#: absolute sanity cap on any wire count field — no legitimate frame in
#: this fabric carries more elements than this, and every parse-path
#: bound is additionally clamped by the bytes actually present.
MAX_WIRE_COUNT = 1 << 24

#: first-int32 sentinel of the optional deadline header
#: (schema ``deadline_hdr``): > MAX_WIRE_COUNT, so no legitimate count
#: or length field of any data-plane framing can collide with it — a
#: request starting with this value carries a 12-byte deadline prefix,
#: anything else is the bare legacy framing.  The native Lookup parser
#: (cpp/capi/ps_shard.cc) tests the same constant.
DEADLINE_MAGIC = 0x7EAD11E5

#: first-int32 sentinel of the v2 deadline header (schema
#: ``deadline_hdr_v2``): RELATIVE budget + server-side arrival stamp —
#: drops the same-host/NTP wall-clock assumption of the absolute form.
#: Also above MAX_WIRE_COUNT, and tested by the native Lookup parser.
DEADLINE_MAGIC2 = 0x7EAD11E6

#: first-int32 sentinel of a press trace file ("PRS1" little-endian,
#: schema ``press_header``)
PRESS_MAGIC = 0x31535250

#: first-int32 sentinel of a checkpoint base snapshot file ("SNAP"
#: little-endian, schema ``ckpt_snap``).  Like the deadline magics it
#: sits above MAX_WIRE_COUNT, so no legitimate count field collides.
CKPT_SNAP_MAGIC = 0x50414E53

#: first-int32 sentinel of one delta-log record ("DLT1" little-endian,
#: schema ``ckpt_delta``)
CKPT_DELTA_MAGIC = 0x31544C44

#: first-int32 sentinel of the compaction marker file ("CMK1"
#: little-endian, schema ``ckpt_marker``)
CKPT_MARKER_MAGIC = 0x314B4D43


class WireError(ValueError):
    """Malformed frame, rejected by a bounds/validity check BEFORE any
    allocation or state mutation.  Carries :data:`EBADFRAME` so the
    server trampoline answers a clean, non-retriable code (the
    ``_error_code_of`` contract in :mod:`brpc_tpu_torch.rpc`)."""

    code = EBADFRAME


def need(payload, offset: int, nbytes: int, what: str = "frame") -> None:
    """The span guard: ``payload`` must hold ``nbytes`` at ``offset``."""
    if offset < 0 or nbytes < 0 or len(payload) - offset < nbytes:
        raise WireError(
            f"{what}: need {nbytes} byte(s) at offset {offset}, have "
            f"{len(payload)} total")


def check_count(count: int, limit: int, what: str = "count") -> int:
    """The count guard: a wire count must be non-negative and bounded by
    what the payload can actually carry (``limit`` is the caller's
    bytes-derived cap).  Returns ``count`` so guards chain inline.
    A negative count is ALWAYS hostile — numpy's ``frombuffer`` treats
    ``count=-1`` as "read everything", silently re-interpreting the
    whole payload."""
    if not 0 <= count <= min(limit, MAX_WIRE_COUNT):
        raise WireError(
            f"{what} {count} outside [0, {min(limit, MAX_WIRE_COUNT)}]")
    return count


def _sizeof(fmt: str) -> int:
    # struct caches compiled formats internally (and is C-thread-safe),
    # so no hand cache is needed on this handler-reachable path
    return struct.calcsize(fmt)


def read(fmt: str, payload, offset: int = 0,
         what: str = "frame") -> tuple:
    """Guarded ``struct.unpack_from``: raises :class:`WireError` (not
    ``struct.error``) when the payload is shorter than the format — the
    drop-in for control-plane header reads."""
    need(payload, offset, _sizeof(fmt), what)
    return struct.unpack_from(fmt, payload, offset)


# ---------------------------------------------------------------------------
# field model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Int:
    """One fixed-width little-endian integer (``fmt`` is ``"<i"`` or
    ``"<q"``)."""

    name: str
    fmt: str = "<q"


@dataclasses.dataclass(frozen=True)
class Bytes:
    """A length-prefixed byte string; ``length`` names the earlier
    :class:`Int` field carrying its byte length."""

    name: str
    length: str


@dataclasses.dataclass(frozen=True)
class Array:
    """A packed scalar array tail; element count is ``count_field *
    mult`` where ``mult`` is a literal or the symbolic ``"dim"``
    (resolved at pack/unpack time — the embedding width is serving
    geometry, not wire data)."""

    name: str
    dtype: str          # numpy dtype string, e.g. "<i4" / "<f4"
    count: str          # name of the Int field holding the element count
    mult: object = 1    # int, or "dim"


@dataclasses.dataclass(frozen=True)
class Group:
    """``count`` repetitions of a record of scalar/bytes fields."""

    name: str
    count: str          # name of the Int field holding the repeat count
    fields: Tuple = ()


@dataclasses.dataclass(frozen=True)
class Tail:
    """The rest of the payload, opaque at this level; ``schema`` names
    the nested :class:`FrameSchema` when the tail is itself framed."""

    name: str
    schema: str = ""


def _group_min_entry(g: Group) -> int:
    """Smallest possible wire size of one group entry (empty strings)."""
    total = 0
    for f in g.fields:
        if isinstance(f, Int):
            total += _sizeof(f.fmt)
    return max(total, 1)


# ---------------------------------------------------------------------------
# the schema object
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FrameSchema:
    """One framing, declared once.  ``pack_sites``/``unpack_sites`` are
    the in-tree functions implementing it by hand (qualnames relative to
    ``brpc_tpu``: ``"ps_remote._pack_windows"``); ``exact_sites`` are
    the dedicated single-purpose functions whose struct-format stream
    must EXACTLY equal this schema's scalar sequence (shared multi-frame
    functions are checked by in-order subsequence instead).
    ``native_sites`` documents native-side consumers (cpp paths) — they
    satisfy the pairing requirement without a Python unpack site, and
    the cross-language tier (``analysis.native``) checks each one's C++
    read sequence against this schema.  ``segments`` upgrades a shared
    multi-frame site from subsequence to EXACT matching: each entry maps
    a site qualname to the dispatch-discriminant keys
    (``("ps_remote.PsShardServer._serve_control", ("Sync",))`` means
    "inside the ``method == \"Sync\"`` branch the stream must equal this
    schema exactly").  ``prebranch`` declares, per segmented site, the
    format stream of the SHARED header the handler reads before (i.e.
    outside) its dispatch branches — ``("ps_remote.PsShardServer._serve",
    "i")`` says "one int32 is read pre-branch"; the lint prepends it to
    the keyed branch's stream for the exact comparison and flags a
    declaration that drifts from the actual shared reads.
    ``response=True`` marks server→client response
    frames whose client consumer is trusted/optional — unpaired is
    explained, not flagged."""

    name: str
    fields: Tuple
    doc: str = ""
    pack_sites: Tuple[str, ...] = ()
    unpack_sites: Tuple[str, ...] = ()
    exact_sites: Tuple[str, ...] = ()
    native_sites: Tuple[str, ...] = ()
    segments: Tuple[Tuple[str, Tuple[str, ...]], ...] = ()
    prebranch: Tuple[Tuple[str, str], ...] = ()
    response: bool = False

    # -- derived ----------------------------------------------------------

    def scalar_formats(self) -> List[str]:
        """The ordered scalar struct-format characters this schema puts
        on the wire (group records contribute one iteration) — what the
        lint matches against a site's extracted format stream."""
        out: List[str] = []

        def walk(fields: Sequence) -> None:
            for f in fields:
                if isinstance(f, Int):
                    out.append(f.fmt.lstrip("<>=!@"))
                elif isinstance(f, Group):
                    walk(f.fields)

        walk(self.fields)
        return out

    def _mult(self, f: Array, dim: int) -> int:
        return dim if f.mult == "dim" else int(f.mult)

    # -- reference implementations ---------------------------------------

    def pack(self, values: Dict[str, object], *, dim: int = 1) -> bytes:
        """Reference packer: builds the frame from a field-value dict
        (ints by name; ``Bytes`` as bytes — their length fields are
        derived; ``Group`` as a list of per-entry dicts — the count
        field is derived; ``Array`` as a numpy array or bytes; ``Tail``
        as bytes)."""
        parts: List[bytes] = []
        self._pack_into(self.fields, values, parts, dim)
        return b"".join(parts)

    def _pack_into(self, fields: Sequence, values: Dict[str, object],
                   parts: List[bytes], dim: int) -> None:
        derived: Dict[str, int] = {}
        for f in fields:
            if isinstance(f, Bytes):
                derived.setdefault(f.length, len(values[f.name]))
            elif isinstance(f, Group):
                derived.setdefault(f.count, len(values[f.name]))
            elif isinstance(f, Array):
                arr = np.asarray(values[f.name])
                mult = self._mult(f, dim)
                derived.setdefault(f.count, arr.size // max(mult, 1))
        for f in fields:
            if isinstance(f, Int):
                val = values.get(f.name, derived.get(f.name, 0))
                parts.append(struct.pack(f.fmt, int(val)))
            elif isinstance(f, Bytes):
                parts.append(bytes(values[f.name]))
            elif isinstance(f, Array):
                arr = np.asarray(values[f.name]).astype(
                    np.dtype(f.dtype), copy=False)
                parts.append(arr.tobytes())
            elif isinstance(f, Group):
                for entry in values[f.name]:
                    self._pack_into(f.fields, entry, parts, dim)
            elif isinstance(f, Tail):
                parts.append(bytes(values.get(f.name, b"")))

    def unpack(self, payload, *, offset: int = 0,
               dim: int = 1) -> Tuple[Dict[str, object], int]:
        """Reference parser: fully guarded — every length/count is
        bounds-checked against the bytes present before it drives an
        allocation or loop.  Returns ``(values, end_offset)``."""
        values, off = self._unpack_from(self.fields, payload, offset,
                                        dim, self.name)
        return values, off

    def _unpack_from(self, fields: Sequence, payload, off: int,
                     dim: int, what: str
                     ) -> Tuple[Dict[str, object], int]:
        values: Dict[str, object] = {}
        for f in fields:
            if isinstance(f, Int):
                (values[f.name],) = read(f.fmt, payload, off,
                                         f"{what}.{f.name}")
                off += _sizeof(f.fmt)
            elif isinstance(f, Bytes):
                ln = check_count(int(values[f.length]),
                                 len(payload) - off,
                                 f"{what}.{f.length}")
                values[f.name] = bytes(payload[off:off + ln])
                off += ln
            elif isinstance(f, Array):
                mult = self._mult(f, dim)
                dt = np.dtype(f.dtype)
                n = check_count(int(values[f.count]),
                                (len(payload) - off) //
                                max(dt.itemsize * max(mult, 1), 1),
                                f"{what}.{f.count}") * mult
                values[f.name] = np.frombuffer(payload, dt, n, off)
                off += n * dt.itemsize
            elif isinstance(f, Group):
                cnt = check_count(int(values[f.count]),
                                  (len(payload) - off) //
                                  _group_min_entry(f),
                                  f"{what}.{f.count}")
                entries = []
                for _ in range(cnt):
                    entry, off = self._unpack_from(f.fields, payload,
                                                   off, dim,
                                                   f"{what}.{f.name}")
                    entries.append(entry)
                values[f.name] = entries
            elif isinstance(f, Tail):
                values[f.name] = bytes(payload[off:])
                off = len(payload)
        return values, off

    # -- fuzzing support --------------------------------------------------

    def example(self, rng, *, dim: int = 4) -> Dict[str, object]:
        """A small valid value dict, deterministic under ``rng`` (a
        ``random.Random``) — the fuzzer's mutation baseline."""
        values: Dict[str, object] = {}
        self._example_into(self.fields, values, rng, dim)
        return values

    def _example_into(self, fields: Sequence, values: Dict[str, object],
                      rng, dim: int) -> None:
        derived = set()
        for f in fields:
            if isinstance(f, Bytes):
                derived.add(f.length)
            elif isinstance(f, (Array, Group)):
                derived.add(f.count)
        for f in fields:
            if isinstance(f, Int):
                if f.name not in derived:
                    values[f.name] = rng.randrange(0, 1 << 16)
            elif isinstance(f, Bytes):
                s = bytes(rng.randrange(97, 123)
                          for _ in range(rng.randrange(0, 9)))
                values[f.name] = s
                values[f.length] = len(s)
            elif isinstance(f, Array):
                mult = self._mult(f, dim)
                # shared count fields (apply_req's ids/grads) must agree
                n = int(values.get(f.count, rng.randrange(0, 5)))
                values[f.count] = n
                dt = np.dtype(f.dtype)
                raw = bytes(rng.randrange(0, 256)
                            for _ in range(n * mult * dt.itemsize))
                values[f.name] = np.frombuffer(raw, dt)
            elif isinstance(f, Group):
                n = rng.randrange(0, 4)
                values[f.count] = n
                entries = []
                for _ in range(n):
                    entry: Dict[str, object] = {}
                    self._example_into(f.fields, entry, rng, dim)
                    entries.append(entry)
                values[f.name] = entries
            elif isinstance(f, Tail):
                if f.schema and f.schema in REGISTRY:
                    nested = REGISTRY[f.schema]
                    values[f.name] = nested.pack(
                        nested.example(rng, dim=dim), dim=dim)
                else:
                    values[f.name] = bytes(
                        rng.randrange(0, 256)
                        for _ in range(rng.randrange(0, 17)))


# ---------------------------------------------------------------------------
# the registry: every framing in the tree, declared once
# ---------------------------------------------------------------------------

REGISTRY: Dict[str, FrameSchema] = {}


def schema(name: str, *fields, **kw) -> FrameSchema:
    sc = FrameSchema(name=name, fields=tuple(fields), **kw)
    REGISTRY[name] = sc
    return sc


schema(
    "lookup_req",
    Int("count", "<i"), Array("ids", "<i4", "count"),
    doc="Lookup request: int32 count ++ int32 ids (absolute)",
    pack_sites=("ps_remote._pack_lookup_req",
                "ps_remote._pack_lookup_req_iobuf"),
    unpack_sites=("ps_remote.PsShardServer._serve",
                  "ps_remote.DevicePsShardServer._serve"),
    exact_sites=("ps_remote._pack_lookup_req",),
    native_sites=("cpp/capi/ps_shard.cc:CPsService::ServeLookup",),
    segments=(("ps_remote.PsShardServer._serve", ("Lookup",)),
              ("ps_remote.DevicePsShardServer._serve", ("Lookup",))),
    prebranch=(("ps_remote.PsShardServer._serve", "i"),
               ("ps_remote.DevicePsShardServer._serve", "i")))

schema(
    "apply_req",
    Int("count", "<i"), Array("ids", "<i4", "count"),
    Array("grads", "<f4", "count", mult="dim"),
    doc="ApplyGrad framing: count ++ ids ++ float32 grads [count, dim]",
    pack_sites=("ps_remote._pack_apply_req",
                "ps_remote._pack_apply_req_iobuf"),
    unpack_sites=("ps_remote._unpack_apply",),
    exact_sites=("ps_remote._pack_apply_req", "ps_remote._unpack_apply"))

schema(
    "stream_frame",
    Int("seq"), Int("epoch"), Int("gen"), Tail("body"),
    doc="stream frame header (seq, epoch, gen int64) + framed body",
    pack_sites=("ps_remote._pack_stream_frame",
                "ps_remote._pack_stream_frame_iobuf"),
    unpack_sites=("ps_remote._ApplyStreamReceiver.on_data",
                  "ps_remote._ReplicaStreamReceiver.on_data",
                  "ps_remote._MigrateStreamReceiver.on_data"),
    exact_sites=("ps_remote._pack_stream_frame",))

schema(
    "windows",
    Int("count", "<i"),
    Group("entries", "count",
          (Int("wlen", "<i"), Bytes("writer", "wlen"), Int("seq"))),
    doc="writer seq high-water map: count ++ (len ++ utf8 ++ seq)*",
    pack_sites=("ps_remote._pack_windows",),
    unpack_sites=("ps_remote._unpack_windows",),
    exact_sites=("ps_remote._pack_windows", "ps_remote._unpack_windows"))

schema(
    "apply_id_req",
    Int("wlen", "<i"), Bytes("writer", "wlen"), Int("seq"),
    Int("nguards", "<i"),
    Group("guards", "nguards",
          (Int("klen", "<i"), Bytes("key", "klen"), Int("q"))),
    Tail("body", schema="apply_req"),
    doc="ApplyGradId: writer key ++ seq ++ guards ++ apply_req body",
    pack_sites=("ps_remote._pack_apply_id_req",),
    unpack_sites=("ps_remote._unpack_apply_id",),
    exact_sites=("ps_remote._pack_apply_id_req",
                 "ps_remote._unpack_apply_id"))

schema(
    "replica_apply_body",
    Tail("windows", schema="windows"),
    doc="ReplicaApply/MigrateApply frame body: windows ++ apply_req "
        "(two nested frames back to back; the windows parser returns "
        "its end offset)",
    pack_sites=("ps_remote.PsShardServer._apply_batch",
                "ps_remote.DevicePsShardServer._apply_batch",
                "reshard.MigrationShipper.ship"),
    unpack_sites=("ps_remote.PsShardServer._apply_replica_frame",
                  "ps_remote.PsShardServer._apply_migrate_frame"))

schema(
    "replica_apply_setup",
    Int("epoch"),
    doc="ReplicaApply stream setup: the sender's fencing epoch",
    pack_sites=("ps_remote._Replicator._connect",
                "ps_remote._Replicator._try_hydrate"),
    unpack_sites=("ps_remote.PsShardServer._serve_stream_setup",))

schema(
    "sync_req",
    Int("epoch"), Int("gen"), Int("count"),
    Array("table", "<f4", "count"), Tail("windows", schema="windows"),
    doc="replication Sync: epoch ++ gen ++ f32 count ++ table ++ windows",
    pack_sites=("ps_remote._Replicator._connect",
                "durable.hydrate_replica"),
    unpack_sites=("ps_remote.PsShardServer._serve_control",),
    segments=(("ps_remote.PsShardServer._serve_control", ("Sync",)),))

schema(
    "promote_req",
    Int("epoch"),
    doc="Promote: the new fencing epoch",
    pack_sites=("ps_remote.RemoteEmbedding._failover",),
    unpack_sites=("ps_remote.PsShardServer._serve_control",),
    segments=(("ps_remote.PsShardServer._serve_control",
               ("Promote",)),))

schema(
    "scheme_fence_req",
    Int("ver"),
    doc="SchemeFence: the successor scheme version",
    pack_sites=("reshard.MigrationDriver.cutover",),
    unpack_sites=("ps_remote.PsShardServer._serve_control",),
    segments=(("ps_remote.PsShardServer._serve_control",
               ("SchemeFence",)),))

schema(
    "migrate_sync_req",
    Int("scheme"), Int("src_gen"), Int("row0"), Int("count"),
    Int("alen", "<i"), Bytes("src", "alen"),
    Array("rows", "<f4", "count", mult="dim"),
    Tail("windows", schema="windows"),
    doc="MigrateSync: range handoff header ++ source addr ++ rows ++ "
        "windows",
    pack_sites=("reshard.MigrationShipper._connect",
                "durable.hydrate_destination"),
    unpack_sites=("ps_remote.PsShardServer._serve_control",),
    segments=(("ps_remote.PsShardServer._serve_control",
               ("MigrateSync",)),))

schema(
    "migrate_apply_setup",
    Int("scheme"), Int("alen", "<i"), Bytes("src", "alen"),
    doc="MigrateApply stream setup: successor scheme ++ source addr",
    pack_sites=("reshard.MigrationShipper._connect",
                "reshard.MigrationShipper._try_hydrate"),
    unpack_sites=("ps_remote.PsShardServer._serve_stream_setup",))

schema(
    "ack_frame",
    Int("gen"),
    doc="one int64 riding a reply stream: a generation ack, or a "
        "negative fence notification",
    pack_sites=("ps_remote._ApplyStreamReceiver._fence",
                "ps_remote._ReplicaStreamReceiver.on_data",
                "ps_remote._MigrateStreamReceiver.on_data"),
    unpack_sites=("ps_remote._ReplicaAckReceiver.on_data",
                  "ps_remote._PushStreamReceiver.on_data",
                  "reshard._ShipperAckReceiver.on_data"))

schema(
    "gen_rsp",
    Int("gen"),
    doc="int64 generation response (ApplyGrad/Flush/MigrateStart/...)",
    pack_sites=("ps_remote.PsShardServer._serve_control",
                "ps_remote.PsShardServer._serve_apply_id",),
    unpack_sites=("ps_remote.RemoteEmbedding._note_acked_gen",),
    segments=(("ps_remote.PsShardServer._serve_control",
               ("Flush", "MigrateStart", "SchemeFence",
                "CompleteImport")),),
    response=True)

schema(
    "epoch_gen_rsp",
    Int("epoch"), Int("gen"),
    doc="(epoch, gen) int64 pair: the Promote response",
    pack_sites=("ps_remote.PsShardServer._serve_control",),
    segments=(("ps_remote.PsShardServer._serve_control",
               ("Promote",)),),
    response=True)

schema(
    "replica_setup_rsp",
    Int("epoch"), Int("gen"), Int("seeded"),
    doc="ReplicaApply stream setup response: the backup's fencing "
        "epoch ++ installed generation ++ chain-seeded flag — seeded "
        "distinguishes a gen-0 backup whose table WAS established by a "
        "wholesale Sync (or a seeded checkpoint base) from a fresh "
        "random-init table, so first-boot hydration can ship only the "
        "delta tail",
    pack_sites=("ps_remote.PsShardServer._serve_stream_setup",),
    unpack_sites=("ps_remote._Replicator._try_hydrate",),
    response=True)

schema(
    "deadline_hdr",
    Int("magic", "<i"), Int("deadline_us"), Tail("body"),
    doc="optional request prefix (overload control): DEADLINE_MAGIC ++ "
        "absolute wall-clock deadline in microseconds ++ the original "
        "request body — servers shed work whose budget is already "
        "exhausted (EDEADLINE 2014) before touching the table; the "
        "native Lookup handler peels the same header",
    pack_sites=("ps_remote._pack_deadline",
                "ps_remote._pack_deadline_iobuf"),
    unpack_sites=("ps_remote._unpack_deadline",),
    exact_sites=("ps_remote._pack_deadline",
                 "ps_remote._unpack_deadline"),
    native_sites=("cpp/capi/ps_shard.cc:CPsService::ServeLookup",))

schema(
    "deadline_hdr_v2",
    Int("magic", "<i"), Int("budget_us"), Tail("body"),
    doc="v2 deadline prefix: DEADLINE_MAGIC2 ++ RELATIVE budget in "
        "microseconds ++ the original request body — the server stamps "
        "arrival with its OWN clock and computes expiry as arrival + "
        "budget, so no same-host/NTP wall-clock agreement is assumed; "
        "the shared _unpack_deadline dispatches on the magic and the "
        "native Lookup handler peels both forms",
    pack_sites=("ps_remote._pack_deadline_rel",
                "ps_remote._pack_deadline_rel_iobuf"),
    unpack_sites=("ps_remote._unpack_deadline",),
    exact_sites=("ps_remote._pack_deadline_rel",),
    native_sites=("cpp/capi/ps_shard.cc:CPsService::ServeLookup",))

schema(
    "press_header",
    Int("magic", "<i"), Int("version", "<i"), Int("seed"),
    Int("vocab"), Int("dim", "<i"), Int("count", "<i"),
    doc="press trace file header: PRESS_MAGIC ++ format version ++ "
        "workload seed ++ vocab ++ dim ++ record count",
    pack_sites=("press._pack_press_header",),
    unpack_sites=("press._unpack_press_header",),
    exact_sites=("press._pack_press_header",
                 "press._unpack_press_header"))

schema(
    "press_record",
    Int("t_us"), Int("op", "<i"), Int("nids", "<i"),
    Array("ids", "<i4", "nids"),
    doc="one recorded traffic op: scheduled arrival offset (us from "
        "trace start) ++ op kind (0=lookup, 1=apply) ++ key ids; "
        "gradients are re-derived from the header seed on replay",
    pack_sites=("press._pack_press_record",),
    unpack_sites=("press._unpack_press_record",),
    exact_sites=("press._pack_press_record",
                 "press._unpack_press_record"))

schema(
    "ckpt_snap",
    Int("magic", "<i"), Int("version", "<i"), Int("epoch"), Int("gen"),
    Int("rows", "<i"), Int("dim", "<i"), Int("seeded", "<i"),
    Int("crc"), Int("count"),
    Array("table", "<f4", "count"), Tail("windows", schema="windows"),
    doc="checkpoint base snapshot file (brpc_tpu_torch.durable), format v2: "
        "CKPT_SNAP_MAGIC ++ format version ++ fencing epoch ++ "
        "generation ++ table geometry ++ chain-seeded flag (a gen-0 "
        "base from a Sync'd server is not a fresh random table) ++ "
        "crc32 of everything after the header ++ f32 element count ++ "
        "the table image ++ writer dedup windows — restore parses disk "
        "bytes as hostile input, so torn/bit-flipped files must answer "
        "a clean reject",
    pack_sites=("durable._pack_snapshot",),
    unpack_sites=("durable._unpack_snapshot",),
    exact_sites=("durable._pack_snapshot", "durable._unpack_snapshot"))

schema(
    "ckpt_delta",
    Int("magic", "<i"), Int("gen"), Int("crc"), Int("blen", "<i"),
    Bytes("body", "blen"),
    doc="one delta-log record (brpc_tpu_torch.durable): CKPT_DELTA_MAGIC ++ "
        "the generation this batch produced ++ crc32 of the body ++ "
        "body length ++ a replica_apply_body frame (windows ++ "
        "apply_req) — the ReplicaApply framing teed to disk, so "
        "apply order is log order",
    pack_sites=("durable._pack_delta",),
    unpack_sites=("durable._unpack_delta",),
    exact_sites=("durable._pack_delta", "durable._unpack_delta"))

schema(
    "ckpt_marker",
    Int("magic", "<i"), Int("version", "<i"), Int("base_gen"),
    doc="compaction marker file (brpc_tpu_torch.durable): the generation of "
        "the newest durable base snapshot — advisory cross-check only "
        "(restore trusts the validated snapshots themselves), so a "
        "stale marker after a crash mid-compaction is tolerated",
    pack_sites=("durable._pack_marker",),
    unpack_sites=("durable._unpack_marker",),
    exact_sites=("durable._pack_marker", "durable._unpack_marker"))

schema(
    "writer_seq_rsp",
    Int("applied"), Int("gen"),
    doc="WriterSeq response: applied high-water ++ covering gen",
    pack_sites=("ps_remote.PsShardServer._serve_control",),
    unpack_sites=("ps_remote.RemoteEmbedding._transfer_pushes",
                  "ps_remote.RemoteEmbedding._confirm_push"),
    segments=(("ps_remote.PsShardServer._serve_control",
               ("WriterSeq",)),),
    response=True)


#: text/record parsers on the registry plane — not byte frames, but
#: hostile-input surface all the same.  The lint verifies each exists
#: and each is covered by a fuzz target (the "fuzzers for every parser"
#: gate); the fuzzer mutates tags / JSON records directly.
TEXT_PARSERS: Tuple[str, ...] = (
    "naming.parse_shard_tag",
    "naming.parse_claim_tag",
    "naming.parse_schemes",
    "naming.parse_claims",
)
