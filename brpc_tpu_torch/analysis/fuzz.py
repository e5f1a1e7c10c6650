"""Structure-aware deterministic fuzzer for every parser in the PS
fabric — the dynamic half of the wire-contract tier.

The reference framework treats every protocol parser as hostile-input
surface and fuzzes each one (SURVEY §2.5, §4).  This module does that
for ours, driven by the frame-schema registry (:mod:`brpc_tpu_torch.wire`):
every declared framing gets a mutation engine that KNOWS its field
boundaries — truncation at each boundary, length-field lies (negative,
huge, off-by-one), junk tails, mid-string splits, raw byte flips — and
every parser gets a target that asserts the wire contract:

- **byte parsers** (the hand-rolled ``_unpack_*`` family, both shard
  servers' ``_serve`` paths, the generic :meth:`FrameSchema.unpack`)
  must either parse or raise a clean ``ValueError`` (the sanctioned
  reject, usually :class:`brpc_tpu_torch.wire.WireError`) — never
  ``struct.error`` / ``IndexError`` / numpy internals, never a hang,
  never an allocation beyond a small multiple of the payload;
- **text/record parsers** (``naming.parse_shard_tag`` /
  ``parse_claim_tag`` / ``parse_schemes`` / ``parse_claims``) must
  NEVER raise — malformed registry content is skipped, not fatal;
- **live servers** (``--live``, needs the native core): mutated
  requests and stream frames against a real ``PsShardServer`` —
  including the native ``CPsService`` Lookup parse — must answer codes
  from the sanctioned set, leave the server serving, and leave the
  handle ledger (``BRPC_TPU_HANDLECHECK=1``) at its starting counts.

Everything is DETERMINISTIC: one ``--seed`` fixes the whole run, so a
failure replays exactly and tier-1 can carry a bounded smoke run.
Crashers found during development are stored under
``tests/fuzz_corpus/`` and replayed green forever
(:func:`replay_corpus`).

CLI::

    python -m brpc_tpu_torch.analysis.fuzz --seed 0 [--iters N] [--live]
        [--target NAME] [--corpus DIR] [--save-crashes DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import random
import struct
import sys
import time
import tracemalloc
import zlib
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from brpc_tpu_torch import naming, wire

__all__ = [
    "FuzzTarget", "Failure", "mutated_frames", "python_targets",
    "coverage_map", "run_target", "run", "parity_fuzz", "fuzz_live",
    "replay_corpus", "save_crash", "main", "SANCTIONED_LIVE_CODES",
]

#: RpcError codes a live fuzzed server may answer: the native parse
#: reject (EREQUEST 1003), the Python clean reject (EBADFRAME 2013),
#: residual application-level ValueErrors (EINTERNAL 2001 — e.g. ids
#: outside the shard range), and the fabric's own redirect/refusal
#: codes a mutated control frame can legitimately trigger.
SANCTIONED_LIVE_CODES = frozenset({
    1003,   # EREQUEST — native parser reject
    2001,   # EINTERNAL — handler ValueError (out-of-range ids, ...)
    2002,   # ENOMETHOD/unknown-method family
    2004,   # ELIMIT — a mutated burst may trip a configured limiter
    2009,   # ENOTPRIMARY
    2010,   # EFENCED
    2011,   # EMIGRATING
    2012,   # ESCHEMEMOVED
    wire.EBADFRAME,
    2014,   # EDEADLINE — a mutated deadline header may be expired
})

#: per-exec wall bound: a parser that takes longer than this on a
#: few-KB hostile payload is looping on attacker-controlled state
HANG_BUDGET_S = 0.75

#: allocation bound: peak traced allocation per exec may not exceed
#: this plus a small multiple of the payload (a parser must not turn a
#: 100-byte lie into a gigabyte table)
ALLOC_BUDGET_BYTES = 16 << 20


@dataclasses.dataclass
class Failure:
    target: str
    desc: str
    kind: str          # "crash" / "hang" / "alloc" / "contract"
    detail: str
    payload_hex: str = ""

    def format(self) -> str:
        return (f"[{self.target}] {self.kind} on {self.desc}: "
                f"{self.detail}")


@dataclasses.dataclass
class FuzzTarget:
    """One parser under fuzz: ``gen(rng, iters)`` yields
    ``(desc, payload)`` cases; ``exec_fn(payload)`` runs the parser;
    ``sanctioned`` are the exception types that count as a clean
    reject.  ``covers`` names the wire schemas / text parsers this
    target exercises (the lint's fuzzers-for-every-parser gate reads
    it)."""

    name: str
    covers: Tuple[str, ...]
    gen: Callable
    exec_fn: Callable
    sanctioned: Tuple = (ValueError,)
    #: bytes-like payloads can be stored/replayed via the corpus
    corpus_able: bool = True


# ---------------------------------------------------------------------------
# schema-driven mutation engine
# ---------------------------------------------------------------------------

def _int_lies(fmt: str) -> Tuple[int, ...]:
    if fmt.endswith("i"):
        return (-1, -2**31, 2**31 - 1, 1, 255, (1 << 24) + 1)
    return (-1, -2**63, 2**63 - 1, 1, 1 << 40)


def mutated_frames(sch: "wire.FrameSchema", rng: random.Random,
                   iters: int, *, dim: int = 4
                   ) -> Iterable[Tuple[str, bytes]]:
    """Deterministic stream of ``iters`` mutated frames for one schema:
    a rotation over valid frames, boundary truncations, length-field
    lies, junk tails, mid-field splits and byte flips, all derived from
    the schema's own field structure."""
    int_fields = [f for f in sch.fields if isinstance(f, wire.Int)]
    for i in range(iters):
        values = sch.example(rng, dim=dim)
        base = sch.pack(values, dim=dim)
        pick = rng.randrange(6)
        if pick == 0 or not base:
            yield "valid", base
        elif pick == 1:
            cut = rng.randrange(len(base) + 1)
            yield f"truncate@{cut}", base[:cut]
        elif pick == 2 and int_fields:
            f = rng.choice(int_fields)
            lie = rng.choice(_int_lies(f.fmt))
            lied = dict(values)
            lied[f.name] = lie
            try:
                yield f"lie:{f.name}={lie}", sch.pack(lied, dim=dim)
            except struct.error:  # lie wider than the field: clamp
                yield "valid", base
        elif pick == 3:
            junk = bytes(rng.randrange(256)
                         for _ in range(rng.randrange(1, 33)))
            yield f"junk_tail+{len(junk)}", base + junk
        elif pick == 4:
            # mid-field split: cut inside the frame then splice junk —
            # models a torn write / reused buffer
            cut = rng.randrange(len(base))
            junk = bytes(rng.randrange(256)
                         for _ in range(rng.randrange(1, 9)))
            yield f"splice@{cut}", base[:cut] + junk
        else:
            flipped = bytearray(base)
            for _ in range(rng.randrange(1, 4)):
                pos = rng.randrange(len(flipped))
                flipped[pos] ^= 1 << rng.randrange(8)
            yield "bitflip", bytes(flipped)


def _tag_cases(rng: random.Random, iters: int
               ) -> Iterable[Tuple[str, str]]:
    """Mutated registration tags for the shard/claim tag parsers."""
    bases = ["3/8", "3/8/1", "0/1", "3/8@e7P", "3/8/2@e7B",
             "3/8@v5e7P", "5/8@v12e3B"]
    junk = "/@vePB0123456789-+_ \t٠۱x"
    for _ in range(iters):
        t = rng.choice(bases)
        pick = rng.randrange(5)
        if pick == 0:
            yield "valid", t
        elif pick == 1:
            pos = rng.randrange(len(t) + 1)
            yield "insert", t[:pos] + rng.choice(junk) + t[pos:]
        elif pick == 2 and t:
            pos = rng.randrange(len(t))
            yield "delete", t[:pos] + t[pos + 1:]
        elif pick == 3:
            yield "number_lie", t.replace(
                "8", str(rng.choice([-1, 0, 2**63, 10**30])), 1)
        else:
            yield "garbage", "".join(
                rng.choice(junk) for _ in range(rng.randrange(0, 20)))


def _scheme_node_cases(rng: random.Random, iters: int
                       ) -> Iterable[Tuple[str, list]]:
    """Mutated registry node lists for parse_schemes/parse_claims."""
    good = naming.PartitionScheme(
        version=3,
        replica_sets=(naming.ReplicaSet(("127.0.0.1:7001",
                                         "127.0.0.1:7002")),
                      naming.ReplicaSet(("127.0.0.1:7003",))),
        weight=1.5, state="active", bounds=(0, 96, 256))
    good_tag = naming.SCHEME_TAG_PREFIX + good.to_json()
    for _ in range(iters):
        pick = rng.randrange(7)
        if pick == 0:
            yield "valid", [{"addr": "0.0.0.0:3", "tag": good_tag}]
        elif pick == 1:
            cut = rng.randrange(len(good_tag) + 1)
            yield "truncated_json", [{"addr": "0.0.0.0:3",
                                      "tag": good_tag[:cut]}]
        elif pick == 2:
            t = bytearray(good_tag.encode())
            pos = rng.randrange(len(t))
            t[pos] = rng.randrange(32, 127)
            yield "mutated_json", [{"addr": "0.0.0.0:3",
                                    "tag": t.decode(errors="replace")}]
        elif pick == 3:
            yield "type_swap", [{"addr": "0.0.0.0:3", "tag":
                                 naming.SCHEME_TAG_PREFIX + json.dumps({
                                     "version": rng.choice(
                                         [3, "x", None, -1, 1e308]),
                                     "replica_sets": rng.choice(
                                         ["abc", [{"addresses": "abc"}],
                                          [{"addresses": [1, 2]}],
                                          [], None]),
                                     "weight": rng.choice(
                                         [1.0, "inf", 1e400, "nan"]),
                                     "bounds": rng.choice(
                                         [None, {"a": 1}, [0, "x", 9],
                                          [5, 1]]),
                                 })}]
        elif pick == 4:
            yield "deep_nest", [{"addr": "0.0.0.0:3", "tag":
                                 naming.SCHEME_TAG_PREFIX +
                                 "[" * 4000 + "]" * 4000}]
        elif pick == 5:
            yield "claim_no_addr", [{"tag": "3/8@e7P"},
                                    {"addr": 7, "tag": "2/8@e7P"},
                                    {"addr": "127.0.0.1:1",
                                     "tag": rng.choice(
                                         ["1/8@v2e9P", "1/8@e-3P",
                                          "1/8@ve7P", "-1/8@e7P"])}]
        else:
            yield "non_str_tag", [{"addr": "x", "tag": rng.choice(
                [None, 7, ["a"], {"t": 1}])}, {"no": "fields"}]


# ---------------------------------------------------------------------------
# targets
# ---------------------------------------------------------------------------

def python_targets(*, dim: int = 4) -> List[FuzzTarget]:
    """Every directly-callable Python parser, schema-driven."""
    from brpc_tpu_torch import ps_remote

    targets: List[FuzzTarget] = []
    for name, sch in sorted(wire.REGISTRY.items()):
        targets.append(FuzzTarget(
            name=f"schema:{name}",
            covers=(name,),
            gen=lambda rng, n, s=sch: mutated_frames(s, rng, n, dim=dim),
            exec_fn=lambda p, s=sch: s.unpack(p, dim=dim)))

    targets.append(FuzzTarget(
        name="unpack_windows",
        covers=("windows",),
        gen=lambda rng, n: mutated_frames(
            wire.REGISTRY["windows"], rng, n, dim=dim),
        exec_fn=ps_remote._unpack_windows))

    targets.append(FuzzTarget(
        name="unpack_apply",
        covers=("apply_req",),
        gen=lambda rng, n: mutated_frames(
            wire.REGISTRY["apply_req"], rng, n, dim=dim),
        exec_fn=lambda p: ps_remote._unpack_apply(p, 0, 1 << 20, dim)))

    def _apply_id(p):
        writer, seq, guards, body = ps_remote._unpack_apply_id(p)
        return ps_remote._unpack_apply(bytes(body), 0, 1 << 20, dim)

    targets.append(FuzzTarget(
        name="unpack_apply_id",
        covers=("apply_id_req", "apply_req"),
        gen=lambda rng, n: mutated_frames(
            wire.REGISTRY["apply_id_req"], rng, n, dim=dim),
        exec_fn=_apply_id))

    from brpc_tpu_torch import durable

    targets.append(FuzzTarget(
        name="unpack_ckpt_snap",
        covers=("ckpt_snap",),
        gen=lambda rng, n: mutated_frames(
            wire.REGISTRY["ckpt_snap"], rng, n, dim=dim),
        exec_fn=lambda p: durable._unpack_snapshot(bytes(p))))

    targets.append(FuzzTarget(
        name="unpack_ckpt_delta",
        covers=("ckpt_delta",),
        gen=lambda rng, n: mutated_frames(
            wire.REGISTRY["ckpt_delta"], rng, n, dim=dim),
        exec_fn=lambda p: durable._unpack_delta(bytes(p))))

    targets.append(FuzzTarget(
        name="unpack_ckpt_marker",
        covers=("ckpt_marker",),
        gen=lambda rng, n: mutated_frames(
            wire.REGISTRY["ckpt_marker"], rng, n, dim=dim),
        exec_fn=lambda p: durable._unpack_marker(bytes(p))))

    targets.append(FuzzTarget(
        name="unpack_deadline",
        covers=("deadline_hdr",),
        gen=lambda rng, n: mutated_frames(
            wire.REGISTRY["deadline_hdr"], rng, n, dim=dim),
        exec_fn=lambda p: ps_remote._unpack_deadline(bytes(p))))

    targets.append(FuzzTarget(
        name="unpack_deadline_v2",
        covers=("deadline_hdr_v2",),
        gen=lambda rng, n: mutated_frames(
            wire.REGISTRY["deadline_hdr_v2"], rng, n, dim=dim),
        exec_fn=lambda p: ps_remote._unpack_deadline(bytes(p))))

    def _press_trace_cases(rng: random.Random, iters: int):
        """Mutated whole trace files: schema-mutated headers, and a
        valid header (claiming one record) followed by schema-mutated
        record bytes — the parser must reject mid-file corruption
        cleanly, never crash or replay garbage."""
        from brpc_tpu_torch import press
        hdr_sch = wire.REGISTRY["press_header"]
        rec_sch = wire.REGISTRY["press_record"]
        good_hdr = press._pack_press_header(seed=1, vocab=64, dim=4,
                                            count=1)
        # exactly `iters` cases total: the tier-1 smoke asserts every
        # target runs its full budget
        for desc, frame in mutated_frames(hdr_sch, rng, iters // 2,
                                          dim=dim):
            yield f"hdr:{desc}", frame
        for desc, frame in mutated_frames(rec_sch, rng,
                                          iters - iters // 2, dim=dim):
            yield f"rec:{desc}", good_hdr + frame

    def _parse_trace(p):
        from brpc_tpu_torch import press
        return press.parse_trace(p)

    targets.append(FuzzTarget(
        name="press_trace",
        covers=("press_header", "press_record"),
        gen=_press_trace_cases,
        exec_fn=_parse_trace))

    targets.append(FuzzTarget(
        name="parse_shard_tag",
        covers=("naming.parse_shard_tag",),
        gen=_tag_cases,
        exec_fn=naming.parse_shard_tag,
        sanctioned=(),                # must never raise
        corpus_able=False))
    targets.append(FuzzTarget(
        name="parse_claim_tag",
        covers=("naming.parse_claim_tag",),
        gen=_tag_cases,
        exec_fn=naming.parse_claim_tag,
        sanctioned=(),
        corpus_able=False))
    targets.append(FuzzTarget(
        name="parse_schemes",
        covers=("naming.parse_schemes",),
        gen=_scheme_node_cases,
        exec_fn=naming.parse_schemes,
        sanctioned=(),
        corpus_able=False))
    targets.append(FuzzTarget(
        name="parse_claims",
        covers=("naming.parse_claims",),
        gen=_scheme_node_cases,
        exec_fn=naming.parse_claims,
        sanctioned=(),
        corpus_able=False))
    return targets


def coverage_map() -> Dict[str, Tuple[str, ...]]:
    """target name -> covered schemas/parsers; what the wire-contract
    lint's fuzzers-for-every-parser gate reads."""
    return {t.name: t.covers for t in python_targets()}


# ---------------------------------------------------------------------------
# the run loop
# ---------------------------------------------------------------------------

def _target_rng(seed: int, name: str) -> random.Random:
    return random.Random((seed << 32) ^ zlib.crc32(name.encode()))


def run_target(target: FuzzTarget, seed: int, iters: int, *,
               memcheck: bool = True
               ) -> Tuple[int, float, List[Failure]]:
    """Runs one target for ``iters`` execs; returns ``(execs,
    wall_seconds, failures)``.  Every exec asserts the contract: clean
    parse or sanctioned reject, bounded wall time, bounded peak
    allocation (with ``memcheck``)."""
    rng = _target_rng(seed, target.name)
    failures: List[Failure] = []
    execs = 0
    tracing = memcheck and not tracemalloc.is_tracing()
    if tracing:
        tracemalloc.start()
    t_total0 = time.perf_counter()
    try:
        for desc, payload in target.gen(rng, iters):
            size = len(payload) if isinstance(payload,
                                              (bytes, bytearray)) else 0
            if memcheck:
                tracemalloc.reset_peak()
            t0 = time.perf_counter()
            try:
                target.exec_fn(payload)
            except target.sanctioned:
                pass
            except Exception as e:  # noqa: BLE001 — the verdict itself
                failures.append(Failure(
                    target.name, desc, "crash",
                    f"{type(e).__name__}: {e}",
                    payload.hex() if isinstance(
                        payload, (bytes, bytearray)) else repr(payload)))
            elapsed = time.perf_counter() - t0
            execs += 1
            if elapsed > HANG_BUDGET_S:
                failures.append(Failure(
                    target.name, desc, "hang",
                    f"exec took {elapsed:.2f}s",
                    payload.hex() if isinstance(
                        payload, (bytes, bytearray)) else repr(payload)))
            if memcheck:
                _, peak = tracemalloc.get_traced_memory()
                if peak > ALLOC_BUDGET_BYTES + 8 * size:
                    failures.append(Failure(
                        target.name, desc, "alloc",
                        f"peak {peak} bytes for a {size}-byte payload",
                        payload.hex() if isinstance(
                            payload, (bytes, bytearray))
                        else repr(payload)))
    finally:
        if tracing:
            tracemalloc.stop()
    return execs, time.perf_counter() - t_total0, failures


def run(seed: int, iters: int, *, targets: Optional[List[FuzzTarget]]
        = None, memcheck: bool = True) -> Dict[str, object]:
    """Fuzz every Python target; returns a report dict (per-target
    execs/sec + all failures)."""
    targets = targets if targets is not None else python_targets()
    report: Dict[str, object] = {"seed": seed, "iters": iters,
                                 "targets": {}, "failures": []}
    for t in targets:
        execs, wall, failures = run_target(t, seed, iters,
                                           memcheck=memcheck)
        report["targets"][t.name] = {
            "execs": execs,
            "execs_per_sec": round(execs / wall, 1) if wall else 0.0,
        }
        report["failures"].extend(dataclasses.asdict(f)
                                  for f in failures)
    report["ok"] = not report["failures"]
    return report


# ---------------------------------------------------------------------------
# static/dynamic parity: fuzz one pack/unpack pair against a schema
# ---------------------------------------------------------------------------

def parity_fuzz(sch: "wire.FrameSchema", pack_fn: Callable,
                unpack_fn: Callable, *, seed: int = 0, iters: int = 50,
                dim: int = 4) -> List[Failure]:
    """Dynamic twin of the ``wire-contract`` lint's drift check: packs
    schema-valid values through ``pack_fn`` and asserts byte equality
    with the schema's reference packer, then feeds reference frames to
    ``unpack_fn`` and asserts it accepts them.  A pair whose field
    order/width drifted fails HERE at runtime exactly where the lint
    flags it statically."""
    rng = random.Random(seed)
    failures: List[Failure] = []
    for _ in range(iters):
        values = sch.example(rng, dim=dim)
        ref = sch.pack(values, dim=dim)
        try:
            hand = bytes(pack_fn(values))
        except Exception as e:  # noqa: BLE001 — drift verdict
            failures.append(Failure(
                f"parity:{sch.name}", "pack", "contract",
                f"pack_fn raised {type(e).__name__}: {e}"))
            continue
        if hand != ref:
            failures.append(Failure(
                f"parity:{sch.name}", "pack", "contract",
                f"pack drift: hand-rolled bytes != schema bytes "
                f"({hand.hex()} vs {ref.hex()})", ref.hex()))
        try:
            unpack_fn(ref)
        except Exception as e:  # noqa: BLE001 — drift verdict
            failures.append(Failure(
                f"parity:{sch.name}", "unpack", "contract",
                f"unpack_fn rejected a schema-valid frame: "
                f"{type(e).__name__}: {e}", ref.hex()))
    return failures


# ---------------------------------------------------------------------------
# live-server fuzzing (native core)
# ---------------------------------------------------------------------------

class _NullReceiver:
    def on_data(self, data: bytes) -> None:
        pass

    def on_closed(self) -> None:
        pass


class _StreamSet:
    """Holder for the interleaved fuzz writers' streams: owns every
    stream put into it; :meth:`close` releases them all (the handle
    ledger cross-checks the teardown)."""

    def __init__(self):
        self._streams: Dict[int, object] = {}

    def open(self, ch, k: int, writer: bytes) -> None:
        st = ch.stream("Ps", "StreamApply", writer,
                       receiver=_NullReceiver())
        self._streams[k] = st

    def get(self, k: int):
        return self._streams[k]

    def close(self) -> None:
        for st in self._streams.values():
            st.close()
        self._streams.clear()


def fuzz_live(seed: int, iters: int = 150, *, timeout_ms: int = 3000,
              dim: int = 4) -> Dict[str, object]:
    """Mutated unary requests + stream frames against LIVE shard
    servers (the native ``CPsService`` Lookup parse path included).
    Asserts: every error is a sanctioned RpcError code, the servers
    still serve a well-formed Lookup afterwards (no hang, no wedged
    state), and the handle ledger ends where it started."""
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.analysis import handles
    from brpc_tpu_torch.ps_remote import PsShardServer

    rng = _target_rng(seed, "live")
    failures: List[Failure] = []
    codes_seen: Dict[int, int] = {}
    execs = 0
    ledger_before = handles.live_counts() if handles.enabled() else None

    vocab = 256
    #: (method, schema) — data-plane methods on one server, lifecycle
    #: controls on another so a successful mutated SchemeFence/Promote
    #: can't wedge the data server's write path mid-run
    data_methods = [("Lookup", "lookup_req"),
                    ("ApplyGrad", "apply_req"),
                    ("ApplyGradId", "apply_id_req")]
    ctl_methods = [("Promote", "promote_req"),
                   ("Sync", "sync_req"),
                   ("SchemeFence", "scheme_fence_req"),
                   ("MigrateSync", "migrate_sync_req"),
                   ("MigrateStart", None),
                   ("WriterSeq", None),
                   ("NoSuchMethod", None)]

    data_srv = PsShardServer(vocab, dim, 0, 4, native_read=True,
                             combine=True, stream=True)
    ctl_srv = PsShardServer(vocab, dim, 1, 4, native_read=True)
    # both channels are constructed inside the try below: if the second
    # constructor throws, the finally still releases the first
    data_ch = ctl_ch = None

    def one_call(ch, method: str, payload: bytes, desc: str) -> None:
        nonlocal execs
        t0 = time.perf_counter()
        try:
            ch.call("Ps", method, payload, timeout_ms=timeout_ms)
        except rpc.RpcError as e:
            codes_seen[e.code] = codes_seen.get(e.code, 0) + 1
            if e.code not in SANCTIONED_LIVE_CODES:
                failures.append(Failure(
                    f"live:{method}", desc, "contract",
                    f"unsanctioned code {e.code}: {e}", payload.hex()))
        execs += 1
        if time.perf_counter() - t0 > timeout_ms / 1000.0 + 1.0:
            failures.append(Failure(
                f"live:{method}", desc, "hang",
                f"call took {time.perf_counter() - t0:.2f}s",
                payload.hex()))

    try:
        data_ch = rpc.Channel(data_srv.address, timeout_ms=timeout_ms)
        ctl_ch = rpc.Channel(ctl_srv.address, timeout_ms=timeout_ms)
        for ch, methods in ((data_ch, data_methods),
                            (ctl_ch, ctl_methods)):
            for method, schema_name in methods:
                sch = wire.REGISTRY.get(schema_name) \
                    if schema_name else None
                if sch is not None:
                    for desc, payload in mutated_frames(
                            sch, rng, iters // 8 + 1, dim=dim):
                        one_call(ch, method, payload, desc)
                else:
                    for _ in range(iters // 16 + 1):
                        blob = bytes(rng.randrange(256) for _ in
                                     range(rng.randrange(0, 64)))
                        one_call(ch, method, blob, "blob")
        # stream frames: mutated stream_frame payloads at the framed
        # push path (no per-frame response — liveness is the verdict).
        # THREE concurrent writer ids interleave over the same stream
        # server round-robin: the per-writer seq windows and the shared
        # combiner must keep their state disjoint under hostile
        # interleavings, not just under one writer (an earlier
        # single-writer deferral).
        writers = (b"fuzz-w0", b"fuzz-w1", b"fuzz-w2")
        streams = _StreamSet()
        try:
            for k, w in enumerate(writers):
                streams.open(data_ch, k, w)
            alive = set(range(len(writers)))
            for i, (desc, payload) in enumerate(mutated_frames(
                    wire.REGISTRY["stream_frame"], rng,
                    3 * (iters // 4 + 1), dim=dim)):
                if not alive:
                    break
                k = sorted(alive)[i % len(alive)]
                try:
                    streams.get(k).write(payload)
                    execs += 1
                except rpc.RpcError:
                    # server broke THIS stream: allowed teardown; the
                    # other writers must keep interleaving
                    alive.discard(k)
        finally:
            streams.close()
        # liveness: both servers still answer a well-formed Lookup
        ids = np.arange(4, dtype=np.int32)
        req = struct.pack("<i", 4) + ids.tobytes()
        rsp = data_ch.call("Ps", "Lookup", req, timeout_ms=timeout_ms)
        if len(rsp) != 4 * dim * 4:
            failures.append(Failure(
                "live:Lookup", "post-fuzz", "contract",
                f"liveness Lookup answered {len(rsp)} bytes, "
                f"expected {4 * dim * 4}"))
        ids2 = ids + vocab // 4
        req2 = struct.pack("<i", 4) + ids2.astype(np.int32).tobytes()
        ctl_ch.call("Ps", "Lookup", req2, timeout_ms=timeout_ms)
        execs += 2
    finally:
        if data_ch is not None:
            data_ch.close()
        if ctl_ch is not None:
            ctl_ch.close()
        data_srv.close()
        ctl_srv.close()
    if ledger_before is not None:
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            after = handles.live_counts()
            drift = {k: v - ledger_before.get(k, 0)
                     for k, v in after.items()
                     if v > ledger_before.get(k, 0)}
            if not drift:
                break
            time.sleep(0.02)
        if drift:
            failures.append(Failure(
                "live", "ledger", "contract",
                f"handle ledger drifted across the fuzz session: "
                f"{drift}"))
    return {
        "execs": execs,
        "codes_seen": {str(k): v for k, v in sorted(codes_seen.items())},
        "failures": [dataclasses.asdict(f) for f in failures],
        "ok": not failures,
    }


# ---------------------------------------------------------------------------
# corpus: replayable crashers
# ---------------------------------------------------------------------------

def save_crash(corpus_dir: str, failure: Failure) -> str:
    """Persist one crasher as a replayable corpus entry."""
    os.makedirs(corpus_dir, exist_ok=True)
    digest = hashlib.sha1(
        f"{failure.target}|{failure.payload_hex}".encode()
    ).hexdigest()[:12]
    path = os.path.join(corpus_dir, f"{failure.target.replace(':', '_')}"
                                    f"_{digest}.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"target": failure.target, "desc": failure.desc,
                   "kind": failure.kind, "detail": failure.detail,
                   "payload_hex": failure.payload_hex}, f, indent=2)
        f.write("\n")
    return path


def replay_corpus(corpus_dir: str) -> Tuple[int, List[Failure]]:
    """Re-run every stored crasher against today's parsers: each must
    now parse or reject cleanly.  Returns ``(replayed, failures)``."""
    by_name = {t.name: t for t in python_targets()}
    failures: List[Failure] = []
    replayed = 0
    for fname in sorted(os.listdir(corpus_dir)):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(corpus_dir, fname), "r",
                  encoding="utf-8") as f:
            entry = json.load(f)
        target = by_name.get(entry["target"])
        if target is None:
            failures.append(Failure(
                entry["target"], fname, "contract",
                "corpus names a target that no longer exists"))
            continue
        payload = bytes.fromhex(entry["payload_hex"])
        replayed += 1
        try:
            target.exec_fn(payload)
        except target.sanctioned:
            pass
        except Exception as e:  # noqa: BLE001 — regression verdict
            failures.append(Failure(
                entry["target"], fname, "crash",
                f"corpus crasher regressed: {type(e).__name__}: {e}",
                entry["payload_hex"]))
    return replayed, failures


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m brpc_tpu_torch.analysis.fuzz",
        description="Structure-aware deterministic fuzzer for every "
                    "parser in the PS fabric")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--iters", type=int, default=400,
                        help="execs per target (default 400)")
    parser.add_argument("--target", action="append",
                        help="run only the named target(s)")
    parser.add_argument("--live", action="store_true",
                        help="also fuzz live servers (needs the native "
                             "core)")
    parser.add_argument("--corpus", metavar="DIR",
                        help="replay a crasher corpus instead of "
                             "fuzzing")
    parser.add_argument("--save-crashes", metavar="DIR",
                        help="persist new crashers into DIR as corpus "
                             "entries")
    parser.add_argument("--no-memcheck", action="store_true",
                        help="skip tracemalloc allocation bounding "
                             "(faster; used by the bench block)")
    args = parser.parse_args(argv)

    if args.corpus:
        replayed, failures = replay_corpus(args.corpus)
        print(f"corpus: {replayed} entr(ies) replayed, "
              f"{len(failures)} regression(s)")
        for f in failures:
            print("  " + f.format())
        return 1 if failures else 0

    targets = python_targets()
    if args.target:
        wanted = set(args.target)
        targets = [t for t in targets if t.name in wanted]
        unknown = wanted - {t.name for t in targets}
        if unknown:
            parser.error(f"unknown targets: {sorted(unknown)}; known: "
                         f"{sorted(t.name for t in python_targets())}")
    report = run(args.seed, args.iters, targets=targets,
                 memcheck=not args.no_memcheck)
    for name, stats in report["targets"].items():
        print(f"{name:28s} {stats['execs']:6d} execs  "
              f"{stats['execs_per_sec']:10.1f} exec/s")
    failures = [Failure(**f) for f in report["failures"]]
    if args.live:
        live = fuzz_live(args.seed)
        print(f"{'live':28s} {live['execs']:6d} execs  codes "
              f"{live['codes_seen']}")
        failures.extend(Failure(**f) for f in live["failures"])
    for f in failures:
        print(f.format())
        if args.save_crashes and f.payload_hex and f.kind == "crash":
            print("  saved: " + save_crash(args.save_crashes, f))
    print(f"{sum(s['execs'] for s in report['targets'].values())} "
          f"execs total, {len(failures)} failure(s)", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
