"""Scenario traffic harness — the ``rpc_press`` / ``rpc_replay`` analog
(SURVEY §2.9/§2.11) for the PS fabric.

The reference ships load tooling as part of the framework: ``rpc_press``
replays synthetic traffic at a target qps against any service,
``rpc_replay`` re-fires traffic captured by the rpc_dump sampler.  This
module is that pairing for the embedding fabric, and the acceptance
workload of the overload-control tier (:mod:`brpc_tpu_torch.limiter`):

- :func:`build_ops` generates a DETERMINISTIC op stream from a
  :class:`Scenario`: seeded Poisson (open-loop) arrivals at a
  piecewise-constant rate (steady + periodic bursts), zipf-skewed key
  draws (the hot-row reality of embedding traffic), and a
  read/write mix.
- record/replay: :func:`save_trace` / :func:`load_trace` persist an op
  stream as a binary trace file — schema-declared framing
  (``press_header`` / ``press_record`` in :mod:`brpc_tpu_torch.wire`,
  fuzzed like every other parser), gradients re-derived from the header seed
  so a trace is compact and a replay is exact.
- :func:`run_press` drives the stream OPEN-LOOP against a live shard
  server (one pacer thread issuing ``call_async`` at the scheduled
  instants — arrivals do not slow down when the server does, which is
  the point — plus a collector pool joining completions), measuring
  per-op sojourn (completion minus SCHEDULED arrival: coordinated
  omission is not allowed to hide queueing) and reporting the SLO
  numbers the scenario matrix is judged on: availability, p50/p99 of
  successes, and GOODPUT — in-deadline successes per second, the only
  number that survives an overload collapse.

CLI::

    python -m brpc_tpu_torch.press --target ip:port --qps 500 --duration 3
        [--record FILE | --replay FILE] [--deadline-ms 50 --stamp]
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from brpc_tpu_torch import obs, wire
from brpc_tpu_torch.analysis.race import checked_lock

__all__ = [
    "OP_LOOKUP", "OP_APPLY", "PressOp", "Scenario", "zipf_weights",
    "build_ops", "trace_bytes", "parse_trace", "save_trace",
    "load_trace", "run_press", "GRAD_VALUE", "main",
]

#: trace file format version (press_header.version)
PRESS_VERSION = 1

OP_LOOKUP = 0
OP_APPLY = 1

#: the synthesized gradient value: exactly representable (2^-6), so a
#: recorded run and its replay mutate tables byte-identically
GRAD_VALUE = 2.0 ** -6


@dataclasses.dataclass(frozen=True)
class PressOp:
    """One scheduled op: arrival offset (us from run start), kind
    (``OP_LOOKUP``/``OP_APPLY``), and the key ids it touches."""

    t_us: int
    op: int
    ids: np.ndarray


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One traffic shape, fully determined by its fields + ``seed``.

    ``qps`` is the steady open-loop arrival rate; when
    ``burst_every_s`` > 0, windows of ``burst_len_s`` starting every
    ``burst_every_s`` arrive at ``burst_qps`` instead (the
    past-capacity spike overload control exists for).  ``zipf_s`` > 0
    draws keys zipf(s)-skewed over the vocab (rank-1 hottest);
    ``read_fraction`` splits lookups vs gradient applies."""

    name: str = "steady"
    duration_s: float = 2.0
    qps: float = 200.0
    batch: int = 16
    read_fraction: float = 1.0
    zipf_s: float = 0.0
    burst_qps: float = 0.0
    burst_every_s: float = 0.0
    burst_len_s: float = 0.0
    seed: int = 0


def zipf_weights(vocab: int, s: float) -> np.ndarray:
    """Normalized zipf(s) pmf over ``vocab`` ranks (rank 1 hottest)."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    w = ranks ** -float(s)
    return w / w.sum()


def _rate_at(sc: Scenario, t: float) -> float:
    if sc.burst_every_s > 0 and sc.burst_qps > 0 and \
            (t % sc.burst_every_s) < sc.burst_len_s:
        return sc.burst_qps
    return sc.qps


def build_ops(sc: Scenario, vocab: int) -> List[PressOp]:
    """The scenario's deterministic op stream: seeded Poisson arrivals
    whose rate follows the steady/burst schedule, zipf or uniform key
    draws, seeded read/write coin flips.  Same scenario → same stream,
    always (the record/replay determinism contract)."""
    rng = np.random.default_rng(sc.seed)
    weights = zipf_weights(vocab, sc.zipf_s) if sc.zipf_s > 0 else None
    ops: List[PressOp] = []
    t = 0.0
    while True:
        rate = max(_rate_at(sc, t), 1e-6)
        t += float(rng.exponential(1.0 / rate))
        if t >= sc.duration_s:
            break
        if weights is not None:
            ids = rng.choice(vocab, size=sc.batch, p=weights)
        else:
            ids = rng.integers(0, vocab, size=sc.batch)
        kind = OP_LOOKUP if rng.random() < sc.read_fraction else OP_APPLY
        ops.append(PressOp(int(t * 1e6), kind,
                           np.sort(ids).astype(np.int32)))
    return ops


# ---------------------------------------------------------------------------
# record / replay (wire schemas press_header / press_record)
# ---------------------------------------------------------------------------

def _pack_press_header(seed: int, vocab: int, dim: int,
                       count: int) -> bytes:
    return struct.pack("<iiqqii", wire.PRESS_MAGIC, PRESS_VERSION,
                       seed, vocab, dim, count)


def _unpack_press_header(payload, offset: int = 0
                         ) -> Tuple[Tuple[int, int, int, int], int]:
    """Returns ``((seed, vocab, dim, count), end_offset)``; rejects a
    wrong magic/version or hostile geometry with :class:`wire.WireError`
    before anything is allocated."""
    magic, version, seed, vocab, dim, count = wire.read(
        "<iiqqii", payload, offset, "press.header")
    if magic != wire.PRESS_MAGIC:
        raise wire.WireError(f"press trace magic {magic:#x} != "
                             f"{wire.PRESS_MAGIC:#x}")
    if version != PRESS_VERSION:
        raise wire.WireError(f"press trace version {version} "
                             f"(supported: {PRESS_VERSION})")
    if vocab < 0 or dim < 0 or count < 0:
        raise wire.WireError(
            f"press trace header with negative geometry "
            f"(vocab={vocab}, dim={dim}, count={count})")
    return (seed, vocab, dim, count), offset + 32


def _pack_press_record(op: PressOp) -> bytes:
    ids = np.ascontiguousarray(op.ids, dtype=np.int32)
    return struct.pack("<qii", op.t_us, op.op, ids.size) + ids.tobytes()


def _unpack_press_record(payload, offset: int = 0
                         ) -> Tuple[PressOp, int]:
    """Guarded record parse: the id count is bounded by the bytes
    actually present before it drives the array read."""
    t_us, kind, nids = wire.read("<qii", payload, offset, "press.record")
    offset += 16
    wire.check_count(nids, (len(payload) - offset) // 4, "press.nids")
    ids = np.frombuffer(payload, np.int32, nids, offset)
    return PressOp(t_us, kind, ids), offset + 4 * nids


def trace_bytes(ops: List[PressOp], *, seed: int = 0, vocab: int = 0,
                dim: int = 0) -> bytes:
    """Serialize one op stream (header ++ records back to back)."""
    parts = [_pack_press_header(seed, vocab, dim, len(ops))]
    for op in ops:
        parts.append(_pack_press_record(op))
    return b"".join(parts)


def parse_trace(buf) -> Tuple[Dict[str, int], List[PressOp]]:
    """Strict inverse of :func:`trace_bytes`: every declared record
    must parse, kinds must be known, and nothing may trail the last
    record — a torn or corrupted trace rejects cleanly
    (:class:`wire.WireError`), it never replays garbage traffic."""
    (seed, vocab, dim, count), off = _unpack_press_header(buf)
    wire.check_count(count, (len(buf) - off) // 16, "press.count")
    ops: List[PressOp] = []
    for _ in range(count):
        op, off = _unpack_press_record(buf, off)
        if op.op not in (OP_LOOKUP, OP_APPLY):
            raise wire.WireError(f"press record with unknown op kind "
                                 f"{op.op}")
        if op.t_us < 0:
            raise wire.WireError("press record with negative arrival")
        ops.append(op)
    if off != len(buf):
        raise wire.WireError(
            f"press trace carries {len(buf) - off} trailing byte(s) "
            f"after its {count} declared record(s)")
    return {"seed": seed, "vocab": vocab, "dim": dim}, ops


def save_trace(path: str, ops: List[PressOp], *, seed: int = 0,
               vocab: int = 0, dim: int = 0) -> None:
    with open(path, "wb") as f:
        f.write(trace_bytes(ops, seed=seed, vocab=vocab, dim=dim))


def load_trace(path: str) -> Tuple[Dict[str, int], List[PressOp]]:
    with open(path, "rb") as f:
        return parse_trace(f.read())


# ---------------------------------------------------------------------------
# the open-loop driver
# ---------------------------------------------------------------------------

def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1)))
    return sorted_vals[idx]


class _ChannelPool:
    """Round-robin native-channel registry for the multi-connection
    pacer: one connection serializes its socket writes, so ``n > 1``
    raises the open-loop client ceiling on multi-core hosts.  Owns its
    channels — :meth:`close` releases every one (the dynamic handle
    ledger cross-checks)."""

    def __init__(self, addr: str, n: int, timeout_ms: int):
        from brpc_tpu_torch import rpc  # lazy: press imports without the core
        self._chs: Dict[int, object] = {}
        for i in range(max(1, n)):
            ch = rpc.Channel(addr, timeout_ms=timeout_ms)
            self._chs[i] = ch

    def __len__(self) -> int:
        return len(self._chs)

    def pick(self, i: int):
        return self._chs[i % len(self._chs)]

    def close(self) -> None:
        for ch in self._chs.values():
            ch.close()
        self._chs.clear()


def run_press(addr: str, ops: List[PressOp], dim: int, *,
              deadline_ms: Optional[float] = None,
              stamp_deadline: bool = False,
              stamp_mode: str = "absolute",
              collectors: int = 4,
              channels: int = 1,
              timeout_ms: Optional[int] = None,
              retry_on_limit: int = 0,
              limit_backoff_ms: float = 5.0,
              service: str = "Ps") -> Dict[str, object]:
    """Drive ``ops`` open-loop against the shard server at ``addr``.

    One pacer thread issues every op at its SCHEDULED instant via
    ``call_async`` (a slow server does not slow arrivals — that is what
    makes overload real); ``collectors`` threads join completions.
    With ``deadline_ms`` each call carries that native timeout, and
    ``stamp_deadline=True`` additionally prefixes the deadline header
    (wire schema ``deadline_hdr``) so the SERVER sheds queued work that
    can no longer answer in time.

    Latency is reported two ways: ``service`` (join minus issue) and
    ``sojourn`` (join minus scheduled arrival — the open-loop number
    that includes client-side catch-up lag and refuses coordinated
    omission).  Goodput counts successes whose sojourn beat the
    deadline; availability counts all successes.

    ``retry_on_limit`` applies the production client policy to
    ``ELIMIT`` sheds: up to N re-issues, each after the MANDATORY
    ``limit_backoff_ms`` pause (never straight back into the overload)
    and only while the op's own deadline budget still has room — a
    transient admission spike is absorbed, a sustained overload stays
    a shed.

    ``channels=N`` paces over N native connections round-robin: one
    channel serializes its socket's writes, so on a multi-core host a
    single connection caps the open-loop driver below what the server
    could absorb — the multi-connection pacer raises the client
    ceiling (the reference rpc_press's connection fan-out).
    ``stamp_mode="relative"`` stamps the v2 relative-budget header
    instead of the absolute wall-clock form."""
    from brpc_tpu_torch import rpc  # lazy: press imports without the core
    from brpc_tpu_torch.ps_remote import (
        _pack_apply_req, _pack_deadline, _pack_deadline_rel,
        _pack_lookup_req)

    # channel registry keyed by pacer index (every entry is closed
    # before run_press returns; the dynamic handle ledger checks it)
    chs = _ChannelPool(addr, channels,
                       timeout_ms or int(deadline_ms * 4
                                         if deadline_ms else 2000))
    results: List[Tuple[bool, int, float, float]] = []
    res_mu = checked_lock("press.results")
    inflight: collections.deque = collections.deque()
    pacing_done = threading.Event()
    call_timeout = int(deadline_ms) if deadline_ms is not None else None

    def _record(ok: bool, code: int, sojourn_s: float,
                service_s: float) -> None:
        with res_mu:
            results.append((ok, code, sojourn_s, service_s))

    start = time.monotonic()

    def pacer() -> None:
        wall0 = time.time()
        for i, op in enumerate(ops):
            due = start + op.t_us / 1e6
            now = time.monotonic()
            if due > now:
                time.sleep(due - now)
            if op.op == OP_LOOKUP:
                method, req = "Lookup", _pack_lookup_req(op.ids)
            else:
                grads = np.full((op.ids.size, dim), GRAD_VALUE,
                                np.float32)
                method, req = "ApplyGrad", _pack_apply_req(op.ids, grads)
            if stamp_deadline and deadline_ms is not None:
                if stamp_mode == "relative":
                    # v2: remaining budget at ISSUE; the server
                    # arrival-stamps with its own clock (no wall-clock
                    # agreement assumed).  Client-side catch-up lag
                    # already burned part of the budget.
                    req = _pack_deadline_rel(
                        int((due + deadline_ms / 1000.0
                             - time.monotonic()) * 1e6), req)
                else:
                    # absolute wall-clock deadline: scheduled arrival +
                    # budget (NOT issue + budget — an op the pacer
                    # issued late has already burned part of its
                    # budget queueing client-side)
                    req = _pack_deadline(
                        int((wall0 + op.t_us / 1e6
                             + deadline_ms / 1000.0) * 1e6), req)
            op_ch = chs.pick(i)
            t_issue = time.monotonic()
            try:
                pc = op_ch.call_async(service, method, req,
                                      timeout_ms=call_timeout)
            except rpc.RpcError as e:
                _record(False, e.code, t_issue - due, 0.0)
                continue
            # collector-pool registry: every queued PendingCall is
            # joined by exactly one collector before the run returns
            inflight.append((due, t_issue, method, req, 0, op_ch, pc))  # lint: allow-handle-escape
        pacing_done.set()

    def collector() -> None:
        while True:
            try:
                due, t_issue, method, req, tries, op_ch, pc = \
                    inflight.popleft()
            except IndexError:
                if pacing_done.is_set() and not inflight:
                    return
                time.sleep(0.001)
                continue
            try:
                pc.join()
                ok, code = True, 0
            except rpc.RpcError as e:
                ok, code = False, e.code
            end = time.monotonic()
            if not ok and code == 2004 and tries < retry_on_limit and \
                    deadline_ms is not None and \
                    (due + deadline_ms / 1000.0) - end \
                    > 2 * limit_backoff_ms / 1000.0:
                # ELIMIT with budget left: MANDATORY backoff, then one
                # more leg (the resilience-tier retry contract) —
                # sojourn keeps accruing from the original arrival
                time.sleep(limit_backoff_ms / 1000.0)
                try:
                    pc2 = op_ch.call_async(service, method, req,
                                           timeout_ms=call_timeout)
                except rpc.RpcError as e:
                    _record(False, e.code, time.monotonic() - due, 0.0)
                    continue
                inflight.append((due, t_issue, method, req,  # lint: allow-handle-escape
                                 tries + 1, op_ch, pc2))
                continue
            _record(ok, code, end - due, end - t_issue)

    threads = [threading.Thread(target=pacer, name="press-pacer")]
    threads += [threading.Thread(target=collector,
                                 name=f"press-collect{i}")
                for i in range(max(1, collectors))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.monotonic() - start

    with res_mu:
        done = list(results)
    n = len(done)
    ok_sojourns = sorted(s for ok, _, s, _ in done if ok)
    ok_services = sorted(sv for ok, _, _, sv in done if ok)
    errors: Dict[str, int] = {}
    for ok, code, _, _ in done:
        if not ok:
            errors[str(code)] = errors.get(str(code), 0) + 1
    n_ok = len(ok_sojourns)
    in_deadline = n_ok if deadline_ms is None else sum(
        1 for s in ok_sojourns if s * 1000.0 <= deadline_ms)
    offered_qps = len(ops) / max(wall_s, 1e-9)
    report = {
        "n": n,
        "ok": n_ok,
        "errors": errors,
        "availability": round(n_ok / n, 4) if n else 0.0,
        "goodput_qps": round(in_deadline / max(wall_s, 1e-9), 1),
        "offered_qps": round(offered_qps, 1),
        "p50_ms": round(_percentile(ok_sojourns, 0.50) * 1e3, 3),
        "p99_ms": round(_percentile(ok_sojourns, 0.99) * 1e3, 3),
        "p50_service_ms": round(_percentile(ok_services, 0.50) * 1e3, 3),
        "p99_service_ms": round(_percentile(ok_services, 0.99) * 1e3, 3),
        "duration_s": round(wall_s, 3),
        "deadline_ms": deadline_ms,
        "stamped": bool(stamp_deadline and deadline_ms is not None),
        "stamp_mode": stamp_mode,
        "channels": len(chs),
    }
    if obs.enabled():
        obs.counter("press_ops").add(n)
        obs.counter("press_errors").add(n - n_ok)
    chs.close()
    return report


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m brpc_tpu_torch.press",
        description="Scenario load harness (rpc_press/rpc_replay "
                    "analog) for the PS fabric")
    parser.add_argument("--target", help="shard server ip:port (omit "
                                         "with --record to only write "
                                         "a trace)")
    parser.add_argument("--vocab", type=int, default=1024)
    parser.add_argument("--dim", type=int, default=32)
    parser.add_argument("--qps", type=float, default=200.0)
    parser.add_argument("--duration", type=float, default=2.0)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--read-fraction", type=float, default=1.0)
    parser.add_argument("--zipf", type=float, default=0.0)
    parser.add_argument("--burst-qps", type=float, default=0.0)
    parser.add_argument("--burst-every", type=float, default=0.0)
    parser.add_argument("--burst-len", type=float, default=0.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--deadline-ms", type=float)
    parser.add_argument("--stamp", action="store_true",
                        help="propagate the deadline header so the "
                             "server sheds expired work")
    parser.add_argument("--stamp-mode", choices=("absolute",
                                                 "relative"),
                        default="absolute",
                        help="deadline header form: absolute "
                             "wall-clock us (v1) or relative budget "
                             "with server-side arrival stamp (v2)")
    parser.add_argument("--channels", type=int, default=1,
                        help="native connections to pace over "
                             "round-robin (raises the open-loop "
                             "client ceiling on multi-core hosts)")
    parser.add_argument("--record", metavar="FILE",
                        help="write the generated op stream to FILE")
    parser.add_argument("--replay", metavar="FILE",
                        help="replay a recorded trace instead of "
                             "generating")
    args = parser.parse_args(argv)

    if args.replay:
        meta, ops = load_trace(args.replay)
        vocab = meta["vocab"] or args.vocab
        dim = meta["dim"] or args.dim
    else:
        sc = Scenario(duration_s=args.duration, qps=args.qps,
                      batch=args.batch,
                      read_fraction=args.read_fraction,
                      zipf_s=args.zipf, burst_qps=args.burst_qps,
                      burst_every_s=args.burst_every,
                      burst_len_s=args.burst_len, seed=args.seed)
        ops = build_ops(sc, args.vocab)
        vocab, dim = args.vocab, args.dim
    if args.record:
        save_trace(args.record, ops, seed=args.seed, vocab=vocab,
                   dim=dim)
        print(f"recorded {len(ops)} op(s) to {args.record}")
        if not args.target:
            return 0
    if not args.target:
        parser.error("--target is required unless only --record is "
                     "given")
    report = run_press(args.target, ops, dim,
                       deadline_ms=args.deadline_ms,
                       stamp_deadline=args.stamp,
                       stamp_mode=args.stamp_mode,
                       channels=args.channels)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys
    sys.exit(main())
