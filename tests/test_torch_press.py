"""The port's scenario traffic harness (``brpc_tpu_torch.press``) beside
the reference's (``brpc_tpu.press``).

- Twins of ``tests/test_press.py``: deterministic workload generation,
  zipf skew, burst scheduling, the record/replay trace format (strict
  parser), the CLI, and the live open-loop driver against the port's
  ``PsShardServer``.
- Parity: for a steady, a zipf and a burst scenario both packages'
  ``build_ops`` give the same stream, their ``trace_bytes`` are
  byte-equal, and each side's ``parse_trace`` reads the other's bytes.
- The open-loop driver against the port's ``DevicePsShardServer`` on the
  CPU device client: every op succeeds, and the final table is bit-equal
  to a host replay of the applies (``np.subtract.at`` with press's
  constant gradient).

Every native test ends with no net growth of the port's handle ledger.
"""

import os
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from brpc_tpu import press as ref_press
from brpc_tpu_torch import press, wire
from brpc_tpu_torch.analysis import handles
from brpc_tpu_torch.press import (OP_APPLY, OP_LOOKUP, PressOp, Scenario,
                                  build_ops, parse_trace, trace_bytes,
                                  zipf_weights)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_leak_gate(request):
    """No net growth of the port's handle ledger across a native test."""
    if "needs_native" not in request.node.keywords \
            or not handles.enabled():
        yield
        return
    before = handles.live_counts()
    yield
    deadline = time.monotonic() + 2.0
    while True:
        leaked = {k: v - before.get(k, 0)
                  for k, v in handles.live_counts().items()
                  if v > before.get(k, 0)}
        if not leaked or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    assert not leaked, f"leaked port handles {leaked}:\n{handles.report()}"


def _same_ops(a, b) -> bool:
    return len(a) == len(b) and all(
        x.t_us == y.t_us and x.op == y.op and np.array_equal(x.ids,
                                                             y.ids)
        for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def test_build_ops_deterministic_and_sorted_arrivals():
    sc = Scenario(duration_s=0.5, qps=400, batch=8, seed=3)
    a, b = build_ops(sc, 256), build_ops(sc, 256)
    assert _same_ops(a, b) and len(a) > 100
    ts = [op.t_us for op in a]
    assert ts == sorted(ts)
    assert all(0 <= t < 500_000 for t in ts)
    assert all(op.ids.size == 8 and op.ids.dtype == np.int32
               for op in a)


def test_read_write_mix_follows_fraction():
    sc = Scenario(duration_s=1.0, qps=500, read_fraction=0.7, seed=1)
    ops = build_ops(sc, 128)
    writes = sum(1 for op in ops if op.op == OP_APPLY)
    frac = writes / len(ops)
    assert 0.2 < frac < 0.4                    # ~0.3 expected


def test_zipf_skew_concentrates_on_hot_ranks():
    w = zipf_weights(1000, 1.2)
    assert abs(w.sum() - 1.0) < 1e-9
    assert w[0] > 50 * w[999]
    sc = Scenario(duration_s=1.0, qps=400, batch=16, zipf_s=1.2,
                  seed=2)
    ops = build_ops(sc, 1000)
    counts = np.bincount(
        np.concatenate([op.ids for op in ops]), minlength=1000)
    # the hottest decile draws a large multiple of the coldest
    assert counts[:100].sum() > 5 * counts[900:].sum()


def test_burst_windows_arrive_denser_than_steady():
    sc = Scenario(duration_s=2.0, qps=100, burst_qps=1000,
                  burst_every_s=1.0, burst_len_s=0.25, seed=4)
    ops = build_ops(sc, 64)
    in_burst = sum(1 for op in ops
                   if (op.t_us / 1e6) % 1.0 < 0.25)
    out_burst = len(ops) - in_burst
    # 0.5s of burst at 10x the rate vs 1.5s steady
    assert in_burst > 2 * out_burst


# ---------------------------------------------------------------------------
# trace record/replay
# ---------------------------------------------------------------------------

def test_trace_roundtrip_exact(tmp_path):
    sc = Scenario(duration_s=0.3, qps=300, batch=5,
                  read_fraction=0.8, seed=9)
    ops = build_ops(sc, 512)
    path = os.path.join(tmp_path, "t.trace")
    press.save_trace(path, ops, seed=9, vocab=512, dim=16)
    meta, back = press.load_trace(path)
    assert meta == {"seed": 9, "vocab": 512, "dim": 16}
    assert _same_ops(ops, back)


def test_trace_rejects_corruption():
    ops = [PressOp(10, OP_LOOKUP, np.arange(3, dtype=np.int32))]
    blob = trace_bytes(ops, seed=1, vocab=64, dim=4)
    with pytest.raises(wire.WireError):
        parse_trace(blob[:-1])                 # truncated record
    with pytest.raises(wire.WireError):
        parse_trace(blob + b"x")               # trailing junk
    bad_magic = b"\x00" + blob[1:]
    with pytest.raises(wire.WireError):
        parse_trace(bad_magic)
    # a count lying past the bytes present
    lied = bytearray(blob)
    struct.pack_into("<i", lied, 28, 99)       # header count field
    with pytest.raises(wire.WireError):
        parse_trace(bytes(lied))
    # a negative id count inside a record
    neg = bytearray(blob)
    struct.pack_into("<i", neg, 32 + 12, -1)   # record nids
    with pytest.raises(wire.WireError):
        parse_trace(bytes(neg))
    # an unknown op kind
    kind = bytearray(blob)
    struct.pack_into("<i", kind, 32 + 8, 9)    # record op field
    with pytest.raises(wire.WireError):
        parse_trace(bytes(kind))


def test_trace_schema_parity_with_hand_rolled_packers():
    """The hand-rolled press packers are byte-identical to the
    declared schemas (the wire-contract parity discipline)."""
    hdr = wire.REGISTRY["press_header"]
    assert press._pack_press_header(seed=5, vocab=100, dim=8,
                                    count=2) == hdr.pack({
        "magic": wire.PRESS_MAGIC, "version": press.PRESS_VERSION,
        "seed": 5, "vocab": 100, "dim": 8, "count": 2})
    rec = wire.REGISTRY["press_record"]
    op = PressOp(77, OP_APPLY, np.array([1, 5, 9], np.int32))
    assert press._pack_press_record(op) == rec.pack({
        "t_us": 77, "op": OP_APPLY, "nids": 3, "ids": op.ids})


# ---------------------------------------------------------------------------
# the live driver (native)
# ---------------------------------------------------------------------------

@pytest.mark.needs_native
def test_run_press_steady_under_capacity():
    from brpc_tpu_torch.ps_remote import PsShardServer
    srv = PsShardServer(256, 8, 0, 1)
    try:
        sc = Scenario(duration_s=0.6, qps=200, batch=8,
                      read_fraction=0.8, seed=5)
        ops = build_ops(sc, 256)
        rep = press.run_press(srv.address, ops, 8, deadline_ms=200,
                              stamp_deadline=True)
        assert rep["n"] == len(ops)
        assert rep["availability"] == 1.0
        assert rep["goodput_qps"] > 0
        assert rep["p99_ms"] <= 200
        assert rep["stamped"] is True
        # the writes actually landed: the table moved
        assert srv._install_gen > 0
    finally:
        srv.close()


@pytest.mark.needs_native
def test_run_press_retry_on_limit_absorbs_admission_spikes():
    """A 1-slot gate under a concurrency-2 schedule: bare runs shed,
    the ELIMIT-retry client policy absorbs them."""
    from brpc_tpu_torch.ps_remote import PsShardServer
    srv = PsShardServer(256, 8, 0, 1, limiter="constant:1")
    try:
        # all ops due at ~t=0: guaranteed admission collisions
        ops = [PressOp(i * 100, OP_LOOKUP,
                       np.arange(4, dtype=np.int32))
               for i in range(40)]
        bare = press.run_press(srv.address, ops, 8, deadline_ms=500)
        retried = press.run_press(srv.address, ops, 8,
                                  deadline_ms=500, retry_on_limit=3,
                                  limit_backoff_ms=2.0)
        assert retried["availability"] >= bare["availability"]
        assert retried["availability"] >= 0.97
    finally:
        srv.close()


def test_cli_record_then_replay_file(tmp_path):
    path = os.path.join(tmp_path, "cli.trace")
    rc = press.main(["--record", path, "--qps", "300", "--duration",
                     "0.2", "--vocab", "128", "--seed", "6"])
    assert rc == 0
    meta, ops = press.load_trace(path)
    assert meta["vocab"] == 128 and len(ops) > 20
    # the same seed regenerates the identical stream
    again = build_ops(Scenario(duration_s=0.2, qps=300, seed=6), 128)
    assert _same_ops(ops, again)


def test_cli_is_runnable_as_module():
    out = subprocess.run(
        [sys.executable, "-m", "brpc_tpu_torch.press", "--help"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0
    assert "rpc_press" in out.stdout


@pytest.mark.needs_native
def test_run_press_multi_channel_pacer():
    """channels=N paces over N native connections round-robin (the
    multi-core client-ceiling satellite): same determinism and SLO
    surface, per-channel retry legs, and a report that names the
    fan-out.  Relative-budget stamping (v2) rides the same path."""
    from brpc_tpu_torch.ps_remote import PsShardServer
    srv = PsShardServer(256, 8, 0, 1)
    try:
        sc = Scenario(duration_s=0.5, qps=240, batch=8,
                      read_fraction=0.7, seed=9)
        ops = build_ops(sc, 256)
        rep = press.run_press(srv.address, ops, 8, deadline_ms=300,
                              stamp_deadline=True,
                              stamp_mode="relative", channels=3)
        assert rep["channels"] == 3
        assert rep["stamp_mode"] == "relative"
        assert rep["n"] == len(ops)
        assert rep["availability"] == 1.0
        assert srv._install_gen > 0     # v2-stamped writes landed
        # single-channel equivalence: the op stream is identical, so
        # the table advanced the same number of write batches
        gen_multi = srv._install_gen
        rep1 = press.run_press(srv.address, ops, 8, deadline_ms=300,
                               channels=1)
        assert rep1["channels"] == 1
        assert rep1["availability"] == 1.0
        assert srv._install_gen == 2 * gen_multi
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

PARITY_SCENARIOS = {
    "steady": dict(duration_s=0.5, qps=300, batch=8, read_fraction=0.9,
                   seed=11),
    "zipf": dict(duration_s=0.5, qps=300, batch=16, read_fraction=0.9,
                 zipf_s=1.2, seed=11),
    "burst": dict(duration_s=1.0, qps=100, batch=4, read_fraction=0.7,
                  burst_qps=1000, burst_every_s=0.5, burst_len_s=0.1,
                  seed=4),
}


@pytest.mark.parametrize("name", sorted(PARITY_SCENARIOS))
def test_streams_and_traces_equal_to_reference(name):
    kw = PARITY_SCENARIOS[name]
    ours = build_ops(Scenario(name=name, **kw), 512)
    theirs = ref_press.build_ops(ref_press.Scenario(name=name, **kw), 512)
    assert len(ours) > 20 and _same_ops(ours, theirs)
    blob = trace_bytes(ours, seed=kw["seed"], vocab=512, dim=16)
    ref_blob = ref_press.trace_bytes(theirs, seed=kw["seed"], vocab=512,
                                     dim=16)
    assert blob == ref_blob
    meta, back = parse_trace(ref_blob)
    ref_meta, ref_back = ref_press.parse_trace(blob)
    assert meta == ref_meta == {"seed": kw["seed"], "vocab": 512, "dim": 16}
    assert _same_ops(back, ours) and _same_ops(ref_back, ours)


def test_constants_and_report_surface_match_reference():
    assert press.GRAD_VALUE == ref_press.GRAD_VALUE
    assert press.PRESS_VERSION == ref_press.PRESS_VERSION
    assert (press.OP_LOOKUP, press.OP_APPLY) == (ref_press.OP_LOOKUP,
                                                 ref_press.OP_APPLY)
    assert Scenario() == Scenario(**vars(ref_press.Scenario()))
    assert press.__all__ == ref_press.__all__


# ---------------------------------------------------------------------------
# the open-loop driver against the port's device shard (CPU client)
# ---------------------------------------------------------------------------

@pytest.mark.needs_native
def test_run_press_against_device_shard_matches_host_replay():
    from brpc_tpu_torch.device import DeviceClient
    from brpc_tpu_torch.ps_remote import DevicePsShardServer
    vocab, dim, lr = 512, 16, 0.05
    dev = DeviceClient("cpu")
    srv = DevicePsShardServer(vocab, dim, 0, 1, lr=lr, seed=3,
                              device_client=dev)
    try:
        replay = srv.table.copy()
        assert srv._dev_serving
        sc = Scenario(duration_s=0.6, qps=100, batch=16,
                      read_fraction=0.8, zipf_s=1.2, seed=11)
        ops = build_ops(sc, vocab)
        applies = [op for op in ops if op.op == OP_APPLY]
        assert applies and len(applies) < len(ops)
        rep = press.run_press(srv.address, ops, dim)
        assert rep["n"] == rep["ok"] == len(ops) and rep["errors"] == {}
        assert srv._dev_serving
        # Every apply subtracts the same f32 value lr * GRAD_VALUE from
        # each of its rows, so the replay is exact in any apply order.
        for op in applies:
            grads = np.full((op.ids.size, dim), press.GRAD_VALUE,
                            np.float32)
            np.subtract.at(replay, op.ids, lr * grads)
        assert srv.table.tobytes() == replay.tobytes()
    finally:
        srv.close()
        dev.close()


# F5: press's mixed open-loop load into both packages' device shards on
# their CPU clients (the reference's on its test PJRT plugin, built from
# cpp/ as tests/test_torch_device_programs.py builds it): 400 qps, one op in
# ten an ApplyGrad of 256 ids, a 16384 x 512 table and a 2 s deadline an
# op. Before the repair the port's shard served 83-128 of 763 ops (the
# rest timed out) where the reference's served all.
F5_SCENARIO = dict(duration_s=2.0, qps=400, batch=256, read_fraction=0.9,
                   seed=11)
F5_VOCAB, F5_DIM, F5_LR, F5_DEADLINE_MS = 16384, 512, 0.05, 2000


@pytest.fixture(scope="module")
def fake_pjrt(tmp_path_factory):
    """The reference's test plugin, built from ``cpp/`` into a temp dir."""
    out = tmp_path_factory.mktemp("fake_pjrt") / "libbrt_fake_pjrt.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-fPIC", "-shared",
                    "-I", os.path.join(ROOT, "cpp"),
                    os.path.join(ROOT, "cpp", "device",
                                 "fake_pjrt_plugin.cc"),
                    "-o", str(out)], check=True, capture_output=True,
                   timeout=300)
    return str(out)


def _press_device_shard(press_mod, obs_mod, server_cls, client):
    """Drives F5's load into a device shard on ``client``; returns press's
    report, the shard's wasted launches, and whether its final table
    equals a host replay of every apply bit for bit."""
    srv = server_cls(F5_VOCAB, F5_DIM, 0, 1, lr=F5_LR, seed=3,
                     device_client=client)
    try:
        replay = srv.table.copy()
        ops = press_mod.build_ops(press_mod.Scenario(**F5_SCENARIO),
                                  F5_VOCAB)
        applies = [op for op in ops if op.op == press_mod.OP_APPLY]
        wasted = obs_mod.counter("ps_device_wasted_launches")
        wasted_before, installs_before = wasted.get_value(), srv._install_gen
        rep = press_mod.run_press(srv.address, ops, F5_DIM,
                                  deadline_ms=F5_DEADLINE_MS)
        # An apply whose caller timed out still lands on the shard.
        settle = time.monotonic() + 30.0
        while srv._install_gen - installs_before < len(applies) \
                and time.monotonic() < settle:
            time.sleep(0.05)
        for op in applies:
            np.subtract.at(replay, op.ids,
                           F5_LR * np.full((op.ids.size, F5_DIM),
                                           press_mod.GRAD_VALUE,
                                           np.float32))
        exact = srv.table.tobytes() == replay.tobytes()
        return rep, wasted.get_value() - wasted_before, exact
    finally:
        srv.close()


@pytest.mark.needs_native
def test_device_shard_serves_mixed_load_as_reference_does(
        fake_pjrt, monkeypatch, record_property):
    """The port's shard serves every op of F5's load wherever the
    reference's does, and its table ends bit-equal to a host replay."""
    from brpc_tpu import obs as ref_obs
    from brpc_tpu import rpc as ref_rpc
    from brpc_tpu.ps_remote import DevicePsShardServer as RefShard
    from brpc_tpu_torch import obs
    from brpc_tpu_torch.device import DeviceClient
    from brpc_tpu_torch.ps_remote import DevicePsShardServer

    monkeypatch.setenv("BRT_FAKE_PJRT_DEVICES", "1")
    ref_client = ref_rpc.DeviceClient(fake_pjrt)
    try:
        ref_rep, ref_wasted, ref_exact = _press_device_shard(
            ref_press, ref_obs, RefShard, ref_client)
    finally:
        ref_client.close()
    client = DeviceClient("cpu")
    try:
        rep, wasted, exact = _press_device_shard(press, obs,
                                                 DevicePsShardServer, client)
    finally:
        client.close()
    for side, r, w in (("reference", ref_rep, ref_wasted),
                       ("port", rep, wasted)):
        record_property(f"{side}_ok", f"{r['ok']} of {r['n']}")
        record_property(f"{side}_wasted_launches", w)
        print(f"F5 {side}: {r['ok']} of {r['n']} ok, errors {r['errors']}, "
              f"goodput {r['goodput_qps']:.1f} qps, {w} wasted launches")
    assert ref_exact and ref_rep["n"] == rep["n"]
    if ref_rep["ok"] == ref_rep["n"]:
        assert rep["ok"] == rep["n"], (rep["ok"], rep["errors"])
    assert exact
