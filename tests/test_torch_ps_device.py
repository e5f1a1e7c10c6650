"""The port's device PS shard on the CPU, beside the reference.

``brpc_tpu_torch.ps_remote.DevicePsShardServer`` is the reference's device
shard copied into the port; its device client is the port's torch
``DeviceClient`` (``brpc_tpu_torch/device.py``), run here on the CPU, where
the programs are the plain versions of ``ops/embedding_rows.py``.

- Parity: the port's device shard and the reference's CPU
  ``brpc_tpu.ps_remote.PsShardServer`` get the same Lookup/ApplyGrad stream
  over RPC (random grads that are not powers of two, repeated ids, lr 0.1),
  with the combiner off and on; every Lookup's bytes and the final tables
  are equal bit for bit. The reference's PJRT device shard is not the
  yardstick: without a plugin its tests skip.
- The reference's device scenarios (``tests/test_ps_device.py``: lookup,
  apply, a training round trip, the combiner's single launch, stream push,
  failover, a fenced stale primary, checkpoint cold restart, a split
  severed mid-copy, a split's shipper retargeted to a promoted backup, the
  rebalancer's failback), translated: the port's modules (``reshard``'s
  ``MigrationDriver``, ``rebalance``'s ``Rebalancer``) and a CPU client in
  place of the PJRT one.
- Marked ``cuda``: the same shard on the card against the shard on the CPU,
  bit for bit, and the fault matrix's six scenarios (failover, the fenced
  primary, the cold restart, the two splits, the failback) on the card's
  client; they skip without a card.

Each package loads its own build of the native core (the reference's
``cpp/build/``, the port's ``brpc_tpu_torch/_build/native/``), each with its
own globals (the drop hook, the flags): a test that runs both side by side
talks to each side through that side's own ``rpc``, and a fault plan
installed through the port's ``fault`` reaches only the port's servers. Every
test ends with no net growth of the port's handle ledger, except where the
module-scoped shard fills its executable cache, as in the reference.
"""

import struct
import threading
import time

import numpy as np
import pytest
import torch

from brpc_tpu import ps_remote as ref_ps
from brpc_tpu_torch import fault, obs, resilience, rpc
from brpc_tpu_torch.analysis import handles
from brpc_tpu_torch.device import DeviceClient
from brpc_tpu_torch.durable import CheckpointStore
from brpc_tpu_torch.naming import (NamingClient, PartitionScheme,
                                   ReplicaSet, publish_scheme)
from brpc_tpu_torch.ops import embedding_rows as er
from brpc_tpu_torch.ps_remote import (DevicePsShardServer, RemoteEmbedding,
                                      _pack_apply_req)
from brpc_tpu_torch.rebalance import (RebalanceOptions, RebalancePolicy,
                                      Rebalancer)
from brpc_tpu_torch.reshard import MigrationDriver

pytestmark = pytest.mark.needs_native

VOCAB, DIM = 16, 8


@pytest.fixture(autouse=True)
def _obs_on():
    was = obs.enabled()
    obs.set_enabled(True)
    yield
    obs.set_enabled(was)
    fault.clear()


@pytest.fixture(autouse=True)
def _port_leak_gate(request):
    """No net growth of the port's handle ledger across a test."""
    if "allow_handle_leak" in request.node.keywords \
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


@pytest.fixture(scope="module")
def shard():
    dev = DeviceClient(device="cpu")
    s = DevicePsShardServer(VOCAB, DIM, 0, 1, lr=0.5, device_client=dev)
    emb = RemoteEmbedding([s.address], VOCAB, DIM, timeout_ms=120000)
    yield s, emb
    emb.close()
    s.close()
    dev.close()


# allow_handle_leak: the module-scoped `shard` fixture compiles its
# gather/scatter executables lazily inside these tests and caches them
# for the module's lifetime — net-per-test handle growth is the cache
# filling, released at fixture teardown, not a leak.
@pytest.mark.allow_handle_leak
def test_device_lookup_matches_resident_table(shard):
    s, emb = shard
    host = s.table  # DMA snapshot of the HBM-resident table
    ids = np.array([0, 3, 7, 15], np.int32)
    rows = emb.lookup(ids)
    np.testing.assert_allclose(rows, host[ids], rtol=1e-6)


@pytest.mark.allow_handle_leak  # same module-fixture exe-cache growth
def test_device_apply_grad_updates_hbm_table(shard):
    s, emb = shard
    before = s.table
    ids = np.array([1, 2, 5, 5], np.int32)  # duplicate: must accumulate
    grads = np.ones((4, DIM), np.float32)
    emb.apply_gradients(ids, grads)
    after = s.table
    np.testing.assert_allclose(after[1], before[1] - 0.5, rtol=1e-5)
    np.testing.assert_allclose(after[2], before[2] - 0.5, rtol=1e-5)
    # row 5 got BOTH contributions (scatter-add semantics on device)
    np.testing.assert_allclose(after[5], before[5] - 1.0, rtol=1e-5)
    # untouched rows stay put
    np.testing.assert_allclose(after[0], before[0], rtol=1e-6)


def test_device_training_step_roundtrip(shard):
    s, emb = shard
    ids = np.array([4, 6, 8, 9], np.int32)
    target = np.zeros((4, DIM), np.float32)
    first_loss = None
    for _ in range(5):
        rows = emb.lookup(ids)
        loss = float(((rows - target) ** 2).mean())
        if first_loss is None:
            first_loss = loss
        emb.apply_gradients(ids, rows - target)
    assert float(((emb.lookup(ids) - target) ** 2).mean()) < first_loss


def test_device_combiner_single_launch_no_wasted_scatters():
    """combine=True routes every ApplyGrad through the combiner: the
    lost-swap redo loop never races itself (one installer at a time), so
    wasted scatter launches stay at ZERO under 8-writer fan-in and the
    table still sums exactly."""
    obs.set_enabled(True)  # earlier suites may leave obs off
    dev = DeviceClient(device="cpu")
    s = DevicePsShardServer(VOCAB, DIM, 0, 1, lr=0.5, device_client=dev,
                            combine=True)
    emb = RemoteEmbedding([s.address], VOCAB, DIM, timeout_ms=120000)
    try:
        before = s.table
        wasted0 = obs.counter("ps_device_wasted_launches").get_value()
        ids = np.arange(8, dtype=np.int32)
        g = np.ones((8, DIM), np.float32)

        def writer():
            e = RemoteEmbedding([s.address], VOCAB, DIM,
                                timeout_ms=120000)
            try:
                for _ in range(3):
                    e.apply_gradients(ids, g)
            finally:
                e.close()

        threads = [threading.Thread(target=writer) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        after = s.table
        # 8 writers x 3 rounds x lr 0.5 x ones = exactly -12.0
        np.testing.assert_allclose(after[:8], before[:8] - 12.0,
                                   rtol=1e-5)
        assert obs.counter("ps_device_wasted_launches").get_value() \
            == wasted0
        assert obs.counter("ps_combined_applies").get_value() > 0
    finally:
        emb.close()
        s.close()
        dev.close()


def test_device_stream_push_applies_through_combiner():
    dev = DeviceClient(device="cpu")
    s = DevicePsShardServer(VOCAB, DIM, 0, 1, lr=0.5, device_client=dev,
                            stream=True)
    emb = RemoteEmbedding([s.address], VOCAB, DIM, timeout_ms=120000)
    try:
        before = s.table
        ids = np.array([2, 3, 3], np.int32)  # duplicate: must accumulate
        emb.push_gradients(ids, np.ones((3, DIM), np.float32))
        emb.flush_gradients()
        after = s.table
        np.testing.assert_allclose(after[2], before[2] - 0.5, rtol=1e-5)
        np.testing.assert_allclose(after[3], before[3] - 1.0, rtol=1e-5)
    finally:
        emb.close()
        s.close()
        dev.close()


# ---------------------------------------------------------------------------
# The fault matrix: the device tier is a first-class citizen of
# the replication / fencing / checkpoint / migration machinery — the
# SAME scenarios test_replication.py / test_reshard.py / test_durable.py
# prove on the CPU tier, with the serving table resident in HBM.
# ---------------------------------------------------------------------------


def _device_pair(dev, **kw):
    """1 shard x 2 device replicas, replica 0 the boot primary (serving
    from HBM), replica 1 a backup folded down to its host mirror."""
    servers = [DevicePsShardServer(VOCAB, DIM, 0, 1, lr=1.0,
                                   device_client=dev, **kw)
               for _ in range(2)]
    rs = ReplicaSet(tuple(sv.address for sv in servers), primary=0)
    for r, sv in enumerate(servers):
        sv.configure_replication(rs, r)
    return servers, rs


def _wait_delta_streams(primary, timeout_s=5.0):
    """Until the primary's delta stream to every backup is up. A pair acks
    a write without a backup whose stream is not yet up (the legacy
    barrier), so a write made earlier may live on the primary alone."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and not all(
            p.stream is not None and not p.need_sync
            for p in primary._replicator._peers):
        time.sleep(0.01)


def _retry_policy(attempts=4, attempt_ms=500):
    return resilience.RetryPolicy(
        max_attempts=attempts,
        backoff=resilience.Backoff(base_ms=1, max_ms=10),
        attempt_timeout_ms=attempt_ms)


def _close_all(*servers):
    for sv in servers:
        sv.close()


# The fault matrix runs on the CPU client and, marked ``cuda``, on the card
# (the kernels); a ``cuda`` case skips without a card.
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _client(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return DeviceClient(device=device)


@pytest.mark.parametrize("device", DEVICES)
def test_device_kill_primary_failover_zero_failed_lookups(device):
    """Kill the HBM-serving primary under sustained load: every lookup
    and write still succeeds (redirect + failover), the backup's host
    mirror is STAGED INTO HBM at promotion, and the revived ex-primary
    is fenced back to a host-mirror backup."""
    dev = _client(device)
    servers, rs = _device_pair(dev)
    emb = RemoteEmbedding(
        [rs], VOCAB, DIM, timeout_ms=10000, retry=_retry_policy(),
        breakers=resilience.BreakerRegistry(
            resilience.BreakerOptions(short_window=4, min_samples=2,
                                      min_isolation_ms=50),
            redirect=True),
        health_check=True, health_interval_ms=20)
    ids = np.arange(VOCAB, dtype=np.int32)
    grads = np.ones((VOCAB, DIM), np.float32)
    stages0 = int(obs.counter("ps_device_promote_stages").get_value())
    mirrors0 = int(obs.counter("ps_device_mirror_downs").get_value())
    try:
        assert servers[0]._dev_serving and not servers[1]._dev_serving
        # The reference's scenario writes at once and loses that write
        # with the primary when the backup's stream is not up yet (the
        # client then refuses a lossy promotion): wait for the stream.
        _wait_delta_streams(servers[0])
        emb.apply_gradients(ids, grads)      # warm: streams + replicas
        prim = servers[0].address
        fault.install(fault.FaultPlan(fault.kill_rules(prim), seed=3))
        # sustained load with the primary dead: every batch must
        # succeed — redirect + failover, never an exception
        t_end = time.monotonic() + 1.0
        reads = writes = 0
        while time.monotonic() < t_end:
            emb.lookup(ids)
            reads += 1
            emb.apply_gradients(ids, grads)
            writes += 1
        assert reads > 5 and writes > 5
        # the backup was promoted with a fencing epoch AND its mirror
        # was staged into HBM — it now serves the device path
        assert servers[1].is_primary and servers[1].epoch >= 1
        assert servers[1]._dev_serving
        assert int(obs.counter("ps_device_promote_stages").get_value()) \
            > stages0
        assert int(obs.counter("ps_client_failovers").get_value()) >= 1
        fault.clear()
        # the prober revives the corpse; the new primary's propagation
        # fences it into a BACKUP — which folds its HBM table down
        # into the host mirror (nothing device-applied is lost)
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline and emb._isolated(prim):
            time.sleep(0.02)
        assert not emb._isolated(prim)
        emb.apply_gradients(ids, grads)
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline and (
                servers[0].is_primary or servers[0]._dev_serving
                or int(obs.counter("ps_device_mirror_downs").get_value())
                <= mirrors0):  # the fold counts itself last
            time.sleep(0.02)
        assert not servers[0].is_primary
        assert not servers[0]._dev_serving
        assert int(obs.counter("ps_device_mirror_downs").get_value()) \
            > mirrors0
    finally:
        fault.clear()
        emb.close()
        _close_all(*servers)
        dev.close()


@pytest.mark.parametrize("device", DEVICES)
def test_device_fenced_stale_primary_rejected_and_mirrored_down(device):
    """An out-of-band promotion the HBM-serving primary never heard
    about: its next propagation is refused with EFENCED, the write is
    NOT acked, and the stale primary demotes itself — folding the live
    device table down into the host mirror."""
    dev = _client(device)
    servers, _ = _device_pair(dev)
    old, new = servers
    mirrors0 = int(obs.counter("ps_device_mirror_downs").get_value())
    try:
        # wait for the (eagerly connected) delta stream: the fence
        # notification rides its reply half
        _wait_delta_streams(old)
        # Partition the old primary's replication CONTROL plane so the
        # new primary cannot inform it (otherwise the eager propagation
        # demotes it instantly) — the old data stream stays up.
        fault.install(fault.FaultPlan([
            fault.FaultRule(action="error", side="server", service="Ps",
                            method="Sync", endpoint=old.address,
                            error_code=1009),
            fault.FaultRule(action="error", side="server", service="Ps",
                            method="ReplicaApply", endpoint=old.address,
                            error_code=1009)], seed=1))
        # Out-of-band promotion (epoch 1): stages the backup's host
        # mirror into HBM before the promote response lands.
        ch_new = rpc.Channel(new.address, timeout_ms=5000)
        try:
            ch_new.call("Ps", "Promote", struct.pack("<q", 1))
        finally:
            ch_new.close()
        assert new.is_primary and new.epoch == 1 and new._dev_serving
        assert old.is_primary            # stale, unaware, still on HBM
        ch_old = rpc.Channel(old.address, timeout_ms=5000)
        try:
            with pytest.raises(rpc.RpcError) as ei:
                ch_old.call("Ps", "ApplyGrad", bytes(_pack_apply_req(
                    np.arange(4, dtype=np.int32),
                    np.ones((4, DIM), np.float32))))
            assert ei.value.code == resilience.EFENCED
            # demoted: the next write is refused outright
            with pytest.raises(rpc.RpcError) as ei2:
                ch_old.call("Ps", "ApplyGrad", bytes(_pack_apply_req(
                    np.arange(4, dtype=np.int32),
                    np.ones((4, DIM), np.float32))))
            assert ei2.value.code == resilience.ENOTPRIMARY
        finally:
            ch_old.close()
        assert not old.is_primary
        # the fence demotion folded the device table into the mirror; the
        # fold runs after the demotion, on the thread that saw the fence,
        # and counts itself last (the reference's scenario read both at
        # once and raced that fold)
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline and (
                old._dev_serving or int(obs.counter(
                    "ps_device_mirror_downs").get_value()) <= mirrors0):
            time.sleep(0.02)
        assert not old._dev_serving
        assert int(obs.counter("ps_device_mirror_downs").get_value()) \
            > mirrors0
        assert int(obs.counter("ps_replica_fenced").get_value()) >= 1
    finally:
        _close_all(*servers)
        dev.close()


@pytest.mark.parametrize("device", DEVICES)
def test_device_checkpoint_cold_restart_bit_exact(tmp_path, device):
    """Cold restart from the durable ledger: every delta the device
    primary ACKED is teed into the CheckpointStore, and a FRESH device
    server replays base + chain to the exact acked generation —
    byte-for-byte, through the HBM roundtrip."""
    dev = _client(device)
    sv = DevicePsShardServer(VOCAB, DIM, 0, 1, lr=1.0, seed=3,
                             device_client=dev)
    store = CheckpointStore(str(tmp_path))
    emb = RemoteEmbedding([sv.address], VOCAB, DIM, timeout_ms=120000)
    ids = np.arange(VOCAB, dtype=np.int32)
    try:
        assert sv.attach_checkpoint(store) is None  # nothing to recover
        assert sv._dev_serving                      # re-staged after tee
        for d in (0.5, 0.25, 0.125):
            emb.apply_gradients(ids, np.full((VOCAB, DIM), d,
                                             np.float32))
        expect = sv.table.copy()
        gen = sv._install_gen
    finally:
        emb.close()
        sv.close()
        store.close()
    # cold restart: fresh process state, same store root
    sv2 = DevicePsShardServer(VOCAB, DIM, 0, 1, lr=1.0, seed=3,
                              device_client=dev)
    store2 = CheckpointStore(str(tmp_path))
    try:
        point = sv2.attach_checkpoint(store2)
        assert point is not None and point.gen == gen
        assert sv2._install_gen == gen
        assert sv2._dev_serving                     # recovered AND serving
        assert np.array_equal(sv2.table, expect)    # bit-exact ledger
        # the gen-0 base was stamped seeded: it is a real snapshot of
        # the seeded table, not mistakable for a fresh one
        assert store2.load_base()[4]
        # the tee re-armed: device applies keep checkpointing
        emb2 = RemoteEmbedding([sv2.address], VOCAB, DIM,
                               timeout_ms=120000)
        try:
            emb2.apply_gradients(ids, np.full((VOCAB, DIM), 0.5,
                                              np.float32))
        finally:
            emb2.close()
        assert store2.last_gen == sv2._install_gen
    finally:
        sv2.close()
        store2.close()
        dev.close()



# -- resharding and the rebalancer on the device tier ------------------------


@pytest.mark.parametrize("device", DEVICES)
def test_device_split_severed_midcopy_recovers_byte_identical(device):
    """A LIVE 1→2 split off a device-serving source with the handoff
    plane of one destination severed mid-copy: the shipper backs off,
    reconnects, resyncs the range wholesale, and after cutover the
    destination DEVICE shards hold exactly the source's bytes — the
    generation-pinned device snapshot feeding unchanged MigrateSync
    framing."""
    dev = _client(device)
    src = DevicePsShardServer(VOCAB, DIM, 0, 1, lr=1.0,
                              device_client=dev)
    new = [DevicePsShardServer(VOCAB, DIM, s, 2, lr=1.0, importing=True,
                               scheme_version=1, device_client=dev)
           for s in range(2)]
    sc0 = PartitionScheme(0, (ReplicaSet.of(src.address),))
    sc1 = PartitionScheme(1, tuple(ReplicaSet.of(sv.address)
                                   for sv in new))
    emb = RemoteEmbedding([sc0], VOCAB, DIM, timeout_ms=10000,
                          retry=_retry_policy())
    ids = np.arange(VOCAB, dtype=np.int32)
    before = src.table.copy()
    drv = MigrationDriver(sc0, sc1, VOCAB)
    try:
        emb.apply_gradients(ids, np.full((VOCAB, DIM), 0.5, np.float32))
        # the first 3 handoff attempts at destination 1 die mid-stream
        fault.install(fault.FaultPlan(fault.partition_rules(
            new[1].address, max_hits=3), seed=5))
        drv.start()
        emb.apply_gradients(ids, np.full((VOCAB, DIM), 0.25,
                                         np.float32))
        drv.wait_caught_up(deadline_s=30)
        fault.clear()
        drv.cutover()
        # cutover's CompleteImport opened the destinations for
        # business: device primaries stage their imported mirrors
        # into device memory and serve the device path
        assert all(sv._dev_serving for sv in new)
        emb.set_schemes([sc0.with_(state="draining", weight=0.0), sc1])
        emb.apply_gradients(ids, np.full((VOCAB, DIM), 0.125,
                                         np.float32))
        expect = before.copy()
        for d in (0.5, 0.25, 0.125):
            expect[ids] -= np.float32(d)
        assert np.array_equal(
            np.concatenate([sv.table for sv in new]), expect)
        assert int(obs.counter(
            "ps_migrate_connect_errors").get_value()) >= 1
    finally:
        fault.clear()
        drv.close()
        emb.close()
        _close_all(src, *new)
        dev.close()


@pytest.mark.parametrize("device", DEVICES)
def test_device_split_shipper_retargets_to_promoted_dest_backup(device):
    """Kill a REPLICATED destination's primary mid-split: the stranded
    shipper sweeps the destination replica group (``ReplicaState``,
    highest claiming epoch wins), re-points at the promoted backup and
    resyncs wholesale — ``ps_migration_retargets`` counts the save and
    the survivor converges byte-identical."""
    dev = _client(device)
    src = DevicePsShardServer(VOCAB, DIM, 0, 1, lr=1.0,
                              device_client=dev)
    dst_a = DevicePsShardServer(VOCAB, DIM, 0, 2, lr=1.0,
                                importing=True, scheme_version=1,
                                device_client=dev)
    dst_b = DevicePsShardServer(VOCAB, DIM, 0, 2, lr=1.0,
                                importing=True, scheme_version=1,
                                device_client=dev)
    dst_1 = DevicePsShardServer(VOCAB, DIM, 1, 2, lr=1.0,
                                importing=True, scheme_version=1,
                                device_client=dev)
    rs0 = ReplicaSet((dst_a.address, dst_b.address), primary=0)
    dst_a.configure_replication(rs0, 0)
    dst_b.configure_replication(rs0, 1)
    sc0 = PartitionScheme(0, (ReplicaSet.of(src.address),))
    sc1 = PartitionScheme(1, (rs0, ReplicaSet.of(dst_1.address)))
    emb = RemoteEmbedding([sc0], VOCAB, DIM, timeout_ms=10000,
                          retry=_retry_policy())
    ids = np.arange(VOCAB, dtype=np.int32)
    retargets0 = int(obs.counter("ps_migration_retargets").get_value())
    drv = MigrationDriver(sc0, sc1, VOCAB)
    try:
        emb.apply_gradients(ids, np.full((VOCAB, DIM), 0.5, np.float32))
        drv.start()
        drv.wait_caught_up(deadline_s=30)   # initial copy lands
        # destination primary dies; the backup is promoted out-of-band
        # (the rebalancer's job) — the fixed spec address now strands
        # the shipper until the ReplicaState sweep re-points it
        fault.install(fault.FaultPlan(
            fault.kill_rules(dst_a.address), seed=7))
        ch = rpc.Channel(dst_b.address, timeout_ms=5000)
        try:
            ch.call("Ps", "Promote", struct.pack("<q", 1))
        finally:
            ch.close()
        assert dst_b.is_primary
        emb.apply_gradients(ids, np.full((VOCAB, DIM), 0.25,
                                         np.float32))
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and int(obs.counter(
                "ps_migration_retargets").get_value()) <= retargets0:
            time.sleep(0.02)
        assert int(obs.counter("ps_migration_retargets").get_value()) \
            > retargets0
        drv.wait_caught_up(deadline_s=30)
        # the promoted backup holds the source's exact bytes for its
        # range (wholesale resync: it never saw MigrateApply)
        half = VOCAB // 2
        src_now = src.table
        assert np.array_equal(dst_b.table, src_now[:half])
        assert np.array_equal(dst_1.table, src_now[half:])
    finally:
        fault.clear()
        drv.abort()
        drv.close()
        emb.close()
        _close_all(src, dst_a, dst_b, dst_1)
        dev.close()


@pytest.mark.parametrize("device", DEVICES)
def test_device_rebalancer_failback_restages_declared_primary(device):
    """The rebalancer's autonomous failback on the device tier: a
    usurped device-serving primary that came back as a host-mirror
    backup is promoted back once caught up — and the fenced Promote
    restages its mirror into device memory. The port's rebalance.py, a
    copy of the reference's, needs no device knowledge: the same
    ReplicaState freshness gate and Promote wire call drive both
    tiers."""
    dev = _client(device)
    servers, rs = _device_pair(dev)
    declared, usurper = servers
    reg_server = rpc.Server()
    reg_server.add_naming_registry()
    reg_addr = f"127.0.0.1:{reg_server.start('127.0.0.1:0')}"
    nc = NamingClient(reg_addr)
    publish_scheme(nc, "ps", PartitionScheme(1, (rs,)))
    for sv in servers:
        nc.register("ps", sv.address, ttl_ms=500, tag_fn=sv.claim_tag)
    reb = Rebalancer(reg_addr, "ps", VOCAB,
                     policy=RebalancePolicy(RebalanceOptions(
                         failback_sustain_s=0.0)))
    ids = np.arange(8, dtype=np.int32)
    grads = np.full((8, DIM), 0.5, np.float32)
    try:
        # failure-style promotion of the backup: it stages to the device
        ch = rpc.Channel(usurper.address, timeout_ms=5000)
        try:
            ch.call("Ps", "Promote", struct.pack("<q", 1))
            assert usurper.is_primary and usurper._dev_serving
            # the declared primary learns it was usurped on the next
            # propagation — poke with a write so the fence lands
            ch.call("Ps", "ApplyGrad",
                    bytes(_pack_apply_req(ids, grads)))
        finally:
            ch.close()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and (declared.is_primary
                                               or declared._dev_serving):
            time.sleep(0.02)
        assert not declared.is_primary and not declared._dev_serving
        fb0 = int(obs.counter("ps_failbacks").get_value())
        decided = None
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and decided is None:
            decided = reb.step()
            time.sleep(0.05)
        assert decided is not None and decided.kind == "failback"
        assert int(obs.counter("ps_failbacks").get_value()) == fb0 + 1
        # failed back AND serving from device memory again
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not (
                declared.is_primary and declared._dev_serving):
            time.sleep(0.02)
        assert declared.is_primary and declared._dev_serving
        assert declared.epoch >= 2
    finally:
        reb.stop()
        nc.close()
        _close_all(*servers)
        reg_server.close()
        dev.close()



# -- parity with the reference's CPU shard -----------------------------------

LR = 0.1  # not a power of two: lr * g rounds


def _request_stream(seed, steps=24):
    """Lookup/ApplyGrad batches of 1 to 47 ids drawn Zipf-skewed (ids
    repeat), with normal grads that are not powers of two."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        count = int(rng.integers(1, 3 * VOCAB))
        ids = ((rng.zipf(1.3, count) - 1) % VOCAB).astype(np.int32)
        yield ids, rng.standard_normal((count, DIM)).astype(np.float32)


def _drive(pairs, seed):
    """Send one stream to every (server address, client, rpc module)
    triple in turn; returns each one's Lookup replies. Even steps apply
    through ``RemoteEmbedding`` (ApplyGradId), odd ones through a raw
    ``ApplyGrad`` call."""
    replies = [[] for _ in pairs]
    for step, (ids, grads) in enumerate(_request_stream(seed)):
        for n, (addr, emb, rpc_mod) in enumerate(pairs):
            replies[n].append(emb.lookup(ids).tobytes())
            if step % 2 == 0:
                emb.apply_gradients(ids, grads)
                continue
            ch = rpc_mod.Channel(addr, timeout_ms=10000)
            try:
                ch.call("Ps", "ApplyGrad",
                        bytes(_pack_apply_req(ids, grads)))
            finally:
                ch.close()
    return replies


@pytest.mark.parametrize("combine", [False, True])
def test_device_shard_equals_reference_cpu_shard(combine):
    from brpc_tpu import rpc as ref_rpc
    dev = DeviceClient(device="cpu")
    port = DevicePsShardServer(VOCAB, DIM, 0, 1, lr=LR, seed=5,
                               device_client=dev, combine=combine)
    ref = ref_ps.PsShardServer(VOCAB, DIM, 0, 1, lr=LR, seed=5,
                               combine=combine)
    port_emb = RemoteEmbedding([port.address], VOCAB, DIM,
                               timeout_ms=120000)
    ref_emb = ref_ps.RemoteEmbedding([ref.address], VOCAB, DIM,
                                     timeout_ms=120000)
    try:
        start = ref.table.copy()
        assert port._dev_serving and port.table.tobytes() == start.tobytes()
        got, want = _drive([(port.address, port_emb, rpc),
                            (ref.address, ref_emb, ref_rpc)], seed=9)
        assert got == want
        assert port.table.tobytes() == ref.table.tobytes()
        assert not np.array_equal(ref.table, start)
    finally:
        port_emb.close()
        ref_emb.close()
        port.close()
        ref.close()
        dev.close()


# -- the shard on the card ---------------------------------------------------


@pytest.mark.cuda
def test_device_shard_on_card_equals_cpu_shard():
    """The same stream into the shard with its table in device memory
    (the kernels) and into the shard on the CPU (the plain versions):
    every Lookup and the final tables bit-equal, one launch a request."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    card, cpu = DeviceClient(), DeviceClient(device="cpu")
    servers = [DevicePsShardServer(VOCAB, DIM, 0, 1, lr=LR, seed=5,
                                   device_client=d) for d in (card, cpu)]
    embs = [RemoteEmbedding([s.address], VOCAB, DIM, timeout_ms=120000)
            for s in servers]
    try:
        before = dict(er.launches)
        got, want = _drive([(s.address, e, rpc)
                            for s, e in zip(servers, embs)], seed=9)
        steps = len(got)
        assert er.launches["gather_rows"] == before["gather_rows"] + steps
        assert er.launches["scatter_sub"] == before["scatter_sub"] + steps
        assert got == want
        assert servers[0].table.tobytes() == servers[1].table.tobytes()
    finally:
        for e in embs:
            e.close()
        for s in servers:
            s.close()
        card.close()
        cpu.close()
