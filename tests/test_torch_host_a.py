"""Twin suites, group (a): the reference's tests of the host tier that
reach the port's own code (its native loader, the zero-copy buffers, the
handle ledger, the race harness, the PS hot path, the native read path),
each file run as written against the port (``tests/torch_twin.py``).

Two cases are written by hand instead of mirrored:

- ``test_native_rpc.py::test_async_handler_jax_completion``: the handler's
  completion thread computes its product with torch, the port's
  framework, instead of a jitted JAX function.
- ``test_ps_hotpath.py::test_device_shard_no_torn_rows_and_racecheck_clean``:
  the reference runs it on a PJRT plugin and skips without one; the twin
  runs the port's device shard on its own client on the CPU
  (``DeviceClient(device="cpu")``), with the reference's helpers and
  assertions.
"""

import threading

import numpy as np
import torch

import test_ps_hotpath as ref_hotpath
from torch_twin import reference_runs, twin_suite  # noqa: F401


def async_handler_torch_completion(tmp_path):
    """The north-star shape: the handler enqueues the compute and returns;
    a completion thread responds, so fiber workers never block on it."""
    from brpc_tpu_torch import rpc

    srv = rpc.Server()

    def async_matmul(method, request, respond):
        arr = np.frombuffer(request, np.float32).reshape(16, 16)

        def completion():
            a = torch.from_numpy(arr.copy())
            respond((a @ a).numpy().tobytes())

        threading.Thread(target=completion).start()  # handler returns now

    srv.add_async_service("Compute", async_matmul)
    port = srv.start("127.0.0.1:0")
    ch = rpc.Channel(f"127.0.0.1:{port}", timeout_ms=10000)
    a = np.arange(256, dtype=np.float32).reshape(16, 16) / 256.0
    out = np.frombuffer(ch.call("Compute", "MatMul", a.tobytes()),
                        np.float32).reshape(16, 16)
    np.testing.assert_allclose(out, a @ a, rtol=1e-5)
    ch.close()
    srv.close()


def device_shard_no_torn_rows_on_cpu_client(tmp_path):
    """Lookups racing ApplyGrads on the device shard: every served row is
    a whole generation, no update is lost, and the race harness reports no
    ``ps.device_shard`` lock held across a blocking device call."""
    from brpc_tpu_torch.analysis import race
    from brpc_tpu_torch.device import DeviceClient
    from brpc_tpu_torch.ps_remote import DevicePsShardServer, RemoteEmbedding

    vocab, dim = 16, 8
    dev = DeviceClient(device="cpu")
    race.clear()
    race.set_enabled(True)   # locks created by the server become checked
    try:
        server = DevicePsShardServer(vocab, dim, 0, 1, lr=1.0,
                                     device_client=dev)
        emb = RemoteEmbedding([server.address], vocab, dim,
                              timeout_ms=120000)
        try:
            init = server.table.copy()
            assert ref_hotpath._hammer_one_shard(emb, init, vocab,
                                                 rounds=10, lookups=4,
                                                 applies=2)
            final = server.table
            assert ref_hotpath._row_deltas_are_whole(final, init)
            # 10 rounds x 2 applies x lr=1.0 x grad=1: nothing lost
            np.testing.assert_allclose(final, init - 20.0, atol=1e-4)
        finally:
            emb.close()
            server.close()
        blocked = [f for f in race.findings()
                   if f.kind == "blocking-call"
                   and "ps.device_shard" in f.locks]
        assert blocked == [], race.report()
    finally:
        race.set_enabled(None)
        race.clear()
        dev.close()


test_native_rpc = twin_suite(
    "test_native_rpc.py",
    hand={"test_async_handler_jax_completion":
          async_handler_torch_completion})
test_zerocopy = twin_suite("test_zerocopy.py")
test_handles = twin_suite("test_handles.py")
test_race_harness = twin_suite("test_race_harness.py")
test_ps_hotpath = twin_suite(
    "test_ps_hotpath.py",
    hand={"test_device_shard_no_torn_rows_and_racecheck_clean":
          device_shard_no_torn_rows_on_cpu_client})
test_ps_native = twin_suite("test_ps_native.py")
