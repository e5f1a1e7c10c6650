"""The port's device client and its two kernels' plain versions, on the CPU.

``brpc_tpu_torch.device.DeviceClient`` keeps the surface of the reference's
native PJRT client (``brpc_tpu/rpc.py`` ``DeviceClient``) that the PS device
shard calls. Its programs are the kernels of
``brpc_tpu_torch/ops/embedding_rows.py``: on CPU tensors their plain
versions, which are held here to numpy and to JAX bit for bit:

- ``gather_rows`` against ``table[ids]``;
- ``scatter_sub`` against ``np.subtract.at(table, ids, lr * grads)``, the
  arithmetic of the host tier, the backups and checkpoint replay, on random
  floats that are not powers of two, with many repeated ids and the shard's
  padding (id 0, grad 0), at every power-of-two bucket from 1 to 4096;
- ``scatter_sub`` against the reference's own scatter semantics, JAX
  ``table.at[ids].add(-(lr * grads))`` on the CPU: bit-equal where the ids
  are unique; where they repeat, within one ulp of the result per element,
  since XLA may sum an id's updates in another order (jax 0.9.0 on the CPU
  applies them in order and measured 0 ulp).

Tests marked ``cuda`` hold the kernels to their plain versions on the card,
bit for bit; they skip without one. Every test here ends with no net growth
of the port's handle ledger (clients, executables, device buffers).
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu_torch import rpc
from brpc_tpu_torch.analysis import handles, race
from brpc_tpu_torch.device import DeviceClient
from brpc_tpu_torch.ops import embedding_rows as er

pytestmark = pytest.mark.needs_native

LR = 0.1  # not a power of two: lr * g rounds
BUCKETS = [1 << n for n in range(13)]  # 1 .. 4096


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


@pytest.fixture
def dev():
    client = DeviceClient(device="cpu")
    yield client
    client.close()


def _batch(bucket, rows=512, dim=24, seed=0):
    """A shard-shaped update: ``bucket`` slots, three quarters of them (at
    least one) real ids drawn Zipf-skewed so that ids repeat, the rest the
    shard's padding, id 0 with a zero gradient."""
    rng = np.random.default_rng(seed + bucket)
    table = rng.standard_normal((rows, dim)).astype(np.float32)
    count = max(1, bucket * 3 // 4)
    ids = np.zeros(bucket, np.int32)
    ids[:count] = (rng.zipf(1.3, count) - 1) % rows
    grads = np.zeros((bucket, dim), np.float32)
    grads[:count] = rng.standard_normal((count, dim))
    return table, ids, grads


def _subtract_at(table, ids, grads, lr=LR):
    want = table.copy()
    np.subtract.at(want, ids, lr * grads)
    return want


def _plain_scatter(table, ids, grads, lr=LR):
    return er.scatter_sub(torch.from_numpy(table), torch.from_numpy(ids),
                          torch.from_numpy(grads),
                          torch.tensor(np.float32(lr))).numpy()


# -- the client surface ------------------------------------------------------


@pytest.mark.parametrize("array", [
    np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
    np.arange(-5, 5, dtype=np.int32),
    np.frombuffer(b"device bytes", np.uint8),
    np.array(LR, np.float32)], ids=["f32", "i32", "u8", "scalar"])
def test_stage_fetch_round_trip(dev, array):
    h = dev.stage(array)
    try:
        assert h > 0 and dev.live() == [h]
        assert dev.fetch(h) == array.tobytes()
        (t,) = dev._get([h], 1)
        assert tuple(t.shape) == array.shape and t.device.type == "cpu"
    finally:
        dev.release(h)
    assert dev.live() == []


def test_stage_copies_and_takes_dims(dev):
    a = np.ones((2, 3), np.float32)
    h = dev.stage(a)
    h2 = dev.stage(a.tobytes(), dtype="f32", dims=[3, 2])
    try:
        a[:] = 5  # the staged buffer is a copy
        assert np.frombuffer(dev.fetch(h), np.float32).tolist() == [1.0] * 6
        (t,) = dev._get([h2], 1)
        assert tuple(t.shape) == (3, 2) and t.dtype == torch.float32
        with pytest.raises(rpc.RpcError) as ei:
            dev.stage(b"12345", dtype="f32", dims=[2])
        assert ei.value.code == 5002
        with pytest.raises(rpc.RpcError):
            dev.stage(a, device_index=1)
    finally:
        dev.release(h)
        dev.release(h2)


def test_handles_are_unique_and_release_is_forgiving(dev):
    other = DeviceClient(device="cpu")
    try:
        hs = [dev.stage(np.zeros(2, np.int32)) for _ in range(3)]
        ho = other.stage(np.zeros(2, np.int32))
        assert len(set(hs + [ho])) == 4 and min(hs + [ho]) > 0
        assert dev.device_count == 1
        for h in hs:
            dev.release(h)
        dev.release(hs[0])  # twice: ignored, as the native client's rc is
        dev.release(ho)     # another client's handle: ignored here
        assert other.live() == [ho]
        with pytest.raises(rpc.RpcError):
            dev.fetch(hs[0])
    finally:
        other.close()
    assert other.live() == []


def test_mlir_specs_and_compile(dev):
    spec = dev.mlir("gather_rows", 16, 8, 4)
    assert spec == dev.mlir("gather_rows", 16, 8, 4)
    assert spec != dev.mlir("scatter_sub", 16, 8, 4)
    with pytest.raises(ValueError, match="unknown mlir builder kind"):
        dev.mlir("all_to_all", 16)
    for text in ("module @gather { func.func public @main() { } }",
                 spec.replace("rows=16", "rows=-16"), spec + "extra",
                 spec.replace("gather_rows", "add_f32")):
        with pytest.raises(rpc.RpcError) as ei:
            dev.compile(text)
        assert ei.value.code == 5003
    with pytest.raises(rpc.RpcError):
        dev.compile(spec, num_replicas=2)
    exe = dev.compile(spec)
    assert exe.num_outputs == 1 and exe.kind == "gather_rows"
    exe.close()
    exe.close()  # idempotent


def test_execute_runs_programs_functionally(dev):
    table, ids, grads = _batch(8, rows=16, dim=8)
    t_h, i_h, g_h = dev.stage(table), dev.stage(ids), dev.stage(grads)
    lr_h = dev.stage(np.array(LR, np.float32))
    gather = dev.compile(dev.mlir("gather_rows", 16, 8, 8))
    scatter = dev.compile(dev.mlir("scatter_sub", 16, 8, 8))
    try:
        [[rows_h]] = gather.execute([t_h, i_h])
        [[new_h]] = scatter.execute([t_h, i_h, g_h, lr_h])
        assert np.frombuffer(dev.fetch(rows_h), np.float32).reshape(8, 8) \
            .tobytes() == table[ids].tobytes()
        assert dev.fetch(new_h) == _subtract_at(table, ids, grads).tobytes()
        # functional: the input table is unchanged
        assert dev.fetch(t_h) == table.tobytes()
        with pytest.raises(rpc.RpcError, match="want 4 operands"):
            scatter.execute([t_h, i_h])
        with pytest.raises(rpc.RpcError, match="operand 1"):
            gather.execute([t_h, g_h])
        with pytest.raises(rpc.RpcError, match="one replica"):
            gather.execute([t_h, i_h, t_h, i_h], nreplicas=2)
        with pytest.raises(rpc.RpcError, match="unknown buffer"):
            gather.execute([t_h, 0])
        dev.release(rows_h)
        dev.release(new_h)
    finally:
        gather.close()
        scatter.close()
        for h in (t_h, i_h, g_h, lr_h):
            dev.release(h)
    with pytest.raises(rpc.RpcError, match="closed executable"):
        gather.execute([t_h, i_h])


def test_close_drops_buffers_and_refuses_more():
    client = DeviceClient(device="cpu")
    h = client.stage(np.zeros(4, np.float32))
    assert client.live() == [h]
    client.close()
    assert client.live() == []
    with pytest.raises(rpc.RpcError, match="closed"):
        client.stage(np.zeros(4, np.float32))
    client.close()  # idempotent


def test_client_defaults_to_the_card():
    with pytest.raises(ValueError, match="unknown device"):
        DeviceClient(device="tpu")
    if torch.cuda.is_available():
        client = DeviceClient()
        try:
            assert client.device == "cuda" and client.device_count >= 1
        finally:
            client.close()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceClient()


def test_rpc_exposes_the_torch_client():
    assert rpc.DeviceClient is DeviceClient
    assert rpc.DeviceExecutable.__module__ == "brpc_tpu_torch.device"


def test_blocking_device_calls_are_noted_under_racecheck(dev):
    """execute and fetch tell RACECHECK they block, as the native calls
    do: a checked lock held across either is a finding."""
    race.set_enabled(True)
    race.clear()
    try:
        mu = race.checked_lock("test.device_client")
        h = dev.stage(np.zeros((4, 2), np.float32))
        i_h = dev.stage(np.zeros(2, np.int32))
        exe = dev.compile(dev.mlir("gather_rows", 4, 2, 2))
        with mu:
            dev.fetch(h)
            [[out]] = exe.execute([h, i_h])
        found = " ".join(f.message for f in race.findings()
                         if f.kind == "blocking-call")
        assert "brt_device_fetch" in found and "brt_device_execute" in found
        for x in (h, i_h, out):
            dev.release(x)
        exe.close()
    finally:
        race.clear()
        race.set_enabled(None)


# -- the plain versions against numpy and JAX --------------------------------


@pytest.mark.parametrize("bucket", BUCKETS)
def test_plain_gather_equals_numpy(bucket):
    table, ids, _ = _batch(bucket)
    got = er.gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
    assert got.numpy().tobytes() == table[ids].tobytes()


@pytest.mark.parametrize("bucket", BUCKETS)
def test_plain_scatter_equals_subtract_at(bucket):
    table, ids, grads = _batch(bucket)
    got = _plain_scatter(table, ids, grads)
    want = _subtract_at(table, ids, grads)
    assert got.tobytes() == want.tobytes()
    if bucket >= 8:  # the case has repeats and rows that moved
        assert len(np.unique(ids)) < len(ids)
        assert not np.array_equal(want, table)


def test_numpy_lr_is_a_weak_f32_scalar():
    """The shard multiplies by the Python float lr; numpy 2 rounds it to
    f32 first, so the device's resident ``np.float32(lr)`` gives the same
    products."""
    _, _, grads = _batch(64)
    assert (LR * grads).dtype == np.float32
    assert (LR * grads).tobytes() == (np.float32(LR) * grads).tobytes()


@pytest.mark.parametrize("repeats", [False, True])
def test_plain_scatter_against_jax_scatter(repeats):
    rng = np.random.default_rng(11)
    rows, dim, k = 256, 16, 128
    table = rng.standard_normal((rows, dim)).astype(np.float32)
    ids = (rng.integers(0, 16, k) if repeats
           else rng.permutation(rows)[:k]).astype(np.int32)
    grads = rng.standard_normal((k, dim)).astype(np.float32)
    got = _plain_scatter(table, ids, grads)
    want = np.asarray(jnp.asarray(table).at[ids].add(
        -(np.float32(LR) * jnp.asarray(grads))))
    if not repeats:
        assert got.tobytes() == want.tobytes()
    else:
        ulp = np.spacing(np.abs(want)).astype(np.float64)
        gap = np.abs(got.astype(np.float64) - want) / ulp
        assert gap.max() <= 1.0


def test_plain_versions_check_inputs():
    table, ids, grads = _batch(4, rows=8, dim=4)
    t, i, g = (torch.from_numpy(x) for x in (table, ids, grads))
    lr = torch.tensor(np.float32(LR))
    with pytest.raises(TypeError, match="int32"):
        er.gather_rows(t, i.long())
    with pytest.raises(TypeError, match="table"):
        er.gather_rows(t.double(), i)
    with pytest.raises(TypeError, match="grads"):
        er.scatter_sub(t, i, g[:2], lr)
    with pytest.raises(TypeError, match="lr"):
        er.scatter_sub(t, i, g, lr.double())
    with pytest.raises(ValueError, match="contiguous"):
        er.gather_rows(t.t(), i)
    bad = i.clone()
    bad[0] = 8
    with pytest.raises(IndexError):
        er.gather_rows(t, bad)
    with pytest.raises(IndexError):
        er.scatter_sub(t, bad, g, lr)
    bad[0] = -1
    with pytest.raises(IndexError):
        er.scatter_sub(t, bad, g, lr)


# -- the kernels on the card -------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [1, 2, 64, 1024, 4096])
@pytest.mark.parametrize("dim", [4096, 24, 7])
def test_kernels_equal_plain_on_card(cuda_device, bucket, dim):
    """Bit for bit: the gather copies floats, the scatter-sub rounds each
    product and each subtraction as the plain version does, in batch
    order. dim 7 takes the kernels' scalar path."""
    table, ids, grads = _batch(bucket, rows=2048, dim=dim, seed=3)
    t, i, g = (torch.from_numpy(x).to(cuda_device)
               for x in (table, ids, grads))
    lr = torch.tensor(np.float32(LR), device=cuda_device)
    before = dict(er.launches)
    rows = er.gather_rows(t, i)
    new = er.scatter_sub(t, i, g, lr)
    torch.cuda.synchronize()
    assert er.launches["gather_rows"] == before["gather_rows"] + 1
    assert er.launches["scatter_sub"] == before["scatter_sub"] + 1
    assert torch.equal(rows, er.gather_rows_reference(t, i))
    plain = er.scatter_sub_reference(t, i, g, lr)
    assert new.cpu().numpy().tobytes() == plain.cpu().numpy().tobytes()
    assert new.cpu().numpy().tobytes() == \
        _subtract_at(table, ids, grads).tobytes()
    assert t.cpu().numpy().tobytes() == table.tobytes()  # never in place


@pytest.mark.cuda
def test_kernels_keep_subnormals_on_card(cuda_device):
    """No flush to zero: a subnormal row minus a subnormal product stays
    what numpy makes of it."""
    table = np.full((4, 8), np.float32(3e-39))
    ids = np.array([1, 1, 2, 0], np.int32)
    grads = np.full((4, 8), np.float32(1e-38))
    t, i, g = (torch.from_numpy(x).to(cuda_device)
               for x in (table, ids, grads))
    lr = torch.tensor(np.float32(0.1), device=cuda_device)
    got = er.scatter_sub(t, i, g, lr).cpu().numpy()
    assert got.tobytes() == _subtract_at(table, ids, grads).tobytes()
    assert (got[1] != 0).all() and (np.abs(got[1]) < 1.18e-38).all()


@pytest.mark.cuda
def test_cuda_client_runs_the_kernels(cuda_device):
    client = DeviceClient()
    try:
        table, ids, grads = _batch(16, rows=64, dim=32, seed=5)
        t_h, i_h, g_h = (client.stage(x) for x in (table, ids, grads))
        lr_h = client.stage(np.array(LR, np.float32))
        exe = client.compile(client.mlir("scatter_sub", 64, 32, 16))
        [[new_h]] = exe.execute([t_h, i_h, g_h, lr_h])
        assert client.fetch(new_h) == \
            _subtract_at(table, ids, grads).tobytes()
        exe.close()
    finally:
        client.close()
