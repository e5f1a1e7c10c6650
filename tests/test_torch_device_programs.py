"""The device fabric's K4 and K5 programs, the port against the reference.

The reference's ``brpc_tpu.rpc.DeviceClient`` runs ``add``, ``reduce_sum``,
``all_reduce_sum`` and ``all_gather`` through its native PJRT client on
its test plugin (``cpp/device/fake_pjrt_plugin.cc``, built here with g++
into the test's temp dir, four virtual devices). The port's
``brpc_tpu_torch.device.DeviceClient("cpu", num_devices=4)`` gets the same
staged arrays and runs the plain versions of
``brpc_tpu_torch/ops/device_programs.py``. Inputs are drawn from a seed
with -0.0, subnormals, +-inf and NaN planted.

- ``add``, ``all_reduce_sum`` and ``all_gather``: the fetched bytes equal
  the reference's, NaNs as NaNs (a NaN's payload is not IEEE arithmetic's
  to keep: x86 keeps an operand's, the card makes its canonical one).
- ``reduce_sum``: the reference sums in sequential f32 and the port rounds
  an f64 sum once. Port against reference within Higham's bound for the
  sequential sum, ``(n - 1) * 2**-24 * sum|x|``; port against the f64 sum
  within one f32 ulp; inf and NaN where the reference has them.
- The reference's refusals, code for code, and the port's own.

Tests marked ``cuda`` hold each kernel to its plain version on the card,
and with two cards or more the collectives over peers; they skip without
a card. Every test ends with no net growth of the port's handle ledger.
"""

import subprocess
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from brpc_tpu import rpc as ref_rpc
from brpc_tpu_torch import rpc
from brpc_tpu_torch.analysis import handles
from brpc_tpu_torch.device import DeviceClient
from brpc_tpu_torch.ops import device_programs as dp

pytestmark = pytest.mark.needs_native

ROOT = Path(__file__).resolve().parent.parent
DEVICES = 4
REPLICAS = [1, 2, 4]
SIZES = [1, 16, 4099]
SPECIALS = np.array([-0.0, 1e-40, -3e-42, np.inf, -np.inf, np.nan],
                    np.float32)


@pytest.fixture(autouse=True)
def _port_leak_gate(request):
    """No net growth of the port's handle ledger across a test."""
    if not handles.enabled():
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
def plugin(tmp_path_factory):
    """The reference's test plugin, built from ``cpp/`` into a temp dir."""
    out = tmp_path_factory.mktemp("fake_pjrt") / "libbrt_fake_pjrt.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-fPIC", "-shared",
                    "-I", str(ROOT / "cpp"),
                    str(ROOT / "cpp" / "device" / "fake_pjrt_plugin.cc"),
                    "-o", str(out)], check=True, capture_output=True,
                   timeout=300)
    return str(out)


@pytest.fixture
def ref(plugin, monkeypatch):
    monkeypatch.setenv("BRT_FAKE_PJRT_DEVICES", str(DEVICES))
    client = ref_rpc.DeviceClient(plugin)
    assert client.device_count == DEVICES
    yield client
    client.close()


@pytest.fixture
def port():
    client = DeviceClient("cpu", num_devices=DEVICES)
    yield client
    client.close()
    assert client.live() == []


def _draw(n, seed, specials=True):
    """``[n]`` f32 normals with -0.0, subnormals and (``specials``) +-inf
    and NaN planted at seeded positions; the first plant is -0.0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    plants = SPECIALS if specials else SPECIALS[:3]
    count = min(n, len(plants) * -(-n // 200))
    at = rng.permutation(n)[:count]
    x[at] = np.resize(plants, count)
    return x


def _run(client, kind, arrays, n, replicas, p1=None):
    """Stages ``arrays[d]`` (a tuple of operands) on device d, compiles
    ``kind`` for ``replicas``, executes, fetches every replica's output
    and releases everything; returns the outputs' bytes."""
    staged = [[client.stage(a, device_index=d) for a in ops]
              for d, ops in enumerate(arrays)]
    exe = client.compile(client.mlir(kind, n, replicas if p1 is None
                                     else p1), replicas)
    try:
        outs = exe.execute([h for ops in staged for h in ops], replicas)
        try:
            assert [len(o) for o in outs] == [1] * replicas
            return [client.fetch(h) for (h,) in outs]
        finally:
            for (h,) in outs:
                client.release(h)
    finally:
        exe.close()
        for ops in staged:
            for h in ops:
                client.release(h)


def _floats(raw):
    return np.frombuffer(raw, np.float32)


def _same_floats(got, want):
    """Bit for bit, except that any NaN equals any NaN."""
    got, want = _floats(got), _floats(want)
    nan = np.isnan(want)
    return got.shape == want.shape and np.array_equal(np.isnan(got), nan) \
        and got[~nan].tobytes() == want[~nan].tobytes()


# -- against the reference ---------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("p1", [0, 2, 4])
def test_add_matches_reference(ref, port, n, p1):
    """A one-replica program whatever ``p1`` is, as ``brt_mlir_module``
    builds it."""
    arrays = [(_draw(n, 1), _draw(n, 2))]
    want = _run(ref, "add", arrays, n, 1, p1)
    got = _run(port, "add", arrays, n, 1, p1)
    assert _same_floats(got[0], want[0])
    assert port.mlir("add", n, p1) == port.mlir("add", n)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("replicas", REPLICAS)
@pytest.mark.parametrize("kind", ["all_reduce_sum", "all_gather"])
def test_collectives_match_reference(ref, port, kind, replicas, n):
    arrays = [(_draw(n, 10 + d),) for d in range(replicas)]
    want = _run(ref, kind, arrays, n, replicas)
    got = _run(port, kind, arrays, n, replicas)
    out_n = n if kind == "all_reduce_sum" else n * replicas
    for d in range(replicas):
        assert _floats(got[d]).shape == (out_n,)
        assert _same_floats(got[d], want[d])
        assert got[d] == got[0]  # every replica holds the same bytes


def test_all_reduce_of_one_replica_maps_negative_zero_to_zero(ref, port):
    """Summed from +0.0: -0.0 comes back as +0.0; subnormals, inf and NaN
    pass through."""
    x = _draw(16, 3)
    assert np.signbit(x[np.where(x == 0)]).all()
    for client in (ref, port):
        (out,) = _run(client, "all_reduce_sum", [(x,)], 16, 1)
        out = _floats(out)
        zero = x == 0
        assert (out[zero] == 0).all() and not np.signbit(out[zero]).any()
        keep = ~zero & ~np.isnan(x)
        assert out[keep].tobytes() == x[keep].tobytes()
        assert np.isnan(out[np.isnan(x)]).all()


def _higham(x):
    return (len(x) - 1) * 2.0 ** -24 * np.abs(x.astype(np.float64)).sum()


def _check_sum(got, want_ref, x):
    got, want_ref = _floats(got), _floats(want_ref)
    assert got.shape == want_ref.shape == (1,)  # a 0-d f32: 4 bytes
    g, r = float(got[0]), float(want_ref[0])
    with np.errstate(invalid="ignore"):  # inf - inf in the exact sum
        exact = np.float32(x.astype(np.float64).sum())
    if np.isnan(r) or np.isinf(r):
        assert got.tobytes() == want_ref.tobytes() or \
            (np.isnan(g) and np.isnan(r))
        return
    assert abs(g - r) <= _higham(x)
    assert abs(g - float(exact)) <= np.spacing(np.abs(exact))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("p1", [0, 2, 4])
def test_reduce_sum_matches_reference(ref, port, n, p1):
    x = _draw(n, 20 + p1, specials=False)
    want = _run(ref, "reduce_sum", [(x,)], n, 1, p1)
    got = _run(port, "reduce_sum", [(x,)], n, 1, p1)
    _check_sum(got[0], want[0], x)


@pytest.mark.parametrize("n", [7, 16, 4099])
def test_reduce_sum_with_inf_and_nan_matches_reference(ref, port, n):
    x = _draw(n, 30)
    want = _run(ref, "reduce_sum", [(x,)], n, 1)
    got = _run(port, "reduce_sum", [(x,)], n, 1)
    _check_sum(got[0], want[0], x)


def test_reduce_sum_of_a_cancelling_input(ref, port):
    """[1e8, 1, -1e8, ...]: the sequential f32 sum loses the ones, the f64
    sum keeps them; the port stays within one ulp of the exact sum and
    within the reference's Higham bound."""
    x = np.tile(np.array([1e8, 1, -1e8, 1], np.float32), 256)
    want = _run(ref, "reduce_sum", [(x,)], x.size, 1)
    got = _run(port, "reduce_sum", [(x,)], x.size, 1)
    _check_sum(got[0], want[0], x)
    assert _floats(got[0])[0] == 512.0
    assert _floats(want[0])[0] != 512.0


# -- refusals -----------------------------------------------------------------


def _codes(client, fn):
    with pytest.raises(Exception) as ei:
        fn(client)
    return getattr(ei.value, "code", type(ei.value).__name__)


def test_refusals_match_reference(ref, port):
    """22 for nreplicas other than compile's, 5 at execute for a program
    written for another replica count than compiled, 22 for a released
    handle, ValueError for an unknown kind."""

    def wrong_nreplicas(c):
        hs = [c.stage(np.ones(4, np.float32), device_index=d)
              for d in range(2)]
        exe = c.compile(c.mlir("all_reduce_sum", 4, 2), 2)
        try:
            exe.execute(hs, 1)
        finally:
            exe.close()
            for h in hs:
                c.release(h)

    def spec_against_compile(c, kind="all_reduce_sum", p1=2, replicas=1,
                             operands=1):
        hs = [c.stage(np.ones(4, np.float32), device_index=d)
              for d in range(replicas) for _ in range(operands)]
        exe = c.compile(c.mlir(kind, 4, p1), replicas)
        try:
            exe.execute(hs, replicas)
        finally:
            exe.close()
            for h in hs:
                c.release(h)

    def stale(c):
        h = c.stage(np.ones(4, np.float32))
        c.release(h)
        exe = c.compile(c.mlir("reduce_sum", 4))
        try:
            exe.execute([h])
        finally:
            exe.close()

    cases = [wrong_nreplicas, spec_against_compile,
             lambda c: spec_against_compile(c, "all_gather", 1, 2),
             lambda c: spec_against_compile(c, "add", 0, 2, operands=2),
             lambda c: spec_against_compile(c, "reduce_sum", 4, 4),
             stale, lambda c: c.mlir("all_to_all", 4)]
    got = [_codes(port, case) for case in cases]
    assert got == [_codes(ref, case) for case in cases]
    assert got == [22, 5, 5, 5, 5, 22, "ValueError"]


def test_port_refuses_what_the_test_plugin_lets_through(port):
    """A wrong operand count or shape, an operand on another replica's
    device, more replicas than devices, and virtual devices on the card."""
    a = [port.stage(np.ones(4, np.float32), device_index=d)
         for d in range(2)]
    short = port.stage(np.ones(3, np.float32))
    add = port.compile(port.mlir("add", 4))
    reduce = port.compile(port.mlir("all_reduce_sum", 4, 2), 2)
    try:
        for call, match in (
                (lambda: add.execute([a[0]]), "want 2 operands"),
                (lambda: add.execute([a[0], short]), "operand 1"),
                (lambda: add.execute([a[0], a[1]]), "on device 1"),
                (lambda: reduce.execute([a[1], a[0]], 2), "on device 1"),
                (lambda: reduce.execute([a[0], short], 2), "replica 1"),
                (lambda: reduce.execute([a[0]], 2), "want 2 operands")):
            with pytest.raises(rpc.RpcError, match=match) as ei:
                call()
            assert ei.value.code == 22
        with pytest.raises(rpc.RpcError) as ei:
            port.compile(port.mlir("all_gather", 4, 8), 8)
        assert ei.value.code == 5003
        with pytest.raises(rpc.RpcError) as ei:
            port.compile(port.mlir("gather_rows", 4, 2, 2), 2)
        assert ei.value.code == 5003
        with pytest.raises(rpc.RpcError) as ei:
            port.stage(np.ones(4, np.float32), device_index=DEVICES)
        assert ei.value.code == 5002
    finally:
        add.close()
        reduce.close()
        for h in a + [short]:
            port.release(h)
    with pytest.raises(ValueError, match="num_devices"):
        DeviceClient("cpu", num_devices=0)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="num_devices"):
            DeviceClient("cuda", num_devices=2)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceClient("cuda", num_devices=2)


def test_handles_record_their_device_and_outputs_land_on_each(port):
    hs = [port.stage(_draw(8, d), device_index=d) for d in range(DEVICES)]
    exe = port.compile(port.mlir("all_gather", 8, DEVICES), DEVICES)
    try:
        outs = exe.execute(hs, DEVICES)
        with port._mu:
            assert [port._buffers[h][1] for h in hs] == list(range(DEVICES))
            assert [port._buffers[h][1] for (h,) in outs] == \
                list(range(DEVICES))
        for (h,) in outs:
            port.release(h)
    finally:
        exe.close()
        for h in hs:
            port.release(h)
    assert port.live() == []


# -- the wrappers' plain versions --------------------------------------------


def test_wrappers_check_inputs():
    x = torch.ones(8)
    with pytest.raises(TypeError, match="f32"):
        dp.add(x, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        dp.reduce_sum(torch.ones(8, 2).t()[0])
    with pytest.raises(ValueError, match="add"):
        dp.add(x, torch.ones(4))
    with pytest.raises(TypeError, match="replica 1"):
        dp.all_reduce_sum([x, torch.ones(4)])
    with pytest.raises(ValueError, match="no replicas"):
        dp.all_gather([])
    outs = dp.all_reduce_sum([x, x])
    assert outs[0] is not outs[1]  # a buffer for each replica
    assert dp.reduce_sum(torch.ones(0)).item() == 0.0


# -- the kernels on the card -------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _bits(t):
    return t.cpu().numpy().tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 16, 4099, 1 << 20])
@pytest.mark.parametrize("offset", [0, 1])
def test_kernels_equal_plain_on_card(cuda_device, n, offset):
    """Bit for bit (NaNs as NaNs) for add and the collectives at one
    replica; reduce_sum within one ulp of its plain version. ``offset`` 1
    runs misaligned views (the kernels' scalar paths)."""
    a, b = (torch.from_numpy(_draw(n + offset, s)).to(cuda_device)[offset:]
            for s in (40, 41))
    fin = torch.from_numpy(_draw(n + offset, 42, specials=False)).to(
        cuda_device)[offset:]
    before = dict(dp.launches)
    got_add = dp.add(a, b)
    got_sum = dp.reduce_sum(fin)
    (got_ar,) = dp.all_reduce_sum([a])
    (got_ag,) = dp.all_gather([a])
    torch.cuda.synchronize()
    assert {k: dp.launches[k] - before[k] for k in before} == \
        {"add": 1, "reduce_sum": 1, "all_reduce_sum": 1, "all_gather": 1}
    assert _same_floats(_bits(got_add), _bits(dp.add_reference(a, b)))
    (want_ar,) = dp.all_reduce_sum_reference([a])
    assert _same_floats(_bits(got_ar), _bits(want_ar))
    assert _bits(got_ag) == _bits(a)
    want = dp.reduce_sum_reference(fin).item()
    assert got_sum.shape == () and \
        abs(got_sum.item() - want) <= np.spacing(np.float32(abs(want)))
    assert _bits(dp.reduce_sum(fin)) == _bits(got_sum)  # deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("replicas", [2, 4])
@pytest.mark.parametrize("n", [16, 4099, 1 << 20])
def test_collectives_over_peers_on_cards(cuda_device, replicas, n):
    if torch.cuda.device_count() < replicas:
        pytest.skip(f"needs {replicas} CUDA devices")
    xs = [torch.from_numpy(_draw(n, 50 + d)).to(f"cuda:{d}")
          for d in range(replicas)]
    ar = dp.all_reduce_sum(xs)
    ag = dp.all_gather(xs)
    for d in range(replicas):
        torch.cuda.synchronize(d)
    want_ar = dp.all_reduce_sum_reference(xs)
    want_ag = dp.all_gather_reference(xs)
    for d in range(replicas):
        assert ar[d].device == xs[d].device == ag[d].device
        assert _bits(ar[d]) == _bits(ar[0]) and _bits(ag[d]) == _bits(ag[0])
        assert _same_floats(_bits(ar[d]), _bits(want_ar[d]))
        assert _bits(ag[d]) == _bits(want_ag[d])


@pytest.mark.cuda
@pytest.mark.parametrize("replicas", [2, 4])
def test_collectives_join_the_input_streams(cuda_device, replicas):
    """Overwriting every input right after the call, on its own card's
    stream and with no wait, must not reach a peer still reading it: the
    wrappers make each input's stream wait for every replica's kernel."""
    if torch.cuda.device_count() < replicas:
        pytest.skip(f"needs {replicas} CUDA devices")
    n = 1 << 24
    arrays = [_draw(n, 70 + d) for d in range(replicas)]
    want_ar = np.zeros(n, np.float32)
    with np.errstate(invalid="ignore"):  # inf + -inf
        for x in arrays:
            want_ar = want_ar + x
    want_ag = np.concatenate(arrays).tobytes()
    xs, ys = ([torch.from_numpy(x).to(f"cuda:{d}")
               for d, x in enumerate(arrays)] for _ in range(2))
    for d in range(replicas):
        torch.cuda.synchronize(d)
    ar = dp.all_reduce_sum(xs)
    for x in xs:
        x.fill_(float("nan"))
    ag = dp.all_gather(ys)
    for y in ys:
        y.fill_(float("nan"))
    for d in range(replicas):
        torch.cuda.synchronize(d)
    assert all(_same_floats(_bits(a), want_ar.tobytes()) for a in ar)
    assert all(_bits(g) == want_ag for g in ag)


@pytest.mark.cuda
def test_cuda_client_runs_every_replica(cuda_device):
    client = DeviceClient()
    replicas = min(client.device_count, 4)
    try:
        arrays = [(_draw(4099, 60 + d),) for d in range(replicas)]
        got = _run(client, "all_reduce_sum", arrays, 4099, replicas)
        want = np.zeros(4099, np.float32)
        for (x,) in arrays:
            want = want + x
        assert all(_same_floats(g, want.tobytes()) for g in got)
        got = _run(client, "all_gather", arrays, 4099, replicas)
        assert all(g == np.concatenate([x for (x,) in arrays]).tobytes()
                   for g in got)
    finally:
        client.close()
    assert client.live() == []
