"""The native core's device tier on the port's PJRT plugin.

The port's plugin (``brpc_tpu_torch/csrc/pjrt/``, built by
``brpc_tpu_torch.native_device``) runs the native core's device layer
(``cpp/device/``) as the reference's plugins do. On the CPU its host build
stands in for the card's, as ``cpp/device/fake_pjrt_plugin.cc`` does for
the reference's TPU.

(a) The reference's unchanged native programs ``cpp/tests/test_device.cc``,
    ``test_collective.cc``, ``test_tpu_ps.cc`` and ``cpp/examples/tpu_ps.cc``
    (built with g++ against the port's native core) pass on the host
    plugin. The tests open their plugin as ``./libbrt_fake_pjrt.so``: they
    run in a directory where that name links to the port's plugin.
(b) The six programs of ``brt_mlir_module`` through the port's C API
    (``brt_device_client_new``, ``brt_device_stage_shaped``,
    ``brt_mlir_module``, ``brt_device_compile``, ``brt_device_execute``,
    ``brt_device_fetch``) on the reference's test plugin and on the port's
    host plugin, both with 4 devices, on seeded numpy inputs with -0.0,
    subnormals, inf and NaN planted, duplicate ids and empty k, at R = 1,
    2 and 4: bit for bit, NaNs as NaNs. ``reduce_sum`` is the one
    exception, as in ``tests/test_torch_device_programs.py``: the test
    plugin sums in f32 in order, the port's kernel (and so its plain
    version) sums in f64 and rounds once; the port's is held bit for bit
    to numpy's in-order f64 sum rounded once, and to the test plugin's
    within Higham's bound.
(c) An unknown module, a wrong replica count, a mis-shaped or mistyped
    argument and an argument on the wrong device each get an error from
    the plugin that names it, never a result.
(d) ``brpc_tpu_torch/csrc/examples/tpu_ps.cc`` at 512 x 64, k 64, 3 steps
    on the host plugin: its JSON line reports every check true.
(e) ``cuda`` twins of (a)-(c) on the CUDA plugin, against the host plugin;
    they skip without a card.

Also held here: the plugin build hashes every file it compiles or
includes, and builds its host backend only when asked for by name.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import pytest

from brpc_tpu_torch import native_device as nd
from brpc_tpu_torch import rpc
from brpc_tpu_torch.analysis import handles

pytestmark = pytest.mark.needs_native

ROOT = Path(__file__).resolve().parent.parent
DEVICES = 4
REPLICAS = [1, 2, 4]
SIZES = [1, 16, 4099]
SPECIALS = np.array([-0.0, 1e-40, -3e-42, np.inf, -np.inf, np.nan],
                    np.float32)
LR = 0.05  # not a power of two: lr * g rounds
PROGRAM_TIMEOUT_S = 120

# name: (source, arguments before the plugin's, what its output must hold)
PROGRAMS = {
    "test_device": ("cpp/tests/test_device.cc", "ALL device tests OK"),
    "test_collective": ("cpp/tests/test_collective.cc",
                        "ALL collective tests OK"),
    "test_tpu_ps": ("cpp/tests/test_tpu_ps.cc", "ALL tpu_ps tests OK"),
    "tpu_ps_example": ("cpp/examples/tpu_ps.cc", "allreduce on DEVICE path"),
}
FULL_WIDTH = "brpc_tpu_torch/csrc/examples/tpu_ps.cc"


@pytest.fixture(autouse=True)
def _port_leak_gate():
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
def host_plugin():
    return nd.build_plugin("host")


@pytest.fixture(scope="module")
def fake_plugin(tmp_path_factory):
    """The reference's test plugin, built from ``cpp/`` into a temp dir."""
    out = tmp_path_factory.mktemp("fake_pjrt") / "libbrt_fake_pjrt.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-fPIC", "-shared",
                    "-I", str(ROOT / "cpp"),
                    str(ROOT / "cpp" / "device" / "fake_pjrt_plugin.cc"),
                    "-o", str(out)], check=True, capture_output=True,
                   timeout=300)
    return out


@pytest.fixture(scope="module")
def programs():
    """The native programs, built at once."""
    sources = {name: src for name, (src, _) in PROGRAMS.items()}
    sources["tpu_ps"] = FULL_WIDTH
    nd.core_library()  # one build of the core, before the programs link it
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
        built = {name: ex.submit(nd.build_program, ROOT / src)
                 for name, src in sources.items()}
        return {name: f.result() for name, f in built.items()}


@pytest.fixture
def cuda_plugin():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA plugin runs only on the "
                    "card")
    return nd.build_plugin("cuda")


def _run_program(programs, name, plugin, tmp_path):
    """Runs a program from a directory where ``libbrt_fake_pjrt.so`` links
    to ``plugin``; returns its stdout."""
    run_dir = nd.link_as_test_plugin(plugin, tmp_path / "run")
    args = [str(plugin)] if name == "tpu_ps_example" else []
    env = dict(os.environ, BRT_PJRT_PLUGIN=str(plugin))
    env.pop("BRT_PJRT_NUM_DEVICES", None)
    proc = subprocess.run([str(programs[name]), *args], cwd=run_dir, env=env,
                          capture_output=True, text=True,
                          timeout=PROGRAM_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


# -- the port's C API over a plugin -----------------------------------------


class CApiClient:
    """The port's ``brt_device_*`` C API on one plugin, as the reference's
    ``DeviceClient(plugin_path)`` drives it."""

    F32, I32 = 1, 2

    def __init__(self, plugin):
        self.lib = rpc._load()
        err = ctypes.create_string_buffer(1024)
        self.ptr = self.lib.brt_device_client_new(str(plugin).encode(), err,
                                                  1024)
        if not self.ptr:
            raise rpc.RpcError(5001, err.value.decode(errors="replace"))
        self.count = self.lib.brt_device_count(self.ptr)
        self.exes = []

    def close(self):
        for exe in self.exes:
            self.lib.brt_device_executable_destroy(exe)
        self.exes = []
        self.lib.brt_device_client_destroy(self.ptr)

    def stage(self, array, device=0):
        array = np.asarray(array)
        dtype = self.F32 if array.dtype == np.float32 else self.I32
        dims = (ctypes.c_int64 * max(array.ndim, 1))(*array.shape)
        err = ctypes.create_string_buffer(1024)
        data = array.tobytes()
        h = self.lib.brt_device_stage_shaped(self.ptr, data, len(data),
                                             device, dtype, dims, array.ndim,
                                             err, 1024)
        if h == 0:
            raise rpc.RpcError(5002, err.value.decode(errors="replace"))
        return h

    @staticmethod
    def module(kind, p0, p1=0, p2=0):
        lib = rpc._load()
        text = lib.brt_mlir_module(kind.encode(), p0, p1, p2)
        try:
            return ctypes.string_at(text).decode()
        finally:
            lib.brt_free(text)

    def compile(self, text, replicas=1):
        err = ctypes.create_string_buffer(1024)
        exe = self.lib.brt_device_compile(self.ptr, text.encode(), replicas,
                                          err, 1024)
        if not exe:
            raise rpc.RpcError(5003, err.value.decode(errors="replace"))
        self.exes.append(exe)
        return exe

    def execute(self, exe, handles_, replicas=1):
        """``handles_`` is [replica][operand]; returns each replica's
        output handle."""
        flat = [h for ops in handles_ for h in ops]
        args = (ctypes.c_uint64 * max(len(flat), 1))(*flat)
        outs = (ctypes.c_uint64 * replicas)()
        err = ctypes.create_string_buffer(1024)
        rc = self.lib.brt_device_execute(exe, args, len(handles_[0]),
                                         replicas, outs, replicas, err, 1024)
        if rc != 0:
            raise rpc.RpcError(rc, err.value.decode(errors="replace"))
        return list(outs)

    def fetch(self, h):
        out, n = ctypes.c_void_p(), ctypes.c_size_t()
        err = ctypes.create_string_buffer(1024)
        rc = self.lib.brt_device_fetch(self.ptr, h, ctypes.byref(out),
                                       ctypes.byref(n), err, 1024)
        if rc != 0:
            raise rpc.RpcError(rc, err.value.decode(errors="replace"))
        try:
            return ctypes.string_at(out, n.value)
        finally:
            self.lib.brt_free(out)

    def release(self, h):
        assert self.lib.brt_device_release(h) == 0

    def run(self, kind, params, operands, replicas=1):
        """Stages ``operands[d]`` on device d, compiles and executes
        ``kind``, fetches every replica's output and releases everything."""
        staged = [[self.stage(a, d) for a in ops]
                  for d, ops in enumerate(operands)]
        try:
            outs = self.execute(self.compile(self.module(kind, *params),
                                             replicas), staged, replicas)
            try:
                return [self.fetch(h) for h in outs]
            finally:
                for h in outs:
                    self.release(h)
        finally:
            for ops in staged:
                for h in ops:
                    self.release(h)


@pytest.fixture
def clients(fake_plugin, host_plugin, monkeypatch):
    monkeypatch.setenv("BRT_FAKE_PJRT_DEVICES", str(DEVICES))
    monkeypatch.delenv("BRT_PJRT_NUM_DEVICES", raising=False)
    ref, port = CApiClient(fake_plugin), CApiClient(host_plugin)
    assert ref.count == port.count == DEVICES
    yield ref, port
    ref.close()
    port.close()


def _draw(n, seed, specials=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    plants = SPECIALS if specials else SPECIALS[:3]
    count = min(n, len(plants) * -(-n // 200))
    x[rng.permutation(n)[:count]] = np.resize(plants, count)
    return x


def _same_floats(got, want):
    """Bit for bit, except that any NaN equals any NaN."""
    got, want = np.frombuffer(got, np.float32), np.frombuffer(want, np.float32)
    nan = np.isnan(want)
    return got.shape == want.shape and np.array_equal(np.isnan(got), nan) \
        and got[~nan].tobytes() == want[~nan].tobytes()


def _f64_sum(x):
    """numpy's in-order f64 sum from +0.0, rounded to f32 once (the port's
    reduce_sum)."""
    with np.errstate(invalid="ignore", over="ignore"):
        terms = np.concatenate([[0.0], x.astype(np.float64)])
        return np.float32(np.cumsum(terms)[-1]).tobytes()


def _cases():
    """(kind, params, operands, replicas) of every program."""
    cases = []
    for n in SIZES:
        cases.append(("add", (n,), [(_draw(n, 1), _draw(n, 2))], 1))
        cases.append(("reduce_sum", (n,), [(_draw(n, 3, specials=False),)],
                      1))
        cases.append(("reduce_sum", (n,), [(_draw(n, 4),)], 1))
        for r in REPLICAS:
            xs = [(_draw(n, 10 + d),) for d in range(r)]
            cases.append(("all_reduce_sum", (n, r), xs, r))
            cases.append(("all_gather", (n, r), xs, r))
    rng = np.random.default_rng(7)
    rows, dim = 37, 5
    table = _draw(rows * dim, 8).reshape(rows, dim)
    for k in (0, 1, 64):
        ids = rng.integers(0, rows, k).astype(np.int32)
        if k > 1:
            ids[k // 2:] = ids[: k - k // 2]  # every id at least twice
        grads = _draw(k * dim, 9 + k).reshape(k, dim) if k else \
            np.zeros((0, dim), np.float32)
        cases.append(("gather_rows", (rows, dim, k), [(table, ids)], 1))
        cases.append(("scatter_sub", (rows, dim, k),
                      [(table, ids, grads, np.array(LR, np.float32))], 1))
    return cases


CASES = _cases()


def _case_id(case):
    kind, params, _, replicas = case
    return f"{kind}-{'x'.join(map(str, params))}-R{replicas}"


def _want(kind, params, operands):
    """The plain result of a case on the host, for each replica."""
    if kind == "scatter_sub":
        table, ids, grads, lr = (a.copy() for a in operands[0])
        with np.errstate(invalid="ignore", over="ignore"):
            np.subtract.at(table, ids, np.float32(lr) * grads)
        return [table.tobytes()]
    if kind == "gather_rows":
        table, ids = operands[0]
        return [table[ids].tobytes()]
    return None


# -- (a) the reference's native programs on the host plugin ------------------


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_reference_programs_pass_on_host_plugin(programs, host_plugin, name,
                                                tmp_path):
    out = _run_program(programs, name, host_plugin, tmp_path)
    assert PROGRAMS[name][1] in out and "SKIP" not in out, out


# -- (b) the six programs, the reference's test plugin against the port's ----


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_programs_match_reference_plugin(clients, case):
    ref, port = clients
    kind, params, operands, replicas = case
    got = port.run(kind, params, operands, replicas)
    want = ref.run(kind, params, operands, replicas)
    assert len(got) == len(want) == replicas
    if kind == "reduce_sum":
        (x,) = operands[0]
        assert _same_floats(got[0], _f64_sum(x))
        g, r = (float(np.frombuffer(b, np.float32)[0]) for b in (got[0],
                                                               want[0]))
        if np.isfinite(r):
            bound = (len(x) - 1) * 2.0 ** -24 * \
                np.abs(x.astype(np.float64)).sum()
            assert abs(g - r) <= bound
        else:
            assert np.isnan(g) == np.isnan(r) and (np.isnan(g) or g == r)
        return
    for d in range(replicas):
        assert _same_floats(got[d], want[d]), (kind, d)
        assert got[d] == got[0]
    plain = _want(kind, params, operands)
    if plain is not None:
        assert _same_floats(got[0], plain[0])


def test_launch_counters_count_each_program(host_plugin, clients):
    _, port = clients
    lib = ctypes.CDLL(str(host_plugin))
    lib.brt_pjrt_launches.argtypes = [ctypes.c_int]
    lib.brt_pjrt_launches.restype = ctypes.c_longlong
    lib.brt_pjrt_live_buffers.argtypes = []
    lib.brt_pjrt_live_buffers.restype = ctypes.c_longlong
    lib.brt_pjrt_program_name.argtypes = [ctypes.c_int]
    lib.brt_pjrt_program_name.restype = ctypes.c_char_p
    names = [lib.brt_pjrt_program_name(p).decode() for p in range(6)]
    assert names == ["add", "reduce_sum", "all_reduce_sum", "all_gather",
                     "gather_rows", "scatter_sub"]
    before = [lib.brt_pjrt_launches(p) for p in range(6)]
    x = _draw(4099, 5)
    port.run("all_reduce_sum", (4099, 4), [(x,)] * 4, 4)  # two-shot
    port.run("all_reduce_sum", (16, 4), [(x[:16],)] * 4, 4)  # one-shot
    port.run("all_gather", (0, 2), [(x[:0],)] * 2, 2)  # nothing to move
    port.run("gather_rows", (4, 4, 0),
             [(x[:16].reshape(4, 4), np.zeros(0, np.int32))])
    port.run("scatter_sub", (4, 4, 0),
             [(x[:16].reshape(4, 4), np.zeros(0, np.int32),
               np.zeros((0, 4), np.float32), np.float32(LR))])
    after = [lib.brt_pjrt_launches(p) for p in range(6)]
    # the host's rule takes the two-shot from 1024 floats a replica: one
    # launch a replica with a slice (four of 1024, 1024, 1024 and 1027);
    # the one-shot: one a replica; an empty all-gather and an empty
    # gather: none; a scatter of k = 0 still copies the table
    assert [a - b for a, b in zip(after, before)] == [0, 0, 4 + 4, 0, 0, 1]
    assert lib.brt_pjrt_live_buffers() == 0


# -- (c) refusals ---------------------------------------------------------


def _refusal(client, fn):
    with pytest.raises(rpc.RpcError) as ei:
        fn(client)
    return str(ei.value)


def _refusal_cases():
    def unknown_module(c):
        c.compile("module @brt_softmax attributes {mhlo.num_replicas = 1 : "
                  "i32} {\n}\n")

    def too_many_replicas(c):
        c.compile(c.module("all_reduce_sum", 4, 16), 16)

    def more_replicas_than_devices(c):
        c.compile(c.module("all_gather", 4, c.count + 1), c.count + 1)

    def module_against_launch(c):
        # written for 2 replicas, compiled and launched as one
        x = c.stage(np.ones(4, np.float32))
        try:
            c.execute(c.compile(c.module("all_reduce_sum", 4, 2), 1), [[x]])
        finally:
            c.release(x)

    def misshaped(c):
        a, b = c.stage(np.ones(4, np.float32)), c.stage(np.ones(3, np.float32))
        try:
            c.execute(c.compile(c.module("add", 4)), [[a, b]])
        finally:
            c.release(a)
            c.release(b)

    def mistyped(c):
        t = c.stage(np.ones((4, 2), np.float32))
        ids = c.stage(np.zeros(2, np.float32))
        try:
            c.execute(c.compile(c.module("gather_rows", 4, 2, 2)), [[t, ids]])
        finally:
            c.release(t)
            c.release(ids)

    def wrong_device(c):
        a, b = c.stage(np.ones(4, np.float32), 0), \
            c.stage(np.ones(4, np.float32), 1)
        try:
            c.execute(c.compile(c.module("add", 4)), [[a, b]])
        finally:
            c.release(a)
            c.release(b)

    def replica_on_wrong_device(c):
        a, b = c.stage(np.ones(4, np.float32), 0), \
            c.stage(np.ones(4, np.float32), 0)
        try:
            c.execute(c.compile(c.module("all_gather", 4, 2), 2), [[a], [b]],
                      2)
        finally:
            c.release(a)
            c.release(b)

    return {
        "unknown_module": (unknown_module, "unrecognized module @brt_softmax"),
        "too_many_replicas": (too_many_replicas,
                              "kernels take at most 8"),
        "more_replicas_than_devices": (more_replicas_than_devices,
                                       "the client has"),
        "module_against_launch": (module_against_launch,
                                  "compiled for 2 replicas; Execute got "
                                  "num_devices 1"),
        "misshaped": (misshaped, "argument 1 of replica 0 is f32[3]; the "
                                 "module takes f32[4]"),
        "mistyped": (mistyped, "argument 1 of replica 0 is f32[2]; the "
                               "module takes i32[2]"),
        "wrong_device": (wrong_device, "argument 1 of replica 0 lies on "
                                       "device 1, not on device 0"),
        "replica_on_wrong_device": (replica_on_wrong_device,
                                    "argument 0 of replica 1 lies on device "
                                    "0, not on device 1"),
    }


REFUSALS = _refusal_cases()


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_plugin_refuses_with_an_error_naming_it(host_plugin, case,
                                               monkeypatch):
    monkeypatch.delenv("BRT_PJRT_NUM_DEVICES", raising=False)
    client = CApiClient(host_plugin)
    try:
        fn, words = REFUSALS[case]
        assert words in _refusal(client, fn)
    finally:
        client.close()


def test_num_devices_from_the_environment(host_plugin, monkeypatch):
    monkeypatch.setenv("BRT_PJRT_NUM_DEVICES", "2")
    client = CApiClient(host_plugin)
    assert client.count == 2
    client.close()
    monkeypatch.setenv("BRT_PJRT_NUM_DEVICES", "9")
    with pytest.raises(rpc.RpcError, match="num_devices 9: the kernels take "
                                           "at most 8"):
        CApiClient(host_plugin)


# -- (d) the full-width program, cut to a CPU's size -------------------------


def test_full_width_program_on_host_plugin(programs, host_plugin):
    env = dict(os.environ)
    env.pop("BRT_PJRT_NUM_DEVICES", None)
    proc = subprocess.run(
        [str(programs["tpu_ps"]), "--plugin", str(host_plugin), "--rows",
         "512", "--dim", "64", "--k", "64", "--steps", "3"],
        capture_output=True, text=True, timeout=PROGRAM_TIMEOUT_S, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["ok"] and report["error"] == ""
    assert report["checks"] == {"lookups_bit_equal": True,
                                "tables_bit_equal": True,
                                "collectives_bit_equal": True,
                                "collectives_on_device": True,
                                "live_buffers_zero": True}
    assert (report["platform"], report["devices"], report["rows"],
            report["dim"], report["shards"]) == ("brt_host", 4, 512, 64, 2)
    assert [(c["op"], c["replicas"]) for c in report["collectives"]] == [
        (op, r) for r in REPLICAS for op in ("all_reduce_sum", "all_gather")]
    launches = report["launches"]
    # a K2 and a K3 a shard a step (Zipf ids reach both shards), 5 steps
    assert launches["gather_rows"] == launches["scatter_sub"] == 10
    # six calls of each collective at R = 1, 2, 4, one launch a replica
    assert launches["all_reduce_sum"] == launches["all_gather"] == 6 * 7
    assert report["live_buffers"] == 0


def test_full_width_program_refuses_bad_flags(programs, host_plugin):
    proc = subprocess.run([str(programs["tpu_ps"]), "--plugin",
                           str(host_plugin), "--rows", "513"],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2 and "usage" in proc.stderr


# -- the build ---------------------------------------------------------------


def test_plugin_path_hashes_every_file_it_compiles_or_includes(tmp_path):
    """A copy of the plugin's sources in a temp tree: an edit to any file
    the build compiles or includes gives another library path."""
    csrc, cpp = tmp_path / "pkg" / "csrc", tmp_path / "cpp"
    shutil.copytree(nd.CSRC, csrc, ignore=shutil.ignore_patterns(
        "__pycache__"))
    (cpp / "third_party" / "pjrt").mkdir(parents=True)
    shutil.copy(nd.CPP / "third_party" / "pjrt" / "pjrt_c_api.h",
                cpp / "third_party" / "pjrt")
    for kind in ("cuda", "host"):
        base = nd.plugin_path(kind, csrc, cpp)
        assert base.name == nd.plugin_path(kind).name  # the same contents
        touched = [csrc / src for src in nd.PLUGIN_SOURCES[kind]] + [
            csrc / "pjrt" / "plugin.h",
            cpp / "third_party" / "pjrt" / "pjrt_c_api.h"]
        for path in touched:
            text = path.read_bytes()
            path.write_bytes(text + b"\n// edited\n")
            assert nd.plugin_path(kind, csrc, cpp) != base, path
            path.write_bytes(text)
        assert nd.plugin_path(kind, csrc, cpp) == base
    # a source of the other backend only does not move a plugin
    host = nd.plugin_path("host", csrc, cpp)
    (csrc / "pjrt" / "cuda_backend.cu").write_text("// edited\n")
    assert nd.plugin_path("host", csrc, cpp) == host


def test_program_path_hashes_its_includes(tmp_path):
    src = tmp_path / "prog.cc"
    header = tmp_path / "local.h"
    header.write_text("#pragma once\n")
    src.write_text('#include "local.h"\n#include "rpc/server.h"\n'
                   "int main() { return 0; }\n")
    core = tmp_path / "libcore.so"
    core.write_bytes(b"core")
    first = nd.program_path(src, core)
    header.write_text("#pragma once\n// edited\n")
    second = nd.program_path(src, core)
    core.write_bytes(b"core, rebuilt")
    assert len({first, second, nd.program_path(src, core)}) == 3
    assert nd.CPP / "rpc" / "server.h" in nd.includes([src], [nd.CPP])


def test_host_backend_is_built_only_by_name(tmp_path, monkeypatch):
    """``build_plugin()`` builds the card's plugin from the CUDA backend;
    only ``build_plugin("host")`` compiles the host backend."""
    commands = []

    def run(cmd, out, what):
        commands.append(cmd)
        if "host_backend.cc" not in " ".join(cmd):
            raise nd.BuildError("no nvcc here")
        out.write_bytes(b"")
        return ""

    monkeypatch.setattr(nd, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(nd, "_run", run)
    monkeypatch.setattr(nd._build, "_nvcc", lambda: "nvcc")
    with pytest.raises(nd.BuildError):
        nd.build_plugin()
    assert len(commands) == 1 and commands[0][0] == "nvcc"
    assert not any("host_backend" in part for part in commands[0])
    assert any(part.endswith("cuda_backend.cu") for part in commands[0])
    assert not list(tmp_path.glob("*host*"))
    path = nd.build_plugin("host")
    assert "host" in path.name and commands[1][0] == "g++"
    assert not any("cuda_backend" in part for part in commands[1])
    with pytest.raises(ValueError, match="no plugin"):
        nd.build_plugin("cpu")


# -- (e) the CUDA plugin on the card -----------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_reference_programs_pass_on_cuda_plugin(programs, cuda_plugin, name,
                                                tmp_path):
    out = _run_program(programs, name, cuda_plugin, tmp_path)
    assert PROGRAMS[name][1] in out and "SKIP" not in out, out
    if name == "test_device":
        assert "platform=brt_cuda" in out


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_cuda_plugin_matches_host_plugin(cuda_plugin, host_plugin, case,
                                         monkeypatch):
    """Every replica of a card's devices (4, on as many cards as there are)
    against the host plugin; reduce_sum within one ulp of its f64 sum."""
    monkeypatch.setenv("BRT_PJRT_NUM_DEVICES", str(DEVICES))
    card, host = CApiClient(cuda_plugin), CApiClient(host_plugin)
    try:
        kind, params, operands, replicas = case
        got = card.run(kind, params, operands, replicas)
        want = host.run(kind, params, operands, replicas)
    finally:
        card.close()
        host.close()
    if kind == "reduce_sum":
        g, w = (np.frombuffer(b, np.float32)[0] for b in (got[0], want[0]))
        assert (np.isnan(g) and np.isnan(w)) or g == w or \
            abs(float(g) - float(w)) <= np.spacing(np.abs(w))
        return
    for d in range(replicas):
        assert _same_floats(got[d], want[d]), (kind, d)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_cuda_plugin_refuses_with_an_error_naming_it(cuda_plugin, case,
                                                     monkeypatch):
    monkeypatch.setenv("BRT_PJRT_NUM_DEVICES", str(DEVICES))
    client = CApiClient(cuda_plugin)
    try:
        fn, words = REFUSALS[case]
        assert words in _refusal(client, fn)
    finally:
        client.close()


@pytest.mark.cuda
def test_cuda_plugin_refuses_more_devices_than_the_kernels_take(
        cuda_plugin, monkeypatch):
    monkeypatch.setenv("BRT_PJRT_NUM_DEVICES", "9")
    with pytest.raises(rpc.RpcError, match="num_devices 9: the kernels take "
                                           "at most 8"):
        CApiClient(cuda_plugin)


@pytest.mark.cuda
def test_cuda_plugin_without_a_card_makes_no_client(programs, cuda_plugin,
                                                    tmp_path):
    """With no card visible the CUDA plugin refuses to make a client (the
    reference's test_device then prints SKIP); it has no host device."""
    env = dict(os.environ, BRT_PJRT_PLUGIN=str(cuda_plugin),
               CUDA_VISIBLE_DEVICES="")
    env.pop("BRT_PJRT_NUM_DEVICES", None)
    proc = subprocess.run([str(programs["test_device"])], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=PROGRAM_TIMEOUT_S)
    assert proc.returncode == 0
    assert "SKIP: no PJRT device available" in proc.stdout
    assert "no CUDA device" in proc.stdout
    assert "ALL device tests OK" not in proc.stdout
