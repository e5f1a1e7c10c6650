"""Each package builds and loads its own native core, one process at a time.

The reference's loader (``brpc_tpu/rpc.py``) builds ``cpp/build/`` with
cmake and ninja; the port's (``brpc_tpu_torch/rpc.py``) builds
``brpc_tpu_torch/_build/native/`` with g++. The port's loader holds a file
lock around its build, so processes that load it at once wait for one
build; the reference's loader orders only the threads of one process.

**At import** this module builds both cores, one process at a time: it
holds an ``fcntl`` lock on ``cpp/build/port-tests.lock`` while it probes the
reference's core (``brpc_tpu.rpc.native_core_available()``), then probes
the port's under the port's own lock. Test workers import every test module
while they collect, before ``tests/conftest.py`` probes the reference's core
to decide whether the native tests run. So under ``pytest -n N`` one worker
builds each core and the others wait for it and load the finished library,
where before N workers ran cmake and ninja in one directory at once and
most of them failed (their native tests then skipped).
"""

import fcntl
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from brpc_tpu import rpc as ref_rpc
from brpc_tpu_torch import rpc as port_rpc

ROOT = Path(__file__).resolve().parent.parent


def _build_both_cores() -> None:
    build = ROOT / "cpp" / "build"
    build.mkdir(parents=True, exist_ok=True)
    with open(build / "port-tests.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        ref_rpc.native_core_available()
    port_rpc.native_core_available()


_build_both_cores()


def _port_core() -> Path:
    if not port_rpc.native_core_available():
        pytest.skip(f"the port's native core is unavailable: "
                    f"{port_rpc._load_error.splitlines()[0]}")
    return Path(port_rpc._build_dir()) / "libbrpc_tpu_c.so"


def test_packages_resolve_different_library_paths():
    ref_dir = Path(ref_rpc._build_dir()).resolve()
    port_dir = Path(port_rpc._build_dir()).resolve()
    assert ref_dir == ROOT / "cpp" / "build"
    assert port_dir != ref_dir
    assert ref_dir not in port_dir.parents and port_dir not in ref_dir.parents


def test_port_library_lies_under_its_own_build_dir():
    so = _port_core()
    assert so.is_file()
    assert ROOT / "brpc_tpu_torch" / "_build" in so.resolve().parents
    assert port_rpc._load()._name == str(so)


@pytest.mark.needs_native
def test_two_cores_keep_their_own_globals():
    """Both cores live in this process, each bound to its own symbols: a
    server made through the port counts in the port's core and not in the
    reference's."""
    _port_core()
    assert port_rpc._load()._handle != ref_rpc._load()._handle
    ref_before = ref_rpc.debug_handle_count("server")
    port_before = port_rpc.debug_handle_count("server")
    server = port_rpc.Server()
    try:
        assert port_rpc.debug_handle_count("server") == port_before + 1
        assert ref_rpc.debug_handle_count("server") == ref_before
    finally:
        server.close()
    assert port_rpc.debug_handle_count("server") == port_before


# A process that loads the port's core from ``build``. The first builds it
# with a build function that writes the library in place in two halves (as
# a linker does, without the g++ recipe's rename) and, between them,
# announces the build through ``started`` and waits until the second
# process is about to load. The second must wait for the build and load
# the whole library; without the lock it would open half a library.
_LOADER = textwrap.dedent("""
    import os, sys, time
    from brpc_tpu_torch import rpc
    build, role, started, ready, real = sys.argv[1:6]
    rpc._build_dir = lambda: build

    def slow_build(src, so):
        data = open(real, "rb").read()
        with open(so, "wb") as f:
            f.write(data[:len(data) // 2])
            f.flush()
            open(started, "w").close()
            for _ in range(1200):
                if os.path.exists(ready):
                    break
                time.sleep(0.05)
            time.sleep(1.0)
            f.write(data[len(data) // 2:])

    def no_build(src, so):
        raise AssertionError("a second build ran")

    if role == "first":
        rpc._build_with_gxx = slow_build
    else:
        rpc._build_with_gxx = no_build
        open(ready, "w").close()
    lib = rpc._load()
    print(role, rpc.native_build is not None, bool(lib.brt_server_new))
""")


def test_second_process_waits_for_the_build_under_the_lock(tmp_path):
    real = _port_core()
    build = tmp_path / "native"
    started, ready = tmp_path / "started", tmp_path / "ready"

    def loader(role):
        return subprocess.Popen(
            [sys.executable, "-c", _LOADER, str(build), role, str(started),
             str(ready), str(real)], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env={**os.environ, "PYTHONPATH": str(ROOT)})

    first = loader("first")
    second = None
    try:
        deadline = time.monotonic() + 60
        while not started.exists() and first.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert started.exists(), first.communicate(timeout=60)
        second = loader("second")
        outs = [p.communicate(timeout=120) for p in (first, second)]
    finally:
        for p in (first, second):
            if p is not None:
                p.kill()
    for p, (out, err) in zip((first, second), outs):
        assert p.returncode == 0, err
    assert outs[0][0].split() == ["first", "True", "True"]
    assert outs[1][0].split() == ["second", "False", "True"]
    assert (build / "libbrpc_tpu_c.so").read_bytes() == real.read_bytes()
