"""ctypes bindings over the native RPC core (cpp/ → libbrpc_tpu_c.so).

Gives Python the reference's user surface — Server/Channel/Controller
(src/brpc/server.h:347, channel.h:151) — backed by the C++ fiber scheduler,
wait-free socket transport and cluster layer. Payloads are bytes; structure
(JSON, msgpack, numpy buffers) is the caller's choice.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import sys
import threading
import time
import weakref
from typing import Callable, Optional

from brpc_tpu_torch import fault, obs, resilience
from brpc_tpu_torch.analysis import handles as _handles
from brpc_tpu_torch.analysis import race as _race

_INT64_MIN = -(2 ** 63)  # "inherit the channel option" timeout sentinel

_HANDLER = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
    ctypes.c_size_t, ctypes.c_void_p
)

# brt_stream_handler: (user, stream_id, data, len, closed) — data frames
# arrive with closed=0, the final callback is (NULL, 0, 1).
_STREAM_HANDLER = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
    ctypes.c_size_t, ctypes.c_int
)

# brt_drop_hook: (user, service, method, port) -> nonzero to drop.
_DROP_HOOK = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
    ctypes.c_int
)

# brt_iobuf_release: (data, arg) — fired when the last native reference
# to a borrowed (append_pinned) block drops; arg is the pin-registry
# token.  ctypes auto-acquires the GIL, so the callback may fire from
# any fiber/socket thread.
_IOBUF_RELEASE = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p)

_lib = None
_load_error: Optional[str] = None
# Serializes the first-touch g++ build + dlopen: two threads racing
# into _load() would otherwise both run the build.
_load_mu = _race.checked_lock("rpc.load")


class NativeCoreUnavailable(RuntimeError):
    """The native core (cpp/ → libbrpc_tpu_c.so) could not be built or
    loaded — usually a missing g++ toolchain, a failed build, or
    an unloadable .so.  Callers that can degrade (tests, pure-Python
    tiers) catch this; ``native_core_available()`` probes without
    raising."""


def _build_dir() -> str:
    """Where the port builds and finds its own copy of the native core:
    never the reference's ``cpp/build/``, which the reference's loader
    builds with cmake."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_build", "native")


def _source_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "cpp")


def native_core_available() -> bool:
    """True when the native core is loadable (building it on first use
    if a toolchain is present). Never raises."""
    try:
        _load()
        return True
    except NativeCoreUnavailable:
        return False


#: How this process built the native core: ``{"toolchain": ..., "seconds":
#: ...}``, or None when it found the library already built.
native_build: Optional[dict] = None


def _load_inner():
    global native_build
    build = _build_dir()
    so = os.path.join(build, "libbrpc_tpu_c.so")
    os.makedirs(build, exist_ok=True)
    # _load_mu orders this process's threads; the file lock orders
    # processes (test workers, a second program in the checkout): one
    # builds, the rest wait and load its finished library.
    with open(os.path.join(build, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(so):
            t0 = time.monotonic()
            _build_with_gxx(_source_dir(), so)
            native_build = {"toolchain": "g++",
                            "seconds": time.monotonic() - t0}
        return ctypes.CDLL(so)


def _system_lib(*names: str) -> str:
    """Path of the first of ``names`` (a runtime soname is enough) in the
    system library directories; the bare first name when none is there."""
    for d in ("/lib/x86_64-linux-gnu", "/usr/lib/x86_64-linux-gnu",
              "/usr/lib64", "/lib64", "/usr/lib"):
        for n in names:
            if os.path.exists(os.path.join(d, n)):
                return os.path.join(d, n)
    return names[0]


def _build_with_gxx(src: str, so: str) -> None:
    """The CMake target ``brpc_tpu_c`` built with g++ alone: the same
    sources, one g++ per file in parallel, then one shared link against
    the system's libstdc++, renamed into place when complete.

    The reference's loader runs cmake and ninja instead. On the H100
    machine that build links libstdc++ into the library statically, and
    the process then dies (SIGSEGV) at the library's first log line, in
    the stream insert; this build does not. ``-fcoroutines`` and
    ``-include errno.h`` let gcc 10 compile the tree too. Raises
    ``FileNotFoundError`` without g++ and ``CalledProcessError`` when a
    step fails, as the reference's cmake path does."""
    import concurrent.futures
    import glob
    import tempfile
    srcs = []
    for part in ("base", "fiber", "var", "transport", "rpc", "cluster",
                 "device", "capi"):
        srcs += sorted(glob.glob(os.path.join(src, part, "*.cc")))
    srcs = [f for f in srcs if not f.endswith("fake_pjrt_plugin.cc")]
    srcs += sorted(glob.glob(os.path.join(src, "fiber", "*.S")))
    objdir = tempfile.mkdtemp(prefix="obj-gxx-", dir=os.path.dirname(so))

    def compile_one(path: str) -> str:
        rel = os.path.relpath(path, src).replace(os.sep, "_")
        obj = os.path.join(objdir, rel + ".o")
        cmd = ["g++", "-c", "-fPIC", "-O2", "-g0", "-w", "-I", src]
        if path.endswith(".cc"):
            cmd += ["-std=c++20", "-fcoroutines", "-include", "errno.h"]
        subprocess.run(cmd + ["-o", obj, path], check=True,
                       capture_output=True)
        return obj

    try:
        with concurrent.futures.ThreadPoolExecutor(
                os.cpu_count() or 4) as ex:
            objs = list(ex.map(compile_one, srcs))
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-shared", "-o", tmp, *objs, "-lpthread", "-ldl",
             _system_lib("libz.so", "libz.so.1"),
             _system_lib("libssl.so", "libssl.so.3", "libssl.so.1.1"),
             _system_lib("libcrypto.so", "libcrypto.so.3",
                         "libcrypto.so.1.1")],
            check=True, capture_output=True)
        os.replace(tmp, so)
    finally:
        shutil.rmtree(objdir, ignore_errors=True)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _load_mu:
        if _lib is None:
            _lib = _load_locked()
        return _lib


def _load_locked():
    global _load_error
    if _load_error is not None:
        # Don't retry a g++ build per call — the toolchain won't
        # appear mid-process.
        raise NativeCoreUnavailable(_load_error)
    try:
        lib = _load_inner()
    except FileNotFoundError as e:
        _load_error = (f"native build toolchain missing ({e}); install "
                       f"g++ or use a prebuilt "
                       f"{_build_dir()}/libbrpc_tpu_c.so")
        raise NativeCoreUnavailable(_load_error) from e
    except subprocess.CalledProcessError as e:
        tail = (e.stderr or b"").decode(errors="replace")[-2000:]
        _load_error = f"native build failed ({e.cmd}):\n{tail}"
        raise NativeCoreUnavailable(_load_error) from e
    except OSError as e:
        _load_error = f"native core failed to load: {e}"
        raise NativeCoreUnavailable(_load_error) from e
    # Every brt_* symbol declares BOTH argtypes and restype (matching
    # cpp/capi/c_api.h) — ctypes defaults an undeclared restype to c_int,
    # which truncates 64-bit pointers/handles; the `ctypes-contract` check
    # in brpc_tpu_torch.analysis enforces this table stays complete.
    lib.brt_server_new.argtypes = []
    lib.brt_server_new.restype = ctypes.c_void_p
    lib.brt_server_add_service.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, _HANDLER, ctypes.c_void_p]
    lib.brt_server_add_service.restype = ctypes.c_int
    lib.brt_server_start.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.brt_server_start.restype = ctypes.c_int
    lib.brt_server_add_naming_registry.argtypes = [ctypes.c_void_p]
    lib.brt_server_add_naming_registry.restype = ctypes.c_int
    lib.brt_server_port.argtypes = [ctypes.c_void_p]
    lib.brt_server_port.restype = ctypes.c_int
    lib.brt_server_stop.argtypes = [ctypes.c_void_p]
    lib.brt_server_stop.restype = None
    lib.brt_server_set_concurrency_limiter.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.brt_server_set_concurrency_limiter.restype = ctypes.c_int
    lib.brt_server_max_concurrency.argtypes = [ctypes.c_void_p]
    lib.brt_server_max_concurrency.restype = ctypes.c_int
    lib.brt_server_destroy.argtypes = [ctypes.c_void_p]
    lib.brt_server_destroy.restype = None
    lib.brt_session_respond.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
        ctypes.c_char_p]
    lib.brt_session_respond.restype = None
    lib.brt_channel_new.restype = ctypes.c_void_p
    lib.brt_channel_new.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
    lib.brt_channel_call.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_size_t, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p, ctypes.c_size_t]
    lib.brt_channel_call.restype = ctypes.c_int
    lib.brt_channel_call_start.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_size_t]
    lib.brt_channel_call_start.restype = ctypes.c_void_p
    lib.brt_channel_call_start_opts.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_size_t, ctypes.c_int64]
    lib.brt_channel_call_start_opts.restype = ctypes.c_void_p
    lib.brt_call_join.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p, ctypes.c_size_t]
    lib.brt_call_join.restype = ctypes.c_int
    lib.brt_call_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.brt_call_wait.restype = ctypes.c_int
    lib.brt_call_group_new.argtypes = []
    lib.brt_call_group_new.restype = ctypes.c_void_p
    lib.brt_call_group_add.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.brt_call_group_add.restype = ctypes.c_int
    lib.brt_call_group_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.brt_call_group_wait.restype = ctypes.c_int
    lib.brt_call_group_wait_any.argtypes = [ctypes.c_void_p,
                                            ctypes.c_int64]
    lib.brt_call_group_wait_any.restype = ctypes.c_int
    lib.brt_call_group_completed.argtypes = [ctypes.c_void_p]
    lib.brt_call_group_completed.restype = ctypes.c_int
    lib.brt_call_group_destroy.argtypes = [ctypes.c_void_p]
    lib.brt_call_group_destroy.restype = None
    lib.brt_ps_shard_new.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.brt_ps_shard_new.restype = ctypes.c_void_p
    lib.brt_ps_shard_install.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64]
    lib.brt_ps_shard_install.restype = ctypes.c_int
    lib.brt_ps_shard_generation.argtypes = [ctypes.c_void_p]
    lib.brt_ps_shard_generation.restype = ctypes.c_uint64
    lib.brt_ps_shard_native_lookups.argtypes = [ctypes.c_void_p]
    lib.brt_ps_shard_native_lookups.restype = ctypes.c_uint64
    lib.brt_ps_shard_lookup_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64)]
    lib.brt_ps_shard_lookup_stats.restype = None
    lib.brt_server_add_ps_service.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, _HANDLER,
        ctypes.c_void_p]
    lib.brt_server_add_ps_service.restype = ctypes.c_int
    lib.brt_ps_shard_destroy.argtypes = [ctypes.c_void_p]
    lib.brt_ps_shard_destroy.restype = None
    lib.brt_stream_create.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_size_t, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_char_p, ctypes.c_size_t]
    lib.brt_stream_create.restype = ctypes.c_int
    lib.brt_stream_create_rx.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_size_t, ctypes.c_int64, _STREAM_HANDLER, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p, ctypes.c_size_t]
    lib.brt_stream_create_rx.restype = ctypes.c_int
    lib.brt_stream_accept.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, _STREAM_HANDLER, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint64)]
    lib.brt_stream_accept.restype = ctypes.c_int
    lib.brt_stream_write.argtypes = [
        ctypes.c_uint64, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int64)]
    lib.brt_stream_write.restype = ctypes.c_int
    lib.brt_stream_close.argtypes = [ctypes.c_uint64]
    lib.brt_stream_close.restype = ctypes.c_int
    lib.brt_stream_join.argtypes = [ctypes.c_uint64, ctypes.c_int64]
    lib.brt_stream_join.restype = ctypes.c_int
    lib.brt_stream_abort.argtypes = [ctypes.c_uint64]
    lib.brt_stream_abort.restype = ctypes.c_int
    # zero-copy buffer currency (capi/iobuf_capi.cc + c_api.cc variants)
    lib.brt_iobuf_new.argtypes = []
    lib.brt_iobuf_new.restype = ctypes.c_void_p
    lib.brt_iobuf_destroy.argtypes = [ctypes.c_void_p]
    lib.brt_iobuf_destroy.restype = None
    lib.brt_iobuf_append.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.brt_iobuf_append.restype = ctypes.c_int
    lib.brt_iobuf_appendv.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_int]
    lib.brt_iobuf_appendv.restype = ctypes.c_int
    lib.brt_iobuf_append_user_data.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, _IOBUF_RELEASE,
        ctypes.c_void_p]
    lib.brt_iobuf_append_user_data.restype = ctypes.c_int
    lib.brt_iobuf_append_iobuf.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.brt_iobuf_append_iobuf.restype = ctypes.c_int
    lib.brt_iobuf_size.argtypes = [ctypes.c_void_p]
    lib.brt_iobuf_size.restype = ctypes.c_int64
    lib.brt_iobuf_copy_out.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t]
    lib.brt_iobuf_copy_out.restype = ctypes.c_int64
    lib.brt_iobuf_block_count.argtypes = [ctypes.c_void_p]
    lib.brt_iobuf_block_count.restype = ctypes.c_int
    lib.brt_iobuf_block_data.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.brt_iobuf_block_data.restype = ctypes.c_void_p
    lib.brt_iobuf_block_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.brt_iobuf_block_len.restype = ctypes.c_int64
    lib.brt_channel_call_iobuf.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_size_t]
    lib.brt_channel_call_iobuf.restype = ctypes.c_void_p
    lib.brt_channel_call_start_iobuf.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_int64]
    lib.brt_channel_call_start_iobuf.restype = ctypes.c_void_p
    lib.brt_call_join_iobuf.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
        ctypes.c_size_t]
    lib.brt_call_join_iobuf.restype = ctypes.c_void_p
    lib.brt_session_respond_iobuf.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]
    lib.brt_session_respond_iobuf.restype = None
    lib.brt_stream_writev.argtypes = [
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64)]
    lib.brt_stream_writev.restype = ctypes.c_int
    lib.brt_set_drop_hook.argtypes = [_DROP_HOOK, ctypes.c_void_p]
    lib.brt_set_drop_hook.restype = None
    lib.brt_call_cancel.argtypes = [ctypes.c_void_p]
    lib.brt_call_cancel.restype = None
    lib.brt_call_destroy.argtypes = [ctypes.c_void_p]
    lib.brt_call_destroy.restype = None
    lib.brt_channel_destroy.argtypes = [ctypes.c_void_p]
    lib.brt_channel_destroy.restype = None
    lib.brt_free.argtypes = [ctypes.c_void_p]
    lib.brt_free.restype = None
    lib.brt_init.argtypes = [ctypes.c_int]
    lib.brt_init.restype = None
    lib.brt_event_new.argtypes = []
    lib.brt_event_new.restype = ctypes.c_void_p
    lib.brt_event_set.argtypes = [ctypes.c_void_p]
    lib.brt_event_set.restype = None
    lib.brt_event_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.brt_event_wait.restype = ctypes.c_int
    lib.brt_event_destroy.argtypes = [ctypes.c_void_p]
    lib.brt_event_destroy.restype = None
    # device fabric (native PJRT staging + compiled execution)
    lib.brt_device_client_new.restype = ctypes.c_void_p
    lib.brt_device_client_new.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.brt_device_count.argtypes = [ctypes.c_void_p]
    lib.brt_device_count.restype = ctypes.c_int
    lib.brt_device_stage.restype = ctypes.c_uint64
    lib.brt_device_stage.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_size_t]
    lib.brt_device_stage_shaped.restype = ctypes.c_uint64
    lib.brt_device_stage_shaped.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64), ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t]
    lib.brt_device_fetch.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p, ctypes.c_size_t]
    lib.brt_device_fetch.restype = ctypes.c_int
    lib.brt_device_release.argtypes = [ctypes.c_uint64]
    lib.brt_device_release.restype = ctypes.c_int
    lib.brt_device_client_destroy.argtypes = [ctypes.c_void_p]
    lib.brt_device_client_destroy.restype = None
    lib.brt_mlir_module.restype = ctypes.c_void_p
    lib.brt_mlir_module.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    lib.brt_device_compile.restype = ctypes.c_void_p
    lib.brt_device_compile.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_size_t]
    lib.brt_device_executable_num_outputs.argtypes = [ctypes.c_void_p]
    lib.brt_device_executable_num_outputs.restype = ctypes.c_int
    lib.brt_device_execute.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t,
        ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t]
    lib.brt_device_execute.restype = ctypes.c_int
    lib.brt_device_executable_destroy.argtypes = [ctypes.c_void_p]
    lib.brt_device_executable_destroy.restype = None
    lib.brt_debug_handle_counts.argtypes = []
    lib.brt_debug_handle_counts.restype = ctypes.c_void_p
    lib.brt_debug_handle_count.argtypes = [ctypes.c_char_p]
    lib.brt_debug_handle_count.restype = ctypes.c_long
    lib.brt_debug_fail_connections.argtypes = [ctypes.c_char_p]
    lib.brt_debug_fail_connections.restype = ctypes.c_int
    lib.brt_init(0)
    if _handles.enabled():
        _install_handle_ledger(lib)
    return lib


# ---------------------------------------------------------------------------
# dynamic handle ledger (BRPC_TPU_HANDLECHECK=1)
# ---------------------------------------------------------------------------

# The owning brt_* constructor/destructor pairs, keyed the same way as
# the native ground-truth counters (cpp/capi/handle_ledger.cc) so
# debug_handle_counts() and the Python ledger compare directly.  Streams
# are tracked at the Python object layer instead (Channel.stream /
# the receiver registry): their ABI uses out-param ids, not returns.
_HANDLE_NEW = {
    "brt_server_new": "server",
    "brt_channel_new": "channel",
    "brt_channel_call_start": "call",
    "brt_channel_call_start_opts": "call",
    "brt_call_group_new": "call_group",
    "brt_ps_shard_new": "ps_shard",
    "brt_event_new": "event",
    "brt_device_client_new": "device_client",
    "brt_device_compile": "device_executable",
    "brt_iobuf_new": "iobuf",
    "brt_channel_call_iobuf": "iobuf",
    "brt_call_join_iobuf": "iobuf",
    "brt_channel_call_start_iobuf": "call",
}
_HANDLE_DESTROY = {
    "brt_server_destroy": "server",
    "brt_channel_destroy": "channel",
    "brt_call_destroy": "call",
    "brt_call_group_destroy": "call_group",
    "brt_ps_shard_destroy": "ps_shard",
    "brt_event_destroy": "event",
    "brt_device_client_destroy": "device_client",
    "brt_device_executable_destroy": "device_executable",
    "brt_iobuf_destroy": "iobuf",
}


class _LedgerFn:
    """Transparent wrapper over one bound ctypes function that feeds the
    handle ledger: constructors record their returned handle (with
    creation stack), destructors release the first argument.  The
    ``argtypes``/``restype`` surface delegates to the wrapped function so
    the C-ABI contract tests (and any later re-declaration) see through
    the wrapper."""

    __slots__ = ("_fn", "_kind", "_is_new")

    def __init__(self, fn, kind: str, is_new: bool):
        self._fn = fn
        self._kind = kind
        self._is_new = is_new

    def __call__(self, *args):
        if self._is_new:
            out = self._fn(*args)
            _handles.note_create(self._kind, out)
            return out
        _handles.note_destroy(self._kind, args[0])
        return self._fn(*args)

    @property
    def argtypes(self):
        return self._fn.argtypes

    @argtypes.setter
    def argtypes(self, value):
        self._fn.argtypes = value

    @property
    def restype(self):
        return self._fn.restype

    @restype.setter
    def restype(self, value):
        self._fn.restype = value


def _install_handle_ledger(lib) -> None:
    """Wraps every owning ``brt_*_new``/``_destroy`` pair so the dynamic
    ledger sees each native handle's birth and death.  Installed once, at
    load time, only under ``BRPC_TPU_HANDLECHECK`` — the unwrapped ABI
    carries zero overhead."""
    for name, kind in _HANDLE_NEW.items():
        setattr(lib, name, _LedgerFn(getattr(lib, name), kind, True))
    for name, kind in _HANDLE_DESTROY.items():
        setattr(lib, name, _LedgerFn(getattr(lib, name), kind, False))


def debug_handle_counts() -> dict:
    """Ground-truth live native-object counts per handle type, reported
    by the C++ side itself (``brt_debug_handle_counts``): the native
    cross-check for :mod:`brpc_tpu_torch.analysis.handles` — the Python ledger
    knows creation stacks, this table knows the truth."""
    lib = _load()
    p = lib.brt_debug_handle_counts()
    if not p:
        return {}
    try:
        text = ctypes.string_at(p).decode()
    finally:
        lib.brt_free(p)
    out = {}
    for line in text.splitlines():
        name, _, count = line.partition(" ")
        if name:
            out[name] = int(count)
    return out


def debug_handle_count(kind: str) -> int:
    """Live native-object count for ONE handle kind (e.g. ``ps_shard``,
    ``server``) straight from the C++ atomics — the cheap point probe
    behind retirement proofs: after a resharding drain, the retired
    scheme's shards must return the ``ps_shard``/``server`` counts to
    their pre-scale-out baseline."""
    return int(_load().brt_debug_handle_count(kind.encode()))


def debug_fail_connections(addr: str) -> int:
    """Fails every live client connection to ``addr`` ("ip:port") —
    exactly what the peer observes when the process holding those
    sockets dies.  The abrupt-death lever for leak/teardown tests (the
    stream registry's socket-failure teardown fires, receivers see
    ``on_closed``).  Returns the number of sockets failed."""
    return _load().brt_debug_fail_connections(addr.encode())


class RpcError(RuntimeError):
    def __init__(self, code: int, text: str):
        super().__init__(f"rpc failed ({code}): {text}")
        self.code = code


def _req_ptr(request):
    """Request bytes for a native call: ``bytes`` pass straight through;
    writable buffers (``bytearray``/``memoryview``) are wrapped zero-copy
    — legal because every native call path copies the request before
    returning, so the caller may reuse the buffer immediately.  This is
    what lets the PS client frame each request into ONE pre-sized
    ``bytearray`` instead of concatenating intermediates."""
    if isinstance(request, bytes) or request is None:
        return request
    return (ctypes.c_char * len(request)).from_buffer(request)


# ---------------------------------------------------------------------------
# zero-copy buffer currency (brt_iobuf_* — capi/iobuf_capi.cc)
# ---------------------------------------------------------------------------

# Pin registry for borrowed blocks: append_pinned hands the native core a
# raw pointer into a Python buffer and parks the owning object here; the
# native release callback (last-ref drop — possibly on a socket thread,
# GIL auto-acquired) pops it.  The ledger of live pins is exact: a pinned
# buffer outlives every wire write that borrowed it, never longer.
_iobuf_pin_mu = threading.Lock()
_iobuf_pins: dict = {}
_iobuf_pin_seq = [0]


@_IOBUF_RELEASE
def _iobuf_release_cb(data, arg):
    with _iobuf_pin_mu:
        _iobuf_pins.pop(arg, None)


def debug_iobuf_pins() -> int:
    """Live borrowed-block pins (buffers the native core still holds a
    reference into).  Drops to zero once every in-flight write drained."""
    with _iobuf_pin_mu:
        return len(_iobuf_pins)


def _pin_buffer(data):
    """(address, nbytes, keepalive) of ``data``'s memory WITHOUT copying.
    Accepts bytes, writable buffers (bytearray/memoryview/numpy) and
    read-only numpy arrays; the keepalive object must stay referenced
    until the native side releases the block."""
    if isinstance(data, bytes):
        addr = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value
        return addr, len(data), data
    if hasattr(data, "__array_interface__"):       # numpy, any writability
        ai = data.__array_interface__
        if ai.get("strides") is not None:
            raise ValueError("append_pinned needs a contiguous array")
        return ai["data"][0], data.nbytes, data
    mv = memoryview(data)
    if not mv.contiguous:
        raise ValueError("append_pinned needs a contiguous buffer")
    if mv.readonly:
        # ctypes can't from_buffer a read-only view; numpy can still
        # surface the address (the pin keeps the chain alive).
        import numpy as np
        arr = np.frombuffer(mv, np.uint8)
        return (arr.__array_interface__["data"][0], mv.nbytes,
                (data, mv, arr))
    c = (ctypes.c_char * mv.nbytes).from_buffer(mv)
    return ctypes.addressof(c), mv.nbytes, (data, mv, c)


class _IobufToken:
    """Keepalive anchor: every exported view holds a reference, and the
    native handle is destroyed by the token's finalizer once the LAST
    holder (wrapper or view) is gone — a borrowed view can therefore
    never dangle."""

    __slots__ = ("__weakref__",)


#: Crossover below which the zero-copy machinery COSTS more than the
#: copy it saves (native handle + pin-registry lifecycle vs a sub-page
#: memcpy): requests/responses carried as an :class:`IOBuf` under this
#: size are routed through the plain bytes twin automatically — the
#: wire bytes are identical — unless the handle was built with
#: ``force_iobuf=True``.  The PS tier keys its engagement floor off
#: this same constant (ps_remote._ZC_MIN_BYTES).
IOBUF_MIN_BYTES = 4096


class IOBuf:
    """A native refcounted buffer chain (``brt::IOBuf``) addressed from
    Python — the zero-copy currency of the RPC tier.

    Build requests as [small owned header ++ borrowed payload]:
    ``append()`` copies (use it for the few-byte framing headers),
    ``append_pinned()`` borrows the caller's buffer with NO copy — the
    buffer is pinned in a registry until the native core drops its last
    reference (i.e. after the socket write drained), so mutating it
    before then is a data race the caller owns.  Responses come back as
    an :class:`IOBuf` from ``Channel.call``/``PendingCall.join`` when the
    request went in as one; read them with ``as_memoryview()`` (zero-copy
    for single-block bodies) or ``tobytes()``.

    Lifetime: ``close()`` releases the handle — unless live views exist,
    in which case destruction defers to the last view's death (the
    borrow-not-dangle contract).  Abandoned handles are reclaimed by GC
    via the same finalizer, but the ledger check expects explicit
    ``close()``.
    """

    __slots__ = ("_lib", "_ptr", "_token", "_fin", "force_iobuf")

    def __init__(self, data=None, *, force_iobuf: bool = False):
        lib = _load()
        ptr = lib.brt_iobuf_new()
        if not ptr:
            raise MemoryError("brt_iobuf_new failed")
        self._lib = lib
        self._ptr = ptr
        self._token = _IobufToken()
        self._fin = weakref.finalize(self._token, lib.brt_iobuf_destroy,
                                     ptr)
        #: escape hatch for the sub-IOBUF_MIN_BYTES bytes-twin routing:
        #: True keeps this handle on the native iobuf path end to end
        #: no matter how small the payload is
        self.force_iobuf = bool(force_iobuf)
        if data:
            self.append(data)

    @classmethod
    def _adopt(cls, lib, ptr) -> "IOBuf":
        """Wraps a native handle we already own (response swaps)."""
        io = cls.__new__(cls)
        io._lib = lib
        io._ptr = ptr
        io._token = _IobufToken()
        io._fin = weakref.finalize(io._token, lib.brt_iobuf_destroy,
                                   ptr)
        io.force_iobuf = False
        return io

    def __len__(self) -> int:
        if self._ptr is None:
            return 0
        return int(self._lib.brt_iobuf_size(self._ptr))

    @property
    def size(self) -> int:
        return len(self)

    @property
    def block_count(self) -> int:
        if self._ptr is None:
            return 0
        return self._lib.brt_iobuf_block_count(self._ptr)

    def _require(self):
        if self._ptr is None:
            raise RuntimeError("IOBuf is closed")
        return self._ptr

    def append(self, data) -> None:
        """Copying append (the native side owns a copy) — right for the
        few-byte framing headers in front of a borrowed payload."""
        ptr = self._require()
        if not isinstance(data, (bytes, bytearray, memoryview)):
            data = bytes(data)
        n = len(data)
        if n == 0:
            return
        rc = self._lib.brt_iobuf_append(ptr, _req_ptr(data), n)
        if rc != 0:
            raise RpcError(rc, "iobuf append failed")

    def append_pinned(self, data) -> None:
        """Zero-copy append: the native chain BORROWS ``data``'s memory.
        ``data`` is pinned (kept alive and counted in
        :func:`debug_iobuf_pins`) until the core's last reference drops;
        the caller must not mutate it before then."""
        ptr = self._require()
        addr, n, keep = _pin_buffer(data)
        if n == 0:
            return
        with _iobuf_pin_mu:
            _iobuf_pin_seq[0] += 1
            token = _iobuf_pin_seq[0]
            _iobuf_pins[token] = keep
        rc = self._lib.brt_iobuf_append_user_data(
            ptr, addr, n, _iobuf_release_cb, token)
        if rc != 0:
            with _iobuf_pin_mu:
                _iobuf_pins.pop(token, None)
            raise RpcError(rc, "iobuf append_pinned failed")

    def append_iobuf(self, other: "IOBuf") -> None:
        """Shares ``other``'s blocks (refcount bump, no payload copy)."""
        ptr = self._require()
        rc = self._lib.brt_iobuf_append_iobuf(ptr, other._require())
        if rc != 0:
            raise RpcError(rc, "iobuf append_iobuf failed")

    def as_memoryview(self) -> memoryview:
        """The contents as a buffer suitable for ``np.frombuffer``.

        Single-block chains (bodies under the native 8KB block size, and
        swapped-in responses whose payload was one borrowed block) export
        a ZERO-COPY view over native memory: the view holds the handle's
        keepalive token, so it stays valid after ``close()`` — the
        handle's destruction defers to the view's death.  Multi-block
        chains gather once into fresh memory (still one copy fewer than
        the bytes path)."""
        ptr = self._require()
        nblocks = self._lib.brt_iobuf_block_count(ptr)
        if nblocks == 1:
            n = int(self._lib.brt_iobuf_block_len(ptr, 0))
            base = self._lib.brt_iobuf_block_data(ptr, 0)
            arr = (ctypes.c_char * n).from_address(base)
            # The view must pin the native handle: ctypes instances keep
            # arbitrary attributes, and memoryview(arr) keeps arr.
            arr._brt_keepalive = self._token
            return memoryview(arr)
        total = int(self._lib.brt_iobuf_size(ptr))
        out = bytearray(total)
        if total:
            got = self._lib.brt_iobuf_copy_out(
                ptr, (ctypes.c_char * total).from_buffer(out), total, 0)
            if got != total:
                raise RpcError(-1, f"iobuf gather {got} != {total}")
            if obs.enabled():
                obs.counter("rpc_bytes_copied").add(total)
        return memoryview(out)

    def tobytes(self) -> bytes:
        """Copy out the full contents (the compatibility exit)."""
        ptr = self._require()
        total = int(self._lib.brt_iobuf_size(ptr))
        out = bytearray(total)
        if total:
            self._lib.brt_iobuf_copy_out(
                ptr, (ctypes.c_char * total).from_buffer(out), total, 0)
            if obs.enabled():
                obs.counter("rpc_bytes_copied").add(total)
        return bytes(out)

    def close(self) -> None:
        """Release the handle.  With live ``as_memoryview()`` views the
        native buffer stays pinned and destruction happens when the last
        view dies; without views it is destroyed here, now."""
        if self._ptr is None:
            return
        ptr, self._ptr = self._ptr, None
        token, self._token = self._token, None
        # 2 = the local `token` + getrefcount's argument ref: no view
        # holds the anchor, so the handle can die synchronously.
        # Otherwise the finalizer owns destruction — it fires when the
        # last view drops the token.
        if sys.getrefcount(token) <= 2:
            self._fin.detach()
            self._lib.brt_iobuf_destroy(ptr)
        del token

    def __enter__(self) -> "IOBuf":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# server-side stream receivers (one process-global dispatch trampoline)
# ---------------------------------------------------------------------------

# stream_id -> receiver (an object with on_data(bytes) / on_closed()).
# Server side: registered by Server.add_stream_handler's accept() before
# the response leaves (so no frame can beat the registration).  Client
# side (``Channel.stream(receiver=...)``): the native create returns the
# stream id only AFTER the setup RPC — a fast server can write frames
# that arrive BEFORE the Python registration, so unknown-sid frames are
# buffered (bounded) and drained through a two-phase handoff when the
# registration lands; ordering is preserved because the native exec
# fiber only appends while the handoff placeholder is present.  Entries
# are removed when the peer's CLOSE is delivered.
_stream_mu = _race.checked_lock("rpc.stream.receivers")
_stream_receivers: dict = {}
# sid -> [queued_bytes, frames]; a frame of None = the close sentinel
_stream_orphans: dict = {}
_STREAM_ORPHAN_SIDS = 64     # dropped-oldest bound on unclaimed sids
_STREAM_ORPHAN_BYTES = 1 << 20   # per-sid queued-bytes bound


class _PreRegistration:
    """Handoff placeholder: while present, the dispatch fiber APPENDS
    frames instead of delivering, and the registering thread drains in
    order before flipping the entry to the real receiver."""

    __slots__ = ("queued",)

    def __init__(self, queued):
        self.queued = queued   # list of frames; None element = close


def _deliver(receiver, item, stream_id: int) -> None:
    if item is None:
        _handles.note_destroy("stream_receiver", stream_id)
        try:
            receiver.on_closed()
        finally:
            # Complete the close handshake: the peer already closed,
            # closing our side fully retires the native stream (and
            # wakes the peer's join).
            _load().brt_stream_close(stream_id)
    else:
        receiver.on_data(item)


def _register_stream_receiver(stream_id: int, receiver) -> None:
    _handles.note_create("stream_receiver", stream_id)
    pre = None
    with _stream_mu:
        orphans = _stream_orphans.pop(stream_id, None)
        if orphans and orphans[1]:
            pre = _PreRegistration(orphans[1])
            _stream_receivers[stream_id] = pre
        else:
            _stream_receivers[stream_id] = receiver
    if pre is None:
        return
    # Drain-then-flip: pop one queued frame at a time (the exec fiber may
    # still be appending), deliver it on THIS thread, and atomically swap
    # in the receiver once the queue is empty.
    while True:
        with _stream_mu:
            if pre.queued:
                item = pre.queued.pop(0)
            else:
                if _stream_receivers.get(stream_id) is pre:
                    _stream_receivers[stream_id] = receiver
                return
        _deliver(receiver, item, stream_id)
        if item is None:
            with _stream_mu:
                _stream_receivers.pop(stream_id, None)
            return


@_STREAM_HANDLER
def _stream_dispatch(user, stream_id, data, length, closed):
    """Runs serialized per stream on the native ExecutionQueue consumer
    (same fiber→Python shape as the service trampoline).  A slow receiver
    back-pressures the writer through the consumed-bytes feedback — that
    is the design, not a bug.  Exceptions cannot reach a response (frames
    have none), so they are counted and swallowed."""
    try:
        payload = None
        if not closed:
            payload = ctypes.string_at(data, length) if length else b""
        evicted: list = []
        with _stream_mu:
            receiver = _stream_receivers.get(stream_id)
            if isinstance(receiver, _PreRegistration):
                receiver.queued.append(payload)
                return
            if receiver is None:
                # Not (yet) registered: buffer for a racing client-side
                # registration (Channel.stream(receiver=...)).  Unclaimed
                # sids are bounded two ways — count (drop the oldest sid)
                # and per-sid queued bytes (a firehose nobody claims is
                # garbage, not a registration race: the race window is
                # one Python call).  An evicted sid gets its native close
                # completed below so the peer's join isn't stranded.
                entry = _stream_orphans.setdefault(stream_id, [0, []])
                entry[0] += length if payload is not None else 0
                entry[1].append(payload)
                if entry[0] > _STREAM_ORPHAN_BYTES:
                    _stream_orphans.pop(stream_id, None)
                    evicted.append(stream_id)
                while len(_stream_orphans) > _STREAM_ORPHAN_SIDS:
                    sid = next(iter(_stream_orphans))
                    _stream_orphans.pop(sid)
                    evicted.append(sid)
            elif closed:
                _stream_receivers.pop(stream_id, None)
        if evicted:
            lib = _load()
            for sid in evicted:
                # Complete/abort the native half regardless of whether
                # the dropped queue held the close sentinel — this is
                # what retires the native stream for a sid no receiver
                # will ever claim.
                lib.brt_stream_close(sid)
                if obs.enabled():
                    obs.counter("stream_orphans_evicted").add(1)
            return
        if receiver is None:
            return
        if closed:
            _handles.note_destroy("stream_receiver", stream_id)
            try:
                receiver.on_closed()
            finally:
                _load().brt_stream_close(stream_id)
        else:
            receiver.on_data(payload)
    except Exception:  # noqa: BLE001 — no response channel for frames
        if obs.enabled():
            obs.counter("stream_handler_errors").add(1)


def _make_stream_accept(lib, session):
    """The ``accept`` callable handed to a stream-capable handler: binds
    the stream riding the in-flight request to ``receiver`` and registers
    it for dispatch.  Must run inside the handler, before the response
    leaves — which is guaranteed, because the trampoline responds only
    after the handler returns.  Returns the server half as a writable
    :class:`Stream` — the native stream layer is symmetric, so the
    handler (or its receiver) may WRITE frames back to the client
    (server→client direction: acks, progress, catch-up data); the client
    reads them by passing ``receiver=`` to :meth:`Channel.stream`."""

    def accept(receiver, max_buf_size: int = 0) -> "Stream":
        sid = ctypes.c_uint64()
        rc = lib.brt_stream_accept(session, max_buf_size, _stream_dispatch,
                                   None, ctypes.byref(sid))
        if rc != 0:
            raise RpcError(rc, "stream accept failed "
                               "(request carries no stream?)")
        # Register before the response can reach the client: no data
        # frame can arrive until the client learns the peer stream id
        # from the response meta.
        _register_stream_receiver(sid.value, receiver)
        if obs.enabled():
            obs.counter("stream_accepts").add(1)
        # track=False: the server half's lifecycle belongs to the close
        # handshake in _stream_dispatch (receiver registry is the ledger
        # entry); this wrapper is a write surface, not an owner.
        return Stream(lib, sid.value, b"", "", "", "peer", track=False)

    return accept


# ---------------------------------------------------------------------------
# native pre-dispatch drop hook (fault-injection tier)
# ---------------------------------------------------------------------------

# listen port -> "ip:port" of live servers, so the drop hook can hand the
# fault plan the same endpoint string its per-endpoint rules match on.
_servers_by_port: dict = {}
_drop_hook_ref = None  # pinned CFUNCTYPE while installed


def install_drop_hook() -> None:
    """Installs the native pre-dispatch drop hook (idempotent): every
    parsed request consults :func:`brpc_tpu_torch.fault.server_drop_intercept`
    before dispatch, and a firing ``drop`` rule discards it silently —
    no response, so the CLIENT's real timeout path runs.  Called by
    ``fault.install`` when a plan carries server-side drop rules; raises
    :class:`NativeCoreUnavailable` without the native core."""
    global _drop_hook_ref
    if _drop_hook_ref is not None:
        return
    lib = _load()

    @_DROP_HOOK
    def hook(user, service, method, port):
        try:
            if not fault.active():
                return 0
            dropped = fault.server_drop_intercept(
                service.decode(errors="replace"),
                method.decode(errors="replace"),
                _servers_by_port.get(port))
            return 1 if dropped else 0
        except Exception:  # noqa: BLE001 — never fail the request path
            return 0

    _drop_hook_ref = hook  # pin before install: the native side keeps it
    lib.brt_set_drop_hook(hook, None)


def uninstall_drop_hook() -> None:
    """Removes the native drop hook (test isolation)."""
    global _drop_hook_ref
    if _drop_hook_ref is None:
        return
    _load().brt_set_drop_hook(ctypes.cast(None, _DROP_HOOK), None)
    _drop_hook_ref = None


#: overload-shed error codes -> the rpcz annotation that keeps shed
#: requests visible in traces instead of vanishing as generic errors
_SHED_TAGS = {2004: "shed=limiter", 2014: "shed=deadline"}


def _record_server_call(service: str, method: str, t0: int, wall: float,
                        req_len: int, rsp_len: int,
                        error: Optional[str],
                        error_code: int = 2001) -> None:
    elapsed = time.monotonic_ns() - t0
    end = obs.clock_ns()
    obs.recorder(f"rpc_server_{service}_{method}").record(elapsed / 1e9)
    obs.counter("rpc_server_in_bytes").add(req_len)
    obs.counter("rpc_server_out_bytes").add(rsp_len)
    if error is not None:
        obs.counter("rpc_server_errors").add(1)
    tag = _SHED_TAGS.get(error_code) if error is not None else None
    obs.record_span(obs.Span(
        service=service, method=method, side="server",
        request_bytes=req_len, response_bytes=rsp_len,
        start_ns=end - elapsed, end_ns=end, wall_time=wall,
        error_code=error_code if error else 0,
        error_text=error or "",
        annotations=[tag] if tag else []))


def _error_code_of(e: BaseException) -> int:
    """Server-side failure code: a handler raising :class:`RpcError`
    (fault injection, an overload rejection) keeps its code on the wire;
    anything else is EINTERNAL (2001)."""
    code = getattr(e, "code", None)
    return code if isinstance(code, int) and code != 0 else 2001


def _record_client_call(service: str, method: str, peer: str, t0: int,
                        wall: float, req_len: int, rsp_len: int,
                        error_code: int, error_text: str,
                        tag: Optional[str] = None) -> None:
    elapsed = time.monotonic_ns() - t0
    end = obs.clock_ns()
    obs.recorder(f"rpc_client_{service}_{method}").record(elapsed / 1e9)
    obs.counter("rpc_client_out_bytes").add(req_len)
    obs.counter("rpc_client_in_bytes").add(rsp_len)
    if error_code:
        obs.counter("rpc_client_errors").add(1)
    obs.record_span(obs.Span(
        service=service, method=method, side="client", peer=peer,
        request_bytes=req_len, response_bytes=rsp_len,
        start_ns=end - elapsed, end_ns=end, wall_time=wall,
        error_code=error_code,
        error_text=error_text,
        annotations=[tag] if tag else []))


class Server:
    """Native RPC server. Handlers: fn(method: str, request: bytes) -> bytes
    (raise to fail the call)."""

    def __init__(self):
        self._lib = _load()
        self._ptr = self._lib.brt_server_new()
        self._handlers = []  # keep CFUNCTYPE refs alive
        self._listen: Optional[str] = None  # set by start()
        # per-method overload control (brpc_tpu_torch.limiter.ServerLimiter);
        # consulted by both trampolines on every dispatch
        self._limiter = None

    def set_concurrency_limiter(self, limiter) -> None:
        """Installs per-method overload control on the PYTHON
        trampolines: ``limiter`` is a
        :class:`brpc_tpu_torch.limiter.ServerLimiter` (None clears).  A
        request its method gate refuses answers ``ELIMIT`` (2004)
        without touching the handler; admitted requests feed the
        gate's limiter with their outcome and handler latency.
        Live-switchable — gates are consulted per dispatch."""
        self._limiter = limiter

    def set_native_concurrency_limiter(self, name: str,
                                       max_concurrency: int = 0) -> None:
        """Installs the NATIVE server-wide concurrency limiter
        (``"auto"``, ``"constant"`` + ``max_concurrency``,
        ``"timeout[:us]"``, ``""`` = off — cpp/rpc/concurrency_limiter):
        enforced in the C++ dispatch path before ANY Python runs, so the
        zero-Python native Lookup path (``add_ps_service``) sheds too.
        Must be called before :meth:`start`."""
        rc = self._lib.brt_server_set_concurrency_limiter(
            self._ptr, name.encode(), max_concurrency)
        if rc != 0:
            raise RuntimeError(
                f"set_native_concurrency_limiter failed: {rc} "
                f"(server already started?)")

    @property
    def native_max_concurrency(self) -> int:
        """The native limiter's current ceiling (0 = off/unlimited) —
        the adaptive gauge for the native dispatch path."""
        return self._lib.brt_server_max_concurrency(self._ptr)

    def _sync_trampoline(self, name: str,
                         handler: Callable[[str, bytes], bytes], *,
                         pass_accept: bool = False):
        """Builds the fiber->Python trampoline shared by
        :meth:`add_service`, :meth:`add_ps_service` and
        :meth:`add_stream_handler` (the caller must pin the returned
        CFUNCTYPE on ``self._handlers``).  With ``pass_accept`` the
        handler is called as ``handler(method, request, accept)`` and may
        invoke ``accept(receiver, max_buf_size=0)`` once, BEFORE
        returning, to bind the stream riding this request."""
        lib = self._lib

        @_HANDLER
        def trampoline(user, method, req, req_len, session):
            rec = obs.enabled()
            # t0 is unconditional: the method gate's limiter needs the
            # handler latency whether or not obs is recording
            t0 = time.monotonic_ns()
            wall = time.time() if rec else 0.0
            m = b""
            mstr = ""
            out_len = 0
            err = None
            err_code = 0
            gate = None
            try:
                m = method
                mstr = m.decode()
                lim = self._limiter
                if lim is not None:
                    g = lim.gate(mstr)
                    if g is not None:
                        if not g.admit():
                            # per-method overload shed: answered before
                            # the handler (or even the request bytes)
                            # are touched — the MethodStatus::OnRequested
                            # contract
                            raise RpcError(
                                resilience.ELIMIT,
                                f"{name}.{mstr} shed: concurrency limit "
                                f"{g.max_concurrency} reached")
                        gate = g
                data = ctypes.string_at(req, req_len) if req_len else b""
                if rec and req_len:
                    obs.counter("rpc_bytes_copied").add(req_len)
                if fault.active():
                    fault.server_intercept(name, mstr, self._listen)
                if pass_accept:
                    out = handler(mstr, data,
                                  _make_stream_accept(lib, session))
                else:
                    out = handler(mstr, data)
                if out is None:
                    out = b""
                out_len = len(out)
            except Exception as e:  # noqa: BLE001
                err = str(e)
                err_code = _error_code_of(e)
            # Accounting BEFORE the response leaves: the moment the
            # client sees the reply it may read this server's vars —
            # a record landing after the respond races that read.
            try:
                if gate is not None:
                    gate.on_responded(
                        err_code, (time.monotonic_ns() - t0) // 1000)
                if rec:
                    _record_server_call(
                        name, mstr or m.decode(errors="replace"), t0,
                        wall, req_len, out_len, err,
                        err_code if err else 2001)
            finally:
                if err is None:
                    if isinstance(out, IOBuf) and not out.force_iobuf \
                            and out_len < IOBUF_MIN_BYTES:
                        # Sub-crossover response: the bytes twin is
                        # cheaper than the respond_iobuf handle dance
                        # (identical wire bytes).
                        data = out.tobytes()
                        out.close()
                        lib.brt_session_respond(session, data, out_len,
                                                0, None)
                    elif isinstance(out, IOBuf):
                        # The response SHARES the handler's blocks (no
                        # copy); the handle is not consumed — close it
                        # here, which defers actual destruction past the
                        # socket write via the block refcounts.
                        lib.brt_session_respond_iobuf(
                            session, out._require(), 0, None)
                        out.close()
                    else:
                        lib.brt_session_respond(session, out, out_len, 0,
                                                None)
                else:
                    lib.brt_session_respond(session, None, 0, err_code,
                                            err.encode())

        return trampoline

    def add_service(self, name: str,
                    handler: Callable[[str, bytes], bytes]) -> None:
        trampoline = self._sync_trampoline(name, handler)
        rc = self._lib.brt_server_add_service(self._ptr, name.encode(),
                                              trampoline, None)
        if rc != 0:
            raise RuntimeError(f"add_service failed: {rc}")
        self._handlers.append(trampoline)

    def add_stream_handler(self, name: str, handler) -> None:
        """Registers a service whose handler may ACCEPT streams:
        ``handler(method, request, accept) -> bytes``.  A method that
        wants the client's stream calls ``accept(receiver,
        max_buf_size=0)`` (at most once, before returning); ``receiver``
        then gets ``on_data(bytes)`` per frame and ``on_closed()`` once,
        serialized, after the client's graceful close — a slow receiver
        back-pressures the writer through the stream's consumed-bytes
        window.  Methods that ignore ``accept`` behave exactly like
        :meth:`add_service` handlers.  The server auto-closes its half of
        a stream after ``on_closed`` (completing the handshake the
        client's ``Stream.join`` waits on); a client that dies WITHOUT
        closing gets the same teardown — the socket-failure hook in the
        native stream registry delivers a synthetic close (ordered after
        queued data), so ``on_closed`` still fires and the receiver is
        freed, not leaked."""
        trampoline = self._sync_trampoline(name, handler, pass_accept=True)
        rc = self._lib.brt_server_add_service(self._ptr, name.encode(),
                                              trampoline, None)
        if rc != 0:
            raise RuntimeError(f"add_stream_handler failed: {rc}")
        self._handlers.append(trampoline)

    def add_ps_service(self, name: str, shard: "PsShard",
                       fallback: Callable[[str, bytes], bytes], *,
                       stream: bool = False) -> None:
        """Registers a PS service whose ``Lookup`` is served NATIVELY from
        ``shard`` — zero Python (no GIL, no ctypes trampoline, no request
        framing) in the read loop.  Every other method (``ApplyGrad``,
        lifecycle, fault injection) dispatches to ``fallback`` on the
        standard trampoline, so the Python tier keeps the write path.
        With ``stream=True`` the fallback is stream-capable and called as
        ``fallback(method, request, accept)`` (see
        :meth:`add_stream_handler`) — the streaming gradient push rides
        the same service as the native read path.  The shard must outlive
        this server (close the server first)."""
        trampoline = self._sync_trampoline(name, fallback,
                                           pass_accept=stream)
        rc = self._lib.brt_server_add_ps_service(
            self._ptr, name.encode(), shard._ptr, trampoline, None)
        if rc != 0:
            raise RuntimeError(f"add_ps_service failed: {rc}")
        self._handlers.append(trampoline)

    def add_async_service(self, name: str, handler) -> None:
        """handler(method: str, request: bytes, respond) — call
        ``respond(data: bytes)`` or ``respond(error=str)`` EXACTLY once,
        from any thread, any time (the fiber worker is released
        immediately — the "enqueue JAX work without blocking workers"
        shape: dispatch, return, respond from the completion callback)."""
        lib = self._lib

        @_HANDLER
        def trampoline(user, method, req, req_len, session):
            data = ctypes.string_at(req, req_len) if req_len else b""
            sess = ctypes.c_void_p(session)
            m = method.decode()
            rec = obs.enabled()
            t0 = time.monotonic_ns()  # gate latency needs it without obs
            if rec:
                wall = time.time()
                nreq = req_len
            gate = None

            def respond(payload: bytes = b"", error: Optional[str] = None,
                        error_code: int = 2001):
                # Latency spans dispatch -> respond, wherever respond runs
                # (the async contract: any thread, after the fiber worker
                # is long gone).  Accounting lands BEFORE the response
                # leaves — a client reading this server's vars right
                # after its reply must see this call counted.
                if gate is not None:
                    gate.on_responded(
                        error_code if error is not None else 0,
                        (time.monotonic_ns() - t0) // 1000)
                if error is not None:
                    if rec:
                        _record_server_call(name, m, t0, wall, nreq, 0,
                                            error, error_code)
                    lib.brt_session_respond(sess, None, 0, error_code,
                                            error.encode())
                else:
                    if rec:
                        _record_server_call(name, m, t0, wall, nreq,
                                            len(payload), None)
                    lib.brt_session_respond(sess, payload, len(payload), 0,
                                            None)

            lim = self._limiter
            if lim is not None:
                g = lim.gate(m)
                if g is not None and not g.admit():
                    # refused: respond ELIMIT with gate still None, so
                    # nothing is released on a request never admitted
                    respond(error=f"{name}.{m} shed: concurrency limit "
                                  f"{g.max_concurrency} reached",
                            error_code=resilience.ELIMIT)
                    return
                gate = g
            try:
                if fault.active():
                    fault.server_intercept(name, m, self._listen)
                handler(m, data, respond)
            except Exception as e:  # noqa: BLE001
                respond(error=str(e), error_code=_error_code_of(e))

        rc = lib.brt_server_add_service(self._ptr, name.encode(),
                                        trampoline, None)
        if rc != 0:
            raise RuntimeError(f"add_async_service failed: {rc}")
        self._handlers.append(trampoline)

    def add_status_service(self) -> None:
        """Hosts the ``_status`` builtin service (vars + rpcz dumps over
        the RPC fabric — the reference's builtin pages, src/brpc/builtin/)
        so a remote ``Channel`` can scrape this node's metrics:
        ``obs.status_service.scrape_vars(channel)``."""
        from brpc_tpu_torch.obs.status_service import (SERVICE_NAME,
                                                 make_status_handler)
        self.add_service(SERVICE_NAME, make_status_handler())

    def add_naming_registry(self) -> None:
        """Hosts the native service registry on this server ("Naming",
        JSON-mapped — see brpc_tpu_torch.naming for the client side)."""
        rc = self._lib.brt_server_add_naming_registry(self._ptr)
        if rc != 0:
            raise RuntimeError(f"add_naming_registry failed: {rc}")

    def start(self, addr: str = "127.0.0.1:0") -> int:
        rc = self._lib.brt_server_start(self._ptr, addr.encode())
        if rc != 0:
            raise RuntimeError(f"server start failed: {rc}")
        port = self._lib.brt_server_port(self._ptr)
        # the resolved listen address identifies this server to the
        # fault plan (per-endpoint server-side rules); the port map lets
        # the NATIVE drop hook translate its port back to this string
        self._listen = f"{addr.rsplit(':', 1)[0]}:{port}"
        _servers_by_port[port] = self._listen
        return port

    @property
    def port(self) -> int:
        return self._lib.brt_server_port(self._ptr)

    def stop(self) -> None:
        if self._ptr:
            self._lib.brt_server_stop(self._ptr)

    def close(self) -> None:
        if self._ptr:
            self._lib.brt_server_destroy(self._ptr)
            self._ptr = None


class PendingCall:
    """One in-flight async RPC (from :meth:`Channel.call_async`).

    ``join()`` parks until the reply lands and returns the response bytes
    (or raises :class:`RpcError` with the server/transport failure — same
    contract as the synchronous ``call``).  ``wait(timeout_s)`` peeks at
    completion without consuming it; ``cancel()`` requests native
    cancellation (reference ``StartCancel``) — the call still completes
    exactly once, with ECANCELEDRPC (2005) if the cancel won, so
    ``join``/``close`` stay mandatory.  The native handle is freed
    exactly once, by ``join()`` or ``close()``; ``close()`` on an
    un-joined call waits for completion first (the native core may still
    be filling the response), so abandoning a fan-out mid-error is safe —
    and cheap after ``cancel()``, which is how the PS tier abandons
    straggler shards.
    """

    __slots__ = ("_lib", "_ptr", "_service", "_method", "_peer",
                 "_req_len", "_t0", "_wall", "_tag", "_iobuf")

    def __init__(self, lib, ptr, service, method, peer, req_len, t0, wall,
                 tag=None, iobuf=False):
        self._lib = lib
        self._ptr = ptr
        self._service = service
        self._method = method
        self._peer = peer
        self._req_len = req_len
        self._t0 = t0      # None when obs was disabled at start
        self._wall = wall
        self._tag = tag
        # Calls started with an IOBuf request join to an IOBuf response
        # (brt_call_join_iobuf swaps the blocks out — no copy).
        self._iobuf = iobuf

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        """True once the call has completed (``join`` will not block).
        ``timeout_s=None`` waits indefinitely; ``0`` polls.  Callable
        any number of times — nothing is consumed."""
        if self._ptr is None:
            return True
        if timeout_s is None:
            if _race.enabled():
                _race.note_blocking("brt_call_wait")
            return self._lib.brt_call_wait(self._ptr, -1) == 0
        us = max(0, int(timeout_s * 1e6))
        return self._lib.brt_call_wait(self._ptr, us) == 0

    def cancel(self) -> None:
        """Request cancellation (safe from any thread, idempotent, no-op
        after completion).  The losing half of a backup-request hedge and
        abandoned PS stragglers go through here."""
        if self._ptr is not None:
            self._lib.brt_call_cancel(self._ptr)
            if obs.enabled():
                obs.counter("rpc_cancels").add(1)

    def join(self) -> bytes:
        if self._ptr is None:
            raise RuntimeError("async call already joined/closed")
        if _race.enabled():
            _race.note_blocking("brt_call_join")
        if self._iobuf:
            return self._join_iobuf()
        ptr, self._ptr = self._ptr, None
        rsp = ctypes.c_void_p()
        rsp_len = ctypes.c_size_t()
        errbuf = ctypes.create_string_buffer(256)
        try:
            rc = self._lib.brt_call_join(ptr, ctypes.byref(rsp),
                                         ctypes.byref(rsp_len), errbuf, 256)
            if rc != 0:
                text = errbuf.value.decode(errors="replace")
                if self._t0 is not None:
                    _record_client_call(self._service, self._method,
                                        self._peer, self._t0, self._wall,
                                        self._req_len, 0, rc, text,
                                        self._tag)
                raise RpcError(rc, text)
            try:
                out = ctypes.string_at(rsp, rsp_len.value)
            finally:
                self._lib.brt_free(rsp)
        finally:
            self._lib.brt_call_destroy(ptr)
        if self._t0 is not None:
            # start -> join latency: the caller-visible async window
            _record_client_call(self._service, self._method, self._peer,
                                self._t0, self._wall, self._req_len,
                                len(out), 0, "", self._tag)
            obs.counter("rpc_bytes_copied").add(len(out))
        return out

    def _join_iobuf(self) -> "IOBuf":
        """Collects the reply as an :class:`IOBuf` — the response blocks
        are swapped out of the call, not copied."""
        ptr, self._ptr = self._ptr, None
        err = ctypes.c_int()
        errbuf = ctypes.create_string_buffer(256)
        try:
            h = self._lib.brt_call_join_iobuf(ptr, ctypes.byref(err),
                                              errbuf, 256)
            if not h:
                text = errbuf.value.decode(errors="replace")
                if self._t0 is not None:
                    _record_client_call(self._service, self._method,
                                        self._peer, self._t0, self._wall,
                                        self._req_len, 0, err.value, text,
                                        self._tag)
                raise RpcError(err.value or -1, text)
        finally:
            self._lib.brt_call_destroy(ptr)
        out = IOBuf._adopt(self._lib, h)
        if self._t0 is not None:
            _record_client_call(self._service, self._method, self._peer,
                                self._t0, self._wall, self._req_len,
                                len(out), 0, "", self._tag)
        return out

    def close(self) -> None:
        """Abandon without collecting the result (no-op after join)."""
        if self._ptr is not None:
            ptr, self._ptr = self._ptr, None
            self._lib.brt_call_destroy(ptr)


class CallGroup:
    """Exact multi-call fan-in: one native CountdownEvent signaled by the
    done-closure of every registered call (the ParallelChannel shape,
    cpp/cluster/parallel_channel.*).

    ``add()`` registers an un-consumed :class:`PendingCall` (a call that
    already completed counts immediately).  ``wait()`` parks until EVERY
    registered call has completed; ``wait_any()`` parks until a completion
    that no previous ``wait_any`` consumed exists, consumes it, and
    returns — N calls yield exactly N successful ``wait_any`` returns, so
    hedge/fan-out loops wake exactly instead of polling ``wait`` in time
    slices.  The group observes completion only: ``join()``/``close()``
    each call as usual.  ``close()`` is safe with members still in flight
    (registration is refcounted natively)."""

    __slots__ = ("_lib", "_ptr")

    def __init__(self):
        self._lib = _load()
        self._ptr = self._lib.brt_call_group_new()

    def add(self, call: PendingCall) -> None:
        if self._ptr is None or call._ptr is None:
            raise RuntimeError("cannot add a joined/closed call to a group")
        self._lib.brt_call_group_add(self._ptr, call._ptr)

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        """True once every registered call has completed (all joins are
        then non-blocking).  Level-triggered; callable repeatedly."""
        if obs.enabled():
            obs.counter("rpc_group_waits").add(1)
        if timeout_s is None:
            if _race.enabled():
                _race.note_blocking("brt_call_group_wait")
            return self._lib.brt_call_group_wait(self._ptr, -1) == 0
        us = max(0, int(timeout_s * 1e6))
        return self._lib.brt_call_group_wait(self._ptr, us) == 0

    def wait_any(self, timeout_s: Optional[float] = None) -> bool:
        """True once an unconsumed completion exists (consuming it): each
        successful return corresponds to exactly one call completing."""
        if obs.enabled():
            obs.counter("rpc_group_waits").add(1)
        if timeout_s is None:
            if _race.enabled():
                _race.note_blocking("brt_call_group_wait")
            return self._lib.brt_call_group_wait_any(self._ptr, -1) == 0
        us = max(0, int(timeout_s * 1e6))
        return self._lib.brt_call_group_wait_any(self._ptr, us) == 0

    @property
    def completed(self) -> int:
        """Completions observed so far (diagnostics)."""
        return self._lib.brt_call_group_completed(self._ptr)

    def close(self) -> None:
        if self._ptr is not None:
            ptr, self._ptr = self._ptr, None
            self._lib.brt_call_group_destroy(ptr)


class Stream:
    """Client write side of a streaming RPC (from :meth:`Channel.stream`).

    An ordered, flow-controlled frame pipe bound to the channel's
    connection (the reference's StreamCreate/StreamWrite,
    cpp/rpc/stream.*): ``write()`` ships one framed message at wire rate
    and PARKS when the peer's unconsumed window (``max_buf_size``) is
    full — backpressure is real, not advisory; the stalled time feeds the
    ``stream_stall_ms`` counter.  ``close()`` is graceful: in-flight
    frames drain to the receiver IN ORDER before its ``on_closed`` runs,
    and ``join()`` returns once the peer has consumed everything and
    closed its half — the "every pushed delta is applied" barrier the PS
    tier builds on.  ``abort()`` is the error-path teardown (failed
    setup, dead connection): immediate, nothing reaches the peer.

    Writes on one stream must come from one thread at a time (frame
    order is the caller's once two writers interleave).
    """

    # Stalls below this are the wait-free socket write itself, not
    # backpressure; counting them would drown the signal in noise.
    _STALL_FLOOR_US = 1000

    __slots__ = ("_lib", "_id", "response", "service", "method", "peer",
                 "_closed", "_track")

    def __init__(self, lib, stream_id: int, response: bytes, service: str,
                 method: str, peer: str, track: bool = True):
        self._lib = lib
        self._id = stream_id
        #: the setup RPC's response bytes (the server's accept-time answer)
        self.response = response
        self.service = service
        self.method = method
        self.peer = peer
        self._closed = False
        # Client streams own their ledger entry; the server-half write
        # surface returned by accept() does not (the receiver registry
        # entry is that stream's ledger record).
        self._track = track

    def write(self, data) -> None:
        """Ordered framed write (bytes/bytearray/memoryview — the native
        side copies before returning).  Parks while the flow-control
        window is full; raises :class:`RpcError` on a closed/broken
        stream (EPIPE: peer closed; EINVAL: locally closed/unknown)."""
        if self._closed:
            raise RpcError(22, f"stream to {self.peer} is closed")
        if _race.enabled():
            _race.note_blocking("brt_stream_write")
        stall = ctypes.c_int64()
        rc = self._lib.brt_stream_write(self._id, _req_ptr(data),
                                        len(data), ctypes.byref(stall))
        if obs.enabled():
            obs.counter("stream_writes").add(1)
            obs.counter("stream_bytes_out").add(len(data))
            if stall.value > self._STALL_FLOOR_US:
                obs.counter("stream_stall_ms").add(stall.value / 1000.0)
        if rc != 0:
            raise RpcError(rc, f"stream write to {self.peer} failed")

    def writev(self, frames) -> int:
        """Batched ordered write: N framed messages in ONE native
        crossing, each frame's payload borrowed, not copied — bytes
        frames are pinned until the socket write drains them, and
        :class:`IOBuf` frames ride their own block refcounts.  Returns
        the number of frames written.  On failure raises
        :class:`RpcError` with ``e.frames_written`` set — frames before
        it are on the wire, frames from it on are NOT (the caller's
        retry queue still holds them)."""
        if self._closed:
            raise RpcError(22, f"stream to {self.peer} is closed")
        frames = list(frames)
        if not frames:
            return 0
        if _race.enabled():
            _race.note_blocking("brt_stream_writev")
        temps = []
        handles = []
        total = 0
        try:
            for f in frames:
                if isinstance(f, IOBuf):
                    handles.append(f._require())
                    total += len(f)
                else:
                    io = IOBuf()
                    io.append_pinned(f)
                    temps.append(io)
                    handles.append(io._require())
                    total += len(f)
            arr = (ctypes.c_void_p * len(handles))(*handles)
            nw = ctypes.c_int()
            stall = ctypes.c_int64()
            rc = self._lib.brt_stream_writev(
                self._id, arr, len(handles), ctypes.byref(nw),
                ctypes.byref(stall))
        finally:
            for io in temps:
                io.close()
        if obs.enabled():
            obs.counter("stream_writes").add(nw.value)
            obs.counter("stream_bytes_out").add(total)
            if stall.value > self._STALL_FLOOR_US:
                obs.counter("stream_stall_ms").add(stall.value / 1000.0)
        if rc != 0:
            e = RpcError(rc, f"stream writev to {self.peer} failed at "
                             f"frame {nw.value}/{len(handles)}")
            e.frames_written = nw.value
            raise e
        return nw.value

    def close(self) -> None:
        """Graceful close: flushes in-flight frames, then tells the peer.
        Idempotent; pair with :meth:`join` to wait for full application."""
        if not self._closed:
            self._closed = True
            if self._track:
                _handles.note_destroy("stream", self._id)
            self._lib.brt_stream_close(self._id)

    def join(self, timeout_s: Optional[float] = None) -> bool:
        """True once BOTH sides closed — every written frame was
        delivered, consumed, and the peer answered CLOSE.  Call after
        :meth:`close`; ``timeout_s=None`` waits forever."""
        if _race.enabled():
            _race.note_blocking("brt_stream_join")
        us = -1 if timeout_s is None else max(0, int(timeout_s * 1e6))
        return self._lib.brt_stream_join(self._id, us) == 0

    def abort(self) -> None:
        """Abrupt local teardown (reconnect/error paths): wakes any
        writer/joiner, frees native state, sends nothing.  Idempotent."""
        if not self._closed:
            self._closed = True
            if self._track:
                _handles.note_destroy("stream", self._id)
        self._lib.brt_stream_abort(self._id)


class PsShard:
    """Native generation-versioned PS shard (cpp/capi/ps_shard.cc): serves
    ``Lookup`` entirely inside the C++ fiber handler once attached to a
    server via :meth:`Server.add_ps_service`.

    The caller owns the WRITE path: it keeps the mutable table (numpy),
    applies gradients, then publishes an immutable snapshot with
    :meth:`install` — readers pin a generation, gather outside any lock,
    and the last reader frees a retired snapshot (the handle-generation
    scheme of the device shard, moved into the native core)."""

    __slots__ = ("_lib", "_ptr", "rows_per", "dim")

    def __init__(self, vocab: int, dim: int, shard_index: int,
                 num_shards: int):
        self._lib = _load()
        self._ptr = self._lib.brt_ps_shard_new(vocab, dim, shard_index,
                                               num_shards)
        if not self._ptr:
            raise ValueError(
                f"bad shard geometry: vocab={vocab} dim={dim} "
                f"shard={shard_index}/{num_shards}")
        self.rows_per = vocab // num_shards
        self.dim = dim

    def install(self, table, gen: int) -> None:
        """Publishes ``table`` ([rows_per, dim] float32) as generation
        ``gen``.  The native side snapshots the buffer before returning,
        so the caller may keep mutating its array."""
        import numpy as np
        arr = np.ascontiguousarray(table, dtype=np.float32)
        if arr.shape != (self.rows_per, self.dim):
            raise ValueError(f"table shape {arr.shape} != "
                             f"({self.rows_per}, {self.dim})")
        rc = self._lib.brt_ps_shard_install(self._ptr, arr.ctypes.data,
                                            self.rows_per, gen)
        if rc != 0:
            raise RpcError(rc, "ps shard install failed")

    @property
    def generation(self) -> int:
        return self._lib.brt_ps_shard_generation(self._ptr)

    @property
    def native_lookups(self) -> int:
        """Lookups served with zero Python in the loop."""
        return self._lib.brt_ps_shard_native_lookups(self._ptr)

    def lookup_stats(self) -> "tuple[int, int]":
        """``(sum_us, count)`` of native Lookup service times — the
        zero-Python read path never touches the server's Python latency
        recorder, so its tail stats are reconstructed from this pair."""
        sum_us = ctypes.c_int64(0)
        count = ctypes.c_int64(0)
        self._lib.brt_ps_shard_lookup_stats(
            self._ptr, ctypes.byref(sum_us), ctypes.byref(count))
        return sum_us.value, count.value

    def close(self) -> None:
        """Destroy the shard.  Servers it is attached to MUST already be
        closed (their handlers gather from this shard's snapshots)."""
        if self._ptr is not None:
            ptr, self._ptr = self._ptr, None
            self._lib.brt_ps_shard_destroy(ptr)


class Channel:
    """Client channel. addr: "ip:port" single-server, or a cluster url
    ("list://h1,h2", "file://path", "dns://host:port") + lb name."""

    def __init__(self, addr: str, lb: Optional[str] = None,
                 timeout_ms: int = 1000, max_retry: int = 3):
        self._lib = _load()
        self._addr = addr
        self._ptr = self._lib.brt_channel_new(
            addr.encode(), lb.encode() if lb else None, timeout_ms,
            max_retry)
        if not self._ptr:
            raise RuntimeError(f"channel init failed for {addr}")

    def call(self, service: str, method: str, request: bytes = b"", *,
             timeout_ms: Optional[int] = None,
             retry: "Optional[resilience.RetryPolicy]" = None,
             deadline_ms: Optional[float] = None,
             backup_ms: Optional[float] = None,
             breaker: "Optional[resilience.CircuitBreaker]" = None
             ) -> bytes:
        """Synchronous call.  The keyword-only resilience options layer
        policy over the bare native call (brpc_tpu_torch.resilience):

        - ``timeout_ms`` — per-call deadline override (reference
          ``Controller::set_timeout_ms``).
        - ``retry`` / ``deadline_ms`` — RetryPolicy attempts under a
          total deadline budget; each attempt's native timeout is the
          budget still remaining.
        - ``backup_ms`` — hedge: a second attempt fires if no reply in
          N ms, first completion wins, loser is cancelled natively.
        - ``breaker`` — per-endpoint CircuitBreaker: fail fast while
          open, feed every outcome.
        """
        if retry is not None or deadline_ms is not None \
                or backup_ms is not None or breaker is not None:
            return resilience.resilient_call(
                self, service, method, request, retry=retry,
                deadline_ms=deadline_ms, backup_ms=backup_ms,
                breaker=breaker, timeout_ms=timeout_ms)
        if timeout_ms is not None:
            return self.call_async(service, method, request,
                                   timeout_ms=timeout_ms).join()
        rec = obs.enabled()
        if rec:
            t0 = time.monotonic_ns()
            wall = time.time()
        if fault.active():
            fault.client_intercept(service, method, self._addr)
        if _race.enabled():
            _race.note_blocking("brt_channel_call")
        if isinstance(request, IOBuf) and not request.force_iobuf \
                and len(request) < IOBUF_MIN_BYTES:
            # Below the crossover the handle-lifecycle tax outweighs
            # the saved copy: route through the bytes twin (identical
            # wire bytes; the caller still closes its handle, and the
            # response comes back as plain bytes).
            request = request.tobytes()
        if isinstance(request, IOBuf):
            # Zero-copy currency: the request's blocks are shared into
            # the native call (no payload copy; the caller's handle keeps
            # its contents for retries) and the reply comes back as an
            # IOBuf whose blocks were swapped out of the response.
            err = ctypes.c_int()
            errbuf = ctypes.create_string_buffer(256)
            h = self._lib.brt_channel_call_iobuf(
                self._ptr, service.encode(), method.encode(),
                request._require(), ctypes.byref(err), errbuf, 256)
            if not h:
                text = errbuf.value.decode(errors="replace")
                if rec:
                    _record_client_call(service, method, self._addr, t0,
                                        wall, len(request), 0, err.value,
                                        text)
                raise RpcError(err.value or -1, text)
            out = IOBuf._adopt(self._lib, h)
            if rec:
                _record_client_call(service, method, self._addr, t0, wall,
                                    len(request), len(out), 0, "")
            return out
        rsp = ctypes.c_void_p()
        rsp_len = ctypes.c_size_t()
        errbuf = ctypes.create_string_buffer(256)
        rc = self._lib.brt_channel_call(
            self._ptr, service.encode(), method.encode(),
            _req_ptr(request), len(request), ctypes.byref(rsp),
            ctypes.byref(rsp_len), errbuf, 256)
        if rc != 0:
            text = errbuf.value.decode(errors="replace")
            if rec:
                _record_client_call(service, method, self._addr, t0, wall,
                                    len(request), 0, rc, text)
            raise RpcError(rc, text)
        try:
            out = ctypes.string_at(rsp, rsp_len.value)
        finally:
            self._lib.brt_free(rsp)
        if rec:
            _record_client_call(service, method, self._addr, t0, wall,
                                len(request), len(out), 0, "")
            obs.counter("rpc_bytes_copied").add(len(out))
        return out

    def call_async(self, service: str, method: str, request: bytes = b"",
                   *, timeout_ms: Optional[int] = None,
                   tag: Optional[str] = None) -> PendingCall:
        """Starts the call and returns immediately with a
        :class:`PendingCall`; the RPC proceeds on the fiber scheduler and
        ``join()`` collects the reply.  Starting N calls before joining
        any fans out over N servers concurrently — whole-batch latency is
        max(server) instead of sum(server) (the ParallelChannel shape,
        cpp/cluster/parallel_channel.*).  The request bytes are copied by
        the native core before this returns.  ``timeout_ms`` overrides
        the channel deadline for this one call (the retry loop's
        shrinking budget rides this); ``tag`` annotates the client rpcz
        span (attempt/hedge labels)."""
        rec = obs.enabled()
        t0 = time.monotonic_ns() if rec else None
        wall = time.time() if rec else 0.0
        if fault.active():
            fault.client_intercept(service, method, self._addr, timeout_ms)
        if isinstance(request, IOBuf) and not request.force_iobuf \
                and len(request) < IOBUF_MIN_BYTES:
            # Same bytes-twin routing as the sync call: sub-crossover
            # payloads skip the handle tax (join() then returns bytes).
            request = request.tobytes()
        if isinstance(request, IOBuf):
            ptr = self._lib.brt_channel_call_start_iobuf(
                self._ptr, service.encode(), method.encode(),
                request._require(),
                _INT64_MIN if timeout_ms is None else int(timeout_ms))
            if not ptr:
                raise RpcError(-1, f"call_start failed for {self._addr}")
            return PendingCall(self._lib, ptr, service, method, self._addr,
                               len(request), t0, wall, tag, iobuf=True)
        ptr = self._lib.brt_channel_call_start_opts(
            self._ptr, service.encode(), method.encode(),
            _req_ptr(request), len(request),
            _INT64_MIN if timeout_ms is None else int(timeout_ms))
        if not ptr:
            raise RpcError(-1, f"call_start failed for {self._addr}")
        return PendingCall(self._lib, ptr, service, method, self._addr,
                           len(request), t0, wall, tag)

    def stream(self, service: str, method: str, request: bytes = b"", *,
               max_buf_size: int = 0, receiver=None) -> Stream:
        """Creates an ordered flow-controlled byte-frame stream bound to
        this channel's connection by running ``service``.``method``
        synchronously — the server's handler must ``accept`` the stream
        (see :meth:`Server.add_stream_handler`); its response comes back
        on ``Stream.response``.  ``max_buf_size`` bounds the unconsumed
        bytes in flight (0 = the native 2MB default): writers park beyond
        it until the receiver's consumed-bytes feedback returns credit.
        Raises :class:`RpcError` when the setup RPC fails or the server
        never accepted — nothing is left behind either way.

        ``receiver`` (an object with ``on_data(bytes)``/``on_closed()``)
        attaches a READ side: frames the server writes on its accepted
        half deliver to it, serialized, with a final ``on_closed`` after
        the server closes — the server→client direction (replica acks,
        catch-up data).  Frames the server wrote before this call
        returned are buffered and delivered first, possibly on the
        calling thread.  ``close()`` is a FULL close, not a half-close:
        peer frames arriving after it are discarded, so collect what you
        expect before closing.  An rx stream must be torn down with
        ``close()`` (``abort()`` would strand the native relay — the
        closed callback is what frees it)."""
        rec = obs.enabled()
        if rec:
            t0 = time.monotonic_ns()
            wall = time.time()
        if fault.active():
            fault.client_intercept(service, method, self._addr)
        if _race.enabled():
            _race.note_blocking("brt_stream_create")
        sid = ctypes.c_uint64()
        rsp = ctypes.c_void_p()
        rsp_len = ctypes.c_size_t()
        errbuf = ctypes.create_string_buffer(256)
        if receiver is not None:
            rc = self._lib.brt_stream_create_rx(
                self._ptr, service.encode(), method.encode(),
                _req_ptr(request), len(request), max_buf_size,
                _stream_dispatch, None, ctypes.byref(sid),
                ctypes.byref(rsp), ctypes.byref(rsp_len), errbuf, 256)
        else:
            rc = self._lib.brt_stream_create(
                self._ptr, service.encode(), method.encode(),
                _req_ptr(request), len(request), max_buf_size,
                ctypes.byref(sid), ctypes.byref(rsp), ctypes.byref(rsp_len),
                errbuf, 256)
        if rc != 0:
            text = errbuf.value.decode(errors="replace")
            if rec:
                _record_client_call(service, method, self._addr, t0, wall,
                                    len(request), 0, rc, text,
                                    tag="stream")
            raise RpcError(rc, text)
        try:
            out = ctypes.string_at(rsp, rsp_len.value)
        finally:
            self._lib.brt_free(rsp)
        if rec:
            obs.counter("stream_creates").add(1)
            _record_client_call(service, method, self._addr, t0, wall,
                                len(request), len(out), 0, "",
                                tag="stream")
        _handles.note_create("stream", sid.value)
        if receiver is not None:
            # Registration drains any frames the server raced ahead of
            # this return (ordered handoff — see _register_stream_receiver).
            _register_stream_receiver(sid.value, receiver)
        return Stream(self._lib, sid.value, out, service, method,
                      self._addr)

    def close(self) -> None:
        if self._ptr:
            self._lib.brt_channel_destroy(self._ptr)
            self._ptr = None


# The device fabric is PyTorch's (``brpc_tpu_torch/device.py``), under the
# names the reference's native client has, so ``rpc.DeviceClient()`` in
# ``ps_remote`` reaches it unchanged.
from brpc_tpu_torch.device import DeviceClient, DeviceExecutable  # noqa: E402,F401
