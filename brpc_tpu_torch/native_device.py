"""Build the port's PJRT plugin and the native programs that run on it.

The native core's device tier (``cpp/device/``: ``PjrtClient``, the
staging, ``PjrtExecutable``, and above it ``CollectiveChannel`` and the C
API's ``brt_device_*``) reaches a device only through a PJRT plugin. The
port's plugin lives in ``csrc/pjrt/`` (``plugin.h`` says how it is cut):

- ``build_plugin("cuda")``: the H100's, nvcc for sm_90a with the kernels'
  flags (``ops/_build.NVCC_FLAGS``) from ``plugin.cc``, ``cuda_backend.cu``
  and the kernels' sources ``csrc/embedding_rows.cu`` and
  ``csrc/device_programs.cu``;
- ``build_plugin("host")``: its plain version for tests on a CPU, g++ from
  ``plugin.cc`` and ``host_backend.cc``. Built only when a caller names it.

``build_program(path)`` builds a C++ program (a test or an example of
``cpp/``, or one of the port's under ``csrc/examples/``) with g++ against
the native core that ``rpc.py`` builds, with an rpath to it. Not cmake:
on the card, its build links libstdc++ statically and crashes
(``rpc._build_with_gxx``).

Everything goes under ``brpc_tpu_torch/_build/native_device/``, built at
first use into a temporary file renamed into place. Each file's name
carries a hash of the command's flags and of every file the build
compiles or includes (quoted ``#include``s followed through the source
directories and the include path), and for a program of the core's
library, so an edit anywhere in them builds anew.

The native test programs of ``cpp/tests/`` that open the reference's test
plugin by the name ``./libbrt_fake_pjrt.so`` run in a directory where that
name is a link to the port's plugin (``link_as_test_plugin``).
"""

from __future__ import annotations

import hashlib
import os
import re
import subprocess
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

from brpc_tpu_torch.ops import _build

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
CSRC = PKG / "csrc"
CPP = ROOT / "cpp"
BUILD_DIR = PKG / "_build" / "native_device"

# The sources of each plugin, relative to csrc/.
PLUGIN_SOURCES = {
    "cuda": ("pjrt/plugin.cc", "pjrt/cuda_backend.cu", "embedding_rows.cu",
             "device_programs.cu"),
    "host": ("pjrt/plugin.cc", "pjrt/host_backend.cc"),
}
HOST_FLAGS = ("-std=c++17", "-O2", "-g0", "-fPIC", "-shared",
              "-ffp-contract=off", "-pthread")
PROGRAM_FLAGS = ("-std=c++20", "-fcoroutines", "-include", "errno.h", "-O2",
                 "-g0", "-w", "-ffp-contract=off", "-pthread")
# The name the reference's native tests open their plugin by.
TEST_PLUGIN_NAME = "libbrt_fake_pjrt.so"

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


class BuildError(RuntimeError):
    """A compiler is missing or refused a source."""


def includes(sources: Iterable[Path],
             include_dirs: Sequence[Path]) -> List[Path]:
    """``sources`` and every file they reach through quoted ``#include``s,
    each looked up beside the including file, then in ``include_dirs``."""
    seen: dict = {}
    todo = [Path(s) for s in sources]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen[path] = True
        for name in _INCLUDE.findall(path.read_text(errors="replace")):
            for base in (path.parent, *include_dirs):
                found = (base / name).resolve()
                if found.is_file():
                    todo.append(found)
                    break
    return sorted(seen)


def _digest(files: Iterable[Path], flags: Sequence[str], roots: dict,
            extra: bytes = b"") -> str:
    """A hash of the flags and of each file's contents and name, the name
    taken under the first of ``roots`` (label: directory) that holds it."""
    named = {}
    for path in files:
        path, name = path.resolve(), path.name
        for label, root in roots.items():
            if path.is_relative_to(Path(root).resolve()):
                name = f"{label}/{path.relative_to(Path(root).resolve())}"
                break
        named[name] = path
    h = hashlib.sha256("\0".join(flags).encode())
    for name, path in sorted(named.items()):
        h.update(name.encode() + b"\0")
        h.update(path.read_bytes())
    h.update(extra)
    return h.hexdigest()[:16]


def _plugin_flags(kind: str) -> tuple:
    if kind == "cuda":
        return (*_build.NVCC_FLAGS, "-lpthread")
    if kind == "host":
        return HOST_FLAGS
    raise ValueError(f"no plugin {kind!r}: 'cuda' (the card's) or 'host' "
                     f"(its plain version, for CPU tests)")


def plugin_path(kind: str = "cuda", csrc: Path = CSRC,
                cpp: Path = CPP) -> Path:
    """Where ``build_plugin(kind)`` puts the plugin built from the sources
    under ``csrc`` and ``cpp`` (another tree's, for a test of the hash)."""
    flags = _plugin_flags(kind)
    sources = [csrc / s for s in PLUGIN_SOURCES[kind]]
    files = includes(sources, [cpp, csrc / "pjrt"])
    digest = _digest(files, flags, {"csrc": csrc, "cpp": cpp})
    return BUILD_DIR / f"libbrt_pjrt_{kind}-{digest}.so"


def _run(cmd: List[str], out: Path, what: str) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"{what} (exit {proc.returncode}):\n"
                         f"{proc.stdout[-4000:]}")
    os.replace(tmp, out)
    return proc.stdout


def build_plugin(kind: str = "cuda") -> Path:
    """The plugin's library, built first when missing. ``"cuda"`` is the
    card's (nvcc; raises ``BuildError`` without it); ``"host"`` is the
    plain version, and only a caller that names it gets it."""
    out = plugin_path(kind)
    if out.is_file():
        return out
    sources = [str(CSRC / s) for s in PLUGIN_SOURCES[kind]]
    include = ["-I", str(CPP), "-I", str(CSRC / "pjrt")]
    if kind == "cuda":
        try:
            compiler = _build._nvcc()
        except _build.BuildError as e:
            raise BuildError(str(e)) from e
    else:
        compiler = "g++"
    _run([compiler, *_plugin_flags(kind), *include, *sources], out,
         f"the {kind} plugin")
    return out


def core_library() -> Path:
    """The native core's library, built by ``rpc.py``'s loader first when
    missing."""
    from brpc_tpu_torch import rpc

    rpc._load()
    return Path(rpc._build_dir()) / "libbrpc_tpu_c.so"


def program_path(source: Path, core: Optional[Path] = None) -> Path:
    """Where ``build_program(source)`` puts the program."""
    source = Path(source).resolve()
    core = core_library() if core is None else core
    files = includes([source], [CPP])
    digest = _digest(files, PROGRAM_FLAGS, {"cpp": CPP, "repo": ROOT},
                     extra=hashlib.sha256(core.read_bytes()).digest())
    return BUILD_DIR / f"{source.stem}-{digest}"


def build_program(source) -> Path:
    """The program of the C++ file ``source``, built first when missing."""
    source = Path(source).resolve()
    core = core_library()
    out = program_path(source, core)
    if out.is_file():
        return out
    lib_dir = str(core.parent)
    _run(["g++", *PROGRAM_FLAGS, "-I", str(CPP), str(source), "-L", lib_dir,
          "-lbrpc_tpu_c", f"-Wl,-rpath,{lib_dir}", "-ldl", "-lpthread"],
         out, f"program {source.name}")
    return out


def link_as_test_plugin(plugin: Path, directory: Path) -> Path:
    """Makes ``directory/libbrt_fake_pjrt.so`` a link to ``plugin``, so that
    the reference's native tests, which open their plugin by that relative
    name, run on the port's plugin when started in ``directory``."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    link = directory / TEST_PLUGIN_NAME
    tmp = directory / f"{TEST_PLUGIN_NAME}.{os.getpid()}.tmp"
    tmp.unlink(missing_ok=True)
    tmp.symlink_to(Path(plugin).resolve())
    os.replace(tmp, link)
    return directory
