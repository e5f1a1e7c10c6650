"""Build the CUDA sources under ``csrc/`` into shared libraries on first use.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``: ``nvcc`` for
``sm_90a`` with a plain C interface, loaded with ``ctypes``. The hash covers
the source, every header beside it (``csrc/*.cuh``) and the flags, so an
edited source or header is rebuilt and an unchanged one is reused.
``build()`` raises with the compiler's output if nvcc fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def sources() -> list[str]:
    """Names of the kernel sources, one library each."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.is_file():
        raise BuildError("nvcc not found on PATH, in $CUDA_HOME or "
                         "/usr/local/cuda; the CUDA kernels cannot be built")
    return str(path)


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile every named source (default: all) whose library is missing,
    one nvcc for each source, all started together.

    Returns the compiler's output (ptxas's registers, spills and shared
    memory of each kernel) by the name of each source it compiled. nvcc
    writes a temporary file that is renamed into place, so two processes
    building at once never load a half-written library.
    """
    names = sources() if names is None else names
    todo = [n for n in names if not library_path(n).is_file()]
    logs: dict[str, str] = {}
    if not todo:
        return logs
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (out, tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                          f"{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise BuildError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
