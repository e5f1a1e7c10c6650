"""The port stands alone: it imports neither ``jax`` nor ``brpc_tpu``.

A fresh interpreter imports every module of ``brpc_tpu_torch`` and
``chip_smoke`` and then finds neither package in ``sys.modules``; an AST
scan finds no import of either in the sources, the port's measurement
scripts (``fabric_routes.py``, ``tp_scaling.py``, ``f32_dense_gap.py``)
included. The port's
command-line tools (the linter, the fuzzer, the press harness), each run
in a fresh interpreter, load neither package.

The port's C++ sources stand alone too: its PJRT plugin
(``brpc_tpu_torch/csrc/pjrt/``) includes nothing of ``cpp/`` but the PJRT
C API's header (nothing of ``cpp/device/``), its native programs
(``brpc_tpu_torch/csrc/examples/``) only the native core's headers, and
the plugin's CUDA backend computes nothing on the host: each of its
programs is a launch through a kernel's C entry point.
"""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
_SOURCES = sorted((ROOT / "brpc_tpu_torch").rglob("*.py")) + [
    ROOT / name for name in ("chip_smoke.py", "fabric_routes.py",
                             "tp_scaling.py", "f32_dense_gap.py")]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import brpc_tpu_torch, chip_smoke
names = [m.name for m in pkgutil.walk_packages(brpc_tpu_torch.__path__,
                                               "brpc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "brpc_tpu"))
print(" ".join(names), "|", bad)
"""


_RUN_CLI = """
import runpy, sys
sys.argv = [sys.argv[1]] + sys.argv[2:]
try:
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "brpc_tpu"))
print("|", code, bad)
"""

_CLIS = {
    "lint": ["brpc_tpu_torch.analysis", "brpc_tpu_torch/wire.py"],
    "fuzz": ["brpc_tpu_torch.analysis.fuzz", "--seed", "0", "--iters", "2",
             "--no-memcheck"],
    "press": ["brpc_tpu_torch.press", "--record", "{tmp}/t.trace",
              "--duration", "0.1"],
}


@pytest.mark.parametrize("cli", sorted(_CLIS))
def test_cli_loads_neither_jax_nor_reference(cli, tmp_path):
    args = [a.format(tmp=tmp_path) for a in _CLIS[cli]]
    out = subprocess.run([sys.executable, "-c", _RUN_CLI] + args, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    code, bad = out.stdout.rsplit("|", 1)[1].split(" ", 2)[1:]
    assert code in ("0", "None") and bad.strip() == "[]", out.stdout


def _forbidden(name):
    return name.split(".")[0] in ("jax", "jaxlib", "brpc_tpu")


def test_imports_pull_in_neither_jax_nor_reference():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names, bad = out.stdout.split("|")
    assert {"brpc_tpu_torch.models.llama", "brpc_tpu_torch.ops._build",
            "brpc_tpu_torch.ops.flash_attention", "brpc_tpu_torch.optim",
            "brpc_tpu_torch.utils.checkpoint", "brpc_tpu_torch.device",
            "brpc_tpu_torch.ops.embedding_rows", "brpc_tpu_torch.rpc",
            "brpc_tpu_torch.ps_remote", "brpc_tpu_torch.durable",
            "brpc_tpu_torch.reshard", "brpc_tpu_torch.parallel.mesh",
            "brpc_tpu_torch.parallel.collective_channel",
            "brpc_tpu_torch.ps", "brpc_tpu_torch.rebalance",
            "brpc_tpu_torch.parallel.functional",
            "brpc_tpu_torch.parallel.tensor_parallel",
            "brpc_tpu_torch.parallel.ring", "brpc_tpu_torch.parallel.pipeline",
            "brpc_tpu_torch.models.moe", "brpc_tpu_torch.dryrun",
            "brpc_tpu_torch.press", "brpc_tpu_torch.analysis.callgraph",
            "brpc_tpu_torch.analysis.lint", "brpc_tpu_torch.analysis.fuzz",
            "brpc_tpu_torch.analysis.native",
            "brpc_tpu_torch.analysis.__main__",
            "brpc_tpu_torch.native_device"} \
        <= set(names.split())
    assert bad.strip() == "[]"


@pytest.mark.parametrize("path", _SOURCES, ids=lambda p: p.name)
def test_sources_import_neither_jax_nor_reference(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(_forbidden(n) for n in names), \
            f"{path.relative_to(ROOT)}:{node.lineno} imports {names}"


_PLUGIN = sorted((ROOT / "brpc_tpu_torch" / "csrc" / "pjrt").iterdir())
_PROGRAMS = sorted((ROOT / "brpc_tpu_torch" / "csrc" / "examples").iterdir())
_QUOTED = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


@pytest.mark.parametrize("path", _PLUGIN + _PROGRAMS, ids=lambda p: p.name)
def test_native_sources_include_only_the_core_and_pjrt_header(path):
    text = path.read_text()
    assert "brpc_tpu/" not in text.replace("brpc_tpu_torch/", "")
    for name in _QUOTED.findall(text):
        if path in _PLUGIN:
            # its own header, and of cpp/ only the PJRT C API
            assert name in ("plugin.h", "third_party/pjrt/pjrt_c_api.h"), \
                f"{path.name} includes {name}"
        else:
            found = ROOT / "cpp" / name
            assert found.is_file() and name.split("/")[0] in (
                "base", "cluster", "device", "fiber", "rpc", "var",
                "transport"), f"{path.name} includes {name}"
            assert "fake_pjrt" not in name


def _method_body(text, name):
    start = text.index(f"  std::string {name}(int d")
    end = text.find("\n  std::string ", start + 1)
    return text[start:end if end > 0 else len(text)]


def test_cuda_backend_has_no_host_compute_path():
    """Each program of the card's backend is one call of its kernel's C
    entry point, and the file holds none of the host backend's arithmetic
    or copies, nor a way to reach the host backend."""
    text = (ROOT / "brpc_tpu_torch" / "csrc" / "pjrt" /
            "cuda_backend.cu").read_text()
    entries = {"Add": "brt_add_f32", "ReduceSum": "brt_reduce_sum_f32",
               "GatherRows": "brt_gather_rows_f32",
               "ScatterSub": "brt_scatter_sub_f32",
               "AllReduce": "brt_all_reduce_sum_f32",
               "AllGather": "brt_all_gather_f32"}
    for method, entry in entries.items():
        body = _method_body(text, method)
        assert body.count(f"{entry}(") == 1, method
        assert "for (" not in body and "while" not in body, method
    for host_only in ("memcpy(", "memset(", "aligned_alloc", "malloc(",
                      "host_backend", "HostBackend", "std::thread",
                      "cudaLaunchHostFunc", "cudaMallocHost"):
        assert host_only not in text, host_only
