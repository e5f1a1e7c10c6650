"""The port stands alone: it imports neither ``jax`` nor ``brpc_tpu``.

A fresh interpreter imports every module of ``brpc_tpu_torch`` and
``chip_smoke`` and then finds neither package in ``sys.modules``; an AST
scan finds no import of either in the sources.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
_SOURCES = sorted((ROOT / "brpc_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]

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
            "brpc_tpu_torch.models.moe", "brpc_tpu_torch.dryrun"} \
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
