"""Run a reference test file, as written, against the port.

The host tier of the port (``rpc``, ``wire``, ``limiter``, ``obs``,
``resilience``, ``fault``, ``naming``, ``durable``, ``reshard``,
``rebalance``, ``ps_remote`` and the parts of ``analysis`` they reach) is a
copy of the reference's. Its twin suites hold it there: each reference test
file runs against the port in a subprocess, and every test function of the
file becomes one case of a twin module.

- The subprocess sees a mirror of the file and of ``tests/conftest.py`` in
  a directory of its own, with the package name ``brpc_tpu`` replaced by
  ``brpc_tpu_torch`` throughout (imports, and the names fixture trees give
  themselves). Nothing rebinds ``brpc_tpu`` in the test process: under
  ``pytest -n 6 --dist loadfile`` a worker runs the reference's own files
  in that process too.
- The file runs once, under ``pytest -p xdist -n 1``: a test that kills its
  process is recorded as failed and the rest of the file still runs, each
  test once. Every node's outcome and time are read from a ``--junitxml``
  file; pytest's own exit code must say that the run reached its end.
- A function's case passes when every node of it passed. A failing case
  carries the reference test's own failure text.
- Collection reads the functions' names from the file's AST and starts no
  subprocess (``twin_suite``); the run happens in a module-scoped fixture
  (``reference_runs``), on the first case of each file.

Run a twin module alone with ``JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_host_a.py -q``.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
PORT = "brpc_tpu_torch"
_REFERENCE_NAME = re.compile(r"\bbrpc_tpu\b")
# A whole reference file (its slowest, test_replication.py, takes ~15 s).
TIMEOUT_S = 600
# A test that hangs dumps every thread's stack after this many seconds.
FAULTHANDLER_S = 120


@dataclasses.dataclass
class Node:
    nodeid: str
    outcome: str  # "passed", "failed", "error" or "skipped"
    seconds: float
    text: str = ""


def reference_tests(ref_file: str) -> list:
    """The names of the test functions of ``tests/<ref_file>``, in order."""
    tree = ast.parse((TESTS / ref_file).read_text(encoding="utf-8"))
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n.name.startswith("test")]


def mirror(ref_file: str, dest: Path) -> Path:
    """Writes ``dest/tests/<ref_file>`` and its conftest with the package
    renamed; returns the mirrored file."""
    tests = dest / "tests"
    tests.mkdir(parents=True, exist_ok=True)
    for name in ("conftest.py", ref_file):
        text = (TESTS / name).read_text(encoding="utf-8")
        (tests / name).write_text(_REFERENCE_NAME.sub(PORT, text),
                                  encoding="utf-8")
    return tests / ref_file


def _environment() -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTEST_", "PYTHONPATH"))}
    env["PYTHONPATH"] = str(ROOT)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _nodes(xml: Path) -> list:
    nodes = []
    for case in ET.parse(xml).getroot().iter("testcase"):
        outcome, text = "passed", ""
        for child in case:
            if child.tag in ("failure", "error", "skipped"):
                outcome = {"failure": "failed"}.get(child.tag, child.tag)
                text = "\n".join(filter(None, (child.get("message"),
                                               child.text)))
                break
        nodes.append(Node(f"{case.get('classname')}::{case.get('name')}",
                          outcome, float(case.get("time") or 0.0), text))
    return nodes


def run_reference_file(ref_file: str, workdir: Path,
                       deselect=()) -> tuple:
    """Runs the mirror of ``tests/<ref_file>`` against the port, leaving out
    the functions named in ``deselect``. Returns ``(by_function, problem)``:
    each function's nodes, and what went wrong with the run as a whole
    (empty when pytest ran it to its end)."""
    path = mirror(ref_file, workdir)
    names = reference_tests(ref_file)
    for name in deselect:
        # --deselect takes node-id prefixes: no other name may start with
        # a deselected one.
        clash = [n for n in names if n != name and n.startswith(name)]
        assert not clash, f"deselecting {name} would drop {clash}"
    xml, log = workdir / "junit.xml", workdir / "pytest.log"
    rel = path.relative_to(workdir).as_posix()
    cmd = [sys.executable, "-m", "pytest", rel, "-q", "-m", "not slow",
           "-p", "no:cacheprovider", "-p", "no:randomly", "-p", "xdist",
           "-n", "1", "--rootdir", str(workdir), "--junitxml", str(xml),
           "-o", f"faulthandler_timeout={FAULTHANDLER_S}"]
    for name in deselect:
        cmd += ["--deselect", f"{rel}::{name}"]
    problem = ""
    with open(log, "w", encoding="utf-8") as out:
        try:
            rc = subprocess.run(cmd, cwd=workdir, env=_environment(),
                                stdout=out, stderr=subprocess.STDOUT,
                                timeout=TIMEOUT_S).returncode
        except subprocess.TimeoutExpired:
            rc = None
    if rc is None:
        problem = f"the run outlasted {TIMEOUT_S} s"
    elif rc not in (0, 1):
        problem = f"pytest exited {rc}"
    by_function = {name: [] for name in names}
    if xml.exists():
        for node in _nodes(xml):
            name = node.nodeid.split("::")[-1].split("[")[0]
            by_function.setdefault(name, []).append(node)
    elif not problem:
        problem = "pytest wrote no junit file"
    if problem:
        tail = log.read_text(encoding="utf-8", errors="replace")[-4000:]
        problem += f" ({' '.join(cmd)}); its output ends:\n{tail}"
    return by_function, problem


class ReferenceRuns:
    """Each reference file's run, made on first demand, once a module."""

    def __init__(self, factory):
        self._factory = factory
        self._runs = {}

    def get(self, ref_file: str, deselect) -> tuple:
        if ref_file not in self._runs:
            workdir = self._factory.mktemp(Path(ref_file).stem)
            self._runs[ref_file] = run_reference_file(ref_file, workdir,
                                                      deselect)
        return self._runs[ref_file]


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    return ReferenceRuns(tmp_path_factory)


def verdict(ref_file: str, name: str, nodes: list, problem: str) -> None:
    """Fails, or skips, the case of ``name`` unless all its nodes passed."""
    if not nodes:
        pytest.fail(f"{ref_file}::{name} has no recorded outcome. "
                    f"{problem}", pytrace=False)
    bad = [n for n in nodes if n.outcome in ("failed", "error")]
    if bad:
        pytest.fail("\n\n".join(
            f"{n.nodeid} {n.outcome} after {n.seconds:.3f} s:\n{n.text}"
            for n in bad), pytrace=False)
    skipped = [n for n in nodes if n.outcome == "skipped"]
    if skipped:
        pytest.skip("; ".join(f"{n.nodeid}: {n.text}" for n in skipped))


def twin_suite(ref_file: str, hand=None):
    """A test function with one case per test function of
    ``tests/<ref_file>``. ``hand`` maps the names of the functions that
    have a hand-written twin to it (a callable taking ``tmp_path``); those
    are left out of the subprocess and run in this process."""
    hand = dict(hand or {})
    names = reference_tests(ref_file)
    unknown = set(hand) - set(names)
    assert not unknown, f"{ref_file} has no test {sorted(unknown)}"

    @pytest.mark.parametrize("name", names)
    def test(name, reference_runs, tmp_path):
        if name in hand:
            hand[name](tmp_path)
            return
        by_function, problem = reference_runs.get(ref_file, tuple(hand))
        verdict(ref_file, name, by_function.get(name, []), problem)

    test.__name__ = Path(ref_file).stem
    test.__doc__ = f"The cases of tests/{ref_file}, run against the port."
    return test
