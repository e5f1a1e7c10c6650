"""The port's linter (``brpc_tpu_torch.analysis.lint``): its gate over the
port's tree, and its findings beside the reference's on the same fixtures.

- The gate, twin of ``tests/test_lint_clean.py``: ``brpc_tpu_torch/`` lints
  clean against ``tests/torch_lint_baseline.json`` (empty), every check ran
  against the real surface, and a seeded violation flips the gate. The
  reference's linter, run over the port's tree, finds nothing either.
- Parity on the lint half of ``tests/test_analysis.py`` (its tests before
  ``_lint_exc_fixture``): each reference test runs as written, with every
  lint of its fixture tree going through both linters. The port lints a
  mirror of the tree in which ``brpc_tpu`` is ``brpc_tpu_torch`` and the
  JAX tracers (``jax.jit``, ``shard_map``) are torch's (``torch.compile``,
  ``torch.jit.script``); both must give the same findings (check, file,
  line and message, with the package and the tracers' names mapped), and
  the reference test's own assertions then run on the port's findings.
  Its CLI tests run against the port's CLI. The two host-callback tests
  have no twin: torch has no host callbacks, and the port's linter
  dropped that hazard class (a test below shows it stays silent there).
- The port's trace-purity roots: ``torch.compile``, ``torch.jit.script``
  and ``torch.jit.trace``, ``torch.cuda.make_graphed_callables`` (as
  decorators, through ``partial`` and as calls) and the body of a
  ``with torch.cuda.graph(...)`` capture; ``re.compile``, the builtin
  ``compile`` and ``jax.jit`` are not roots.
- The CLI (``python -m brpc_tpu_torch.analysis --baseline
  tests/torch_lint_baseline.json``) exits 0 on the port, 1 with a seeded
  violation of each of the fourteen checks, 2 on an unknown check.
"""

import ast
import dataclasses
import os
import re
import shutil
import subprocess
import sys
import textwrap
import types

import pytest

import test_analysis as ref_tests
from brpc_tpu.analysis import lint as ref_lint
from brpc_tpu_torch import wire
from brpc_tpu_torch.analysis import fuzz, lint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "brpc_tpu_torch")
BASELINE = os.path.join(ROOT, "tests", "torch_lint_baseline.json")


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree_findings():
    """Both linters over the port's whole tree, every check, once."""
    return (lint.run_lint([PKG], checks=list(lint.ALL_CHECKS)),
            ref_lint.run_lint([PKG], checks=list(ref_lint.ALL_CHECKS)))


def test_package_lint_clean_vs_baseline(tree_findings):
    baseline_ids = lint.load_baseline(BASELINE)
    assert baseline_ids == set()
    new, suppressed = lint.apply_baseline(tree_findings[0], baseline_ids)
    assert not new, (
        "brpc_tpu_torch/ must lint clean against "
        "tests/torch_lint_baseline.json (python -m brpc_tpu_torch.analysis "
        "--baseline tests/torch_lint_baseline.json); new findings:\n"
        + "\n".join(f.format() for f in new))
    stale = baseline_ids - {f.id for f in suppressed}
    assert not stale, f"baseline ids no longer firing, regenerate: {stale}"


def test_every_check_ran_against_real_surface(tree_findings, tmp_path):
    """The gate sees its subject matter: the tree declares brt_ symbols
    (the port's core and its three CUDA libraries), registers handlers,
    imports obs, creates checked locks, and its wire registry has native
    twins; a seeded violation in a tree of the same layout flips it."""
    assert tree_findings[0] == []
    text = {p: open(p, encoding="utf-8").read()
            for p in lint._iter_py_files([PKG])}
    joined = "\n".join(text.values())
    for needle in (".argtypes =", "add_service(", "from brpc_tpu_torch "
                   "import obs", "checked_lock(", "lib.brt_add_f32.argtypes",
                   "lib.brt_gather_rows_f32.argtypes",
                   "lib.brt_flash_attention_bf16.argtypes"):
        assert needle in joined, needle
    assert any(s.native_sites for s in wire.REGISTRY.values())
    (tmp_path / "bad.py").write_text(textwrap.dedent("""\
        class H:
            def __init__(self, srv):
                srv.add_service("X", self._h)
            def _h(self, m, r):
                self.state = r
    """))
    assert lint.run_lint([str(tmp_path)]) != []


def test_reference_linter_finds_nothing_in_the_port(tree_findings):
    assert tree_findings[1] == []


def test_port_trace_purity_has_no_root_in_the_tree():
    """The port has no traced function today: no torch tracer wraps any of
    its code, so trace-purity has nothing to walk (the fixtures below show
    that it fires when one does)."""
    roots = [fn for p in lint._iter_py_files([PKG])
             for fn in lint._traced_functions(
                 ast.parse(open(p, encoding="utf-8").read()))]
    assert roots == []


def test_finding_id_anchors_on_the_port_package():
    a = lint.Finding("ctypes-contract", "/x/brpc_tpu_torch/ops/k.py", 3, "m")
    b = lint.Finding("ctypes-contract", "/y/z/brpc_tpu_torch/ops/k.py", 9,
                     "m")
    c = lint.Finding("ctypes-contract", "/x/brpc_tpu/ops/k.py", 3, "m")
    assert lint._stable_path(a.path) == "brpc_tpu_torch/ops/k.py"
    assert lint._stable_path("/r/cpp/capi/c_api.cc") == "cpp/capi/c_api.cc"
    assert a.id == b.id != c.id
    # the reference anchors on brpc_tpu/ and gives a port file its basename
    assert ref_lint._stable_path(a.path) == "k.py"


# ---------------------------------------------------------------------------
# parity on the reference's fixtures
# ---------------------------------------------------------------------------

#: the port's name for what traces a function (the reference says
#: "jax.jit/shard_map")
_PORT_TRACERS = lint._TRACED_BY


def _to_port_source(src: str) -> str:
    """A fixture as the port's code would say it, line for line."""
    src = src.replace("from brpc_tpu._compat import shard_map",
                      "import torch")
    src = re.sub(r"\bshard_map\b", "torch.jit.script", src)
    src = src.replace("jax.jit", "torch.compile")
    return re.sub(r"\bbrpc_tpu\b", "brpc_tpu_torch", src)


def _to_port_path(path: str) -> str:
    return re.sub(r"(^|/)brpc_tpu(?=/|$)", r"\1brpc_tpu_torch", path)


class _Twin(types.SimpleNamespace):
    """Stands in for the reference's ``lint`` module inside a reference
    test. Each lint of the fixture tree under ``ref`` also lints its mirror
    under ``port``; the findings must agree, and the port's come back
    (with the reference tree's paths, so the test's own checks apply)."""

    def __init__(self, ref: str, port: str):
        super().__init__(ALL_CHECKS=lint.ALL_CHECKS, Finding=lint.Finding,
                         apply_baseline=lint.apply_baseline,
                         load_baseline=lint.load_baseline, ref=ref,
                         port=port, calls=0)

    def _mirror(self) -> None:
        shutil.rmtree(self.port, ignore_errors=True)
        for dirpath, _, files in os.walk(self.ref):
            rel = _to_port_path(os.path.relpath(dirpath, self.ref))
            os.makedirs(os.path.join(self.port, rel), exist_ok=True)
            for f in files:
                with open(os.path.join(dirpath, f), encoding="utf-8") as fh:
                    text = fh.read()
                with open(os.path.join(self.port, rel, f), "w",
                          encoding="utf-8") as fh:
                    fh.write(_to_port_source(text))

    def _port_of(self, path: str) -> str:
        rel = os.path.relpath(path, self.ref)
        return os.path.normpath(os.path.join(self.port, _to_port_path(rel)))

    def _key(self, f, root: str, port: bool):
        msg = f.message.replace(root, "<root>")
        rel = os.path.relpath(f.path, root)
        if not port:
            msg = re.sub(r"\bbrpc_tpu\b", "brpc_tpu_torch", msg).replace(
                "jax.jit/shard_map", _PORT_TRACERS)
            rel = _to_port_path(rel)
        return f.check, rel, f.line, msg

    def _both(self, ref_fn, port_fn, paths, checks):
        self.calls += 1
        self._mirror()
        try:
            theirs = ref_fn(paths, checks)
        except ValueError as e:
            with pytest.raises(ValueError) as ours:
                port_fn([self._port_of(p) for p in paths], checks)
            assert str(ours.value) == str(e)
            raise ours.value
        ours = port_fn([self._port_of(p) for p in paths], checks)
        assert sorted(self._key(f, self.port, True) for f in ours) == \
            sorted(self._key(f, self.ref, False) for f in theirs)
        back = {self._port_of(f.path): f.path for f in theirs}
        return [dataclasses.replace(f, path=back[f.path]) for f in ours]

    def lint_files(self, files, checks=None):
        return self._both(ref_lint.lint_files, lint.lint_files,
                          [str(p) for p in files], checks)

    def run_lint(self, paths, checks=None):
        return self._both(ref_lint.run_lint, lint.run_lint,
                          [str(p) for p in paths], checks)


def _port_cli(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = cwd + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "brpc_tpu_torch.analysis"] + args,
        capture_output=True, text=True, env=env, cwd=cwd)


_LINT_HALF_END = ref_tests._lint_exc_fixture.__code__.co_firstlineno
_NO_TWIN = {"test_host_callback_flagged_and_pragma_allowlists",
            "test_host_callback_transitive_chain"}
_LINT_HALF = sorted(
    name for name, fn in vars(ref_tests).items()
    if name.startswith("test_") and isinstance(fn, types.FunctionType)
    and fn.__code__.co_firstlineno < _LINT_HALF_END and name not in _NO_TWIN)


def test_lint_half_is_the_reference_set():
    assert len(_LINT_HALF) + len(_NO_TWIN) == 77


@pytest.mark.parametrize("name", _LINT_HALF)
def test_reference_lint_fixture_on_port(name, tmp_path, monkeypatch):
    fn = getattr(ref_tests, name)
    if "_run_cli" in fn.__code__.co_names:
        monkeypatch.setattr(ref_tests, "lint", lint)
        monkeypatch.setattr(ref_tests, "_run_cli", _port_cli)
        fn(tmp_path)
        return
    twin = _Twin(str(tmp_path / "ref"), str(tmp_path / "port"))
    os.makedirs(twin.ref)
    monkeypatch.setattr(ref_tests, "lint", twin)
    if fn.__code__.co_argcount:
        fn(tmp_path / "ref")
    else:
        fn()
    # every test but the baseline split lints a fixture tree
    assert twin.calls or name == "test_apply_baseline_split"


def test_host_callbacks_are_not_a_hazard_class_of_the_port(tmp_path):
    """The reference flags ``jax.debug.print``/``pure_callback``/
    ``io_callback`` under trace; torch has no host callbacks, so the port's
    trace-purity says nothing of such calls."""
    (tmp_path / "m.py").write_text(textwrap.dedent("""\
        import torch

        @torch.compile
        def noisy(x):
            jax.debug.print("x={}", x)
            return jax.pure_callback(lambda v: v, x, x)
    """))
    assert lint.run_lint([str(tmp_path)], checks=["trace-purity"]) == []
    assert not hasattr(lint, "_host_callback_desc")


# ---------------------------------------------------------------------------
# the port's trace-purity roots
# ---------------------------------------------------------------------------

_ROOT_FORMS = {
    "decorator": ("@torch.compile\ndef step(x):\n", "step"),
    "decorator_call": ("@torch.compile(mode='reduce-overhead')\n"
                       "def step(x):\n", "step"),
    "partial": ("@partial(torch.compile, fullgraph=True)\n"
                "def step(x):\n", "step"),
    "jit_script": ("@torch.jit.script\ndef step(x):\n", "step"),
    "jit_alias": ("@jit.script\ndef step(x):\n", "step"),
    "call": ("def step(x):\n", "step", "run = torch.compile(step)\n"),
    "jit_trace": ("def step(x):\n", "step",
                  "run = torch.jit.trace(step, (1,))\n"),
    "graphed": ("def step(x):\n", "step",
                "run = torch.cuda.make_graphed_callables((other, step), "
                "((1,), (1,)))\n"),
}


@pytest.mark.parametrize("form", sorted(_ROOT_FORMS))
def test_torch_tracer_roots_flag_impure_chain(form, tmp_path):
    head, root, *tail = _ROOT_FORMS[form]
    src = ("import time\nimport torch\nfrom functools import partial\n"
           "from torch import jit\n\n"
           "def other(x):\n    return x\n\n"
           "def helper(x):\n    return x + time.time()\n\n"
           + head + "    return helper(x)\n\n" + "".join(tail))
    (tmp_path / "m.py").write_text(src)
    (f,) = lint.run_lint([str(tmp_path)], checks=["trace-purity"])
    assert f.line == 10 and "time.time" in f.message
    assert f"{root} -> helper" in f.message


def test_cuda_graph_capture_body_is_traced(tmp_path):
    (tmp_path / "m.py").write_text(textwrap.dedent("""\
        import torch
        from brpc_tpu_torch import obs

        def helper(x):
            obs.counter("steps").add(1)
            return x

        def capture(g, x):
            with torch.cuda.graph(g):
                y = helper(x)
                print(y)
            print("after the capture: not traced")
    """))
    chain, direct = sorted(lint.run_lint([str(tmp_path)],
                                         checks=["trace-purity"]),
                           key=lambda f: f.line)
    assert chain.line == 5 and "<capture> -> helper" in chain.message
    assert direct.line == 11 and "inside '<capture>' which is traced by " \
        f"{_PORT_TRACERS}" in direct.message


def test_non_tracers_are_not_roots(tmp_path):
    (tmp_path / "m.py").write_text(textwrap.dedent("""\
        import re
        import jax

        def step(x):
            print(x)
            return x

        PAT = re.compile(step)
        CODE = compile(step, "f", "exec")
        RUN = jax.jit(step)
    """))
    assert lint.run_lint([str(tmp_path)], checks=["trace-purity"]) == []


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_gate_exits_zero_on_the_port():
    proc = _port_cli(["--baseline", BASELINE], cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean: no findings" in proc.stderr


_RPC_APP = """\
    def fire_and_forget(ch):
        ch.call_async("Ps", "ApplyGrad", b"x")
"""

#: a seeded violation of each Python check: files of a fixture tree
_SEEDED = {
    "ctypes-contract": {"m.py": "lib.brt_bad(1)\n"},
    "fiber-shared-state": {"m.py": """\
        class H:
            def __init__(self, srv):
                srv.add_service("X", self._h)
            def _h(self, m, r):
                self.state = r
    """},
    "obs-guard": {"m.py": """\
        from brpc_tpu_torch import obs
        a = obs.Adder()
    """},
    "trace-purity": {"m.py": """\
        import torch

        @torch.compile
        def step(x):
            print(x)
            return x
    """},
    "lock-order": {"m.py": ref_tests._LOCK_FIXTURE},
    "fiber-blocking-sleep": {"m.py": ref_tests._SLEEP_HANDLER},
    "handle-lifecycle": {"rpc.py": ref_tests._RPC_STUB, "app.py": _RPC_APP},
    "exception-flow": {"rpc.py": ref_tests._RPC_STUB,
                       "app.py": ref_tests._IMPLICIT_THROW_FIXTURE},
    "lock-exception-safety": {"m.py": ref_tests._LOCK_MANUAL_FIXTURE},
    "wire-contract": {"m.py": """\
        import struct
        HDR = struct.Struct("qqi")
    """},
}

_HANDLE_LEAK_CC = """\
    #include "x.h"
    void* leaky_new() {
      brt_capi::handle_inc(brt_capi::HandleKind::kServer);
      if (!init()) {
        return nullptr;
      }
      return ptr;
    }
"""


def _seed_native(check, tmp_path, monkeypatch):
    """A seeded violation of a cross-language check: the port's tree with
    one of its contracts broken (a stale native site, no sanctioned codes,
    no fuzz coverage), or a package-shaped tree whose C++ leaks a ledger
    count on an error path."""
    if check == "wire-contract-native":
        sch = wire.FrameSchema(name="stale_req",
                               fields=(wire.Int("count", "<i"),),
                               native_sites=("cpp/capi/ps_shard.cc:Gone",))
        monkeypatch.setitem(wire.REGISTRY, "stale_req", sch)
    elif check == "native-errors":
        monkeypatch.setattr(fuzz, "SANCTIONED_LIVE_CODES", frozenset())
    elif check == "native-endian":
        monkeypatch.setattr(fuzz, "coverage_map", lambda: {})
    else:
        pkg = tmp_path / "brpc_tpu_torch"
        pkg.mkdir()
        (pkg / "__init__.py").write_text("")
        (tmp_path / "cpp" / "capi").mkdir(parents=True)
        (tmp_path / "cpp" / "capi" / "fix.cc").write_text(
            textwrap.dedent(_HANDLE_LEAK_CC))
        return str(pkg)
    return os.path.join(PKG, "wire.py")


@pytest.mark.parametrize("check", list(lint.ALL_CHECKS))
def test_cli_seeded_violation_of_each_check_exits_one(check, tmp_path,
                                                       monkeypatch,
                                                       capsys):
    if check in _SEEDED:
        for name, src in _SEEDED[check].items():
            (tmp_path / name).write_text(_to_port_source(
                textwrap.dedent(src)))
        target = str(tmp_path)
    else:
        target = _seed_native(check, tmp_path, monkeypatch)
    args = ["--check", check, "--baseline", BASELINE, "--format=json"]
    assert lint.main(args + [target]) == 1
    out = capsys.readouterr().out
    assert f'"check": "{check}"' in out
    if check not in _SEEDED and check != "native-handle-balance":
        monkeypatch.undo()
        assert lint.main(args + [target]) == 0


def test_cli_unknown_check_exits_two(capsys):
    with pytest.raises(SystemExit) as exc:
        lint.main(["--check", "trace_purity", PKG])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert all(name in err for name in lint.ALL_CHECKS)
