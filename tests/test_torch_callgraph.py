"""The port's call-graph resolver (``brpc_tpu_torch.analysis.callgraph``)
and the interprocedural lint passes built on it, beside the reference's.

- Twins of ``tests/test_callgraph.py``: cross-module edges, method
  resolution through self, partial targets, cycle tolerance, held-object,
  local and return-type inference, may-throw summaries, and seeded
  cross-module violations that a per-file pass misses but the call-graph
  pass reports with the full call chain. The traced root of the
  trace-purity fixture is ``torch.compile``, the port's tracer.
- Parity: both resolvers build the same nodes and the same edges (caller,
  callee, call line) over the whole ``brpc_tpu_torch/`` tree.
"""

import ast
import os
import textwrap

import pytest

from brpc_tpu.analysis import callgraph as ref_callgraph
from brpc_tpu_torch.analysis import lint
from brpc_tpu_torch.analysis.callgraph import (build_callgraph,
                                               module_name_for_path)

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "brpc_tpu_torch")


def _graph(tmp_path, **files):
    pairs = []
    for name, src in files.items():
        p = tmp_path / f"{name}.py"
        p.write_text(textwrap.dedent(src))
        pairs.append((str(p), ast.parse(textwrap.dedent(src))))
    return build_callgraph(pairs)


def _only_node(g, suffix):
    hits = [nid for nid in g.nodes if nid.endswith(suffix)]
    assert len(hits) == 1, (suffix, sorted(g.nodes))
    return hits[0]


def _callee_ids(g, node_id):
    return sorted({s.callee for s in g.callees(node_id)})


# ---- resolver: edges ----

def test_cross_module_edges_from_import_and_alias(tmp_path):
    g = _graph(
        tmp_path,
        helpers="""\
            def shared():
                pass
        """,
        a="""\
            from helpers import shared

            def caller():
                shared()
        """,
        b="""\
            import helpers

            def caller2():
                helpers.shared()
        """,
    )
    shared = _only_node(g, ":shared")
    assert _callee_ids(g, _only_node(g, ":caller")) == [shared]
    assert _callee_ids(g, _only_node(g, ":caller2")) == [shared]


def test_method_resolution_through_self_and_base(tmp_path):
    g = _graph(tmp_path, m="""\
        class Base:
            def inherited(self):
                pass

        class Impl(Base):
            def entry(self):
                self.helper()
                self.inherited()

            def helper(self):
                pass
    """)
    entry = _only_node(g, "Impl.entry")
    assert _callee_ids(g, entry) == sorted([
        _only_node(g, "Base.inherited"), _only_node(g, "Impl.helper")])


def test_constructor_edge_including_inherited_init(tmp_path):
    g = _graph(
        tmp_path,
        lib="""\
            class Base:
                def __init__(self):
                    pass

            class Widget(Base):
                pass
        """,
        use="""\
            from lib import Widget

            def make():
                return Widget()
        """,
    )
    assert _callee_ids(g, _only_node(g, ":make")) == \
        [_only_node(g, "Base.__init__")]


def test_partial_targets(tmp_path):
    g = _graph(tmp_path, m="""\
        from functools import partial

        def worker(a, b):
            pass

        bound = partial(worker, 1)

        def runner():
            h = partial(worker, 2)
            h(3)

        def direct():
            partial(worker, 4)(5)
    """)
    worker = _only_node(g, ":worker")
    assert worker in _callee_ids(g, _only_node(g, ":runner"))
    assert worker in _callee_ids(g, _only_node(g, ":direct"))
    # the module-level alias resolves for callers too
    assert g.modules[next(iter(g.modules))].partial_aliases["bound"] == worker


def test_nested_function_edges(tmp_path):
    g = _graph(tmp_path, m="""\
        def outer():
            def inner():
                leaf()
            inner()

        def leaf():
            pass
    """)
    outer = _only_node(g, ":outer")
    inner = _only_node(g, "outer.inner")
    assert inner in _callee_ids(g, outer)
    assert _only_node(g, ":leaf") in _callee_ids(g, inner)


def test_cycle_tolerance(tmp_path):
    g = _graph(tmp_path, m="""\
        def ping():
            pong()

        def pong():
            ping()
    """)
    ping = _only_node(g, ":ping")
    reach = g.reachable(ping)
    assert ping in reach and _only_node(g, ":pong") in reach
    assert len(reach) == 2  # terminated despite the cycle


def test_module_name_for_path(tmp_path):
    pkg = tmp_path / "pkg" / "sub"
    pkg.mkdir(parents=True)
    (tmp_path / "pkg" / "__init__.py").write_text("")
    (pkg / "__init__.py").write_text("")
    (pkg / "mod.py").write_text("")
    assert module_name_for_path(str(pkg / "mod.py")) == "pkg.sub.mod"
    assert module_name_for_path(str(pkg / "__init__.py")) == "pkg.sub"
    lone = tmp_path / "lone.py"
    lone.write_text("")
    assert module_name_for_path(str(lone)) == "lone"


# ---- attr-type map: calls on held objects (self.<attr> = Class(...)) ----

def test_held_object_method_edge_resolves(tmp_path):
    """An earlier deferral: ``self.dev.stage()`` used to be a skipped edge;
    the ``self.<attr> = Class(...)`` type map resolves it."""
    g = _graph(tmp_path, m="""\
        class Dev:
            def stage(self):
                pass

        class Shard:
            def __init__(self):
                self.dev = Dev()

            def handle(self):
                self.dev.stage()
    """)
    assert _only_node(g, "Dev.stage") in \
        _callee_ids(g, _only_node(g, "Shard.handle"))


def test_held_object_edge_across_modules_and_alias(tmp_path):
    g = _graph(
        tmp_path,
        rpclib="""\
            class DeviceClient:
                def fetch(self):
                    pass
        """,
        app="""\
            import rpclib

            class Server:
                def __init__(self, client=None):
                    self.dev = client or rpclib.DeviceClient()

                def handle(self):
                    self.dev.fetch()
        """,
    )
    # the `x or Class()` injectable-dependency default resolves too
    assert _only_node(g, "DeviceClient.fetch") in \
        _callee_ids(g, _only_node(g, "Server.handle"))


def test_held_object_ambiguous_attr_stays_unresolved(tmp_path):
    """An attr constructed as two different classes would make any edge a
    guess — the under-approximation polarity drops it."""
    g = _graph(tmp_path, m="""\
        class A:
            def go(self):
                pass

        class B:
            def go(self):
                pass

        class User:
            def __init__(self, fast):
                if fast:
                    self.impl = A()
                else:
                    self.impl = B()

            def handle(self):
                self.impl.go()
    """)
    assert _callee_ids(g, _only_node(g, "User.handle")) == []


def test_held_object_mutation_reaches_fiber_shared_state(tmp_path):
    """A handler mutating state THROUGH a held object was invisible to the
    resolver before the attr-type map; now the chain is followed and the
    unlocked mutation inside the held class is reported."""
    (tmp_path / "app.py").write_text(textwrap.dedent("""\
        class Sink:
            def __init__(self):
                self.items = []

            def push(self, x):
                self.items.append(x)

        class Shard:
            def __init__(self, server):
                self.sink = Sink()
                server.add_service("Ps", self._handle)

            def _handle(self, method, req):
                self.sink.push(req)
                return b""
    """))
    findings = [f for f in lint.run_lint([str(tmp_path)])
                if f.check == "fiber-shared-state"]
    assert len(findings) == 1
    f = findings[0]
    assert "self.items" in f.message
    assert "Shard._handle -> Sink.push" in f.message


def test_constructor_self_mutation_exempt(tmp_path):
    """__init__ initializing its OWN fresh object is not shared-state
    mutation (nothing else can see the object before publication) — the
    attr-type map makes constructors handler-reachable, so the check must
    not flag them."""
    (tmp_path / "app.py").write_text(textwrap.dedent("""\
        class Item:
            def __init__(self, v):
                self.v = v

        class Shard:
            def __init__(self, server):
                server.add_service("Ps", self._handle)

            def _handle(self, method, req):
                return Item(req).v
    """))
    assert lint.run_lint([str(tmp_path)]) == []


# ---- seeded cross-module violations the lexical pass misses ----

_IMPURE_HELPERS = """\
    import time

    def stamp(x):
        return deeper(x)

    def deeper(x):
        return x + time.time()
"""

_TRACED_APP = """\
    import torch
    from helpers import stamp

    @torch.compile
    def step(x):
        return stamp(x)
"""


def test_cross_module_trace_purity_with_chain(tmp_path):
    (tmp_path / "helpers.py").write_text(textwrap.dedent(_IMPURE_HELPERS))
    (tmp_path / "app.py").write_text(textwrap.dedent(_TRACED_APP))
    # the old lexical shape — scanning app.py alone — sees nothing
    assert lint.run_lint([str(tmp_path / "app.py")]) == []
    # the whole-package pass follows the chain into the other module
    findings = [f for f in lint.run_lint([str(tmp_path)])
                if f.check == "trace-purity"]
    assert len(findings) == 1
    f = findings[0]
    assert f.path.endswith("helpers.py")
    assert "time.time" in f.message
    assert "step -> stamp -> deeper" in f.message  # the full call chain


_SHARED_HELPERS = """\
    PENDING = []

    def enqueue(item):
        PENDING.append(item)
"""

_HANDLER_APP = """\
    from helpers import enqueue

    class Shard:
        def __init__(self, server):
            server.add_service("Ps", self._handle)

        def _handle(self, method, req):
            enqueue(req)
            return b""
"""


def test_cross_module_fiber_shared_state_with_chain(tmp_path):
    (tmp_path / "helpers.py").write_text(textwrap.dedent(_SHARED_HELPERS))
    (tmp_path / "app.py").write_text(textwrap.dedent(_HANDLER_APP))
    assert lint.run_lint([str(tmp_path / "app.py")]) == []
    findings = [f for f in lint.run_lint([str(tmp_path)])
                if f.check == "fiber-shared-state"]
    assert len(findings) == 1
    f = findings[0]
    assert f.path.endswith("helpers.py")
    assert "PENDING" in f.message
    assert "Shard._handle -> enqueue" in f.message


def test_cross_module_helper_called_under_lock_stays_clean(tmp_path):
    (tmp_path / "helpers.py").write_text(textwrap.dedent(_SHARED_HELPERS))
    (tmp_path / "app.py").write_text(textwrap.dedent("""\
        import threading
        from helpers import enqueue

        class Shard:
            def __init__(self, server):
                self._mu = threading.Lock()
                server.add_service("Ps", self._handle)

            def _handle(self, method, req):
                with self._mu:
                    enqueue(req)
                return b""
    """))
    assert lint.run_lint([str(tmp_path)]) == []


def test_thread_local_state_exempt(tmp_path):
    (tmp_path / "app.py").write_text(textwrap.dedent("""\
        import threading

        class Shard:
            def __init__(self, server):
                self._local = threading.local()
                server.add_service("Ps", self._handle)

            def _handle(self, method, req):
                self._local.scratch = req
                return b""
    """))
    assert lint.run_lint([str(tmp_path)]) == []


def test_handler_registered_as_bare_function(tmp_path):
    (tmp_path / "app.py").write_text(textwrap.dedent("""\
        SEEN = []

        def handle(method, req):
            SEEN.append(req)
            return b""

        def setup(server):
            server.add_service("Ps", handle)
    """))
    findings = [f for f in lint.run_lint([str(tmp_path)])
                if f.check == "fiber-shared-state"]
    assert len(findings) == 1
    assert "SEEN" in findings[0].message


# ---- local-variable type inference (x = Class(); x.meth()) ----

def test_local_constructor_binding_resolves(tmp_path):
    g = _graph(
        tmp_path,
        lib="""\
            class Worker:
                def run(self):
                    pass
        """,
        app="""\
            from lib import Worker

            def main():
                w = Worker()
                w.run()
        """,
    )
    main = _only_node(g, ":main")
    assert _only_node(g, "Worker.run") in _callee_ids(g, main)


def test_local_binding_through_module_alias_and_ifexp(tmp_path):
    g = _graph(
        tmp_path,
        lib="""\
            class Worker:
                def run(self):
                    pass
        """,
        app="""\
            import lib

            def main(flag, given):
                w = lib.Worker() if flag else None
                v = given or lib.Worker()
                w.run()
                v.run()
        """,
    )
    main = _only_node(g, ":main")
    run = _only_node(g, "Worker.run")
    # both the conditional and the or-default bind to ONE class each
    assert [c for c in _callee_ids(g, main) if c == run] == [run]
    assert sum(1 for s in g.callees(main) if s.callee == run) == 2


def test_local_ambiguous_stays_deferred_but_call_results_resolve(tmp_path):
    # That deferral's second half: calls on CALL RESULTS now resolve
    # through return-type inference — `y = factory(); y.run()` follows
    # the factory's direct in-package return.  Ambiguity rules are
    # unchanged: a local bound to two classes (or a factory whose returns
    # disagree) stays unresolved.
    g = _graph(
        tmp_path,
        lib="""\
            class A:
                def run(self):
                    pass

            class B:
                def run(self):
                    pass

            def factory():
                return A()

            def two_faced(flag):
                if flag:
                    return A()
                return B()
        """,
        app="""\
            from lib import A, B, factory, two_faced

            def ambiguous(flag):
                x = A()
                if flag:
                    x = B()
                x.run()

            def call_result():
                y = factory()
                y.run()

            def ambiguous_factory():
                z = two_faced(True)
                z.run()
        """,
    )
    run_a = _only_node(g, "A.run")
    run_b = _only_node(g, "B.run")
    amb = _callee_ids(g, _only_node(g, ":ambiguous"))
    assert run_a not in amb and run_b not in amb
    cr = _callee_ids(g, _only_node(g, ":call_result"))
    assert run_a in cr            # the closed deferral
    assert run_b not in cr
    assert _only_node(g, ":factory") in cr
    # a factory whose returns name two classes is ambiguous → no edge
    af = _callee_ids(g, _only_node(g, ":ambiguous_factory"))
    assert run_a not in af and run_b not in af


def test_nested_def_reads_enclosing_local_binding(tmp_path):
    g = _graph(
        tmp_path,
        lib="""\
            class Worker:
                def run(self):
                    pass
        """,
        app="""\
            from lib import Worker

            def outer():
                w = Worker()

                def inner():
                    w.run()
                return inner
        """,
    )
    inner = _only_node(g, "outer.inner")
    assert _only_node(g, "Worker.run") in _callee_ids(g, inner)


def test_annotated_attr_and_conditional_constructor_resolve(tmp_path):
    # self.<attr>: T = Class(...) if cond else None — the AnnAssign +
    # IfExp form the combiner uses; the attr-type map must see through
    # both or handler-reachable calls on the held object stay opaque.
    g = _graph(tmp_path, m="""\
        class Helper:
            def work(self):
                pass

        class Owner:
            def __init__(self, on):
                self.h: "Helper | None" = Helper() if on else None

            def entry(self):
                self.h.work()
    """)
    entry = _only_node(g, "Owner.entry")
    assert _only_node(g, "Helper.work") in _callee_ids(g, entry)


def test_synchronized_helper_method_not_flagged_as_container(tmp_path):
    # self.q.add() where q's class is in-package and add() locks
    # internally: the call RESOLVES, the interprocedural walk checks the
    # callee's body, and the raw-container mutator heuristic must not
    # double-report.  An UNLOCKED helper still yields a finding — inside
    # the helper, with the chain.
    good = """\
        import threading

        class Combiner:
            def __init__(self):
                self._mu = threading.Lock()
                self._q = []

            def add(self, item):
                with self._mu:
                    self._q.append(item)

        class Shard:
            def __init__(self, server):
                self.q = Combiner()
                server.add_service("Ps", self._handle)

            def _handle(self, method, req):
                self.q.add(req)
                return b""
    """
    src = textwrap.dedent(good)
    (tmp_path / "good.py").write_text(src)
    assert [f for f in lint.run_lint([str(tmp_path)])
            if f.check == "fiber-shared-state"] == []
    bad = src.replace("        with self._mu:\n"
                      "            self._q.append(item)",
                      "        self._q.append(item)")
    assert bad != src
    (tmp_path / "good.py").write_text(bad)
    findings = [f for f in lint.run_lint([str(tmp_path)])
                if f.check == "fiber-shared-state"]
    assert len(findings) == 1
    assert "Combiner.add" in findings[0].message


# ---- return-type inference (calls on CALL RESULTS resolve) ----

def test_cached_accessor_call_result_resolves(tmp_path):
    # the obs.recorder(name).record shape: the accessor returns a local
    # that is ALSO fed from a cache lookup, but every resolved return
    # names one class — annotation-free inference from the constructor
    # binding
    g = _graph(
        tmp_path,
        vars="""\
            class LatencyRecorder:
                def record(self, s):
                    pass
        """,
        obs="""\
            from vars import LatencyRecorder

            _cache = {}

            def recorder(name):
                rec = _cache.get(name)
                if rec is None:
                    rec = LatencyRecorder()
                    _cache[name] = rec
                return rec
        """,
        app="""\
            import obs

            def instrument(name, v):
                obs.recorder(name).record(v)
        """,
    )
    rec = _only_node(g, "LatencyRecorder.record")
    assert rec in _callee_ids(g, _only_node(g, ":instrument"))


def test_string_annotation_return_type_resolves(tmp_path):
    g = _graph(
        tmp_path,
        rpc="""\
            class Stream:
                def write(self, b):
                    pass
        """,
        client="""\
            from brpc_tpu_torch import nothing  # noqa
            import rpc

            class Client:
                def _push_stream(self, s) -> "rpc.Stream":
                    return self._streams[s]

                def push(self, s, frame):
                    self._push_stream(s).write(frame)
        """,
    )
    write = _only_node(g, "Stream.write")
    assert write in _callee_ids(g, _only_node(g, "Client.push"))


def test_optional_annotation_unwraps(tmp_path):
    g = _graph(
        tmp_path,
        lib="""\
            class Thing:
                def go(self):
                    pass
        """,
        app="""\
            from typing import Optional

            from lib import Thing

            def maybe_thing(flag) -> Optional[Thing]:
                return Thing() if flag else None

            def use(flag):
                t = maybe_thing(flag)
                t.go()
        """,
    )
    go = _only_node(g, "Thing.go")
    assert go in _callee_ids(g, _only_node(g, ":use"))


def test_constructor_call_result_chain_resolves(tmp_path):
    g = _graph(
        tmp_path,
        lib="""\
            class W:
                def __init__(self):
                    pass

                def run(self):
                    pass
        """,
        app="""\
            from lib import W

            def inline():
                W().run()
        """,
    )
    assert _only_node(g, "W.run") in _callee_ids(g, _only_node(g, ":inline"))


def test_factory_typed_attr_assignment(tmp_path):
    # self.<attr> = make_channel() types the attr through the factory's
    # return type — held-object calls resolve
    g = _graph(
        tmp_path,
        lib="""\
            class Channel:
                def __init__(self, addr):
                    pass

                def call(self, m):
                    pass

            def make_channel(addr):
                return Channel(addr)
        """,
        app="""\
            from lib import make_channel

            class Client:
                def __init__(self, addr):
                    self.ch = make_channel(addr)

                def go(self):
                    self.ch.call("M")
        """,
    )
    call = _only_node(g, "Channel.call")
    assert call in _callee_ids(g, _only_node(g, "Client.go"))


def test_factory_return_chain_fixpoint(tmp_path):
    g = _graph(
        tmp_path,
        lib="""\
            class C:
                def m(self):
                    pass

            def inner():
                return C()

            def outer():
                return inner()
        """,
        app="""\
            from lib import outer

            def use():
                x = outer()
                x.m()
        """,
    )
    assert _only_node(g, "C.m") in _callee_ids(g, _only_node(g, ":use"))


# ---- may-throw fixpoint ----

def _throws(g, suffix):
    return g.throw_summary(_only_node(g, suffix))


def test_may_throw_explicit_raise_and_propagation(tmp_path):
    g = _graph(tmp_path, m="""\
        def boom():
            raise ValueError("bad")

        def mid():
            boom()

        def top():
            mid()

        def quiet():
            return 1 + 2
    """)
    for suffix in (":boom", ":mid", ":top"):
        s = _throws(g, suffix)
        assert s.may_throw, suffix
        assert s.types == ("ValueError",), suffix
        assert s.confidence == "high", suffix
    q = _throws(g, ":quiet")
    assert not q.may_throw and not q.external
    assert q.confidence == "none"


def test_may_throw_absorbed_by_base_class_handler(tmp_path):
    g = _graph(tmp_path, m="""\
        def boom():
            raise KeyError("k")

        def guarded():
            try:
                boom()
            except LookupError:
                return None

        def misguarded():
            try:
                boom()
            except OSError:
                return None
    """)
    # KeyError < LookupError: the guard absorbs the proven throw
    assert not _throws(g, ":guarded").may_throw
    # an unrelated clause absorbs nothing — the KeyError unwinds out
    s = _throws(g, ":misguarded")
    assert s.types == ("KeyError",) and s.confidence == "high"


def test_may_throw_external_call_is_low_confidence_only(tmp_path):
    g = _graph(tmp_path, m="""\
        import os

        def rm(path):
            os.remove(path)
    """)
    s = _throws(g, ":rm")
    # os.remove can obviously raise, but the analysis cannot prove a
    # chain — external bit only, NEVER a proven may-throw (findings
    # built on summaries stay free of unverifiable chains)
    assert not s.may_throw
    assert s.external
    assert s.confidence == "external"


def test_may_throw_assert_statement(tmp_path):
    g = _graph(tmp_path, m="""\
        def check(x):
            assert x > 0, "positive"
            return x
    """)
    s = _throws(g, ":check")
    assert s.types == ("AssertionError",)


def test_may_throw_unknown_type_absorbed_only_by_catch_all(tmp_path):
    g = _graph(tmp_path, m="""\
        def relay(e):
            raise e

        def narrow():
            try:
                relay(make())
            except ValueError:
                return None

        def wide():
            try:
                relay(make())
            except Exception:
                return None

        def make():
            return RuntimeError("x")
    """)
    assert _throws(g, ":relay").unknown
    # a named clause cannot prove it absorbs an unknown-typed throw
    assert _throws(g, ":narrow").unknown
    # only a catch-all absorbs it
    assert not _throws(g, ":wide").may_throw


def test_may_throw_in_package_exception_hierarchy(tmp_path):
    g = _graph(tmp_path, m="""\
        class FabricError(RuntimeError):
            pass

        class WireError(FabricError):
            pass

        def boom():
            raise WireError("frame")

        def guarded():
            try:
                boom()
            except FabricError:
                return None

        def misguarded():
            try:
                boom()
            except OSError:
                return None
    """)
    assert _throws(g, ":boom").types == ("WireError",)
    # the scanned ClassDef chain WireError -> FabricError is honoured
    assert not _throws(g, ":guarded").may_throw
    assert _throws(g, ":misguarded").types == ("WireError",)


def test_may_throw_recursive_cycle_terminates(tmp_path):
    g = _graph(tmp_path, m="""\
        def ping(n):
            if n <= 0:
                raise TimeoutError("spin")
            return pong(n - 1)

        def pong(n):
            return ping(n)
    """)
    assert _throws(g, ":ping").types == ("TimeoutError",)
    assert _throws(g, ":pong").types == ("TimeoutError",)


def test_may_throw_fixpoint_deterministic(tmp_path):
    src = """\
        class AppError(Exception):
            pass

        def a():
            raise AppError("a")

        def b():
            a()
            assert True

        def c(x):
            if x:
                raise ValueError(x)
            b()
    """
    g1 = _graph(tmp_path, m=src)
    other = tmp_path / "again"
    other.mkdir()
    g2 = _graph(other, m=src)
    t1 = {nid.split(":", 1)[-1]: g1.compute_throws()[nid]
          for nid in g1.nodes}
    t2 = {nid.split(":", 1)[-1]: g2.compute_throws()[nid]
          for nid in g2.nodes}
    assert t1 == t2
    # and re-computation on the same graph is cached + identical
    assert g1.compute_throws() is g1.compute_throws()


# ---- parity with the reference over the port's tree ----

def _tree_graph(build):
    pairs = []
    for root, dirs, files in os.walk(PKG):
        dirs[:] = sorted(d for d in dirs if d not in ("__pycache__",
                                                      "_build"))
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path, encoding="utf-8") as fh:
                    pairs.append((path, ast.parse(fh.read(), path)))
    return build(pairs)


@pytest.fixture(scope="module")
def tree_graphs():
    return (_tree_graph(build_callgraph),
            _tree_graph(ref_callgraph.build_callgraph))


def _edges(g):
    return {(caller, site.callee, site.line)
            for caller, sites in g.edges.items() for site in sites}


def test_whole_tree_graph_equal_to_reference(tree_graphs):
    ours, theirs = tree_graphs
    assert len(ours.nodes) > 1000
    assert set(ours.nodes) == set(theirs.nodes)
    assert len(_edges(ours)) > 1000
    assert _edges(ours) == _edges(theirs)
