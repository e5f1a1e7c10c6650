"""Whole-package call-graph resolver over the ASTs of a Python tree.

The first linter enforced its concurrency contracts lexically: a traced
function calling an impure helper defined in another module escaped
``trace-purity``, and ``fiber-shared-state`` only saw mutation inside
the handler's own class.  The known art this tier mirrors — lockdep's
order-graph inference, ThreadSanitizer's happens-before checking — is
interprocedural by construction; this module makes our static passes the
same.

What gets resolved (edges carry the call site's path + line):

- bare-name calls to module-level functions (and module-level lambdas),
  nested functions of the enclosing scope, and ``from mod import fn``
  imports that land on a scanned module;
- dotted calls through module aliases (``import brpc_tpu_torch.rpc as rpc``,
  ``from brpc_tpu_torch import rpc`` → ``rpc.fn()``) and full dotted paths
  (``brpc_tpu_torch.rpc.fn()``);
- method calls through ``self`` (``self._serve()``), including
  in-package base classes, and unbound ``ClassName.meth`` calls;
- method calls on HELD objects through a lightweight attr-type map:
  ``self.dev = rpc.DeviceClient(...)`` (anywhere in the class, including
  ``x or Class()`` defaults) lets ``self.dev.stage()`` resolve to
  ``DeviceClient.stage``; an attr constructed as two different classes is
  ambiguous and stays unresolved (no false edges);
- method calls on LOCAL variables bound directly to in-package
  constructors (the same semantics, one scope down): ``x = Class();
  x.meth()`` resolves, including ``x or Class()`` defaults and across
  nested defs reading the enclosing scope; a local constructed as two
  different classes is ambiguous and dropped;
- method calls on CALL RESULTS through per-function return-type
  inference: a function whose ``->`` annotation (incl. string forms,
  one ``Optional[...]`` layer unwrapped) or whose direct in-package
  returns (``return Class(...)``, returns of constructor-bound locals,
  ``return factory()`` chains via a bounded fixpoint) name ONE class
  lets both ``obs.recorder(name).record(...)`` and ``x = factory();
  x.meth()`` resolve; conflicting returns are ambiguous and dropped —
  the factory-call assignment also feeds the attr/local type maps
  (``self.ch = make_channel()`` types ``self.ch``);
- constructor calls (``rpc.Server()`` → ``Server.__init__``);
- ``functools.partial`` targets: ``h = partial(worker, 1); h()``
  resolves to ``worker``, as does calling/constructing the partial
  directly (the construction itself records an edge — the partial
  exists to be called).

Everything unresolvable (calls on arbitrary objects, call results,
parameters) is silently skipped: the graph is an under-approximation,
which is the right polarity for lint (no false edges → no false call
chains in findings).

Traversals tolerate recursion/cycles — ``reachable`` and the checks
built on top memoize on visited nodes.

Entry point: :func:`build_callgraph` over ``(path, ast.Module)`` pairs;
:class:`CallGraph` answers ``node_for_ast`` / ``call_target`` /
``callees`` / ``reachable`` / ``resolve_callable_expr``.

May-throw analysis (:meth:`CallGraph.compute_throws`): a per-function
fixpoint over the same edges answering "can this function raise, and
what?".  Explicit ``raise``/``assert`` statements contribute proven
types (``raise X(...)`` / ``raise X`` where ``X`` names a known
exception class; a bare re-raise or a dynamic raise expression is a
proven throw of *unknown* type); resolved calls propagate their
callee's summary; a call or raise lexically inside a ``try`` is
absorbed by handlers that can catch it (matching by class name through
the in-package class hierarchy plus the builtin exception tree —
``except RpcError`` absorbs a raised ``StreamClosed`` subclass; an
unknown-typed throw is absorbed only by a catch-all handler).
Unresolvable calls never contribute proven types — they set only the
low-confidence ``external`` bit, so a finding built on a proven
summary never rests on a guessed chain.  Per-call query:
:meth:`CallGraph.call_throws`.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = ["CallGraph", "FuncNode", "ModuleInfo", "ClassInfo", "CallSite",
           "ThrowSummary", "build_callgraph", "module_name_for_path"]


def module_name_for_path(path: str) -> str:
    """Dotted module name for a file, walking up through ``__init__.py``
    packages (``brpc_tpu_torch/obs/vars.py`` →
    ``brpc_tpu_torch.obs.vars``); a file outside any package is just its
    stem (fixture-friendly)."""
    path = os.path.abspath(path)
    d, fname = os.path.split(path)
    stem = fname[:-3] if fname.endswith(".py") else fname
    parts = [] if stem == "__init__" else [stem]
    while os.path.isfile(os.path.join(d, "__init__.py")):
        d, base = os.path.split(d)
        if not base:
            break
        parts.append(base)
    if not parts:
        parts = [stem]
    return ".".join(reversed(parts))


@dataclasses.dataclass
class ClassInfo:
    name: str
    module: str
    bases: List[ast.expr]
    methods: Dict[str, str]          # method name -> node id
    #: every value ever assigned to self.<attr> inside the class body
    #: (feeds the attr-type map; see CallGraph._build_attr_types)
    attr_assigns: Dict[str, List[ast.expr]] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class FuncNode:
    node_id: str                     # "<module>:<qual>"
    module: str                      # dotted module name
    qual: str                        # "Cls._handle" / "fn" / "fn.inner"
    name: str                        # last component of qual
    cls: Optional[str]               # owning class name, if a method
    path: str
    fn: ast.AST                      # FunctionDef / AsyncFunctionDef / Lambda
    local_defs: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ModuleInfo:
    name: str
    path: str
    tree: ast.Module
    funcs: Dict[str, str] = dataclasses.field(default_factory=dict)
    classes: Dict[str, ClassInfo] = dataclasses.field(default_factory=dict)
    #: local alias -> dotted module name ("rpc" -> "brpc_tpu_torch.rpc")
    import_aliases: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: local name -> (dotted module, original name) for `from m import n`
    from_imports: Dict[str, Tuple[str, str]] = dataclasses.field(
        default_factory=dict)
    #: names bound by module top-level statements (mutable module state)
    module_globals: Set[str] = dataclasses.field(default_factory=set)
    #: module-level `x = partial(target, ...)` -> resolved target node id
    partial_aliases: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class CallSite:
    callee: str                      # node id
    path: str
    line: int


#: handler types that catch everything we model (all proven raises in
#: this tree derive from Exception; BaseException is a superset)
_CATCH_ALL = frozenset({"Exception", "BaseException"})

#: direct bases of the builtin exceptions this tree actually raises or
#: catches — enough hierarchy that ``except LookupError`` absorbs a
#: raised ``KeyError`` without importing anything at analysis time
_BUILTIN_EXC_BASES: Dict[str, Tuple[str, ...]] = {
    "ValueError": ("Exception",),
    "TypeError": ("Exception",),
    "KeyError": ("LookupError",),
    "IndexError": ("LookupError",),
    "LookupError": ("Exception",),
    "AttributeError": ("Exception",),
    "NameError": ("Exception",),
    "RuntimeError": ("Exception",),
    "NotImplementedError": ("RuntimeError",),
    "RecursionError": ("RuntimeError",),
    "OSError": ("Exception",),
    "IOError": ("OSError",),
    "TimeoutError": ("OSError",),
    "ConnectionError": ("OSError",),
    "BrokenPipeError": ("ConnectionError",),
    "ConnectionResetError": ("ConnectionError",),
    "ConnectionAbortedError": ("ConnectionError",),
    "ConnectionRefusedError": ("ConnectionError",),
    "FileNotFoundError": ("OSError",),
    "FileExistsError": ("OSError",),
    "PermissionError": ("OSError",),
    "InterruptedError": ("OSError",),
    "BlockingIOError": ("OSError",),
    "ArithmeticError": ("Exception",),
    "ZeroDivisionError": ("ArithmeticError",),
    "OverflowError": ("ArithmeticError",),
    "FloatingPointError": ("ArithmeticError",),
    "AssertionError": ("Exception",),
    "StopIteration": ("Exception",),
    "StopAsyncIteration": ("Exception",),
    "MemoryError": ("Exception",),
    "BufferError": ("Exception",),
    "UnicodeError": ("ValueError",),
    "UnicodeDecodeError": ("UnicodeError",),
    "UnicodeEncodeError": ("UnicodeError",),
    "EOFError": ("Exception",),
    "ImportError": ("Exception",),
    "ModuleNotFoundError": ("ImportError",),
    "SystemExit": ("BaseException",),
    "KeyboardInterrupt": ("BaseException",),
    "GeneratorExit": ("BaseException",),
}


@dataclasses.dataclass(frozen=True)
class ThrowSummary:
    """What one function can raise, per the may-throw fixpoint.

    ``types`` and ``unknown`` are PROVEN: they trace back through
    resolved call edges to an explicit ``raise``/``assert`` in scanned
    code.  ``external`` is the conservative low-confidence bit — some
    unresolved or out-of-package call on an unguarded path might throw,
    but the analysis cannot name a chain.  Checks that emit findings
    consult only the proven half; the external bit exists so callers
    can distinguish "proven not to raise from scanned code" from
    "nothing is known"."""

    #: proven raisable exception type names, sorted (e.g. ("RpcError",
    #: "ValueError")); a name is a class' last path component
    types: Tuple[str, ...] = ()
    #: proven throw whose type the analysis cannot name (bare re-raise,
    #: ``raise make_error()``, ``raise e`` through a variable)
    unknown: bool = False
    #: an unresolved/external call sits on an unguarded path
    external: bool = False

    @property
    def may_throw(self) -> bool:
        """Proven: an explicit raise in scanned code can unwind out."""
        return bool(self.types) or self.unknown

    @property
    def confidence(self) -> str:
        if self.may_throw:
            return "high"
        return "external" if self.external else "none"


def _last_name(expr: ast.AST) -> Optional[str]:
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def _dotted_chain(expr: ast.AST) -> Optional[List[str]]:
    """['rpc', 'Server'] for ``rpc.Server``; None unless rooted at a Name."""
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return list(reversed(parts))
    return None


class CallGraph:
    def __init__(self) -> None:
        self.modules: Dict[str, ModuleInfo] = {}
        self.nodes: Dict[str, FuncNode] = {}
        self.edges: Dict[str, List[CallSite]] = {}
        self._by_ast: Dict[int, str] = {}
        self._call_targets: Dict[int, str] = {}  # id(ast.Call) -> node id
        #: (module, class, attr) -> (owning ModuleInfo, class name) for
        #: attrs whose every constructor assignment names ONE class
        self._attr_types: Dict[Tuple[str, str, str],
                               Tuple["ModuleInfo", str]] = {}
        #: node id -> (owning ModuleInfo, class name) for functions whose
        #: return type resolves to ONE in-package class (annotation, or
        #: direct in-package returns — see _infer_return_types)
        self._return_types: Dict[str, Tuple["ModuleInfo", str]] = {}
        #: lazy results of the may-throw fixpoint (compute_throws)
        self._throws: Optional[Dict[str, ThrowSummary]] = None
        #: class name -> direct base names, over every scanned module
        #: (built lazily; name-keyed — class names are unique enough in
        #: one package, and a collision only widens absorption)
        self._class_bases: Optional[Dict[str, Tuple[str, ...]]] = None
        self._ancestor_cache: Dict[str, frozenset] = {}

    # -- construction ------------------------------------------------------

    def add_module(self, path: str, tree: ast.Module) -> ModuleInfo:
        name = module_name_for_path(path)
        if name in self.modules:  # two fixture files with one stem
            name = f"{name}@{path}"
        mi = ModuleInfo(name=name, path=path, tree=tree)
        self.modules[name] = mi
        self._collect_imports(mi)
        self._collect_defs(mi)
        return mi

    def _collect_imports(self, mi: ModuleInfo) -> None:
        # Imports anywhere in the file (the tree uses function-local
        # imports to break cycles, e.g. ps_remote.from_registry).
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    mi.import_aliases[alias.asname or
                                      alias.name.split(".")[0]] = (
                        alias.name if alias.asname else
                        alias.name.split(".")[0])
                    if alias.asname is None and "." in alias.name:
                        # `import a.b.c` binds `a`; remember the full path
                        # too so `a.b.c.fn()` resolves by longest prefix.
                        mi.import_aliases.setdefault(alias.name, alias.name)
            elif isinstance(node, ast.ImportFrom):
                if node.level:  # relative import: anchor at this package
                    base = mi.name.split(".")
                    base = base[:len(base) - node.level]
                    mod = ".".join(base + ([node.module]
                                           if node.module else []))
                else:
                    mod = node.module or ""
                for alias in node.names:
                    mi.from_imports[alias.asname or alias.name] = (
                        mod, alias.name)

    def _collect_defs(self, mi: ModuleInfo) -> None:
        for stmt in mi.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._register_func(mi, stmt, qual_prefix="", cls=None,
                                    into=mi.funcs)
            elif isinstance(stmt, ast.ClassDef):
                ci = ClassInfo(name=stmt.name, module=mi.name,
                               bases=list(stmt.bases), methods={})
                mi.classes[stmt.name] = ci
                for item in stmt.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self._register_func(
                            mi, item, qual_prefix=stmt.name + ".",
                            cls=stmt.name, into=ci.methods)
                for node in ast.walk(stmt):
                    if isinstance(node, ast.Assign):
                        targets, value = node.targets, node.value
                    elif isinstance(node, ast.AnnAssign) and \
                            node.value is not None:
                        # self.<attr>: T = value — the annotated form of
                        # the same binding
                        targets, value = [node.target], node.value
                    else:
                        continue
                    for tgt in targets:
                        if isinstance(tgt, ast.Attribute) and \
                                isinstance(tgt.value, ast.Name) and \
                                tgt.value.id == "self":
                            ci.attr_assigns.setdefault(
                                tgt.attr, []).append(value)
            elif isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign,
                                   ast.For, ast.AsyncFor)):
                targets = []
                if isinstance(stmt, ast.Assign):
                    targets = stmt.targets
                elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
                    targets = [stmt.target]
                else:
                    targets = [stmt.target]
                for tgt in targets:
                    for leaf in ast.walk(tgt):
                        if isinstance(leaf, ast.Name):
                            mi.module_globals.add(leaf.id)
                if isinstance(stmt, ast.Assign) and \
                        isinstance(stmt.value, ast.Lambda):
                    for tgt in stmt.targets:
                        if isinstance(tgt, ast.Name):
                            self._register_lambda(mi, tgt.id, stmt.value)

    def _register_func(self, mi: ModuleInfo, fn: ast.AST, qual_prefix: str,
                       cls: Optional[str], into: Dict[str, str]) -> str:
        qual = qual_prefix + fn.name
        node_id = f"{mi.name}:{qual}"
        node = FuncNode(node_id=node_id, module=mi.name, qual=qual,
                        name=fn.name, cls=cls, path=mi.path, fn=fn)
        self.nodes[node_id] = node
        self._by_ast[id(fn)] = node_id
        into[fn.name] = node_id
        # nested defs are their own nodes, visible by name to the parent
        for stmt in fn.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child = self._register_func(
                    mi, stmt, qual_prefix=qual + ".", cls=cls,
                    into=node.local_defs)
        return node_id

    def _register_lambda(self, mi: ModuleInfo, name: str,
                         fn: ast.Lambda) -> None:
        node_id = f"{mi.name}:{name}"
        self.nodes[node_id] = FuncNode(
            node_id=node_id, module=mi.name, qual=name, name=name, cls=None,
            path=mi.path, fn=fn)
        self._by_ast[id(fn)] = node_id
        mi.funcs.setdefault(name, node_id)

    # -- module / class resolution ----------------------------------------

    def _find_module(self, dotted: str) -> Optional[ModuleInfo]:
        mi = self.modules.get(dotted)
        if mi is not None:
            return mi
        # fixture trees have no package root: match by dotted suffix,
        # then by last component, but only when unambiguous
        for matcher in (lambda n: n.endswith("." + dotted),
                        lambda n: n.split(".")[-1] == dotted.split(".")[-1]):
            hits = [m for n, m in self.modules.items() if matcher(n)]
            if len(hits) == 1:
                return hits[0]
        return None

    def _resolve_class(self, mi: ModuleInfo, name: str,
                       _seen: Optional[Set[str]] = None
                       ) -> Optional[ClassInfo]:
        ci = mi.classes.get(name)
        if ci is not None:
            return ci
        src = mi.from_imports.get(name)
        if src is not None:
            target = self._find_module(src[0])
            if target is not None and target is not mi:
                return target.classes.get(src[1])
        return None

    def _method(self, mi: ModuleInfo, cls_name: str, meth: str,
                _seen: Optional[Set[str]] = None) -> Optional[str]:
        """Resolve ``cls_name.meth`` including in-package base classes."""
        seen = _seen or set()
        key = f"{mi.name}.{cls_name}"
        if key in seen:
            return None
        seen.add(key)
        ci = self._resolve_class(mi, cls_name)
        if ci is None:
            return None
        hit = ci.methods.get(meth)
        if hit is not None:
            return hit
        base_mi = self.modules.get(ci.module, mi)
        for base in ci.bases:
            base_name = _last_name(base)
            if base_name is None:
                continue
            hit = self._method(base_mi, base_name, meth, seen)
            if hit is not None:
                return hit
        return None

    # -- attr-type map (self.<attr> = Class(...)) --------------------------

    def _class_of_value(self, value: ast.AST, mi: ModuleInfo
                        ) -> Optional[Tuple[ModuleInfo, str]]:
        """Class constructed by an assigned value: a direct ``Class(...)``
        call, an ``x or Class(...)`` default (the injectable-dependency
        idiom), or a ``Class(...) if cond else None`` conditional (the
        optional-subsystem idiom — a ``None`` arm neither helps nor
        hurts).  None for anything else — parameters, call results and
        literals stay untyped (under-approximation)."""
        if isinstance(value, ast.BoolOp):
            hits: Dict[Tuple[str, str], Tuple[ModuleInfo, str]] = {}
            for v in value.values:
                h = self._class_of_value(v, mi)
                if h is not None:
                    hits[(h[0].name, h[1])] = h
            return next(iter(hits.values())) if len(hits) == 1 else None
        if isinstance(value, ast.IfExp):
            hits = {}
            for v in (value.body, value.orelse):
                h = self._class_of_value(v, mi)
                if h is not None:
                    hits[(h[0].name, h[1])] = h
            return next(iter(hits.values())) if len(hits) == 1 else None
        if not isinstance(value, ast.Call):
            return None
        f = value.func
        if isinstance(f, ast.Name):
            if f.id in mi.classes:
                return mi, f.id
            src = mi.from_imports.get(f.id)
            if src is not None:
                target = self._find_module(src[0])
                if target is not None and target is not mi:
                    if src[1] in target.classes:
                        return target, src[1]
                    if src[1] in target.funcs:
                        # from m import factory; x = factory()
                        return self._return_types.get(target.funcs[src[1]])
            if f.id in mi.funcs:
                # x = local_factory() — the factory's inferred return type
                return self._return_types.get(mi.funcs[f.id])
            return None
        chain = _dotted_chain(f)
        if chain is None:
            return None
        expanded = chain
        if chain[0] in mi.import_aliases:
            expanded = mi.import_aliases[chain[0]].split(".") + chain[1:]
        for cut in range(len(expanded) - 1, 0, -1):
            target = self._find_module(".".join(expanded[:cut]))
            if target is None:
                continue
            rest = expanded[cut:]
            if len(rest) == 1:
                if rest[0] in target.classes:
                    return target, rest[0]
                if rest[0] in target.funcs:
                    # x = mod.factory() — dotted factory call
                    return self._return_types.get(target.funcs[rest[0]])
            return None
        return None

    def _local_constructor_types(
            self, mi: ModuleInfo, body: Sequence[ast.AST]
    ) -> Dict[str, Tuple["ModuleInfo", str]]:
        """Attr-map semantics one scope down: locals of this scope bound
        DIRECTLY to in-package constructors (``x = Class(...)``, incl.
        ``x or Class()``).  Nested function/class/lambda bodies are their
        own scopes and do not contribute; a name whose constructor
        assignments disagree is ambiguous and dropped; non-constructor
        assignments (call results, parameters, literals) neither help
        nor hurt — the same polarity as the attr map."""
        values: Dict[str, List[ast.expr]] = {}

        def scan(node: ast.AST) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                return  # inner scope: its assignments are not our locals
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                values.setdefault(node.targets[0].id, []).append(node.value)
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name) and \
                    node.value is not None:
                values.setdefault(node.target.id, []).append(node.value)
            for child in ast.iter_child_nodes(node):
                scan(child)

        for stmt in body:
            scan(stmt)
        out: Dict[str, Tuple["ModuleInfo", str]] = {}
        for name, vals in values.items():
            hits: Dict[Tuple[str, str], Tuple["ModuleInfo", str]] = {}
            for v in vals:
                h = self._class_of_value(v, mi)
                if h is not None:
                    hits[(h[0].name, h[1])] = h
            if len(hits) == 1:
                out[name] = next(iter(hits.values()))
        return out

    # -- return-type inference (direct in-package returns) -----------------

    def _class_from_dotted(self, parts: List[str], mi: ModuleInfo
                           ) -> Optional[Tuple["ModuleInfo", str]]:
        """Resolve a dotted name (['rpc', 'Stream'] / ['Channel']) to an
        in-package class, through this module's imports."""
        if len(parts) == 1:
            name = parts[0]
            if name in mi.classes:
                return mi, name
            src = mi.from_imports.get(name)
            if src is not None:
                target = self._find_module(src[0])
                if target is not None and src[1] in target.classes:
                    return target, src[1]
            return None
        expanded = parts
        if parts[0] in mi.import_aliases:
            expanded = mi.import_aliases[parts[0]].split(".") + parts[1:]
        for cut in range(len(expanded) - 1, 0, -1):
            target = self._find_module(".".join(expanded[:cut]))
            if target is None:
                continue
            rest = expanded[cut:]
            if len(rest) == 1 and rest[0] in target.classes:
                return target, rest[0]
            return None
        return None

    def _class_from_annotation(self, ann: Optional[ast.AST], mi: ModuleInfo
                               ) -> Optional[Tuple["ModuleInfo", str]]:
        """Resolve a ``-> T`` return annotation to an in-package class.
        Handles bare/dotted names, string annotations (the `from
        __future__ import annotations` / forward-reference idiom, incl.
        quoted dotted forms like ``"rpc.Stream"``), and unwraps a single
        ``Optional[...]`` layer — an annotated None possibility doesn't
        change which class's methods resolve."""
        if ann is None:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            text = ann.value.strip().strip("'\"")
            if text.startswith("Optional[") and text.endswith("]"):
                text = text[len("Optional["):-1].strip()
            parts = text.split(".")
            if all(p.isidentifier() for p in parts):
                return self._class_from_dotted(parts, mi)
            return None
        if isinstance(ann, ast.Subscript) and \
                _last_name(ann.value) == "Optional":
            return self._class_from_annotation(ann.slice, mi)
        parts = _dotted_chain(ann)
        if parts is not None:
            return self._class_from_dotted(parts, mi)
        return None

    def _infer_return_types(self) -> None:
        """Infer each function's return class from its ``->`` annotation
        or, failing that, from DIRECT in-package returns: ``return
        Class(...)``, returns of locals bound to in-package constructors,
        and ``return factory()`` where the factory's own return type is
        already known (a bounded fixpoint resolves chains).  Conflicting
        resolved returns are ambiguous and dropped; unresolved returns
        neither help nor hurt — the attr-map polarity.  This is what lets
        call-RESULT method calls resolve (``obs.recorder(name).record``,
        factory functions)."""
        for _ in range(4):  # bounded fixpoint: chains are shallow
            changed = False
            for node in self.nodes.values():
                if node.node_id in self._return_types:
                    continue
                fn = node.fn
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                mi = self.modules[node.module]
                rt = self._class_from_annotation(
                    getattr(fn, "returns", None), mi)
                if rt is None:
                    rt = self._returns_from_body(fn, mi)
                if rt is not None:
                    self._return_types[node.node_id] = rt
                    changed = True
            if not changed:
                break

    def _returns_from_body(self, fn: ast.AST, mi: ModuleInfo
                           ) -> Optional[Tuple["ModuleInfo", str]]:
        local_types = self._local_constructor_types(mi, fn.body)
        hits: Dict[Tuple[str, str], Tuple["ModuleInfo", str]] = {}

        def scan(node: ast.AST) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                return  # nested scopes return for themselves
            if isinstance(node, ast.Return) and node.value is not None:
                h = None
                if isinstance(node.value, ast.Name):
                    h = local_types.get(node.value.id)
                else:
                    h = self._class_of_value(node.value, mi)
                if h is not None:
                    hits[(h[0].name, h[1])] = h
            for child in ast.iter_child_nodes(node):
                scan(child)

        for stmt in fn.body:
            scan(stmt)
        return next(iter(hits.values())) if len(hits) == 1 else None

    def return_type(self, node_id: str
                    ) -> Optional[Tuple["ModuleInfo", str]]:
        """The class a function's calls evaluate to, when inferred; a
        constructor (``__init__``) yields its own class."""
        rt = self._return_types.get(node_id)
        if rt is not None:
            return rt
        node = self.nodes.get(node_id)
        if node is not None and node.cls is not None and \
                node.name == "__init__":
            mi = self.modules[node.module]
            if node.cls in mi.classes:
                return mi, node.cls
        return None

    def _build_attr_types(self) -> None:
        """Resolve every class's ``self.<attr> = Class(...)`` assignments
        into the attr-type map.  An attr constructed as two DIFFERENT
        classes is ambiguous and dropped; non-constructor assignments
        (None sentinels, parameters) neither help nor hurt."""
        for mi in self.modules.values():
            for cls_name, ci in mi.classes.items():
                for attr, values in ci.attr_assigns.items():
                    hits: Dict[Tuple[str, str],
                               Tuple[ModuleInfo, str]] = {}
                    for v in values:
                        h = self._class_of_value(v, mi)
                        if h is not None:
                            hits[(h[0].name, h[1])] = h
                    if len(hits) == 1:
                        self._attr_types[(mi.name, cls_name, attr)] = \
                            next(iter(hits.values()))

    # -- expression resolution --------------------------------------------

    def _resolve_name(self, name: str, ctx: FuncNode,
                      local_partials: Optional[Dict[str, str]] = None
                      ) -> Optional[str]:
        if local_partials and name in local_partials:
            return local_partials[name]
        if name in ctx.local_defs:
            return ctx.local_defs[name]
        mi = self.modules[ctx.module]
        if name in mi.funcs:
            return mi.funcs[name]
        if name in mi.partial_aliases:
            return mi.partial_aliases[name]
        if name in mi.classes:
            return self._method(mi, name, "__init__")
        src = mi.from_imports.get(name)
        if src is not None:
            target = self._find_module(src[0])
            if target is not None and target is not mi:
                if src[1] in target.funcs:
                    return target.funcs[src[1]]
                if src[1] in target.classes:
                    return self._method(target, src[1], "__init__")
        return None

    def _resolve_dotted(self, chain: List[str], ctx: FuncNode
                        ) -> Optional[str]:
        mi = self.modules[ctx.module]
        # ClassName.meth with a locally visible class (unbound call)
        if len(chain) == 2:
            hit = self._method(mi, chain[0], chain[1])
            if hit is not None:
                return hit
        # expand a leading import alias, then longest-prefix module match
        expanded = chain
        if chain[0] in mi.import_aliases:
            expanded = mi.import_aliases[chain[0]].split(".") + chain[1:]
        for cut in range(len(expanded) - 1, 0, -1):
            target = self._find_module(".".join(expanded[:cut]))
            if target is None:
                continue
            rest = expanded[cut:]
            if len(rest) == 1:
                if rest[0] in target.funcs:
                    return target.funcs[rest[0]]
                if rest[0] in target.classes:
                    return self._method(target, rest[0], "__init__")
            elif len(rest) == 2:
                return self._method(target, rest[0], rest[1])
            return None
        return None

    def resolve_callable_expr(self, expr: ast.AST, ctx: FuncNode,
                              local_partials: Optional[Dict[str, str]] = None,
                              local_types: Optional[Dict[str, Tuple[
                                  "ModuleInfo", str]]] = None
                              ) -> Optional[str]:
        """Resolve an expression in callable position (or passed as a
        callback) to a node id; None when it lands outside the graph.
        ``local_types`` is the scope's constructor-bound-local map (see
        :meth:`_local_constructor_types`)."""
        if isinstance(expr, ast.Name):
            return self._resolve_name(expr.id, ctx, local_partials)
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                    and ctx.cls is not None:
                return self._method(self.modules[ctx.module], ctx.cls,
                                    expr.attr)
            if isinstance(expr.value, ast.Attribute) and \
                    isinstance(expr.value.value, ast.Name) and \
                    expr.value.value.id == "self" and ctx.cls is not None:
                # self.<attr>.<meth> on a held object: the attr-type map
                # knows what self.<attr> was constructed as
                held = self._attr_types.get(
                    (ctx.module, ctx.cls, expr.value.attr))
                if held is not None:
                    return self._method(held[0], held[1], expr.attr)
            if isinstance(expr.value, ast.Name) and local_types and \
                    expr.value.id in local_types:
                # x.<meth> on a constructor-bound local.  A typed local
                # SHADOWS any module alias of the same name, so a miss
                # stays unresolved rather than falling through to a
                # (false) module-level resolution.
                held = local_types[expr.value.id]
                return self._method(held[0], held[1], expr.attr)
            if isinstance(expr.value, ast.Call):
                # <call>().<meth> — a method on a CALL RESULT: resolve the
                # inner call, then its inferred return type (factory
                # functions, obs.recorder(name).record, Class().meth).
                inner = self.resolve_callable_expr(expr.value.func, ctx,
                                                   local_partials,
                                                   local_types)
                if inner is not None:
                    rt = self.return_type(inner)
                    if rt is not None:
                        return self._method(rt[0], rt[1], expr.attr)
                return None
            chain = _dotted_chain(expr)
            if chain is not None:
                return self._resolve_dotted(chain, ctx)
            return None
        if isinstance(expr, ast.Call) and \
                _last_name(expr.func) == "partial" and expr.args:
            # partial(f, ...) called or passed directly
            return self.resolve_callable_expr(expr.args[0], ctx,
                                              local_partials, local_types)
        return None

    # -- edge extraction ---------------------------------------------------

    def extract_edges(self) -> None:
        # All modules are loaded by now, so cross-module constructor
        # assignments resolve; the maps must exist before any edge walk.
        # Return types FIRST: the attr/local type maps consult them for
        # factory-call assignments (self.x = make_channel()).
        self._infer_return_types()
        self._build_attr_types()
        for mi in self.modules.values():
            # module top-level code gets a pseudo-node so inline lambdas /
            # module-scope calls still resolve in a context
            top_id = f"{mi.name}:<module>"
            top = FuncNode(node_id=top_id, module=mi.name, qual="<module>",
                           name="<module>", cls=None, path=mi.path,
                           fn=mi.tree)
            self.nodes[top_id] = top
            self._extract_scope(mi, mi.tree.body, top, {})
            # module-level partial aliases resolve against the pseudo-node
            for stmt in mi.tree.body:
                if isinstance(stmt, ast.Assign) and \
                        isinstance(stmt.value, ast.Call) and \
                        _last_name(stmt.value.func) == "partial" and \
                        stmt.value.args:
                    tgt = self.resolve_callable_expr(stmt.value.args[0], top)
                    if tgt is not None:
                        for t in stmt.targets:
                            if isinstance(t, ast.Name):
                                mi.partial_aliases[t.id] = tgt

    def _extract_scope(self, mi: ModuleInfo, body: Sequence[ast.AST],
                       ctx: FuncNode, local_partials: Dict[str, str],
                       outer_types: Optional[Dict[str, Tuple[
                           "ModuleInfo", str]]] = None) -> None:
        # Constructor-bound locals of THIS scope, over a copy of the
        # enclosing scope's map (closures read outer locals; inner
        # bindings shadow).
        local_types = dict(outer_types or {})
        local_types.update(self._local_constructor_types(mi, body))

        def visit(node: ast.AST) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner_id = self._by_ast.get(id(node))
                inner = self.nodes.get(inner_id) if inner_id else None
                for dec in node.decorator_list:
                    visit(dec)  # decorators evaluate in the OUTER scope
                if inner is not None:
                    self._extract_scope(mi, node.body, inner,
                                        dict(local_partials), local_types)
                return
            if isinstance(node, ast.ClassDef):
                for item in node.body:
                    visit(item)
                return
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    _last_name(node.value.func) == "partial" and \
                    node.value.args:
                tgt = self.resolve_callable_expr(node.value.args[0], ctx,
                                                 local_partials,
                                                 local_types)
                if tgt is not None:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            local_partials[t.id] = tgt
                    self._add_edge(ctx, tgt, node.lineno, node.value)
            if isinstance(node, ast.Call):
                tgt = self.resolve_callable_expr(node.func, ctx,
                                                 local_partials,
                                                 local_types)
                if tgt is None and _last_name(node.func) == "partial" and \
                        node.args:
                    # bare partial construction: edge to the target (the
                    # partial exists to be called, often out of our sight)
                    tgt = self.resolve_callable_expr(node.args[0], ctx,
                                                     local_partials,
                                                     local_types)
                if tgt is not None:
                    self._add_edge(ctx, tgt, node.lineno, node)
            for child in ast.iter_child_nodes(node):
                visit(child)

        for stmt in body:
            visit(stmt)

    def _add_edge(self, ctx: FuncNode, callee: str, line: int,
                  call: ast.AST) -> None:
        self.edges.setdefault(ctx.node_id, []).append(
            CallSite(callee=callee, path=ctx.path, line=line))
        self._call_targets[id(call)] = callee

    # -- queries -----------------------------------------------------------

    def node_for_ast(self, fn: ast.AST) -> Optional[FuncNode]:
        node_id = self._by_ast.get(id(fn))
        return self.nodes.get(node_id) if node_id else None

    def call_target(self, call: ast.AST) -> Optional[str]:
        """Resolved callee node id of an ``ast.Call`` seen during
        :func:`extract_edges`; None when unresolved."""
        return self._call_targets.get(id(call))

    def callees(self, node_id: str) -> List[CallSite]:
        return self.edges.get(node_id, [])

    def reachable(self, root: str) -> Set[str]:
        """All node ids reachable from ``root`` (cycle-tolerant)."""
        seen: Set[str] = set()
        stack = [root]
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(site.callee for site in self.callees(cur))
        return seen

    # -- may-throw analysis ------------------------------------------------

    def exception_ancestors(self, name: str) -> frozenset:
        """``name`` plus every base class name reachable through scanned
        ``ClassDef`` bases and the builtin exception tree (cycle-safe)."""
        cached = self._ancestor_cache.get(name)
        if cached is not None:
            return cached
        if self._class_bases is None:
            bases: Dict[str, Tuple[str, ...]] = {}
            for mi in self.modules.values():
                for ci in mi.classes.values():
                    names = tuple(n for n in (_last_name(b)
                                              for b in ci.bases) if n)
                    # first definition wins (deterministic: add order)
                    bases.setdefault(ci.name, names)
            self._class_bases = bases
        out: Set[str] = set()
        stack = [name]
        while stack:
            cur = stack.pop()
            if cur in out:
                continue
            out.add(cur)
            stack.extend(self._class_bases.get(cur, ()))
            stack.extend(_BUILTIN_EXC_BASES.get(cur, ()))
        result = frozenset(out)
        self._ancestor_cache[name] = result
        return result

    def handler_catch_names(self, handler: ast.excepthandler
                            ) -> Optional[frozenset]:
        """Exception names one ``except`` clause catches; None means
        catch-all (bare ``except:``, ``except Exception``, or a dynamic
        type expression we cannot name — trusting the latter to catch
        keeps the throw summary an under-approximation)."""
        t = handler.type
        if t is None:
            return None
        elts = t.elts if isinstance(t, ast.Tuple) else [t]
        names = []
        for e in elts:
            n = _last_name(e)
            if n is None:
                return None
            names.append(n)
        if set(names) & _CATCH_ALL:
            return None
        return frozenset(names)

    def exception_catches(self, catch: Optional[frozenset],
                          raised: Optional[str]) -> bool:
        """Does a handler with catch-set ``catch`` absorb a raise of
        ``raised``?  ``catch=None`` is catch-all; ``raised=None`` is an
        unknown-typed throw (only catch-all absorbs it)."""
        if catch is None:
            return True
        if raised is None:
            return False
        return bool(catch & self.exception_ancestors(raised))

    def raised_type_name(self, node: ast.Raise) -> Optional[str]:
        """Exception class name of ``raise X(...)`` / ``raise X`` when
        ``X`` names a class the analysis knows (scanned ``ClassDef`` or
        the builtin table); None for bare re-raise or dynamic raises —
        a proven throw of unknown type."""
        exc = node.exc
        if exc is None:
            return None
        name = _last_name(exc.func if isinstance(exc, ast.Call) else exc)
        if name is None:
            return None
        if self._class_bases is None:
            self.exception_ancestors("Exception")  # builds the map
        if name in self._class_bases or name in _BUILTIN_EXC_BASES or \
                name in _CATCH_ALL:
            return name
        return None

    def _absorbed(self, raised: Optional[str],
                  handlers: Tuple[Tuple[Optional[frozenset], ...], ...]
                  ) -> bool:
        return any(self.exception_catches(c, raised)
                   for level in handlers for c in level)

    def _eval_throws(self, node: FuncNode,
                     summaries: Dict[str, ThrowSummary]) -> ThrowSummary:
        types: Set[str] = set()
        unknown = False
        external = False

        def add_call(call: ast.Call, handlers) -> None:
            nonlocal unknown, external
            tgt = self._call_targets.get(id(call))
            sub = summaries.get(tgt) if tgt else None
            if sub is None:
                if not self._absorbed(None, handlers):
                    external = True
                return
            for t in sub.types:
                if not self._absorbed(t, handlers):
                    types.add(t)
            if (sub.unknown or sub.external) and \
                    not self._absorbed(None, handlers):
                if sub.unknown:
                    unknown = True
                if sub.external:
                    external = True

        def walk(n: ast.AST, handlers) -> None:
            nonlocal unknown, external
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
                return  # nested defs throw when *called*, via their node
            if isinstance(n, ast.Try):
                inner = handlers + (tuple(self.handler_catch_names(h)
                                          for h in n.handlers),) \
                    if n.handlers else handlers
                for s in n.body:
                    walk(s, inner)
                for s in n.orelse:      # else runs after the protected
                    walk(s, handlers)   # region — handlers do not apply
                for h in n.handlers:
                    for s in h.body:
                        walk(s, handlers)
                for s in n.finalbody:
                    walk(s, handlers)
                return
            if isinstance(n, ast.Raise):
                t = self.raised_type_name(n)
                if not self._absorbed(t, handlers):
                    if t is None:
                        unknown = True
                    else:
                        types.add(t)
            elif isinstance(n, ast.Assert):
                if not self._absorbed("AssertionError", handlers):
                    types.add("AssertionError")
            elif isinstance(n, ast.Call):
                add_call(n, handlers)
            for child in ast.iter_child_nodes(n):
                walk(child, handlers)

        fn = node.fn
        body = fn.body if isinstance(fn, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.Module)) else [fn.body]
        for stmt in body:
            walk(stmt, ())
        return ThrowSummary(types=tuple(sorted(types)), unknown=unknown,
                            external=external)

    def compute_throws(self) -> Dict[str, ThrowSummary]:
        """Run (once) and return the per-function may-throw fixpoint:
        node id -> :class:`ThrowSummary`.  Deterministic — nodes are
        iterated sorted and summaries carry sorted tuples."""
        if self._throws is not None:
            return self._throws
        summaries: Dict[str, ThrowSummary] = {
            nid: ThrowSummary() for nid in self.nodes}
        order = sorted(self.nodes)
        # monotone (sets only grow) over a finite lattice; the bound is
        # a backstop, not a tuning knob
        for _ in range(len(order) + 2):
            changed = False
            for nid in order:
                new = self._eval_throws(self.nodes[nid], summaries)
                if new != summaries[nid]:
                    summaries[nid] = new
                    changed = True
            if not changed:
                break
        self._throws = summaries
        return summaries

    def throw_summary(self, node_id: str) -> ThrowSummary:
        return self.compute_throws().get(node_id, ThrowSummary())

    def call_throws(self, call: ast.AST) -> Optional[ThrowSummary]:
        """Throw summary of a call's resolved callee; None when the
        call never resolved (external — low confidence by definition,
        so checks emit no finding for it)."""
        tgt = self._call_targets.get(id(call))
        if tgt is None:
            return None
        return self.compute_throws().get(tgt)


def build_callgraph(files: Iterable[Tuple[str, ast.Module]]) -> CallGraph:
    """Build the whole-package graph over ``(path, parsed module)``."""
    g = CallGraph()
    for path, tree in files:
        g.add_module(path, tree)
    g.extract_edges()
    return g
