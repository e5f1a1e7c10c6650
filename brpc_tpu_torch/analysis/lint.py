"""Framework-invariant AST linter for the Python tier.

The reference enforces its concurrency contracts with purpose-built
tooling (contention profiler, bthread diagnostics, builtin hazard pages);
this is the equivalent static pass for the hazards our fabric creates.
Fourteen checks, each encoding an invariant the runtime cannot enforce,
the concurrency ones interprocedural over the whole-package call graph
(:mod:`brpc_tpu_torch.analysis.callgraph` — the lockdep/TSan polarity: follow
the calls, not the file):

- ``ctypes-contract`` — every ``*.brt_*`` symbol used anywhere must have
  BOTH ``argtypes`` and ``restype`` declared somewhere in the scanned
  tree (``rpc._load()`` is the canonical site).  ctypes defaults an
  undeclared restype to c_int, which silently truncates 64-bit handles
  on the way out of the native core.  Also: a ``CFUNCTYPE`` callback
  passed inline to a ``brt_*`` call is owned by nobody — the native core
  keeps the raw function pointer while Python GCs the closure.
- ``fiber-shared-state`` — methods reachable from a handler registered
  via ``add_service``/``add_async_service`` run concurrently on fiber
  workers (the trampoline releases the GIL across ctypes); any mutation
  of ``self``/module state anywhere in the handler-reachable set — across
  modules, through helpers — must sit inside a ``with self._mu``-style
  block.  Rwlock sides are understood: ``with self._mu.write():`` is an
  exclusive hold, ``with self._mu.read():`` is SHARED and never
  legitimizes mutation.  Thread-local state (``self._local.*``/``*tls*``)
  is exempt.
- ``obs-guard`` — instrumentation outside ``brpc_tpu_torch/obs`` must go
  through the no-op-able helpers (``obs.counter``/``obs.recorder``/
  ``obs.record_span``); constructing reducers or touching the Registry
  directly bypasses the ``enabled()`` gate.
- ``trace-purity`` — no wall-clock reads, ``print``, lock traffic, or
  ``obs`` calls anywhere transitively reachable (through in-package
  helpers) from a function handed to one of torch's tracers:
  ``torch.compile``, ``torch.jit.script``/``torch.jit.trace`` or
  ``torch.cuda.make_graphed_callables`` (as a decorator, through
  ``functools.partial`` or as a call), or from the body of a
  ``with torch.cuda.graph(...)`` capture.  They run once at trace or
  capture time and vanish from the compiled program or the replayed
  graph.  Findings carry the full call chain from the traced root to
  the impure site.  Torch has no counterpart of JAX's host callbacks
  (``jax.debug.print``, ``pure_callback``/``io_callback``), so the
  port's linter has no host-callback hazard class.
  DELIBERATE trace-time effects (e.g. counters of programs built) are
  declared with ``# lint: allow-trace-impure`` on the call line or on
  the helper's ``def`` line — the walk neither flags nor descends
  there.
- ``lock-order`` — the static half of the RACECHECK harness: derives
  the ``with <checked_lock>`` nesting graph over the call graph and
  reports inversion cycles without running anything; the dynamic
  harness (:mod:`brpc_tpu_torch.analysis.race`) becomes the confirmer, not
  the only detector.  ``checked_rwlock`` participates too: both
  ``.read()`` and ``.write()`` contexts acquire under the lock's one
  name, matching the dynamic graph's keying.  Locks resolve through
  module/class/parameter bindings AND literal dict containers at
  module scope (``LOCKS["a"]``) or class scope (``self.LOCKS["a"]``,
  including containers inherited from base classes — the direct class
  bodies along the base chain are walked, nearest assignment wins) —
  constant keys bind by key; dynamic keys and mutated containers stay
  unresolved (dynamic-harness territory).
- ``fiber-blocking-sleep`` — a bare ``time.sleep`` anywhere
  handler-reachable (interprocedural, same walk as
  ``fiber-shared-state``) parks the fiber worker PTHREAD, not just the
  fiber, stalling every handler scheduled on that worker.  The
  sanctioned path is :mod:`brpc_tpu_torch.resilience` (``sleep_ms`` +
  ``Backoff``: deadline-capped, deterministically jittered) — calls
  resolving into that module are not followed, and its own sleeps are
  exempt.
- ``handle-lifecycle`` — every call that returns an OWNING native
  handle (constructors/factories of ``rpc``'s owner classes — Server,
  Channel, PendingCall, CallGroup, Stream, PsShard, DeviceClient,
  DeviceExecutable — plus in-package functions inferred to return a
  fresh one) must, on every normal-flow path, reach its release
  (``close``/``join``/``abort``), be returned to the caller, or be
  stored on an object whose own close-style method releases it
  (ownership transfer, audited through the attr/local/return type
  maps).  Escapes into containers or thread targets are reported;
  deliberate registries carry ``# lint: allow-handle-escape``.  The
  flow analysis is may-leak at explicit exits (an early ``return``
  with a live handle is THE classic leak) and trusts a release seen on
  any branch (the guard idiom) — no false positives from merges.
  Exception paths are fully in scope: a handle acquired and still
  live at an explicit ``raise`` is a leak unless a ``finally``, a
  ``with``, or an enclosing ``except`` handler that actually covers
  the raised type releases it — handler trust is SCOPED to the
  statements inside the handler's own ``try`` and to the exception
  types it can catch (resolved through the in-package class hierarchy
  plus the builtin exception tree), replacing the old
  context-insensitive trust.  The deferred dataflow is closed too:
  handles appended into a local container become a tracked may-leak
  set (drained by iterating-and-releasing, discharged by returning or
  storing the container; ``# lint: allow-handle-escape`` on the append
  still marks a deliberate registry), rebinding a name over an
  un-released handle (``h = new(); h = other``) is flagged as a drop
  of the first obligation, and module-scope producer assignments are
  audited like attrs (some function in the module must release the
  global, or the singleton is declared with the pragma).  The
  ABI half audits ``rpc._load()``'s restype
  registry itself: every ``c_void_p``-returning constructor symbol
  needs its destroy symbol declared.  The dynamic complement is the
  handle ledger (:mod:`brpc_tpu_torch.analysis.handles`,
  ``BRPC_TPU_HANDLECHECK=1``).
- ``exception-flow`` — the interprocedural half of exception-safe
  handle lifecycle, built on the may-throw fixpoint in
  :mod:`brpc_tpu_torch.analysis.callgraph`: every in-package function gets a
  summary of the exception types it can raise (explicit ``raise`` and
  ``assert`` propagated through resolved call edges, with
  ``except``-guarded calls absorbing what their handlers can catch),
  and a live handle at a call site whose callee PROVABLY may throw is
  an exit — a leak on the unwinding edge unless an enclosing
  ``finally``/``with`` or a handler covering that call (and that
  thrown type) releases it.  Unresolvable/external callees carry a
  low-confidence ``external`` bit and are deliberately silent, so a
  finding never rests on a false chain.
- ``lock-exception-safety`` — same machinery pointed at locks and
  obligations: a ``checked_lock``/``checked_rwlock`` acquired
  manually (``.acquire()`` outside ``with``) and still held across a
  may-throw site is left locked forever on the unwinding edge unless
  a ``finally`` (or a covering handler) releases it; and a fence-flag
  obligation (``self._x = True`` … ``self._x = False`` in the same
  block) with a may-throw site between set and reset unwinds
  half-done unless the reset sits in a ``finally``.  No pragma
  escape — these are fixed, not baselined.
- ``wire-contract`` — frame-schema symmetry and parse-path bounds for
  every hand-rolled framing: ``_pack_X``/``_unpack_X`` pairs must move
  the same field stream (order + width), every site registered in
  :mod:`brpc_tpu_torch.wire`'s schema registry must match its declared
  scalar sequence (exactly for dedicated functions; shared multi-frame
  handlers like ``_serve_control`` are checked by **exact segmented
  matching** — each schema binds to its dispatch-discriminant branch
  via the schema's ``segments`` declaration and that branch's stream
  must equal the schema exactly; shared reads BEFORE the dispatch
  branch — ``_serve``'s header — are declared per-site with the
  schema's ``prebranch`` field and prepended to the branch stream for
  the exact comparison, stale declarations included, leaving in-order
  subsequence only for shared sites with no segment key), struct
  formats must
  be
  explicit little-endian, counts/lengths read off the wire on
  handler-reachable parse paths must reach a bounds check before they
  drive a size/loop, and every declared schema/text parser must have a
  fuzz target (:mod:`brpc_tpu_torch.analysis.fuzz` — the "fuzzers for every
  parser" gate).  The dynamic complement is the structure-aware fuzzer
  itself.
- ``wire-contract-native`` / ``native-errors`` /
  ``native-handle-balance`` / ``native-endian`` — the cross-language tier
  (:mod:`brpc_tpu_torch.analysis.native`): a clang-free tokenizer +
  function-body extractor over ``cpp/capi/*.cc`` checks every
  ``wire.REGISTRY`` schema with a declared ``native_sites`` twin
  field-for-field against the C++ parser's extracted read sequence
  (widths, order, literal offsets, count-before-bounds, magic
  sentinels; stale site declarations and undeclared native parsers are
  findings too), resolves every ``SetFailed`` constant against
  ``errors.h``/errno and holds serve-path handlers to the live
  fuzzer's sanctioned code set (static/dynamic parity), and flags
  ``handle_inc`` ledger bumps left unbalanced on native error-return
  paths.  ``native-endian`` closes the byte-order hole: every native
  parser a schema claims whose extracted read stream contains a
  multi-byte scalar must be covered by a runtime parity-fuzz target
  (cross-checked against :func:`brpc_tpu_torch.analysis.fuzz.coverage_map`),
  so an endianness mismatch cannot hide in a parser no fuzzer drives.
  These run only when the scan covers the real package (the
  native tree is located relative to ``brpc_tpu_torch/``).

Findings carry a stable id (hash of check + package-relative path +
message, deliberately line-free) so CI can diff against an accepted
baseline (``--baseline FILE`` suppresses known ids; ``--write-baseline``
emits one).

Entry points: :func:`run_lint` (in-process, returns findings) and
:func:`main` (the ``python -m brpc_tpu_torch.analysis`` CLI; exit 0 = clean,
1 = findings, 2 = usage error — unknown ``--check`` names are rejected
with the valid set listed).
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import hashlib
import json
import os
import sys
from typing import (Dict, Iterable, List, Optional, Sequence, Set, Tuple)

from brpc_tpu_torch.analysis.callgraph import (CallGraph, FuncNode,
                                         build_callgraph)

__all__ = ["Finding", "run_lint", "lint_files", "main", "ALL_CHECKS",
           "load_baseline", "apply_baseline"]

ALL_CHECKS = ("ctypes-contract", "fiber-shared-state", "obs-guard",
              "trace-purity", "lock-order", "fiber-blocking-sleep",
              "handle-lifecycle", "exception-flow",
              "lock-exception-safety", "wire-contract",
              "wire-contract-native", "native-errors",
              "native-handle-balance", "native-endian")

#: checks implemented by the cross-language tier (analysis.native)
_NATIVE_CHECKS = ("wire-contract-native", "native-errors",
                  "native-handle-balance", "native-endian")

#: checks that need the whole-package call graph
_GRAPH_CHECKS = {"fiber-shared-state", "trace-purity", "lock-order",
                 "fiber-blocking-sleep", "handle-lifecycle",
                 "exception-flow", "lock-exception-safety",
                 "wire-contract"}

#: attribute names that look like a lock on self / a module
_LOCKISH = ("mu", "lock", "mutex")
#: rwlock side methods (checked_rwlock's read()/write() contexts)
_RW_SIDES = ("read", "write")
#: container methods that mutate their receiver in place
_MUTATORS = {
    "append", "appendleft", "extend", "insert", "remove", "pop", "popleft",
    "clear", "update", "setdefault", "add", "discard", "sort", "reverse",
}
#: obs surface that hot paths must NOT touch directly (the no-op-able
#: helpers counter/recorder/record_span/span/enabled stay allowed)
_OBS_GUARDED = {
    "Registry", "default_registry", "expose", "Adder", "Maxer", "Miner",
    "LatencyRecorder", "Window", "PerSecond", "PassiveStatus",
}
#: torch's tracers, as the tails of dotted names ("torch.jit.script"
#: and "jit.script" both end in ("jit", "script")): a function handed to
#: one runs once at trace time.  A bare ``compile`` is the builtin.
_TRACERS = {("torch", "compile"), ("jit", "script"), ("jit", "trace"),
            ("make_graphed_callables",)}
#: capture contexts: the body of ``with torch.cuda.graph(g):`` runs once
#: at capture; a replay runs only the kernels it recorded
_CAPTURES = {("cuda", "graph")}
#: how findings name the tracers
_TRACED_BY = "torch.compile/torch.jit/CUDA graph capture"
_TIME_FNS = {"time", "time_ns", "monotonic", "monotonic_ns",
             "perf_counter", "perf_counter_ns", "sleep"}
#: pragma declaring DELIBERATE trace-time impurity: on a call line, the
#: call is neither flagged nor followed from traced roots; on a `def`
#: line, traced walks never descend into that function (the canonical
#: use: trace-time instrumentation like collective program counters,
#: which by design runs once per trace and must not be reported as a
#: vanishing side effect)
_ALLOW_TRACE_IMPURE = "lint: allow-trace-impure"
#: pragma declaring a DELIBERATE handle escape (a managed registry /
#: fan-out set whose owner releases its members out of the static
#: check's sight) — suppresses handle-lifecycle escape/leak findings on
#: that line
_ALLOW_HANDLE_ESCAPE = "lint: allow-handle-escape"

# ---- handle-lifecycle owner tables -----------------------------------------
# Owning native-handle classes of brpc_tpu_torch.rpc (each wraps a brt_* handle
# that MUST be explicitly destroyed) -> the methods that release it.  The
# table mirrors rpc._load()'s restype registry: every class here fronts a
# brt_* constructor declared with a c_void_p restype (the ABI-pairing
# sub-check below keeps that registry itself paired new<->destroy).
_HANDLE_OWNERS: Dict[str, frozenset] = {
    "Server": frozenset({"close"}),
    "Channel": frozenset({"close"}),
    "PendingCall": frozenset({"join", "close"}),
    "CallGroup": frozenset({"close"}),
    "Stream": frozenset({"close", "abort"}),
    "PsShard": frozenset({"close"}),
    "DeviceClient": frozenset({"close"}),
    "DeviceExecutable": frozenset({"close"}),
}
#: factory methods returning a FRESH owning handle: (class, method) ->
#: produced owner class
_HANDLE_FACTORIES = {
    ("Channel", "call_async"): "PendingCall",
    ("Channel", "stream"): "Stream",
    ("DeviceClient", "compile"): "DeviceExecutable",
}
#: method-NAME fallback for receivers the type maps cannot resolve
#: (`self.channels[s].call_async(...)`): the name is unambiguous enough
#: to imply ownership even without a resolved receiver
_FACTORY_NAME_FALLBACK = {"call_async": "PendingCall"}
#: methods whose body counts as "releases what self.<attr> holds" for
#: the ownership-transfer audit of attr-stored handles
_RELEASEISH_METHODS = {"close", "stop", "shutdown", "abort", "__exit__",
                       "__del__", "clear", "reset"}
#: ABI pairing for c_void_p-returning symbols that don't follow the
#: brt_X_new -> brt_X_destroy naming rule
_ABI_NEW_PAIRS = {
    "brt_channel_call_start": "brt_call_destroy",
    "brt_channel_call_start_opts": "brt_call_destroy",
    "brt_device_compile": "brt_device_executable_destroy",
    "brt_mlir_module": "brt_free",
    "brt_debug_handle_counts": "brt_free",
}


def _stable_path(path: str) -> str:
    """Package-relative posix path (machine-independent id component).
    Native-tier findings anchor on ``cpp/`` the same way Python ones
    anchor on ``brpc_tpu_torch/``."""
    parts = os.path.normpath(path).replace(os.sep, "/").split("/")
    for anchor in ("brpc_tpu_torch", "cpp"):
        if anchor in parts:
            return "/".join(parts[parts.index(anchor):])
    return parts[-1]


@dataclasses.dataclass
class Finding:
    check: str
    path: str
    line: int
    message: str
    #: stable id: hash over check + package-relative path + message (no
    #: line number, so pure drift doesn't churn baselines)
    id: str = ""

    def __post_init__(self) -> None:
        if not self.id:
            raw = f"{self.check}|{_stable_path(self.path)}|{self.message}"
            self.id = hashlib.sha1(raw.encode()).hexdigest()[:12]

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.check}:{self.id}] " \
               f"{self.message}"

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# small AST helpers
# ---------------------------------------------------------------------------

def _last_name(expr: ast.AST) -> Optional[str]:
    """'jax.jit' -> 'jit', 'jit' -> 'jit', else None."""
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def _root_name(expr: ast.AST) -> Optional[str]:
    """'a.b.c' -> 'a' (the base Name of a dotted chain)."""
    while isinstance(expr, (ast.Attribute, ast.Subscript)):
        expr = expr.value
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def _is_self_rooted(expr: ast.AST) -> bool:
    return _root_name(expr) == "self"


def _is_tls_path(expr: ast.AST) -> bool:
    """True for thread-local chains (``self._local.cell``) — per-thread
    state needs no lock."""
    while isinstance(expr, (ast.Attribute, ast.Subscript)):
        if isinstance(expr, ast.Attribute):
            low = expr.attr.lower()
            if "local" in low or "tls" in low:
                return True
        expr = expr.value
    return False


def _is_lockish_ctx(expr: ast.AST) -> bool:
    """True for `with self._mu:` / `with _load_mu:` style context exprs,
    including rwlock sides (`with self._mu.read():` / `.write()`)."""
    name = None
    if isinstance(expr, ast.Attribute):
        name = expr.attr
    elif isinstance(expr, ast.Name):
        name = expr.id
    elif isinstance(expr, ast.Call):
        f = expr.func
        if isinstance(f, ast.Attribute) and f.attr in _RW_SIDES:
            # with self._mu.read()/.write(): lockish iff the receiver is
            return _is_lockish_ctx(f.value)
        # with self._mu.acquire_timeout(...) style — treat lock method
        # calls on a lockish receiver as lock context too
        return _is_lockish_ctx(f)
    if name is None:
        return False
    low = name.lower()
    return any(part in low for part in _LOCKISH)


def _lock_ctx_kind(expr: ast.AST) -> Optional[str]:
    """Classify a with-item context: ``"lock"`` for exclusive holds
    (plain locks, rwlock ``.write()``), ``"read"`` for the SHARED rwlock
    side, ``None`` for non-lock contexts.  The distinction matters to
    `fiber-shared-state`: a read-side hold serializes against writers but
    not against sibling readers, so it must never legitimize mutation."""
    if not _is_lockish_ctx(expr):
        return None
    if isinstance(expr, ast.Call) and \
            isinstance(expr.func, ast.Attribute) and \
            expr.func.attr == "read":
        return "read"
    return "lock"


def _describe(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - unparse of synthetic nodes
        return "<expr>"


def _local_binds(fn: ast.AST) -> Set[str]:
    """Names bound locally inside ``fn`` (params, plain assigns, loop and
    with targets) — these shadow module globals for the shared-state
    check."""
    out: Set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in (list(args.posonlyargs) + list(args.args) +
                  list(args.kwonlyargs)):
            out.add(a.arg)
        if args.vararg:
            out.add(args.vararg.arg)
        if args.kwarg:
            out.add(args.kwarg.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Global):
            out -= set(node.names)  # `global x` un-shadows
            continue
        tgt_lists: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            tgt_lists = list(node.targets)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            tgt_lists = [node.target]
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            tgt_lists = [node.target]
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            tgt_lists = [i.optional_vars for i in node.items
                         if i.optional_vars is not None]
        for tgt in tgt_lists:
            if isinstance(tgt, ast.Name):
                out.add(tgt.id)
            elif isinstance(tgt, (ast.Tuple, ast.List)):
                for leaf in ast.walk(tgt):
                    if isinstance(leaf, ast.Name):
                        out.add(leaf.id)
    return out


def _node_display(node: FuncNode) -> str:
    if node.cls is not None:
        return f"{node.cls}.{node.name}"
    if node.qual == "<module>":
        return f"{node.module}:<module>"
    return node.qual


# ---------------------------------------------------------------------------
# per-file scan state
# ---------------------------------------------------------------------------

class _FileScan:
    """One parsed file plus everything the checks extract from it."""

    def __init__(self, path: str, tree: ast.Module,
                 src_lines: Optional[List[str]] = None):
        self.path = path
        self.tree = tree
        self.src_lines = src_lines or []
        # ctypes-contract
        self.native_decls: Dict[str, Set[str]] = {}  # brt_x -> declared kinds
        self.native_uses: List[Tuple[str, int]] = []  # (brt_x, line)
        # brt_x -> (restype name, decl line) — the restype registry the
        # handle-lifecycle ABI-pairing sub-check audits
        self.native_restypes: Dict[str, Tuple[str, int]] = {}
        self.cfunctype_protos: Set[str] = set()
        # obs-guard bookkeeping: names bound to obs modules / obs imports
        self.obs_module_aliases: Set[str] = set()
        self.obs_imported_names: Set[str] = set()
        self._collect()

    def _collect(self) -> None:
        decl_nodes: Set[int] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    self._note_decl(tgt, node.value, decl_nodes)
                if isinstance(node.value, ast.Call) and \
                        _last_name(node.value.func) == "CFUNCTYPE":
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            self.cfunctype_protos.add(tgt.id)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.endswith(".obs") or ".obs." in alias.name:
                        self.obs_module_aliases.add(
                            alias.asname or alias.name.split(".")[-1])
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if mod == "brpc_tpu_torch" or mod.endswith(".obs"):
                    for alias in node.names:
                        if alias.name == "obs" or mod.endswith(".obs"):
                            tgt = alias.asname or alias.name
                            if alias.name == "obs":
                                self.obs_module_aliases.add(tgt)
                            else:
                                self.obs_imported_names.add(tgt)
                elif ".obs." in mod or mod.startswith("obs."):
                    for alias in node.names:
                        self.obs_imported_names.add(alias.asname or alias.name)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Attribute) and \
                    node.attr.startswith("brt_") and id(node) not in decl_nodes:
                self.native_uses.append((node.attr, node.lineno))

    def _note_decl(self, tgt: ast.AST, value: ast.AST,
                   decl_nodes: Set[int]) -> None:
        if isinstance(tgt, ast.Attribute) and \
                tgt.attr in ("argtypes", "restype") and \
                isinstance(tgt.value, ast.Attribute) and \
                tgt.value.attr.startswith("brt_"):
            self.native_decls.setdefault(tgt.value.attr, set()).add(tgt.attr)
            decl_nodes.add(id(tgt.value))
            if tgt.attr == "restype":
                rname = _last_name(value)
                if rname is not None:
                    self.native_restypes[tgt.value.attr] = (rname,
                                                            tgt.lineno)

    def line_has(self, lineno: int, marker: str) -> bool:
        if 1 <= lineno <= len(self.src_lines):
            return marker in self.src_lines[lineno - 1]
        return False


# ---------------------------------------------------------------------------
# check: ctypes-contract
# ---------------------------------------------------------------------------

def _check_ctypes_contract(scans: List[_FileScan]) -> List[Finding]:
    findings: List[Finding] = []
    decls: Dict[str, Set[str]] = {}
    for sc in scans:
        for name, kinds in sc.native_decls.items():
            decls.setdefault(name, set()).update(kinds)
    reported: Set[Tuple[str, str]] = set()
    for sc in scans:
        for name, line in sc.native_uses:
            have = decls.get(name, set())
            missing = [k for k in ("argtypes", "restype") if k not in have]
            if not missing or (name, sc.path) in reported:
                continue
            reported.add((name, sc.path))
            findings.append(Finding(
                "ctypes-contract", sc.path, line,
                f"native symbol '{name}' used without "
                f"{' and '.join(missing)} declared anywhere in the scanned "
                f"tree (ctypes defaults restype to c_int — 64-bit handles "
                f"truncate); declare it in rpc._load()"))
    for sc in scans:
        findings.extend(_check_cfunctype_pinning(sc))
    return findings


def _check_cfunctype_pinning(sc: _FileScan) -> List[Finding]:
    protos = sc.cfunctype_protos
    if not protos:
        return []
    findings: List[Finding] = []
    # 1) inline construction passed straight to the native core (one walk
    #    over the whole tree so each call site reports exactly once)
    for node in ast.walk(sc.tree):
        if not isinstance(node, ast.Call):
            continue
        fn_last = _last_name(node.func)
        if fn_last is None or not fn_last.startswith("brt_"):
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Call) and _last_name(arg.func) in protos:
                findings.append(Finding(
                    "ctypes-contract", sc.path, arg.lineno,
                    f"CFUNCTYPE callback constructed inline in a "
                    f"'{fn_last}' call — nothing owns it and the GC frees "
                    f"it under the native core's feet; store it on the "
                    f"owner object first"))
    # 2) named callbacks passed to the native core but never pinned.
    #    Callbacks are attributed to the scope that DIRECTLY defines them;
    #    pinning/passing is searched through that whole scope subtree.
    #    MODULE-scope callbacks are exempt: a module-level name is held by
    #    the module namespace for the life of the process — it cannot be
    #    GC'd under the native core (only function locals can).
    scopes: List[ast.AST] = [
        n for n in ast.walk(sc.tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for scope in scopes:
        callbacks = _callback_locals_shallow(scope, protos)
        if not callbacks:
            continue
        passed_to_native: Dict[str, int] = {}
        pinned: Set[str] = set()
        # `global X; X = cb` pins on the module namespace — as immortal
        # as self.<attr> on a long-lived owner.
        declared_global: Set[str] = set()
        for node in ast.walk(scope):
            if isinstance(node, ast.Global):
                declared_global.update(node.names)
        for node in ast.walk(scope):
            if isinstance(node, ast.Call):
                fn_last = _last_name(node.func)
                is_native = fn_last is not None and fn_last.startswith("brt_")
                for arg in list(node.args) + \
                        [kw.value for kw in node.keywords]:
                    if isinstance(arg, ast.Name) and arg.id in callbacks:
                        if is_native:
                            passed_to_native.setdefault(arg.id, arg.lineno)
                        else:
                            # arg of append()/add()/...: the owner keeps it
                            pinned.add(arg.id)
            elif isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id in callbacks:
                for tgt in node.targets:
                    if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                        pinned.add(node.value.id)
                    elif isinstance(tgt, ast.Name) and \
                            tgt.id in declared_global:
                        pinned.add(node.value.id)
        for name, line in sorted(passed_to_native.items()):
            if name not in pinned:
                findings.append(Finding(
                    "ctypes-contract", sc.path, line,
                    f"CFUNCTYPE callback '{name}' is passed to the native "
                    f"core but never pinned on an owner object "
                    f"(self.<attr> = {name} or self.<list>.append({name})) "
                    f"— it is GC'd while the core still holds the pointer"))
    return findings


def _callback_locals_shallow(scope: ast.AST, protos: Set[str]
                             ) -> Dict[str, int]:
    """Callback names defined as DIRECT children of the scope (nested
    function scopes audit their own callbacks)."""
    out: Dict[str, int] = {}
    body = scope.body if hasattr(scope, "body") else []
    for node in body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and _last_name(node.value.func) in protos:
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out[tgt.id] = node.lineno
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if _last_name(dec) in protos:
                    out[node.name] = node.lineno
    return out


# ---------------------------------------------------------------------------
# check: fiber-shared-state (interprocedural over the call graph)
# ---------------------------------------------------------------------------

def _find_handler_roots(sc: _FileScan, graph: CallGraph,
                        top: Optional[FuncNode],
                        register_names: Tuple[str, ...] = (
                            "add_service", "add_async_service"),
                        ) -> List[str]:
    """Node ids of handlers registered via add_service/add_async_service
    anywhere in this file (``self.X`` methods, bare function names,
    partial targets).  ``register_names`` widens the registration set
    (the wire-contract check also treats ``add_ps_service`` /
    ``add_stream_handler`` trampoline targets as hostile-input roots)."""
    roots: List[str] = []

    def visit(node: ast.AST, ctx: Optional[FuncNode]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inner = graph.node_for_ast(node)
            for child in ast.iter_child_nodes(node):
                visit(child, inner or ctx)
            return
        if isinstance(node, ast.Call) and ctx is not None and \
                _last_name(node.func) in register_names:
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                tgt = graph.resolve_callable_expr(arg, ctx)
                if tgt is not None:
                    roots.append(tgt)
        for child in ast.iter_child_nodes(node):
            visit(child, ctx)

    visit(sc.tree, top)
    return roots


def _check_fiber_shared_state(scans: List[_FileScan],
                              graph: CallGraph) -> List[Finding]:
    sc_by_path = {sc.path: sc for sc in scans}
    mi_by_path = {mi.path: mi for mi in graph.modules.values()}
    roots: List[str] = []
    for sc in scans:
        mi = mi_by_path.get(sc.path)
        top = graph.nodes.get(f"{mi.name}:<module>") if mi else None
        roots.extend(_find_handler_roots(sc, graph, top))
    findings: List[Finding] = []
    visited: Set[Tuple[str, bool]] = set()
    queue: List[Tuple[str, bool, Tuple[str, ...]]] = [
        (r, False, (_node_display(graph.nodes[r]),))
        for r in roots if r in graph.nodes]
    while queue:
        node_id, locked, chain = queue.pop()
        if (node_id, locked) in visited:
            continue
        visited.add((node_id, locked))
        node = graph.nodes.get(node_id)
        if node is None or node.path not in sc_by_path:
            continue
        _scan_shared_state(sc_by_path[node.path], graph, node, locked,
                           chain, queue, findings)
    return findings


def _scan_shared_state(sc: _FileScan, graph: CallGraph, node: FuncNode,
                       locked0: bool, chain: Tuple[str, ...],
                       queue: List[Tuple[str, bool, Tuple[str, ...]]],
                       findings: List[Finding]) -> None:
    fn = node.fn
    mi = graph.modules[node.module]
    display = _node_display(node)
    global_names = {name for n in ast.walk(fn) if isinstance(n, ast.Global)
                    for name in n.names}
    mod_state = (mi.module_globals - _local_binds(fn)) | global_names
    # A constructor mutating its OWN self is initializing an object no
    # other fiber can see yet (publication happens after __init__
    # returns) — never a race.  Module-state mutation in a reachable
    # __init__ still counts.
    fresh_self = node.name == "__init__"

    def mutation(n: ast.AST, what: str, in_read: bool = False) -> None:
        via = ""
        if len(chain) > 1:
            via = f" [reached via {' -> '.join(chain)}]"
        hint = (" (a read-side `.read()` hold is SHARED — sibling "
                "readers run concurrently; mutation needs the write "
                "side)" if in_read else "")
        findings.append(Finding(
            "fiber-shared-state", sc.path, n.lineno,
            f"handler-reachable {display} mutates {what} outside a "
            f"`with self._mu` block{hint} — handlers run concurrently on "
            f"fiber workers (the ctypes trampoline releases the GIL)"
            f"{via}"))

    def scan(n: ast.AST, locked: bool, in_read: bool = False) -> None:
        if isinstance(n, (ast.With, ast.AsyncWith)):
            kinds = [_lock_ctx_kind(item.context_expr) for item in n.items]
            now_locked = locked or "lock" in kinds
            now_read = (in_read or "read" in kinds) and not now_locked
            for item in n.items:
                scan(item.context_expr, locked, in_read)
            for child in n.body:
                scan(child, now_locked, now_read)
            return
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            return  # nested defs get their own audit when reachable
        if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for tgt in targets:
                if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                    if _is_tls_path(tgt) or locked:
                        continue
                    if node.cls is not None and _is_self_rooted(tgt):
                        if not fresh_self:
                            mutation(tgt, _describe(tgt), in_read)
                    else:
                        root = _root_name(tgt)
                        if root is not None and root in mod_state:
                            mutation(tgt, f"module state "
                                          f"'{_describe(tgt)}'", in_read)
                elif isinstance(tgt, ast.Name) and tgt.id in global_names \
                        and not locked:
                    mutation(tgt, f"module global '{tgt.id}'", in_read)
        if isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Attribute) and not locked:
                if f.attr == "at" and n.args and not _is_tls_path(n.args[0]):
                    # np.<ufunc>.at(self.table, ...) mutates in place
                    if node.cls is not None and _is_self_rooted(n.args[0]):
                        if not fresh_self:
                            mutation(n, _describe(n.args[0]), in_read)
                    elif isinstance(n.args[0], ast.Name) and \
                            n.args[0].id in mod_state:
                        mutation(n, f"module state '{n.args[0].id}'",
                                 in_read)
                elif f.attr in _MUTATORS and not _is_tls_path(f.value) \
                        and graph.call_target(n) is None:
                    # A receiver whose method RESOLVES in the call graph
                    # (attr-type/local-type map) is not a raw container:
                    # the interprocedural walk below analyzes the callee's
                    # body — its own mutations get checked against its own
                    # locking, so the heuristic must not double-report
                    # (e.g. an internally-synchronized combiner's .add()).
                    if node.cls is not None and _is_self_rooted(f.value):
                        if not fresh_self:
                            mutation(n, f"{_describe(f.value)} "
                                        f"(via .{f.attr}())", in_read)
                    elif isinstance(f.value, ast.Name) and \
                            f.value.id in mod_state:
                        mutation(n, f"module state '{f.value.id}' "
                                    f"(via .{f.attr}())", in_read)
            tgt = graph.call_target(n)
            if tgt is not None and tgt in graph.nodes:
                # Lock context propagates through calls; a read-side hold
                # does NOT (the callee's mutations still race siblings).
                queue.append((tgt, locked,
                              chain + (_node_display(graph.nodes[tgt]),)))
        for child in ast.iter_child_nodes(n):
            scan(child, locked, in_read)

    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for child in body:
        scan(child, locked0)


# ---------------------------------------------------------------------------
# check: fiber-blocking-sleep (interprocedural over the call graph)
# ---------------------------------------------------------------------------

def _is_sanctioned_sleep_module(path: str) -> bool:
    """The resilience module OWNS blocking sleeps (``sleep_ms`` /
    ``Backoff`` — deadline-capped, deterministically jittered); its
    internals are exempt and calls resolving into it are not followed."""
    return _stable_path(path).startswith("brpc_tpu_torch/resilience")


def _time_sleep_aliases(sc: _FileScan) -> Tuple[Set[str], Set[str]]:
    """(module aliases of ``time``, bare names bound to ``time.sleep``)
    in this file."""
    mods: Set[str] = set()
    bares: Set[str] = set()
    for node in ast.walk(sc.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "time":
                    mods.add(alias.asname or "time")
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            for alias in node.names:
                if alias.name == "sleep":
                    bares.add(alias.asname or "sleep")
    return mods, bares


def _check_fiber_blocking_sleep(scans: List[_FileScan],
                                graph: CallGraph) -> List[Finding]:
    sc_by_path = {sc.path: sc for sc in scans}
    mi_by_path = {mi.path: mi for mi in graph.modules.values()}
    aliases: Dict[str, Tuple[Set[str], Set[str]]] = {}
    roots: List[str] = []
    for sc in scans:
        mi = mi_by_path.get(sc.path)
        top = graph.nodes.get(f"{mi.name}:<module>") if mi else None
        roots.extend(_find_handler_roots(sc, graph, top))
    findings: List[Finding] = []
    visited: Set[str] = set()
    queue: List[Tuple[str, Tuple[str, ...]]] = [
        (r, (_node_display(graph.nodes[r]),))
        for r in roots if r in graph.nodes]
    while queue:
        node_id, chain = queue.pop()
        if node_id in visited:
            continue
        visited.add(node_id)
        node = graph.nodes.get(node_id)
        if node is None or node.path not in sc_by_path:
            continue
        if _is_sanctioned_sleep_module(node.path):
            continue
        sc = sc_by_path[node.path]
        if sc.path not in aliases:
            aliases[sc.path] = _time_sleep_aliases(sc)
        time_mods, sleep_bares = aliases[sc.path]
        display = _node_display(node)

        def flag(n: ast.AST, desc: str) -> None:
            via = f" [reached via {' -> '.join(chain)}]" \
                if len(chain) > 1 else ""
            findings.append(Finding(
                "fiber-blocking-sleep", sc.path, n.lineno,
                f"handler-reachable {display} calls {desc} — it parks "
                f"the fiber worker PTHREAD (not just the fiber), "
                f"stalling every handler scheduled on it; use "
                f"brpc_tpu_torch.resilience sleep_ms/Backoff (deadline-capped "
                f"backoff) or an event wait{via}"))

        def scan(n: ast.AST) -> None:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
                return  # nested defs audit when reachable themselves
            if isinstance(n, ast.Call):
                f = n.func
                if isinstance(f, ast.Attribute) and f.attr == "sleep" \
                        and _root_name(f) in time_mods:
                    flag(n, f"{_describe(f)}()")
                elif isinstance(f, ast.Name) and f.id in sleep_bares:
                    flag(n, f"{f.id}() (imported from time)")
                tgt = graph.call_target(n)
                if tgt is not None and tgt in graph.nodes and \
                        not _is_sanctioned_sleep_module(
                            graph.nodes[tgt].path):
                    queue.append(
                        (tgt, chain + (_node_display(graph.nodes[tgt]),)))
            for child in ast.iter_child_nodes(n):
                scan(child)

        body = node.fn.body if isinstance(node.fn.body, list) \
            else [node.fn.body]
        for child in body:
            scan(child)
    return findings


# ---------------------------------------------------------------------------
# check: obs-guard
# ---------------------------------------------------------------------------

def _in_pkg_dir(path: str, dirname: str) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    return dirname in parts


def _check_obs_guard(sc: _FileScan) -> List[Finding]:
    if _in_pkg_dir(sc.path, "obs"):
        return []  # the obs package itself owns the Registry
    findings: List[Finding] = []
    for node in ast.walk(sc.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        hit: Optional[str] = None
        if isinstance(fn, ast.Name) and fn.id in _OBS_GUARDED and \
                fn.id in sc.obs_imported_names:
            hit = fn.id
        elif isinstance(fn, ast.Attribute) and fn.attr in _OBS_GUARDED:
            root = _root_name(fn)
            if root in sc.obs_module_aliases:
                hit = f"{root}.{fn.attr}"
            elif fn.attr == "expose" and isinstance(fn.value, ast.Call) and \
                    _last_name(fn.value.func) in _OBS_GUARDED:
                hit = f"{_describe(fn.value.func)}().expose"
        if hit:
            findings.append(Finding(
                "obs-guard", sc.path, node.lineno,
                f"direct obs call '{hit}' outside brpc_tpu_torch/obs — "
                f"hot-path instrumentation must use the no-op-able helpers "
                f"(obs.counter / obs.recorder / obs.record_span) so "
                f"disabling observability disables the cost"))
    return findings


# ---------------------------------------------------------------------------
# check: trace-purity (interprocedural over the call graph)
# ---------------------------------------------------------------------------

def _dotted_tail_in(expr: ast.AST, tails: Set[Tuple[str, ...]]) -> bool:
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
    parts.reverse()
    return any(tuple(parts[-len(t):]) == t for t in tails
               if len(parts) >= len(t))


def _is_tracer_expr(expr: ast.AST) -> bool:
    return _dotted_tail_in(expr, _TRACERS)


def _is_tracing_decorator(dec: ast.AST) -> bool:
    if _is_tracer_expr(dec):
        return True
    if isinstance(dec, ast.Call):
        if _is_tracer_expr(dec.func):
            return True  # @torch.compile(mode=...)
        if _last_name(dec.func) == "partial" and dec.args and \
                _is_tracer_expr(dec.args[0]):
            return True  # @partial(torch.compile, ...)
    return False


def _is_capture_block(node: ast.AST) -> bool:
    return isinstance(node, (ast.With, ast.AsyncWith)) and any(
        isinstance(item.context_expr, ast.Call)
        and _dotted_tail_in(item.context_expr.func, _CAPTURES)
        for item in node.items)


def _traced_functions(tree: ast.Module) -> List[ast.AST]:
    traced: List[ast.AST] = []
    by_name: Dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name[node.name] = node
            if any(_is_tracing_decorator(d) for d in node.decorator_list):
                traced.append(node)
        elif isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Lambda):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    by_name[tgt.id] = node.value
    for node in ast.walk(tree):
        if _is_capture_block(node):
            traced.append(node)  # with torch.cuda.graph(g): <body>
        if isinstance(node, ast.Call) and _is_tracer_expr(node.func) \
                and node.args:
            arg = node.args[0]
            # make_graphed_callables takes a callable or a tuple of them
            args = arg.elts if isinstance(arg, ast.Tuple) else [arg]
            for arg in args:
                if isinstance(arg, ast.Lambda):
                    traced.append(arg)
                elif isinstance(arg, ast.Name) and arg.id in by_name:
                    traced.append(by_name[arg.id])
    # dedup while keeping order
    seen: Set[int] = set()
    out = []
    for fn in traced:
        if id(fn) not in seen:
            seen.add(id(fn))
            out.append(fn)
    return out


def _check_trace_purity(scans: List[_FileScan],
                        graph: CallGraph) -> List[Finding]:
    findings: List[Finding] = []
    sc_by_path = {sc.path: sc for sc in scans}
    for sc in scans:
        for fn in _traced_functions(sc.tree):
            root_name = getattr(fn, "name", "<capture>"
                                if _is_capture_block(fn) else "<lambda>")
            _walk_traced(sc, fn, root_name, graph, sc_by_path, findings)
    return findings


def _walk_traced(root_sc: _FileScan, root_fn: ast.AST, root_name: str,
                 graph: CallGraph, sc_by_path: Dict[str, _FileScan],
                 findings: List[Finding]) -> None:
    scanned: Set[int] = set()
    visited_nodes: Set[str] = set()
    # (fn ast, owning scan, display name, chain from the traced root)
    stack: List[Tuple[ast.AST, _FileScan, str, Tuple[str, ...]]] = [
        (root_fn, root_sc, root_name, (root_name,))]

    def impure(sc: _FileScan, node: ast.AST, name: str,
               chain: Tuple[str, ...], what: str) -> None:
        if len(chain) > 1:
            where = (f"{what} inside '{name}' reached from traced "
                     f"'{root_name}' via call chain {' -> '.join(chain)}")
        else:
            where = (f"{what} inside '{name}' which is traced by "
                     f"{_TRACED_BY}")
        findings.append(Finding(
            "trace-purity", sc.path, node.lineno,
            f"{where} — it runs once at trace time and vanishes from the "
            f"compiled program"))

    while stack:
        fn, sc, name, chain = stack.pop()
        if id(fn) in scanned:
            continue
        for node in ast.walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                scanned.add(id(node))
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if _is_lockish_ctx(item.context_expr):
                        impure(sc, node, name, chain,
                               f"lock acquisition "
                               f"'{_describe(item.context_expr)}'")
            if not isinstance(node, ast.Call):
                continue
            if sc.line_has(node.lineno, _ALLOW_TRACE_IMPURE):
                continue  # declared deliberate trace-time effect
            f = node.func
            if isinstance(f, ast.Name) and f.id == "print":
                impure(sc, node, name, chain, "print()")
            elif isinstance(f, ast.Attribute):
                root = _root_name(f)
                if root == "time" and f.attr in _TIME_FNS:
                    impure(sc, node, name, chain,
                           f"wall-clock call time.{f.attr}()")
                elif f.attr in ("acquire", "release") and \
                        _is_lockish_ctx(f.value):
                    impure(sc, node, name, chain,
                           f"lock call '{_describe(f)}()'")
                elif root == "obs" or root in sc.obs_module_aliases:
                    impure(sc, node, name, chain,
                           f"obs instrumentation '{_describe(f)}()'")
                elif root == "threading" and f.attr in ("Lock", "RLock"):
                    impure(sc, node, name, chain, "lock construction")
            tgt = graph.call_target(node)
            if tgt is not None and tgt not in visited_nodes:
                visited_nodes.add(tgt)
                callee = graph.nodes.get(tgt)
                if callee is None or callee.qual == "<module>":
                    continue
                callee_sc = sc_by_path.get(callee.path)
                if callee_sc is not None and callee_sc.line_has(
                        getattr(callee.fn, "lineno", 0),
                        _ALLOW_TRACE_IMPURE):
                    continue  # def-level: deliberate trace-time function
                if callee_sc is not None and id(callee.fn) not in scanned:
                    stack.append((callee.fn, callee_sc,
                                  _node_display(callee),
                                  chain + (_node_display(callee),)))


# ---------------------------------------------------------------------------
# check: lock-order (static inversion cycles over the call graph)
# ---------------------------------------------------------------------------

def _collect_checked_locks(scans: List[_FileScan], graph: CallGraph
                           ) -> Tuple[Dict[str, Dict[str, str]],
                                      Dict[Tuple[str, str], Dict[str, str]],
                                      Dict[str, Dict[str, Dict[str, str]]],
                                      Dict[Tuple[str, str],
                                           Dict[str, Dict[str, str]]]]:
    """Map ``x = checked_lock("name")`` assignments to lock names:
    per-module ``var -> name``, per-class ``self.attr -> name``,
    per-module literal-dict CONTAINERS ``var -> {key -> name}`` (a
    module-level ``LOCKS = {"a": checked_lock(...), "b": A}`` makes
    ``LOCKS["a"]`` resolvable by key), and per-CLASS literal-dict
    containers ``(module, cls) -> attr -> {key -> name}`` (a class-scope
    ``LOCKS = {...}`` makes ``self.LOCKS["a"]`` resolvable the same
    way)."""
    mi_by_path = {mi.path: mi for mi in graph.modules.values()}
    mod_locks: Dict[str, Dict[str, str]] = {}
    cls_locks: Dict[Tuple[str, str], Dict[str, str]] = {}
    cont_locks: Dict[str, Dict[str, Dict[str, str]]] = {}
    ccont_locks: Dict[Tuple[str, str], Dict[str, Dict[str, str]]] = {}

    def lock_name(value: ast.AST) -> Optional[str]:
        if isinstance(value, ast.Call) and \
                _last_name(value.func) in ("checked_lock",
                                           "checked_rwlock") and \
                value.args and \
                isinstance(value.args[0], ast.Constant) and \
                isinstance(value.args[0].value, str):
            return value.args[0].value
        return None

    for sc in scans:
        mi = mi_by_path.get(sc.path)
        if mi is None:
            continue
        for node in ast.walk(sc.tree):
            if not isinstance(node, ast.Assign):
                continue
            name = lock_name(node.value)
            if name is None:
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    mod_locks.setdefault(mi.name, {})[tgt.id] = name
        for stmt in sc.tree.body:
            if not isinstance(stmt, ast.ClassDef):
                continue
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Assign):
                    continue
                name = lock_name(node.value)
                if name is None:
                    continue
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id == "self":
                        cls_locks.setdefault(
                            (mi.name, stmt.name), {})[tgt.attr] = name
    # Second sweep: MODULE-LEVEL literal dict containers.  Values may be
    # direct checked_lock(...) calls or names of locks collected above
    # (same module), so this runs after the direct pass.
    for sc in scans:
        mi = mi_by_path.get(sc.path)
        if mi is None:
            continue

        def dict_entries(value: ast.Dict) -> Dict[str, str]:
            entries: Dict[str, str] = {}
            for k, v in zip(value.keys, value.values):
                if not (isinstance(k, ast.Constant)
                        and isinstance(k.value, str)):
                    continue
                name = lock_name(v)
                if name is None and isinstance(v, ast.Name):
                    name = mod_locks.get(mi.name, {}).get(v.id)
                if name is not None:
                    entries[k.value] = name
            return entries

        for stmt in sc.tree.body:
            if isinstance(stmt, ast.Assign) and \
                    isinstance(stmt.value, ast.Dict):
                entries = dict_entries(stmt.value)
                if entries:
                    for tgt in stmt.targets:
                        if isinstance(tgt, ast.Name):
                            cont_locks.setdefault(
                                mi.name, {})[tgt.id] = entries
            elif isinstance(stmt, ast.ClassDef):
                # class-scope literal dicts: `self.LOCKS["a"]` binds by
                # key exactly like the module-level form
                for inner in stmt.body:
                    if not (isinstance(inner, ast.Assign)
                            and isinstance(inner.value, ast.Dict)):
                        continue
                    entries = dict_entries(inner.value)
                    if entries:
                        for tgt in inner.targets:
                            if isinstance(tgt, ast.Name):
                                ccont_locks.setdefault(
                                    (mi.name, stmt.name),
                                    {})[tgt.id] = entries
    # Third sweep: INHERITED class-scope containers.  `self.LOCKS["a"]`
    # in a subclass resolves through the base chain's DIRECT class
    # bodies (nearest assignment wins, bases left-to-right depth-first
    # through the call graph's class resolution).  Any direct
    # assignment of the same name in a nearer class shadows the
    # inherited mapping — a class that rebuilds the container
    # non-literally stays deferred — and a container MUTATED anywhere
    # along the chain (subscript-store or in-place mutator on
    # ``self.<attr>``) is never inherited: dynamic-harness territory,
    # same policy as the module-level form.
    cls_defs: Dict[Tuple[str, str], Tuple[object, ast.ClassDef]] = {}
    cls_assigned: Dict[Tuple[str, str], Set[str]] = {}
    cls_mutated: Dict[Tuple[str, str], Set[str]] = {}
    for sc in scans:
        mi = mi_by_path.get(sc.path)
        if mi is None:
            continue
        for stmt in sc.tree.body:
            if not isinstance(stmt, ast.ClassDef):
                continue
            key = (mi.name, stmt.name)
            cls_defs[key] = (mi, stmt)
            names: Set[str] = set()
            for inner in stmt.body:
                if isinstance(inner, ast.Assign):
                    names.update(t.id for t in inner.targets
                                 if isinstance(t, ast.Name))
                elif isinstance(inner, ast.AnnAssign) and \
                        isinstance(inner.target, ast.Name):
                    names.add(inner.target.id)
            cls_assigned[key] = names
            mut: Set[str] = set()
            for node in ast.walk(stmt):
                if isinstance(node, (ast.Assign, ast.Delete)):
                    for t in node.targets:
                        if isinstance(t, ast.Subscript) and \
                                isinstance(t.value, ast.Attribute):
                            mut.add(t.value.attr)
                elif isinstance(node, ast.AugAssign) and \
                        isinstance(node.target, ast.Subscript) and \
                        isinstance(node.target.value, ast.Attribute):
                    mut.add(node.target.value.attr)
                elif isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _MUTATORS and \
                        isinstance(node.func.value, ast.Attribute):
                    mut.add(node.func.value.attr)
            cls_mutated[key] = mut

    def chain(key: Tuple[str, str],
              seen: Set[Tuple[str, str]]) -> List[Tuple[str, str]]:
        if key in seen or key not in cls_defs:
            return []
        seen.add(key)
        cmi, cdef = cls_defs[key]
        out = [key]
        for base in cdef.bases:
            bname = _last_name(base)
            if bname is None:
                continue
            binfo = graph._resolve_class(cmi, bname)
            if binfo is None:
                continue
            out.extend(chain((binfo.module, binfo.name), seen))
        return out

    for key in list(cls_defs):
        order = chain(key, set())
        if len(order) < 2:
            continue
        mutated_chain: Set[str] = set()
        for k in order:
            mutated_chain |= cls_mutated.get(k, set())
        claimed: Set[str] = set()
        for k in order:
            for attr in sorted(cls_assigned.get(k, ())):
                if attr in claimed:
                    continue
                claimed.add(attr)
                if k == key:
                    continue          # direct entries already collected
                entries = ccont_locks.get(k, {}).get(attr)
                if entries and attr not in mutated_chain:
                    ccont_locks.setdefault(key, {})[attr] = dict(entries)
    return mod_locks, cls_locks, cont_locks, ccont_locks


def _order_path(adj: Dict[str, Set[str]], src: str,
                dst: str) -> Optional[List[str]]:
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in sorted(adj.get(node, ())):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _make_lock_resolver(graph: CallGraph,
                        mod_locks: Dict[str, Dict[str, str]],
                        cls_locks: Dict[Tuple[str, str], Dict[str, str]],
                        cont_locks: Dict[str, Dict[str, Dict[str, str]]],
                        ccont_locks: Dict[Tuple[str, str],
                                          Dict[str, Dict[str, str]]]):
    """Shared lock-expression resolver over the maps from
    :func:`_collect_checked_locks` — used by ``lock-order`` and
    ``lock-exception-safety`` so both checks name locks identically."""

    def _target_module(node: FuncNode, root: str):
        """Resolve an imported-module alias / from-import in ``node``'s
        module to the graph module it names (or None)."""
        mi = graph.modules[node.module]
        target_name = mi.import_aliases.get(root)
        if target_name is None and root in mi.from_imports:
            m, orig = mi.from_imports[root]
            target_name = f"{m}.{orig}" if m else orig
        return graph._find_module(target_name) if target_name else None

    def resolve_lock(expr: ast.AST, node: FuncNode,
                     param_locks: Optional[Dict[str, str]] = None
                     ) -> Optional[str]:
        if isinstance(expr, ast.Call):
            # rwlock sides: `with rw.read():` / `.write()` acquire under
            # the lock's one name, exactly as the dynamic harness keys
            # them (a read-vs-write split would hide r/w inversions).
            f = expr.func
            if isinstance(f, ast.Attribute) and f.attr in _RW_SIDES:
                return resolve_lock(f.value, node, param_locks)
            return None
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                    and node.cls is not None:
                return cls_locks.get((node.module, node.cls),
                                     {}).get(expr.attr)
            root = _root_name(expr)
            if root is None:
                return None
            mi = graph.modules[node.module]
            target_name = mi.import_aliases.get(root)
            if target_name is None and root in mi.from_imports:
                m, orig = mi.from_imports[root]
                target_name = f"{m}.{orig}" if m else orig
            if target_name:
                target = graph._find_module(target_name)
                if target is not None:
                    return mod_locks.get(target.name, {}).get(expr.attr)
            return None
        if isinstance(expr, ast.Subscript):
            # Container-stored locks: `LOCKS["a"]` where LOCKS is a
            # module-level literal dict — the subscript load binds by
            # key (closes the last static lock blind spot; non-constant
            # keys and non-literal containers stay unresolved).
            sl = expr.slice
            if not (isinstance(sl, ast.Constant)
                    and isinstance(sl.value, str)):
                return None
            base = expr.value
            if isinstance(base, ast.Attribute) and \
                    isinstance(base.value, ast.Name) and \
                    base.value.id == "self" and node.cls is not None:
                # `self.LOCKS["a"]`: class-scope literal-dict container
                hit = ccont_locks.get((node.module, node.cls),
                                      {}).get(base.attr, {}).get(sl.value)
                if hit is not None:
                    return hit
            if isinstance(base, ast.Name):
                cont = cont_locks.get(node.module, {}).get(base.id)
                if cont is None:
                    # `from mod import LOCKS`: the container lives in
                    # the source module under its original name.
                    mi = graph.modules[node.module]
                    if base.id in mi.from_imports:
                        m, orig = mi.from_imports[base.id]
                        target = graph._find_module(m) if m else None
                        if target is not None:
                            cont = cont_locks.get(target.name,
                                                  {}).get(orig)
                return cont.get(sl.value) if cont else None
            if isinstance(base, ast.Attribute) and \
                    isinstance(base.value, ast.Name):
                # `mod.LOCKS["a"]` through an imported module
                target = _target_module(node, base.value.id)
                if target is not None:
                    return cont_locks.get(target.name,
                                          {}).get(base.attr,
                                                  {}).get(sl.value)
            return None
        if isinstance(expr, ast.Name):
            if param_locks and expr.id in param_locks:
                # a lock received as a function PARAMETER, named by
                # binding the caller's argument through the call graph
                return param_locks[expr.id]
            return mod_locks.get(node.module, {}).get(expr.id)
        return None

    return resolve_lock


def _check_lock_order(scans: List[_FileScan],
                      graph: CallGraph) -> List[Finding]:
    mod_locks, cls_locks, cont_locks, ccont_locks = \
        _collect_checked_locks(scans, graph)
    if not mod_locks and not cls_locks and not cont_locks \
            and not ccont_locks:
        return []
    resolve_lock = _make_lock_resolver(graph, mod_locks, cls_locks,
                                       cont_locks, ccont_locks)

    # acquisition edges: (held, acquired) -> first site (path, line, chain)
    edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
    adj: Dict[str, Set[str]] = {}
    memo: Set[Tuple[str, Tuple[str, ...], Tuple[Tuple[str, str], ...]]] = \
        set()

    def callee_bindings(call: ast.Call, node: FuncNode,
                        callee: FuncNode,
                        params: Dict[str, str]) -> Dict[str, str]:
        """Bind lock-valued arguments of `call` to the callee's parameter
        names, so `def use(lk): with lk:` acquires under the CALLER's
        lock name (with module-literal containers also resolved, the
        static lock blind spots are closed; locks in mutated/non-literal
        containers stay dynamic-harness-only)."""
        cargs = getattr(callee.fn, "args", None)
        if cargs is None:
            return {}
        names = [a.arg for a in (list(cargs.posonlyargs) +
                                 list(cargs.args))]
        offset = 1 if callee.cls is not None and names and \
            names[0] == "self" else 0
        out: Dict[str, str] = {}
        for i, arg in enumerate(call.args):
            ln = resolve_lock(arg, node, params)
            if ln is not None and offset + i < len(names):
                out[names[offset + i]] = ln
        kw_ok = set(names) | {a.arg for a in cargs.kwonlyargs}
        for kw in call.keywords:
            if kw.arg is None:
                continue
            ln = resolve_lock(kw.value, node, params)
            if ln is not None and kw.arg in kw_ok:
                out[kw.arg] = ln
        return out

    def walk(node_id: str, held: Tuple[str, ...],
             chain: Tuple[str, ...],
             param_locks: Tuple[Tuple[str, str], ...] = ()) -> None:
        key = (node_id, tuple(sorted(set(held))), param_locks)
        if key in memo or len(chain) > 25:
            return
        memo.add(key)
        node = graph.nodes.get(node_id)
        if node is None:
            return
        params = dict(param_locks)

        def scan(n: ast.AST, held: Tuple[str, ...]) -> None:
            if isinstance(n, (ast.With, ast.AsyncWith)):
                new_held = held
                for item in n.items:
                    ln = resolve_lock(item.context_expr, node, params)
                    if ln is None:
                        continue
                    for h in new_held:
                        if h != ln and (h, ln) not in edges:
                            edges[(h, ln)] = (node.path, n.lineno,
                                              " -> ".join(chain))
                            adj.setdefault(h, set()).add(ln)
                    if ln not in new_held:
                        new_held = new_held + (ln,)
                for child in n.body:
                    scan(child, new_held)
                return
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
                return
            if isinstance(n, ast.Call):
                tgt = graph.call_target(n)
                if tgt is not None and tgt in graph.nodes:
                    callee = graph.nodes[tgt]
                    bound = callee_bindings(n, node, callee, params)
                    walk(tgt, held,
                         chain + (_node_display(callee),),
                         tuple(sorted(bound.items())))
            for child in ast.iter_child_nodes(n):
                scan(child, held)

        body = node.fn.body if isinstance(node.fn.body, list) \
            else [node.fn.body]
        for child in body:
            scan(child, held)

    for node_id in sorted(graph.nodes):
        node = graph.nodes[node_id]
        walk(node_id, (), (_node_display(node),))

    findings: List[Finding] = []
    reported: Set[frozenset] = set()
    for (a, b), (path, line, chain_desc) in sorted(edges.items()):
        cyc = _order_path(adj, b, a)
        if cyc is None:
            continue
        cyc_set = frozenset([a] + cyc)
        if cyc_set in reported:
            continue
        reported.add(cyc_set)
        opposite = edges.get((cyc[0], cyc[1])) if len(cyc) > 1 else None
        opp_desc = f"; opposite order acquired in {opposite[2]}" \
            if opposite else ""
        findings.append(Finding(
            "lock-order", path, line,
            f"static lock-order inversion: acquiring '{b}' while holding "
            f"'{a}' (in {chain_desc}) closes the cycle "
            f"{' -> '.join([a] + cyc)} — the two orders can deadlock under "
            f"the right interleaving{opp_desc}"))
    return findings


# ---------------------------------------------------------------------------
# check: lock-exception-safety (manual acquire/release across throwing edges)
# ---------------------------------------------------------------------------


def _check_lock_exception_safety(scans: List[_FileScan],
                                 graph: CallGraph) -> List[Finding]:
    """Two exception-unwind obligations on the may-throw fixpoint:

    1. a ``checked_lock``/``checked_rwlock`` acquired via a bare
       ``.acquire()`` (outside ``with``) and still held at a site the
       fixpoint PROVES can raise — unless an enclosing ``finally``
       releases the lock or a handler that catches every thrown type
       does — leaves the lock held forever on the unwinding edge;
    2. a fence flag (``self.x = True`` … ``self.x = False`` in the same
       block) with a proven-throwing site between set and reset and no
       ``try/finally`` resetting it — the flag is left half-done.

    Unresolved calls (external confidence) never produce findings."""
    mod_locks, cls_locks, cont_locks, ccont_locks = \
        _collect_checked_locks(scans, graph)
    findings: List[Finding] = []
    resolve_lock = _make_lock_resolver(graph, mod_locks, cls_locks,
                                       cont_locks, ccont_locks)
    sc_paths = {sc.path for sc in scans}
    reported: Set[Tuple[str, str]] = set()

    def releases_in(stmts: List[ast.AST], fnode: FuncNode) -> Set[str]:
        out: Set[str] = set()
        for s in stmts:
            for n in ast.walk(s):
                if isinstance(n, ast.Call) and \
                        isinstance(n.func, ast.Attribute) and \
                        n.func.attr == "release":
                    ln = resolve_lock(n.func.value, fnode)
                    if ln is not None:
                        out.add(ln)
        return out

    def throw_events(n: ast.AST
                     ) -> Optional[Tuple[List[Optional[str]], str]]:
        """(thrown types, description) when ``n`` is a proven-throwing
        site — an explicit raise or a call with a proven summary."""
        if isinstance(n, ast.Raise):
            t = graph.raised_type_name(n)
            return [t], f"raise {t or 'of a dynamic type'}"
        if isinstance(n, ast.Call):
            tgt = graph.call_target(n)
            if tgt is None:
                return None
            summ = graph.throw_summary(tgt)
            if not summ.may_throw:
                return None
            thrown = list(summ.types) + ([None] if summ.unknown else [])
            callee = graph.nodes.get(tgt)
            cdisp = _node_display(callee) if callee else tgt
            tdesc = "/".join(summ.types) if summ.types else "an exception"
            return thrown, f"call to {cdisp}, which can raise {tdesc}"
        return None

    def flag_held(fnode: FuncNode, held: Dict[str, int], line: int,
                  thrown: List[Optional[str]], desc: str,
                  fin_locks: Set[str], scopes: Tuple) -> None:
        for lname in sorted(held):
            if lname in fin_locks:
                continue
            if all(any(graph.exception_catches(c, t) and lname in rel
                       for c, rel in scopes) for t in thrown):
                continue
            key = (fnode.node_id, lname)
            if key in reported:
                continue
            reported.add(key)
            findings.append(Finding(
                "lock-exception-safety", fnode.path, line,
                f"{_node_display(fnode)}: checked lock '{lname}' "
                f"acquired at line {held[lname]} outside `with` is "
                f"still held at this may-throw site ({desc}) — the "
                f"unwinding edge leaves it locked forever; acquire "
                f"with `with` or pair acquire/release in try/finally"))

    def scan(n: ast.AST, fnode: FuncNode, held: Dict[str, int],
             fin_locks: Set[str], scopes: Tuple) -> None:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            return
        if isinstance(n, ast.Try):
            fin2 = fin_locks | releases_in(list(n.finalbody), fnode)
            sc2 = scopes + tuple(
                (graph.handler_catch_names(h),
                 frozenset(releases_in(list(h.body), fnode)))
                for h in n.handlers)
            for s in n.body:
                scan(s, fnode, held, fin2, sc2)
            for s in n.orelse:
                scan(s, fnode, held, fin2, scopes)
            for h in n.handlers:
                for s in h.body:
                    scan(s, fnode, held, fin_locks, scopes)
            for s in n.finalbody:
                scan(s, fnode, held, fin_locks, scopes)
            return
        if isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Attribute) and \
                    f.attr in ("acquire", "release"):
                ln = resolve_lock(f.value, fnode)
                if ln is not None:
                    if f.attr == "acquire":
                        held[ln] = n.lineno
                    else:
                        held.pop(ln, None)
                    return
            ev = throw_events(n)
            if ev is not None and held:
                flag_held(fnode, held, n.lineno, ev[0], ev[1],
                          fin_locks, scopes)
        elif isinstance(n, ast.Raise) and held:
            ev = throw_events(n)
            flag_held(fnode, held, n.lineno, ev[0], ev[1], fin_locks,
                      scopes)
        for child in ast.iter_child_nodes(n):
            scan(child, fnode, held, fin_locks, scopes)

    def scan_flags(fnode: FuncNode) -> None:
        """Fence flags: self.<x> = True ... self.<x> = False with a
        proven-throwing site between, no finally resetting it."""

        def flag_attr(s: ast.AST, value: bool) -> Optional[str]:
            if isinstance(s, ast.Assign) and len(s.targets) == 1 and \
                    isinstance(s.value, ast.Constant) and \
                    s.value.value is value:
                return _self_attr_of(s.targets[0])
            return None

        def first_throw_in(s: ast.AST, attr: str
                           ) -> Optional[Tuple[int, str]]:
            # skip subtrees protected by a finally that resets the flag
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
                return None
            if isinstance(s, ast.Try) and any(
                    flag_attr(fs, False) == attr or
                    flag_attr(fs, True) == attr
                    for fs in s.finalbody):
                return None
            ev = throw_events(s)
            if ev is not None:
                return s.lineno, ev[1]
            for child in ast.iter_child_nodes(s):
                hit = first_throw_in(child, attr)
                if hit is not None:
                    return hit
            return None

        def blocks(n: ast.AST):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)) and \
                    n is not fnode.fn:
                return
            for field in ("body", "orelse", "finalbody"):
                b = getattr(n, field, None)
                if isinstance(b, list) and b and isinstance(b[0], ast.stmt):
                    yield b
            for child in ast.iter_child_nodes(n):
                yield from blocks(child)

        for block in blocks(fnode.fn):
            pending: Dict[str, Tuple[int, int]] = {}
            for idx, s in enumerate(block):
                a_set = flag_attr(s, True)
                if a_set is not None:
                    pending[a_set] = (s.lineno, idx)
                    continue
                a_clr = flag_attr(s, False)
                if a_clr is not None and a_clr in pending:
                    set_line, set_idx = pending.pop(a_clr)
                    for span_stmt in block[set_idx + 1:idx]:
                        hit = first_throw_in(span_stmt, a_clr)
                        if hit is None:
                            continue
                        key = (fnode.node_id, f"flag:{a_clr}")
                        if key in reported:
                            break
                        reported.add(key)
                        findings.append(Finding(
                            "lock-exception-safety", fnode.path, hit[0],
                            f"{_node_display(fnode)}: fence flag "
                            f"self.{a_clr} is set at line {set_line} "
                            f"and reset at line {s.lineno}, but this "
                            f"may-throw site between them ({hit[1]}) "
                            f"can unwind with the flag still set — "
                            f"half-done obligation; reset it in a "
                            f"finally"))
                        break

    for node_id in sorted(graph.nodes):
        fnode = graph.nodes[node_id]
        if not isinstance(fnode.fn, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
            continue
        if fnode.path not in sc_paths:
            continue
        held: Dict[str, int] = {}
        for stmt in fnode.fn.body:
            scan(stmt, fnode, held, set(), ())
        scan_flags(fnode)
    return findings


# ---------------------------------------------------------------------------
# check: handle-lifecycle (interprocedural ownership over the call graph)
# ---------------------------------------------------------------------------

class _HBinding:
    """One live owned handle bound to a local name.  Branch copies of the
    flow state SHARE binding objects, so a release observed on any path
    marks the same object every sibling path sees — reporting stays
    may-leak at explicit exits (the state at THAT point) and must-leak
    nowhere (no false positives from merge order).

    A binding with ``members is not None`` is a LOCAL CONTAINER (``pcs =
    []``) rather than a handle: appends of owned handles move their
    obligation into ``members`` (the may-leak set), and the container is
    released by draining it (a loop or comprehension releasing each
    element), returning it, or storing it on an owner."""

    __slots__ = ("kind", "line", "origin", "released", "members")

    def __init__(self, kind: str, line: int, origin: str = "",
                 members: Optional[Set[str]] = None):
        self.kind = kind
        self.line = line
        self.origin = origin
        self.released = False
        self.members = members

    @property
    def live(self) -> bool:
        """Carries an unmet obligation (a container is only live once it
        actually holds handles)."""
        if self.released:
            return False
        return self.members is None or bool(self.members)


def _handle_producer_nodes(graph: CallGraph) -> Dict[str, str]:
    """node id -> produced owner class, for the constructors and factory
    methods of the ``rpc`` module's owner table."""
    producers: Dict[str, str] = {}
    for mi in graph.modules.values():
        if mi.name != "brpc_tpu_torch.rpc" and mi.name.split(".")[-1] != "rpc":
            continue
        for cls in _HANDLE_OWNERS:
            ci = mi.classes.get(cls)
            if ci is not None and "__init__" in ci.methods:
                producers[ci.methods["__init__"]] = cls
        for (cls, meth), kind in _HANDLE_FACTORIES.items():
            ci = mi.classes.get(cls)
            if ci is not None and meth in ci.methods:
                producers[ci.methods[meth]] = kind
    return producers


def _name_chain(expr: ast.AST) -> Optional[List[str]]:
    """['rpc', 'Channel'] for ``rpc.Channel``; None unless Name-rooted."""
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return list(reversed(parts))
    return None


def _is_rpc_module_name(name: str) -> bool:
    return name == "brpc_tpu_torch.rpc" or name.split(".")[-1] == "rpc"


def _producer_kind(call: ast.Call, graph: CallGraph, module: str,
                   producers: Dict[str, str],
                   sources: Dict[str, Tuple[str, str]]
                   ) -> Optional[Tuple[str, str]]:
    """(owner kind, origin description) when this call returns a FRESH
    owning handle; None otherwise.  ``module`` is the calling module (for
    import-aware constructor resolution)."""
    tgt = graph.call_target(call)
    if tgt is not None:
        kind = producers.get(tgt)
        if kind is not None:
            return kind, ""
        src = sources.get(tgt)
        if src is not None:
            return src
        return None
    f = call.func
    # Constructor of an owner class (covers classes whose __init__ is
    # inherited/implicit, where no call edge exists)
    parts = _name_chain(f)
    mi = graph.modules.get(module)
    if parts is not None and mi is not None:
        hit = graph._class_from_dotted(parts, mi)
        if hit is not None and _is_rpc_module_name(hit[0].name) and \
                hit[1] in _HANDLE_OWNERS:
            return hit[1], ""
    if isinstance(f, ast.Attribute) and f.attr in _FACTORY_NAME_FALLBACK:
        return _FACTORY_NAME_FALLBACK[f.attr], ""
    return None


def _handle_sources(graph: CallGraph, producers: Dict[str, str]
                    ) -> Dict[str, Tuple[str, str]]:
    """Functions that hand a FRESH owning handle to their caller: every
    valued top-scope ``return`` is a producer call, or a local whose
    every top-scope assignment is a producer call of one kind (``return
    None`` error arms are neutral).  Cached accessors — a local that is
    ALSO assigned from a dict lookup, like ``obs.recorder`` — do not
    qualify: they return a handle the callee still owns, and claiming
    ownership at the caller would be a false finding."""
    sources: Dict[str, Tuple[str, str]] = {}
    for node in graph.nodes.values():
        fn = node.fn
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) or \
                node.node_id in producers:
            continue
        # top-scope assignments per local name (nested scopes excluded)
        assigns: Dict[str, List[ast.AST]] = {}
        returns: List[ast.expr] = []

        def scan(n: ast.AST) -> None:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
                return
            if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                    isinstance(n.targets[0], ast.Name):
                assigns.setdefault(n.targets[0].id, []).append(n.value)
            elif isinstance(n, ast.Return) and n.value is not None:
                returns.append(n.value)
            for child in ast.iter_child_nodes(n):
                scan(child)

        for stmt in fn.body:
            scan(stmt)
        kinds: Set[str] = set()
        fresh = bool(returns)
        for value in returns:
            if isinstance(value, ast.Constant) and value.value is None:
                continue  # error arm: neutral
            pk = _producer_kind(value, graph, node.module,
                                producers, {}) \
                if isinstance(value, ast.Call) else None
            if pk is not None:
                kinds.add(pk[0])
                continue
            if isinstance(value, ast.Name):
                vals = assigns.get(value.id, [])
                val_kinds = set()
                ok = bool(vals)
                for v in vals:
                    p = _producer_kind(v, graph, node.module,
                                       producers, {}) \
                        if isinstance(v, ast.Call) else None
                    if p is None:
                        ok = False  # mixed origin: may be a cached handle
                        break
                    val_kinds.add(p[0])
                if ok and len(val_kinds) == 1:
                    kinds.add(next(iter(val_kinds)))
                    continue
            fresh = False
            break
        if fresh and len(kinds) == 1:
            kind = next(iter(kinds))
            sources[node.node_id] = (
                kind, f" (fresh {kind} produced by {_node_display(node)})")
    return sources


def _self_attr_of(tgt: ast.AST) -> Optional[str]:
    """'attr' for self.<attr> or self.<attr>[...] targets, else None."""
    if isinstance(tgt, ast.Subscript):
        tgt = tgt.value
    if isinstance(tgt, ast.Attribute) and \
            isinstance(tgt.value, ast.Name) and tgt.value.id == "self":
        return tgt.attr
    return None


def _check_handle_lifecycle(scans: List[_FileScan], graph: CallGraph,
                            active: Set[str]) -> List[Finding]:
    """Runs the shared handle-flow machinery; normal-path findings carry
    check ``handle-lifecycle``, implicit-exception-edge findings carry
    ``exception-flow`` — ``active`` picks which of the two surface."""
    sc_by_path = {sc.path: sc for sc in scans}
    producers = _handle_producer_nodes(graph)
    findings: List[Finding] = []
    if "handle-lifecycle" in active:
        findings.extend(_check_abi_pairing(scans))
    if not producers:
        return findings
    sources = _handle_sources(graph, producers)
    # (module, class, attr, kind, line, path) for the attr-store audit
    attr_stores: List[Tuple[str, str, str, str, int, str]] = []
    for node in graph.nodes.values():
        if not isinstance(node.fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        sc = sc_by_path.get(node.path)
        if sc is None:
            continue
        _flow_handles(sc, graph, node, producers, sources, attr_stores,
                      findings, active)
    if "handle-lifecycle" in active:
        findings.extend(_audit_attr_stores(attr_stores, graph, sc_by_path))
        findings.extend(_audit_module_producers(graph, sc_by_path,
                                                producers, sources))
    return findings


def _audit_module_producers(graph: CallGraph,
                            sc_by_path: Dict[str, "_FileScan"],
                            producers: Dict[str, str],
                            sources: Dict[str, Tuple[str, str]]
                            ) -> List[Finding]:
    """Module-scope producers audited like attr stores: a global bound
    to a fresh owning handle at import time is fine only if some
    function in the same module releases it (a shutdown/atexit path) —
    otherwise nothing can ever free it."""
    findings: List[Finding] = []
    for mod_name in sorted(graph.modules):
        mi = graph.modules[mod_name]
        sc = sc_by_path.get(mi.path)
        if sc is None:
            continue
        # (global name, kind, line) for module-level producer assigns;
        # walk top-level statements but never into defs/classes (those
        # flows are audited per-function)
        bound: List[Tuple[str, str, int]] = []

        def top_walk(n: ast.AST) -> None:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
                return
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
                pk = _producer_kind(n.value, graph, mod_name, producers,
                                    sources)
                if pk is not None:
                    for t in n.targets:
                        if isinstance(t, ast.Name):
                            bound.append((t.id, pk[0], n.lineno))
            for child in ast.iter_child_nodes(n):
                top_walk(child)

        for stmt in mi.tree.body:
            top_walk(stmt)
        for gname, kind, line in bound:
            if sc.line_has(line, _ALLOW_HANDLE_ESCAPE):
                continue
            releases = _HANDLE_OWNERS.get(kind, frozenset({"close"}))
            released = False
            for node in graph.nodes.values():
                if node.module != mod_name or released:
                    continue
                for n in ast.walk(node.fn):
                    if isinstance(n, ast.Call) and \
                            isinstance(n.func, ast.Attribute) and \
                            isinstance(n.func.value, ast.Name) and \
                            n.func.value.id == gname and \
                            n.func.attr in releases:
                        released = True
                        break
            if not released:
                findings.append(Finding(
                    "handle-lifecycle", sc.path, line,
                    f"module-scope {kind} bound to global '{gname}' at "
                    f"import time, but no function in this module ever "
                    f"releases it ({'/'.join(sorted(releases))}) — the "
                    f"native handle lives until process exit with no "
                    f"shutdown path; add one (atexit or an explicit "
                    f"close hook) or mark a deliberate singleton with "
                    f"`# {_ALLOW_HANDLE_ESCAPE}`"))
    return findings


def _check_abi_pairing(scans: List[_FileScan]) -> List[Finding]:
    """The restype-registry half: every c_void_p-returning constructor
    symbol must have its destroy symbol declared in the same tree — a
    handle type nothing can free leaks by construction."""
    restypes: Dict[str, Tuple[str, int, str]] = {}
    declared: Set[str] = set()
    for sc in scans:
        declared.update(sc.native_decls)
        for name, (rname, line) in sc.native_restypes.items():
            restypes.setdefault(name, (rname, line, sc.path))
    findings: List[Finding] = []
    for name in sorted(restypes):
        rname, line, path = restypes[name]
        if rname != "c_void_p":
            continue
        if name in _ABI_NEW_PAIRS:
            expected = _ABI_NEW_PAIRS[name]
        elif name.endswith("_new"):
            expected = name[:-len("_new")] + "_destroy"
        else:
            continue
        if expected not in declared:
            findings.append(Finding(
                "handle-lifecycle", path, line,
                f"constructor symbol '{name}' returns an owning c_void_p "
                f"handle but its destroy symbol '{expected}' is not "
                f"declared anywhere in the scanned tree — handles of this "
                f"type cannot be freed"))
    return findings


def _flow_handles(sc: _FileScan, graph: CallGraph, node: FuncNode,
                  producers: Dict[str, str],
                  sources: Dict[str, Tuple[str, str]],
                  attr_stores: List[Tuple[str, str, str, str, int, str]],
                  findings: List[Finding], active: Set[str]) -> None:
    """Abstract interpretation of one function body: owning handles must
    reach a release on every normal-flow path, be returned, be stored on
    self (audited separately), or carry the escape pragma.

    Exception paths are modeled at explicit ``raise`` statements AND at
    every call whose resolved callee the may-throw fixpoint PROVES can
    raise (``exception-flow`` findings): a handle still live there leaks
    unless an enclosing ``finally``/``with`` releases it or an ``except``
    handler that (a) lexically encloses that site and (b) can catch the
    thrown type releases it — handler trust is scoped per ``try`` and
    per exception type, never context-insensitive.  Unresolved calls
    carry only the low-confidence ``external`` tag and never produce a
    finding.

    Handles appended to LOCAL containers become a tracked may-leak set
    (the container must be drained/returned/stored), rebinding a live
    handle's only name is a drop, and module-scope producers are audited
    separately (:func:`_audit_module_producers`)."""
    display = _node_display(node)

    def kind_of(call: ast.Call) -> Optional[Tuple[str, str]]:
        return _producer_kind(call, graph, node.module, producers,
                              sources)

    def allow(line: int) -> bool:
        return sc.line_has(line, _ALLOW_HANDLE_ESCAPE)

    def releases_of(kind: str) -> frozenset:
        return _HANDLE_OWNERS.get(kind, frozenset({"close"}))

    def report(line: int, msg: str, check: str = "handle-lifecycle"
               ) -> None:
        if check in active and not allow(line):
            findings.append(Finding(check, sc.path, line, msg))

    # producer calls consumed inline by a chained release
    # (`ch.call_async(...).join()`): collected up front, skipped later
    consumed: Set[int] = set()
    for n in ast.walk(node.fn):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and isinstance(n.func.value, ast.Call):
            pk = kind_of(n.func.value)
            if pk is not None and n.func.attr in releases_of(pk[0]):
                consumed.add(id(n.func.value))

    def release_name(state: Dict[str, _HBinding], name: str) -> None:
        b = state.get(name)
        if b is not None:
            b.released = True

    def fork_state(state: Dict[str, _HBinding]) -> Dict[str, _HBinding]:
        """A copy with CLONED bindings: releases observed inside it stay
        inside it.  Except-handler bodies run on forks — a handler's
        release covers only the exception edges of its own try (via the
        scope entries), never the fall-through path after the try."""
        out: Dict[str, _HBinding] = {}
        for name, b in state.items():
            nb = _HBinding(b.kind, b.line, b.origin,
                           None if b.members is None else set(b.members))
            nb.released = b.released
            out[name] = nb
        return out

    def handler_covers(name: str, raised: Optional[str],
                       scopes: Tuple[Tuple[Optional[frozenset],
                                           frozenset], ...]) -> bool:
        """Does some enclosing handler that can catch ``raised`` release
        ``name``?  Scoped trust: ``scopes`` holds only the handlers of
        the trys lexically enclosing the SITE being judged."""
        return any(graph.exception_catches(catch, raised) and name in rel
                   for catch, rel in scopes)

    # exception-flow reports at most one throwing site per binding — the
    # first unprotected one is the leak edge worth fixing
    throw_reported: Set[int] = set()

    def report_throw(state: Dict[str, _HBinding], call: ast.Call,
                     tgt: str, summ, fin_rel: Set[str],
                     scopes: Tuple) -> None:
        thrown = list(summ.types) + ([None] if summ.unknown else [])
        callee = graph.nodes.get(tgt)
        cdisp = _node_display(callee) if callee else tgt
        tdesc = "/".join(summ.types) if summ.types else "an exception"
        if summ.unknown and summ.types:
            tdesc += " (and unknown types)"
        for name, b in sorted(state.items()):
            if not b.live or name in fin_rel or allow(b.line):
                continue
            if all(handler_covers(name, t, scopes) for t in thrown):
                continue
            if id(b) in throw_reported:
                continue
            throw_reported.add(id(b))
            if b.members is not None:
                what = (f"container '{name}' holding owned "
                        f"{'/'.join(sorted(b.members))} handles "
                        f"(filled since line {b.line})")
            else:
                what = (f"{b.kind} '{name}' (created line {b.line}"
                        f"{b.origin})")
            report(call.lineno,
                   f"{display}: {what} is live across this call to "
                   f"{cdisp}, which can raise {tdesc} — on that "
                   f"unwinding edge the handle leaks; hold it in a "
                   f"`with`/try-finally or release it before the call",
                   check="exception-flow")

    def maybe_report_throw(call: ast.Call, state: Dict[str, _HBinding],
                           fin_rel: Set[str], scopes: Tuple) -> None:
        if "exception-flow" not in active:
            return
        tgt = graph.call_target(call)
        if tgt is None:
            return  # unresolved: external-only confidence, no finding
        summ = graph.throw_summary(tgt)
        if summ.may_throw:
            report_throw(state, call, tgt, summ, fin_rel, scopes)

    def scan_expr(n: ast.AST, state: Dict[str, _HBinding],
                  transfer: bool, fin_rel: Set[str] = frozenset(),
                  scopes: Tuple = ()) -> None:
        """Generic walk of an expression: classifies producer calls and
        owned-name stores that the statement dispatch didn't already
        claim.  `transfer` marks return-value context (everything the
        expression mentions goes to the caller).  ``fin_rel``/``scopes``
        carry the enclosing finally/handler coverage for judging
        throwing call sites."""
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            return  # nested scopes audit themselves
        if isinstance(n, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            # `[pc.join() for pc in pcs]`: draining a tracked container
            for gen in n.generators:
                if not (isinstance(gen.iter, ast.Name)
                        and isinstance(gen.target, ast.Name)):
                    continue
                cb = state.get(gen.iter.id)
                if cb is None or cb.members is None or not cb.members:
                    continue
                rel = set().union(*(releases_of(k) for k in cb.members))
                rel |= {"cancel"}
                for leaf in ast.walk(n.elt):
                    if isinstance(leaf, ast.Call) and \
                            isinstance(leaf.func, ast.Attribute) and \
                            isinstance(leaf.func.value, ast.Name) and \
                            leaf.func.value.id == gen.target.id and \
                            leaf.func.attr in rel:
                        cb.released = True
        if isinstance(n, ast.Call):
            f = n.func
            # x.close() / x.join() — release of an owned local
            if isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Name):
                b = state.get(f.value.id)
                if b is not None and b.members is None and \
                        f.attr in releases_of(b.kind):
                    b.released = True
            # container.append(x) / registry.add(x): ownership moves
            # into a container.  A LOCAL container binding tracks the
            # obligation as a may-leak set; anything else (module
            # global, attr, parameter) is an escape the check cannot
            # follow.
            if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
                recv = state.get(f.value.id) \
                    if isinstance(f.value, ast.Name) else None
                if recv is not None and recv.members is not None and \
                        f.attr in {"append", "add", "appendleft",
                                   "insert"}:
                    deliberate = allow(n.lineno)
                    for arg in n.args:
                        if isinstance(arg, ast.Call) and \
                                id(arg) not in consumed:
                            pk2 = kind_of(arg)
                            if pk2 is not None and not deliberate:
                                recv.members.add(pk2[0])
                        for leaf in ast.walk(arg):
                            if isinstance(leaf, ast.Name) and \
                                    leaf.id in state and \
                                    state[leaf.id].live and \
                                    state[leaf.id].members is None:
                                if not deliberate:
                                    recv.members.add(state[leaf.id].kind)
                                state[leaf.id].released = True
                else:
                    for arg in n.args:
                        for leaf in ast.walk(arg):
                            if isinstance(leaf, ast.Name) and \
                                    leaf.id in state and \
                                    state[leaf.id].live and \
                                    state[leaf.id].members is None:
                                report(n.lineno,
                                       f"{display}: owned "
                                       f"{state[leaf.id].kind} "
                                       f"'{leaf.id}' escapes into a "
                                       f"container via .{f.attr}() — "
                                       f"the static check cannot see "
                                       f"its release; mark a "
                                       f"deliberate registry with "
                                       f"`# {_ALLOW_HANDLE_ESCAPE}`")
                                state[leaf.id].released = True
            # threading.Thread(target=..., args=(x,)): the handle's
            # lifetime now belongs to a thread this walk can't follow
            if _last_name(f) == "Thread":
                for arg in list(n.args) + [kw.value for kw in n.keywords]:
                    for leaf in ast.walk(arg):
                        if isinstance(leaf, ast.Name) and \
                                leaf.id in state and \
                                not state[leaf.id].released:
                            report(n.lineno,
                                   f"{display}: owned "
                                   f"{state[leaf.id].kind} '{leaf.id}' "
                                   f"escapes into a thread target — "
                                   f"release moves off every path this "
                                   f"check walks; mark deliberate "
                                   f"hand-off with "
                                   f"`# {_ALLOW_HANDLE_ESCAPE}`")
                            state[leaf.id].released = True
            pk = kind_of(n) if id(n) not in consumed else None
            if pk is not None:
                if transfer:
                    pass  # returned to the caller: its obligation now
                else:
                    # a fresh handle with no binding in a non-transfer
                    # context: argument passing transfers ownership to
                    # the callee (under-approximation); everything else
                    # is a drop, reported by the statement dispatch
                    pass
            # a PROVEN-throwing callee unwinds through here: every live
            # handle not covered by finally/with or a catching handler
            # leaks on that edge (releases above ran first, so a
            # release call never flags its own receiver)
            maybe_report_throw(n, state, fin_rel, scopes)
        if isinstance(n, ast.Name) and transfer:
            release_name(state, n.id)
        for child in ast.iter_child_nodes(n):
            scan_expr(child, state, transfer, fin_rel, scopes)

    def container_producers(value: ast.AST) -> List[ast.Call]:
        """Producer calls nested under a non-call expression (list/tuple/
        dict literals, comprehensions, conditionals)."""
        out = []
        for leaf in ast.walk(value):
            if isinstance(leaf, ast.Call) and id(leaf) not in consumed:
                if kind_of(leaf) is not None:
                    out.append(leaf)
        return out

    def finally_releases(finalbody: List[ast.AST]) -> Set[str]:
        """Names a finally block releases (context-insensitively: any
        `x.<release>()` or transfer anywhere inside it counts — finally
        runs on every exit, which is the whole point of the idiom)."""
        names: Set[str] = set()
        for stmt in finalbody:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Call) and \
                        isinstance(n.func, ast.Attribute) and \
                        isinstance(n.func.value, ast.Name) and \
                        n.func.attr in {m for rel in _HANDLE_OWNERS.values()
                                        for m in rel} | {"cancel"}:
                    names.add(n.func.value.id)
        return names

    def report_exit(state: Dict[str, _HBinding], line: int,
                    finally_rel: Set[str], where: str,
                    scopes: Tuple = (),
                    raised: Tuple = ()) -> None:
        """``raised`` is the tuple of thrown type names (None = unknown)
        when this exit is an exception edge; a handler scope covers a
        name only if it catches EVERY thrown type and releases the
        name.  Empty ``raised`` (return/fall-through) means handler
        coverage does not apply."""
        for name, b in sorted(state.items()):
            if not b.live or name in finally_rel:
                continue
            if allow(b.line):
                continue
            if raised and all(handler_covers(name, t, scopes)
                              for t in raised):
                continue
            if b.members is not None:
                report(line,
                       f"{display}: local container '{name}' still "
                       f"holds owned {'/'.join(sorted(b.members))} "
                       f"handle(s) (filled since line {b.line}) at this "
                       f"{where} — the may-leak set was never drained; "
                       f"release every element, return the container, "
                       f"or store it on an owner whose close drains it")
            else:
                report(line,
                       f"{display}: {b.kind} '{name}' (created line "
                       f"{b.line}{b.origin}) is still live at this "
                       f"{where} — this path leaks the native handle; "
                       f"release it "
                       f"({'/'.join(sorted(releases_of(b.kind)))}), "
                       f"return it, or store it on an owner whose close "
                       f"releases it")

    def exec_block(stmts: List[ast.AST], state: Dict[str, _HBinding],
                   finally_rel: Set[str], exc_scopes: Tuple
                   ) -> Tuple[Dict[str, _HBinding], bool]:
        """Returns (state after the block, terminated-by-return/raise).
        ``exc_scopes`` holds one ``(catch-set, released-names)`` entry
        per handler of every ``try`` lexically enclosing this block —
        coverage is judged per site and per thrown type, so a handler is
        trusted only for raises it both encloses and catches."""
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, ast.Return):
                if stmt.value is not None:
                    scan_expr(stmt.value, state, transfer=True,
                              fin_rel=finally_rel, scopes=exc_scopes)
                report_exit(state, stmt.lineno, finally_rel,
                            "early return" if stmt is not stmts[-1]
                            or stmt.value is None else "return")
                return state, True
            if isinstance(stmt, ast.Raise):
                # the exception path IS a function exit: anything still
                # live here leaks unless a finally or an enclosing
                # handler that CATCHES this raise releases it
                scan_expr(stmt, state, transfer=False,
                          fin_rel=finally_rel, scopes=exc_scopes)
                report_exit(state, stmt.lineno, finally_rel,
                            "raise (exception path)", scopes=exc_scopes,
                            raised=(graph.raised_type_name(stmt),))
                return state, True
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                _exec_assign(stmt, state, finally_rel, exc_scopes)
                continue
            if isinstance(stmt, ast.Expr):
                _exec_expr_stmt(stmt, state, finally_rel, exc_scopes)
                continue
            if isinstance(stmt, ast.If):
                scan_expr(stmt.test, state, transfer=False,
                          fin_rel=finally_rel, scopes=exc_scopes)
                s1, t1 = exec_block(list(stmt.body), dict(state),
                                    finally_rel, exc_scopes)
                s2, t2 = exec_block(list(stmt.orelse), dict(state),
                                    finally_rel, exc_scopes)
                if t1 and t2:
                    return state, True
                merged: Dict[str, _HBinding] = {}
                for s in ([s1] if not t1 else []) + \
                         ([s2] if not t2 else []):
                    for name, b in s.items():
                        if name not in merged or (merged[name].released
                                                  and not b.released):
                            merged[name] = b
                state = merged
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                scan_expr(getattr(stmt, "iter", None) or stmt.test,
                          state, transfer=False, fin_rel=finally_rel,
                          scopes=exc_scopes)
                # `for pc in pcs: pc.join()` — draining a tracked
                # container releases its may-leak set
                it = getattr(stmt, "iter", None)
                if isinstance(it, ast.Name) and \
                        isinstance(getattr(stmt, "target", None),
                                   ast.Name):
                    cb = state.get(it.id)
                    if cb is not None and cb.members:
                        rel = set().union(*(releases_of(k)
                                            for k in cb.members))
                        rel |= {"cancel"}
                        for bstmt in stmt.body:
                            for leaf in ast.walk(bstmt):
                                if isinstance(leaf, ast.Call) and \
                                        isinstance(leaf.func,
                                                   ast.Attribute) and \
                                        isinstance(leaf.func.value,
                                                   ast.Name) and \
                                        leaf.func.value.id == \
                                        stmt.target.id and \
                                        leaf.func.attr in rel:
                                    cb.released = True
                body_state, _t = exec_block(list(stmt.body), dict(state),
                                            finally_rel, exc_scopes)
                for name, b in body_state.items():
                    if name not in state:
                        state[name] = b
                exec_block(list(stmt.orelse), state, finally_rel,
                           exc_scopes)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                with_names: List[str] = []
                for item in stmt.items:
                    pk = kind_of(item.context_expr) \
                        if isinstance(item.context_expr, ast.Call) else None
                    if pk is not None and \
                            isinstance(item.optional_vars, ast.Name):
                        state[item.optional_vars.id] = _HBinding(
                            pk[0], stmt.lineno, pk[1])
                        with_names.append(item.optional_vars.id)
                    else:
                        # `with ch:` / `with closing(ch):` over an owned
                        # binding — __exit__ releases on every edge
                        for leaf in ast.walk(item.context_expr):
                            if isinstance(leaf, ast.Name) and \
                                    leaf.id in state:
                                with_names.append(leaf.id)
                        scan_expr(item.context_expr, state,
                                  transfer=False, fin_rel=finally_rel,
                                  scopes=exc_scopes)
                # inside the block the context manager guarantees
                # release on any unwind; after it, the handle is done
                state, t = exec_block(list(stmt.body), state,
                                      finally_rel | set(with_names),
                                      exc_scopes)
                for nm in with_names:
                    release_name(state, nm)
                if t:
                    return state, True
                continue
            if isinstance(stmt, ast.Try):
                fin_rel = finally_rel | finally_releases(
                    list(stmt.finalbody))
                # handler trust is SCOPED: each handler contributes a
                # (catch-set, released-names) entry that covers only
                # sites inside THIS try's body, and only for raises its
                # clause can actually catch
                scopes_for_body = exc_scopes
                if stmt.handlers:
                    scopes_for_body = exc_scopes + tuple(
                        (graph.handler_catch_names(h),
                         frozenset(finally_releases(list(h.body))))
                        for h in stmt.handlers)
                body_state, body_t = exec_block(list(stmt.body),
                                                dict(state), fin_rel,
                                                scopes_for_body)
                branch_states = [] if body_t else [body_state]
                if not body_t and stmt.orelse:
                    # else runs only after the body completed and is NOT
                    # covered by this try's handlers
                    body_state, t2 = exec_block(list(stmt.orelse),
                                                body_state, fin_rel,
                                                exc_scopes)
                    branch_states = [] if t2 else [body_state]
                for handler in stmt.handlers:
                    # forked bindings: a release inside the handler is
                    # trusted for this try's exception edges (the scope
                    # entry built above) but never for the code AFTER
                    # the try — the normal path never ran the handler
                    h_state, h_t = exec_block(list(handler.body),
                                              fork_state(state), fin_rel,
                                              exc_scopes)
                    if not h_t:
                        branch_states.append(h_state)
                merged = {}
                for s in branch_states:
                    for name, b in s.items():
                        if name not in merged or (merged[name].released
                                                  and not b.released):
                            merged[name] = b
                merged, fin_t = exec_block(list(stmt.finalbody), merged,
                                           finally_rel, exc_scopes)
                if not branch_states or fin_t:
                    return merged, True
                state = merged
                continue
            # anything else: scan its expressions generically
            for child in ast.iter_child_nodes(stmt):
                scan_expr(child, state, transfer=False,
                          fin_rel=finally_rel, scopes=exc_scopes)
        return state, False

    def _exec_assign(stmt, state: Dict[str, _HBinding],
                     fin_rel: Set[str], scopes: Tuple) -> None:
        targets = stmt.targets if isinstance(stmt, ast.Assign) \
            else [stmt.target]
        value = stmt.value
        if value is None:
            return
        pk = kind_of(value) if isinstance(value, ast.Call) and \
            id(value) not in consumed else None
        name_tgts = [t for t in targets if isinstance(t, ast.Name)]
        attr_tgts = [a for a in (_self_attr_of(t) for t in targets)
                     if a is not None]
        sub_local_tgts = [t for t in targets
                          if isinstance(t, ast.Subscript)
                          and _self_attr_of(t) is None]
        # rebinding a live handle's only name drops its obligation —
        # unless the value still mentions the name (`ch = ch or ...`)
        value_names = {leaf.id for leaf in ast.walk(value)
                       if isinstance(leaf, ast.Name)}
        for t in name_tgts:
            old = state.get(t.id)
            if old is not None and old.live and old.members is None and \
                    t.id not in value_names:
                report(stmt.lineno,
                       f"{display}: rebinding '{t.id}' discards the "
                       f"un-released {old.kind} created line {old.line}"
                       f"{old.origin} — the old handle leaks with no "
                       f"name left to release it; release it before "
                       f"rebinding")
                old.released = True
        if pk is not None:
            kind, origin = pk
            # the producer call itself can throw while other handles
            # are live (second-constructor leak)
            maybe_report_throw(value, state, fin_rel, scopes)
            if attr_tgts:
                for attr in attr_tgts:
                    if node.cls is not None:
                        attr_stores.append((node.module, node.cls, attr,
                                            kind, stmt.lineno, sc.path))
                if name_tgts:  # exe = self._cache[k] = producer(): both
                    for t in name_tgts:
                        state[t.id] = _HBinding(kind, stmt.lineno, origin)
                        state[t.id].released = True  # the attr owns it
                return
            if sub_local_tgts:
                report(stmt.lineno,
                       f"{display}: fresh {kind} stored straight into a "
                       f"container — its release is invisible to the "
                       f"static check; mark a deliberate registry with "
                       f"`# {_ALLOW_HANDLE_ESCAPE}`")
                return
            if name_tgts:
                for t in name_tgts:
                    state[t.id] = _HBinding(kind, stmt.lineno, origin)
                return
        # a fresh EMPTY local container: tracked so appended handles
        # become a may-leak set instead of an opaque escape
        if name_tgts and not attr_tgts and not sub_local_tgts and (
                (isinstance(value, (ast.List, ast.Set))
                 and not value.elts)
                or (isinstance(value, ast.Dict) and not value.keys)
                or (isinstance(value, ast.Call)
                    and isinstance(value.func, ast.Name)
                    and value.func.id in {"list", "set", "deque"}
                    and not value.args and not value.keywords)):
            for t in name_tgts:
                state[t.id] = _HBinding("container", stmt.lineno,
                                        members=set())
            return
        # owned name moved onto self.<attr> / into a container
        if isinstance(value, ast.Name) and value.id in state:
            b = state[value.id]
            if attr_tgts and not b.released:
                kinds = sorted(b.members) if b.members is not None \
                    else [b.kind]
                for attr in attr_tgts:
                    if node.cls is not None:
                        for k in kinds:
                            attr_stores.append((node.module, node.cls,
                                                attr, k, stmt.lineno,
                                                sc.path))
                b.released = True
                return
            if sub_local_tgts and b.live and b.members is None:
                report(stmt.lineno,
                       f"{display}: owned {b.kind} '{value.id}' escapes "
                       f"into a container — mark a deliberate registry "
                       f"with `# {_ALLOW_HANDLE_ESCAPE}`")
                b.released = True
                return
        # producers nested deeper (container literals, comprehensions,
        # conditionals) assigned somewhere
        nested = container_producers(value)
        if nested:
            if attr_tgts:
                for call in nested:
                    k = kind_of(call)[0]
                    for attr in attr_tgts:
                        if node.cls is not None:
                            attr_stores.append((node.module, node.cls,
                                                attr, k, stmt.lineno,
                                                sc.path))
            else:
                for call in nested:
                    k = kind_of(call)[0]
                    report(call.lineno,
                           f"{display}: fresh {k} constructed inside a "
                           f"local container/expression — no name owns "
                           f"it, so no release path exists; bind it "
                           f"first or mark a deliberate registry with "
                           f"`# {_ALLOW_HANDLE_ESCAPE}`")
        scan_expr(value, state, transfer=False, fin_rel=fin_rel,
                  scopes=scopes)

    def _exec_expr_stmt(stmt: ast.Expr, state: Dict[str, _HBinding],
                        fin_rel: Set[str], scopes: Tuple) -> None:
        value = stmt.value
        if isinstance(value, ast.Call) and id(value) not in consumed:
            pk = kind_of(value)
            if pk is not None:
                kind, origin = pk
                report(stmt.lineno,
                       f"{display}: result of this call is a fresh "
                       f"{kind}{origin} and is DROPPED — the native "
                       f"handle leaks immediately; bind it and release "
                       f"it ({'/'.join(sorted(releases_of(kind)))})")
                return
        scan_expr(value, state, transfer=False, fin_rel=fin_rel,
                  scopes=scopes)

    end_state, terminated = exec_block(list(node.fn.body), {}, set(), ())
    if not terminated:
        last = node.fn.body[-1]
        report_exit(end_state, getattr(last, "lineno", node.fn.lineno),
                    set(), "fall-through function exit")


def _audit_attr_stores(
        attr_stores: List[Tuple[str, str, str, str, int, str]],
        graph: CallGraph,
        sc_by_path: Dict[str, _FileScan]) -> List[Finding]:
    """Ownership-transfer audit: a handle stored on ``self.<attr>`` is
    properly owned only if its class has a release-ish method whose body
    touches that attr (``close`` iterating ``self.channels``, etc.)."""
    findings: List[Finding] = []
    seen: Set[Tuple[str, str, str]] = set()
    for module, cls, attr, kind, line, path in attr_stores:
        key = (module, cls, attr)
        if key in seen:
            continue
        seen.add(key)
        mi = graph.modules.get(module)
        ci = mi.classes.get(cls) if mi is not None else None
        if ci is None:
            continue
        released = False
        for meth_name, node_id in ci.methods.items():
            if meth_name not in _RELEASEISH_METHODS:
                continue
            meth = graph.nodes.get(node_id)
            if meth is None:
                continue
            for n in ast.walk(meth.fn):
                if isinstance(n, ast.Attribute) and n.attr == attr and \
                        isinstance(n.value, ast.Name) and \
                        n.value.id == "self":
                    released = True
                    break
            if released:
                break
        if released:
            continue
        sc = sc_by_path.get(path)
        if sc is not None and sc.line_has(line, _ALLOW_HANDLE_ESCAPE):
            continue
        findings.append(Finding(
            "handle-lifecycle", path, line,
            f"owning {kind} stored on {cls}.{attr}, but {cls} has no "
            f"close/stop/shutdown-style method touching self.{attr} — "
            f"ownership was transferred to an object that never releases "
            f"it"))
    return findings


# ---------------------------------------------------------------------------
# check: wire-contract (frame-schema symmetry + parse-path bounds)
# ---------------------------------------------------------------------------

_PACK_DIRS = {"pack", "pack_into"}
_UNPACK_DIRS = {"unpack", "unpack_from"}
#: sanctioned bounds-validation calls: a count/length passed to one of
#: these (or to any *check*-named helper) counts as validated
_WIRE_VALIDATORS = {"need", "check_count", "check_span", "read"}
#: call names whose arguments are SIZE positions (an unvalidated wire
#: count reaching one of these drives an allocation or a loop)
_SIZE_SINKS = {"frombuffer", "range", "bytearray", "zeros", "empty",
               "ones", "full"}


def _flatten_fmt(fmt: str) -> str:
    """'<qqi' -> 'qqi': strip byte-order marks and repeat digits — the
    drift comparison cares about field order and width, not grouping."""
    return "".join(ch for ch in fmt if ch.isalpha())


def _struct_consts_of(sc: _FileScan) -> Dict[str, str]:
    """Module-level ``NAME = struct.Struct("<fmt")`` constants — their
    ``.pack_into``/``.unpack_from`` uses carry the constant's format."""
    out: Dict[str, str] = {}
    for stmt in sc.tree.body:
        if not isinstance(stmt, ast.Assign) or \
                not isinstance(stmt.value, ast.Call):
            continue
        call = stmt.value
        if _last_name(call.func) == "Struct" and call.args and \
                isinstance(call.args[0], ast.Constant) and \
                isinstance(call.args[0].value, str):
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name):
                    out[tgt.id] = call.args[0].value
    return out


def _call_wire_direction(call: ast.Call,
                         struct_consts: Dict[str, str]
                         ) -> Optional[Tuple[str, Optional[str], bool]]:
    """``(direction, fmt, explicit)`` for a struct-format call site:
    ``struct.pack/pack_into/unpack/unpack_from``, a struct-Struct
    constant's method, or ``wire.read`` (unpack direction).  ``fmt`` is
    None for non-constant formats; ``explicit`` is False for Struct
    constants (their endianness is checked at the constant)."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    root = _root_name(f)
    if f.attr in _PACK_DIRS | _UNPACK_DIRS and root == "struct":
        direction = "pack" if f.attr in _PACK_DIRS else "unpack"
        fmt = None
        if call.args and isinstance(call.args[0], ast.Constant) and \
                isinstance(call.args[0].value, str):
            fmt = call.args[0].value
        return direction, fmt, True
    if f.attr == "read" and root == "wire":
        fmt = None
        if call.args and isinstance(call.args[0], ast.Constant) and \
                isinstance(call.args[0].value, str):
            fmt = call.args[0].value
        return "unpack", fmt, True
    if f.attr in _PACK_DIRS | _UNPACK_DIRS and \
            isinstance(f.value, ast.Name) and \
            f.value.id in struct_consts:
        direction = "pack" if f.attr in _PACK_DIRS else "unpack"
        return direction, struct_consts[f.value.id], False
    return None


def _fmt_stream(fn: ast.AST, struct_consts: Dict[str, str],
                direction: str) -> str:
    """The ordered, flattened struct-format characters ``fn`` moves in
    ``direction`` — what gets matched against a schema's scalar
    sequence."""
    events: List[Tuple[int, int, str]] = []
    seq = 0
    for n in ast.walk(fn):
        if not isinstance(n, ast.Call):
            continue
        hit = _call_wire_direction(n, struct_consts)
        if hit is None or hit[0] != direction or hit[1] is None:
            continue
        seq += 1
        events.append((n.lineno, seq, _flatten_fmt(hit[1])))
    events.sort()
    return "".join(e[2] for e in events)


def _is_subsequence(needle: str, hay: str) -> bool:
    it = iter(hay)
    return all(ch in it for ch in needle)


def _segment_streams(fn: ast.AST, struct_consts: Dict[str, str],
                     direction: str, key: str) -> Optional[str]:
    """The ``direction`` format stream of the dispatch branch keyed on
    string constant ``key`` — the bodies of every ``if <x> == "key"``
    (or reversed) inside ``fn``, concatenated in line order.  ``None``
    when no such branch exists (a stale segment declaration)."""
    streams: List[Tuple[int, str]] = []
    for n in ast.walk(fn):
        if not isinstance(n, ast.If):
            continue
        test = n.test
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1
                and isinstance(test.ops[0], ast.Eq)):
            continue
        operands = [test.left] + list(test.comparators)
        if not any(isinstance(c, ast.Constant) and c.value == key
                   for c in operands):
            continue
        body = ast.Module(body=n.body, type_ignores=[])
        streams.append((n.lineno,
                        _fmt_stream(body, struct_consts, direction)))
    if not streams:
        return None
    streams.sort()
    return "".join(s for _ln, s in streams)


def _prebranch_stream(fn: ast.AST, struct_consts: Dict[str, str],
                      direction: str) -> str:
    """The ``direction`` format stream OUTSIDE every string-keyed
    dispatch branch of ``fn`` — the shared header a multi-frame handler
    moves before branching on the discriminant.  Matched against a
    schema's ``prebranch`` declaration."""
    excluded: Set[int] = set()
    for n in ast.walk(fn):
        if not isinstance(n, ast.If):
            continue
        test = n.test
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1
                and isinstance(test.ops[0], ast.Eq)):
            continue
        operands = [test.left] + list(test.comparators)
        if not any(isinstance(c, ast.Constant)
                   and isinstance(c.value, str) for c in operands):
            continue
        for stmt in n.body:
            for sub in ast.walk(stmt):
                excluded.add(id(sub))
    events: List[Tuple[int, int, str]] = []
    seq = 0
    for n in ast.walk(fn):
        if not isinstance(n, ast.Call) or id(n) in excluded:
            continue
        hit = _call_wire_direction(n, struct_consts)
        if hit is None or hit[0] != direction or hit[1] is None:
            continue
        seq += 1
        events.append((n.lineno, seq, _flatten_fmt(hit[1])))
    events.sort()
    return "".join(e[2] for e in events)


def _wire_site_index(scans: List[_FileScan], graph: CallGraph
                     ) -> Dict[str, FuncNode]:
    """``"<module-basename>.<Class>.<fn>"`` / ``"<module-basename>.<fn>"``
    -> FuncNode, the resolution table for schema site qualnames."""
    out: Dict[str, FuncNode] = {}
    for node in graph.nodes.values():
        if not isinstance(node.fn, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
            continue
        base = node.module.split(".")[-1]
        out[f"{base}.{_node_display(node)}"] = node
    return out


def _norm_frame_stem(name: str) -> str:
    """'_pack_apply_id_req' / '_unpack_apply_id' -> 'apply_id': the
    name-pairing key for hand-rolled framing functions."""
    for prefix in ("_pack_", "_unpack_"):
        if name.startswith(prefix):
            name = name[len(prefix):]
            break
    for suffix in ("_req", "_rsp"):
        if name.endswith(suffix):
            name = name[:-len(suffix)]
    return name


def _load_wire_registry():
    """The schema registry + fuzz coverage table, imported lazily so the
    linter stays usable on trees that aren't this package."""
    try:
        from brpc_tpu_torch import wire as wire_mod
    except Exception:  # pragma: no cover - package not importable
        return None, None
    covers = None
    try:
        from brpc_tpu_torch.analysis import fuzz as fuzz_mod
        covers = fuzz_mod.coverage_map()
    except Exception:
        covers = None
    return wire_mod, covers


def _check_wire_contract(scans: List[_FileScan],
                         graph: CallGraph) -> List[Finding]:
    findings: List[Finding] = []
    sc_by_path = {sc.path: sc for sc in scans}
    consts_by_path = {sc.path: _struct_consts_of(sc) for sc in scans}
    site_index = _wire_site_index(scans, graph)
    scanned_modules = {mi.name.split(".")[-1]
                       for mi in graph.modules.values()}
    wire_mod, covers = _load_wire_registry()
    # the registry half only applies when the scan actually contains the
    # real package (a tmp-dir fixture scan must not fail stale-site
    # checks for modules it never included)
    in_package_scan = any(
        _stable_path(sc.path).startswith("brpc_tpu_torch/") for sc in scans)

    # -- endianness: every constant struct format must be explicit
    # little-endian (this fabric's wire order); a bare "qqq" silently
    # follows host order AND host padding
    for sc in scans:
        consts = consts_by_path[sc.path]
        for stmt in sc.tree.body:
            if isinstance(stmt, ast.Assign) and \
                    isinstance(stmt.value, ast.Call) and \
                    _last_name(stmt.value.func) == "Struct" and \
                    stmt.value.args and \
                    isinstance(stmt.value.args[0], ast.Constant) and \
                    isinstance(stmt.value.args[0].value, str) and \
                    not stmt.value.args[0].value.startswith("<"):
                findings.append(Finding(
                    "wire-contract", sc.path, stmt.lineno,
                    f"struct.Struct format "
                    f"'{stmt.value.args[0].value}' is not explicit "
                    f"little-endian — native byte order AND padding "
                    f"silently differ across hosts; prefix it with '<'"))
        for n in ast.walk(sc.tree):
            if not isinstance(n, ast.Call):
                continue
            hit = _call_wire_direction(n, consts)
            if hit is None or hit[1] is None or not hit[2]:
                continue
            if not hit[1].startswith("<"):
                findings.append(Finding(
                    "wire-contract", sc.path, n.lineno,
                    f"struct format '{hit[1]}' is not explicit "
                    f"little-endian — native byte order AND padding "
                    f"silently differ across hosts; prefix it with '<'"))

    # -- hand-rolled framing functions: collect and name-pair
    frame_fns: Dict[str, FuncNode] = {}   # site key -> node
    for key, node in site_index.items():
        if node.name.startswith(("_pack_", "_unpack_")):
            consts = consts_by_path.get(node.path, {})
            if _fmt_stream(node.fn, consts, "pack") or \
                    _fmt_stream(node.fn, consts, "unpack"):
                frame_fns[key] = node

    registry_claimed: Set[str] = set()
    schemas = dict(wire_mod.REGISTRY) if wire_mod is not None else {}
    for sch in schemas.values():
        registry_claimed.update(sch.pack_sites)
        registry_claimed.update(sch.unpack_sites)

    by_stem: Dict[Tuple[str, str], Dict[str, FuncNode]] = {}
    for key, node in frame_fns.items():
        mod = key.split(".")[0]
        stem = _norm_frame_stem(node.name)
        side = "pack" if node.name.startswith("_pack_") else "unpack"
        by_stem.setdefault((mod, stem), {})[side] = node
    for (mod, stem), sides in sorted(by_stem.items()):
        pack_node = sides.get("pack")
        unpack_node = sides.get("unpack")
        if pack_node is not None and unpack_node is not None:
            p_stream = _fmt_stream(pack_node.fn,
                                   consts_by_path[pack_node.path],
                                   "pack")
            u_stream = _fmt_stream(unpack_node.fn,
                                   consts_by_path[unpack_node.path],
                                   "unpack")
            if p_stream != u_stream:
                findings.append(Finding(
                    "wire-contract", unpack_node.path,
                    unpack_node.fn.lineno,
                    f"pack/unpack drift for frame '{stem}': "
                    f"{pack_node.name} writes field stream "
                    f"'{p_stream}' but {unpack_node.name} reads "
                    f"'{u_stream}' — the two sides disagree on field "
                    f"order or width"))
            continue
        lone = pack_node or unpack_node
        key = f"{mod}.{_node_display(lone)}"
        if key in registry_claimed:
            continue  # one-sided by declared design (native consumer,
            #           response frame) — the registry is the explanation
        findings.append(Finding(
            "wire-contract", lone.path, lone.fn.lineno,
            f"unpaired framing function {lone.name}: no "
            f"{'_unpack_' if pack_node else '_pack_'}{stem}* "
            f"counterpart in the scanned tree and no wire.REGISTRY "
            f"schema claims it — undeclared one-sided framings drift "
            f"silently; declare it in brpc_tpu_torch/wire.py"))

    # -- registry conformance: every declared site exists and its format
    # stream matches the schema
    if wire_mod is not None and in_package_scan:
        for sch in sorted(schemas.values(), key=lambda s: s.name):
            expected = "".join(
                _flatten_fmt(f) for f in sch.scalar_formats())
            for direction, sites in (("pack", sch.pack_sites),
                                     ("unpack", sch.unpack_sites)):
                for site in sites:
                    node = site_index.get(site)
                    if node is None:
                        if site.split(".")[0] in scanned_modules:
                            findings.append(Finding(
                                "wire-contract",
                                "brpc_tpu_torch/wire.py", 1,
                                f"schema '{sch.name}' names "
                                f"{direction} site '{site}' which does "
                                f"not exist in the scanned tree — the "
                                f"registry is stale"))
                        continue
                    consts = consts_by_path.get(node.path, {})
                    stream = _fmt_stream(node.fn, consts, direction)
                    seg_keys = dict(sch.segments).get(site)
                    if site in sch.exact_sites:
                        if stream != expected:
                            findings.append(Finding(
                                "wire-contract", node.path,
                                node.fn.lineno,
                                f"schema '{sch.name}' {direction} site "
                                f"{site} has field stream '{stream}', "
                                f"schema declares '{expected}' — the "
                                f"hand-rolled site drifted from the "
                                f"declared frame"))
                    elif seg_keys is not None:
                        # shared multi-frame handler with a declared
                        # dispatch discriminant: the keyed branch must
                        # carry this schema EXACTLY — subsequence can
                        # hide a reordered or restretched frame behind
                        # a sibling branch's fields.  A declared
                        # pre-branch header (shared reads outside the
                        # dispatch) prepends to the branch stream and
                        # is itself held to the actual shared reads.
                        head = dict(sch.prebranch).get(site, "")
                        if head:
                            pre = _prebranch_stream(node.fn, consts,
                                                    direction)
                            if pre != head:
                                findings.append(Finding(
                                    "wire-contract", node.path,
                                    node.fn.lineno,
                                    f"schema '{sch.name}' declares "
                                    f"pre-branch stream '{head}' for "
                                    f"{direction} site {site} but the "
                                    f"shared reads outside its "
                                    f"dispatch branches move '{pre}' "
                                    f"— the pre-branch declaration is "
                                    f"stale"))
                        for key in seg_keys:
                            seg = _segment_streams(node.fn, consts,
                                                   direction, key)
                            if seg is None:
                                findings.append(Finding(
                                    "wire-contract", node.path,
                                    node.fn.lineno,
                                    f"schema '{sch.name}' declares "
                                    f"segment '{key}' of {direction} "
                                    f"site {site} but the site has no "
                                    f"branch dispatching on '{key}' — "
                                    f"the segment declaration is "
                                    f"stale"))
                            elif head + seg != expected:
                                got = (f"'{head + seg}' (pre-branch "
                                       f"'{head}' ++ branch '{seg}')"
                                       if head else f"'{seg}'")
                                findings.append(Finding(
                                    "wire-contract", node.path,
                                    node.fn.lineno,
                                    f"schema '{sch.name}' segment "
                                    f"'{key}' of {direction} site "
                                    f"{site} has field stream {got}, "
                                    f"schema declares '{expected}' — "
                                    f"exact segmented match failed for "
                                    f"the dispatch branch"))
                    elif expected and not _is_subsequence(expected,
                                                          stream):
                        findings.append(Finding(
                            "wire-contract", node.path, node.fn.lineno,
                            f"schema '{sch.name}' {direction} site "
                            f"{site}: declared field sequence "
                            f"'{expected}' does not appear in the "
                            f"site's {direction} stream '{stream}' — "
                            f"the site drifted from the declared "
                            f"frame"))
            seg_sites = {s for s, _keys in sch.segments}
            for psite, _stream in sch.prebranch:
                if psite not in seg_sites:
                    findings.append(Finding(
                        "wire-contract", "brpc_tpu_torch/wire.py", 1,
                        f"schema '{sch.name}' declares a pre-branch "
                        f"stream for site '{psite}' with no segments "
                        f"entry for that site — an unanchored "
                        f"pre-branch declaration checks nothing; add "
                        f"the segment key or drop it"))
            if not sch.pack_sites and not sch.response:
                findings.append(Finding(
                    "wire-contract", "brpc_tpu_torch/wire.py", 1,
                    f"schema '{sch.name}' declares no pack site — an "
                    f"unproduced frame, or an undeclared producer"))
            if not sch.unpack_sites and not sch.native_sites and \
                    not sch.response:
                findings.append(Finding(
                    "wire-contract", "brpc_tpu_torch/wire.py", 1,
                    f"schema '{sch.name}' declares no unpack site and "
                    f"no native consumer — an unparsed frame, or an "
                    f"undeclared parser"))
        # text parsers must exist...
        for qual in wire_mod.TEXT_PARSERS:
            if qual not in site_index and \
                    qual.split(".")[0] in scanned_modules:
                findings.append(Finding(
                    "wire-contract", "brpc_tpu_torch/wire.py", 1,
                    f"TEXT_PARSERS names '{qual}' which does not exist "
                    f"in the scanned tree — the registry is stale"))
        # ...and every declared parser must have a fuzz target (the
        # "fuzzers for every parser" gate, SURVEY §4)
        if covers is not None:
            covered = {c for cs in covers.values() for c in cs}
            for sch in sorted(schemas.values(), key=lambda s: s.name):
                if sch.name not in covered:
                    findings.append(Finding(
                        "wire-contract", "brpc_tpu_torch/wire.py", 1,
                        f"schema '{sch.name}' has no fuzz target in "
                        f"brpc_tpu_torch.analysis.fuzz — every declared "
                        f"framing must be fuzzed"))
            for qual in wire_mod.TEXT_PARSERS:
                if qual not in covered:
                    findings.append(Finding(
                        "wire-contract", "brpc_tpu_torch/wire.py", 1,
                        f"text parser '{qual}' has no fuzz target in "
                        f"brpc_tpu_torch.analysis.fuzz — every parser must "
                        f"be fuzzed"))

    # -- unvalidated counts on parse paths
    scope: Dict[str, FuncNode] = {}
    for key, node in frame_fns.items():
        if node.name.startswith("_unpack_"):
            scope[node.node_id] = node
    if wire_mod is not None:
        for sch in schemas.values():
            for site in sch.unpack_sites:
                node = site_index.get(site)
                if node is not None:
                    scope[node.node_id] = node
    mi_by_path = {mi.path: mi for mi in graph.modules.values()}
    reach_roots: List[str] = []
    for sc in scans:
        mi = mi_by_path.get(sc.path)
        top = graph.nodes.get(f"{mi.name}:<module>") if mi else None
        reach_roots.extend(_find_handler_roots(
            sc, graph, top,
            register_names=("add_service", "add_async_service",
                            "add_ps_service", "add_stream_handler")))
    seen: Set[str] = set()
    queue = list(reach_roots)
    while queue:
        node_id = queue.pop()
        if node_id in seen:
            continue
        seen.add(node_id)
        node = graph.nodes.get(node_id)
        if node is None or node.path not in sc_by_path:
            continue
        scope.setdefault(node_id, node)
        for n in ast.walk(node.fn):
            if isinstance(n, ast.Call):
                tgt = graph.call_target(n)
                if tgt is not None:
                    queue.append(tgt)
    for node in sorted(scope.values(), key=lambda n: (n.path,
                                                      n.fn.lineno)):
        sc = sc_by_path.get(node.path)
        if sc is None:
            continue
        _scan_count_validation(sc, node,
                               consts_by_path.get(node.path, {}),
                               findings)
    return findings


def _scan_count_validation(sc: _FileScan, node: FuncNode,
                           struct_consts: Dict[str, str],
                           findings: List[Finding]) -> None:
    """Flag integer fields read off the wire that drive a SIZE (an
    allocation, a loop bound, a slice) without ever reaching a bounds
    check — the unvalidated-count hazard class (`_unpack_windows`'s
    pre-hardening loop, numpy's count=-1 re-interpretation)."""
    fn = node.fn
    display = _node_display(node)
    unpacked: Dict[str, int] = {}
    for n in ast.walk(fn):
        if not isinstance(n, ast.Assign) or \
                not isinstance(n.value, ast.Call):
            continue
        hit = _call_wire_direction(n.value, struct_consts)
        if hit is None or hit[0] != "unpack":
            continue
        for tgt in n.targets:
            leaves = [tgt] if isinstance(tgt, ast.Name) else [
                leaf for leaf in ast.walk(tgt)
                if isinstance(leaf, ast.Name)
            ] if isinstance(tgt, (ast.Tuple, ast.List, ast.Starred)) \
                else []
            for leaf in leaves:
                unpacked.setdefault(leaf.id, n.lineno)
    if not unpacked:
        return
    size_used: Dict[str, int] = {}
    validated: Set[str] = set()

    def mark_size(exprs, line: int) -> None:
        for e in exprs:
            if e is None:
                continue
            for leaf in ast.walk(e):
                if isinstance(leaf, ast.Name) and leaf.id in unpacked:
                    size_used.setdefault(leaf.id, line)

    for n in ast.walk(fn):
        if isinstance(n, ast.Call):
            fl = _last_name(n.func)
            args = list(n.args) + [kw.value for kw in n.keywords]
            if fl in _WIRE_VALIDATORS or (fl is not None
                                          and "check" in fl.lower()):
                for a in args:
                    for leaf in ast.walk(a):
                        if isinstance(leaf, ast.Name):
                            validated.add(leaf.id)
            elif fl == "frombuffer":
                mark_size(args[1:], n.lineno)
            elif fl in _SIZE_SINKS:
                mark_size(args, n.lineno)
        elif isinstance(n, ast.Subscript) and \
                isinstance(n.slice, ast.Slice):
            mark_size([n.slice.lower, n.slice.upper, n.slice.step],
                      n.lineno)
        elif isinstance(n, ast.Compare):
            for leaf in ast.walk(n):
                if isinstance(leaf, ast.Name):
                    validated.add(leaf.id)
    for name in sorted(size_used):
        if name in validated:
            continue
        findings.append(Finding(
            "wire-contract", sc.path, size_used[name],
            f"{display}: '{name}' is read off the wire (line "
            f"{unpacked[name]}) and used as a size/loop bound with no "
            f"bounds validation on any path — a hostile count drives "
            f"unbounded allocation or numpy's count=-1 whole-buffer "
            f"re-interpretation; guard it with wire.check_count / "
            f"wire.need"))


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs
                           if d not in ("__pycache__", ".git", "build")]
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
    return out


def lint_files(files: Iterable[str],
               checks: Optional[Sequence[str]] = None) -> List[Finding]:
    active = set(checks or ALL_CHECKS)
    unknown = active - set(ALL_CHECKS)
    if unknown:
        raise ValueError(
            f"unknown checks: {sorted(unknown)}; "
            f"valid checks: {', '.join(ALL_CHECKS)}")
    scans: List[_FileScan] = []
    findings: List[Finding] = []
    for path in files:
        try:
            with open(path, "r", encoding="utf-8") as f:
                src = f.read()
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:
            findings.append(Finding(
                "syntax", path, e.lineno or 0, f"does not parse: {e.msg}"))
            continue
        scans.append(_FileScan(path, tree, src.splitlines()))
    graph: Optional[CallGraph] = None
    if active & _GRAPH_CHECKS:
        graph = build_callgraph((sc.path, sc.tree) for sc in scans)
    for sc in scans:
        if "obs-guard" in active:
            findings.extend(_check_obs_guard(sc))
    if graph is not None:
        if "fiber-shared-state" in active:
            findings.extend(_check_fiber_shared_state(scans, graph))
        if "trace-purity" in active:
            findings.extend(_check_trace_purity(scans, graph))
        if "lock-order" in active:
            findings.extend(_check_lock_order(scans, graph))
        if "fiber-blocking-sleep" in active:
            findings.extend(_check_fiber_blocking_sleep(scans, graph))
        if active & {"handle-lifecycle", "exception-flow"}:
            findings.extend(_check_handle_lifecycle(scans, graph,
                                                    active))
        if "lock-exception-safety" in active:
            findings.extend(_check_lock_exception_safety(scans, graph))
        if "wire-contract" in active:
            findings.extend(_check_wire_contract(scans, graph))
    if "ctypes-contract" in active:
        findings.extend(_check_ctypes_contract(scans))
    if active & set(_NATIVE_CHECKS):
        # the cross-language tier lives in its own module (its own
        # parsing stack); import lazily so Python-only lint runs don't
        # pay for it
        from brpc_tpu_torch.analysis import native as _native
        findings.extend(_native.check_scans(
            [sc.path for sc in scans], active & set(_NATIVE_CHECKS)))
    # dedup (a nested def can be reached both inside its parent's subtree
    # and as its own call-graph node), then stable order
    seen: Set[Tuple[str, str, int, str]] = set()
    unique: List[Finding] = []
    for f in findings:
        key = (f.check, f.path, f.line, f.message)
        if key not in seen:
            seen.add(key)
            unique.append(f)
    unique.sort(key=lambda f: (f.path, f.line, f.check))
    return unique


def run_lint(paths: Sequence[str],
             checks: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint every ``.py`` file under ``paths`` (files or directories)."""
    return lint_files(_iter_py_files(paths), checks)


def load_baseline(path: str) -> Set[str]:
    """Accepted finding ids from a baseline file: either the
    ``--format=json`` / ``--write-baseline`` output or a plain list of
    ids."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    items: Iterable = ()
    if isinstance(data, dict):
        items = data.get("ids") or data.get("findings") or ()
    elif isinstance(data, list):
        items = data
    ids: Set[str] = set()
    for item in items:
        if isinstance(item, str):
            ids.add(item)
        elif isinstance(item, dict) and "id" in item:
            ids.add(str(item["id"]))
    return ids


def apply_baseline(findings: Sequence[Finding], baseline_ids: Set[str]
                   ) -> Tuple[List[Finding], List[Finding]]:
    """Split findings into (new, suppressed-by-baseline)."""
    new = [f for f in findings if f.id not in baseline_ids]
    old = [f for f in findings if f.id in baseline_ids]
    return new, old


def _default_target() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m brpc_tpu_torch.analysis",
        description="Framework-invariant linter for the brpc_tpu_torch fabric")
    parser.add_argument("paths", nargs="*",
                        help="files/directories to lint "
                             "(default: the brpc_tpu_torch package)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--check", action="append", metavar="NAME",
                        help=f"run only the named check(s); "
                             f"known: {', '.join(ALL_CHECKS)}")
    parser.add_argument("--baseline", metavar="FILE",
                        help="suppress findings whose stable id appears in "
                             "FILE (json: --write-baseline output, "
                             "--format=json output, or a list of ids)")
    parser.add_argument("--write-baseline", metavar="FILE",
                        help="write the current findings as an accepted "
                             "baseline and exit 0")
    args = parser.parse_args(argv)
    try:
        findings = run_lint(args.paths or [_default_target()], args.check)
    except ValueError as e:
        parser.error(str(e))  # exit 2, lists the valid check set
    if args.write_baseline:
        with open(args.write_baseline, "w", encoding="utf-8") as f:
            json.dump({"ids": sorted({x.id for x in findings}),
                       "findings": [x.to_dict() for x in findings]},
                      f, indent=2)
            f.write("\n")
        print(f"baseline: {len(findings)} finding(s) -> "
              f"{args.write_baseline}", file=sys.stderr)
        return 0
    suppressed: List[Finding] = []
    if args.baseline:
        try:
            baseline_ids = load_baseline(args.baseline)
        except (OSError, json.JSONDecodeError) as e:
            parser.error(f"cannot read baseline {args.baseline}: {e}")
        findings, suppressed = apply_baseline(findings, baseline_ids)
    if args.format == "json":
        payload = {
            "count": len(findings),
            "checks": list(args.check or ALL_CHECKS),
            "findings": [f.to_dict() for f in findings],
        }
        if args.baseline:
            payload["suppressed_count"] = len(suppressed)
        print(json.dumps(payload, indent=2))
    else:
        for f in findings:
            print(f.format())
        tail = f", {len(suppressed)} suppressed by baseline" \
            if suppressed else ""
        print((f"{len(findings)} finding(s){tail}" if findings
               else f"clean: no findings{tail}"), file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
