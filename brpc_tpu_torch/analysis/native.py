"""Cross-language contract tier: clang-free static analysis of the
native C API sources (``cpp/capi/*.cc``).

The Python tier's contracts — the :mod:`brpc_tpu_torch.wire` frame schemas,
the ``errors.h`` code space, the native handle ledger — are shared with
hand-written C++ on the other side of the ABI, and the Python lint checks
only ever saw the Python half.  This module closes that gap the same
clang-free way ``tests/test_capi_contract.py`` proved viable: a
comment/string-aware tokenizer plus a brace-matching function-body
extractor, generalized from the test's regex parser into a reusable
mini-frontend, feeding three lint checks that ride the normal CLI,
stable-finding-id, and baseline machinery of
:mod:`brpc_tpu_torch.analysis.lint`:

- ``wire-contract-native`` — for every :mod:`brpc_tpu_torch.wire` schema that
  declares a ``native_sites`` twin (``"cpp/capi/ps_shard.cc:CPsService::
  ServeLookup"``), the named C++ function's extracted wire **read
  sequence** (fixed-width ``copy_to`` loads, array/length reads, size
  guards) must carry the schema's fields in order and at the declared
  widths/offsets; counts that drive an array read must reach a guard
  first; magic-dispatch schemas must actually compare their magic; and
  any scanned function that parses a wire buffer without a claiming
  schema is an undeclared parser.  Stale ``native_sites`` entries are
  findings too — the registry is only trustworthy if it cannot rot.
- ``native-errors`` — every ``SetFailed(CODE, ...)`` constant must
  resolve (``errors.h`` enum, or the POSIX errno namespace the sub-1000
  code space reuses), and serve-path handlers (the ``native_sites``
  twins) may only fail with codes the live fuzzer sanctions
  (:data:`brpc_tpu_torch.analysis.fuzz.SANCTIONED_LIVE_CODES` + the wire
  reject code) — the static half of static/dynamic parity.
- ``native-handle-balance`` — generalizes the ledger symmetry test
  beyond ``_new``/``_destroy`` pairing: within one function, a
  ``handle_inc`` followed by an error return (``nullptr``/``NULL``/
  error constant) with no interleaving ``handle_dec`` leaks a ledger
  count on exactly the path the pairing test never walks.
- ``native-endian`` — byte order on the native side is only PROVEN by
  the runtime parity fuzzer; every claimed native parser whose
  extracted read stream moves a multi-byte scalar must have its
  claiming schema covered by a fuzz target
  (:func:`brpc_tpu_torch.analysis.fuzz.coverage_map`) — an uncovered
  multi-byte read is an endianness assumption no harness exercises.

Everything here is stdlib-only and operates on source text; no
compiler, no clang bindings, no build tree.  The extraction layer
(:func:`strip_comments_and_strings`, :func:`extract_functions`,
:func:`wire_reads_of`) is public so tests and the bench harness can
drive it over fixture TUs directly.
"""

from __future__ import annotations

import dataclasses
import errno as _errno_mod
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "NATIVE_CHECKS", "CppFunction", "ReadEvent",
    "strip_comments_and_strings", "extract_functions", "wire_reads_of",
    "error_codes_of", "handle_events_of", "parse_errors_h",
    "default_cpp_files", "run_native_checks", "check_scans",
]

#: the check names this module implements (mirrored in lint.ALL_CHECKS)
NATIVE_CHECKS = ("wire-contract-native", "native-errors", "native-endian",
                 "native-handle-balance")

#: control keywords that look like `name (...) {` but open plain blocks
_CTRL_KEYWORDS = frozenset({
    "if", "for", "while", "switch", "catch", "return", "sizeof", "new",
    "delete", "throw", "else", "do", "alignof", "decltype", "defined",
})

#: struct-format character -> byte width (the wire.py scalar vocabulary)
_FMT_WIDTH = {"b": 1, "B": 1, "h": 2, "H": 2, "i": 4, "I": 4,
              "q": 8, "Q": 8, "f": 4, "d": 8}


# ---------------------------------------------------------------------------
# tokenizer: comment/string-aware source cleaning
# ---------------------------------------------------------------------------

def strip_comments_and_strings(src: str) -> str:
    """Blank out comments, string/char literal contents, and preprocessor
    directives, preserving length and line structure exactly — brace
    matching and regex scans over the result cannot be confused by a
    ``"}"`` in a log message or a commented-out early return."""
    out = list(src)
    i, n = 0, len(src)
    state = "code"          # code | line | block | str | chr
    line_start = True       # at start-of-line modulo whitespace
    while i < n:
        c = src[i]
        nxt = src[i + 1] if i + 1 < n else ""
        if state == "code":
            if line_start and c == "#":
                # preprocessor directive: blank to end of (continued) line
                while i < n and src[i] != "\n":
                    if src[i] == "\\" and i + 1 < n and src[i + 1] == "\n":
                        out[i] = " "
                        i += 2
                        continue
                    out[i] = " "
                    i += 1
                continue
            if c == "/" and nxt == "/":
                out[i] = out[i + 1] = " "
                i += 2
                state = "line"
                continue
            if c == "/" and nxt == "*":
                out[i] = out[i + 1] = " "
                i += 2
                state = "block"
                continue
            if c == '"':
                i += 1
                state = "str"
                continue
            if c == "'":
                i += 1
                state = "chr"
                continue
            if c == "\n":
                line_start = True
            elif not c.isspace():
                line_start = False
            i += 1
            continue
        if state == "line":
            if c == "\n":
                state = "code"
                line_start = True
                i += 1
                continue
            out[i] = " "
            i += 1
            continue
        if state == "block":
            if c == "*" and nxt == "/":
                out[i] = out[i + 1] = " "
                i += 2
                state = "code"
                continue
            if c != "\n":
                out[i] = " "
            i += 1
            continue
        # str / chr: blank contents, keep the delimiters
        quote = '"' if state == "str" else "'"
        if c == "\\" and i + 1 < n:
            out[i] = out[i + 1] = " "
            i += 2
            continue
        if c == quote:
            i += 1
            state = "code"
            continue
        if c != "\n":
            out[i] = " "
        i += 1
    return "".join(out)


# ---------------------------------------------------------------------------
# function-body extraction (the generalized brace parser)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CppFunction:
    """One function (or method) definition found in a cleaned TU."""

    name: str            # last qualname component ("ServeLookup")
    qual: str            # context-qualified ("CPsService::ServeLookup")
    path: str
    line: int            # 1-based line of the opening brace
    params: str          # cleaned parameter-list text
    body: str            # cleaned body text, outer braces excluded
    body_line: int       # 1-based line where `body` starts

    def buffer_params(self) -> List[str]:
        """Names of ``IOBuf&`` parameters — the wire-parse surfaces."""
        return re.findall(r"IOBuf\s*&\s*(\w+)", self.params)


_HEAD_RE = re.compile(
    r"([A-Za-z_~][\w]*(?:\s*::\s*~?[A-Za-z_~][\w]*)*)\s*(\()")

#: what may legally sit between a definition head's `)` and its `{`:
#: cv/ref qualifiers, virt-specifiers, a ctor init list, a trailing
#: return — anything else means the `(...)` was not a parameter list
_TAIL_RE = re.compile(
    r"(?:\s|const\b|noexcept\b|override\b|final\b|&&?|"
    r"->\s*[\w:<>,&*\s]*|:\s*[^;{]*)*$")


def _segment_head(segment: str) -> Optional[Tuple[str, str]]:
    """If ``segment`` (the text between the last statement boundary and
    an opening brace) looks like a function definition head, return
    ``(qualname, params_text)``.  Scans candidates left-to-right so a
    ctor init list (``Foo(...) : a_(x), b_(y)``) resolves to the ctor,
    not the last initializer's parens."""
    for m in _HEAD_RE.finditer(segment):
        qual = re.sub(r"\s+", "", m.group(1))
        last = qual.split("::")[-1].lstrip("~")
        if last in _CTRL_KEYWORDS or qual in _CTRL_KEYWORDS:
            continue
        before = segment[:m.start()]
        # a head sits at statement level; an initializer / argument /
        # assignment context disqualifies the candidate
        if re.search(r"[=,.?(]|\breturn\b", before):
            continue
        # balanced close of the candidate parameter list
        depth = 0
        close = None
        for idx in range(m.start(2), len(segment)):
            if segment[idx] == "(":
                depth += 1
            elif segment[idx] == ")":
                depth -= 1
                if depth == 0:
                    close = idx
                    break
        if close is None:
            continue
        if _TAIL_RE.fullmatch(segment[close + 1:]) is None:
            continue
        return qual, segment[m.end(2):close]
    return None


def extract_functions(src: str, path: str,
                      cleaned: Optional[str] = None) -> List[CppFunction]:
    """All function/method definitions in ``src`` (outermost only —
    nested lambdas stay part of their enclosing body).  Class/struct
    nesting contributes to ``qual``."""
    text = cleaned if cleaned is not None else \
        strip_comments_and_strings(src)
    out: List[CppFunction] = []
    # context stack entries: ("class", name) | ("fn", record) | ("block",)
    stack: List[Tuple] = []
    seg_start = 0
    paren_depth = 0
    line = 1
    in_fn = 0
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "\n":
            line += 1
        elif c == "(":
            paren_depth += 1
        elif c == ")":
            paren_depth = max(0, paren_depth - 1)
        elif c == ";" and paren_depth == 0:
            seg_start = i + 1
        elif c == "{":
            segment = text[seg_start:i]
            entry: Tuple = ("block",)
            if paren_depth == 0 and not in_fn:
                cls = re.search(r"\b(?:class|struct)\s+([A-Za-z_]\w*)"
                                r"[^;(]*$", segment)
                head = _segment_head(segment.strip()) if cls is None \
                    else None
                if cls is not None:
                    entry = ("class", cls.group(1))
                elif head is not None:
                    qual, params = head
                    classes = [e[1] for e in stack if e[0] == "class"]
                    fullqual = "::".join(classes + [qual]) if classes \
                        else qual
                    entry = ("fn", {"qual": fullqual,
                                    "name": qual.split("::")[-1],
                                    "params": params,
                                    "line": line,
                                    "body_start": i + 1,
                                    "body_line": line})
            if entry[0] == "fn":
                in_fn += 1
            elif in_fn:
                entry = ("block",)
            stack.append(entry)
            seg_start = i + 1
        elif c == "}":
            if stack:
                entry = stack.pop()
                if entry[0] == "fn":
                    in_fn -= 1
                    rec = entry[1]
                    out.append(CppFunction(
                        name=rec["name"], qual=rec["qual"], path=path,
                        line=rec["line"], params=rec["params"],
                        body=text[rec["body_start"]:i],
                        body_line=rec["body_line"]))
            seg_start = i + 1
        i += 1
    out.sort(key=lambda f: f.line)
    return out


# ---------------------------------------------------------------------------
# wire read-sequence extraction
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReadEvent:
    """One ordered wire access in a function body."""

    kind: str                      # "scalar" | "array"
    line: int
    width: Optional[int] = None    # scalar byte width / array elem width
    dest: str = ""                 # scalar destination variable
    offset: Optional[int] = None   # literal byte offset, when constant
    count_vars: Tuple[str, ...] = ()   # identifiers driving an array len


_NON_COUNT_IDENTS = frozenset({
    "size_t", "int", "int32_t", "int64_t", "uint32_t", "uint64_t",
    "uint8_t", "int8_t", "char", "long", "short", "unsigned", "signed",
    "static_cast", "reinterpret_cast", "const_cast", "sizeof", "data",
    "off", "offset", "pos",
})


def _split_args(text: str) -> List[str]:
    """Top-level comma split of an argument list."""
    args: List[str] = []
    depth = 0
    cur = []
    for ch in text:
        if ch in "([<{":
            depth += 1
        elif ch in ")]>}":
            depth -= 1
        if ch == "," and depth == 0:
            args.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    tail = "".join(cur).strip()
    if tail:
        args.append(tail)
    return args


def _int_literal(text: str) -> Optional[int]:
    t = text.strip()
    m = re.fullmatch(r"(0[xX][0-9a-fA-F]+|\d+)(?:[uUlL]*)", t)
    if m is None:
        return None
    return int(m.group(1), 0)


def _balanced_call_args(body: str, open_idx: int) -> Tuple[str, int]:
    """Text of the argument list whose ``(`` sits at ``open_idx``."""
    depth = 0
    for j in range(open_idx, len(body)):
        if body[j] == "(":
            depth += 1
        elif body[j] == ")":
            depth -= 1
            if depth == 0:
                return body[open_idx + 1:j], j
    return body[open_idx + 1:], len(body)


def wire_reads_of(fn: CppFunction,
                  buffers: Optional[Sequence[str]] = None
                  ) -> List[ReadEvent]:
    """The ordered wire read sequence of ``fn`` over its ``IOBuf&``
    parameters (or an explicit ``buffers`` name list): fixed-width
    ``copy_to`` loads become scalar events, variable-length ``copy_to``/
    ``memcpy`` reads become array events carrying the identifiers that
    drive their length."""
    bufs = list(buffers) if buffers is not None else fn.buffer_params()
    if not bufs:
        return []
    events: List[ReadEvent] = []
    pat = re.compile(r"\b(%s)\s*\.\s*copy_to\s*(\()" %
                     "|".join(re.escape(b) for b in bufs))
    for m in pat.finditer(fn.body):
        argtext, _end = _balanced_call_args(fn.body, m.start(2))
        args = _split_args(argtext)
        if len(args) < 2:
            continue
        line = fn.body_line + fn.body.count("\n", 0, m.start())
        size_lit = _int_literal(args[1])
        off_lit = _int_literal(args[2]) if len(args) > 2 else 0
        dest = args[0].lstrip("&").strip()
        if size_lit is not None and size_lit <= 16 and \
                args[0].lstrip().startswith("&"):
            events.append(ReadEvent("scalar", line, width=size_lit,
                                    dest=dest, offset=off_lit))
        else:
            mult = None
            mm = re.search(r"\*\s*(\d+)\s*$", args[1]) or \
                re.match(r"^\s*(\d+)\s*\*", args[1])
            if mm:
                mult = int(mm.group(1))
            cvars = tuple(sorted(
                set(re.findall(r"[A-Za-z_]\w*", args[1])) -
                _NON_COUNT_IDENTS - set(bufs)))
            events.append(ReadEvent("array", line, width=mult,
                                    dest=dest, offset=off_lit,
                                    count_vars=cvars))
    events.sort(key=lambda e: e.line)
    return events


def guarded_idents_of(fn: CppFunction) -> Dict[str, int]:
    """Identifier -> first line where it takes part in a comparison (an
    ``if``/``while`` condition or a standalone relational expression) —
    the coarse bounds-validation signal, mirroring the Python check's
    "appears in any Compare" rule."""
    out: Dict[str, int] = {}
    for m in re.finditer(r"\b(?:if|while)\s*(\()", fn.body):
        cond, _ = _balanced_call_args(fn.body, m.start(1))
        if not re.search(r"[<>]|[!=]=", cond):
            continue
        line = fn.body_line + fn.body.count("\n", 0, m.start())
        for ident in set(re.findall(r"[A-Za-z_]\w*", cond)):
            if ident not in _NON_COUNT_IDENTS:
                out.setdefault(ident, line)
    return out


# ---------------------------------------------------------------------------
# error-code and handle-ledger extraction
# ---------------------------------------------------------------------------

def error_codes_of(fn: CppFunction) -> List[Tuple[str, int]]:
    """``(code_text, line)`` for every ``SetFailed(CODE, ...)`` in the
    body; CODE is an identifier or an integer literal (non-constant
    first arguments — trampoline passthroughs — are skipped)."""
    out: List[Tuple[str, int]] = []
    for m in re.finditer(r"\bSetFailed\s*\(\s*(E[A-Z][A-Z0-9_]*|\d+)\s*,",
                         fn.body):
        line = fn.body_line + fn.body.count("\n", 0, m.start())
        out.append((m.group(1), line))
    return out


def handle_events_of(fn: CppFunction) -> List[Tuple[str, str, int]]:
    """Ordered ``("inc"|"dec"|"return", detail, line)`` events: ledger
    bumps (detail = handle kind text) and return statements (detail =
    the returned expression text)."""
    events: List[Tuple[int, str, str, int]] = []
    for m in re.finditer(r"\bhandle_(inc|dec)\s*\(([^)]*)\)", fn.body):
        line = fn.body_line + fn.body.count("\n", 0, m.start())
        kind = m.group(2).strip().split("::")[-1]
        events.append((m.start(), m.group(1), kind, line))
    for m in re.finditer(r"\breturn\b\s*([^;]*);", fn.body):
        line = fn.body_line + fn.body.count("\n", 0, m.start())
        events.append((m.start(), "return",
                       re.sub(r"\s+", " ", m.group(1).strip()), line))
    events.sort()
    return [(k, d, ln) for _pos, k, d, ln in events]


def parse_errors_h(path: str) -> Dict[str, int]:
    """``NAME -> value`` for the RpcError enum in ``errors.h``."""
    with open(path, "r", encoding="utf-8") as f:
        text = strip_comments_and_strings(f.read())
    out: Dict[str, int] = {}
    for m in re.finditer(r"\b(E[A-Z0-9_]+)\s*=\s*(-?\d+)", text):
        out[m.group(1)] = int(m.group(2))
    return out


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def _schema_events(sch) -> List[Tuple]:
    """Flatten a FrameSchema into expected native read events:
    ``("scalar", width, field_name, offset_or_None)`` and
    ``("array", elem_bytes_or_None, count_field)``.  Offsets are only
    known while every prior field is fixed-width."""
    from brpc_tpu_torch import wire as wire_mod
    out: List[Tuple] = []
    offset: Optional[int] = 0

    def walk(fields) -> None:
        nonlocal offset
        for f in fields:
            if isinstance(f, wire_mod.Int):
                width = _FMT_WIDTH.get(f.fmt.lstrip("<>=!@"), None)
                out.append(("scalar", width, f.name, offset))
                offset = None if offset is None or width is None \
                    else offset + width
            elif isinstance(f, wire_mod.Array):
                import numpy as _np
                elem = _np.dtype(f.dtype).itemsize \
                    if f.mult == 1 else None
                out.append(("array", elem, f.count))
                offset = None
            elif isinstance(f, wire_mod.Bytes):
                out.append(("bytes", None, f.length))
                offset = None
            elif isinstance(f, wire_mod.Group):
                walk(f.fields)
                offset = None
            else:  # Tail
                offset = None

    walk(sch.fields)
    return out


def _match_schema(sch, fn: CppFunction, events: List[ReadEvent],
                  guards: Dict[str, int], magic: Optional[int],
                  finding, findings: List) -> None:
    """Field-for-field match of one schema against one native function's
    extracted read sequence."""
    expected = _schema_events(sch)
    scalars = [e for e in events if e.kind == "scalar"]
    arrays = [e for e in events if e.kind == "array"]
    exp_widths = [e[1] for e in expected if e[0] == "scalar"]
    got_stream = "/".join(f"{e.width}B@{e.offset if e.offset is not None else '?'}"
                          for e in scalars)
    # in-order width subsequence (the handler may serve several schemas)
    bound: Dict[str, ReadEvent] = {}
    it = iter(scalars)
    matched: List[ReadEvent] = []
    ok = True
    for kind, width, fname, exp_off in [e for e in expected
                                        if e[0] == "scalar"]:
        hit = None
        for ev in it:
            if ev.width == width:
                hit = ev
                break
        if hit is None:
            ok = False
            break
        if exp_off is not None and hit.offset is not None and \
                hit.offset not in (exp_off, None) and hit.offset != exp_off:
            findings.append(finding(
                fn, f"schema '{sch.name}' field '{fname}' is read at "
                    f"byte offset {hit.offset}, the schema places it at "
                    f"{exp_off} — native field-order drift"))
        bound[fname] = hit
        matched.append(hit)
    if not ok:
        findings.append(finding(
            fn, f"schema '{sch.name}' declares scalar widths "
                f"{exp_widths} but native site {fn.qual} reads "
                f"'{got_stream or '<none>'}' — width/order drift between "
                f"the C++ parser and the declared frame"))
        return
    # arrays: an array read driven by the bound count variable
    for kind, elem, count_field in [e for e in expected
                                    if e[0] == "array"]:
        cb = bound.get(count_field)
        hits = [a for a in arrays
                if cb is not None and cb.dest in a.count_vars]
        if not hits:
            findings.append(finding(
                fn, f"schema '{sch.name}': no native array read driven "
                    f"by count field '{count_field}' in {fn.qual} — the "
                    f"array tail is not parsed off the declared count"))
            continue
        hit = hits[0]
        if elem is not None and hit.width is not None and \
                hit.width != elem:
            findings.append(finding(
                fn, f"schema '{sch.name}': native array read in "
                    f"{fn.qual} moves {hit.width}-byte elements, the "
                    f"schema declares {elem}-byte elements — element "
                    f"width drift"))
        # the count must reach a guard BEFORE it drives the read
        gline = guards.get(cb.dest) if cb is not None else None
        if gline is None or gline > hit.line:
            findings.append(finding(
                fn, f"schema '{sch.name}': count '{cb.dest}' drives an "
                    f"array read in {fn.qual} without a preceding "
                    f"bounds check — a hostile count is used as a bound "
                    f"before validation"))
    # magic-dispatch schemas must test their magic constant
    if magic is not None:
        pat = re.compile(r"\b(?:0[xX]%x|%d)\b" % (magic, magic),
                         re.IGNORECASE)
        if not pat.search(fn.body):
            findings.append(finding(
                fn, f"schema '{sch.name}': native site {fn.qual} never "
                    f"compares the magic constant 0x{magic:X} — the "
                    f"dispatch sentinel is not checked"))


def _schema_magic(wire_mod, sch) -> Optional[int]:
    """The dispatch sentinel for magic-prefixed schemas, resolved from
    the wire module's constants (``deadline_hdr`` -> DEADLINE_MAGIC)."""
    if not sch.fields or getattr(sch.fields[0], "name", "") != "magic":
        return None
    table = {
        "deadline_hdr": getattr(wire_mod, "DEADLINE_MAGIC", None),
        "deadline_hdr_v2": getattr(wire_mod, "DEADLINE_MAGIC2", None),
    }
    return table.get(sch.name)


def default_cpp_files(repo_root: str) -> List[str]:
    """The scanned native surface: every C API translation unit."""
    capi = os.path.join(repo_root, "cpp", "capi")
    if not os.path.isdir(capi):
        return []
    return sorted(os.path.join(capi, f) for f in os.listdir(capi)
                  if f.endswith(".cc"))


def _load_fn_index(cpp_files: Iterable[str]
                   ) -> Tuple[Dict[str, List[CppFunction]],
                              List[CppFunction]]:
    """Parse every TU once: path-keyed function lists + flat list."""
    by_path: Dict[str, List[CppFunction]] = {}
    flat: List[CppFunction] = []
    for path in cpp_files:
        try:
            with open(path, "r", encoding="utf-8") as f:
                src = f.read()
        except OSError:
            continue
        fns = extract_functions(src, path)
        by_path[path] = fns
        flat.extend(fns)
    return by_path, flat


def _resolve_site(site: str, repo_root: str,
                  by_path: Dict[str, List[CppFunction]]
                  ) -> Tuple[Optional[CppFunction], Optional[str]]:
    """``"cpp/capi/ps_shard.cc:CPsService::ServeLookup"`` -> the parsed
    function, loading the TU on demand if it was outside the default
    scan set.  Returns (fn, resolved_path)."""
    if ":" not in site:
        return None, None
    rel, qual = site.split(":", 1)
    path = os.path.join(repo_root, *rel.split("/"))
    if path not in by_path:
        if not os.path.isfile(path):
            return None, None
        with open(path, "r", encoding="utf-8") as f:
            by_path[path] = extract_functions(f.read(), path)
    want = qual.split("::")[-1]
    for fn in by_path[path]:
        if fn.qual == qual or fn.name == want:
            return fn, path
    return None, path


def run_native_checks(cpp_files: Sequence[str], repo_root: str,
                      checks: Optional[Iterable[str]] = None,
                      wire_mod=None, errors_h: Optional[str] = None,
                      sanctioned: Optional[Set[int]] = None,
                      covers=None) -> List:
    """Run the native checks over ``cpp_files``; returns lint Findings.

    ``wire_mod``/``errors_h``/``sanctioned``/``covers`` are injectable
    so fixture tests can drive the checks against seeded TUs and
    synthetic registries; by default the real :mod:`brpc_tpu_torch.wire`,
    ``cpp/rpc/errors.h`` and the fuzzer's sanctioned set and coverage
    map are used."""
    from brpc_tpu_torch.analysis.lint import Finding
    active = set(checks if checks is not None else NATIVE_CHECKS)
    findings: List[Finding] = []
    by_path, flat = _load_fn_index(cpp_files)

    if wire_mod is None:
        try:
            from brpc_tpu_torch import wire as wire_mod  # type: ignore
        except Exception:  # pragma: no cover - package not importable
            wire_mod = None

    def finding_at(fn: CppFunction, msg: str,
                   check: str = "wire-contract-native") -> Finding:
        return Finding(check, fn.path, fn.line, msg)

    claimed: Dict[str, str] = {}   # resolved fn id -> schema name
    serve_fns: List[CppFunction] = []
    if wire_mod is not None:
        for sch in sorted(wire_mod.REGISTRY.values(),
                          key=lambda s: s.name):
            for site in sch.native_sites:
                fn, _path = _resolve_site(site, repo_root, by_path)
                if fn is None:
                    if "wire-contract-native" in active:
                        findings.append(Finding(
                            "wire-contract-native", "brpc_tpu_torch/wire.py",
                            1,
                            f"schema '{sch.name}' names native site "
                            f"'{site}' which does not exist in the "
                            f"native tree — the registry is stale"))
                    continue
                claimed[f"{fn.path}:{fn.qual}"] = sch.name
                serve_fns.append(fn)
                if "wire-contract-native" in active:
                    _match_schema(sch, fn, wire_reads_of(fn),
                                  guarded_idents_of(fn),
                                  _schema_magic(wire_mod, sch),
                                  finding_at, findings)

    if "wire-contract-native" in active:
        # reverse direction: a scanned function that parses wire fields
        # off an IOBuf parameter without a claiming schema
        for fn in flat:
            key = f"{fn.path}:{fn.qual}"
            if key in claimed:
                continue
            scalars = [e for e in wire_reads_of(fn)
                       if e.kind == "scalar"]
            if scalars:
                findings.append(finding_at(
                    fn, f"native function {fn.qual} reads "
                        f"{len(scalars)} fixed-width wire field(s) off "
                        f"an IOBuf parameter but no wire.REGISTRY "
                        f"schema claims it via native_sites — "
                        f"undeclared native parsers drift silently"))

    if "native-errors" in active:
        enum: Dict[str, int] = {}
        path = errors_h if errors_h is not None else os.path.join(
            repo_root, "cpp", "rpc", "errors.h")
        if os.path.isfile(path):
            enum = parse_errors_h(path)
        if sanctioned is None:
            try:
                from brpc_tpu_torch.analysis import fuzz as fuzz_mod
                sanctioned = set(fuzz_mod.SANCTIONED_LIVE_CODES)
            except Exception:  # pragma: no cover
                sanctioned = None
        serve_ids = {f"{fn.path}:{fn.qual}" for fn in serve_fns}
        for fn in flat:
            for code_text, line in error_codes_of(fn):
                value = _int_literal(code_text)
                if value is None:
                    value = enum.get(code_text)
                    if value is None:
                        value = getattr(_errno_mod, code_text, None)
                    if value is None:
                        findings.append(Finding(
                            "native-errors", fn.path, line,
                            f"{fn.qual} fails with '{code_text}' which "
                            f"resolves in neither errors.h nor the "
                            f"errno namespace — an undeclared error "
                            f"code crosses the ABI untyped"))
                        continue
                if f"{fn.path}:{fn.qual}" in serve_ids and \
                        sanctioned is not None and \
                        value not in sanctioned:
                    findings.append(Finding(
                        "native-errors", fn.path, line,
                        f"serve-path handler {fn.qual} fails with "
                        f"{code_text} ({value}) which is not in the "
                        f"live fuzzer's sanctioned code set — the "
                        f"dynamic harness would flag this at runtime "
                        f"(static/dynamic parity)"))

    if "native-handle-balance" in active:
        for fn in flat:
            live: List[Tuple[str, int]] = []   # (kind, inc line)
            for kind, detail, line in handle_events_of(fn):
                if kind == "inc":
                    live.append((detail, line))
                elif kind == "dec":
                    for i, (k, _ln) in enumerate(live):
                        if k == detail:
                            live.pop(i)
                            break
                elif kind == "return" and live:
                    val = detail
                    errorish = val in ("nullptr", "NULL") or \
                        _int_literal(val) == 0 and val != "" or \
                        re.fullmatch(r"-\s*\d+|E[A-Z0-9_]+", val) \
                        is not None
                    if errorish:
                        for k, inc_line in live:
                            findings.append(Finding(
                                "native-handle-balance", fn.path, line,
                                f"{fn.qual}: handle_inc({k}) at line "
                                f"{inc_line} is not balanced on the "
                                f"error path returning '{val}' — the "
                                f"ledger leaks a count on exactly the "
                                f"path the new/destroy pairing test "
                                f"never walks"))

    if "native-endian" in active:
        # Byte order on the C++ side is only PROVEN by the runtime
        # parity fuzzer (the native parser and the Python reference
        # unpack the same frames).  Gate the hole: every claimed native
        # parser whose extracted read stream moves a multi-byte scalar
        # must have its claiming schema covered by some fuzz target —
        # an uncovered multi-byte read is an endianness assumption no
        # harness ever exercises.
        if covers is None:
            try:
                from brpc_tpu_torch.analysis import fuzz as fuzz_mod
                covers = fuzz_mod.coverage_map()
            except Exception:  # pragma: no cover - fuzzer unavailable
                covers = None
        if covers is not None:
            covered: Set[str] = set()
            for names in covers.values():
                covered.update(names)
            for fn in serve_fns:
                sch_name = claimed.get(f"{fn.path}:{fn.qual}")
                if sch_name is None or sch_name in covered:
                    continue
                multi = [e for e in wire_reads_of(fn)
                         if e.kind == "scalar" and e.width > 1]
                if multi:
                    findings.append(Finding(
                        "native-endian", fn.path, multi[0].line,
                        f"native parser {fn.qual} reads "
                        f"{len(multi)} multi-byte wire field(s) for "
                        f"schema '{sch_name}' but no runtime "
                        f"parity-fuzz target covers that schema "
                        f"(fuzz.coverage_map) — its byte order is "
                        f"never proven against the Python reference; "
                        f"add a fuzz target covering '{sch_name}'"))
    return findings


def check_scans(scan_paths: Sequence[str],
                checks: Iterable[str]) -> List:
    """Lint-driver entry point: locate the native tree relative to the
    scanned package (the repo root is the parent of ``brpc_tpu_torch/``) and
    run the active native checks.  Scans that do not include the real
    package (tmp-dir fixture trees) skip cleanly — same gating as the
    Python registry checks."""
    root: Optional[str] = None
    for p in scan_paths:
        parts = os.path.normpath(os.path.abspath(p)).split(os.sep)
        if "brpc_tpu_torch" in parts:
            root = os.sep.join(
                parts[:parts.index("brpc_tpu_torch")]) or os.sep
            break
    if root is None:
        return []
    files = default_cpp_files(root)
    if not files:
        return []
    return run_native_checks(files, root, checks)
