"""The port's cross-language contract tier
(``brpc_tpu_torch.analysis.native``) beside the reference's.

- Twins of ``tests/test_native_lint.py``: the tokenizer, the function
  extractor and the wire read-sequence extraction over the real
  ``cpp/capi`` translation units; seeded wrong-width and wrong-order
  native parsers, stale ``native_sites``, undeclared parsers, counts used
  as bounds before validation, undeclared or unsanctioned error codes and
  ledger bumps leaked on error paths, all flagged; the fuzzer's parity
  harness on the same width drift; the CLI, exit codes and the baseline
  round trip. The registry and the sanctioned codes are the port's.
- Parity: both packages extract the same functions and the same wire
  read sequences from every ``cpp/capi/*.cc``.
"""

import dataclasses
import json
import os
import struct
import textwrap
import types

import pytest

from brpc_tpu.analysis import native as ref_native
from brpc_tpu_torch import wire
from brpc_tpu_torch.analysis import fuzz, lint, native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPI = os.path.join(REPO, "cpp", "capi")
PKG = os.path.join(REPO, "brpc_tpu_torch")


def _fn(path, qual):
    with open(path, "r", encoding="utf-8") as f:
        fns = native.extract_functions(f.read(), path)
    hits = [fn for fn in fns if fn.qual == qual]
    assert hits, f"{qual} not extracted from {path}: " \
                 f"{sorted(f.qual for f in fns)}"
    return hits[0]


def _fixture_tree(tmp_path, cc_source, errors_h="enum RpcError "
                                                "{ EREQUEST = 1003 };"):
    (tmp_path / "cpp" / "capi").mkdir(parents=True)
    (tmp_path / "cpp" / "rpc").mkdir(parents=True)
    cc = tmp_path / "cpp" / "capi" / "fix.cc"
    cc.write_text(textwrap.dedent(cc_source))
    (tmp_path / "cpp" / "rpc" / "errors.h").write_text(errors_h)
    return str(cc), str(tmp_path)


def _schema_for(fields, site="cpp/capi/fix.cc:ServeFix"):
    sch = wire.FrameSchema(name="fix_req", fields=tuple(fields),
                           native_sites=(site,))
    return types.SimpleNamespace(REGISTRY={"fix_req": sch})


# ---------------------------------------------------------------------------
# tokenizer + extractor over the real TUs
# ---------------------------------------------------------------------------

def test_strip_preserves_length_and_lines():
    src = ('int f() {\n'
           '  const char* s = "}{ not a brace";  // } neither\n'
           '  /* } multi\n'
           '     line } */\n'
           '#define X }\n'
           '  return 0;\n'
           '}\n')
    out = native.strip_comments_and_strings(src)
    assert len(out) == len(src)
    assert out.count("\n") == src.count("\n")
    # exactly the real function braces survive
    assert out.count("{") == 1 and out.count("}") == 1


def test_extractor_finds_real_capi_functions():
    sl = _fn(os.path.join(CAPI, "ps_shard.cc"),
             "CPsService::ServeLookup")
    assert sl.buffer_params() == ["request"]
    # extern "C" ABI additions are seen too
    _fn(os.path.join(CAPI, "ps_shard.cc"), "brt_ps_shard_lookup_stats")
    # a constructor with a ctor-init-list head and the matching dtor
    stream = os.path.join(CAPI, "stream_capi.cc")
    ctor = _fn(stream, "CStreamRelay::CStreamRelay")
    assert "handle_inc" in ctor.body
    dtor = _fn(stream, "CStreamRelay::~CStreamRelay")
    assert "handle_dec" in dtor.body


def test_serve_lookup_read_sequence_extracted():
    sl = _fn(os.path.join(CAPI, "ps_shard.cc"),
             "CPsService::ServeLookup")
    events = native.wire_reads_of(sl)
    scalars = [e for e in events if e.kind == "scalar"]
    arrays = [e for e in events if e.kind == "array"]
    # count(i32) ++ [magic-peel: deadline i64] ++ count(i32) ++ ids tail
    assert [e.width for e in scalars] == [4, 8, 4]
    assert scalars[0].offset == 0
    assert len(arrays) == 1 and "count" in arrays[0].count_vars
    # the count reaches its bounds check BEFORE it drives the read
    guards = native.guarded_idents_of(sl)
    assert guards["count"] < arrays[0].line


def test_every_native_twin_schema_matched_in_tree():
    """The acceptance gate: every wire.REGISTRY schema with a declared
    C++ parse twin resolves against the real native tree and matches
    field-for-field — zero findings, zero pragmas."""
    twins = [s for s in wire.REGISTRY.values() if s.native_sites]
    assert twins, "registry lost its native twins"
    files = native.default_cpp_files(REPO)
    assert files, "cpp/capi tree missing"
    assert native.run_native_checks(files, REPO) == []


# ---------------------------------------------------------------------------
# detector power: seeded native drift (satellite fixtures)
# ---------------------------------------------------------------------------

#: wrong WIDTH: the schema says the count is i32, the seeded parser
#: reads i64 — exactly the silent-ABI-skew class the tier exists for
_WRONG_WIDTH_CC = """
    #include "x.h"
    namespace {
    void ServeFix(brt::IOBuf& request, brt::IOBuf* out) {
      int64_t count = 0;
      request.copy_to(&count, 8);
      if (count < 0 || request.size() != 8 + size_t(count) * 4) return;
      std::vector<int32_t> ids(size_t(count));
      request.copy_to(ids.data(), size_t(count) * 4, 8);
    }
    }
"""

#: wrong ORDER: schema declares (q, i), parser reads (i, q)
_WRONG_ORDER_CC = """
    #include "x.h"
    namespace {
    void ServeFix(brt::IOBuf& request, brt::IOBuf* out) {
      int32_t gen = 0;
      int64_t epoch = 0;
      request.copy_to(&gen, 4);
      request.copy_to(&epoch, 8, 4);
    }
    }
"""


def test_seeded_wrong_width_parser_flagged(tmp_path):
    cc, root = _fixture_tree(tmp_path, _WRONG_WIDTH_CC)
    wm = _schema_for([wire.Int("count", "<i"),
                      wire.Array("ids", "<i4", "count")])
    fs = native.run_native_checks([cc], root, wire_mod=wm,
                                  sanctioned={1003})
    assert any(f.check == "wire-contract-native"
               and "width/order drift" in f.message for f in fs), \
        [f.message for f in fs]


def test_seeded_wrong_order_parser_flagged(tmp_path):
    cc, root = _fixture_tree(tmp_path, _WRONG_ORDER_CC)
    wm = _schema_for([wire.Int("epoch", "<q"), wire.Int("gen", "<i")])
    fs = native.run_native_checks([cc], root, wire_mod=wm,
                                  sanctioned={1003})
    assert any("width/order drift" in f.message for f in fs)


def test_fuzzer_catches_the_same_width_drift_at_runtime():
    """Static/dynamic parity: a Python twin of the seeded wrong-width
    native parser fails ``parity_fuzz`` on schema-valid frames — the
    drift the native lint flags statically is exactly what the fuzz
    harness rejects dynamically."""
    sch = wire.FrameSchema(
        name="fix_req",
        fields=(wire.Int("count", "<i"),
                wire.Array("ids", "<i4", "count")))

    def drifted_unpack(payload):
        # the C++ fixture's behavior: reads an i64 count off an i32 frame
        (count,) = struct.unpack_from("<q", payload, 0)
        if count < 0 or len(payload) != 8 + count * 4:
            raise ValueError("bad frame")
        return count

    def good_pack(values):
        import numpy as np
        ids = np.asarray(values["ids"], np.int32)
        return struct.pack("<i", ids.size) + ids.tobytes()

    failures = fuzz.parity_fuzz(sch, good_pack, drifted_unpack,
                                seed=7, iters=20)
    assert failures and all(f.kind == "contract" for f in failures)
    # the faithful i32 parser passes the same harness
    def good_unpack(payload):
        (count,) = struct.unpack_from("<i", payload, 0)
        if count < 0 or len(payload) != 4 + count * 4:
            raise ValueError("bad frame")
        return count

    assert fuzz.parity_fuzz(sch, good_pack, good_unpack,
                            seed=7, iters=20) == []


def test_stale_native_site_flagged(tmp_path):
    cc, root = _fixture_tree(tmp_path, _WRONG_WIDTH_CC)
    wm = _schema_for([wire.Int("count", "<i")],
                     site="cpp/capi/fix.cc:ServeGone")
    fs = native.run_native_checks([cc], root, wire_mod=wm,
                                  sanctioned={1003})
    stale = [f for f in fs if "registry is stale" in f.message]
    assert stale and stale[0].path == "brpc_tpu_torch/wire.py"


def test_undeclared_native_parser_flagged(tmp_path):
    cc, root = _fixture_tree(tmp_path, """
        #include "x.h"
        namespace {
        void SneakyParse(brt::IOBuf& request) {
          int32_t gen = 0;
          request.copy_to(&gen, 4);
        }
        }
    """)
    wm = types.SimpleNamespace(REGISTRY={})
    fs = native.run_native_checks([cc], root, wire_mod=wm,
                                  sanctioned={1003})
    assert any("no wire.REGISTRY schema claims it" in f.message
               for f in fs)


def test_count_used_as_bound_before_validation_flagged(tmp_path):
    cc, root = _fixture_tree(tmp_path, """
        #include "x.h"
        namespace {
        void ServeFix(brt::IOBuf& request, brt::IOBuf* out) {
          int32_t count = 0;
          request.copy_to(&count, 4);
          std::vector<int32_t> ids(size_t(count));
          request.copy_to(ids.data(), size_t(count) * 4, 4);
        }
        }
    """)
    wm = _schema_for([wire.Int("count", "<i"),
                      wire.Array("ids", "<i4", "count")])
    fs = native.run_native_checks([cc], root, wire_mod=wm,
                                  sanctioned={1003})
    assert any("before validation" in f.message for f in fs)


# ---------------------------------------------------------------------------
# native-errors
# ---------------------------------------------------------------------------

def test_undeclared_error_code_flagged(tmp_path):
    cc, root = _fixture_tree(tmp_path, """
        #include "x.h"
        void fail_it(Controller* cntl) {
          cntl->SetFailed(EMYSTERY, "nope");
        }
    """)
    fs = native.run_native_checks(
        [cc], root, checks=["native-errors"],
        wire_mod=types.SimpleNamespace(REGISTRY={}), sanctioned={1003})
    assert any(f.check == "native-errors"
               and "EMYSTERY" in f.message for f in fs)


def test_errno_namespace_resolves_clean(tmp_path):
    # the sub-1000 code space reuses POSIX errno — ECONNRESET is legal
    # outside serve paths (brt_debug_fail_connections uses it in-tree)
    cc, root = _fixture_tree(tmp_path, """
        #include "x.h"
        void fail_it(Controller* cntl) {
          cntl->SetFailed(ECONNRESET, "injected");
        }
    """)
    fs = native.run_native_checks(
        [cc], root, checks=["native-errors"],
        wire_mod=types.SimpleNamespace(REGISTRY={}), sanctioned={1003})
    assert fs == []


def test_unsanctioned_serve_path_code_flagged(tmp_path):
    cc, root = _fixture_tree(tmp_path, """
        #include "x.h"
        namespace {
        void ServeFix(brt::IOBuf& request, Controller* cntl) {
          int32_t count = 0;
          request.copy_to(&count, 4);
          cntl->SetFailed(ELOGOFF, "drained");
        }
        }
    """, errors_h="enum RpcError { EREQUEST = 1003, ELOGOFF = 2003 };")
    wm = _schema_for([wire.Int("count", "<i")])
    fs = native.run_native_checks([cc], root, wire_mod=wm,
                                  sanctioned={1003})
    parity = [f for f in fs if f.check == "native-errors"]
    assert parity and "sanctioned" in parity[0].message
    assert "static/dynamic parity" in parity[0].message


# ---------------------------------------------------------------------------
# native-handle-balance
# ---------------------------------------------------------------------------

def test_handle_inc_leaked_on_error_return_flagged(tmp_path):
    cc, root = _fixture_tree(tmp_path, """
        #include "x.h"
        void* leaky_new() {
          brt_capi::handle_inc(brt_capi::HandleKind::kServer);
          if (!init()) {
            return nullptr;
          }
          return ptr;
        }
    """)
    fs = native.run_native_checks(
        [cc], root, checks=["native-handle-balance"],
        wire_mod=types.SimpleNamespace(REGISTRY={}))
    assert len(fs) == 1
    assert "handle_inc(kServer)" in fs[0].message
    assert "error path" in fs[0].message


def test_handle_inc_balanced_on_error_path_clean(tmp_path):
    cc, root = _fixture_tree(tmp_path, """
        #include "x.h"
        void* careful_new() {
          brt_capi::handle_inc(brt_capi::HandleKind::kServer);
          if (!init()) {
            brt_capi::handle_dec(brt_capi::HandleKind::kServer);
            return nullptr;
          }
          return ptr;
        }
    """)
    fs = native.run_native_checks(
        [cc], root, checks=["native-handle-balance"],
        wire_mod=types.SimpleNamespace(REGISTRY={}))
    assert fs == []


def test_handle_inc_then_success_return_clean(tmp_path):
    # the in-tree idiom: inc immediately before the success return
    cc, root = _fixture_tree(tmp_path, """
        #include "x.h"
        void* ok_new() {
          auto* s = make();
          if (s == nullptr) {
            return nullptr;
          }
          brt_capi::handle_inc(brt_capi::HandleKind::kServer);
          return s;
        }
    """)
    fs = native.run_native_checks(
        [cc], root, checks=["native-handle-balance"],
        wire_mod=types.SimpleNamespace(REGISTRY={}))
    assert fs == []


# ---------------------------------------------------------------------------
# CLI wiring, exit codes, baseline roundtrip
# ---------------------------------------------------------------------------

def test_cli_native_checks_run_clean_in_tree(capsys):
    rc = lint.main(["--check", "wire-contract-native",
                    "--check", "native-errors",
                    "--check", "native-handle-balance", PKG])
    assert rc == 0
    assert "clean" in capsys.readouterr().err


def test_cli_unknown_check_exits_2_and_lists_native_names(capsys):
    with pytest.raises(SystemExit) as exc:
        lint.main(["--check", "bogus", PKG])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    for name in native.NATIVE_CHECKS:
        assert name in err


def test_native_checks_skip_outside_package_scans(tmp_path):
    # a tmp fixture tree has no brpc_tpu_torch/ in its scan path: the native
    # tier must skip cleanly instead of linting the wrong repo's cpp/
    (tmp_path / "mod.py").write_text("x = 1\n")
    fs = lint.run_lint([str(tmp_path)],
                       checks=["wire-contract-native"])
    assert fs == []


def test_native_finding_baseline_roundtrip(tmp_path):
    cc, root = _fixture_tree(tmp_path, _WRONG_WIDTH_CC)
    wm = _schema_for([wire.Int("count", "<i"),
                      wire.Array("ids", "<i4", "count")])
    fs = native.run_native_checks([cc], root, wire_mod=wm,
                                  sanctioned={1003})
    assert fs
    # ids are stable: same inputs, same ids
    again = native.run_native_checks([cc], root, wire_mod=wm,
                                     sanctioned={1003})
    assert [f.id for f in fs] == [f.id for f in again]
    # cpp paths anchor machine-independently in the id hash
    assert lint._stable_path(fs[0].path).startswith("cpp/")
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps({"ids": [f.id for f in fs]}))
    new, suppressed = lint.apply_baseline(
        fs, lint.load_baseline(str(baseline)))
    assert new == [] and len(suppressed) == len(fs)


# ---------------------------------------------------------------------------
# native-endian: byte order must be proven by the parity fuzzer
# ---------------------------------------------------------------------------

#: a FAITHFUL claimed parser (matches its schema field-for-field) whose
#: multi-byte reads still need a runtime endianness witness
_ENDIAN_CC = """
    #include "x.h"
    namespace {
    void ServeFix(brt::IOBuf& request, brt::IOBuf* out) {
      int32_t count = 0;
      request.copy_to(&count, 4);
      if (count < 0 || request.size() != 4 + size_t(count) * 4) return;
      std::vector<int32_t> ids(size_t(count));
      request.copy_to(ids.data(), size_t(count) * 4, 4);
    }
    }
"""


def test_native_endian_uncovered_schema_flagged(tmp_path):
    cc, root = _fixture_tree(tmp_path, _ENDIAN_CC)
    wm = _schema_for([wire.Int("count", "<i"),
                      wire.Array("ids", "<i4", "count")])
    fs = native.run_native_checks([cc], root, checks=["native-endian"],
                                  wire_mod=wm, covers={})
    assert len(fs) == 1, [f.message for f in fs]
    f = fs[0]
    assert f.check == "native-endian"
    assert "fix_req" in f.message and "byte order" in f.message
    assert "coverage_map" in f.message


def test_native_endian_covered_schema_clean(tmp_path):
    cc, root = _fixture_tree(tmp_path, _ENDIAN_CC)
    wm = _schema_for([wire.Int("count", "<i"),
                      wire.Array("ids", "<i4", "count")])
    fs = native.run_native_checks(
        [cc], root, checks=["native-endian"], wire_mod=wm,
        covers={"fix_target": ("fix_req",)})
    assert fs == [], [f.message for f in fs]


def test_native_endian_single_byte_reads_exempt(tmp_path):
    # one-byte fields have no byte order: nothing to prove
    cc, root = _fixture_tree(tmp_path, """
        #include "x.h"
        namespace {
        void ServeFix(brt::IOBuf& request, brt::IOBuf* out) {
          uint8_t tag = 0;
          request.copy_to(&tag, 1);
        }
        }
    """)
    wm = _schema_for([wire.Int("tag", "<b")])
    fs = native.run_native_checks([cc], root, checks=["native-endian"],
                                  wire_mod=wm, covers={})
    assert fs == [], [f.message for f in fs]


def test_native_endian_in_tree_every_twin_is_fuzz_covered():
    """The acceptance gate for the sub-check: every claimed native
    parser in the REAL tree is already covered by a parity-fuzz target
    — the default coverage map closes the loop with zero findings."""
    files = native.default_cpp_files(REPO)
    assert files
    covered = set()
    for names in fuzz.coverage_map().values():
        covered.update(names)
    claimed = {s.name for s in wire.REGISTRY.values() if s.native_sites}
    assert claimed <= covered, claimed - covered
    fs = native.run_native_checks(files, REPO, checks=["native-endian"])
    assert fs == [], [f.message for f in fs]


# ---------------------------------------------------------------------------
# parity with the reference over the real translation units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(CAPI) if f.endswith(".cc")))
def test_extraction_equal_to_reference(name):
    path = os.path.join(CAPI, name)
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    ours = native.extract_functions(text, path)
    theirs = ref_native.extract_functions(text, path)
    assert ours, name
    assert [dataclasses.asdict(fn) for fn in ours] == \
        [dataclasses.asdict(fn) for fn in theirs]
    for a, b in zip(ours, theirs):
        assert [dataclasses.asdict(e) for e in native.wire_reads_of(a)] == \
            [dataclasses.asdict(e) for e in ref_native.wire_reads_of(b)]
