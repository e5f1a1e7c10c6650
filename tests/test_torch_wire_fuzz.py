"""The port's wire fuzzer (``brpc_tpu_torch.analysis.fuzz``) beside the
reference's.

- Twins of ``tests/test_wire_fuzz.py``: the seeded run over every Python
  parser of the port, determinism, the corpus replay of
  ``tests/fuzz_corpus/`` (named by target) against the port's parsers,
  the mutation engine's teeth on a pre-hardening parser, numpy's
  ``count=-1`` crasher, the CLI, and (native) mutated requests and stream
  frames against the port's live ``PsShardServer`` with the port's handle
  ledger flat.
- Parity: both fuzzers name the same targets, yield byte-equal mutated
  frames for every schema of the registry at seeds 0 and 1, and run the
  same cases per target with no failure on either side.
"""

import os
import random
import struct
import subprocess
import sys

import numpy as np
import pytest

from brpc_tpu import wire as ref_wire
from brpc_tpu.analysis import fuzz as ref_fuzz
from brpc_tpu_torch import wire
from brpc_tpu_torch.analysis import fuzz

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fuzz_corpus")

#: tier-1 budget: enough to hit every mutation class per target, small
#: enough to stay a smoke test (full runs use the CLI with more)
SMOKE_ITERS = 120


def test_seeded_fuzz_smoke_all_python_parsers_green():
    report = fuzz.run(seed=0, iters=SMOKE_ITERS)
    assert report["ok"], report["failures"]
    # every target actually executed its budget
    for name, stats in report["targets"].items():
        assert stats["execs"] == SMOKE_ITERS, name


def test_second_seed_also_green_and_deterministic():
    r1 = fuzz.run(seed=7, iters=40, memcheck=False)
    r2 = fuzz.run(seed=7, iters=40, memcheck=False)
    assert r1["ok"] and r2["ok"]
    assert list(r1["targets"]) == list(r2["targets"])


def test_corpus_replays_green():
    replayed, failures = fuzz.replay_corpus(CORPUS)
    assert replayed >= 20
    assert failures == [], [f.format() for f in failures]


def test_fuzzer_catches_pre_hardening_parsers():
    """Detector power: the PRE-hardening ``_unpack_windows`` (verbatim)
    must crash under the same seeded stream the hardened tree survives.
    A mutation-engine regression that stops finding these fails here."""

    def old_unpack_windows(payload, offset=0):
        (count,) = struct.unpack_from("<i", payload, offset)
        offset += 4
        windows = {}
        for _ in range(count):
            (wlen,) = struct.unpack_from("<i", payload, offset)
            offset += 4
            w = bytes(payload[offset:offset + wlen]).decode(
                errors="replace")
            offset += wlen
            (seq,) = struct.unpack_from("<q", payload, offset)
            offset += 8
            windows[w] = seq
        return windows, offset

    target = fuzz.FuzzTarget(
        "old_windows", ("windows",),
        lambda rng, n: fuzz.mutated_frames(
            wire.REGISTRY["windows"], rng, n),
        old_unpack_windows)
    _, _, failures = fuzz.run_target(target, 0, 200, memcheck=False)
    assert any(f.kind == "crash" for f in failures), \
        "the mutation engine no longer crashes the unguarded parser"


def test_count_minus_one_is_a_wire_error_not_a_silent_parse():
    """The flagship crasher: numpy's count=-1 'read everything'
    re-interpretation parsed SILENTLY pre-hardening (garbage ids and
    grads that can pass the range check) — it must be a WireError."""
    from brpc_tpu_torch import ps_remote
    p = struct.pack("<i", -1) + np.arange(16, dtype=np.int32).tobytes()
    with pytest.raises(wire.WireError):
        ps_remote._unpack_apply(p, 0, 1 << 30, 1)


def test_fuzz_cli_seeded_run_exits_zero():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "brpc_tpu_torch.analysis.fuzz",
         "--seed", "1", "--iters", "25", "--no-memcheck"],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 failure(s)" in proc.stderr


def test_fuzz_cli_corpus_replay_exits_zero():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "brpc_tpu_torch.analysis.fuzz",
         "--corpus", CORPUS],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 regression(s)" in proc.stdout


@pytest.mark.needs_native
def test_live_server_fuzz_sanctioned_codes_and_flat_ledger():
    report = fuzz.fuzz_live(0, iters=SMOKE_ITERS)
    assert report["ok"], report["failures"]
    assert report["execs"] > 100
    seen = {int(c) for c in report["codes_seen"]}
    assert seen <= set(fuzz.SANCTIONED_LIVE_CODES)
    # the native parse path and the Python wire guards both fired
    assert 1003 in seen or 2001 in seen
    assert wire.EBADFRAME in seen


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

PARITY_FRAMES = 24  # mutated frames a schema and seed


def test_target_names_and_coverage_equal_to_reference():
    assert [t.name for t in fuzz.python_targets()] == \
        [t.name for t in ref_fuzz.python_targets()]
    assert fuzz.coverage_map() == ref_fuzz.coverage_map()
    assert fuzz.SANCTIONED_LIVE_CODES == ref_fuzz.SANCTIONED_LIVE_CODES
    assert sorted(wire.REGISTRY) == sorted(ref_wire.REGISTRY)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(wire.REGISTRY))
def test_mutated_frames_byte_equal_to_reference(name, seed):
    ours = list(fuzz.mutated_frames(wire.REGISTRY[name], random.Random(seed),
                                    PARITY_FRAMES))
    theirs = list(ref_fuzz.mutated_frames(ref_wire.REGISTRY[name],
                                          random.Random(seed),
                                          PARITY_FRAMES))
    assert len(ours) == PARITY_FRAMES and ours == theirs


def test_seeded_run_same_cases_as_reference():
    ours = fuzz.run(seed=3, iters=30, memcheck=False)
    theirs = ref_fuzz.run(seed=3, iters=30, memcheck=False)
    assert ours["ok"] and theirs["ok"], (ours["failures"],
                                         theirs["failures"])
    assert {k: v["execs"] for k, v in ours["targets"].items()} == \
        {k: v["execs"] for k, v in theirs["targets"].items()}
