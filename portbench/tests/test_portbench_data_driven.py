"""A configuration, a traffic mix, a metric and a cell added as new files
and entries are found and run, with no edit to a file that was there."""

import hashlib
import json
import time

import torch

from portbench import harness
from portbench.tests.tiny import TINY_MODEL, tiny_root

NEW_METRIC = '''"""Requests a round."""

LAYER = "Model step"
UNIT = "requests"
MOVES = "prefill_tokens_per_s"
SOURCE = "host_clock"


def read(w):
    return len(w.units) / w.rounds
'''


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_and_run(tmp_path):
    root = tiny_root(tmp_path)
    before = digests(root)
    pb = root / "portbench"
    (pb / "configs" / "tiny-mha.json").write_text(json.dumps(
        {**TINY_MODEL, "num_key_value_heads": 4}))
    (pb / "traffic" / "tiny_burst.json").write_text(json.dumps(
        {"kind": "prefill", "batch": 1, "classes": [[32, 3]],
         "check": {"requests": 2, "positions": 8, "rounds": 1},
         "trace_seconds": 0.3, "limits": {"served_token_gap": 0.5}}))
    (pb / "metrics" / "requests_per_round.tiny.py").write_text(NEW_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-mha", "source": "tests",
                             "file": "portbench/configs/tiny-mha.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tiny_mha.burst", "config": "tiny-mha",
                               "traffic": "tiny_burst", "chips": 1,
                               "why": "tests"})
    bench["per_layer"].append({"name": "requests_per_round.tiny",
                               "unit": "requests", "better": "higher",
                               "source": "host_clock", "layer": "Model step",
                               "moves": "prefill_tokens_per_s",
                               "workloads": ["tiny_mha.burst"]})
    for spec in bench["end_to_end"]:
        if spec["name"] == "prefill_tokens_per_s":
            spec["workloads"].append("tiny_mha.burst")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cpu = [torch.device("cpu")]
    result, _, _ = harness.run(root, "tiny_mha.burst", 2 ** 40 + 3, 0.3, False,
                            time.perf_counter(), cpu)
    assert result["correct"]
    assert set(result["metrics"]) == {"prefill_tokens_per_s", "setup_s"}
    assert result["attempted"] % 3 == 0  # whole rounds of three requests
    result, _, _ = harness.run(root, "tiny_mha.burst", 2 ** 40 + 4, 0.3, True,
                            time.perf_counter(), cpu)
    assert result["correct"]
    assert result["metrics"]["requests_per_round.tiny"] == {
        "value": 3.0, "unit": "requests"}
    after = digests(root)
    assert {k: after[k] for k in before} == before


def test_rounds_are_the_same_multiset_in_an_order_from_the_seed(tmp_path):
    root = tiny_root(tmp_path)
    cpu = [torch.device("cpu")]
    orders = []
    for seed in (5, 6):
        cell, runner = harness.load_cell(root, "tiny.prefill", seed, cpu)
        orders.append([runner._order(cell, r) for r in range(4)])
    for rounds in orders:
        assert all(sorted(r) == sorted(rounds[0]) for r in rounds)
    assert orders[0] != orders[1]
    cell, runner = harness.load_cell(root, "tiny.prefill", 5, cpu)
    assert [runner._order(cell, r) for r in range(4)] == orders[0]
