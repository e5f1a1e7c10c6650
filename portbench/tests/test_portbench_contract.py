"""What the benchmark may import, and the shape of ``BENCHMARK.json``."""

import ast
import json
import re
import statistics
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.tiny import REPO

PB = REPO / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# Modules of the yardstick: none may import the program.
PROGRAM_FREE = ["counts.py", "kinds.py", "weights.py", "model_config.py",
                "trace.py", "reference/__init__.py", "reference/llama.py",
                "reference/train.py", "reference/allreduce.py"]


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("path", sorted(p.relative_to(PB).as_posix()
                                        for p in PB.rglob("*.py")))
def test_no_jax_and_no_reference_package(path):
    tops = {name.split(".")[0] for name in imported(PB / path)}
    assert not tops & harness.FORBIDDEN, tops & harness.FORBIDDEN


@pytest.mark.parametrize("path", PROGRAM_FREE)
def test_yardstick_imports_nothing_of_the_port(path):
    tops = {name.split(".")[0] for name in imported(PB / path)}
    assert "brpc_tpu_torch" not in tops


def test_references_load_nothing_of_the_port():
    code = ("import sys; import portbench.reference.llama, "
            "portbench.reference.train, portbench.reference.allreduce, "
            "portbench.counts, portbench.kinds; print(sorted({m.split('.')[0]"
            " for m in sys.modules} & {'brpc_tpu_torch', 'brpc_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "brpc_tpu_torch_like", object())
    assert "brpc_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert harness.forbidden_modules() == ["jaxlib"]


def test_run_without_a_card_prints_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "deepseek7b.train", "--seed", str(2 ** 31 + 9), "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""


def test_benchmark_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"][1] == "portbench/run.py"
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert 1 <= len(c["why"]) <= 200 and all(NAME.match(k)
                                                  for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (PB / "traffic" / f"{w['traffic']}.json").is_file()
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) \
        == len(b["workloads"])
    fours = sum(w["chips"] == 4 for w in b["workloads"])
    assert fours <= max(1, len(b["workloads"]) // 4)
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names) and all(map(NAME.match, names))
    assert len(json.dumps(b)) < 64 * 1024


def test_run_seconds_fits_a_full_check():
    s = bench()["run_seconds"]
    assert 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_end_to_end_metrics():
    b = bench()
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (PB / "end_to_end" / f"{m['name']}.py").is_file()


def test_per_layer_metrics_match_their_readers():
    b = bench()
    reported = {w["name"]: {m["name"] for m in b["end_to_end"]
                            if harness.applies(m, w["name"])}
                for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        reader = harness.load_module(PB / "metrics" / f"{m['name']}.py")
        assert (reader.LAYER, reader.UNIT, reader.MOVES, reader.SOURCE) == (
            m["layer"], m["unit"], m["moves"], m["source"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        for cell in m["workloads"]:
            assert m["moves"] in reported[cell]
    for cell, e2e in reported.items():
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(harness.applies(m, cell) for m in b["per_layer"])


def test_configuration_files():
    from portbench.model_config import load, model_shape

    for c in bench()["configs"]:
        data = load(REPO / c["file"])
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert set(c["reduced"]) <= set(data)
        m = model_shape(data)
        assert m.hidden == 4096 and m.head_dim == 128


def test_spread_is_the_quartiles_over_the_median():
    from portbench import spread

    values = [100.0, 101.0, 99.0, 100.5, 99.5, 100.2]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert spread.spread(values) == (q3 - q1) / statistics.median(values)
    lines = [json.dumps({"metrics": {"x": {"value": v, "unit": "s"}}})
             for v in values]
    assert spread.metrics(lines) == {"x": values}
