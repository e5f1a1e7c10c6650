"""One run of one cell: set-up, the measured window, the metrics and the
check, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name (see the package docstring); nothing here names a
cell. A runner (``runners/<kind>.py``) gives three functions:

- ``setup(cell) -> state``: build the program's objects and inputs from the
  seed and warm up every shape the mix uses;
- ``run_round(state, index) -> units``: one round of the mix (a fixed
  multiset of work, in an order drawn from the seed), one dict a request,
  step or call, each with ``ok`` false where its output was malformed;
- ``check(state) -> [(name, value, limit), ...]``: free the program's
  state, recompute with the plain reference, and give each number
  compared beside its limit; the run is correct where every number is at
  or under its limit.

The window runs whole rounds until ``--seconds`` have passed, so every
run does the same work in the same proportions, and ends when the device
has finished the last round. A traced run profiles a window of the mix's
``trace_seconds`` (whole rounds too), which keeps its trace small enough
to read within the run.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

from portbench import trace as tracing
from portbench.model_config import load as load_json

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "brpc_tpu"})


class NoDevice(RuntimeError):
    """The machine has fewer cards than the cell asks for."""


class Spans:
    """The harness's spans around its calls into the program, kept on the
    host's real-time clock while tracing and not at all otherwise."""

    def __init__(self, on: bool):
        self.on = on
        self.records = []

    def __call__(self, name: str):
        return _Span(self, name) if self.on else _NULL


class _Span:
    __slots__ = ("spans", "name", "start")

    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.start = time.time_ns()

    def __exit__(self, *exc):
        self.spans.records.append((self.name, self.start, time.time_ns()))
        return False


class _Null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    seed: int
    devices: list
    spans: Spans
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, name: str) -> None:
        """Notes the end of a phase of the run, for the phases line."""
        synchronize(self.devices)
        self.marks.append((name, time.perf_counter()))


@dataclasses.dataclass
class Window:
    """What the metric readers read: the cell, the set-up's and the
    window's seconds on the host clock, the units of work the window ran
    and, in a traced run, its ``trace.Trace``."""
    cell: Cell
    setup_s: float
    window_s: float
    rounds: int
    units: list
    trace: object = None


def load_module(path: Path):
    """A module from a file, under a name made from its path."""
    name = "portbench_file_" + "_".join(path.with_suffix("").parts[-2:]) \
        .replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def applies(spec: dict, cell: str) -> bool:
    return "workloads" not in spec or cell in spec["workloads"]


def cuda_devices(chips: int) -> list:
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} CUDA devices; the cell "
                       f"asks for {chips}")
    return [torch.device("cuda", i) for i in range(chips)]


def synchronize(devices: list) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def power_limit(device: torch.device) -> str:
    """The card's power limit as nvidia-smi reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(device.index), "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out or "unknown"


def load_cell(root: Path, workload: str, seed: int, devices: list | None,
              traced: bool = False) -> tuple:
    """(Cell, its runner module) from ``BENCHMARK.json`` and the files it
    names. ``devices`` None takes the cell's cards and raises ``NoDevice``
    where they are missing; tests pass CPU devices."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == workload)
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    if devices is None:
        devices = cuda_devices(entry["chips"])
    traffic = load_json(root / "portbench" / "traffic"
                        / f"{entry['traffic']}.json")
    runner = load_module(root / "portbench" / "runners"
                         / f"{traffic['kind']}.py")
    return Cell(workload, load_json(root / config["file"]), traffic,
                entry["chips"], seed, devices, Spans(traced)), runner


def run(root: Path, workload: str, seed: int, seconds: float, traced: bool,
        started: float, devices: list | None = None) -> tuple:
    """Runs one cell; returns (result, checks, a line of its phases)."""
    bench = load_json(root / "BENCHMARK.json")
    cell, runner = load_cell(root, workload, seed, devices, traced)
    devices, traffic = cell.devices, cell.traffic

    cell.marks.append(("imports", time.perf_counter()))
    state = runner.setup(cell)
    cell.mark("setup")
    setup_s = time.perf_counter() - started

    limit_s = min(seconds, traffic["trace_seconds"]) if traced else seconds
    capture = tracing.Capture(devices) if traced else tracing.nothing()
    units, rounds = [], 0
    with capture:
        start = time.perf_counter()
        while True:
            units += runner.run_round(state, rounds)
            rounds += 1
            if time.perf_counter() - start >= limit_s:
                break
        synchronize(devices)
        window_s = time.perf_counter() - start
    window = Window(cell, setup_s, window_s, rounds, units,
                    capture.trace(cell.spans.records) if traced else None)

    cuda = devices[0].type == "cuda"
    device = {"platform": "gpu" if cuda else devices[0].type,
              "kind": torch.cuda.get_device_name(devices[0]) if cuda
              else devices[0].type,
              "count": len(devices),
              "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                       for d in devices) if cuda else 0}
    if cuda:
        device["power_limit"] = power_limit(devices[0])

    kind = "per_layer" if traced else "end_to_end"
    folder = "metrics" if traced else "end_to_end"
    metrics = {}
    for spec in bench[kind]:
        if not applies(spec, workload):
            continue
        value = load_module(root / "portbench" / folder
                            / f"{spec['name']}.py").read(window)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    if traced:
        t = window.trace
        device["busy_s"] = sum(t.busy_s(i) for i in t.devices) \
            / len(t.devices)
        device["window_s"] = t.window_s

    cell.mark("window and metrics")
    checks = runner.check(state)
    cell.mark("check")
    correct = all(math.isfinite(v) and v <= limit for _, v, limit in checks)
    result = {"correct": correct, "attempted": len(units),
              "failed": sum(not u["ok"] for u in units),
              "metrics": metrics, "device": device}
    if traced:
        result["breakdown"] = {"device_ops": window.trace.device_ops(),
                               "idle_gaps": window.trace.idle_gaps()}
    result["checks"] = {name: {"value": v, "limit": limit}
                        for name, v, limit in checks}
    return result, checks, phases(cell, started)


def phases(cell: Cell, started: float) -> str:
    """Seconds of each phase the run marked, from the process's start."""
    out, last = [], started
    for name, at in cell.marks:
        out.append(f"{name} {at - last:.3f}")
        last = at
    return "phases (s): " + ", ".join(out)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
