"""The readers of the program's spans (``program_spans.py`` and the seven
metrics of source ``program_span`` and ``program_counter``) on windows
made by hand: spans with device intervals, and the trace's kernels."""

import pytest

from brpc_tpu_torch.obs import rpcz
from portbench import counts, harness, program_spans
from portbench.model_config import load
from portbench.tests.tiny import REPO
from portbench.trace import Trace

MS = 1_000_000  # ns
MARKER = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
PREFILL = ["forward_host_ms.prefill", "forward_idle_ms.prefill",
           "forward_kernels.prefill", "cast_roofline.prefill"]
TRAIN = ["forward_ms.train", "backward_ms.train", "optimizer_ms.train"]


def reader(name):
    return harness.load_module(REPO / "portbench" / "metrics"
                               / f"{name}.py")


def span(name, host, device=None, device_index=0, **counts):
    service, _, method = name.partition(".")
    s = rpcz.Span(service, method, side="user", start_ns=host[0],
                  end_ns=host[1])
    if device is not None:
        s.device = device_index
        s.device_start_ns, s.device_end_ns = device
    s.counts.update(counts)
    return s


def window(monkeypatch, spans, kernels, seconds=1.0):
    """A traced window over [0, seconds] whose program recorded ``spans``."""
    monkeypatch.setattr(rpcz, "captured", lambda lo, hi, kernels: [
        s for s in spans if lo <= s.start_ns and s.end_ns <= hi])
    cell = harness.Cell("hand", load(REPO / "portbench" / "configs"
                                     / "mistral-7b-v0.3.json"), {}, 1, 0, [],
                        harness.Spans(True))
    trace = Trace(kernels, [], (0, int(seconds * 1e9)), [0])
    return harness.Window(cell, 1.0, seconds, 1, [], trace)


def test_a_kernel_belongs_to_the_span_that_holds_its_midpoint(monkeypatch):
    s = span("llama.forward", (0, 5 * MS), device=(10 * MS, 20 * MS))
    kernels = [(0, "a", 9 * MS, 12 * MS),    # midpoint 10.5: inside
               (0, "b", 7 * MS, 11 * MS),    # midpoint 9: outside
               (0, "c", 19 * MS, 22 * MS),   # midpoint 20.5: outside
               (0, "d", 18 * MS, 21 * MS),   # midpoint 19.5: inside
               (1, "e", 12 * MS, 13 * MS)]   # another card
    w = window(monkeypatch, [s], kernels)
    assert program_spans.inside(w, s) == [(9 * MS, 12 * MS),
                                          (18 * MS, 21 * MS)]
    assert program_spans.busy_ns([(0, 4), (2, 6), (8, 9)]) == 7
    assert program_spans.busy_ns([(0, 4), (2, 6), (8, 9)], 1, 8) == 5


def test_prefill_readers(monkeypatch):
    spans = [
        span("llama.forward", (0, 20 * MS), device=(2 * MS, 30 * MS)),
        span("llama.cast", (1 * MS, 2 * MS), device=(3 * MS, 6 * MS),
             bytes=6_000_000_000),
        span("llama.cast", (3 * MS, 4 * MS), device=(20 * MS, 25 * MS),
             bytes=3_000_000_000),
        span("llama.forward", (40 * MS, 70 * MS), device=(41 * MS, 50 * MS)),
        span("request.T512", (0, 21 * MS)),  # another name: not read
    ]
    kernels = [(0, "embed", 2 * MS, 3 * MS),
               (0, "cast", 3 * MS, 5 * MS), (0, "cast", 5 * MS, 6 * MS),
               (0, "gemm", 8 * MS, 18 * MS),
               (0, "cast", 20 * MS, 24 * MS),
               (0, "gemm", 24 * MS, 31 * MS),   # midpoint 27.5: inside
               (0, "gemm", 41 * MS, 45 * MS), (0, "gemm", 44 * MS, 47 * MS),
               (0, MARKER, 6 * MS, 7 * MS),  # markers are no work
               (0, MARKER, 48 * MS, 49 * MS)]
    w = window(monkeypatch, spans, kernels)
    assert reader("forward_host_ms.prefill").read(w) == \
        pytest.approx((20 + 30) / 2)
    # first: 28 ms, busy 2-6, 8-18, 20-31 clipped to 30: 4 + 10 + 10;
    # second: 9 ms, busy 41-47
    assert reader("forward_idle_ms.prefill").read(w) == \
        pytest.approx(((28 - 24) + (9 - 6)) / 2)
    assert reader("forward_kernels.prefill").read(w) == (6 + 2) / 2
    assert reader("cast_roofline.prefill").read(w) == pytest.approx(
        100 * 9e9 / counts.HBM_BYTES_PER_S / ((2 + 1 + 4) / 1e3))


def test_train_readers(monkeypatch):
    spans, kernels = [], []
    for step in range(2):
        t = step * 100 * MS
        spans += [span("step", (t, t + 90 * MS)),  # the harness's
                  span("train.forward", (t, t + 10 * MS),
                       device=(t, t + 30 * MS)),
                  span("train.backward", (t + 10 * MS, t + 20 * MS),
                       device=(t + 30 * MS, t + 80 * MS)),
                  span("train.optimizer", (t + 20 * MS, t + 21 * MS),
                       device=(t + 80 * MS, t + 95 * MS))]
        kernels += [(0, "f", t + 1 * MS, t + 11 * MS),
                    (0, "f", t + 5 * MS, t + 21 * MS),       # overlaps
                    (0, "b", t + 29 * MS, t + 70 * MS + step * MS),
                    (0, "o", t + 81 * MS, t + 93 * MS)]
    w = window(monkeypatch, spans, kernels)
    assert reader("forward_ms.train").read(w) == pytest.approx(20.0)
    assert reader("backward_ms.train").read(w) == pytest.approx(41.5)
    assert reader("optimizer_ms.train").read(w) == pytest.approx(12.0)


def test_spans_outside_the_window_are_not_read(monkeypatch):
    spans = [span("llama.forward", (0, 10 * MS), device=(0, 10 * MS)),
             span("llama.forward", (2000 * MS, 2010 * MS),
                  device=(2000 * MS, 2010 * MS))]
    w = window(monkeypatch, spans, [(0, "k", 1 * MS, 2 * MS)])
    assert reader("forward_kernels.prefill").read(w) == 1
    assert reader("forward_host_ms.prefill").read(w) == pytest.approx(10)


@pytest.mark.parametrize("name", PREFILL + TRAIN)
def test_every_reader_gives_nothing_without_program_spans(monkeypatch, name):
    kernels = [(0, "k", 0, MS)]
    w = window(monkeypatch, [span("request.T512", (0, MS))], kernels)
    assert reader(name).read(w) is None
    # a program with no capture store, as before the program recorded spans
    monkeypatch.delattr(rpcz, "captured")
    assert reader(name).read(w) is None


@pytest.mark.parametrize("name", PREFILL[1:] + TRAIN)
def test_device_readers_give_nothing_without_device_intervals(monkeypatch,
                                                               name):
    """A CPU run: the spans are there, with no interval on a device."""
    spans = [span(n, (0, MS), bytes=6) for n in
             ("llama.forward", "llama.cast", "train.forward",
              "train.backward", "train.optimizer")]
    w = window(monkeypatch, spans, [(0, "k", 0, MS)])
    assert reader(name).read(w) is None
    assert reader("forward_host_ms.prefill").read(w) == pytest.approx(1.0)


def test_cast_roofline_needs_bytes_and_device_time(monkeypatch):
    s = span("llama.cast", (0, MS), device=(0, MS))
    w = window(monkeypatch, [s], [(0, "cast", 0, MS)])
    assert reader("cast_roofline.prefill").read(w) is None  # no bytes
    s.counts["bytes"] = 6
    w = window(monkeypatch, [s], [])
    assert reader("cast_roofline.prefill").read(w) is None  # no kernel
