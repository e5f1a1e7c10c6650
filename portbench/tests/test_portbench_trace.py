"""The trace reduction and the metric readers on windows made by hand."""

import pytest

from portbench import counts, harness
from portbench.model_config import load, model_shape
from portbench.trace import Trace
from portbench.tests.tiny import REPO

MS = 1_000_000  # ns
K1 = "void wg::flash_fwd_wgmma_kernel<128>(...)"
GEMM = "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT"
CAST = "void at::native::vectorized_elementwise_kernel<8, " \
    "at::native::bfloat16_copy_kernel_cuda>"
ADAM = "void at::native::multi_tensor_apply_kernel<FusedAdamMathFunctor>"
K4 = "void all_reduce_kernel<4>(Inputs, Outputs, int, long long)"


def reader(folder, name):
    return harness.load_module(REPO / "portbench" / folder / f"{name}.py")


def window(config, units, kernels, spans=(), devices=(0,), seconds=1.0):
    cell = harness.Cell("hand", load(REPO / "portbench" / "configs"
                                     / f"{config}.json"), {}, len(devices),
                        0, [], harness.Spans(True))
    cell.spans.records = list(spans)
    trace = Trace(kernels, list(spans), (0, int(seconds * 1e9)),
                  list(devices))
    return harness.Window(cell, 1.0, seconds, 1, units, trace)


def test_busy_is_the_union_within_the_window():
    t = Trace([(0, "a", -2 * MS, 3 * MS), (0, "b", 2 * MS, 5 * MS),
               (0, "c", 7 * MS, 12 * MS), (1, "d", 0, 10 * MS)], [],
              (0, 10 * MS), [0, 1])
    assert t.busy(0) == [[0, 5 * MS], [7 * MS, 10 * MS]]
    assert t.busy_s(0) == pytest.approx(0.008)
    assert t.idle_share(0) == pytest.approx(0.2)
    assert t.idle_share(1) == 0.0


def test_idle_gaps_are_named_by_the_innermost_span():
    spans = [("request.T512", 0, 6 * MS), ("sync", 0, 10 * MS),
             ("all_reduce_sum", 6 * MS, 8 * MS)]
    t = Trace([(0, "k", 1 * MS, 2 * MS), (0, "k", 5 * MS, 7 * MS)], spans,
              (0, 10 * MS), [0])
    gaps = dict(t.idle_gaps())
    assert gaps == {"request.T512 (2 gaps)": pytest.approx(0.004),
                    "all_reduce_sum (1 gaps)": pytest.approx(0.003)}
    assert t.device_ops() == [["k", pytest.approx(0.003)]]


def test_prefill_readers():
    m = model_shape(load(REPO / "portbench" / "configs"
                         / "mistral-7b-v0.3.json"))
    units = [{"b": 1, "t": 512, "latency_s": 0.05, "ok": True},
             {"b": 1, "t": 1024, "latency_s": 0.06, "ok": True}]
    kernels = [(0, K1, 0, 10 * MS), (0, GEMM, 10 * MS, 30 * MS),
               (0, CAST, 30 * MS, 38 * MS)]
    w = window("mistral-7b-v0.3", units, kernels, seconds=0.1)
    bound = 32 * (counts.attention_bound_s(1, 512, 32, 8, 128)
                  + counts.attention_bound_s(1, 1024, 32, 8, 128))
    assert reader("metrics", "k1_roofline.prefill").read(w) == \
        pytest.approx(100 * bound / 0.010)
    assert reader("metrics", "copy_cast_ms.short").read(w) == \
        pytest.approx(4.0)
    assert reader("metrics", "idle_share.prefill").read(w) == \
        pytest.approx(62.0)
    flops = counts.prefill_flops(m, 1, 512) + counts.prefill_flops(m, 1, 1024)
    assert reader("metrics", "mfu.prefill").read(w) == \
        pytest.approx(100 * flops / (0.1 * 989e12))
    assert reader("end_to_end", "prefill_tokens_per_s").read(w) == \
        pytest.approx(1536 / 0.1)
    assert reader("end_to_end", "prefill_ms_p95").read(w) == \
        pytest.approx(60.0)


def test_a_reader_with_nothing_to_read_gives_nothing():
    w = window("mistral-7b-v0.3", [{"b": 1, "t": 512, "latency_s": 0.05,
                                    "ok": True}], [(0, GEMM, 0, MS)])
    assert reader("metrics", "k1_roofline.prefill").read(w) is None
    assert reader("metrics", "copy_cast_ms.short").read(w) is None
    assert reader("metrics", "adamw_roofline.train").read(w) is None
    empty = window("mistral-7b-v0.3", [], [])
    assert reader("metrics", "idle_share.prefill").read(empty) is None


def test_train_readers():
    m = model_shape(load(REPO / "portbench" / "configs"
                         / "deepseek-llm-7b.l8.json"))
    units = [{"b": 2, "t": 2048, "ok": True}] * 3
    w = window("deepseek-llm-7b.l8", units,
               [(0, ADAM, 0, 30 * MS), (0, GEMM, 30 * MS, 700 * MS)])
    assert reader("metrics", "adamw_roofline.train").read(w) == \
        pytest.approx(100 * 3 * counts.adamw_bound_s(counts.n_params(m))
                      / 0.030)
    assert reader("metrics", "mfu.train").read(w) == pytest.approx(
        100 * 3 * counts.train_flops(m, 2, 2048) / 989e12)
    assert reader("end_to_end", "train_tokens_per_s").read(w) == \
        pytest.approx(3 * 4096)


def test_sync_readers_take_the_slowest_card_of_each_call():
    units = [{"n": 1000, "ok": True}, {"n": 500, "ok": True}]
    kernels = [(0, K4, 0, 2 * MS), (1, K4, 0, 3 * MS),
               (0, K4, 4 * MS, 5 * MS), (1, K4, 4 * MS, 4 * MS + MS // 2)]
    spans = [("all_reduce_sum", 0, 1000), ("all_reduce_sum", 0, 3000)]
    w = window("deepseek-llm-7b.grads", units, kernels, spans, (0, 1),
               seconds=0.01)
    bound = counts.all_reduce_bound_s(1000, 2) \
        + counts.all_reduce_bound_s(500, 2)
    assert reader("metrics", "k4_roofline.sync").read(w) == \
        pytest.approx(100 * bound / 0.004)
    assert reader("metrics", "host_us_per_call.sync").read(w) == \
        pytest.approx(2.0)
    assert reader("metrics", "idle_share.sync").read(w) == \
        pytest.approx(100 * (1 - 0.003 / 0.01))  # the idler card
    assert reader("end_to_end", "allreduce_GBps").read(w) == \
        pytest.approx(6000 / 0.01 / 1e9)
