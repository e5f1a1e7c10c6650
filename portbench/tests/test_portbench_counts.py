"""The frozen counts against sums worked by hand at the cells' shapes."""

import json

import pytest

from portbench import counts
from portbench.model_config import load, model_shape
from portbench.tests.tiny import REPO

CONFIGS = REPO / "portbench" / "configs"


def shape(name):
    return model_shape(load(CONFIGS / f"{name}.json"))


def test_deepseek_parameters_and_buckets():
    m = shape("deepseek-llm-7b.grads")
    # embedding and head 2 x 102400 x 4096; 30 layers of 4 x 4096^2 +
    # 3 x 4096 x 11008 + 2 x 4096; the final norm 4096
    layer = 4 * 4096 ** 2 + 3 * 4096 * 11008 + 2 * 4096
    assert counts.n_params(m) == 2 * 102400 * 4096 + 30 * layer + 4096 \
        == 6_910_365_696
    spans = counts.buckets(counts.n_params(m), 25 * (1 << 20) // 4)
    assert len(spans) == 1055
    assert spans[-1] == (1054 * 6_553_600, 6_910_365_696)
    assert spans[-1][1] - spans[-1][0] == 2_871_296
    assert all(e - b == 6_553_600 for b, e in spans[:-1])


def test_eight_layer_stage_parameters():
    m = shape("deepseek-llm-7b.l8")
    assert m.layers == 8
    assert counts.n_params(m) == 2 * 102400 * 4096 + 8 * (
        4 * 4096 ** 2 + 3 * 4096 * 11008 + 2 * 4096) + 4096 == 2_457_931_776
    # AdamW's f32 param, gradient and two moments
    assert 16 * counts.n_params(m) == 39_326_908_416


def test_mistral_matmul_weights_and_flops():
    m = shape("mistral-7b-v0.3")
    layer = 4096 * (4096 + 2 * 1024) + 4096 * 4096 + 3 * 4096 * 14336
    assert counts.matmul_weights(m) == 32 * layer + 4096 * 32768 \
        == 7_113_539_584
    t = 16384
    pairs = t * (t + 1) // 2
    assert counts.prefill_flops(m, 1, t) == \
        2 * 7_113_539_584 * t + 4 * 32 * 128 * pairs * 32
    assert counts.train_flops(m, 2, t) == \
        6 * 7_113_539_584 * 2 * t + 12 * 32 * 128 * pairs * 2 * 32


def test_attention_bound_matches_the_kernel_table():
    # PERF.md's kernel table: K1 bf16 at (1, 2048), Hq 32, Hkv 8, D 128
    # is bound by operations at 0.0348 ms
    s = counts.attention_bound_s(1, 2048, 32, 8, 128)
    assert s == pytest.approx(4 * 32 * 128 * 2048 * 2049 / 2 / 989e12)
    assert round(s * 1e3, 4) == 0.0348
    # short sequences are bound by bytes: q, k, v, o once
    assert counts.attention_bound_s(1, 16, 32, 8, 128) == pytest.approx(
        (2 * 16 * 32 * 128 + 2 * 16 * 8 * 128) * 2 / 3.35e12)


def test_fabric_and_adamw_bounds():
    # PERF.md's kernel table: K4a at n = 8,388,608, R = 4: 0.1118 ms,
    # bound by NVLink (2 x 3/4 x 33.5 MB at 450 GB/s)
    assert round(counts.all_reduce_bound_s(8_388_608, 4) * 1e3, 4) == 0.1118
    assert counts.all_reduce_bound_s(8_388_608, 1) == pytest.approx(
        8 * 8_388_608 / 3.35e12)
    assert counts.adamw_bound_s(1000) == pytest.approx(28_000 / 3.35e12)


def test_kinds_classify_the_port_kernels():
    from portbench import kinds

    assert kinds.kind("void flash_fwd_wgmma_kernel<128>(...)") == \
        "flash_attention"
    assert kinds.kind("void all_reduce_kernel<4>(Inputs, Outputs)") == \
        "fabric"
    assert kinds.kind("sm90_xmma_gemm_bf16bf16_bf16f32") == "matmul"
    assert kinds.kind("void at::native::multi_tensor_apply_kernel<"
                      "FusedAdamMathFunctor<float, 4>>") == "optimizer"
    assert kinds.kind("void at::native::unrolled_elementwise_kernel<"
                      "direct_copy_kernel_cuda>") == "copy_cast"
    assert kinds.kind("Memcpy DtoD (Device -> Device)") == "copy_cast"
    assert kinds.kind("void at::native::vectorized_elementwise_kernel<"
                      "4, at::native::FillFunctor<float>>") == "other"


def test_benchmark_names_the_metrics():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert [m["name"] for m in bench["end_to_end"]] == [
        "prefill_tokens_per_s", "prefill_ms_p95", "train_tokens_per_s",
        "setup_s"]
    assert sorted(m["name"] for m in bench["per_layer"]) == sorted([
        "mfu.prefill", "mfu.train", "copy_cast_ms.short",
        "k1_roofline.prefill", "adamw_roofline.train", "idle_share.prefill",
        "idle_share.train"])
