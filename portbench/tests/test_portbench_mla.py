"""The DeepSeek-V2 cell's pieces: its configuration file and reader, its
counts against sums worked by hand at the cell's shapes, its four
per-layer readers on a fake window, and its runner's units and checks
and its controls on the CPU at a tiny size."""

import json
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import counts, harness, mla_counts, mla_weights
from portbench.mla_config import mla_shape
from portbench.model_config import load, model_shape
from portbench.moe_config import moe_shape
from portbench.tests.tiny import REPO, tiny_root

CONFIG = REPO / "portbench" / "configs" / "deepseek-v2-lite.json"
CELL = "deepseekv2lite.prefill_long"
# Tiny but for the head dims, which K1 (the runner's attention) takes.
TINY_MLA = {
    "source": "a tiny model with DeepSeek-V2's equations, for tests",
    "reduced": [], "compute_dtype": "bfloat16", "param_dtype": "float32",
    "hidden_act": "silu", "hidden_size": 64, "intermediate_size": 128,
    "num_attention_heads": 2, "num_key_value_heads": 2,
    "num_hidden_layers": 3, "rms_norm_eps": 1e-6, "rope_theta": 10000,
    "tie_word_embeddings": False, "vocab_size": 512, "kv_lora_rank": 32,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "v_head_dim": 128, "n_routed_experts": 8, "num_experts_per_tok": 3,
    "moe_intermediate_size": 32, "n_shared_experts": 2,
    "first_k_dense_replace": 1, "norm_topk_prob": False,
    "routed_scaling_factor": 1.0, "scoring_func": "softmax",
    "topk_method": "greedy",
    "rope_scaling": {"type": "yarn", "factor": 40, "beta_fast": 32,
                     "beta_slow": 1, "mscale": 0.707,
                     "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096},
}


def test_the_file_is_the_published_config_whole():
    config = load(CONFIG)
    catalog = {"first_k_dense_replace": 1, "hidden_size": 2048,
               "intermediate_size": 10944, "kv_lora_rank": 512,
               "moe_intermediate_size": 1408, "n_routed_experts": 64,
               "n_shared_experts": 2, "num_attention_heads": 16,
               "num_experts_per_tok": 6, "num_hidden_layers": 27,
               "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
               "v_head_dim": 128, "vocab_size": 102400}
    assert {key: config[key] for key in catalog} == catalog
    assert config["reduced"] == [] and config["q_lora_rank"] is None
    m = mla_shape(config)
    assert (m.qk_head, m.shared_intermediate, m.expert_layers) == \
        (192, 2816, 26)
    assert m.yarn_args()["factor"] == 40.0


@pytest.mark.parametrize("other", ["mistral-7b-v0.3.json",
                                   "mixtral-8x7b.l16.json"])
def test_mla_shape_refuses_llama_and_mixtral_files(other):
    with pytest.raises(ValueError, match="not a latent-attention"):
        mla_shape(load(REPO / "portbench" / "configs" / other))


@pytest.mark.parametrize("reader", [model_shape, moe_shape])
def test_the_llama_and_expert_readers_refuse_this_file(reader):
    with pytest.raises(ValueError):
        reader(load(CONFIG))


@pytest.mark.parametrize("change", [{"q_lora_rank": 1536},
                                    {"scoring_func": "sigmoid"},
                                    {"n_group": 8},
                                    {"routed_scaling_factor": 2.5},
                                    {"rope_scaling": {"type": "linear"}}])
def test_mla_shape_refuses_equations_it_does_not_implement(change):
    with pytest.raises(ValueError):
        mla_shape({**load(CONFIG), **change})


def test_counts_at_the_cell_shapes():
    m = mla_shape(load(CONFIG))
    attention = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 \
        + 16 * 128 * 2048
    assert attention == 13_762_560
    assert mla_counts.attention_weights(m) == attention
    routed, shared = 3 * 2048 * 1408, 3 * 2048 * 2816
    active = 27 * attention + 3 * 2048 * 10944 \
        + 26 * (2048 * 64 + 6 * routed + shared) + 2048 * 102400
    assert mla_counts.active_weights(m) == active == 2_451_308_544
    total = 27 * (attention + 512 + 2 * 2048) + 3 * 2048 * 10944 \
        + 26 * (2048 * 64 + 64 * routed + shared) + 2 * 102400 * 2048 + 2048
    assert mla_counts.n_params(m) == total == 15_706_484_224
    pairs = 32768 * 32769 // 2
    assert mla_counts.prefill_flops(m, 1, 32768) == \
        2 * active * 32768 + 27 * 2 * 16 * 320 * pairs
    # attention at 32k is bound by its operations
    assert mla_counts.attention_bound_s(m, 1, 32768) == pytest.approx(
        2 * 16 * 320 * pairs / counts.PEAK_BF16_FLOPS)
    # 32768 pairs over 64 experts and the shared rows: operations
    assert mla_counts.experts_bound_s(m, 6 * 32768, 64, 32768) == \
        pytest.approx(2 * (6 * 32768 * routed + 32768 * shared) / 989e12)
    # one row: the weights it reaches, read once
    assert mla_counts.experts_bound_s(m, 6, 64, 1) == pytest.approx(
        (6 * routed + shared) * 2 / counts.HBM_BYTES_PER_S)


def test_weights_are_made_again_alike_and_stacked_as_the_port_stacks():
    m = mla_shape(TINY_MLA)
    served = mla_weights.served_weights(m, 3, "cpu", torch.float32)
    assert {name: tuple(w.shape) for name, w in served["layers"].items()} \
        == mla_weights.shapes(m)["layers"]
    again = mla_weights.layer_weights(m, 2, 3, "cpu")
    assert torch.equal(served["layers"]["w_gate"][1], again["w_gate"])
    assert torch.equal(served["layers"]["wq"][2], again["wq"])
    first = mla_weights.layer_weights(m, 0, 3, "cpu")
    assert torch.equal(served["layers"]["mlp_up"][0], first["mlp_up"])
    assert "w_router" not in first


def _span(name, start, end, parent=0, counts_=None, device_at=None):
    s = SimpleNamespace(service=name.split(".")[0],
                        method=name.split(".")[1], start_ns=start,
                        end_ns=end, parent_id=parent,
                        counts=counts_ or {}, device=0,
                        device_start_ns=None, device_end_ns=None)
    if device_at is not None:
        s.device_start_ns, s.device_end_ns = device_at
    return s


def _window(spans, kernels, units, window_s=2.0):
    config = load(CONFIG)
    cell = SimpleNamespace(config=config)
    trace = SimpleNamespace(window=(0, 10 ** 12), kernels=kernels,
                            devices=[0],
                            durations=lambda pattern, d: [
                                (e - s) / 1e9 for _, n, s, e in kernels
                                if pattern.search(n)])
    return SimpleNamespace(cell=cell, trace=trace, units=units,
                           window_s=window_s), spans


@pytest.fixture
def fake(monkeypatch):
    """A window with one request of 16384 tokens: one K1 launch of 2 ms,
    one expert layer's route and experts spans (3 ms inside), two latent
    spans of 0.5 ms each."""
    from brpc_tpu_torch.obs import rpcz

    route = _span("moe.route", 10, 20, 1, {"pairs": 6 * 16384,
                                           "experts": 64})
    experts = _span("moe.experts", 30, 40, 1, {"shared": 16384},
                    (1000, 5000))
    latent = [_span("mla.latent", 50 + i, 60 + i, 1, {"rows": 16384},
                    (6000 + 1000 * i, 6600 + 1000 * i)) for i in range(2)]
    kernels = [(0, "void wg::flash_fwd_wgmma_kernel<192, 128>(...)",
                10 ** 6, 3 * 10 ** 6),
               (0, "cutlass_grouped", 1500, 4500),
               (0, "nvjet_latent_a", 6100, 6600),
               (0, "nvjet_latent_b", 7100, 7600)]
    w, spans = _window([route, experts, *latent], kernels,
                       [{"b": 1, "t": 16384, "ok": True}])
    monkeypatch.setattr(rpcz, "captured", lambda *a, **k: spans)
    return w, experts


def _read(name, w):
    return harness.load_module(REPO / "portbench" / "metrics"
                               / f"{name}.py").read(w)


def test_readers_on_a_fake_window(fake):
    w, experts = fake
    m = mla_shape(load(CONFIG))
    assert _read("mfu.mla", w) == pytest.approx(
        100 * mla_counts.prefill_flops(m, 1, 16384) / (2.0 * 989e12))
    assert _read("k1_roofline.mla", w) == pytest.approx(
        100 * 27 * mla_counts.attention_bound_s(m, 1, 16384) / 2e-3)
    assert _read("experts_roofline.mla", w) == pytest.approx(
        100 * mla_counts.experts_bound_s(m, 6 * 16384, 64, 16384) / 3e-6)
    # 0.5 us busy in each latent span, times 27 layers
    assert _read("latent_ms.mla", w) == pytest.approx(27 * 0.5e-3)


def test_readers_give_nothing_where_the_program_has_nothing(fake,
                                                            monkeypatch):
    from brpc_tpu_torch.obs import rpcz

    w, experts = fake
    del experts.counts["shared"]  # a program that counts no shared rows
    assert _read("experts_roofline.mla", w) is None
    monkeypatch.setattr(rpcz, "captured", lambda *a, **k: [])
    assert _read("latent_ms.mla", w) is None
    assert _read("experts_roofline.mla", w) is None
    w.trace.durations = lambda pattern, device: []  # no K1 launch
    assert _read("k1_roofline.mla", w) is None


def _tiny_root(tmp_path):
    """A tiny copy of the benchmark with a cell ``tiny.mla`` of a tiny
    DeepSeek-V2 model under a short version of the cell's own mix."""
    root = tiny_root(tmp_path)
    pb = root / "portbench"
    (pb / "configs" / "tiny-mla.json").write_text(json.dumps(TINY_MLA))
    mix = json.loads((pb / "traffic" / "mla_prefill_long.json").read_text())
    mix.update(classes=[[32, 1], [64, 1]], trace_seconds=0.3,
               check={**mix["check"], "positions": 16})
    (pb / "traffic" / "tiny_mla.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-mla", "source": "tests",
                             "file": "portbench/configs/tiny-mla.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tiny.mla", "config": "tiny-mla",
                               "traffic": "tiny_mla", "chips": 1,
                               "why": "tests"})
    for spec in bench["end_to_end"] + bench["per_layer"]:
        if CELL in spec.get("workloads", []):
            spec["workloads"].append("tiny.mla")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_runner_units_and_checks_on_the_cpu(tmp_path):
    root = _tiny_root(tmp_path)
    cpu = [torch.device("cpu")]
    result, checks, _ = harness.run(root, "tiny.mla", 2 ** 40 + 5, 0.3,
                                    False, time.perf_counter(), cpu)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] % 2 == 0  # whole rounds of two requests
    assert set(result["metrics"]) == {"prefill_tokens_per_s", "setup_s"}
    assert [name for name, _, _ in checks] == [
        "served_token_gap_at_quantile", "share_of_gaps_over",
        "logit_error_at_median"]
    result, _, _ = harness.run(root, "tiny.mla", 2 ** 40 + 6, 0.3, True,
                               time.perf_counter(), cpu)
    assert result["correct"]
    # on the CPU no span has a device interval and the trace no kernel:
    # those readers give nothing
    assert {"mfu.mla", "forward_host_ms.prefill"} <= set(result["metrics"])
    assert not {"k1_roofline.mla", "experts_roofline.mla",
                "latent_ms.mla"} & set(result["metrics"])


def test_controls_and_faults_fail_the_checks_on_the_cpu(tmp_path):
    """The shared experts left out, standing in for the program, fail the
    cell's own limits at the tiny size; the f32 reference against itself
    reads 0."""
    from portbench import mla_control

    root = _tiny_root(tmp_path)
    got = mla_control.readings(root, "tiny.mla", 11, torch.device("cpu"))
    assert set(got) == set(mla_control.variants(mla_shape(TINY_MLA)))
    limits = json.loads((REPO / "portbench" / "traffic"
                         / "mla_prefill_long.json").read_text())["limits"]
    assert any(got["fault_no_shared"][name] > limit
               for name, limit in limits.items())
    assert got["fault_no_shared"]["verdict"] == "not correct"
    assert got["fault_no_shared"]["over_limits"] == [
        name for name, limit in limits.items()
        if got["fault_no_shared"][name] > limit]
    runner = harness.load_module(REPO / "portbench" / "runners"
                                 / "mla_prefill.py")
    logits = [torch.randn(4, 9), torch.randn(3, 9)]
    assert all(value == 0 for _, value, _ in runner.compare(
        logits, logits, {"check": {"quantile": 0.9, "over": 0.3},
                         "limits": limits}))
