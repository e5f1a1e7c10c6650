"""The Mixtral cell's pieces: its counts against sums worked by hand at
the cell's shapes, its configuration file, the reference against the
port's tiny expert model, and its runner's units and checks on the CPU.

Tolerances: the port at float32 against the reference, logits within
2e-4 of their largest (the same arithmetic in another order: the port
sums each token's two expert terms into f32 rows by ``index_add_`` after
grouped products, the reference per expert; measured below 1e-5)."""

import json
import time

import pytest
import torch

from portbench import harness, moe_counts, moe_weights
from portbench.model_config import load, model_shape
from portbench.moe_config import moe_shape
from portbench.reference import llama as dense_reference
from portbench.reference import mixtral as reference
from portbench.tests.tiny import REPO, tiny_root

CONFIG = REPO / "portbench" / "configs" / "mixtral-8x7b.l16.json"
TINY_MOE = {
    "source": "a tiny model with Mixtral's equations, for tests",
    "reduced": [], "compute_dtype": "bfloat16", "param_dtype": "float32",
    "hidden_act": "silu", "hidden_size": 64, "intermediate_size": 128,
    "num_attention_heads": 2, "num_hidden_layers": 2,
    "num_key_value_heads": 1, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "vocab_size": 512,
    "num_local_experts": 8, "num_experts_per_tok": 2,
}


def test_counts_at_the_cell_shapes():
    m = moe_shape(load(CONFIG))
    attention = 4096 * (4096 + 2 * 1024) + 4096 * 4096
    expert = 3 * 4096 * 14336
    assert (attention, expert) == (41_943_040, 176_160_768)
    assert moe_counts.layer_params(m) == attention + 4096 * 8 \
        + 8 * expert + 2 * 4096 == 1_451_270_144
    assert moe_counts.n_params(m) == 16 * 1_451_270_144 \
        + 2 * 32000 * 4096 + 4096 == 23_482_470_400
    assert moe_counts.active_layer_weights(m) == attention + 4096 * 8 \
        + 2 * expert == 394_297_344
    t = 4096
    assert moe_counts.prefill_flops(m, 1, t) == 2 * (
        16 * 394_297_344 + 4096 * 32000) * t \
        + 4 * 4096 * (t * (t + 1) // 2) * 16
    # 512 tokens reach all 8 experts: bound by their bf16 weights' bytes;
    # 8192 pairs by operations
    assert moe_counts.experts_bound_s(m, 1024, 8) == pytest.approx(
        8 * expert * 2 / 3.35e12)
    assert moe_counts.experts_bound_s(m, 8192, 8) == pytest.approx(
        2 * 8192 * expert / 989e12)
    assert moe_counts.experts_bound_s(m, 3, 8) == pytest.approx(
        3 * expert * 2 / 3.35e12)


def test_configuration_file_states_its_cut():
    data = load(CONFIG)
    assert data["reduced"] == ["num_hidden_layers"]
    assert data["published"] == {"num_hidden_layers": 32}
    assert "two-stage pipeline over two H100s" in data["deployment"]
    assert data["num_hidden_layers"] == 16
    m = moe_shape(data)
    assert (m.hidden, m.intermediate, m.heads, m.kv_heads, m.head_dim,
            m.vocab, m.experts, m.per_token) == (4096, 14336, 32, 8, 128,
                                                 32000, 8, 2)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"]
                 if c["name"] == "mixtral-8x7b.l16")
    assert entry["reduced"] == data["reduced"]
    assert entry["source"] == data["source"]


@pytest.mark.parametrize("missing", ["num_local_experts",
                                     "num_experts_per_tok"])
def test_moe_config_refuses_a_file_without_expert_keys(missing):
    data = {k: v for k, v in load(CONFIG).items() if k != missing}
    with pytest.raises(ValueError, match=missing):
        moe_shape(data)
    # the dense reader takes it without a word: the reason for moe_config
    assert model_shape(data).intermediate == 14336


def _tiny(dtype):
    from brpc_tpu_torch.models import llama

    m = moe_shape(TINY_MOE)
    cfg = llama.LlamaConfig(
        vocab_size=m.vocab, hidden=m.hidden, n_layers=m.layers,
        n_heads=m.heads, n_kv_heads=m.kv_heads, head_dim=m.head_dim,
        intermediate=m.intermediate, rope_theta=m.rope_theta,
        norm_eps=m.norm_eps, dtype=dtype, n_experts=m.experts,
        experts_per_token=m.per_token)
    assert llama.param_shapes(cfg) == moe_weights.shapes(m)
    return m, cfg


def test_reference_against_the_port_tiny_model():
    from brpc_tpu_torch.models import llama

    m, cfg = _tiny(torch.float32)
    params = moe_weights.served_weights(m, 7, "cpu", torch.float32)
    tokens = torch.randint(0, m.vocab, (48,),
                           generator=torch.Generator().manual_seed(1))
    positions = torch.arange(48)
    with torch.no_grad():
        got = llama.LlamaModel(cfg, params)(tokens[None])[0]
    (((want, experts),),) = reference.logits_at(
        m, params, lambda i: dense_reference.layer_weights(params, i),
        [(tokens, positions)])
    assert experts.shape == (2, 48, 2)
    assert (got - want).abs().max() <= 2e-4 * want.abs().max()


def _tiny_root(tmp_path):
    """A tiny copy of the benchmark with a cell ``tiny.moe`` of the tiny
    expert model under a short version of the cell's own mix."""
    root = tiny_root(tmp_path)
    pb = root / "portbench"
    (pb / "configs" / "tiny-moe.json").write_text(json.dumps(TINY_MOE))
    mix = json.loads((pb / "traffic" / "moe_prefill_short.json")
                     .read_text())
    mix.update(classes=[[32, 2], [64, 1]], trace_seconds=0.3,
               check={**mix["check"], "requests": 3, "positions": 16,
                      "rounds": 2})
    (pb / "traffic" / "tiny_moe.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-moe", "source": "tests",
                             "file": "portbench/configs/tiny-moe.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tiny.moe", "config": "tiny-moe",
                               "traffic": "tiny_moe", "chips": 1,
                               "why": "tests"})
    for spec in bench["end_to_end"] + bench["per_layer"]:
        if "mixtral8x7b.prefill_short" in spec.get("workloads", []):
            spec["workloads"].append("tiny.moe")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_runner_units_and_checks_on_the_cpu(tmp_path):
    root = _tiny_root(tmp_path)
    cpu = [torch.device("cpu")]
    result, checks, _ = harness.run(root, "tiny.moe", 2 ** 40 + 5, 0.3,
                                    False, time.perf_counter(), cpu)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] % 3 == 0  # whole rounds of three requests
    assert set(result["metrics"]) == {"prefill_tokens_per_s",
                                      "prefill_ms_p95", "setup_s"}
    assert [name for name, _, _ in checks] == [
        "served_token_gap_at_quantile", "share_of_gaps_over"]
    # a tiny bf16 model keeps its top token at nearly every position
    assert checks[1][1] <= 0.1
    result, _, _ = harness.run(root, "tiny.moe", 2 ** 40 + 6, 0.3, True,
                               time.perf_counter(), cpu)
    assert result["correct"]
    # on the CPU no span has a device interval and the trace no kernel:
    # those readers give nothing
    assert {"mfu.moe", "forward_host_ms.prefill"} <= set(result["metrics"])
    assert "experts_roofline.moe" not in result["metrics"]


def test_controls_and_faults_fail_the_checks_on_the_cpu(tmp_path):
    """The reference with top-1 routing, standing in for the program,
    fails the cell's own limits at the tiny size; the f32 reference
    against itself reads 0."""
    from portbench import moe_control

    root = _tiny_root(tmp_path)
    got = moe_control.readings(root, "tiny.moe", 11, torch.device("cpu"))
    assert set(got) == set(moe_control.VARIANTS)
    limits = json.loads((REPO / "portbench" / "traffic"
                         / "moe_prefill_short.json").read_text())["limits"]
    # top-1 routing fails them even here; the subtler faults and the fp8
    # control are read at the cell's size on the card (PERF.md)
    assert any(got["fault_top1"][name] > limit
               for name, limit in limits.items())
    runner = harness.load_module(REPO / "portbench" / "runners"
                                 / "moe_prefill.py")
    logits = [torch.randn(4, 9), torch.randn(3, 9)]
    assert all(value == 0 for _, value, _ in runner.compare(
        logits, logits, {"check": {"quantile": 0.9, "over": 0.3},
                         "limits": limits}))
