"""Prefill serving of a DeepSeek-V2 model (multi-head latent attention,
dense layers first, then routed and shared experts): one client, one
request at a time (a closed loop), as ``runners/prefill.py`` serves a
dense model.

The configuration's model (``mla_config``) is the port's ``LlamaConfig``
with latent attention, YaRN rope, ``first_dense_layers`` and shared
experts, served by ``LlamaModel(cfg, params, attn_fn=flash_attention)``.
Set-up makes each layer's leaves in float32 from the seed one at a time
and casts them into stacks preallocated in the compute type
(``mla_weights.served_weights``), which ``LlamaModel`` wraps without a
copy. Rounds, requests, latencies and the sample of kept logits are
``runners/prefill.py``'s own (its ``run_round``).

Check, as ``runners/moe_prefill.py``'s: once the window has closed, the
sampled requests are served once more with the port's routing recorded,
the model is freed, and the plain float32 reference
(``reference/deepseek_v2.py``) recomputes them layer by layer from
weights and prompts made again from the seed. A top-6 choice whose 6th
and 7th probabilities lie within rounding flips between the port's bf16
residual stream and the f32 reference and moves its position by a whole
expert's term, so the cell compares the gap at the mix's
``check.quantile`` of the positions and the share of positions whose gap
exceeds ``check.over``, not the widest gap; and, beside them, the
relative error ``|got - want| / |want|`` of the logits at the median
position, which a change to every position (a rope, a scale, a product's
precision) moves even where the first-ranked token holds.
"""

from __future__ import annotations

import gc
import math
import sys
from pathlib import Path

import torch

from portbench import harness, mla_weights
from portbench.mla_config import mla_shape
from portbench.port import DTYPES
from portbench.reference import deepseek_v2 as reference

_HERE = Path(__file__).resolve().parent
_prefill = harness.load_module(_HERE / "prefill.py")
_moe = harness.load_module(_HERE / "moe_prefill.py")
run_round = _prefill.run_round
# The numbers compared: the gap at the mix's quantile of the sampled
# positions, the share of positions whose gap exceeds ``check.over``, and
# the logits' relative error at the median position.
CHECKS = (*_moe.CHECKS, "logit_error_at_median")


def llama_config(m, config: dict):
    """The port's ``LlamaConfig`` of a DeepSeek-V2 model, checked against
    the benchmark's layout."""
    from brpc_tpu_torch.models import llama, mla

    yarn = m.yarn_args()
    if yarn is not None:
        yarn = mla.Yarn(**{**yarn, "original_max_position_embeddings":
                           int(yarn["original_max_position_embeddings"])})
    cfg = llama.LlamaConfig(
        vocab_size=m.vocab, hidden=m.hidden, n_layers=m.layers,
        n_heads=m.heads, n_kv_heads=m.heads, head_dim=m.qk_head,
        intermediate=m.intermediate, rope_theta=m.rope_theta,
        norm_eps=m.norm_eps, dtype=DTYPES[config["compute_dtype"]],
        param_dtype=DTYPES[config["param_dtype"]], n_experts=m.experts,
        experts_per_token=m.per_token, first_dense_layers=m.dense_layers,
        expert_intermediate=m.expert_intermediate,
        n_shared_experts=m.shared, norm_topk_prob=m.norm_topk_prob,
        kv_lora_rank=m.kv_lora_rank, qk_nope_head_dim=m.qk_nope,
        qk_rope_head_dim=m.qk_rope, v_head_dim=m.v_head, rope_scaling=yarn)
    if llama.param_shapes(cfg) != mla_weights.shapes(m):
        raise ValueError("the port's parameter layout differs from the "
                         "benchmark's")
    return cfg


def setup(cell):
    from brpc_tpu_torch.models import llama
    from brpc_tpu_torch.ops.flash_attention import flash_attention

    m = mla_shape(cell.config)
    cfg = llama_config(m, cell.config)
    device = cell.devices[0]
    params = mla_weights.served_weights(m, cell.seed, device, cfg.dtype)
    model = llama.LlamaModel(cfg, params, attn_fn=flash_attention)
    del params
    pools = [_prefill._pool(cell, m, c, length, count)
             for c, (length, count) in enumerate(cell.traffic["classes"])]
    cell.mark("weights and prompts")
    with torch.inference_mode():
        for pool in pools:  # every shape the mix uses, once
            model(pool[0])
    return _prefill.State(cell, m, model, pools, _prefill._plan(cell), {})


def logit_errors(got: list, want: list) -> torch.Tensor:
    """At each sampled position, ``|got - want| / |want|`` over the
    vocabulary, sorted."""
    return torch.cat([(g - w).norm(dim=-1) / w.norm(dim=-1)
                      for g, w in zip(got, want)]).sort().values


def compare(got: list, want: list, traffic: dict) -> list:
    """The checks of logits ``got`` against the reference's ``want``, a
    pair a kept row: ``moe_prefill.compare``'s two, and the logits'
    relative error at the median position, by the nearest rank."""
    limits = traffic["limits"]
    checks = _moe.compare(got, want, traffic)
    if not all(math.isfinite(v) for _, v, _ in checks):
        return checks + [(CHECKS[2], float("inf"), limits[CHECKS[2]])]
    errors = logit_errors(got, want)
    median = errors[math.ceil(0.5 * len(errors)) - 1].item()
    return checks + [(CHECKS[2], median, limits[CHECKS[2]])]


def reference_pass(cell, m, seqs: list, variants: tuple = ({},)) -> list:
    device = cell.devices[0]
    return reference.logits_at(
        m, mla_weights.top_weights(m, cell.seed, device),
        lambda i: mla_weights.layer_weights(m, i, cell.seed, device),
        [(batch[b], positions) for _, b, batch, positions in seqs],
        variants)


def summary(got: list, want: list, mine: list | None = None) -> str:
    """``moe_prefill.summary`` and the logits' relative error at a few
    quantiles of the positions."""
    if not got:
        return "no position"
    errors = logit_errors(got, [w for w, _ in want])
    at = {q: errors[math.ceil(q * len(errors)) - 1].item()
          for q in (0.1, 0.5, 0.9, 1.0)}
    return f"{_moe.summary(got, want, mine)}; logit errors at quantiles " \
        f"{at!r}"


def check(state) -> list:
    cell, m = state.cell, state.shape
    device = cell.devices[0]
    seqs = _moe.sequences(state)
    mine = _moe.port_choices(state, seqs)
    got = [state.kept[key][b] for key, b, _, _ in seqs]
    state.model = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    (want,) = reference_pass(cell, m, seqs)
    checks = compare(got, [w for w, _ in want], cell.traffic)
    print(f"mla_prefill check: {len(state.kept)} requests; "
          f"{summary(got, want, mine)}", file=sys.stderr)
    return checks
