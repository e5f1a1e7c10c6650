"""Prefill serving of a sparse-expert model: one client, one request at a
time (a closed loop), as ``runners/prefill.py`` serves a dense one.

The configuration names its experts (``moe_config``); the port's
``LlamaConfig`` with ``n_experts`` and ``experts_per_token`` is served by
``LlamaModel(cfg, params, attn_fn=flash_attention)``, which runs
``models.moe.expert_layer`` in each layer. Set-up makes each layer's
leaves in float32 from the seed one at a time and casts them into stacks
preallocated in the compute type (``moe_weights.served_weights``), which
``LlamaModel`` wraps without a copy, so every layer's float32 weights are
never held at once. Rounds, requests, latencies and the sample of kept
logits are ``runners/prefill.py``'s own (its ``run_round``).

Check: once the window has closed, the sampled requests are served once
more, outside the window, with the port's routing recorded
(``moe.route``), and the model is freed. The plain float32 reference
(``reference/mixtral.py``) then recomputes them layer by layer from
weights and prompts made again from the seed. At each sampled position
the gap is the distance by which the reference's logit of the token the
port puts first lies below the reference's best. A top-2 choice whose
second and third probabilities lie within rounding of each other can
flip between the port's bf16 residual stream and the f32 reference, and
then that position's output moves by a whole expert's term; so the cell
compares the gap at the mix's ``check.quantile`` of the positions, and
the share of positions whose gap exceeds ``check.over``, not the widest
gap. The share of (position, layer) choices that differ from the
reference's is printed beside them.
"""

from __future__ import annotations

import gc
import math
import sys
from pathlib import Path

import torch

from portbench import harness, moe_weights
from portbench.moe_config import moe_shape
from portbench.port import DTYPES
from portbench.reference import mixtral as reference

_prefill = harness.load_module(Path(__file__).resolve().parent
                               / "prefill.py")
run_round = _prefill.run_round
# The numbers compared: the gap at the mix's quantile of the sampled
# positions, and the share of positions whose gap exceeds ``check.over``.
CHECKS = ("served_token_gap_at_quantile", "share_of_gaps_over")


def llama_config(m, config: dict):
    """The port's ``LlamaConfig`` of an expert model, checked against the
    benchmark's layout."""
    from brpc_tpu_torch.models import llama

    cfg = llama.LlamaConfig(
        vocab_size=m.vocab, hidden=m.hidden, n_layers=m.layers,
        n_heads=m.heads, n_kv_heads=m.kv_heads, head_dim=m.head_dim,
        intermediate=m.intermediate, rope_theta=m.rope_theta,
        norm_eps=m.norm_eps, dtype=DTYPES[config["compute_dtype"]],
        param_dtype=DTYPES[config["param_dtype"]], n_experts=m.experts,
        experts_per_token=m.per_token)
    if llama.param_shapes(cfg) != moe_weights.shapes(m):
        raise ValueError("the port's parameter layout differs from the "
                         "benchmark's")
    return cfg


def setup(cell):
    from brpc_tpu_torch.models import llama
    from brpc_tpu_torch.ops.flash_attention import flash_attention

    m = moe_shape(cell.config)
    cfg = llama_config(m, cell.config)
    device = cell.devices[0]
    params = moe_weights.served_weights(m, cell.seed, device, cfg.dtype)
    model = llama.LlamaModel(cfg, params, attn_fn=flash_attention)
    del params
    pools = [_prefill._pool(cell, m, c, length, count)
             for c, (length, count) in enumerate(cell.traffic["classes"])]
    cell.mark("weights and prompts")
    with torch.inference_mode():
        for pool in pools:  # every shape the mix uses, once
            model(pool[0])
    return _prefill.State(cell, m, model, pools, _prefill._plan(cell), {})


def sequences(state) -> list:
    """(request, row, its batch [B, T], positions) of every kept row, in
    order."""
    cell = state.cell
    out = []
    for (index, c, k), rows in sorted(state.kept.items()):
        count = cell.traffic["classes"][c][1]
        batch = state.pools[c][(index % _prefill.POOL_ROUNDS) * count + k]
        positions = torch.tensor(state.plan[(index, c, k)],
                                 device=cell.devices[0])
        out += [((index, c, k), b, batch, positions)
                for b in range(rows.shape[0])]
    return out


def port_choices(state, seqs: list) -> list:
    """The experts the port's router chose at each kept row's positions,
    [L, len(positions), k], from serving its request once more with
    ``moe.route`` recorded."""
    from brpc_tpu_torch.models import moe

    route, chosen = moe.route, []

    def recorded(*args, **kwargs):
        weights, experts = route(*args, **kwargs)
        chosen.append(experts.view(*batch.shape, -1))
        return weights, experts

    out, last = [], None
    moe.route = recorded
    try:
        with torch.inference_mode():
            for key, b, batch, positions in seqs:
                if key != last:  # a request once, for all its rows
                    chosen.clear()
                    state.model(batch)
                    last = key
                out.append(torch.stack([e[b, positions] for e in chosen]))
    finally:
        moe.route = route
    return out


def gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """At each row, the distance by which the reference's logit of the
    token ``got`` ranks first lies below the reference's best."""
    first = got.argmax(-1, keepdim=True)
    return want.max(-1).values - want.gather(-1, first).squeeze(-1)


def flipped(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per (layer, position), whether the two choices differ as sets."""
    return (got.sort(-1).values != want.sort(-1).values).any(-1)


def compare(got: list, want: list, traffic: dict) -> list:
    """The checks of logits ``got`` against the reference's ``want``, a
    pair a kept row: the gap at the mix's quantile of the positions, by
    the nearest rank, and the share of positions whose gap exceeds
    ``check.over``."""
    check, limits = traffic["check"], traffic["limits"]
    if not got or not all(bool(torch.isfinite(g).all()) for g in got):
        return [(name, float("inf"), limits[name]) for name in CHECKS]
    every = torch.cat([gaps(g, w) for g, w in zip(got, want)]).sort().values
    quantile = every[math.ceil(check["quantile"] * len(every)) - 1].item()
    over = (every > check["over"]).double().mean().item()
    return [(CHECKS[0], quantile, limits[CHECKS[0]]),
            (CHECKS[1], over, limits[CHECKS[1]])]


def reference_pass(cell, m, seqs: list, variants: tuple = ({},)) -> list:
    device = cell.devices[0]
    return reference.logits_at(
        m, moe_weights.top_weights(m, cell.seed, device),
        lambda i: moe_weights.layer_weights(m, i, cell.seed, device),
        [(batch[b], positions) for _, b, batch, positions in seqs],
        variants)


def check(state) -> list:
    cell, m = state.cell, state.shape
    device = cell.devices[0]
    seqs = sequences(state)
    mine = port_choices(state, seqs)
    got = [state.kept[key][b] for key, b, _, _ in seqs]
    state.model = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    (want,) = reference_pass(cell, m, seqs)
    checks = compare(got, [w for w, _ in want], cell.traffic)
    print(f"moe_prefill check: {len(state.kept)} requests; "
          f"{summary(got, want, mine)}", file=sys.stderr)
    return checks


def summary(got: list, want: list, mine: list | None = None) -> str:
    """The gaps at a few quantiles of the positions and, given the port's
    choices, the share of (position, layer) choices that differ from the
    reference's: what the limits were set from."""
    if not got:
        return "no position"
    every = torch.cat([gaps(g, w) for g, (w, _) in zip(got, want)]) \
        .sort().values
    at = {q: every[math.ceil(q * len(every)) - 1].item()
          for q in (0.5, 0.75, 0.9, 0.95, 1.0)}
    out = f"{len(every)} positions, gaps at quantiles {at!r}"
    if mine is not None:
        flips = torch.cat([flipped(p, e).reshape(-1)
                           for p, (_, e) in zip(mine, want)])
        out += (f"; routing flips {flips.double().mean().item()!r} of "
                f"{flips.numel()} (position, layer) choices")
    return out
