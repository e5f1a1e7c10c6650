"""Prefill serving: one client, one request at a time (a closed loop).

Each request is a batch of token ids served by the port's
``LlamaModel(cfg, params, attn_fn=flash_attention)`` under
``inference_mode``; its latency runs from the call to the logits on the
device (time to the first token). A round is the mix's multiset of prompt
lengths (``classes``: ``[length, count]``), in an order the seed shuffles,
with token ids drawn from the seed.

Check: a sample of the requests served, drawn from the seed among the
first ``check.rounds`` rounds and always holding one of the longest, keeps
the logits at ``check.positions`` positions drawn from the seed (the last
among them). Once the window has closed and the model is freed, the plain
float32 reference recomputes each from weights and prompts made again
from the seed; the number compared is the widest gap by which the token
the port puts first lies below the reference's best (``served_token_gap``).
"""

from __future__ import annotations

import dataclasses
import gc
import random
import sys
import time

import torch

from portbench import port, weights
from portbench.model_config import model_shape
from portbench.reference import llama as reference

POOL_ROUNDS = 16  # rounds of distinct prompts; later rounds reuse them


@dataclasses.dataclass
class State:
    cell: object
    shape: object
    model: object
    pools: list
    plan: dict
    kept: dict


def _pool(cell, shape, index: int, length: int, count: int):
    return weights.token_ids(shape.vocab, (POOL_ROUNDS * count,
                                           cell.traffic["batch"], length),
                             cell.seed, cell.devices[0], "prefill", index)


def _order(cell, index: int) -> list:
    requests = [(c, k) for c, (_, count) in enumerate(cell.traffic["classes"])
                for k in range(count)]
    random.Random(weights.sub_seed(cell.seed, "order", index)) \
        .shuffle(requests)
    return requests


def _plan(cell) -> dict:
    """{(round, class, k): positions} of the requests whose logits are
    kept: one of the longest class in round 0, the rest drawn among the
    first ``check.rounds`` rounds."""
    check, classes = cell.traffic["check"], cell.traffic["classes"]
    rng = random.Random(weights.sub_seed(cell.seed, "check"))
    longest = max(range(len(classes)), key=lambda c: classes[c][0])
    chosen = [(0, longest, rng.randrange(classes[longest][1]))]
    others = [(r, c, k) for r in range(check["rounds"])
              for c, (_, count) in enumerate(classes) for k in range(count)
              if (r, c, k) != chosen[0]]
    chosen += rng.sample(others, min(check["requests"] - 1, len(others)))
    plan = {}
    for key in chosen:
        length = classes[key[1]][0]
        n = min(check["positions"], length)
        plan[key] = sorted(rng.sample(range(length - 1), n - 1)) \
            + [length - 1]
    return plan


def setup(cell):
    from brpc_tpu_torch.models import llama
    from brpc_tpu_torch.ops.flash_attention import flash_attention

    shape = model_shape(cell.config)
    cfg = port.llama_config(shape, cell.config)
    device = cell.devices[0]
    params = weights.llama_weights(shape, cell.seed, device)
    model = llama.LlamaModel(cfg, params, attn_fn=flash_attention)
    pools = [_pool(cell, shape, c, length, count)
             for c, (length, count) in enumerate(cell.traffic["classes"])]
    cell.mark("weights and prompts")
    with torch.inference_mode():
        for pool in pools:  # every shape the mix uses, once
            model(pool[0])
    return State(cell, shape, model, pools, _plan(cell), {})


def run_round(state: State, index: int) -> list:
    cell, units = state.cell, []
    device, batch = cell.devices[0], cell.traffic["batch"]
    with torch.inference_mode():
        for c, k in _order(cell, index):
            length, count = cell.traffic["classes"][c]
            tokens = state.pools[c][(index % POOL_ROUNDS) * count + k]
            with cell.spans(f"request.T{length}"):
                start = time.perf_counter()
                logits = state.model(tokens)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                latency = time.perf_counter() - start
            ok = tuple(logits.shape) == (batch, length, state.shape.vocab) \
                and logits.dtype == torch.float32
            positions = state.plan.get((index, c, k))
            if positions is not None and ok:
                state.kept[(index, c, k)] = logits[:, positions].clone()
            del logits
            units.append({"b": batch, "t": length, "latency_s": latency,
                          "ok": ok})
    return units


def served_token_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest gap, over the rows, by which the reference's logit of
    the token ``got`` ranks first lies below the reference's best."""
    first = got.argmax(-1, keepdim=True)
    return (want.max(-1).values - want.gather(-1, first).squeeze(-1)) \
        .max().item()


def check(state: State) -> list:
    cell, shape = state.cell, state.shape
    device = cell.devices[0]
    kept, plan = state.kept, state.plan
    state.model = state.pools = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    w = weights.llama_weights(shape, cell.seed, device)
    gap, served = 0.0, 0
    for (index, c, k), rows in sorted(kept.items()):
        length, count = cell.traffic["classes"][c]
        tokens = _pool(cell, shape, c, length, count)[
            (index % POOL_ROUNDS) * count + k]
        positions = torch.tensor(plan[(index, c, k)], device=device)
        for b in range(rows.shape[0]):
            got = rows[b]
            if not bool(torch.isfinite(got).all()):
                return [("served_token_gap", float("inf"),
                         cell.traffic["limits"]["served_token_gap"])]
            want = reference.logits_at(w, tokens[b], positions, shape)
            gap = max(gap, served_token_gap(got, want))
            served += len(positions)
    print(f"prefill check: {len(kept)} requests, {served} served tokens",
          file=sys.stderr)
    if served == 0:  # no sampled request was served: nothing to hold
        gap = float("inf")
    return [("served_token_gap", gap,
             cell.traffic["limits"]["served_token_gap"])]
