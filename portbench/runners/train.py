"""Training: a closed loop of the port's train steps.

Set-up builds one train step, ``llama.make_train_step(cfg,
optim.adamw(params, lr))`` over the seed's weights, and drives it through
its first ``check.steps`` steps on batches drawn from the seed: those are
the warm-up, and the same object then runs the window, a step a round on
further batches. From the first steps it keeps what the check compares:
each step's loss, each leaf's first gradient as AdamW holds it (its first
moment after one step is ``(1 - b1) g``) and each leaf's change after the
last checked step (the weights are made again from the seed to take it).

Check: once the window has closed and the program's state is freed, the
plain float32 reference trains from the same weights on the same batches
and gives the same three: the largest gap of the losses
(``loss_gap``); by the worst leaf, the gap of the gradients' norms over
the larger of the reference leaf's and the median leaf's
(``grad_norm_gap``); and the same of the changes' norms
(``change_norm_gap``), leaving out leaves whose reference gradient is
under ``1e-3`` of the median leaf's, which move by rounding alone.
"""

from __future__ import annotations

import dataclasses
import gc
import statistics
import sys

import torch

from portbench import port, weights
from portbench.model_config import model_shape
from portbench.reference import train as reference

POOL_STEPS = 64  # distinct batches; later steps reuse them
STILL = 1e-3  # a leaf whose reference gradient is under this share of the
#               median leaf's is left out of the change


@dataclasses.dataclass
class State:
    cell: object
    shape: object
    params: object
    optimizer: object
    step: object
    batches: object
    first: dict
    losses: list


def _batches(cell, shape):
    t = cell.traffic
    return weights.token_ids(shape.vocab, (POOL_STEPS, t["batch"], t["seq"]),
                             cell.seed, cell.devices[0], "train")


def _norm(x: torch.Tensor) -> float:
    return torch.linalg.vector_norm(x, dtype=torch.float64).item()


def setup(cell):
    from brpc_tpu_torch import optim
    from brpc_tpu_torch.models import llama

    traffic, device = cell.traffic, cell.devices[0]
    shape = model_shape(cell.config)
    cfg = port.llama_config(shape, cell.config)
    params = llama.trainable(weights.llama_weights(shape, cell.seed, device))
    optimizer = optim.adamw(params, traffic["lr"])
    group = optimizer.param_groups[0]
    hyper = {"betas": list(group["betas"]), "eps": group["eps"],
             "weight_decay": group["weight_decay"]}
    want = {k: traffic[k] for k in hyper}
    if hyper != want:
        raise ValueError(f"the port's AdamW runs {hyper}; the mix states "
                         f"{want}")
    step = llama.make_train_step(cfg, optimizer)
    batches = _batches(cell, shape)
    leaves = weights.flat_leaves(params)
    b1 = traffic["betas"][0]
    cell.mark("weights and batches")
    losses = []
    for i in range(traffic["check"]["steps"]):
        losses.append(step(params, batches[i]).item())
        if i == 0:
            # no first moment: the optimizer got no gradient
            grads = [_norm(optimizer.state[p].get("exp_avg",
                                                  torch.zeros(())))
                     / (1 - b1) for p in leaves]
    cell.mark("checked steps")
    changes = []
    with torch.no_grad():
        for name, p in zip(weights.leaf_names(shape), leaves):
            changes.append(_norm(p - weights.llama_leaf(shape, name,
                                                        cell.seed, device)))
    first = {"losses": losses, "grad_norms": grads, "change_norms": changes}
    return State(cell, shape, params, optimizer, step, batches, first, [])


def run_round(state: State, index: int) -> list:
    cell = state.cell
    tokens = state.batches[(cell.traffic["check"]["steps"] + index)
                           % POOL_STEPS]
    with cell.spans("step"):
        state.losses.append(state.step(state.params, tokens))
    return [{"b": tokens.shape[0], "t": tokens.shape[1], "ok": True}]


def gaps(got: list, want: list, leave_out=()) -> float:
    """By the worst leaf, |got - want| over the larger of want's leaf and
    want's median leaf."""
    kept = [i for i in range(len(want)) if i not in leave_out]
    median = statistics.median(want[i] for i in kept)
    return max(abs(got[i] - want[i]) / max(want[i], median) for i in kept)


def still_leaves(want: dict) -> set:
    """Leaves whose reference gradient is under ``STILL`` of the median
    leaf's."""
    median = statistics.median(want["grad_norms"])
    return {i for i, g in enumerate(want["grad_norms"])
            if g < STILL * median}


def compare(got: dict, want: dict) -> dict:
    """The three numbers compared, of a run's ``got`` against the
    reference's ``want`` (each as ``reference.train.follow`` gives)."""
    still = still_leaves(want)
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(got["losses"],
                                                    want["losses"])),
        "grad_norm_gap": gaps(got["grad_norms"], want["grad_norms"]),
        "change_norm_gap": gaps(got["change_norms"], want["change_norms"],
                                still),
    }


def check(state: State) -> list:
    cell, shape, traffic = state.cell, state.shape, state.cell.traffic
    device = cell.devices[0]
    finite = all(bool(torch.isfinite(x)) for x in state.losses)
    first = state.first
    state.params = state.optimizer = state.step = state.batches = None
    state.losses = []
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    steps = traffic["check"]["steps"]
    batches = list(_batches(cell, shape)[:steps])
    want = reference.follow(shape, cell.seed, batches, traffic, device)
    names = weights.leaf_names(shape)
    print(f"train check: losses {first['losses']} against {want['losses']};"
          f" leaves left out of the change: "
          f"{[names[i] for i in sorted(still_leaves(want))]}",
          file=sys.stderr)
    numbers = compare(first, want)
    if not finite:
        numbers["loss_gap"] = float("inf")
    return [(name, value, traffic["limits"][name])
            for name, value in numbers.items()]
