"""The reference's optax optimizers as torch optimizers.

``adamw`` equals ``optax.adamw(learning_rate)`` at optax's defaults: b1 0.9,
b2 0.999, eps 1e-8 outside the square root (eps_root 0) and a decoupled
weight decay of 1e-4 on every leaf, no mask. ``torch.optim.AdamW`` computes
the same update (its weight decay defaults to 1e-2, so it is set here).
``sgd`` is ``optax.sgd(learning_rate)``: no momentum.

Both take a params tree (``models.llama.trainable``) and number its leaves
in ``tree_leaves`` order. The leaves of a sharded step are DTensors; each
rank's update then runs on its own shards, and since both updates are
elementwise the whole is the reference's update of the global params. The optimizer is no TPU kernel (optax is XLA), so
torch's own implementation runs it: the fused one when the leaves are on
CUDA (one pass over each tensor list), the default one on the CPU.
"""

from __future__ import annotations

import torch

from brpc_tpu_torch.utils.tree import Tree, tree_leaves


def adamw(params: Tree, learning_rate: float) -> torch.optim.AdamW:
    leaves = tree_leaves(params)
    return torch.optim.AdamW(leaves, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4,
                             fused=True if leaves[0].is_cuda else None)


def sgd(params: Tree, learning_rate: float) -> torch.optim.SGD:
    return torch.optim.SGD(tree_leaves(params), lr=learning_rate)


def init_state(optimizer: torch.optim.Optimizer) -> None:
    """Give the optimizer its state (for AdamW: zero moments, step 1)
    without moving a param: one step on zero gradients at a learning rate
    of 0. A template for ``restore_checkpoint`` needs this, because a load
    fills the state the template already holds."""
    lrs = [group["lr"] for group in optimizer.param_groups]
    for group in optimizer.param_groups:
        group["lr"] = 0.0
        for p in group["params"]:
            p.grad = torch.zeros_like(p)
    try:
        optimizer.step()
    finally:
        for group, lr in zip(optimizer.param_groups, lrs):
            group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
