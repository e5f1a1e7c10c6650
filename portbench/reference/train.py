"""The reference training step: the loss over a batch, its gradients and
a plain AdamW update, followed for the first steps of a run.

AdamW as Loshchilov and Hutter define it, decoupled weight decay:
``m = b1 m + (1-b1) g``, ``v = b2 v + (1-b2) g²``, and
``p -= lr (m/(1-b1^s) / (sqrt(v/(1-b2^s)) + eps) + wd p)``.
"""

from __future__ import annotations

import torch

from portbench import weights
from portbench.model_config import ModelShape
from portbench.reference.llama import full_f32, sequence_loss


def batch_loss_backward(leaves: list, tokens: torch.Tensor, m: ModelShape,
                        precision: str = "f32", rows=None) -> float:
    """The mean loss over ``rows`` of ``tokens`` [B, T] (default: all),
    its gradient accumulated into each leaf's ``.grad`` one row at a time.
    Every row has T-1 targets, so the mean of the rows' means is the
    batch's mean."""
    rows = range(tokens.shape[0]) if rows is None else rows
    w = weights.nest(m, leaves)
    total = 0.0
    for r in rows:
        loss = sequence_loss(w, tokens[r], m, precision) / len(rows)
        loss.backward()
        total += loss.item()
    return total


def adamw_step(leaves: list, moments: list, step: int, hyper: dict) -> None:
    lr, wd, eps = hyper["lr"], hyper["weight_decay"], hyper["eps"]
    b1, b2 = hyper["betas"]
    with torch.no_grad():
        for p, (m, v) in zip(leaves, moments):
            g = p.grad
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            update = (m / (1 - b1 ** step)) \
                / ((v / (1 - b2 ** step)).sqrt_() + eps)
            p.sub_(lr * (update + wd * p))


def norm(x: torch.Tensor) -> float:
    return torch.linalg.vector_norm(x, dtype=torch.float64).item()


def follow(m: ModelShape, seed: int, batches: list, hyper: dict, device,
           precision: str = "f32", rows=None) -> dict:
    """Trains from the seed's weights over ``batches``: the loss of each
    step, each leaf's first-gradient norm and each leaf's change after the
    last step."""
    with full_f32():
        leaves = [weights.llama_leaf(m, name, seed, device).requires_grad_()
                  for name in weights.leaf_names(m)]
        moments = [(torch.zeros_like(p), torch.zeros_like(p))
                   for p in leaves]
        losses, grad_norms = [], None
        for step, tokens in enumerate(batches, 1):
            losses.append(batch_loss_backward(leaves, tokens, m, precision,
                                              rows))
            if step == 1:
                grad_norms = [norm(p.grad) for p in leaves]
            adamw_step(leaves, moments, step, hyper)
            for p in leaves:
                p.grad = None
        del moments
        changes = []
        for name, p in zip(weights.leaf_names(m), leaves):
            p0 = weights.llama_leaf(m, name, seed, device)
            changes.append(norm(p.detach() - p0))
            del p0
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": changes}
