"""Nested dicts of tensors, walked in one fixed order.

The order is that of ``jax.tree_util`` on the reference's params: keys
sorted at every level. The optimizer numbers its leaves in this order, so
its state dict and a checkpoint of it line up with the params.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

Tree = Dict[str, object]


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """Every tensor of ``tree``, keys sorted at every level."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Tree) -> Tree:
    """A tree of the same keys with ``fn`` applied to every tensor."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    return fn(tree)
