"""Checkpoint and resume of training state: the port of
``brpc_tpu/utils/checkpoint.py`` on ``torch.distributed.checkpoint``.

The state is a nested dict, as the reference's pytree is, for example
``{"params": params, "opt_state": optimizer.state_dict(), "step": 3}``.
Each step is one directory, ``<ckpt_dir>/<step>``, written under a
temporary name and renamed when complete, so ``latest_step`` never sees a
partial save; the oldest steps beyond ``max_to_keep`` are deleted. A single
process needs no process group. In a world of several ranks every rank
joins the save (each writes its shards of DTensors; a replicated tensor is
written once), and one rank, the default group's rank 0, clears, renames
and prunes the directories, between barriers, so no rank renames or
deletes what another is still writing.

Restoring into a template fills the template's tensors in place (its
optimizer must already hold state: ``optim.init_state``), then hand the
restored ``"opt_state"`` to ``optimizer.load_state_dict``. Without a
template the saved tree comes back as new CPU tensors, and every dict key
as a string (the optimizer's integer keys included).
"""

from __future__ import annotations

import os
import shutil
import warnings
from typing import Any

import torch.distributed as dist
import torch.distributed.checkpoint as dcp

# One process and no process group is how this module saves and loads, so
# dcp's note that it assumes a single process says nothing.
_SINGLE_PROCESS = r"torch\.distributed is .*uninitialized"


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(name) for name in os.listdir(ckpt_dir)
                  if name.isdigit())


def save_checkpoint(ckpt_dir: str, step: int, state: Any,
                    max_to_keep: int = 3, blocking: bool = True) -> None:
    """Saves ``state`` as step ``step`` and keeps the newest
    ``max_to_keep`` steps. The save is complete when this returns, on
    every rank and with ``blocking`` either way, as the reference's is (its
    manager waits for the save when it closes)."""
    final = os.path.join(os.path.abspath(ckpt_dir), str(step))
    partial = f"{final}.partial"
    world = dist.is_initialized()
    lead = not world or dist.get_rank() == 0
    if lead:
        shutil.rmtree(partial, ignore_errors=True)
    if world:
        dist.barrier()  # nobody writes into the partial before it is clear
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", _SINGLE_PROCESS)
        dcp.save(state, checkpoint_id=partial)
    if world:
        dist.barrier()  # every rank's files are written
    if lead:
        shutil.rmtree(final, ignore_errors=True)
        os.rename(partial, final)
        for old in _steps(ckpt_dir)[:-max_to_keep]:
            shutil.rmtree(os.path.join(ckpt_dir, str(old)))
    if world:
        dist.barrier()  # the step is visible to every rank


def latest_step(ckpt_dir: str) -> int | None:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: int | None = None,
                       template: Any = None) -> Any:
    """Restores the state saved at ``step`` (default: the latest). With
    ``template`` (a tree of like-shaped tensors, on any device) the values
    are loaded into it and it is returned; without, the saved tree."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(os.path.abspath(ckpt_dir), str(step))
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint of step {step} in {ckpt_dir}")
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", _SINGLE_PROCESS)
        if template is None:
            return _load_all(path)
        dcp.load(template, checkpoint_id=path)
    return template


def _load_all(path: str) -> Any:
    """The whole saved tree, with no template: dcp's loader for that is
    private, and this is the one place that calls it."""
    from torch.distributed.checkpoint.state_dict_loader import (
        _load_state_dict_from_keys)

    return _load_state_dict_from_keys(checkpoint_id=path)
