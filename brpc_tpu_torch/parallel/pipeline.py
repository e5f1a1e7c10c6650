"""Pipeline parallelism over a 'pp' mesh axis, the port of
``brpc_tpu/parallel/pipeline.py``.

The reference's streaming RPC is an ordered byte pipe between stages; its
compiled sibling passes activations from stage i to stage i+1 with
GPipe-style microbatch scheduling: at tick t, stage s computes microbatch
t - s while its previous output travels on. Here the pipe is a
``batch_isend_irecv`` shift on the axis's process group, and each rank
runs one stage.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from brpc_tpu_torch.parallel import functional as F
from brpc_tpu_torch.parallel.mesh import PartitionSpec as P, axis_group, \
    axis_index, from_block, local_block
from brpc_tpu_torch.utils.tree import tree_map


@torch.no_grad()
def pipeline_apply_local(stage_fn: Callable, params, x_blk: torch.Tensor,
                         group, stage: int, microbatches: int
                         ) -> torch.Tensor:
    """This rank's stage: ``params`` are its stage's (the leading stage
    dim dropped), ``x_blk`` its rows of the input; returns its rows of the
    output. ``group`` is the pipeline axis's process group (None for one
    stage), ``stage`` this rank's position on it."""
    n = F.group_size(group)
    mb = microbatches
    # Every stage gathers the whole microbatch set; stage 0 feeds it.
    if n == 1:
        x_all = x_blk
    else:
        x_all = x_blk.new_empty((n * x_blk.shape[0], *x_blk.shape[1:]))
        dist.all_gather_into_tensor(x_all, x_blk.contiguous(), group=group)
    m_total = x_all.shape[0]
    if m_total % mb:
        raise ValueError(f"{m_total} rows do not split into {mb} "
                         "microbatches")
    shaped = x_all.reshape(mb, m_total // mb, *x_all.shape[1:])

    inflight = torch.zeros_like(shaped[0])
    done = torch.zeros_like(shaped)
    for t in range(mb + n - 1):
        cur = shaped[min(t, mb - 1)] if stage == 0 else inflight
        # a stage outside its window passes its input on unchanged
        out = stage_fn(params, cur) if 0 <= t - stage < mb else cur
        bank = t - (n - 1)
        if stage == n - 1 and 0 <= bank < mb:
            done[bank] = out
        # the activation pipe: pass right (the S-1 -> 0 link carries data
        # that stage 0 ignores, since it injects fresh input)
        (inflight,) = F.shift(group, 1, out)

    full = done.reshape(m_total, *x_all.shape[1:])
    # only stage n-1 banked results; a sum of masked copies broadcasts them
    if stage != n - 1:
        full.zero_()
    if n > 1:
        dist.all_reduce(full, group=group)
    per = m_total // n
    return full[stage * per:(stage + 1) * per]


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                   mesh: DeviceMesh, axis: str = "pp",
                   microbatches: Optional[int] = None) -> torch.Tensor:
    """Runs ``microbatches`` slices of ``x`` through all pipeline stages.

    ``stage_params``: a tensor or a dict tree whose leaves have a leading
    [n_stages] dim, global and sharded over ``axis`` (each rank holds its
    stage's params). ``stage_fn(params_for_stage, microbatch) ->
    microbatch`` (same shape). ``x``: [M, ...] global, M divisible by
    ``microbatches`` (default: the number of stages). Returns the fully
    processed x, a DTensor laid out as ``P(axis)``.

    Schedule: the classic loop of M + S - 1 ticks; at each tick every
    stage computes one microbatch then passes it right; stage 0 feeds
    fresh microbatches, stage S-1 banks results. Bubble fraction
    (S-1)/(M+S-1). Forward only: the result carries no gradient.
    """
    group = axis_group(mesh, axis)
    params = tree_map(lambda p: local_block(p, P(axis), mesh)[0],
                      stage_params)
    out = pipeline_apply_local(
        stage_fn, params, local_block(x, P(axis), mesh), group,
        axis_index(mesh, axis), microbatches or F.group_size(group))
    return from_block(out.contiguous(), P(axis), mesh, x.shape)
