"""Parameter-server fabric: sharded embedding serving, the port of
``brpc_tpu/ps.py``.

The BASELINE north-star app: "bRPC param-server serving Llama-3-8B embedding
shards, allreduce grads". The reference reaches this shape with
PartitionChannel (shard-addressed calls, src/brpc/partition_channel.h:75)
plus ParallelChannel fan-out for reduction (SURVEY.md §2.7). Here the tier
runs on a ``DeviceMesh`` (``parallel/mesh.py``):

- the embedding table lives row-sharded over a 'ps' mesh axis, a DTensor
  whose shard on each rank is ``vocab / n`` consecutive rows;
- ``lookup`` is the shard-addressed read: every rank gathers the rows it
  owns with K2 (``ops/embedding_rows.gather_rows``), zeroes the others,
  and an all-reduce over the axis's process group merges (exactly one
  shard owns each row, so an id outside the table reads as a zero row);
- ``apply_gradients`` is the sharded write: K3 (``scatter_sub``) subtracts
  ``lr * grads`` from the owning shard's rows only, in batch order;
- ``lookup``'s gradient is K3 too, on a zero shard with ``lr = -1``, so the
  table gradient sums each row's gradients in batch order, as the
  reference's scatter-add does, and not in the run-to-run order of atomics.

The reference's ``shard_map`` bodies are the per-rank code below. On CUDA
tensors the kernels launch; on CPU tensors their plain versions run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from brpc_tpu_torch.ops import embedding_rows
from brpc_tpu_torch.parallel.mesh import PartitionSpec as P, axis_size, \
    shard_batch


class EmbeddingShards(NamedTuple):
    """A [vocab, dim] table row-sharded over ``axis``: a DTensor whose local
    tensor on each rank is that rank's ``vocab / n`` rows."""

    table: DTensor
    vocab: int
    dim: int
    axis: str


def create_embedding(
    generator: torch.Generator,
    vocab: int,
    dim: int,
    mesh: DeviceMesh,
    axis: str = "ps",
    scale: float = 0.02,
    dtype: torch.dtype = torch.float32,
) -> EmbeddingShards:
    """A table drawn from ``generator`` (normal, times ``scale``) on the
    generator's device; each rank keeps its rows, on the mesh's device.
    Every rank must pass a generator in the same state."""
    if vocab % axis_size(mesh, axis) != 0:
        raise ValueError(
            f"vocab {vocab} not divisible by {axis}={axis_size(mesh, axis)}"
        )
    table = torch.randn((vocab, dim), generator=generator, dtype=dtype,
                        device=generator.device) * scale
    return EmbeddingShards(shard_batch(table, P(axis, None), mesh), vocab,
                           dim, axis)


def _owned(emb: EmbeddingShards, ids: torch.Tensor, mesh: DeviceMesh):
    """(ids relative to this rank's first row, mask of the ids it owns,
    rows a shard holds)."""
    rows_per = emb.vocab // axis_size(mesh, emb.axis)
    base = mesh.get_local_rank(emb.axis) * rows_per
    local = ids.reshape(-1).long() - base
    return local, (local >= 0) & (local < rows_per), rows_per


class _Lookup(torch.autograd.Function):
    """This rank's owned rows (zeros elsewhere), summed over the axis.

    Backward: the output's gradient is the same on every rank (each rank
    holds the whole replicated output), and the rank's shard gradient is
    its owned ids' gradient rows summed into a zero shard by K3 with
    ``lr = -1``: ``0 - (-1 * g)`` then ``acc - (-g)``, which round exactly
    as an ordered scatter-add. No collective runs in the backward; the
    reference's gradient through ``psum`` under ``shard_map`` is the same,
    not scaled by the axis size.
    """

    @staticmethod
    def forward(ctx, shard, safe, mine, group):
        out = embedding_rows.gather_rows(shard, safe)
        out.masked_fill_(~mine[:, None], 0)
        dist.all_reduce(out, dist.ReduceOp.SUM, group=group)
        ctx.save_for_backward(safe, mine)
        ctx.shard_shape = shard.shape
        return out

    @staticmethod
    def backward(ctx, grad):
        safe, mine = ctx.saved_tensors
        contrib = grad.masked_fill(~mine[:, None], 0).contiguous()
        zero = contrib.new_zeros(ctx.shard_shape)
        minus_one = torch.tensor(-1.0, device=zero.device)
        return (embedding_rows.scatter_sub(zero, safe, contrib, minus_one),
                None, None, None)


def _lookup_local(shard: torch.Tensor, emb: EmbeddingShards,
                  ids: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    ids = ids.to(shard.device)
    local, mine, rows_per = _owned(emb, ids, mesh)
    safe = local.clamp(0, rows_per - 1).to(torch.int32)
    out = _Lookup.apply(shard, safe, mine, mesh.get_group(emb.axis))
    return out.reshape(*ids.shape, emb.dim)


def lookup(emb: EmbeddingShards, ids: torch.Tensor,
           mesh: DeviceMesh) -> torch.Tensor:
    """Shard-addressed read: ids [...] -> rows [..., dim], the same on
    every rank.

    Every shard contributes its owned rows (zeros elsewhere); one sum over
    the axis merges — the PartitionChannel broadcast-read with additive
    merger. Differentiable with respect to ``emb.table``.
    """
    return _lookup_local(emb.table.to_local(), emb, ids, mesh)


def apply_gradients(
    emb: EmbeddingShards,
    ids: torch.Tensor,
    grads: torch.Tensor,
    mesh: DeviceMesh,
    lr: float = 1e-2,
) -> EmbeddingShards:
    """Sharded write: ``lr * grads`` subtracted from the owning shards'
    rows only, one id at a time in batch order, into a new table.

    An id this rank does not own carries a zero gradient onto its row 0, as
    in the reference (``x - lr * 0`` leaves ``x``'s bits as they were).
    ``x - lr*g`` equals the reference's ``x + (-lr*g)`` bit for bit, since
    negation is exact.
    """
    shard = emb.table.to_local()
    ids = ids.to(shard.device)
    local, mine, _ = _owned(emb, ids, mesh)
    safe = torch.where(mine, local, 0).to(torch.int32)
    contrib = grads.to(shard.device, torch.float32).reshape(-1, emb.dim)
    contrib = contrib.masked_fill(~mine[:, None], 0).contiguous()
    step = torch.tensor(lr, dtype=torch.float32, device=shard.device)
    new = embedding_rows.scatter_sub(shard, safe, contrib, step)
    return emb._replace(table=_like(emb.table, new))


def _like(table: DTensor, local: torch.Tensor) -> DTensor:
    """A DTensor laid out as ``table`` whose local tensor is ``local``."""
    return DTensor.from_local(local, table.device_mesh, table.placements,
                              shape=table.shape, stride=table.stride())


def make_ps_train_step(emb_axis: str, dp_axis: str, mesh: DeviceMesh,
                       lr: float):
    """The BASELINE #5 loop: embedding lookup → toy loss → sharded
    embedding update. Returns a step:
    (EmbeddingShards, ids [B,T], targets [B,T,dim]) -> (EmbeddingShards,
    loss).

    ids/targets are replicated here (each dp worker's slice handled by the
    caller's batch sharding); the demonstrative loss is MSE to targets. The
    table gradient comes from ``lookup``'s backward (K3 on the card), then
    the step is plain SGD on the whole shard, ``table - lr * grad``.
    ``emb_axis`` and ``dp_axis`` are taken as in the reference, which reads
    the axis from the table.
    """

    def step(emb: EmbeddingShards, ids, targets):
        shard = emb.table.to_local().detach().requires_grad_(True)
        with torch.enable_grad():
            pred = _lookup_local(shard, emb, ids, mesh)
            loss = torch.mean((pred - targets.to(pred.device)) ** 2)
        (grad,) = torch.autograd.grad(loss, shard)
        new = shard.detach() - lr * grad
        return emb._replace(table=_like(emb.table, new)), loss.detach()

    return step
