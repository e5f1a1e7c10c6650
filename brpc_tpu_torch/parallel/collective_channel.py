"""CollectiveChannel — the ParallelChannel contract over torch.distributed,
the port of ``brpc_tpu/parallel/collective_channel.py``.

The reference fans one call out to N sub-channels with a per-sub
``CallMapper`` (request slicing) and folds replies through a
``ResponseMerger`` (src/brpc/parallel_channel.h:94,127,185). Here the
"sub-channels" are the ranks along one mesh axis, the mapper is the rank's
shard of a DTensor, and the merger is a collective on that axis's process
group: gloo on the CPU, NCCL on the card. The RPC tier
(cpp/cluster/parallel_channel.*) remains the partial-failure-tolerant path;
this module is the bulk-synchronous tier.

Each method takes a global tensor: a ``DTensor`` in any layout (it is
redistributed to the layout the method reads), or a plain tensor that holds
the whole global value on every rank. A replicated result is a plain tensor
with the same value on every rank; a sharded one is a ``DTensor`` (its
``full_tensor()`` is the global value). The reference's ``shard_map``
bodies are written out as per-rank code. Unlike the reference's, these
methods are not differentiable: ``ps.lookup`` carries its own gradient.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from brpc_tpu_torch import obs
from brpc_tpu_torch.parallel.mesh import axis_size, contiguous_stride

_REDUCE = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}


def _record_collective(op: str, x: torch.Tensor) -> None:
    """Per-collective call + byte counters (``collective_<op>_calls`` /
    ``collective_<op>_bytes``), once per call, sized by the global
    tensor."""
    if not obs.enabled():
        return
    obs.counter(f"collective_{op}_calls").add(1)
    obs.counter(f"collective_{op}_bytes").add(
        int(np.prod(tuple(x.shape))) * x.element_size())


class CollectiveChannel:
    """Fan-out/merge primitives over one mesh axis.

    ``axis`` names the "sub-channel" dimension (the ParallelChannel's
    AddChannel list); ``mesh`` supplies the ranks.
    """

    def __init__(self, mesh: DeviceMesh, axis: str = "dp"):
        if axis not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"mesh has no axis {axis!r}: "
                             f"{mesh.mesh_dim_names}")
        self.mesh = mesh
        self.axis = axis
        self.group = mesh.get_group(axis)
        self._dim = mesh.mesh_dim_names.index(axis)

    @property
    def num_channels(self) -> int:
        return axis_size(self.mesh, self.axis)

    @property
    def index(self) -> int:
        """This rank's position along the axis."""
        return self.mesh.get_local_rank(self.axis)

    # ---- layouts: the reference's in_specs / out_specs ----

    def _sharded_placements(self):
        out = [Replicate()] * self.mesh.ndim
        out[self._dim] = Shard(0)
        return out

    def _shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``x`` sharded on dim 0 over the axis
        (in_specs ``P(axis)``)."""
        if isinstance(x, DTensor):
            return x.redistribute(
                self.mesh, self._sharded_placements()).to_local()
        n = self.num_channels
        if x.dim() == 0 or x.shape[0] % n:
            raise ValueError(f"dim 0 of {tuple(x.shape)} does not split "
                             f"into {n} shards")
        rows = x.shape[0] // n
        return x.narrow(0, self.index * rows, rows)

    def _whole(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` replicated (in_specs ``P(None, ...)``)."""
        if isinstance(x, DTensor):
            return x.redistribute(
                self.mesh, [Replicate()] * self.mesh.ndim).to_local()
        return x

    def _sharded_result(self, local: torch.Tensor) -> DTensor:
        """out_specs ``P(axis)``: a DTensor of this rank's rows."""
        local = local.contiguous()
        shape = (local.shape[0] * self.num_channels, *local.shape[1:])
        return DTensor.from_local(
            local, self.mesh, self._sharded_placements(),
            shape=torch.Size(shape), stride=contiguous_stride(shape))

    def _peer(self, index: int) -> int:
        """The global rank at ``index`` along the axis."""
        return dist.get_global_rank(self.group, index)

    # ---- ParallelChannel analogs (fan-out + ResponseMerger) ----

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Every shard contributes, every shard receives the merge.

        The reference shape: ParallelChannel broadcast + additive merger.
        x is sharded over ``axis`` on its leading dim; each shard is summed
        over that dim, and the result is the elementwise reduction of
        those sums, replicated.
        """
        _record_collective("all_reduce", x)
        out = self._shard(x).sum(0)
        dist.all_reduce(out, _REDUCE[op], group=self.group)
        return out

    def all_reduce_inplace(self, x: torch.Tensor,
                           op: str = "sum") -> torch.Tensor:
        """AllReduce of replicated-shape tensors (grad sync): x has the SAME
        shape on every shard; result is the cross-shard reduction. A plain
        ``x`` is this rank's own value; ``x`` itself is left as it was."""
        _record_collective("all_reduce_inplace", x)
        out = self._whole(x).clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, _REDUCE[op], group=self.group)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Each shard's slice, concatenated everywhere (fan-out + concat
        merger — the reference's default "append responses in channel
        order")."""
        _record_collective("all_gather", x)
        shard = self._shard(x).contiguous()
        out = shard.new_empty((shard.shape[0] * self.num_channels,
                               *shard.shape[1:]))
        dist.all_gather_into_tensor(out, shard, group=self.group)
        return out

    def reduce_scatter(self, x: torch.Tensor) -> DTensor:
        """Sum across shards, then each shard keeps its slice (the sharded
        merger — PartitionChannel's write path)."""
        _record_collective("reduce_scatter", x)
        whole = self._whole(x).contiguous()
        n = self.num_channels
        if whole.dim() == 0 or whole.shape[0] % n:
            raise ValueError(f"dim 0 of {tuple(whole.shape)} does not "
                             f"split into {n} shards")
        out = whole.new_empty((whole.shape[0] // n, *whole.shape[1:]))
        dist.reduce_scatter_tensor(out, whole, group=self.group)
        return self._sharded_result(out)

    def broadcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """Root shard's value everywhere (SelectiveChannel pick-one +
        replicate)."""
        _record_collective("broadcast", x)
        out = self._shard(x).clone(memory_format=torch.contiguous_format)
        dist.broadcast(out, src=self._peer(root), group=self.group)
        return out

    def shift(self, x: torch.Tensor, offset: int = 1) -> DTensor:
        """Neighbour exchange over the ring — the streaming-RPC/cascade
        analog: shard i moves to shard (i + offset) mod n."""
        _record_collective("shift", x)
        n = self.num_channels
        shard = self._shard(x).contiguous()
        if offset % n == 0:
            return self._sharded_result(shard.clone())
        out = torch.empty_like(shard)
        me = self.index
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, shard, self._peer((me + offset) % n),
                       self.group),
            dist.P2POp(dist.irecv, out, self._peer((me - offset) % n),
                       self.group)])
        for req in reqs:
            req.wait()
        return self._sharded_result(out)

    def map_reduce(
        self,
        fn: Callable[[torch.Tensor], torch.Tensor],
        x: torch.Tensor,
        op: str = "sum",
    ) -> torch.Tensor:
        """CallMapper + ResponseMerger in one: apply ``fn`` per shard
        (mapper), reduce results across shards (merger)."""
        _record_collective("map_reduce", x)
        out = fn(self._shard(x)).contiguous()
        dist.all_reduce(out, _REDUCE[op], group=self.group)
        return out


def allreduce_benchmark(
    mesh: DeviceMesh,
    axis: str = "dp",
    size_mb: float = 64.0,
    iters: int = 20,
    dtype=torch.float32,
):
    """The BASELINE #3 workload: an fp32 ``all_reduce`` over ``axis``;
    returns GB/s/chip.

    Algorithm bandwidth = 2*(n-1)/n * bytes / time per chip (ring allreduce
    moves each byte twice around all-but-one hops). As in the reference,
    ``all_reduce`` first sums each rank's shard to a scalar, so the
    collective itself carries one value; and with one rank on the axis the
    figure is 0 by construction. ``world_size`` is returned beside it so
    that nobody reads it as a link speed.
    """
    chan = CollectiveChannel(mesh, axis)
    n = chan.num_channels
    itemsize = torch.empty((), dtype=dtype).element_size()
    elems = int(size_mb * 1e6 / itemsize)
    elems = max(elems - elems % (n * 128), n * 128)
    local = torch.ones((elems // n,), dtype=dtype, device=mesh.device_type)
    x = DTensor.from_local(local, mesh, chan._sharded_placements(),
                           shape=torch.Size((elems,)), stride=(1,))

    def sync():
        if mesh.device_type == "cuda":
            torch.cuda.synchronize()

    chan.all_reduce(x, "sum")  # warm-up: the communicator's first call
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        chan.all_reduce(x, "sum")
    sync()
    dt = (time.perf_counter() - t0) / iters
    nbytes = elems * itemsize
    algo_bytes = 2 * (n - 1) / n * nbytes
    return {
        "bytes": nbytes,
        "seconds": dt,
        "gbps_per_chip": algo_bytes / dt / 1e9,
        "devices": n,
        "world_size": dist.get_world_size(),
    }
