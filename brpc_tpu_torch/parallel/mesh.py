"""Device-mesh construction and sharding helpers, the port of
``brpc_tpu/parallel/mesh.py``.

The reference names the parallelism dimensions as the axes of a
``jax.sharding.Mesh``; here they are the named dimensions of a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, one rank a device:

- dp: data parallel (ParallelChannel fan-out + merge == grad allreduce)
- tp: tensor parallel (PartitionChannel's N/M sharding)
- sp: sequence parallel
- pp: pipeline parallel
- ps: the parameter server's row-sharded tables (``brpc_tpu_torch.ps``)

The reference's ``_compat.shard_map`` has no counterpart. A ``shard_map``
body of the reference becomes explicit code that each rank runs on its own
shard (``DTensor.to_local()``), with its collectives on the process group
of the mesh axis it names (``mesh.get_group(axis)``): see
``collective_channel.py`` and ``ps.py``.

A sharded tensor is a ``DTensor``: ``PartitionSpec`` entries map to
``Shard(dim)`` on the mesh dimensions they name and ``Replicate()`` on the
others. ``jax.sharding`` may not be imported here, so ``PartitionSpec`` is
the port's own twin.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pickle
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.placement_types import Placement


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (not sharded), a mesh axis
    name, or a tuple of names (sharded over their product, major first),
    as ``jax.sharding.PartitionSpec``, which also reads a tuple of one
    name as that name and an empty tuple as ``None``."""

    def __new__(cls, *entries):
        def canonical(entry):
            if isinstance(entry, (tuple, list)):
                return tuple(entry) if len(entry) > 1 else \
                    (entry[0] if entry else None)
            return entry
        return super().__new__(cls, (canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def init_world(store_dir: str, rank: int, world_size: int,
               device_type: str = "cuda",
               timeout: Optional[datetime.timedelta] = None) -> None:
    """Joins this process to a default process group of ``world_size``
    ranks that meet through a ``FileStore`` in ``store_dir``, so no TCP
    port is taken: NCCL for ``cuda``, gloo for ``cpu``. On ``cuda`` the
    rank's card is ``rank % device_count``, made current before anything
    is allocated and bound to the group (``device_id``: the communicator
    is made at once, on that card, and no collective guesses the rank's
    card). ``timeout`` bounds the store's waits and each collective
    (torch's default where None)."""
    kw = {} if timeout is None else {"timeout": timeout}
    if device_type == "cuda":
        card = rank % torch.cuda.device_count()
        torch.cuda.set_device(card)
        kw["device_id"] = torch.device("cuda", card)
    store = dist.FileStore(os.path.join(store_dir, "store"), world_size)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=store, rank=rank, world_size=world_size,
                            **kw)


class WorldFailed(RuntimeError):
    """A world of ``run_world`` failed or ran over its time limit; every
    rank has been stopped. ``parts`` maps each rank that had not finished
    to the part it was in."""

    def __init__(self, message: str, parts: Dict[int, str]):
        super().__init__(message)
        self.parts = parts


@dataclasses.dataclass(frozen=True)
class RankContext:
    """What ``run_world`` hands the body on each rank: its rank, the world
    size, the device type, and ``part(name)``, which records the part the
    rank is in so that a failed or hung world can name it."""

    rank: int
    world_size: int
    device_type: str
    store_dir: str

    @property
    def device(self) -> torch.device:
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.device_type)

    def part(self, name: str) -> None:
        _write(os.path.join(self.store_dir, f"rank{self.rank}.part"),
               name.encode())


def _write(path: str, data: bytes) -> None:
    """Replaces the file at ``path`` whole (a reader never sees half)."""
    with open(path + ".tmp", "wb") as f:
        f.write(data)
    os.replace(path + ".tmp", path)


def run_world(body: Callable, world_size: int, *, args: tuple = (),
              device_type: str = "cuda", timeout_s: float) -> list:
    """Runs ``body(ctx, *args)`` on ``world_size`` new processes (spawned),
    each joined to one world by ``init_world`` with ``ctx`` a
    ``RankContext``, and returns each rank's return value (pickled back:
    host values only) in rank order. Rank r is on card r under ``cuda``,
    one rank a card: fewer cards than ranks raise ``RuntimeError`` before
    any process starts, and there is no fallback to the CPU.

    The whole world has ``timeout_s`` seconds (each collective the same).
    A rank that raises, or a world that runs over, stops every rank
    (SIGKILL for one that does not stop) and raises ``WorldFailed`` naming
    each unfinished rank and its part."""
    if device_type == "cuda" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"a world of {world_size} ranks needs "
                           f"{world_size} CUDA devices, found "
                           f"{torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory(prefix="world-") as store:
        procs = mp.start_processes(
            _rank_main, (body, args, world_size, store, device_type,
                         timeout_s),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not procs.join(timeout=max(
                    0.0, min(1.0, deadline - time.monotonic())),
                    grace_period=2.0):
                if time.monotonic() >= deadline:
                    parts = _unfinished(store, world_size)
                    raise WorldFailed(
                        f"a world of {world_size} ranks ran over its "
                        f"{timeout_s} s: " + ", ".join(
                            f"rank {r} in {p!r}" for r, p in parts.items()),
                        parts)
        except ProcessException as e:
            # the ranks that raised, each with its traceback's last line
            # (one rank's failure often makes its peers' collectives fail)
            errors = {}
            for rank, path in enumerate(procs.error_files):
                if os.access(path, os.R_OK):
                    with open(path, "rb") as f:
                        errors[rank] = pickle.load(f).strip() \
                            .splitlines()[-1]
            parts = _unfinished(store, world_size)
            raise WorldFailed(
                f"a world of {world_size} ranks failed: " + "; ".join(
                    f"rank {r} in {p!r}" + (f" raised {errors[r]}"
                                            if r in errors else "")
                    for r, p in parts.items()) + f"\n{e}", parts) from e
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for rank in range(world_size):
            with open(os.path.join(store, f"rank{rank}.result"), "rb") as f:
                results.append(pickle.load(f))  # written by our own ranks
        return results


def _unfinished(store: str, world_size: int) -> Dict[int, str]:
    """Each rank that wrote no result, with the last part it recorded."""
    out = {}
    for rank in range(world_size):
        if os.path.exists(os.path.join(store, f"rank{rank}.result")):
            continue
        try:
            with open(os.path.join(store, f"rank{rank}.part")) as f:
                out[rank] = f.read()
        except FileNotFoundError:
            out[rank] = "starting"
    return out


def _rank_main(rank: int, body: Callable, args: tuple, world_size: int,
               store: str, device_type: str, timeout_s: float) -> None:
    torch.set_num_threads(1)
    ctx = RankContext(rank, world_size, device_type, store)
    ctx.part("init_world")
    init_world(store, rank, world_size, device_type,
               datetime.timedelta(seconds=timeout_s))
    try:
        result = body(ctx, *args)
        ctx.part("final barrier")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    _write(os.path.join(store, f"rank{rank}.result"), pickle.dumps(result))


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None, *,
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh over every rank of the default process group. An unnamed
    leading 'dp' absorbs the ranks the named axes leave over.

    make_mesh({'tp': 4}) on 8 ranks -> mesh (dp=2, tp=4).
    make_mesh() -> every rank on 'dp'.
    """
    n = dist.get_world_size()
    axis_sizes = dict(axis_sizes or {})
    named = math.prod(axis_sizes.values())
    if n % named != 0:
        raise ValueError(f"{n} devices not divisible by axes {axis_sizes}")
    if "dp" not in axis_sizes:
        axis_sizes = {"dp": n // named, **axis_sizes}
    elif named != n:
        raise ValueError(f"axes {axis_sizes} do not cover {n} devices")
    return init_device_mesh(device_type, tuple(axis_sizes.values()),
                            mesh_dim_names=tuple(axis_sizes))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis``, as ``mesh.shape[axis]`` in
    the reference."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {axis!r}: "
                         f"{mesh.mesh_dim_names}")
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_group(mesh: DeviceMesh, axis: Optional[str]):
    """The process group of ``axis``, or None where the mesh lacks the axis
    or the axis has one rank (then there is nothing to send)."""
    names = mesh.mesh_dim_names or ()
    if axis not in names or mesh.size(names.index(axis)) == 1:
        return None
    return mesh.get_group(axis)


def axis_index(mesh: DeviceMesh, axis: Optional[str]) -> int:
    """This rank's position along ``axis`` (0 where the mesh lacks it), as
    ``lax.axis_index``."""
    if axis not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(axis)


@dataclasses.dataclass(frozen=True)
class Ranks:
    """The mesh as one rank's per-rank code sees it: the process group of
    each of the axes 'dp', 'tp' and 'sp' (None for one rank or no such
    axis) and this rank's index on 'tp' and 'sp'. ``Ranks()`` is one rank
    that holds the whole model and the whole batch."""

    mesh: Optional[DeviceMesh] = None
    dp: object = None
    tp: object = None
    sp: object = None
    tp_index: int = 0
    sp_index: int = 0

    @staticmethod
    def of(mesh: DeviceMesh) -> "Ranks":
        return Ranks(mesh, axis_group(mesh, "dp"), axis_group(mesh, "tp"),
                     axis_group(mesh, "sp"), axis_index(mesh, "tp"),
                     axis_index(mesh, "sp"))

    @property
    def tp_size(self) -> int:
        return 1 if self.tp is None else dist.get_world_size(self.tp)

    @property
    def sp_size(self) -> int:
        return 1 if self.sp is None else dist.get_world_size(self.sp)

    def spec(self, *axes: Optional[str]) -> PartitionSpec:
        """A spec over these axes, with None for an axis of one rank: such
        an axis holds the whole dimension, so no collective moves it."""
        return PartitionSpec(*(a if axis_group(self.mesh, a) is not None
                               else None for a in axes))


def _norm_spec(spec: PartitionSpec, mesh) -> PartitionSpec:
    """Drop mesh axes the mesh doesn't have (lets one spec table serve
    dp-only and dp+tp meshes)."""
    names = set(mesh.mesh_dim_names or ())

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(e for e in entry if e in names)
            return kept if kept else None
        return entry if entry in names else None

    return PartitionSpec(*(keep(e) for e in spec))


def _placements(spec: PartitionSpec, mesh: DeviceMesh,
               ndim: int) -> List[Placement]:
    """The DTensor placements, one per mesh dimension, of a tensor of
    ``ndim`` dimensions laid out by ``spec`` (axes the mesh lacks
    dropped)."""
    spec = _norm_spec(spec, mesh)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dimensions")
    names = list(mesh.mesh_dim_names)
    out: List[Placement] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for i in where:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} used twice in "
                                 f"{spec}")
            out[i] = Shard(dim)
    return out


def _narrow(t: torch.Tensor, where: List[Placement],
            mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of the whole ``t`` under ``where`` (a view). A
    sharded dimension must divide evenly."""
    local = t
    for i, (p, at) in enumerate(zip(where, mesh.get_coordinate())):
        if isinstance(p, Shard):
            size, parts = local.shape[p.dim], mesh.size(i)
            if size % parts:
                raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not "
                                 f"split into {parts} shards")
            local = local.narrow(p.dim, at * (size // parts), size // parts)
    return local


def _put(t: torch.Tensor, spec: PartitionSpec, mesh: DeviceMesh) -> DTensor:
    """Every rank holds the same full ``t`` (built from the same seed) and
    keeps a copy of its own shard on the mesh's device: no data moves
    between ranks. A sharded dimension must divide evenly."""
    where = _placements(spec, mesh, t.dim())
    local = _narrow(t, where, mesh)
    local = local.to(mesh.device_type, copy=True).contiguous()
    return DTensor.from_local(local, mesh, where, shape=t.shape,
                              stride=contiguous_stride(t.shape))


def local_block(x: torch.Tensor, spec: PartitionSpec,
                mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of the global ``x`` laid out by ``spec`` (the
    reference's ``in_specs``): a ``DTensor`` in any layout is redistributed
    to it, a plain tensor that holds the whole value is cut. Both are
    differentiable."""
    where = _placements(spec, mesh, x.dim())
    if isinstance(x, DTensor):
        return x.redistribute(mesh, where).to_local()
    return _narrow(x, where, mesh)


def from_block(local: torch.Tensor, spec: PartitionSpec, mesh: DeviceMesh,
               shape) -> DTensor:
    """The global tensor of ``shape`` whose block on each rank, laid out by
    ``spec`` (the reference's ``out_specs``), is ``local``."""
    shape = torch.Size(shape)
    return DTensor.from_local(local, mesh, _placements(spec, mesh, len(shape)),
                              shape=shape, stride=contiguous_stride(shape))


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    stride, step = [], 1
    for size in reversed(shape):
        stride.append(step)
        step *= size
    return tuple(reversed(stride))


def shard_params(params, specs, mesh: DeviceMesh):
    """A param tree (nested dicts) with each leaf laid out by its
    PartitionSpec in ``specs``, as DTensors on the mesh's device."""
    if isinstance(specs, PartitionSpec):
        return _put(params, specs, mesh)
    if not isinstance(specs, dict) or not isinstance(params, dict) \
            or set(specs) != set(params):
        raise ValueError(f"specs {specs!r} do not match the params' keys")
    return {key: shard_params(params[key], specs[key], mesh)
            for key in params}


def shard_batch(batch: torch.Tensor, spec: PartitionSpec,
                mesh: DeviceMesh) -> DTensor:
    return _put(batch, spec, mesh)
