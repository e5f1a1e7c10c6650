"""A gloo world of processes on the CPU for the port's collective tests.

``run(program, world, workdir)`` starts ``world`` processes of this file.
Each joins one default process group through a ``FileStore`` in
``workdir`` (no TCP port, so parallel test workers never collide), runs
``PROGRAMS[program](rank, inputs)`` with the arrays of
``workdir/inputs.npz`` (if the test wrote one), and saves the dict of numpy
arrays it returns to ``workdir/rank<r>.npz``. ``run`` returns those dicts,
one per rank, in rank order. The ranks import ``torch`` and the port, never
``jax`` or ``brpc_tpu``: the tests hold their results against the
reference's functions in the test process.

Inputs that need no reference (fixed aranges, seeded numpy draws) are made
here by functions both sides call.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 240


def run(program: str, world: int, workdir: Path) -> list:
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, __file__, program, str(rank), str(world),
         str(workdir)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    deadline = time.monotonic() + TIMEOUT_S
    outs = []
    try:
        for p in procs:
            left = max(deadline - time.monotonic(), 1.0)
            outs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    failed = [(r, p.returncode, out) for r, (p, out)
              in enumerate(zip(procs, outs)) if p.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(
            f"rank {r} exited {rc}:\n{out[-3000:]}" for r, rc, out in failed))
    results = []
    for rank in range(world):
        with np.load(workdir / f"rank{rank}.npz") as f:
            results.append({k: f[k] for k in f.files})
    return results


# -- inputs both sides make ---------------------------------------------------

def parallel_inputs() -> dict:
    """The arrays of ``tests/test_parallel.py``'s collective tests."""
    return {
        "reduce": np.arange(64, dtype=np.float32).reshape(8, 8),
        "gather": np.arange(32, dtype=np.float32).reshape(16, 2),
        "scatter": np.arange(64, dtype=np.float32).reshape(16, 4),
        "ring": np.arange(8, dtype=np.float32).reshape(8, 1),
        "ones": np.ones((8, 4), np.float32),
        "grad": np.arange(24, dtype=np.float32).reshape(4, 6) / 7,
    }


SHIFTS = (1, 3, -1, 8)
BROADCAST_ROOT = 3


def shard_inputs() -> dict:
    """Params and a batch for ``shard_params`` / ``shard_batch`` on the
    (dp=2, tp=4) mesh, with their specs (as tuples of axis names)."""
    rng = np.random.default_rng(11)
    params = {"w": rng.standard_normal((8, 12)).astype(np.float32),
              "b": rng.standard_normal(12).astype(np.float32),
              "e": rng.standard_normal((16, 4)).astype(np.float32),
              "s": rng.standard_normal(6).astype(np.float32)}
    specs = {"w": (None, "tp"), "b": ("tp",), "e": (("dp", "tp"), None),
             "s": ("sp",)}
    batch = rng.standard_normal((8, 6)).astype(np.float32)
    return {"params": params, "specs": specs, "batch": batch,
            "batch_spec": ("dp", None)}


# -- rank programs -------------------------------------------------------------

def _parallel(rank: int, inputs: dict) -> dict:
    import torch

    from brpc_tpu_torch import obs
    from brpc_tpu_torch.parallel import (CollectiveChannel, PartitionSpec,
                                         allreduce_benchmark, make_mesh,
                                         shard_batch, shard_params)

    out = {}
    x = {k: torch.from_numpy(v) for k, v in parallel_inputs().items()}
    mesh8 = make_mesh({"dp": 8}, device_type="cpu")
    chan = CollectiveChannel(mesh8, "dp")
    for op in ("sum", "max", "min"):
        out[f"all_reduce_{op}"] = chan.all_reduce(x["reduce"], op)
    out["all_reduce_dtensor"] = chan.all_reduce(
        shard_batch(x["reduce"], PartitionSpec("dp"), mesh8))
    out["all_reduce_inplace"] = chan.all_reduce_inplace(x["grad"])
    out["all_reduce_inplace_own"] = chan.all_reduce_inplace(
        x["grad"] + rank)
    out["all_gather"] = chan.all_gather(x["gather"])
    rs = chan.reduce_scatter(x["scatter"])
    out["reduce_scatter_local"] = rs.to_local()
    out["reduce_scatter_full"] = rs.full_tensor()
    out["reduce_scatter_then_gather"] = chan.all_gather(rs)
    for k in SHIFTS:
        out[f"shift_{k}"] = chan.shift(x["ring"], k).full_tensor()
    out["broadcast"] = chan.broadcast(x["gather"], BROADCAST_ROOT)
    out["map_reduce"] = chan.map_reduce(lambda s: torch.sum(s * 2),
                                        x["ones"])
    obs.set_enabled(True)
    calls = obs.counter("collective_all_reduce_calls").get_value()
    nbytes = obs.counter("collective_all_reduce_bytes").get_value()
    chan.all_reduce(x["reduce"])
    out["counter_calls"] = torch.tensor(
        obs.counter("collective_all_reduce_calls").get_value() - calls)
    out["counter_bytes"] = torch.tensor(
        obs.counter("collective_all_reduce_bytes").get_value() - nbytes)
    bench = allreduce_benchmark(mesh8, "dp", size_mb=0.01, iters=2)
    for key, value in bench.items():
        out[f"bench_{key}"] = torch.tensor(value)

    # make_mesh: 'dp' absorbs the ranks the named axes leave over.
    for name, axes in (("tp4", {"tp": 4}), ("all", None),
                       ("tp2_sp2", {"tp": 2, "sp": 2})):
        mesh = make_mesh(axes, device_type="cpu")
        out[f"mesh_{name}_names"] = np.array(mesh.mesh_dim_names)
        out[f"mesh_{name}_shape"] = torch.tensor(tuple(mesh.shape))
        out[f"mesh_{name}_coordinate"] = torch.tensor(mesh.get_coordinate())
    for name, axes in (("tp3", {"tp": 3}), ("dp2_tp2", {"dp": 2, "tp": 2})):
        try:
            make_mesh(axes, device_type="cpu")
            out[f"mesh_{name}_raises"] = np.array("")
        except ValueError as e:
            out[f"mesh_{name}_raises"] = np.array(str(e))

    mesh = make_mesh({"tp": 4}, device_type="cpu")
    data = shard_inputs()
    sharded = shard_params(
        {k: torch.from_numpy(v) for k, v in data["params"].items()},
        {k: PartitionSpec(*v) for k, v in data["specs"].items()}, mesh)
    for key, t in sharded.items():
        out[f"shard_{key}"] = t.to_local()
        out[f"shard_{key}_full"] = t.full_tensor()
    batch = shard_batch(torch.from_numpy(data["batch"]),
                        PartitionSpec(*data["batch_spec"]), mesh)
    out["shard_batch"] = batch.to_local()
    return out


def _ps(rank: int, inputs: dict) -> dict:
    import torch

    from brpc_tpu_torch import ps
    from brpc_tpu_torch.models.convert import embedding_from_reference
    from brpc_tpu_torch.parallel import make_mesh

    out = {}
    mesh = make_mesh({"ps": 4}, device_type="cpu")

    def embedding(name):
        table = inputs[name]
        return embedding_from_reference(table, *table.shape, "ps", mesh)

    def t(name):
        return torch.from_numpy(inputs[name])

    emb = embedding("lookup_table")
    out["lookup_local"] = emb.table.to_local()
    for name in ("lookup_ids", "outside_ids"):
        out[name] = ps.lookup(emb, t(name), mesh)

    emb = embedding("apply_table")
    out["apply"] = ps.apply_gradients(
        emb, t("apply_ids"), t("apply_grads"), mesh, lr=0.5).table.to_local()
    emb = embedding("mixed_table")
    out["mixed"] = ps.apply_gradients(
        emb, t("mixed_ids"), t("mixed_grads"), mesh,
        lr=float(inputs["mixed_lr"])).table.to_local()

    emb = embedding("train_table")
    ids, targets = t("train_ids"), t("train_targets")
    table = emb.table.detach().requires_grad_(True)
    pred = ps.lookup(emb._replace(table=table), ids, mesh)
    (grad,) = torch.autograd.grad(torch.mean((pred - targets) ** 2), table)
    out["train_grad"] = grad.to_local()
    step = ps.make_ps_train_step("ps", "dp", mesh, lr=0.5)
    emb1, loss0 = step(emb, ids, targets)
    out["train_table1"] = emb1.table.to_local()
    losses = [loss0]
    for _ in range(20):
        emb, loss = step(emb, ids, targets)
        losses.append(loss)
    out["train_losses"] = torch.stack(losses)

    try:
        ps.create_embedding(torch.Generator().manual_seed(0), 30, 4, mesh)
        out["create_raises"] = np.array("")
    except ValueError as e:
        out["create_raises"] = np.array(str(e))
    drawn = ps.create_embedding(torch.Generator().manual_seed(7), 64, 8,
                                mesh)
    out["created_local"] = drawn.table.to_local()
    out["created_full"] = drawn.table.full_tensor()
    out["created_draw"] = torch.randn(
        (64, 8), generator=torch.Generator().manual_seed(7)) * 0.02
    return out


PROGRAMS = {"parallel": _parallel, "ps": _ps}


def _main(program: str, rank: int, world: int, workdir: str) -> None:
    import torch
    import torch.distributed as dist

    from brpc_tpu_torch.parallel import init_world

    torch.set_num_threads(1)
    workdir = Path(workdir)
    inputs = {}
    if (workdir / "inputs.npz").exists():
        with np.load(workdir / "inputs.npz") as f:
            inputs = {k: f[k] for k in f.files}
    init_world(str(workdir), rank, world, device_type="cpu")
    try:
        out = PROGRAMS[program](rank, inputs)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(workdir / f"rank{rank}.npz", **{
        k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
        for k, v in out.items()})


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
