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


def _np(t):
    """A DTensor's whole value or a tensor, as numpy."""
    from torch.distributed.tensor import DTensor

    t = t.detach()
    return (t.full_tensor() if isinstance(t, DTensor) else t).float().numpy()


def _flat_params(prefix, params, out):
    from brpc_tpu_torch.utils.tree import tree_leaves

    for i, leaf in enumerate(tree_leaves(params)):
        out[f"{prefix}{i}"] = _np(leaf)


def _recording_mode(calls: list):
    """A dispatch mode that appends every c10d collective the dispatcher
    sees (the process group's own calls and DTensor's functional ones,
    forward and backward) to ``calls``: (op, tensor shapes, the ranks of
    its group)."""
    import torch
    import torch.distributed as dist
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    def group_ranks(arg):
        if isinstance(arg, torch.ScriptObject) and \
                arg._type().qualified_name().endswith(".ProcessGroup"):
            return tuple(dist.get_process_group_ranks(
                dist.ProcessGroup.unbox(arg)))
        return None

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace in ("c10d", "_c10d_functional"):
                flat = tree_leaves((args, kwargs or {}))
                groups = [g for g in map(group_ranks, flat) if g]
                calls.append((func._overloadpacket.__name__,
                              [tuple(a.shape) for a in flat
                               if isinstance(a, torch.Tensor)],
                              groups[0] if groups else ()))
            return func(*args, **(kwargs or {}))

    return Mode()


def _sharded_train(rank: int, inputs: dict) -> dict:
    import dataclasses

    import torch

    from brpc_tpu_torch import optim
    from brpc_tpu_torch.models import llama
    from brpc_tpu_torch.models.convert import params_from_jax
    from brpc_tpu_torch.parallel import (PartitionSpec, make_mesh,
                                         ring_attention, shard_batch,
                                         shard_params)
    from brpc_tpu_torch.utils import checkpoint
    from brpc_tpu_torch.utils.tree import tree_leaves

    out = {}

    def config(vocab, dtype):
        return dataclasses.replace(llama.LlamaConfig.tiny(vocab),
                                   dtype=dtype)

    def tree(prefix, cfg):
        keys = sorted(k[len(prefix):] for k in inputs if k.startswith(prefix))
        flat = {}
        for key in keys:
            node, *rest = key.split(".")
            if rest:
                flat.setdefault(node, {})[rest[0]] = inputs[prefix + key]
            else:
                flat[node] = inputs[prefix + key]
        return params_from_jax(flat, cfg, "cpu")

    # tests/test_llama.py:44: dp=4 x tp=2, SGD 1e-2, tokens (8, 16).
    tokens = torch.from_numpy(inputs["tp_tokens"])
    mesh = make_mesh({"tp": 2}, device_type="cpu")
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        cfg = config(64, dtype)
        init = tree("tp_params.", cfg)
        params = llama.trainable(shard_params(init, llama.param_specs(cfg),
                                              mesh))
        step = llama.make_train_step(cfg, optim.sgd(params, 1e-2))
        batch = shard_batch(tokens, llama.batch_specs(), mesh)
        if name == "f32":
            out["wq_local_shape"] = np.array(
                params["layers"]["wq"].to_local().shape)
            calls = []
            with _recording_mode(calls):
                loss = step(params, batch)
            out["calls"] = np.array(repr(calls))
        else:
            loss = step(params, batch)
        out[f"tp_{name}_loss"] = loss
        _flat_params(f"tp_{name}_p", params, out)
        one = llama.trainable(init)
        out[f"one_{name}_loss"] = llama.make_train_step(
            cfg, optim.sgd(one, 1e-2))(one, tokens)
        _flat_params(f"one_{name}_p", one, out)

    # Where the step refuses: tp=4 splits the tiny config's 2 KV heads;
    # a sequence over sp=2 needs an attn_fn that reads it.
    for name, axes, attn in (("tp4", {"tp": 4}, None),
                             ("sp_dense", {"sp": 2}, None)):
        cfg = config(64, torch.float32)
        m = make_mesh(axes, device_type="cpu")
        params = llama.trainable(shard_params(
            tree("tp_params.", cfg), llama.param_specs(cfg), m))
        try:
            llama.make_train_step(cfg, optim.sgd(params, 1e-2), attn)(
                params, shard_batch(tokens, PartitionSpec("dp", "sp"), m))
            out[f"{name}_raises"] = np.array("")
        except ValueError as e:
            out[f"{name}_raises"] = np.array(str(e))

    # The dryrun's composition: dp=2 x tp=2 x sp=2, ring attention over
    # 'sp' with the heads over 'tp', AdamW 1e-3, f32 compute.
    mesh = make_mesh({"tp": 2, "sp": 2}, device_type="cpu")
    cfg = config(256, torch.float32)

    def ring(q, k, v):
        return ring_attention(q, k, v, mesh=mesh, axis="sp", causal=True,
                              head_axis="tp")

    for name in ("zeros", "random"):
        params = llama.trainable(shard_params(
            tree("dry_params.", cfg), llama.param_specs(cfg), mesh))
        step = llama.make_train_step(cfg, optim.adamw(params, 1e-3), ring)
        batch = shard_batch(torch.from_numpy(inputs[f"dry_{name}"]),
                            PartitionSpec("dp", "sp"), mesh)
        out[f"dry_{name}_loss"] = step(params, batch)
        _flat_params(f"dry_{name}_p", params, out)

    # Checkpoints of tp-sharded params on every rank (the twin of
    # tests/test_ps_ckpt.py:55), restored into a tp-sharded template.
    mesh = make_mesh({"tp": 2}, device_type="cpu")
    cfg = config(64, torch.float32)
    params = shard_params(tree("tp_params.", cfg), llama.param_specs(cfg),
                          mesh)
    ckpt = str(inputs["ckpt_dir"])
    checkpoint.save_checkpoint(ckpt, 7, {"params": params, "step": 7})
    out["ckpt_latest_7"] = np.array(checkpoint.latest_step(ckpt))
    template = shard_params(llama.init_params(
        cfg, generator=torch.Generator().manual_seed(5), device="cpu"),
        llama.param_specs(cfg), mesh)
    state = checkpoint.restore_checkpoint(
        ckpt, template={"params": template, "step": 0})
    out["ckpt_step"] = np.array(state["step"])
    out["ckpt_bit_equal"] = np.array(all(
        torch.equal(a.to_local().view(torch.int32),
                    b.to_local().view(torch.int32))
        for a, b in zip(tree_leaves(params), tree_leaves(state["params"]))))
    checkpoint.save_checkpoint(ckpt, 9, {"params": params, "step": 9})
    out["ckpt_latest_9"] = np.array(checkpoint.latest_step(ckpt))
    # Many ranks saving one step after another, the same step again and
    # pruning meanwhile: each rank's shards of each step must be found.
    for step in (10, 11, 11, 12, 13):
        scaled = {k: v for k, v in params.items()}
        scaled["final_norm"] = params["final_norm"] * step
        checkpoint.save_checkpoint(ckpt, step, {"params": scaled,
                                                "step": step},
                                   max_to_keep=2)
        state = checkpoint.restore_checkpoint(
            ckpt, template={"params": template, "step": 0})
        if state["step"] != step or not torch.equal(
                state["params"]["final_norm"].to_local(),
                scaled["final_norm"].to_local()):
            raise AssertionError(f"step {step} restored as {state['step']}")
    out["ckpt_dirs"] = np.array(sorted(os.listdir(ckpt)))
    return out


def _ring(rank: int, inputs: dict) -> dict:
    import torch
    import torch.distributed as dist

    from brpc_tpu_torch.parallel import (make_mesh, ring_attention,
                                         ulysses_attention)
    from brpc_tpu_torch.parallel.mesh import axis_group

    out = {}

    def qkv(name):
        return [torch.from_numpy(inputs[f"{name}_{x}"]) for x in "qkv"]

    cases = (("ring8", {"sp": 8}, ring_attention, {}),
             ("ring1", {"sp": 1}, ring_attention, {}),
             ("ring_tp", {"tp": 2, "sp": 4}, ring_attention,
              {"head_axis": "tp"}),
             ("ulysses2", {"sp": 2}, ulysses_attention, {}))
    for name, axes, fn, kw in cases:
        mesh = make_mesh(axes, device_type="cpu")
        for causal in (True, False):
            got = fn(*qkv("dense"), mesh=mesh, axis="sp", causal=causal,
                     **kw)
            out[f"{name}_{causal}"] = got.full_tensor()
            out[f"{name}_{causal}_local"] = got.to_local()
    try:
        ulysses_attention(*qkv("dense"), mesh=make_mesh(
            {"sp": 8}, device_type="cpu"), axis="sp")
        out["ulysses8_raises"] = np.array("")
    except ValueError as e:
        out["ulysses8_raises"] = np.array(str(e))

    # The gradient of sum(ring(q, k, v)**2) over sp=4: each rank's loss is
    # its own block's sum; the ranks' gradients of the whole q/k/v add up.
    mesh = make_mesh({"sp": 4}, device_type="cpu")
    q, k, v = (x.requires_grad_(True) for x in qkv("grad"))
    out_ = ring_attention(q, k, v, mesh=mesh, axis="sp")
    (out_.to_local() ** 2).sum().backward()
    for name, x in zip("qkv", (q, k, v)):
        grad = x.grad.clone()
        dist.all_reduce(grad, group=axis_group(mesh, "sp"))
        out[f"grad_{name}"] = grad
    return out


def _moe(rank: int, inputs: dict) -> dict:
    import torch

    from brpc_tpu_torch.models import moe
    from brpc_tpu_torch.parallel import make_mesh, shard_params

    out = {}
    cfg = moe.MoeConfig(hidden=32, intermediate=64, n_experts=4,
                        dtype=torch.float32)
    mesh = make_mesh({"ep": 4}, device_type="cpu")
    params = {k: torch.from_numpy(inputs[f"params_{k}"])
              for k in ("gate", "w_in", "w_out")}
    sharded = {k: v.requires_grad_(True) for k, v in shard_params(
        params, moe.moe_param_specs(), mesh).items()}
    out["w_in_local_shape"] = np.array(sharded["w_in"].to_local().shape)
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    got, aux = moe.moe_layer(sharded, x, cfg)
    out["out"], out["aux"] = got, aux
    (torch.sum(got ** 2) + 0.01 * aux).backward()
    for k, p in sharded.items():
        out[f"grad_{k}"] = p.grad.full_tensor()
    out["grad_x"] = x.grad
    return out


def _pipeline(rank: int, inputs: dict) -> dict:
    import torch

    from brpc_tpu_torch.parallel import make_mesh, pipeline_apply

    out = {}
    w, x = torch.from_numpy(inputs["w"]), torch.from_numpy(inputs["x"])
    for pp in (1, 2, 4, 8):
        mesh = make_mesh({"pp": pp}, device_type="cpu")
        got = pipeline_apply(lambda p, m: torch.tanh(m @ p), w[:pp], x,
                             mesh=mesh, axis="pp", microbatches=8)
        out[f"pp{pp}"] = got.full_tensor()
        out[f"pp{pp}_local"] = got.to_local()
    return out


def _obs_counters(rank: int, inputs: dict) -> dict:
    """``tests/test_obs.py::test_collective_channel_counters`` on a rank:
    the collective counters after one all-reduce and one all-gather."""
    import torch

    from brpc_tpu_torch import obs
    from brpc_tpu_torch.parallel import CollectiveChannel, make_mesh

    def count(name):
        return torch.tensor(obs.counter(name).get_value())

    obs.reset_fabric_vars()
    mesh = make_mesh({"dp": 8}, device_type="cpu")
    chan = CollectiveChannel(mesh, "dp")
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    chan.all_reduce(x)
    out = {"all_reduce_calls": count("collective_all_reduce_calls"),
           "all_reduce_bytes": count("collective_all_reduce_bytes")}
    chan.all_gather(x)
    out["all_gather_calls"] = count("collective_all_gather_calls")
    return out


PROGRAMS = {"parallel": _parallel, "ps": _ps,
            "sharded_train": _sharded_train, "ring": _ring, "moe": _moe,
            "pipeline": _pipeline, "obs_counters": _obs_counters}


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
