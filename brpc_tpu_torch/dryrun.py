"""The multi-rank dry run, the port of ``__graft_entry__.dryrun_multichip``.

``dryrun_multichip(n)`` trains the tiny Llama for one step on a (dp, tp,
sp) mesh of ``n`` ranks, with the reference's mesh rule (tp = 2 when n is
even, sp = 2 when 4 divides n, dp the rest), Megatron tensor parallelism
(``param_specs``), data-parallel batches and ring attention over 'sp' with
the heads kept sharded over 'tp'. It holds the loss and the first four
leaves of the updated params (keys sorted, the reference's tree order)
against the same step on one rank with dense attention and no sharding,
at the reference's gates. Then one SGD step of the MoE layer with its
experts sharded over 'ep', and the GPipe schedule over 'pp'.

It starts ``n`` ranks (``parallel.mesh.run_world``: processes that meet
through a ``FileStore`` in a temporary directory, all stopped, and the
unfinished named, when one fails or the world runs over
``WORLD_TIMEOUT_S``), or runs in the world it is given when this process
already belongs to one of ``n`` ranks.
``device_type="cuda"`` runs NCCL over ``n`` cards and raises when there
are fewer; ``"cpu"`` runs gloo. The CPU runs only when asked for: there is
no fallback from the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from brpc_tpu_torch import optim
from brpc_tpu_torch.models import llama, moe
from brpc_tpu_torch.parallel.mesh import PartitionSpec as P, make_mesh, \
    run_world, shard_batch, shard_params
from brpc_tpu_torch.parallel.pipeline import pipeline_apply
from brpc_tpu_torch.parallel.ring import ring_attention
from brpc_tpu_torch.utils.tree import tree_leaves, tree_map

# The reference's gates against one rank (``__graft_entry__.py:248-258``).
LOSS_RTOL = LOSS_ATOL = 2e-3
PARAM_RTOL = PARAM_ATOL = 5e-3
CHECKED_LEAVES = 4
# A started world's time limit: the spawn, every rank's imports and its
# communicators included (about 50 s on four H100s).
WORLD_TIMEOUT_S = 300.0


def dryrun_multichip(n_devices: int, *, device_type: str = "cuda") -> str:
    """Runs the dry run on ``n_devices`` ranks and returns (and prints, on
    rank 0) the reference's summary line; raises if a gate fails."""
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"a world of {dist.get_world_size()} ranks "
                             f"cannot run dryrun_multichip({n_devices})")
        return _dryrun_impl(n_devices, device_type)
    return run_world(_rank_main, n_devices, args=(n_devices,),
                     device_type=device_type, timeout_s=WORLD_TIMEOUT_S)[0]


def _rank_main(ctx, n: int) -> str:
    ctx.part("dryrun")
    return _dryrun_impl(n, ctx.device_type)


def _dryrun_impl(n: int, device_type: str) -> str:
    tp = 2 if n % 2 == 0 else 1
    sp = 2 if n % 4 == 0 else 1
    mesh = make_mesh({"tp": tp, "sp": sp}, device_type=device_type)
    cfg = llama.LlamaConfig.tiny(vocab_size=256)

    attn_fn = None
    if sp > 1:
        # sequence parallelism: KV blocks rotate the ring while tp keeps
        # the heads sharded
        def attn_fn(q, k, v):
            return ring_attention(q, k, v, mesh=mesh, axis="sp", causal=True,
                                  head_axis="tp" if tp > 1 else None)

    init = llama.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    dp = mesh.size(0)
    tokens = torch.zeros((max(2, dp), 32), dtype=torch.int32)
    params = llama.trainable(shard_params(init, llama.param_specs(cfg), mesh))
    step = llama.make_train_step(cfg, optim.adamw(params, 1e-3), attn_fn)
    loss = step(params, shard_batch(
        tokens, P("dp", "sp") if sp > 1 else llama.batch_specs(), mesh))

    # The same step on one rank, dense attention, nothing sharded: a wrong
    # but finite sharded loss, or gradients that only corrupt the params,
    # fail here.
    ref = llama.trainable(tree_map(
        lambda t: t.to(device_type, copy=True), init))
    ref_loss = llama.make_train_step(cfg, optim.adamw(ref, 1e-3))(
        ref, tokens.to(device_type))
    np.testing.assert_allclose(
        loss.item(), ref_loss.item(), rtol=LOSS_RTOL, atol=LOSS_ATOL,
        err_msg="sharded loss drifted from single-device reference")
    got, want = tree_leaves(params), tree_leaves(ref)
    assert len(got) == len(want)
    for g, w in list(zip(got, want))[:CHECKED_LEAVES]:
        np.testing.assert_allclose(
            g.detach().full_tensor().cpu().numpy(),
            w.detach().cpu().numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL,
            err_msg="sharded param update drifted from reference")

    # Expert parallelism: the MoE layer sharded over 'ep' (its own mesh).
    ep = 2 if n % 2 == 0 else 1
    moe_loss = None
    if ep > 1:
        ep_mesh = make_mesh({"ep": ep}, device_type=device_type)
        mcfg = moe.MoeConfig(hidden=64, intermediate=128, n_experts=ep * 2,
                             dtype=torch.float32)
        mparams = shard_params(
            moe.init_moe_params(mcfg, generator=torch.Generator()
                                .manual_seed(1), device="cpu"),
            moe.moe_param_specs(), ep_mesh)
        mparams = llama.trainable(mparams)
        mx = torch.ones((2, 16, 64), device=device_type)
        out, aux = moe.moe_layer(mparams, mx, mcfg)
        moe_loss = torch.mean(out ** 2) + 0.01 * aux
        grads = torch.autograd.grad(moe_loss, list(mparams.values()))
        with torch.no_grad():
            for p, g in zip(mparams.values(), grads):
                p.sub_(1e-2 * g)
        if not math.isfinite(moe_loss.item()):
            raise AssertionError(f"MoE loss {moe_loss.item()}")

    # Pipeline parallelism: the microbatched stage ring over 'pp'.
    pp = 2 if n % 2 == 0 else 1
    if pp > 1:
        pp_mesh = make_mesh({"pp": pp}, device_type=device_type)
        w = torch.ones((pp, 16, 16), device=device_type) * 0.1
        xs = torch.ones((8, 16), device=device_type)
        out = pipeline_apply(lambda p, m: torch.tanh(m @ p), w, xs,
                             mesh=pp_mesh, axis="pp", microbatches=4)
        want = xs
        for s in range(pp):
            want = torch.tanh(want @ w[s])
        np.testing.assert_allclose(out.full_tensor().cpu().numpy(),
                                   want.cpu().numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg="pipeline differs from the stages "
                                           "run in turn")

    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    line = f"dryrun_multichip({n}): mesh={shape} loss={loss.item():.4f}"
    if moe_loss is not None:
        line += f" moe_ep={ep}(loss={moe_loss.item():.4f})"
    if pp > 1:
        line += f"\n  pp={pp} pipeline step ok"
    if dist.get_rank() == 0:
        print(line, flush=True)
    return line

