"""The Llama train step sharded over a (dp, tp, sp) mesh, written as
per-rank code: Megatron tensor parallelism over 'tp', data parallelism
over 'dp', sequence parallelism over 'sp'.

In the reference one ``make_train_step`` serves every mesh: the params'
``PartitionSpec``s (``param_specs``) and the batch's make XLA insert the
collectives. The port has no such compiler, so ``models.llama``'s step
hands params laid out by ``param_specs`` (DTensors) to ``loss_and_grads``,
which runs ``llama.forward`` on this rank's shards with the mesh's
``Ranks``. The model body is the one of the unsharded step; its
collectives (``parallel/functional.py``) are the identity on one rank:

- ``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up`` are column-parallel (each
  rank holds Hq/tp and Hkv/tp heads and I/tp of the MLP) and take their
  input through ``copy_to`` (identity, gradient all-reduced over 'tp');
  ``wo`` and ``w_down`` are row-parallel (``row_parallel``: partials
  summed over 'tp' in f32, identity gradient);
- the embedding is sharded by vocabulary: ids clamped globally by
  ``_clamped_ids``' rule, a masked local gather, an all-reduce over 'tp';
- the LM head is sharded by vocabulary and its logits are all-gathered
  over 'tp' (``gather_from``: each rank's gradient is its own columns'),
  so the loss is ``loss_fn``'s own arithmetic on the same f32 logits, NaN
  rule included. A vocabulary-parallel logsumexp would hold tp times fewer
  logits per rank, but its three reductions round otherwise than the
  reference's; the gathered logits are as large as one rank's unsharded
  step holds, and on a mesh whose 'tp' has one rank nothing is gathered.

This module adds what the global function needs around the body:

- the batch is sharded over 'dp' and the sequence over 'sp' (tokens laid
  out as ``P('dp', 'sp')``): RoPE takes global positions (``Ranks``'
  sp index), each sp rank gets the first token of the next rank's shard
  by a ring shift for its last target, every rank divides the sum of its
  token losses by the global count B·(T-1) (the last sp rank has
  T/sp - 1 targets), and the gradients are summed over 'dp' and 'sp'
  after the backward;
- ``attn_fn`` keeps the reference's contract: it receives global q/k/v
  (DTensors, batch over 'dp', sequence over 'sp', heads over 'tp') and
  returns the global output, for example ``ring_attention`` over 'sp' with
  ``head_axis='tp'``. Without one, each rank runs dense attention on its
  heads, which needs the whole sequence: 'sp' must then have one rank.

A mesh axis of size one (or absent) runs no collective. The optimizer
holds the DTensor leaves; AdamW and SGD are elementwise, so each rank
updates its shards and the whole equals the reference's global update.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from brpc_tpu_torch.models import llama
from brpc_tpu_torch.parallel import functional as pf
from brpc_tpu_torch.parallel.mesh import Ranks, _placements, from_block, \
    local_block
from brpc_tpu_torch.utils.tree import tree_leaves, tree_map


def check_sharding(cfg: llama.LlamaConfig, params) -> Ranks:
    """The ranks of the params' mesh, after checking that every leaf is a
    DTensor on that mesh laid out by ``param_specs`` and that 'tp' divides
    the KV heads, the vocabulary and the intermediate width (``ValueError``
    otherwise)."""
    mesh = params["embed"].device_mesh
    specs = llama.param_specs(cfg)
    for path, leaf, spec in _walk(params, specs, ""):
        if not isinstance(leaf, DTensor) or leaf.device_mesh != mesh:
            raise ValueError(f"{path}: want a DTensor on the mesh of "
                             f"'embed', got {type(leaf).__name__}")
        if list(leaf.placements) != _placements(spec, mesh, leaf.dim()):
            raise ValueError(f"{path}: laid out as {leaf.placements}, not "
                             f"by param_specs ({spec})")
    ranks = Ranks.of(mesh)
    for what in ("n_kv_heads", "vocab_size", "intermediate"):
        if getattr(cfg, what) % ranks.tp_size:
            raise ValueError(f"tp={ranks.tp_size} does not divide {what} "
                             f"{getattr(cfg, what)}")
    return ranks


def _walk(params, specs, path):
    if isinstance(specs, dict):
        for key in sorted(specs):
            yield from _walk(params[key], specs[key], f"{path}{key}.")
    else:
        yield path[:-1], params, specs


def _attention(attn_fn, r: Ranks):
    """``llama.forward``'s ``attn_fn`` on this rank's q/k/v [B/dp, T/sp,
    H/tp, D]: ``attn_fn`` on the global q/k/v, or None (dense attention
    on this rank's heads)."""
    if attn_fn is None:
        if r.sp_size > 1:
            raise ValueError("sp > 1 needs an attn_fn that reads a "
                             "sequence-sharded q/k/v, such as "
                             "ring_attention")
        return None
    spec = r.spec("dp", "sp", "tp")
    where = _placements(spec, r.mesh, 4)

    def attend(q, k, v):
        out = attn_fn(*(from_block(x, spec, r.mesh,
                                   _global_shape(x, where, r.mesh))
                        for x in (q, k, v)))
        return local_block(out, spec, r.mesh)

    return attend


def _global_shape(x, where, mesh):
    shape = list(x.shape)
    for i, p in enumerate(where):
        if p.is_shard():
            shape[p.dim] *= mesh.size(i)
    return torch.Size(shape)


def loss_and_grads(params, tokens: torch.Tensor, cfg: llama.LlamaConfig,
                   attn_fn=None) -> torch.Tensor:
    """One step's loss of the global batch, and every param's gradient in
    its ``.grad`` (a DTensor laid out as the param), summed over 'dp' and
    'sp'. ``params`` are DTensor leaves that require grad, laid out by
    ``param_specs``; ``tokens`` [B, T] global (a DTensor, or the whole
    batch on every rank), B divisible by dp and T by sp. Returns the loss,
    a detached f32 scalar, the same on every rank."""
    r = check_sharding(cfg, params)
    dp = pf.group_size(r.dp)
    b, t = tokens.shape
    if b % dp or t % r.sp_size:
        raise ValueError(f"tokens {tuple(tokens.shape)} do not split over "
                         f"dp={dp}, sp={r.sp_size}")
    tok = local_block(tokens, r.spec("dp", "sp"), r.mesh).to(
        r.mesh.device_type)
    local = tree_map(lambda p: p.to_local(), params)

    logits = llama.forward(local, tok, cfg, _attention(attn_fn, r), r)
    loss = _local_loss(logits, tok, r, b * (t - 1))
    loss.backward()
    with torch.no_grad():
        for p in tree_leaves(params):
            _sum_over(p.grad.to_local(), (r.dp, r.sp))
        total = loss.detach().clone()
        _sum_over(total, (r.dp, r.sp))
    return total


def _local_loss(logits, tok, r: Ranks, count: int) -> torch.Tensor:
    """The sum of this rank's token losses over the global target count.
    Each position predicts the next token; the last sp rank's last
    position predicts nothing."""
    (nxt,) = pf.shift(r.sp, -1, tok[:, :1])  # the next rank's first token
    if r.sp_index == r.sp_size - 1:
        logits, targets = logits[:, :-1], tok[:, 1:]
    else:
        targets = torch.cat([tok[:, 1:], nxt], dim=1)
    return llama.token_losses(logits, targets).sum() / count


def _sum_over(x: torch.Tensor, groups) -> None:
    """All-reduce ``x`` in place over each group in turn."""
    for group in groups:
        if group is None:
            continue
        buf = x if x.is_contiguous() else x.contiguous()
        dist.all_reduce(buf, group=group)
        if buf is not x:
            x.copy_(buf)
