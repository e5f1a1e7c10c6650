"""Collectives with the gradients of the global function they compute.

The reference's sharded code is differentiated by JAX through the
collectives that GSPMD or ``shard_map`` insert. The port writes each
``shard_map`` body as per-rank code (``parallel/mesh.py``), so each
collective that such code runs under autograd is a
``torch.autograd.Function`` here, with the backward that makes the
per-rank gradients add up to the gradient of the global function:

- ``copy_to``: identity forward, all-reduce backward. Where a replicated
  activation enters rank-local products (the column-parallel weights of
  Megatron, the local experts of a MoE layer), each rank's gradient of it
  is partial and the ranks' parts add up.
- ``reduce_from``: all-reduce forward, identity backward. After products
  whose outputs are partial sums (the row-parallel weights); the result is
  replicated and every rank already holds its whole gradient.
  ``torch.distributed.nn.functional.all_reduce`` all-reduces in its
  backward too, which makes a replicated result's gradient ``n`` times too
  large.
- ``gather_from``: all-gather of the last dimension forward, this rank's
  slice backward, for a result that every rank then uses whole and alike
  (the vocabulary-sharded logits).
- ``shift``: a ring shift by ``offset`` forward, the shift back backward.
- ``all_to_all``: ``all_to_all_single`` on dim 0 both ways (it is its own
  adjoint).
- ``row_parallel``: ``a @ w`` with the inner dimension sharded, the
  partial products summed over the group in f32 and rounded once, as the
  unsharded product rounds once; the backward is the unsharded product's.

Each is the identity on a group of one rank, and ``group=None`` means a
mesh axis of size one: nothing is sent, so a rank never sends to itself.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _contiguous_copy(x: torch.Tensor) -> torch.Tensor:
    return x.clone(memory_format=torch.contiguous_format)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = _contiguous_copy(grad)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = _contiguous_copy(x)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.rank, ctx.width = dist.get_rank(group), x.shape[-1]
        x = x.contiguous()
        flat = x.new_empty((n * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(flat, x, group=group)
        stacked = flat.reshape(n, *x.shape)
        return stacked.movedim(0, -2).reshape(*x.shape[:-1], n * x.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.width
        return grad[..., lo:lo + ctx.width].contiguous(), None


def _ring_shift(group, offset, tensors):
    """Each tensor of this rank goes to the rank ``offset`` further along
    the group's ring; the tensors of the rank ``offset`` before arrive."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    to = dist.get_global_rank(group, (me + offset) % n)
    frm = dist.get_global_rank(group, (me - offset) % n)
    sends = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in sends]
    ops = []
    for s, o in zip(sends, outs):
        ops.append(dist.P2POp(dist.isend, s, to, group))
        ops.append(dist.P2POp(dist.irecv, o, frm, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(outs)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, offset, *tensors):
        ctx.group, ctx.offset = group, offset
        return _ring_shift(group, offset, tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_ring_shift(ctx.group, -ctx.offset, grads))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def _all_to_all(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _RowParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w, group):
        ctx.save_for_backward(a, w)
        out = _f32_product(a, w)
        dist.all_reduce(out, group=group)
        return out.to(a.dtype)

    @staticmethod
    def backward(ctx, grad):
        # The output is replicated, so every rank holds its whole gradient
        # and each weight shard's is local, in a's dtype.
        a, w = ctx.saved_tensors
        da = grad @ w.mT if ctx.needs_input_grad[0] else None
        dw = a.reshape(-1, a.shape[-1]).mT @ grad.reshape(-1, grad.shape[-1]) \
            if ctx.needs_input_grad[1] else None
        return da, dw, None


def _f32_product(a, w):
    """``a @ w`` in f32: exact products, f32 sums. bf16 and f16 values are
    exact in TF32, so on the card their product runs on TF32 tensor cores
    with nothing lost (half bf16's rate) instead of f32's CUDA cores."""
    if not a.is_cuda or a.dtype not in (torch.bfloat16, torch.float16) \
            or w.dtype != a.dtype:
        return a.float() @ w.float()
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        return a.float() @ w.float()
    finally:
        torch.set_float32_matmul_precision(before)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def row_parallel(a: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """``a @ w`` where each rank holds a block of the inner dimension (the
    row-parallel weights of Megatron), summed over ``group``: the partial
    products in f32, rounded once to ``a``'s dtype after the sum. Partials
    rounded first would round twice."""
    return a @ w if group_size(group) == 1 else \
        _RowParallel.apply(a, w, group)


def gather_from(x: torch.Tensor, group) -> torch.Tensor:
    """``[..., w]`` on each rank -> ``[..., n·w]``, rank r's block at
    columns ``r·w``."""
    return x if group_size(group) == 1 else _GatherFrom.apply(x, group)


def shift(group, offset: int, *tensors: torch.Tensor) -> tuple:
    """Ring shift of every tensor by ``offset`` ranks along ``group``, as
    ``CollectiveChannel.shift``: rank i's tensors arrive at rank
    ``(i + offset) mod n``."""
    n = group_size(group)
    if offset % n == 0:
        return tensors
    return _Shift.apply(group, offset, *tensors)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x[j]`` (dim 0 cut in ``n`` equal blocks) goes to rank j; block i
    of the result came from rank i."""
    return x if group_size(group) == 1 else _AllToAll.apply(x, group)
