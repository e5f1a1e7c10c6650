"""Ring attention and Ulysses: sequence parallelism over a mesh axis, the
port of ``brpc_tpu/parallel/ring.py``.

The sequence is sharded over a mesh axis ('sp'). Ring attention keeps Q
resident and rotates the K/V blocks around the axis's ring (a
``batch_isend_irecv`` shift on the axis's process group, as
``CollectiveChannel.shift``), merging each block's attention with an
online softmax. Step s on rank d holds K/V block (d - s) mod n; a Q block
attends to a K/V block iff the K/V block comes no later, the diagonal
block under the triangular mask. Ulysses swaps the sharded dimension from
the sequence to the heads with ``all_to_all_single``, attends over the
whole sequence on a subset of heads, and swaps back.

Both keep the reference's numerics: masks of -1e30 (not -inf) with the
guard for fully masked rows, scores in f32, the probabilities cast to v's
dtype before the PV product. Both are differentiable: the rotation's
backward shifts the gradients the other way, and an all-to-all's is the
same all-to-all (``parallel/functional.py``).

The public functions take global q/k/v (a ``DTensor`` in any layout, or a
plain tensor that holds the whole value on every rank) and return a
``DTensor`` laid out as the reference's ``out_specs``. Each is built on a
per-rank function (``ring_attention_local``, ``ulysses_attention_local``)
that takes this rank's blocks and the axis's process group.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from brpc_tpu_torch.parallel import functional as F
from brpc_tpu_torch.parallel.mesh import PartitionSpec as P, axis_group, \
    axis_index, axis_size, from_block, local_block

_NEG = -1e30


def _block_attend(q, k, v, mask):
    """One block pair: (unnormalized out, row max, row sumexp).

    q: [B,Tq,Hkv,G,D]  k/v: [B,Tk,Hkv,D]  mask: [Tq,Tk] additive f32.
    Returns o [B,Tq,Hkv,G,D] f32 and m, l [B,Hkv,G,Tq].
    """
    d = q.shape[-1]
    scores = torch.einsum("bthgd,bshd->bhgts", q, k).float()
    scores = scores * d ** -0.5 + mask
    m = torch.amax(scores, dim=-1)
    # guard fully-masked rows (exp(-inf - -inf))
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m_safe[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhgts,bshd->bthgd", p.to(v.dtype), v)
    return o.float(), m_safe, l


def _merge(o1, m1, l1, o2, m2, l2):
    """Online-softmax merge of two partial attention states."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)

    def scale(o, a):  # a [B,H,G,T] -> o's layout [B,T,H,G,1]
        return o * a.permute(0, 3, 1, 2)[..., None]
    return scale(o1, a1) + scale(o2, a2), m, l1 * a1 + l2 * a2


def _normalize(o, l, dtype):
    denom = l.permute(0, 3, 1, 2)[..., None]
    return (o / torch.clamp(denom, min=1e-20)).to(dtype)


def _triangle(t, device):
    keep = torch.ones((t, t), dtype=torch.bool, device=device).tril()
    return torch.where(keep, 0.0, _NEG).float()


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group, index: int, causal: bool = True
                         ) -> torch.Tensor:
    """This rank's blocks: q [B, T/n, Hq, D], k/v [B, T/n, Hkv, D] (any
    head shard, GQA groups whole) -> [B, T/n, Hq·D]. ``group`` is the
    sequence axis's process group (None for one rank), ``index`` this
    rank's position on it."""
    n = F.group_size(group)
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, t, hkv, hq // hkv, d)
    tri = _triangle(t, q.device)
    zeros = torch.zeros((t, t), dtype=torch.float32, device=q.device)
    full_neg = torch.full((t, t), _NEG, dtype=torch.float32, device=q.device)

    o = torch.zeros((b, t, hkv, hq // hkv, d), dtype=torch.float32,
                    device=q.device)
    m = torch.full((b, hkv, hq // hkv, t), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    kc, vc = k, v
    for s in range(n):
        kv_index = (index - s) % n
        if not causal:
            mask = zeros
        elif kv_index == index:
            mask = tri
        else:
            mask = zeros if kv_index < index else full_neg
        o, m, l = _merge(o, m, l, *_block_attend(qg, kc, vc, mask))
        if s < n - 1:  # the last block needs no further rotation
            kc, vc = F.shift(group, 1, kc, vc)
    return _normalize(o, l, q.dtype).reshape(b, t, hq * d)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh: DeviceMesh, axis: str = "sp", causal: bool = True,
                   head_axis: Optional[str] = None) -> torch.Tensor:
    """Sequence-sharded GQA attention.

    q: [B, T, Hq, D], k/v: [B, T, Hkv, D], global, T sharded over ``axis``
    (dim 1). ``head_axis`` optionally keeps the heads sharded (tensor
    parallelism composes: sp rotates KV while tp splits heads). Returns
    [B, T, Hq·D], a DTensor laid out as ``P(None, axis, head_axis)``.
    """
    spec = P(None, axis, head_axis)
    out = ring_attention_local(
        *(local_block(x, spec, mesh) for x in (q, k, v)),
        axis_group(mesh, axis), axis_index(mesh, axis), causal)
    b, t, hq, d = q.shape
    return from_block(out, spec, mesh, (b, t, hq * d))


def ulysses_attention_local(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, group, causal: bool = True
                            ) -> torch.Tensor:
    """This rank's sequence blocks with every head: q [B, T/n, Hq, D],
    k/v [B, T/n, Hkv, D] -> [B, T/n, Hq·D]."""
    n = F.group_size(group)

    def seq2head(x):  # [B, T/n, H, D] -> [B, T, H/n, D]
        b, t, h, d = x.shape
        blocks = x.reshape(b, t, n, h // n, d).permute(2, 0, 1, 3, 4)
        got = F.all_to_all(blocks, group)  # block i: rank i's positions
        return got.permute(1, 0, 2, 3, 4).reshape(b, n * t, h // n, d)

    def head2seq(x):  # [B, T, H/n, D] -> [B, T/n, H, D]
        b, t, h, d = x.shape
        blocks = x.reshape(b, n, t // n, h, d).permute(1, 0, 2, 3, 4)
        got = F.all_to_all(blocks, group)  # block i: rank i's heads
        return got.permute(1, 2, 0, 3, 4).reshape(b, t // n, n * h, d)

    qh, kh, vh = seq2head(q), seq2head(k), seq2head(v)
    b, t, hq_l, d = qh.shape
    hkv_l = kh.shape[2]
    qg = qh.reshape(b, t, hkv_l, hq_l // hkv_l, d)
    mask = _triangle(t, q.device) if causal else \
        torch.zeros((t, t), dtype=torch.float32, device=q.device)
    o, _, l = _block_attend(qg, kh, vh, mask)
    out = _normalize(o, l, q.dtype).reshape(b, t, hq_l, d)
    return head2seq(out).reshape(b, q.shape[1], q.shape[2] * d)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      mesh: DeviceMesh, axis: str = "sp",
                      causal: bool = True) -> torch.Tensor:
    """DeepSpeed-Ulysses-style sequence parallelism: an all-to-all swaps
    the sharded dim from sequence to heads, each rank attends over the
    whole sequence on its heads, and a second swaps back. Better than the
    ring when heads >> ranks and the sequence fits one card's memory.

    q/k/v global as ``ring_attention``'s; returns [B, T, Hq·D] laid out as
    ``P(None, axis)``. Raises ``ValueError`` where the axis size does not
    divide the KV heads.
    """
    n = axis_size(mesh, axis)
    hkv = k.shape[2]
    if hkv % n != 0:
        raise ValueError(f"kv heads {hkv} not divisible by axis size {n}")
    spec = P(None, axis)
    out = ulysses_attention_local(
        *(local_block(x, spec, mesh) for x in (q, k, v)),
        axis_group(mesh, axis), causal)
    b, t, hq, d = q.shape
    return from_block(out, spec, mesh, (b, t, hq * d))
