"""Mixture-of-Experts layers with expert parallelism over an 'ep' mesh axis.

Two layers live here. ``moe_layer`` is the port of
``brpc_tpu/models/moe.py``, the Switch layer described below.
``expert_layer`` is the dropless top-k SwiGLU layer of Mixtral and of
DeepSeek-V2, which ``models.llama`` runs in place of the MLP for a config
with experts:

- the router's logits and softmax in f32 over all E experts, the k most
  probable experts of each token (ties to the lower index) and their
  probabilities renormalised to sum to one (Mixtral) or kept as they are
  (DeepSeek-V2's ``norm_topk_prob: false``; ``route``);
- no capacity: the T·k (token, expert) pairs are sorted by expert, the
  rows gathered in that order, and the per-expert offsets found on the
  device, so nothing is read back to the host inside a request;
- the held experts' ``down(silu(gate(x)) * up(x))`` as grouped products
  (``torch._grouped_mm``, one group an expert), then each pair's row
  scaled by its weight and added into its token's row in f32
  (``index_add_``), rounded once to x's dtype;
- where the layer has shared experts (DeepSeek-V2's), their SwiGLU, one
  product of their summed width, over every row, its output the f32 sum's
  starting value, so it too is rounded once.

A rank that holds experts ``held`` of the E computes only their part of
the result; over an 'ep' group, ``reduce_from`` completes the sum. While
the program is traced (``obs.rpcz.trace``), each call records three
marked spans: ``moe.route`` (routing, sort, gather and offsets; counters
``pairs`` and ``experts``), ``moe.experts`` (the grouped products and
SiLU·up, and the shared experts' products; counter ``shared``, the rows
the shared experts ran, 0 without them; its ``kernels`` counted where the
grouped products run on the card in bf16 and there are no shared experts,
so it launches only its start marker) and ``moe.combine``.

Expert parallelism is the PartitionChannel shape at the model tier:
tokens are requests routed to expert partitions. The Switch layer, as in
the reference:

- routing is dense top-1 gating with a fixed capacity per expert (static
  shapes: a one-hot dispatch tensor, no data-dependent gather or scatter),
  the Switch-Transformer recipe, with its load-balancing auxiliary loss;
- experts live sharded over 'ep' (``moe_param_specs``: each rank owns
  E/ep experts), the gate replicated.

Per rank (``moe_layer_local``): the routing, the capacity and the dispatch
tensor are computed whole on every rank from the whole batch; the dispatch
is cut to the rank's experts; each rank runs its experts on their buffers
and combines their outputs into a partial sum over tokens, which an
all-reduce over 'ep' completes (identity backward: the result is
replicated). The tokens enter the local experts through ``copy_to`` (an
all-reduce of their gradient), so the input's gradient is the global one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.nn import functional as F

from brpc_tpu_torch.obs import rpcz
from brpc_tpu_torch.parallel import functional as pf
from brpc_tpu_torch.parallel.mesh import PartitionSpec as P, axis_group, \
    axis_index, local_block

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    hidden: int = 128
    intermediate: int = 256
    n_experts: int = 4
    capacity_factor: float = 2.0
    dtype: torch.dtype = torch.bfloat16


def moe_param_shapes(cfg: MoeConfig) -> Dict[str, tuple]:
    h, f, e = cfg.hidden, cfg.intermediate, cfg.n_experts
    return {"gate": (h, e), "w_in": (e, h, f), "w_out": (e, f, h)}


def init_moe_params(cfg: MoeConfig, *, generator: torch.Generator,
                    device: str | torch.device = "cuda") -> Params:
    """f32 weights drawn as normal times fan_in**-0.5 (hidden for the gate
    and ``w_in``, intermediate for ``w_out``) from ``generator``, which
    must live on ``device``. The same seed gives the same params (but not
    the numbers of ``jax.random``)."""
    fan_in = {"gate": cfg.hidden, "w_in": cfg.hidden,
              "w_out": cfg.intermediate}
    return {name: torch.randn(shape, generator=generator, device=device,
                              dtype=torch.float32) * fan_in[name] ** -0.5
            for name, shape in moe_param_shapes(cfg).items()}


def moe_param_specs() -> Dict[str, P]:
    """Experts shard over 'ep' (leading dim); gate replicated."""
    return {"gate": P(None, None), "w_in": P("ep", None, None),
            "w_out": P("ep", None, None)}


def _routing(xf: torch.Tensor, gate_w: torch.Tensor, e: int, cap: int):
    """(probs, gate value of each token's expert, one-hot experts [N, E]
    int, dispatch [N, E, C] in x's dtype)."""
    logits = xf.float() @ gate_w
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)  # ties: the first index, as jnp
    gate = torch.gather(probs, 1, expert[:, None])[:, 0]
    onehot = F.one_hot(expert, e).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) * onehot  # 1-based queue position
    pos_in_expert = torch.sum(pos, dim=-1) - 1
    keep = pos_in_expert < cap
    # dropped tokens take slot ``cap``, which the slice cuts off
    slot = F.one_hot(torch.where(keep, pos_in_expert, cap).long(),
                     cap + 1).to(xf.dtype)[:, :cap]
    dispatch = onehot.to(xf.dtype)[:, :, None] * slot[:, None, :]
    return probs, gate, onehot, dispatch


def moe_layer_local(params: Params, x: torch.Tensor, cfg: MoeConfig,
                    group, index: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's share: ``params`` hold this rank's experts (``w_in``
    [E/ep, H, F], ``w_out`` [E/ep, F, H]) and the whole gate, ``x`` the
    whole batch [B, T, H]; ``group`` is the 'ep' axis's process group (None
    for one rank), ``index`` this rank's position on it. Returns the
    layer's whole output and aux loss, the same on every rank."""
    b, t, h = x.shape
    e = cfg.n_experts
    n = b * t
    cap = max(1, int(cfg.capacity_factor * n / e))
    xf = x.reshape(n, h)
    probs, gate, onehot, dispatch = _routing(xf, params["gate"], e, cap)

    e_local = params["w_in"].shape[0]
    mine = dispatch[:, index * e_local:(index + 1) * e_local]
    buffers = torch.einsum("nec,nh->ech", mine, pf.copy_to(xf, group))
    y = torch.einsum("ech,ehf->ecf", buffers.to(cfg.dtype),
                     params["w_in"].to(cfg.dtype))
    y = F.gelu(y, approximate="tanh")  # jax.nn.gelu's default form
    y = torch.einsum("ecf,efh->ech", y, params["w_out"].to(cfg.dtype))
    out = torch.einsum("nec,ech->nh", mine.float(), y.float())
    out = pf.reduce_from(out, group) * gate[:, None]

    # load-balancing auxiliary (Switch eq. 4)
    density = torch.mean(onehot.float(), dim=0)
    density_proxy = torch.mean(probs, dim=0)
    aux = torch.sum(density * density_proxy) * e
    return out.reshape(b, t, h).to(x.dtype), aux


def moe_layer(params: Params, x: torch.Tensor,
              cfg: MoeConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, H] -> ([B, T, H], aux_loss).

    Top-1 routing with capacity C = capacity_factor·B·T/E; tokens past an
    expert's capacity pass through as zeros (the caller's residual keeps
    them). aux is the load-balancing term (mean prob · mean assignment ·
    E). ``params`` are plain tensors (one rank, or the whole value on
    every rank) or DTensors laid out by ``moe_param_specs``; then the
    experts run where they live, over their mesh's 'ep' axis, and the
    results are plain tensors, the same on every rank.
    """
    w_in = params["w_in"]
    if not isinstance(w_in, DTensor):
        return moe_layer_local(params, x, cfg, None, 0)
    mesh = w_in.device_mesh
    group = axis_group(mesh, "ep")
    if cfg.n_experts % pf.group_size(group):
        raise ValueError(f"{cfg.n_experts} experts do not split over "
                         f"ep={pf.group_size(group)}")
    specs = moe_param_specs()
    local = {name: local_block(w, specs[name], mesh)
             for name, w in params.items()}
    x = local_block(x, P(), mesh)
    return moe_layer_local(local, x, cfg, group, axis_index(mesh, "ep"))


# Kernels one ``torch._grouped_mm`` launches on an H100 in bf16: its
# argument set-up and the grouped GEMM.
_GROUPED_MM_KERNELS = 2


def route(xf: torch.Tensor, w_router: torch.Tensor, k: int,
          normalise: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing of the rows xf [N, H] over the router's E experts:
    logits and softmax in f32, the k most probable experts in order of
    probability (a stable sort, so ties go to the lower index), and their
    probabilities over their sum or, with ``normalise`` false, as they
    are. Returns (weights [N, k] f32, experts [N, k] int64)."""
    probs = torch.softmax(xf.float() @ w_router.float(), dim=-1)
    top, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    top = top[:, :k]
    if normalise:
        top = top / top.sum(dim=-1, keepdim=True)
    return top, experts[:, :k]


def expert_layer(x: torch.Tensor, w_router: torch.Tensor,
                 w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, k: int, held: range | None = None,
                 group=None, shared: tuple | None = None,
                 normalise: bool = True) -> torch.Tensor:
    """x [B, T, H] -> [B, T, H]: the part of the dropless top-k SwiGLU
    layer that experts ``held`` (a range of the router's E; all of them
    by default) give, summed over ``group`` where one is given.

    ``w_router`` [H, E]; ``w_gate``, ``w_up`` [E_held, H, F] and
    ``w_down`` [E_held, F, H] hold the experts ``held``, in order. A
    token's pair with an expert held elsewhere adds nothing here.
    ``shared`` (gate [H, Fs], up [H, Fs], down [Fs, H]) is the shared
    experts' SwiGLU, added once for every row (over a group, give it to
    one rank). ``normalise`` is ``route``'s."""
    b, t, h = x.shape
    n, e = b * t, w_router.shape[1]
    held = range(e) if held is None else held
    mine = len(held)
    xf = x.reshape(n, h)
    with rpcz.trace("moe", "route", mark=x) as sp:
        weights, experts = route(xf, w_router, k, normalise)
        key = experts.reshape(-1) - held.start
        if mine < e:  # pairs of experts held elsewhere sort last
            key = torch.where((key >= 0) & (key < mine), key, mine)
        key, order = torch.sort(key, stable=True)
        rows = order // k
        offs = torch.searchsorted(
            key, torch.arange(1, mine + 1, device=x.device), out_int32=True)
        xs = xf[rows]
        if sp is not None:
            sp.count("pairs", n * k)
            sp.count("experts", mine)
    with rpcz.trace("moe", "experts", mark=x) as sp:
        gate = torch._grouped_mm(xs, w_gate, offs=offs)
        up = torch._grouped_mm(xs, w_up, offs=offs)
        ys = torch._grouped_mm(F.silu(gate) * up, w_down, offs=offs)
        if shared is not None:
            s_gate, s_up, s_down = shared
            common = (F.silu(xf @ s_gate) * (xf @ s_up)) @ s_down
        if sp is not None:
            sp.count("shared", 0 if shared is None else n)
            if shared is None and x.is_cuda and x.dtype == torch.bfloat16:
                sp.count("kernels", 3 * _GROUPED_MM_KERNELS + 2)
    with rpcz.trace("moe", "combine", mark=x):
        if mine < e:  # rows past the last offset are left unwritten
            ys = ys.masked_fill((key == mine)[:, None], 0)
        pair_weights = weights.reshape(-1)[order]
        out = torch.zeros((n, h), dtype=torch.float32, device=x.device) \
            if shared is None else common.float()
        out = out.index_add_(0, rows, ys * pair_weights[:, None])
        out = pf.reduce_from(out, group).to(x.dtype)
    return out.reshape(b, t, h)
