"""Decoder-only transformers in PyTorch: the port of
``brpc_tpu/models/llama.py``, its Llama-family block, and the expert and
latent-attention blocks of Mixtral and DeepSeek-V2 on the same path.

The layout and the numerics follow the reference so that the same weights
give the same logits:

- params are a nested dict; per-layer weights are stacked on a leading
  ``n_layers`` axis, stored ``[in, out]`` and applied as ``x @ w``;
- master weights stay in ``cfg.param_dtype`` (f32) and the decoder runs in
  ``cfg.dtype`` (bf16). The functional ``forward`` (training, the sharded
  path) casts each layer's weights inside the layer loop, the counterpart
  of the reference's ``lax.scan`` over a cast, so one layer's bf16 copy is
  live at a time. ``LlamaModel`` serves frozen weights, so it holds every
  weight but the embedding in ``cfg.dtype`` once and casts none per
  request: for a 7B model about 14.5 GB on the card in place of 29 GB;
- GQA attention with RoPE (halves, not interleaved pairs), a SwiGLU MLP,
  RMSNorm reduced in f32, an untied LM head and f32 logits;
- a config with experts (``n_experts`` > 0, Mixtral's layer) runs
  ``models.moe.expert_layer`` in place of the MLP: a router ``w_router``
  [h, E] and stacked experts ``w_gate``/``w_up`` [E, h, f] and ``w_down``
  [E, f, h] a layer, top-``experts_per_token`` and dropless. DeepSeek-V2's
  expert layer adds shared experts (``n_shared_experts``: ``shared_gate``,
  ``shared_up`` [h, n·f], ``shared_down``), keeps the top probabilities
  unrenormalised (``norm_topk_prob`` false) and follows
  ``first_dense_layers`` dense layers, whose MLP is stacked apart
  (``mlp_gate``, ``mlp_up``, ``mlp_down``); ``expert_intermediate`` is
  then an expert's width. Such a config is served and runs the functional
  ``forward``; it has no sharded layout (``param_specs`` raises), and
  training it is not supported;
- a config with ``kv_lora_rank`` > 0 runs DeepSeek-V2's multi-head latent
  attention (``models.mla``) in place of grouped-query attention: latent
  projections ``wq``, ``w_kva``, ``kv_norm``, ``w_kvb``, rope (YaRN's
  where ``rope_scaling`` is given) on ``qk_rope_head_dim`` of each query
  and key head, and ``attn_fn`` called with the scores' ``scale``, at q/k
  head dim ``qk_nope_head_dim + qk_rope_head_dim`` and v head dim
  ``v_head_dim``.

``attn_fn`` is pluggable as in the reference; pass
``brpc_tpu_torch.ops.flash_attention.flash_attention`` for the CUDA kernel
when serving. Unlike the reference's, that kernel also has a backward, so
``make_train_step`` with no ``attn_fn`` trains through it
(``train_attention``) where the inputs are CUDA bf16 at a head dim and T
the kernels take, and with dense attention elsewhere (the CPU, f32, the
sharded step).

``LlamaModel`` replays its forward from a CUDA graph, one a prompt shape,
where the tokens are on CUDA, the config is dense (no experts) with
grouped-query attention and no weight requires grad; anywhere else (the
CPU, an expert or latent-attention config, weights being trained) it runs
``forward`` as it is. A replay copies the tokens
into the graph's input, replays the graph and casts the head's output
into fresh f32 logits, so the host enqueues three operations a request
instead of some two thousand; it gains only where prompt shapes (batch
and length) repeat exactly. A shape's first call runs ``forward``; the
shape is captured after it (``forward``'s body, which on the model's
weights casts nothing and opens no span) while the model holds fewer than
``GRAPHS`` graphs and its logits fit in ``GRAPH_MEMORY_SHARE`` of the
card's memory beside theirs. A graph is kept for the model's life, so a
model makes at most ``GRAPHS`` captures. A server whose first shapes fill
the graphs serves every later shape with ``forward``. No benchmark cell
sends such traffic; a cell of jittered prompt lengths (ROADMAP 3.8) is
the one that would bring back an eviction rule, if it shows a loss. The
graphs' pool, which they share, holds besides their logits the largest
captured shape's activations. The expert layer's and latent attention's
spans are why a config with either is not graphed: a replay would not
record them.

While the program is traced (``obs.rpcz.trace``: a ``torch.profiler``
session runs), ``forward`` records the span ``llama.forward``, and
``make_train_step``'s step records ``train.forward``, ``train.backward``
and ``train.optimizer``; ``train.forward`` counts ``k1``
(``K1_TRAIN_COUNTER``) a layer whose attention ran K1. Each marks its
interval on the device. A ``LlamaModel`` call that replays a graph
records ``llama.forward`` around the copy of the tokens, the replay and
the cast of the logits, and counts ``graph`` (``GRAPH_COUNTER``) on it.

The same body runs one rank's share of a model sharded over a (dp, tp,
sp) mesh (``forward``'s ``ranks``): its collectives are the identity
where the group has one rank.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.nn import functional as F

from brpc_tpu_torch.analysis.race import checked_lock
from brpc_tpu_torch.models import mla, moe
from brpc_tpu_torch.models.norm import rms_norm
from brpc_tpu_torch.obs import rpcz
from brpc_tpu_torch.ops import flash_attention as fa
from brpc_tpu_torch.parallel import functional as pf
from brpc_tpu_torch.parallel.mesh import PartitionSpec as P, Ranks
from brpc_tpu_torch.utils.tree import tree_map

Params = Dict[str, object]
AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

#: The counter of a ``llama.forward`` span whose call replayed a graph.
GRAPH_COUNTER = "graph"
#: The counter of a ``train.forward`` span: the layers whose attention ran
#: K1's forward and backward (``train_attention``).
K1_TRAIN_COUNTER = "k1"
#: The most graphs a ``LlamaModel`` captures in its life (as many as there
#: are lengths up to 4096 that K1 takes, multiples of 128) ...
GRAPHS = 32
#: ... and the share of the card's memory that their logits may fill.
GRAPH_MEMORY_SHARE = 1 / 16


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    intermediate: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16        # compute dtype
    param_dtype: torch.dtype = torch.float32   # master weights
    n_experts: int = 0            # 0: the dense MLP
    experts_per_token: int = 0
    # DeepSeek-V2's expert stack: dense layers first, then expert layers
    # of expert_intermediate (0: intermediate) with shared experts.
    first_dense_layers: int = 0
    expert_intermediate: int = 0
    n_shared_experts: int = 0
    norm_topk_prob: bool = True
    # Multi-head latent attention where kv_lora_rank > 0 (models.mla).
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    rope_scaling: Optional[mla.Yarn] = None

    def __post_init__(self):
        if self.n_experts and not 0 < self.experts_per_token \
                <= self.n_experts:
            raise ValueError(f"experts_per_token {self.experts_per_token} "
                             f"with {self.n_experts} experts")
        if (self.first_dense_layers or self.n_shared_experts) and not \
                (self.n_experts and self.first_dense_layers < self.n_layers):
            raise ValueError("dense layers first and shared experts need "
                             "experts and an expert layer")
        mla_dims = (self.qk_nope_head_dim, self.qk_rope_head_dim,
                    self.v_head_dim)
        if self.kv_lora_rank and (min(mla_dims) <= 0
                                  or self.qk_rope_head_dim % 2):
            raise ValueError(f"latent attention needs positive head dims "
                             f"and an even rope dim; got {mla_dims}")
        if self.rope_scaling is not None and not self.kv_lora_rank:
            raise ValueError("rope_scaling is read by latent attention only")

    @staticmethod
    def tiny(vocab_size: int = 512) -> "LlamaConfig":
        """A toy config for tests, the reference's ``tiny``."""
        return LlamaConfig(
            vocab_size=vocab_size,
            hidden=128,
            n_layers=2,
            n_heads=4,
            n_kv_heads=2,
            head_dim=32,
            intermediate=256,
        )

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()  # defaults are Llama-3-8B


#: The leaves of the dense layers of an expert stack with
#: ``first_dense_layers``, stacked over those layers, by the MLP's names
#: they are served under ...
DENSE_LEAVES = {"mlp_gate": "w_gate", "mlp_up": "w_up", "mlp_down": "w_down"}
#: ... and the leaves of an expert config's expert layers, stacked over the
#: layers that follow them.
EXPERT_LEAVES = ("w_router", "w_gate", "w_up", "w_down", "shared_gate",
                 "shared_up", "shared_down")


def param_shapes(cfg: LlamaConfig) -> Params:
    """The shape of every parameter, in the layout of ``init_params``."""
    h, L, f, e = cfg.hidden, cfg.n_layers, cfg.intermediate, cfg.n_experts
    if cfg.kv_lora_rank:
        attn = {name: (L, *shape)
                for name, shape in mla.layer_shapes(cfg).items()}
    else:
        q_out = cfg.n_heads * cfg.head_dim
        kv_out = cfg.n_kv_heads * cfg.head_dim
        attn = {"wq": (L, h, q_out), "wk": (L, h, kv_out),
                "wv": (L, h, kv_out), "wo": (L, q_out, h)}
    if e:
        d, fe = cfg.first_dense_layers, cfg.expert_intermediate or f
        le, fs = L - d, cfg.n_shared_experts * fe
        ffn = {"w_router": (le, h, e), "w_gate": (le, e, h, fe),
               "w_up": (le, e, h, fe), "w_down": (le, e, fe, h)}
        if fs:
            ffn.update(shared_gate=(le, h, fs), shared_up=(le, h, fs),
                       shared_down=(le, fs, h))
        if d:
            ffn.update(mlp_gate=(d, h, f), mlp_up=(d, h, f),
                       mlp_down=(d, f, h))
    else:
        ffn = {"w_gate": (L, h, f), "w_up": (L, h, f), "w_down": (L, f, h)}
    return {
        "embed": (cfg.vocab_size, h),
        "layers": {
            **attn,
            **ffn,
            "attn_norm": (L, h),
            "mlp_norm": (L, h),
        },
        "final_norm": (h,),
        "lm_head": (h, cfg.vocab_size),
    }


def init_params(cfg: LlamaConfig, *, generator: torch.Generator,
                device: str | torch.device = "cuda") -> Params:
    """Weights drawn as normal * fan_in**-0.5 in f32, norms one.

    ``generator`` must live on ``device``; the same seed gives the same
    params (but not the numbers of ``jax.random``).
    """
    shapes = param_shapes(cfg)

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(fan_in ** -0.5).to(cfg.param_dtype)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=cfg.param_dtype)

    layers = {}
    for name, shape in shapes["layers"].items():
        # stacked [L, (E,) in, out] weights have fan_in = in; norms [L, h]
        layers[name] = ones(shape) if name.endswith("norm") \
            else dense(shape, shape[-2])
    return {
        "embed": dense(shapes["embed"], 1.0),
        "layers": layers,
        "final_norm": ones(shapes["final_norm"]),
        "lm_head": dense(shapes["lm_head"], cfg.hidden),
    }


def param_specs(cfg: LlamaConfig) -> Params:
    """PartitionSpecs for each param over mesh axes ('dp', 'tp'), the
    reference's Megatron layout: the attention's and the MLP's first
    products column-sharded over 'tp', their second products row-sharded,
    the embedding and the LM head sharded by vocabulary. ``make_train_step``
    runs per-rank tensor-parallel code on params laid out by them. A config
    with experts or latent attention has no such layout: ``ValueError``."""
    if cfg.n_experts or cfg.kv_lora_rank:
        raise ValueError("no sharded layout for a config with experts or "
                         "latent attention")
    column, row, whole = P(None, None, "tp"), P(None, "tp", None), \
        P(None, None)
    layers = {"wq": column, "wk": column, "wv": column, "wo": row,
              "w_gate": column, "w_up": column, "w_down": row,
              "attn_norm": whole, "mlp_norm": whole}
    return {"embed": P("tp", None), "layers": layers,
            "final_norm": P(None), "lm_head": P(None, "tp")}


def batch_specs() -> P:
    """Token batches are sharded over the data-parallel axis."""
    return P("dp", None)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embeddings on halves of the head dim. x: [B,T,H,D],
    positions: [B,T]; the rotation runs in f32."""
    d_half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, d_half, dtype=torch.float32,
                                    device=x.device) / d_half)
    angles = positions[..., None].float() * freqs         # [B,T,Dh]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              scale: float | None = None) -> torch.Tensor:
    """Dense grouped-query attention. q: [B,T,Hq,D], k: [B,T,Hkv,D], v:
    [B,T,Hkv,Dv] -> [B,T,Hq*Dv]. The scores are computed in q's dtype and
    then cast to f32, scaled after the product (by ``scale``; None:
    D**-0.5), masked with -inf; the probabilities are cast to v's dtype
    before the PV product."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    q = q.reshape(b, t, hkv, hq // hkv, d)
    scores = torch.einsum("bthgd,bshd->bhgts", q, k).float()
    scores = scores * (d ** -0.5 if scale is None else scale)
    if causal:
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, -torch.inf)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v)
    return out.reshape(b, t, hq * v.shape[-1])


def train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, span=None,
                    scale: float | None = None) -> torch.Tensor:
    """The unsharded train step's attention where it is given no
    ``attn_fn``: K1's forward and backward (``flash_attention``) where its
    kernels train on q (``flash_attention.trains``: CUDA bf16 at a head dim
    and T they take) and no ``scale`` is given, so no T x T scores are
    made, counting ``K1_TRAIN_COUNTER`` on ``span`` (a traced
    ``train.forward``; None counts nothing); dense ``attention``
    elsewhere, the CPU among them."""
    if fa.trains(q) and scale is None:
        if span is not None:
            span.count(K1_TRAIN_COUNTER, 1)
        return fa.flash_attention(q, k, v, causal=causal)
    return attention(q, k, v, causal=causal, scale=scale)


def _layers(cfg: LlamaConfig, x: torch.Tensor, positions: torch.Tensor,
            weights, attn_fn: Optional[AttnFn], tp, feed_forward: Callable,
            latent: Callable) -> torch.Tensor:
    """The decoder layers in turn: ``weights`` gives each layer's weights
    in ``cfg.dtype``, ``feed_forward(cfg, y, lp, tp)`` its feed-forward
    (``_feed_forward``) and, for latent attention, ``latent(cfg, y, lp,
    positions, attend)`` its attention (``mla.attention``). They are
    arguments so that the body a CUDA graph captures, which only a config
    without either runs, reaches in the call graph no span of the expert
    layer or of latent attention, which no replay would record (the
    trace-purity lint finds the spans' locks otherwise). With a
    'tp' group (dense configs only), each ``lp`` holds this rank's
    Megatron shards: the heads and the MLP's intermediate columns it owns
    (column-parallel products after ``copy_to``), and the matching rows of
    ``wo`` and ``w_down`` (``row_parallel``)."""
    for lp in weights:
        x, y = _attention_half(cfg, x, lp, positions, attn_fn, tp, latent)
        x = x + feed_forward(cfg, y, lp, tp)
    return x


def _feed_forward(cfg: LlamaConfig, y: torch.Tensor, lp: Params,
                  tp) -> torch.Tensor:
    """A layer's feed-forward: ``moe.expert_layer`` for a layer with a
    router (with its shared experts where it has them), else the MLP."""
    if "w_router" in lp:
        shared = (lp["shared_gate"], lp["shared_up"], lp["shared_down"]) \
            if "shared_gate" in lp else None
        return moe.expert_layer(y, lp["w_router"], lp["w_gate"],
                                lp["w_up"], lp["w_down"],
                                cfg.experts_per_token, shared=shared,
                                normalise=cfg.norm_topk_prob)
    return _mlp(cfg, y, lp, tp)


def _attention_half(cfg: LlamaConfig, x: torch.Tensor, lp: Params,
                    positions: torch.Tensor, attn_fn: Optional[AttnFn],
                    tp, latent: Callable) -> tuple:
    """A layer up to its feed-forward: the residual after attention, and
    its norm, the feed-forward's input."""
    b, t, _ = x.shape
    y = pf.copy_to(rms_norm(x, lp["attn_norm"], cfg.norm_eps), tp)
    attend = attn_fn if attn_fn is not None else attention
    if cfg.kv_lora_rank:
        o = latent(cfg, y, lp, positions, attend)
    else:
        q = (y @ lp["wq"]).reshape(b, t, -1, cfg.head_dim)
        k = (y @ lp["wk"]).reshape(b, t, -1, cfg.head_dim)
        v = (y @ lp["wv"]).reshape(b, t, -1, cfg.head_dim)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        o = attend(q, k, v)
    x = x + pf.row_parallel(o, lp["wo"], tp)
    return x, pf.copy_to(rms_norm(x, lp["mlp_norm"], cfg.norm_eps), tp)


def _mlp(cfg: LlamaConfig, y: torch.Tensor, lp: Params,
         tp) -> torch.Tensor:
    """The dense SwiGLU feed-forward."""
    return pf.row_parallel(F.silu(y @ lp["w_gate"]) * (y @ lp["w_up"]),
                           lp["w_down"], tp)


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            attn_fn: Optional[AttnFn] = None,
            ranks: Ranks = Ranks()) -> torch.Tensor:
    """tokens: [B, T] integer -> logits [B, T, vocab] float32.

    The embedding rows are gathered in the master dtype, then cast, so no
    compute-dtype copy of the whole table is made.

    ``ranks`` other than ``Ranks()`` make this one rank's share of the
    model sharded by ``param_specs`` (``parallel.tensor_parallel``):
    ``params`` are its local shards, ``tokens`` its block of the batch and
    of the sequence (its positions start at ``sp_index·T``), and the
    logits its rows, whole over the vocabulary.
    """
    with rpcz.trace("llama", "forward", mark=tokens):
        return _forward(params, tokens, cfg, attn_fn, ranks).float()


def _forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
             attn_fn: Optional[AttnFn], ranks: Ranks) -> torch.Tensor:
    """``forward`` up to the head's output in ``cfg.dtype``, gathered over
    'tp', with no span. Each layer's weights are cast inside the layer
    loop, so one layer's copy in ``cfg.dtype`` is live at a time, and the
    head's after the layers. On weights in ``cfg.dtype`` already (the
    embedding aside) and one rank, it casts no weight and calls no
    collective, so a CUDA graph can hold all of it."""
    x, positions = _inputs(params["embed"], tokens, cfg, ranks)
    # One unbind per stacked leaf: its backward stacks the layers' grads
    # once, where indexing w[i] would add a zero-filled gradient of the
    # whole stack for every layer.
    layers = {name: w.unbind(0) for name, w in params["layers"].items()}
    weights = ({name: _cast(w, cfg.dtype)
                for name, w in _layer_weights(cfg, layers, i).items()}
               for i in range(cfg.n_layers))
    x = _layers(cfg, x, positions, weights, attn_fn, ranks.tp, _feed_forward,
                mla.attention)
    head = _head(cfg, x, _cast(params["final_norm"], cfg.dtype),
                 _cast(params["lm_head"], cfg.dtype), ranks.tp)
    return pf.gather_from(head, ranks.tp)


def _layer_weights(cfg: LlamaConfig, layers: dict, i: int) -> dict:
    """Layer i's weights from the stacks ``layers`` (each unbound over its
    layers): a stack over every layer gives its i-th; with
    ``first_dense_layers`` d, the dense MLP's stacks give layers below d
    under the MLP's names and the expert leaves' stacks the layers from d
    on."""
    d = cfg.first_dense_layers
    out = {}
    for name, ws in layers.items():
        if name in DENSE_LEAVES:
            if i < d:
                out[DENSE_LEAVES[name]] = ws[i]
        elif cfg.n_experts and name in EXPERT_LEAVES:
            if i >= d:
                out[name] = ws[i - d]
        else:
            out[name] = ws[i]
    return out


def _cast(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w`` in ``dtype``. A weight in ``dtype`` already, as a served
    model's are, is returned without a call into ``to``: the 160 such
    calls of a Mixtral request took 0.15-0.37 ms of the host of an H100
    machine."""
    return w if w.dtype == dtype else w.to(dtype)


def _inputs(table: torch.Tensor, tokens: torch.Tensor, cfg: LlamaConfig,
            ranks: Ranks) -> tuple:
    """The tokens' embedding in ``cfg.dtype`` and their positions."""
    x = _embed(table, _clamped_ids(tokens, cfg.vocab_size),
               ranks).to(cfg.dtype)
    b, t = tokens.shape
    positions = (ranks.sp_index * t
                 + torch.arange(t, device=tokens.device)).expand(b, t)
    return x, positions


def _head(cfg: LlamaConfig, x: torch.Tensor, norm: torch.Tensor,
          head_w: torch.Tensor, tp) -> torch.Tensor:
    """The final norm and the LM head's product, in ``cfg.dtype``."""
    return pf.copy_to(rms_norm(x, norm, cfg.norm_eps), tp) @ head_w


def _embed(table: torch.Tensor, ids: torch.Tensor,
           ranks: Ranks) -> torch.Tensor:
    """``table[ids]``. A table sharded by vocabulary over 'tp' gives its
    owner's row and zeros on the other ranks, summed over 'tp'."""
    if ranks.tp is None:
        return table[ids]
    rows = table.shape[0]
    local = ids - ranks.tp_index * rows
    mine = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)].masked_fill(~mine[..., None], 0)
    return pf.reduce_from(x, ranks.tp)


def _clamped_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """jnp's rule for an index into ``n`` rows: a negative id counts from
    the end, then the id is clamped into ``[0, n)``. Out-of-vocabulary
    tokens read a real row, as the reference's, and never reach a
    device-side bounds check."""
    ids = ids.long()
    return torch.where(ids < 0, ids + n, ids).clamp_(0, n - 1)


def loss_fn(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            attn_fn: Optional[AttnFn] = None) -> torch.Tensor:
    """Next-token cross-entropy (last position predicts nothing).

    A target outside ``[-vocab, vocab)`` gives NaN, as the fill of the
    reference's ``jnp.take_along_axis`` does; a negative one in range
    counts from the end."""
    logits = forward(params, tokens, cfg, attn_fn)[:, :-1]
    return torch.mean(token_losses(logits, tokens[:, 1:]))


def token_losses(logits: torch.Tensor,
                 targets: torch.Tensor) -> torch.Tensor:
    """``logsumexp(logits) - logits[target]`` at each position, f32, with
    ``loss_fn``'s rule for targets out of range."""
    targets = targets.long()
    vocab = logits.shape[-1]
    targets = torch.where(targets < 0, targets + vocab, targets)
    inside = (targets >= 0) & (targets < vocab)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        targets.clamp(0, vocab - 1)[..., None]).squeeze(-1)
    gold = torch.where(inside, gold, torch.full_like(gold, math.nan))
    return logz - gold


def trainable(params: Params) -> Params:
    """The same tensors as fresh leaves that require grad (storage shared),
    for ``make_train_step`` and its optimizer."""
    return tree_map(lambda t: t.detach().requires_grad_(True), params)


def make_train_step(cfg: LlamaConfig, optimizer: torch.optim.Optimizer,
                    attn_fn: Optional[AttnFn] = None
                    ) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    """Returns ``step(params, tokens) -> loss``, the counterpart of the
    reference's ``make_train_step``.

    ``optimizer`` holds the leaves of ``params`` (``optim.adamw`` or
    ``optim.sgd`` over ``trainable(params)``). Where the reference returns
    new params and optimizer state, ``step`` updates both in place and
    returns the loss of the params it was given, a detached f32 scalar. The
    gradients are freed before it returns, so a step holds one gradient
    tree at its peak.

    As in the reference, the params' layout makes the step sharded: params
    laid out by ``param_specs`` as DTensors on a mesh with axes among
    ('dp', 'tp', 'sp') run ``parallel.tensor_parallel.loss_and_grads``,
    per-rank Megatron code over that mesh (tokens laid out by
    ``batch_specs``, or ``P('dp', 'sp')`` with sequence parallelism). It
    raises ``ValueError`` where 'tp' does not divide the KV heads, the
    vocabulary or the intermediate width.

    Unsharded and with no ``attn_fn``, each layer's attention is
    ``train_attention``: K1 on CUDA bf16 inputs it trains on, dense
    attention elsewhere. The sharded step keeps dense attention.
    """

    def step(params: Params, tokens: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        try:
            if isinstance(params["embed"], DTensor):
                # imported here: tensor_parallel imports this module
                from brpc_tpu_torch.parallel import tensor_parallel

                loss = tensor_parallel.loss_and_grads(params, tokens, cfg,
                                                      attn_fn)
            else:
                with rpcz.trace("train", "forward", mark=tokens) as sp:
                    loss = loss_fn(params, tokens, cfg,
                                   attn_fn if attn_fn is not None
                                   else functools.partial(train_attention,
                                                          span=sp))
                with rpcz.trace("train", "backward", mark=tokens):
                    loss.backward()
            with rpcz.trace("train", "optimizer", mark=tokens):
                optimizer.step()
        finally:
            optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    return step


@dataclasses.dataclass
class _Graph:
    """One prompt shape's captured forward: the tokens it reads and the
    logits in ``cfg.dtype`` it writes."""
    graph: "torch.cuda.CUDAGraph"
    tokens: torch.Tensor
    logits: torch.Tensor


class _Graphs:
    """A model's graphs by prompt shape, captured on ``weights`` (their
    ``data_ptr``s) into one memory pool and kept while the weights are:
    at most ``GRAPHS``, whose logits fill at most ``budget`` bytes."""

    def __init__(self, budget: int, weights: tuple):
        self.budget = budget
        self.weights = weights
        self.pool = None
        self.graphs: Dict[tuple, _Graph] = {}

    def held(self) -> int:
        """The bytes of the graphs' logits."""
        return sum(g.logits.nbytes for g in self.graphs.values())

    def admit(self, key: tuple, nbytes: int) -> bool:
        """Whether to capture ``key``'s shape, whose logits take
        ``nbytes``, after a call served without a graph: while fewer than
        ``GRAPHS`` are held and the logits fit in the budget beside
        theirs. No graph is evicted, so once the graphs are full every
        shape without one is served eagerly."""
        return key not in self.graphs and len(self.graphs) < GRAPHS \
            and self.held() + nbytes <= self.budget


class LlamaModel(nn.Module):
    """Holds the params of ``init_params`` and serves ``forward``.

    The weights are frozen ``nn.Parameter``s. The embedding's table is
    wrapped as it is, its rows gathered and then cast; every other weight
    is held in ``cfg.dtype``, cast once here (wrapped, not copied, where it
    is in ``cfg.dtype`` already), so a request casts no weight and gives
    the logits of ``forward`` on the params given.

    On CUDA a dense model replays a prompt shape's forward from a CUDA
    graph once the shape is captured, after its first call, while there
    is room; at most ``GRAPHS`` are captured in the model's life, so a
    server whose first shapes fill them serves later shapes eagerly (the
    module's docstring says which traffic that leaves out). Calls that
    share a model are enqueued one at a time; on one stream, as the
    default stream is, each reads its graph's logits before the next
    replay writes them. Weights moved or replaced (not loaded in place)
    drop the graphs.
    """

    def __init__(self, cfg: LlamaConfig, params: Params,
                 attn_fn: Optional[AttnFn] = None):
        super().__init__()
        self.cfg = cfg
        self.attn_fn = attn_fn

        def frozen(t):
            return nn.Parameter(t.to(cfg.dtype), requires_grad=False)

        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.layers = nn.ParameterDict(
            {name: frozen(w) for name, w in params["layers"].items()})
        self.final_norm = frozen(params["final_norm"])
        self.lm_head = frozen(params["lm_head"])
        self._graphs: Optional[_Graphs] = None
        self._enqueue = checked_lock("models.llama_graphs")

    def params(self) -> Params:
        return {"embed": self.embed, "layers": dict(self.layers),
                "final_norm": self.final_norm, "lm_head": self.lm_head}

    def _replays(self, device: torch.device) -> bool:
        """Whether a call on ``device`` takes the graph path: CUDA, a
        dense config without latent attention, and no weight that requires
        grad."""
        return device.type == "cuda" \
            and not (self.cfg.n_experts or self.cfg.kv_lora_rank) \
            and not any(p.requires_grad for p in self.parameters())

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        if not self._replays(tokens.device):
            return forward(self.params(), tokens, self.cfg, self.attn_fn)
        key = (tuple(tokens.shape), tokens.dtype, tokens.device)
        weights = tuple(p.data_ptr() for p in self.parameters())
        with self._enqueue:
            if self._graphs is None or self._graphs.weights != weights:
                total = torch.cuda.get_device_properties(
                    tokens.device).total_memory
                self._graphs = _Graphs(int(total * GRAPH_MEMORY_SHARE),
                                       weights)
            graphs = self._graphs
            g = graphs.graphs.get(key)
        if g is None:
            logits = forward(self.params(), tokens, self.cfg, self.attn_fn)
            nbytes = tokens.numel() * self.cfg.vocab_size \
                * self.cfg.dtype.itemsize
            with self._enqueue:
                if graphs is self._graphs and graphs.admit(key, nbytes):
                    graphs.graphs[key] = self._capture(tokens, graphs)
            return logits
        with rpcz.trace("llama", "forward", mark=tokens) as sp:
            with self._enqueue:
                g.tokens.copy_(tokens)
                g.graph.replay()
                logits = g.logits.to(torch.float32, copy=True)
            if sp is not None:
                sp.count(GRAPH_COUNTER, 1)
        return logits

    def _capture(self, tokens: torch.Tensor, graphs: _Graphs) -> _Graph:
        """Captures ``_forward`` on one rank for ``tokens``' shape into
        ``graphs``' pool, on a copy of the tokens held outside it. K1 does
        not count the launches it makes while captured."""
        with torch.inference_mode(False):
            static = tokens.clone()
        if graphs.pool is None:
            graphs.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        params = self.params()
        # thread_local: another thread's CUDA calls do not break a capture
        with torch.cuda.graph(graph, pool=graphs.pool,
                              capture_error_mode="thread_local"):
            out = _forward(params, static, self.cfg, self.attn_fn, Ranks())
        return _Graph(graph, static, out)
