"""Mixtral's layer equations in plain float32 PyTorch, one sequence at a
time.

As Mixtral-8x7B-v0.1 and its Hugging Face code (``MixtralSparseMoeBlock``)
define them: the attention half of the Llama layer (``reference.llama``:
RMSNorm, RoPE on halves, causal grouped-query attention, the output
product), then in place of the MLP a sparse expert block on the normed
rows y: router logits ``y @ w_router`` [E], their softmax, the two most
probable experts, their probabilities renormalised to sum to one, and
the output Σ wᵢ · ``down_i(silu(gate_i(y)) * up_i(y))`` over the chosen
experts; no shared expert and no capacity. A final RMSNorm and an untied
LM head. Weights are ``[in, out]``, experts stacked ``[E, in, out]``.

Departures, none in the equations: ties between probabilities go to the
lower expert index (a stable sort; ``torch.topk`` promises no order);
each expert runs on the rows routed to it, gathered, and its terms are
added back in expert order; attention is computed in blocks of queries,
as ``reference.llama`` does.

``logits_at`` runs many sequences layer by layer, so that one layer's
float32 weights are made and held at a time. Its keyword arguments plant
what the benchmark's controls need: ``precision="fp8"`` rounds every
product's operands (the router's too) to float8 e4m3; ``k`` other than
the model's routes to fewer experts; ``renormalise=False`` keeps the raw
probabilities; ``drop_second`` leaves out the second expert's term.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.nn import functional as F

from portbench.reference.llama import SCORE_BLOCK_BYTES, attention, \
    full_f32, mm, rms_norm, rope


def route(y: torch.Tensor, w_router: torch.Tensor, k: int,
          precision: str = "f32", renormalise: bool = True) -> tuple:
    """(weights [T, k], experts [T, k]) of the rows y [T, h]."""
    probs = torch.softmax(mm(y, w_router, precision), dim=-1)
    top, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, experts = top[:, :k], experts[:, :k]
    if renormalise:
        top = top / top.sum(dim=-1, keepdim=True)
    return top, experts


def experts_block(y: torch.Tensor, lw: dict, k: int, precision: str = "f32",
                  renormalise: bool = True,
                  drop_second: bool = False) -> tuple:
    """(the sparse block's output [T, h], the experts chosen [T, k])."""
    weights, experts = route(y, lw["w_router"], k, precision, renormalise)
    if drop_second:
        weights = weights[:, :1]
    out = torch.zeros_like(y)
    for e in range(lw["w_router"].shape[1]):
        rows, slot = torch.nonzero(experts[:, :weights.shape[1]] == e,
                                   as_tuple=True)
        if rows.numel() == 0:
            continue
        x = y[rows]
        h = F.silu(mm(x, lw["w_gate"][e], precision)) \
            * mm(x, lw["w_up"][e], precision)
        out.index_add_(0, rows, mm(h, lw["w_down"][e], precision)
                       * weights[rows, slot, None])
    return out, experts


def layer(x: torch.Tensor, lw: dict, m, k: int | None = None,
          precision: str = "f32", renormalise: bool = True,
          drop_second: bool = False) -> tuple:
    """One decoder layer over a whole sequence x [T, h]: (its output, the
    experts each row chose)."""
    t = x.shape[0]
    y = rms_norm(x, lw["attn_norm"], m.norm_eps)
    q = rope(mm(y, lw["wq"], precision).view(t, m.heads, m.head_dim),
             m.rope_theta)
    kk = rope(mm(y, lw["wk"], precision).view(t, m.kv_heads, m.head_dim),
              m.rope_theta)
    v = mm(y, lw["wv"], precision).view(t, m.kv_heads, m.head_dim)
    block = max(1, min(t, SCORE_BLOCK_BYTES // (4 * m.heads * t)))
    attn = torch.cat([attention(q[q0:q0 + block], kk[:q0 + block],
                                v[:q0 + block], q0)
                      for q0 in range(0, t, block)])
    del q, kk, v, y
    x = x + mm(attn, lw["wo"], precision)
    out, experts = experts_block(rms_norm(x, lw["mlp_norm"], m.norm_eps),
                                 lw, m.per_token if k is None else k,
                                 precision, renormalise, drop_second)
    return x + out, experts


def logits_at(m, top: dict, layer_weights: Callable[[int], dict],
              sequences: list, variants: tuple = ({},)) -> list:
    """For each variant (keyword arguments of ``layer``), the logits
    [len(positions), vocab] of each sequence ``(tokens [T], positions)``
    at its positions, and the experts each layer chose there [L,
    len(positions), k]: a list, a variant, of (logits, experts) lists.

    ``top`` holds the f32 ``embed``, ``final_norm`` and ``lm_head``;
    ``layer_weights(i)`` makes layer i's f32 weights, once: every sequence
    of every variant passes through a layer before the next is made."""
    with torch.no_grad(), full_f32():
        states = [[top["embed"][tokens] for tokens, _ in sequences]
                  for _ in variants]
        chosen = [[[] for _ in sequences] for _ in variants]
        for i in range(m.layers):
            lw = layer_weights(i)
            for v, kw in enumerate(variants):
                for s, (_, positions) in enumerate(sequences):
                    states[v][s], experts = layer(states[v][s], lw, m, **kw)
                    chosen[v][s].append(experts[positions])
            del lw
        out = []
        for v, kw in enumerate(variants):
            precision = kw.get("precision", "f32")
            logits = [mm(rms_norm(x[positions], top["final_norm"],
                                  m.norm_eps), top["lm_head"], precision)
                      for x, (_, positions) in zip(states[v], sequences)]
            out.append([(got, torch.stack(c)) for got, c
                        in zip(logits, chosen[v])])
        return out
