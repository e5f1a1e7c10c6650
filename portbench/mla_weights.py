"""A DeepSeek-V2 model's weights (``mla_config.MlaShape``), made from
``--seed`` one leaf and layer at a time, so that neither the program's
set-up nor the reference ever holds every layer's float32 weights at once.

Each layer's leaf comes from its own generator, named by the leaf and the
layer (``weights.generator(device, seed, "weights", name, layer)``), in
one call; the embedding, the final norm and the LM head from generators
named by the leaf alone. Products are N(0, 1/fan_in) with fan_in the
``in`` axis (the embedding N(0, 1)), routed experts stacked ``[E, in,
out]``, the router ``[hidden, E]`` and the shared experts as one SwiGLU
of their summed width; norms 1 + 0.1·N(0, 1), as ``weights`` makes them.
Layers below ``dense_layers`` hold an MLP (``mlp_*``), the others a router
and experts; the port stacks each group over its own layers
(``shapes``).
"""

from __future__ import annotations

import torch

from portbench import weights
from portbench.mla_config import MlaShape

ATTENTION_LEAVES = ("wq", "w_kva", "kv_norm", "w_kvb", "wo", "attn_norm",
                    "mlp_norm")
DENSE_LEAVES = ("mlp_gate", "mlp_up", "mlp_down")
EXPERT_LEAVES = ("w_router", "w_gate", "w_up", "w_down", "shared_gate",
                 "shared_up", "shared_down")
TOP_LEAVES = ("embed", "final_norm", "lm_head")


def layer_shapes(m: MlaShape, layer: int) -> dict:
    """Layer ``layer``'s leaves' shapes."""
    h, heads, r = m.hidden, m.heads, m.kv_lora_rank
    out = {"wq": (h, heads * m.qk_head), "w_kva": (h, r + m.qk_rope),
           "kv_norm": (r,), "w_kvb": (r, heads * (m.qk_nope + m.v_head)),
           "wo": (heads * m.v_head, h), "attn_norm": (h,), "mlp_norm": (h,)}
    if layer < m.dense_layers:
        f = m.intermediate
        out.update(mlp_gate=(h, f), mlp_up=(h, f), mlp_down=(f, h))
    else:
        e, f, fs = m.experts, m.expert_intermediate, m.shared_intermediate
        out.update(w_router=(h, e), w_gate=(e, h, f), w_up=(e, h, f),
                   w_down=(e, f, h), shared_gate=(h, fs), shared_up=(h, fs),
                   shared_down=(fs, h))
    return out


def top_shapes(m: MlaShape) -> dict:
    return {"embed": (m.vocab, m.hidden), "final_norm": (m.hidden,),
            "lm_head": (m.hidden, m.vocab)}


def shapes(m: MlaShape) -> dict:
    """Every leaf's shape, nested and stacked as the port's
    ``param_shapes``: attention and norms over every layer, the dense MLP
    over the dense layers, the router and experts over the others."""
    dense = layer_shapes(m, 0) if m.dense_layers else {}
    expert = layer_shapes(m, m.dense_layers)
    layers = {name: (m.layers, *expert[name]) for name in ATTENTION_LEAVES}
    layers.update({name: (m.dense_layers, *dense[name])
                   for name in DENSE_LEAVES if name in dense})
    layers.update({name: (m.expert_layers, *expert[name])
                   for name in EXPERT_LEAVES})
    return {**top_shapes(m), "layers": layers}


def _made(shape: tuple, name: str, generator) -> torch.Tensor:
    w = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    if name.endswith("norm"):
        return w.mul_(weights.NORM_JITTER).add_(1.0)
    if name == "embed":
        return w
    return w.mul_(shape[-2] ** -0.5)


def layer_leaf(m: MlaShape, name: str, layer: int, seed: int,
               device) -> torch.Tensor:
    """Layer ``layer``'s f32 leaf ``name``, in one call."""
    return _made(layer_shapes(m, layer)[name], name, weights.generator(
        device, seed, "weights", name, layer))


def layer_weights(m: MlaShape, layer: int, seed: int, device) -> dict:
    """Every f32 leaf of one layer."""
    return {name: layer_leaf(m, name, layer, seed, device)
            for name in layer_shapes(m, layer)}


def top_weights(m: MlaShape, seed: int, device) -> dict:
    """The f32 embedding, final norm and LM head."""
    return {name: _made(shape, name, weights.generator(device, seed,
                                                       "weights", name))
            for name, shape in top_shapes(m).items()}


def served_weights(m: MlaShape, seed: int, device,
                   dtype: torch.dtype) -> dict:
    """Every leaf, nested as ``shapes``: each layer's leaves made in f32
    one at a time and cast into stacks preallocated in ``dtype``; the
    embedding, final norm and LM head in f32."""
    layers = {name: torch.empty(shape, dtype=dtype, device=device)
              for name, shape in shapes(m)["layers"].items()}
    for i in range(m.layers):
        for name in layer_shapes(m, i):
            j = i - m.dense_layers if name in EXPERT_LEAVES else i
            layers[name][j].copy_(layer_leaf(m, name, i, seed, device))
    return {**top_weights(m, seed, device), "layers": layers}
