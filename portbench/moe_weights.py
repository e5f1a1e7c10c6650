"""An expert model's weights, made from ``--seed`` one leaf and layer at a
time, so that neither the program's set-up nor the reference ever holds
every layer's float32 weights at once.

Each layer's leaf comes from its own generator, named by the leaf and the
layer (``weights.generator(device, seed, "weights", name, layer)``), in
one call; the embedding, the final norm and the LM head are the dense
model's leaves (``weights.llama_leaf``). Products are N(0, 1/fan_in) with
fan_in the ``in`` axis, experts stacked ``[E, in, out]`` and the router
``[hidden, E]``; norms 1 + 0.1·N(0, 1), as ``weights`` makes them.
"""

from __future__ import annotations

import torch

from portbench import weights
from portbench.moe_config import MoeShape

LAYER_LEAVES = ("wq", "wk", "wv", "wo", "w_router", "w_gate", "w_up",
                "w_down", "attn_norm", "mlp_norm")
TOP_LEAVES = ("embed", "final_norm", "lm_head")


def layer_shapes(m: MoeShape) -> dict:
    """One layer's leaves' shapes."""
    h, f, e = m.hidden, m.intermediate, m.experts
    return {"wq": (h, m.q_out), "wk": (h, m.kv_out), "wv": (h, m.kv_out),
            "wo": (m.q_out, h), "w_router": (h, e), "w_gate": (e, h, f),
            "w_up": (e, h, f), "w_down": (e, f, h), "attn_norm": (h,),
            "mlp_norm": (h,)}


def shapes(m: MoeShape) -> dict:
    """Every leaf's shape, nested and stacked as the port's
    ``param_shapes``."""
    return {"embed": (m.vocab, m.hidden),
            "layers": {name: (m.layers, *shape)
                       for name, shape in layer_shapes(m).items()},
            "final_norm": (m.hidden,), "lm_head": (m.hidden, m.vocab)}


def layer_leaf(m: MoeShape, name: str, layer: int, seed: int,
               device) -> torch.Tensor:
    """Layer ``layer``'s f32 leaf ``name``, in one call."""
    shape = layer_shapes(m)[name]
    w = torch.randn(shape, generator=weights.generator(
        device, seed, "weights", name, layer), device=device,
        dtype=torch.float32)
    if name.endswith("norm"):
        return w.mul_(weights.NORM_JITTER).add_(1.0)
    return w.mul_(shape[-2] ** -0.5)


def layer_weights(m: MoeShape, layer: int, seed: int, device) -> dict:
    """Every f32 leaf of one layer."""
    return {name: layer_leaf(m, name, layer, seed, device)
            for name in LAYER_LEAVES}


def top_weights(m: MoeShape, seed: int, device) -> dict:
    """The f32 embedding, final norm and LM head."""
    return {name: weights.llama_leaf(m, name, seed, device)
            for name in TOP_LEAVES}


def served_weights(m: MoeShape, seed: int, device,
                   dtype: torch.dtype) -> dict:
    """Every leaf, nested as ``shapes``: each layer's leaves made in f32
    one at a time and cast into stacks preallocated in ``dtype``; the
    embedding, final norm and LM head in f32."""
    layers = {name: torch.empty(shape, dtype=dtype, device=device)
              for name, shape in shapes(m)["layers"].items()}
    for i in range(m.layers):
        for name in LAYER_LEAVES:
            layers[name][i].copy_(layer_leaf(m, name, i, seed, device))
    return {**top_weights(m, seed, device), "layers": layers}
