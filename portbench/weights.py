"""The benchmark's own inputs, made from ``--seed``.

Every tensor comes from a ``torch.Generator`` on the device it is made on,
seeded from the run's seed and the tensor's name, so that any one of them
can be made again alone: the references make their inputs afresh rather
than read what the program held. Weights are in the port's layout (stacked
``[layers, in, out]`` leaves, applied as ``x @ w``) and in float32, the
type the port keeps its master weights in.
"""

from __future__ import annotations

import hashlib

import torch

from portbench.model_config import ModelShape

LAYER_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                "attn_norm", "mlp_norm")
# Norm weights are 1 + NORM_JITTER * N(0, 1), so that a path that drops
# them shows.
NORM_JITTER = 0.1


def sub_seed(seed: int, *names) -> int:
    """A 63-bit seed for the input called ``names`` in run ``seed``."""
    key = "/".join(str(x) for x in (seed, *names)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") \
        & ((1 << 63) - 1)


def generator(device, seed: int, *names) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(sub_seed(seed, *names))
    return g


def llama_shapes(m: ModelShape) -> dict:
    """Every leaf's shape, nested as the port's ``param_shapes``."""
    h, L, i = m.hidden, m.layers, m.intermediate
    return {
        "embed": (m.vocab, h),
        "layers": {
            "wq": (L, h, m.q_out), "wk": (L, h, m.kv_out),
            "wv": (L, h, m.kv_out), "wo": (L, m.q_out, h),
            "w_gate": (L, h, i), "w_up": (L, h, i), "w_down": (L, i, h),
            "attn_norm": (L, h), "mlp_norm": (L, h),
        },
        "final_norm": (h,),
        "lm_head": (h, m.vocab),
    }


def leaf_names(m: ModelShape) -> list:
    """Leaf names in a fixed order: ``embed``, ``layers.<w>``...,
    ``final_norm``, ``lm_head``."""
    return ["embed", *(f"layers.{w}" for w in LAYER_LEAVES), "final_norm",
            "lm_head"]


def leaf_shape(m: ModelShape, name: str) -> tuple:
    shapes = llama_shapes(m)
    if name.startswith("layers."):
        return shapes["layers"][name[len("layers."):]]
    return shapes[name]


def llama_leaf(m: ModelShape, name: str, seed: int, device) -> torch.Tensor:
    """One f32 leaf: N(0, 1/fan_in) for products (fan_in the ``in`` axis;
    the embedding N(0, 1)), 1 + 0.1 N(0, 1) for norms. One call a leaf."""
    shape = leaf_shape(m, name)
    w = torch.randn(shape, generator=generator(device, seed, "weights", name),
                    device=device, dtype=torch.float32)
    if name.endswith("norm"):
        return w.mul_(NORM_JITTER).add_(1.0)
    if name == "embed":
        return w
    return w.mul_(shape[-2] ** -0.5)


def nest(m: ModelShape, leaves: list) -> dict:
    """Leaves in ``leaf_names`` order, nested as ``llama_shapes``."""
    out = {"layers": {}}
    for name, leaf in zip(leaf_names(m), leaves):
        if name.startswith("layers."):
            out["layers"][name[len("layers."):]] = leaf
        else:
            out[name] = leaf
    return out


def llama_weights(m: ModelShape, seed: int, device) -> dict:
    """Every leaf, nested as ``llama_shapes``."""
    return nest(m, [llama_leaf(m, name, seed, device)
                    for name in leaf_names(m)])


def flat_leaves(tree: dict) -> list:
    """The leaves of ``llama_weights``' nesting in ``leaf_names`` order."""
    return [tree["embed"], *(tree["layers"][w] for w in LAYER_LEAVES),
            tree["final_norm"], tree["lm_head"]]


def token_ids(vocab: int, shape: tuple, seed: int, device,
              *names) -> torch.Tensor:
    """Uniform int64 token ids in ``[0, vocab)``."""
    return torch.randint(0, vocab, shape, device=device, dtype=torch.int64,
                         generator=generator(device, seed, "tokens", *names))


def gradient_chunk(out: torch.Tensor, seed: int, replica: int,
                   chunk: int) -> torch.Tensor:
    """Fills ``out`` with chunk ``chunk`` of replica ``replica``'s flat f32
    gradient, N(0, 1): one call a chunk."""
    return out.normal_(generator=generator(out.device, seed, "grad", replica,
                                           chunk))
