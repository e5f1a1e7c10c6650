"""A configuration file's model, as the shapes the benchmark needs.

Configuration files hold a model's published ``config.json`` keys (Hugging
Face names). ``ModelShape`` reads the keys of the Llama layer equations
(RMSNorm, RoPE on halves, grouped-query attention, SwiGLU, untied head) and
refuses a configuration those equations do not describe.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class ModelShape:
    vocab: int
    hidden: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    intermediate: int
    rope_theta: float
    norm_eps: float

    @property
    def q_out(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_out(self) -> int:
        return self.kv_heads * self.head_dim


# Keys whose published value the Llama equations require.
_REQUIRED = {"hidden_act": "silu", "tie_word_embeddings": False}
_ABSENT_OR_NULL = ("sliding_window", "rope_scaling")


def load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def model_shape(config: dict) -> ModelShape:
    """The shape of a configuration's model; raises ``ValueError`` where
    the configuration leaves the equations the port implements."""
    for key, want in _REQUIRED.items():
        if config.get(key) != want:
            raise ValueError(f"{key} is {config.get(key)!r}; the Llama "
                             f"equations need {want!r}")
    for key in _ABSENT_OR_NULL:
        if config.get(key) is not None:
            raise ValueError(f"{key} is {config[key]!r}; the Llama "
                             f"equations have none")
    heads = config["num_attention_heads"]
    return ModelShape(
        vocab=config["vocab_size"],
        hidden=config["hidden_size"],
        layers=config["num_hidden_layers"],
        heads=heads,
        kv_heads=config.get("num_key_value_heads", heads),
        head_dim=config.get("head_dim") or config["hidden_size"] // heads,
        intermediate=config["intermediate_size"],
        rope_theta=float(config["rope_theta"]),
        norm_eps=float(config["rms_norm_eps"]),
    )
