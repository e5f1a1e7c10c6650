"""The system under test: the port's entry points, as the cells call them.

This is the only module of the harness, besides the runners, that imports
``brpc_tpu_torch``; the references and the counts never do.
"""

from __future__ import annotations

import torch

from portbench import weights
from portbench.model_config import ModelShape

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def llama_config(m: ModelShape, config: dict):
    """The port's ``LlamaConfig`` for a configuration file, whose
    ``compute_dtype`` and ``param_dtype`` say how the port runs it."""
    from brpc_tpu_torch.models import llama

    cfg = llama.LlamaConfig(
        vocab_size=m.vocab, hidden=m.hidden, n_layers=m.layers,
        n_heads=m.heads, n_kv_heads=m.kv_heads, head_dim=m.head_dim,
        intermediate=m.intermediate, rope_theta=m.rope_theta,
        norm_eps=m.norm_eps, dtype=DTYPES[config["compute_dtype"]],
        param_dtype=DTYPES[config["param_dtype"]])
    if llama.param_shapes(cfg) != weights.llama_shapes(m):
        raise ValueError("the port's parameter layout differs from the "
                         "benchmark's")
    return cfg
