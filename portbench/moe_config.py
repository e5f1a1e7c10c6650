"""A configuration file's sparse-expert model: the Llama layer shape that
``model_config`` reads, and the two expert keys of Mixtral's
``config.json`` (Hugging Face names), which that reader does not know.
``moe_shape`` refuses a file without them, so a dense file is never read
as an expert model, nor an expert file by this path as a dense one."""

from __future__ import annotations

import dataclasses

from portbench.model_config import ModelShape, model_shape

EXPERT_KEYS = ("num_local_experts", "num_experts_per_tok")


@dataclasses.dataclass(frozen=True)
class MoeShape(ModelShape):
    """``ModelShape`` with E experts a layer, each token routed to
    ``per_token`` of them; ``intermediate`` is an expert's width."""
    experts: int = 0
    per_token: int = 0


def moe_shape(config: dict) -> MoeShape:
    """The shape of a configuration's expert model; ``ValueError`` where
    an expert key is missing or the Llama equations do not hold."""
    missing = [key for key in EXPERT_KEYS if key not in config]
    if missing:
        raise ValueError(f"no {', '.join(missing)}: not an expert model")
    experts, per_token = (int(config[key]) for key in EXPERT_KEYS)
    if not 0 < per_token <= experts:
        raise ValueError(f"{per_token} experts a token of {experts}")
    return MoeShape(**dataclasses.asdict(model_shape(config)),
                    experts=experts, per_token=per_token)
