"""A configuration file's DeepSeek-V2 model (Hugging Face's
``modeling_deepseek.py`` keys): multi-head latent attention without a
query latent, YaRN rope where ``rope_scaling`` says so, and
``first_k_dense_replace`` dense layers followed by expert layers of
softmax top-k routed experts beside shared ones. ``mla_shape`` refuses a
file without the latent-attention and expert keys, so a Llama or Mixtral
file is never read by this path, and refuses the settings whose
equations the port does not implement (a query latent, grouped routing,
sigmoid scores, a routed scaling factor other than 1, expert layers at a
stride)."""

from __future__ import annotations

import dataclasses

MLA_KEYS = ("kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
            "v_head_dim", "n_routed_experts", "num_experts_per_tok",
            "moe_intermediate_size", "n_shared_experts",
            "first_k_dense_replace")
# Keys whose published value the equations here require.
_REQUIRED = {"hidden_act": "silu", "tie_word_embeddings": False,
             "q_lora_rank": None, "scoring_func": "softmax",
             "topk_method": "greedy", "moe_layer_freq": 1,
             "attention_bias": False, "routed_scaling_factor": 1}
_YARN_KEYS = ("factor", "original_max_position_embeddings", "beta_fast",
              "beta_slow", "mscale", "mscale_all_dim")


@dataclasses.dataclass(frozen=True)
class MlaShape:
    vocab: int
    hidden: int
    layers: int
    heads: int
    kv_lora_rank: int
    qk_nope: int
    qk_rope: int
    v_head: int
    intermediate: int          # the dense layers' MLP
    expert_intermediate: int   # a routed or shared expert's width
    experts: int
    per_token: int
    shared: int                # shared experts, run as one of shared × width
    dense_layers: int          # first_k_dense_replace
    norm_topk_prob: bool
    rope_theta: float
    norm_eps: float
    yarn: tuple | None         # (key, value) of _YARN_KEYS, or None

    @property
    def qk_head(self) -> int:
        return self.qk_nope + self.qk_rope

    @property
    def shared_intermediate(self) -> int:
        return self.shared * self.expert_intermediate

    @property
    def expert_layers(self) -> int:
        return self.layers - self.dense_layers

    def yarn_args(self) -> dict | None:
        return None if self.yarn is None else dict(self.yarn)


def mla_shape(config: dict) -> MlaShape:
    """The shape of a configuration's DeepSeek-V2 model; ``ValueError``
    where a key of its equations is missing or has a value they do not
    describe."""
    missing = [key for key in MLA_KEYS if key not in config]
    if missing:
        raise ValueError(f"no {', '.join(missing)}: not a latent-attention "
                         f"expert model")
    for key, want in _REQUIRED.items():
        if config.get(key, want) != want:
            raise ValueError(f"{key} is {config[key]!r}; the DeepSeek-V2 "
                             f"equations here need {want!r}")
    if config.get("n_group", 1) != 1 or config.get("topk_group", 1) != 1:
        raise ValueError("grouped routing is not implemented")
    heads = config["num_attention_heads"]
    if config.get("num_key_value_heads", heads) != heads:
        raise ValueError("latent attention has as many KV heads as heads")
    scaling = config.get("rope_scaling")
    yarn = None
    if scaling is not None:
        if scaling.get("type") != "yarn":
            raise ValueError(f"rope_scaling {scaling!r}: only yarn")
        yarn = tuple((key, float(scaling[key])) for key in _YARN_KEYS)
    experts, per_token = config["n_routed_experts"], \
        config["num_experts_per_tok"]
    if not 0 < per_token <= experts:
        raise ValueError(f"{per_token} experts a token of {experts}")
    if not 0 <= config["first_k_dense_replace"] \
            < config["num_hidden_layers"]:
        raise ValueError("no expert layer")
    return MlaShape(
        vocab=config["vocab_size"], hidden=config["hidden_size"],
        layers=config["num_hidden_layers"], heads=heads,
        kv_lora_rank=config["kv_lora_rank"],
        qk_nope=config["qk_nope_head_dim"],
        qk_rope=config["qk_rope_head_dim"], v_head=config["v_head_dim"],
        intermediate=config["intermediate_size"],
        expert_intermediate=config["moe_intermediate_size"],
        experts=experts, per_token=per_token,
        shared=config["n_shared_experts"],
        dense_layers=config["first_k_dense_replace"],
        norm_topk_prob=bool(config.get("norm_topk_prob", False)),
        rope_theta=float(config["rope_theta"]),
        norm_eps=float(config["rms_norm_eps"]), yarn=yarn)
