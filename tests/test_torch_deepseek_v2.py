"""DeepSeek-V2's block on the port's path (``models.mla``, the mixed
stack and shared experts of ``models.llama`` and ``models.moe``) against
the plain float32 reference of the benchmark
(``portbench/reference/deepseek_v2.py``), at a tiny size on the CPU:
hidden 128, 4 heads, latent 64, q/k head dim 32 + 16 rope, v 32, one
dense layer, then two layers of 8 experts at top-3 with 2 shared, and
YaRN at the published factor, on seeded random weights
(``portbench.mla_weights``).

Tolerances, each with its reason:

- f32 against the reference: logits within 2e-5 of their largest. The
  same arithmetic in another order: the port rotates rope pairs where
  they lie (the reference de-interleaves them first, which permutes q's
  and k's rope dims alike), runs the experts as grouped products and
  sums each token's terms into its f32 row; the reference runs each
  expert on its rows;
- faults planted in the reference (no shared experts, top-2 of 3) must
  move the logits by more than 100 times that tolerance, so that the
  comparison above would see them;
- a dense or Mixtral config gives the same bits as the layer code that
  ran before latent attention and shared experts came (``_parent_*``
  below, a copy of it).

The last case (``cuda``) serves the whole model at its published widths
on the card through K1.
"""

import json
import math

import pytest
import torch
from torch.nn import functional as F

from brpc_tpu_torch.models import llama, mla, moe
from brpc_tpu_torch.ops import flash_attention as fa
from portbench import harness, mla_weights
from portbench.mla_config import mla_shape
from portbench.reference import deepseek_v2 as reference
from portbench.tests.tiny import REPO

YARN = {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
        "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
        "type": "yarn"}
TINY = {
    "compute_dtype": "float32", "param_dtype": "float32",
    "hidden_act": "silu", "hidden_size": 128, "intermediate_size": 256,
    "num_attention_heads": 4, "num_key_value_heads": 4,
    "num_hidden_layers": 3, "rms_norm_eps": 1e-6, "rope_theta": 10000,
    "tie_word_embeddings": False, "vocab_size": 512, "kv_lora_rank": 64,
    "q_lora_rank": None, "qk_nope_head_dim": 32, "qk_rope_head_dim": 16,
    "v_head_dim": 32, "n_routed_experts": 8, "num_experts_per_tok": 3,
    "moe_intermediate_size": 64, "n_shared_experts": 2,
    "first_k_dense_replace": 1, "norm_topk_prob": False,
    "routed_scaling_factor": 1.0, "scoring_func": "softmax",
    "topk_method": "greedy", "rope_scaling": YARN,
}
# The published head dims, at which K1's plain version serves the model.
PUBLISHED_HEADS = {"qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
                   "v_head_dim": 128}
TOLERANCE = 2e-5
SEED = 2 ** 33 + 7

_runner = harness.load_module(REPO / "portbench" / "runners"
                              / "mla_prefill.py")


def _model(config=TINY):
    """(the reference's shape, the port's config) of a config dict."""
    m = mla_shape(config)
    return m, _runner.llama_config(m, config)


def _tokens(m, t=48, seed=1):
    return torch.randint(0, m.vocab, (t,),
                         generator=torch.Generator().manual_seed(seed))


def _reference(m, tokens, variants=({},)):
    """The reference's logits at every position of ``tokens``, a variant
    each, and the experts each expert layer chose there."""
    out = reference.logits_at(
        m, mla_weights.top_weights(m, SEED, "cpu"),
        lambda i: mla_weights.layer_weights(m, i, SEED, "cpu"),
        [(tokens, torch.arange(len(tokens)))], variants)
    return [variant[0] for variant in out]


def _served(m, cfg, tokens, attn_fn=None):
    params = mla_weights.served_weights(m, SEED, "cpu", cfg.dtype)
    with torch.no_grad():
        return llama.LlamaModel(cfg, params, attn_fn)(tokens[None])[0]


@pytest.mark.parametrize("heads,attn_fn", [
    ({}, None), (PUBLISHED_HEADS, fa.flash_attention)],
    ids=["tiny heads, dense attention", "published heads, K1's plain"])
def test_port_matches_the_reference(heads, attn_fn):
    m, cfg = _model({**TINY, **heads})
    tokens = _tokens(m)
    got = _served(m, cfg, tokens, attn_fn)
    ((want, experts),) = _reference(m, tokens)
    assert experts.shape == (2, 48, 3)
    assert (got - want).abs().max() <= TOLERANCE * want.abs().max()
    params = mla_weights.served_weights(m, SEED, "cpu", cfg.dtype)
    with torch.no_grad():
        functional = llama.forward(params, tokens[None], cfg, attn_fn)[0]
    assert torch.equal(functional, got)


@pytest.mark.parametrize("fault", [{"shared": False}, {"k": 2}],
                         ids=["no shared experts", "top-(k-1)"])
def test_planted_faults_move_the_logits_beyond_the_tolerance(fault):
    m, cfg = _model()
    tokens = _tokens(m)
    got = _served(m, cfg, tokens)
    ((want, _), (faulty, _)) = _reference(m, tokens, ({}, fault))
    assert (got - want).abs().max() <= TOLERANCE * want.abs().max()
    assert (got - faulty).abs().max() > 100 * TOLERANCE * want.abs().max()


def test_yarn_table_is_the_published_one():
    m, cfg = _model(dict(TINY, qk_rope_head_dim=64, qk_nope_head_dim=128))
    yarn = cfg.rope_scaling
    assert mla.correction_range(yarn, 64, 10000.0) == (10, 23)
    assert reference.yarn_find_correction_range(32, 1, 64, 10000.0,
                                                4096) == (10, 23)
    assert mla.get_mscale(40, 0.707) ** 2 == pytest.approx(1.58963,
                                                           abs=2e-5)
    assert mla.softmax_scale(cfg) == pytest.approx(0.114721, abs=2e-6)
    assert mla.softmax_scale(cfg) == reference.softmax_scale(m)
    assert mla.cos_sin_scale(cfg) == 1.0
    # the frequencies: the reference's cos table at positions 0..T-1
    cos, sin = reference.rotary(m, 40, "cpu")
    angles = torch.arange(40.0)[:, None] * mla.inv_freq(cfg, "cpu")
    assert torch.allclose(torch.cos(angles), cos[:, :32], atol=1e-6)
    assert torch.allclose(torch.sin(angles), sin[:, 32:], atol=1e-6)
    # pairs below 10 keep theta's frequency; above 23, a fortieth of it
    plain = 10000.0 ** (-torch.arange(0, 64, 2) / 64)
    got = mla.inv_freq(cfg, "cpu")
    assert torch.allclose(got[:10], plain[:10], rtol=1e-6)
    assert torch.allclose(got[24:], plain[24:] / 40, rtol=1e-6)


def test_rotating_pairs_where_they_lie_is_the_published_layout():
    """``rope_pairs`` gives HF's de-interleaved, half-rotated values in the
    pairs' own order: the same permutation on q's and k's rope dims, so
    every score is HF's."""
    m, cfg = _model()
    g = torch.Generator().manual_seed(3)
    q, k = (torch.randn((40, 4, 16), generator=g) for _ in range(2))
    positions = torch.arange(40)
    freqs = mla.inv_freq(cfg, "cpu")
    got_q, got_k = (mla.rope_pairs(x[None], positions[None], freqs)[0]
                    for x in (q, k))
    cos, sin = reference.rotary(m, 40, "cpu")
    want_q, want_k = (reference.apply_rotary(x, cos, sin) for x in (q, k))
    deinterleave = torch.cat([torch.arange(0, 16, 2), torch.arange(1, 16, 2)])
    assert torch.allclose(got_q[..., deinterleave], want_q, atol=1e-5)
    assert torch.allclose(torch.einsum("thd,shd->hts", got_q, got_k),
                          torch.einsum("thd,shd->hts", want_q, want_k),
                          atol=1e-4)


@pytest.mark.parametrize("k,e", [(3, 8), (6, 64)])
def test_unrenormalised_routing_keeps_the_raw_probabilities(k, e):
    g = torch.Generator().manual_seed(4)
    xf, w = torch.randn((32, 16), generator=g), torch.randn((16, e),
                                                            generator=g)
    weights, experts = moe.route(xf, w, k, normalise=False)
    probs = torch.softmax(xf @ w, dim=-1)
    assert torch.equal(weights, probs.gather(1, experts))
    assert weights.sum(-1).mean() < 0.99  # no renormalisation
    renormalised, same = moe.route(xf, w, k)
    assert torch.equal(same, experts)
    assert torch.allclose(renormalised.sum(-1), torch.ones(32))


def test_shared_experts_enter_the_f32_sum_once():
    g = torch.Generator().manual_seed(5)
    h, e, f, fs = 32, 4, 16, 24
    x = torch.randn((1, 10, h), generator=g)
    w = [torch.randn(s, generator=g) * 0.2 for s in
         ((h, e), (e, h, f), (e, h, f), (e, f, h), (h, fs), (h, fs),
          (fs, h))]
    routed = moe.expert_layer(x, *w[:4], 2)
    both = moe.expert_layer(x, *w[:4], 2, shared=tuple(w[4:]))
    common = (F.silu(x @ w[4]) * (x @ w[5])) @ w[6]
    assert torch.allclose(both, routed + common, atol=1e-5)


def _parent_expert_layer(x, w_router, w_gate, w_up, w_down, k):
    """The expert layer as it ran before shared experts came."""
    b, t, h = x.shape
    n, e = b * t, w_router.shape[1]
    xf = x.reshape(n, h)
    probs = torch.softmax(xf.float() @ w_router.float(), dim=-1)
    top, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    top = top[:, :k]
    weights, experts = top / top.sum(dim=-1, keepdim=True), experts[:, :k]
    key, order = torch.sort(experts.reshape(-1), stable=True)
    rows = order // k
    offs = torch.searchsorted(key, torch.arange(1, e + 1), out_int32=True)
    xs = xf[rows]
    gate = torch._grouped_mm(xs, w_gate, offs=offs)
    up = torch._grouped_mm(xs, w_up, offs=offs)
    ys = torch._grouped_mm(F.silu(gate) * up, w_down, offs=offs)
    scale = weights.reshape(-1)[order]
    out = torch.zeros((n, h), dtype=torch.float32).index_add_(
        0, rows, ys * scale[:, None])
    return out.to(x.dtype).reshape(b, t, h)


def _parent_forward(params, tokens, cfg):
    """``forward`` as it ran before latent attention, the mixed stack and
    shared experts came (one rank)."""
    x = params["embed"][tokens].to(cfg.dtype)
    b, t = tokens.shape
    positions = torch.arange(t).expand(b, t)
    for i in range(cfg.n_layers):
        lp = {name: w[i].to(cfg.dtype)
              for name, w in params["layers"].items()}
        y = llama.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = ((y @ lp[name]).reshape(b, t, -1, cfg.head_dim)
                   for name in ("wq", "wk", "wv"))
        q = llama.rope(q, positions, cfg.rope_theta)
        k = llama.rope(k, positions, cfg.rope_theta)
        x = x + llama.attention(q, k, v) @ lp["wo"]
        y = llama.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        if cfg.n_experts:
            x = x + _parent_expert_layer(y, lp["w_router"], lp["w_gate"],
                                         lp["w_up"], lp["w_down"],
                                         cfg.experts_per_token)
        else:
            x = x + (F.silu(y @ lp["w_gate"]) * (y @ lp["w_up"])) \
                @ lp["w_down"]
    head = llama.rms_norm(x, params["final_norm"].to(cfg.dtype),
                          cfg.norm_eps) @ params["lm_head"].to(cfg.dtype)
    return head.float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("experts", [0, 4], ids=["dense", "mixtral"])
def test_dense_and_mixtral_configs_give_the_parent_path_bits(experts, dtype):
    cfg = llama.LlamaConfig(vocab_size=256, hidden=64, n_layers=2,
                            n_heads=4, n_kv_heads=2, head_dim=16,
                            intermediate=96, dtype=dtype, n_experts=experts,
                            experts_per_token=2 if experts else 0)
    params = llama.init_params(cfg, generator=torch.Generator()
                               .manual_seed(6), device="cpu")
    tokens = torch.randint(0, 256, (2, 24),
                           generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        got = llama.forward(params, tokens, cfg)
        served = llama.LlamaModel(cfg, params)(tokens)
        want = _parent_forward(params, tokens, cfg)
    assert torch.equal(got, want)
    assert torch.equal(served, want)


def test_the_mixed_stack_serves_each_layer_its_own_weights():
    m, cfg = _model()
    shapes = llama.param_shapes(cfg)["layers"]
    assert shapes["mlp_gate"] == (1, 128, 256)
    assert shapes["w_gate"] == (2, 8, 128, 64)
    assert shapes["shared_gate"] == (2, 128, 128)
    assert shapes["wq"] == (3, 128, 4 * 48)
    layers = {name: torch.zeros(shape).unbind(0)
              for name, shape in shapes.items()}
    first, second = (llama._layer_weights(cfg, layers, i) for i in (0, 1))
    assert "w_router" not in first and first["w_gate"].shape == (128, 256)
    assert second["w_gate"].shape == (8, 128, 64)
    assert "shared_gate" in second and "mlp_gate" not in second
    with pytest.raises(ValueError, match="sharded"):
        llama.param_specs(cfg)


@pytest.mark.parametrize("change,match", [
    ({"qk_rope_head_dim": 15}, "even rope"),
    ({"first_dense_layers": 3}, "expert layer"),
    ({"kv_lora_rank": 0}, "latent attention only")])
def test_config_refuses_what_the_block_cannot_run(change, match):
    _, cfg = _model()
    fields = {f.name: getattr(cfg, f.name)
              for f in cfg.__dataclass_fields__.values()}
    with pytest.raises(ValueError, match=match):
        llama.LlamaConfig(**{**fields, **change})


def test_dense_attention_takes_a_scale_and_a_v_head_dim_of_its_own():
    g = torch.Generator().manual_seed(8)
    q, k = (torch.randn((1, 32, 4, 48), generator=g) for _ in range(2))
    v = torch.randn((1, 32, 4, 32), generator=g)
    got = llama.attention(q, k, v, scale=0.3)
    scores = torch.einsum("bthd,bshd->bhts", q, k) * 0.3
    mask = torch.ones(32, 32, dtype=torch.bool).tril()
    probs = torch.softmax(scores.masked_fill(~mask, -math.inf), -1)
    want = torch.einsum("bhts,bshd->bthd", probs, v).reshape(1, 32, 128)
    assert torch.allclose(got, want, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; K1 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_whole_model_serves_through_k1_once_a_layer_on_card(
        cuda_device):
    """DeepSeek-V2-Lite at its published widths, all 27 layers, through
    ``LlamaModel`` with K1: one (192, 128) launch a layer a request, no
    read back to the host inside it, finite f32 logits."""
    config = json.loads((REPO / "portbench" / "configs"
                         / "deepseek-v2-lite.json").read_text())
    m, cfg = _model(config)
    params = mla_weights.served_weights(m, SEED, cuda_device, cfg.dtype)
    model = llama.LlamaModel(cfg, params, attn_fn=fa.flash_attention)
    del params
    tokens = _tokens(m, 2048).to(cuda_device)[None]
    with torch.inference_mode():
        model(tokens)  # builds and warms up
        before = dict(fa.launches)
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits = model(tokens)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    assert fa.launches == {**before, "bf16": before["bf16"] + 27}
    assert logits.shape == (1, 2048, 102400) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
