"""The port's Llama forward and loss against the reference's.

The reference's ``init_params(PRNGKey(0), tiny())`` is loaded into the port
through ``params_from_jax`` and both sides get the same tokens, drawn with
numpy. Tolerances, each with its reason:

- f32 compute, 1e-4: the same arithmetic summed in another order; the
  measured gap is ~3e-6 at |logits| <= 4.3.
- bf16 compute, 0.1 absolute: the two frameworks round to bf16 at the same
  places but their matmuls and elementwise ops may differ by an ulp, and a
  flipped ulp early in the stack moves logits of magnitude ~4 by a few bf16
  ulps (0.016 each there); the measured gap is ~0.035, as flash against
  dense inside JAX (0.031).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.models import llama as ref
from brpc_tpu.ops import flash_attention as ref_flash
from brpc_tpu_torch.models import llama
from brpc_tpu_torch.models.convert import params_from_jax
from brpc_tpu_torch.ops import flash_attention as fa
from brpc_tpu_torch.utils.tree import tree_map

_DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4, 1e-4),
           "bf16": (jnp.bfloat16, torch.bfloat16, 0.1, 0.0)}
_ATTN = {"dense": (None, None),
         "flash": (functools.partial(ref_flash, interpret=True),
                   fa.flash_attention)}


@functools.lru_cache(maxsize=None)
def _ref_params():
    params = ref.init_params(jax.random.PRNGKey(0), ref.LlamaConfig.tiny())
    return jax.tree_util.tree_map(np.asarray, params)


def _port_params(cfg=None):
    return params_from_jax(_ref_params(), cfg or llama.LlamaConfig.tiny(),
                           "cpu")


def _tokens(shape=(2, 64), seed=0):
    return np.random.default_rng(seed).integers(0, 512, shape, np.int32)


def _configs(dtype):
    jdt, tdt, _, _ = _DTYPES[dtype]
    return (dataclasses.replace(ref.LlamaConfig.tiny(), dtype=jdt),
            dataclasses.replace(llama.LlamaConfig.tiny(), dtype=tdt))


@pytest.mark.parametrize("attn", ["dense", "flash"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_and_loss_match_reference(dtype, attn):
    ref_cfg, cfg = _configs(dtype)
    ref_attn, port_attn = _ATTN[attn]
    _, _, atol, rtol = _DTYPES[dtype]
    tokens = _tokens()

    @jax.jit
    def ref_run(p, t):
        return (ref.forward(p, t, ref_cfg, ref_attn),
                ref.loss_fn(p, t, ref_cfg, ref_attn))

    want_logits, want_loss = ref_run(_ref_params(), jnp.asarray(tokens))
    params, t = _port_params(), torch.from_numpy(tokens)
    got_logits = llama.forward(params, t, cfg, port_attn)
    got_loss = llama.loss_fn(params, t, cfg, port_attn)
    assert got_logits.dtype == torch.float32
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=atol, rtol=rtol)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), atol=atol,
                               rtol=rtol)


# Ids past either end of the tiny vocabulary (512): jnp counts a negative
# id from the end and clamps the rest, so 600 and -600 read rows 511 and 0.
# As targets, -5 counts from the end and 600 and -600 fill NaN.
_OUT_OF_RANGE = ((0, 3, 600, 7), (1, 10, -1, 9), (1, 20, -600, 4),
                 (0, 40, 511, 3), (1, 50, -512, 5), (0, 63, -5, 0))


@pytest.mark.parametrize("targets_in_range", [True, False])
def test_out_of_vocabulary_tokens_match_reference(targets_in_range):
    """Tokens past the vocabulary on both sides: the port clamps them as
    the reference's indexing does (logits equal at the forward's f32
    tolerance), and a target outside the vocabulary makes the loss NaN in
    both. With ``targets_in_range`` the odd ids sit only at the last
    position, which no target reads, so the loss is finite in both."""
    ref_cfg, cfg = _configs("f32")
    _, _, atol, rtol = _DTYPES["f32"]
    tokens = _tokens()
    for b, t, bad, _ in _OUT_OF_RANGE:
        tokens[b, 63 if targets_in_range else t] = bad
    got_logits = llama.forward(_port_params(), torch.from_numpy(tokens), cfg)
    got_loss = llama.loss_fn(_port_params(), torch.from_numpy(tokens), cfg)
    want_logits, want_loss = jax.jit(lambda p, t: (
        ref.forward(p, t, ref_cfg), ref.loss_fn(p, t, ref_cfg)))(
            _ref_params(), jnp.asarray(tokens))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=atol, rtol=rtol)
    assert np.isnan(float(want_loss)) == (not targets_in_range)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), atol=atol,
                               rtol=rtol, equal_nan=True)


def test_out_of_vocabulary_ids_follow_jnp_indexing():
    """ROADMAP's worked example: on 4 rows, ids 5, -1, -5 and -6 read rows
    3, 3, 0 and 0, as jnp's gather does."""
    ids = np.array([5, -1, -5, -6, -4, 4, 2], np.int32)
    want = np.asarray(jnp.arange(4)[jnp.asarray(ids)])
    got = llama._clamped_ids(torch.from_numpy(ids), 4).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:4], [3, 3, 0, 0])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_and_rope_match_reference(dtype):
    jdt, tdt, _, _ = _DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 4, 32), dtype=np.float32)
    w = rng.standard_normal((32,), dtype=np.float32)
    pos = np.broadcast_to(np.arange(16), (2, 16))
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    # one bf16 ulp at |x| < 4 is 1/64 at most; f32 differs in the last bits
    tol = 1e-5 if dtype == "f32" else 2 ** -6
    np.testing.assert_allclose(
        llama.rms_norm(tx, tw, 1e-5).float().numpy(),
        np.asarray(ref.rms_norm(jx, jw, 1e-5), np.float32), atol=tol,
        rtol=tol)
    np.testing.assert_allclose(
        llama.rope(tx, torch.from_numpy(pos.copy()), 5e5).float().numpy(),
        np.asarray(ref.rope(jx, jnp.asarray(pos), 5e5), np.float32),
        atol=tol, rtol=tol)


def test_forward_shapes_and_finite():
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, generator=torch.Generator().manual_seed(0),
                               device="cpu")
    tokens = torch.from_numpy(_tokens((2, 16), seed=1))
    logits = llama.forward(params, tokens, cfg, fa.flash_attention)
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert logits.dtype == torch.float32
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_causality(attn):
    """Changing a future token must not change past logits."""
    cfg = llama.LlamaConfig.tiny()
    params = _port_params()
    t1 = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8]], dtype=torch.int32)
    t2 = t1.clone()
    t2[0, -1] = 9
    attn_fn = _ATTN[attn][1]
    l1 = llama.forward(params, t1, cfg, attn_fn)
    l2 = llama.forward(params, t2, cfg, attn_fn)
    np.testing.assert_allclose(l1[:, :-1].numpy(), l2[:, :-1].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert not torch.allclose(l1[:, -1], l2[:, -1])


def test_init_params_reproducible_and_in_reference_layout():
    cfg = llama.LlamaConfig.tiny()

    def init(seed):
        return llama.init_params(
            cfg, generator=torch.Generator().manual_seed(seed), device="cpu")

    a, b, c = init(0), init(0), init(1)
    flat = jax.tree_util.tree_leaves
    assert jax.tree_util.tree_structure(a) == \
        jax.tree_util.tree_structure(_ref_params())
    for x, y, want in zip(flat(a), flat(b), flat(_ref_params())):
        assert x.shape == want.shape and x.dtype == torch.float32
        assert torch.equal(x, y)
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])
    # normal * fan_in**-0.5: wq has fan_in = hidden
    std = a["layers"]["wq"].std().item() * cfg.hidden ** 0.5
    assert 0.9 < std < 1.1
    assert torch.equal(a["final_norm"], torch.ones(cfg.hidden))


def test_params_from_jax_copies_as_is():
    params = _port_params()
    for got, want in zip(jax.tree_util.tree_leaves(params),
                         jax.tree_util.tree_leaves(_ref_params())):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    bad = dict(_ref_params(), lm_head=_ref_params()["lm_head"].T)
    with pytest.raises(ValueError, match="lm_head"):
        params_from_jax(bad, llama.LlamaConfig.tiny(), "cpu")
    with pytest.raises(ValueError, match="keys"):
        params_from_jax({"embed": _ref_params()["embed"]},
                        llama.LlamaConfig.tiny(), "cpu")


def test_llama3_8b_config_matches_reference():
    got = dataclasses.asdict(llama.LlamaConfig.llama3_8b())
    want = dataclasses.asdict(ref.LlamaConfig.llama3_8b())
    assert got.pop("dtype") == torch.bfloat16
    assert got.pop("param_dtype") == torch.float32
    # the port's expert and latent-attention fields, which the reference
    # lacks: a dense model with grouped-query attention
    port_only = {"n_experts": 0, "experts_per_token": 0,
                 "first_dense_layers": 0, "expert_intermediate": 0,
                 "n_shared_experts": 0, "norm_topk_prob": True,
                 "kv_lora_rank": 0,
                 "qk_nope_head_dim": 0, "qk_rope_head_dim": 0,
                 "v_head_dim": 0, "rope_scaling": None}
    assert {name: got.pop(name) for name in port_only} == port_only
    want.pop("dtype"), want.pop("param_dtype")
    assert got == want


def test_llama_model_serves_forward():
    cfg = llama.LlamaConfig.tiny()
    params = _port_params()
    model = llama.LlamaModel(cfg, params, attn_fn=fa.flash_attention)
    assert model.embed.data_ptr() == params["embed"].data_ptr()
    assert not any(p.requires_grad for p in model.parameters())
    tokens = torch.from_numpy(_tokens((1, 32), seed=2))
    torch.testing.assert_close(
        model(tokens), llama.forward(params, tokens, cfg, fa.flash_attention),
        rtol=0, atol=0)


def test_llama_model_holds_its_weights_in_the_compute_dtype():
    cfg = llama.LlamaConfig.tiny()
    params = _port_params()
    model = llama.LlamaModel(cfg, params, attn_fn=fa.flash_attention)
    assert all(w.dtype == torch.bfloat16 for w in model.layers.values())
    assert (model.final_norm.dtype, model.lm_head.dtype) == (
        torch.bfloat16, torch.bfloat16)
    # the embedding's rows are gathered, then cast
    assert model.embed.data_ptr() == params["embed"].data_ptr()
    tokens = torch.from_numpy(_tokens((1, 32), seed=3))
    for _ in range(2):
        torch.testing.assert_close(
            model(tokens),
            llama.forward(params, tokens, cfg, fa.flash_attention),
            rtol=0, atol=0)


def test_llama_model_holds_weights_in_the_compute_dtype_as_themselves():
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    params = _port_params(cfg)
    model = llama.LlamaModel(cfg, params)
    for name, w in model.layers.items():
        assert w.data_ptr() == params["layers"][name].data_ptr()
    for name in ("final_norm", "lm_head"):
        assert getattr(model, name).data_ptr() == params[name].data_ptr()
    tokens = torch.from_numpy(_tokens((1, 32), seed=5))
    torch.testing.assert_close(model(tokens),
                               llama.forward(params, tokens, cfg),
                               rtol=0, atol=0)


def test_llama_model_loads_master_weights_into_its_bf16_ones():
    """``load_state_dict`` of f32 masters casts them into the bf16
    weights: the model then serves ``forward`` on those masters."""
    cfg = llama.LlamaConfig.tiny()
    model = llama.LlamaModel(cfg, _port_params(), attn_fn=fa.flash_attention)
    params = tree_map(lambda w: w * -1, _port_params())
    model.load_state_dict(
        {"embed": params["embed"], "final_norm": params["final_norm"],
         "lm_head": params["lm_head"],
         **{f"layers.{k}": w for k, w in params["layers"].items()}})
    assert model.lm_head.dtype == torch.bfloat16
    tokens = torch.from_numpy(_tokens((1, 32), seed=4))
    torch.testing.assert_close(
        model(tokens), llama.forward(params, tokens, cfg, fa.flash_attention),
        rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad"])
def test_llama_model_built_and_served_under_either_mode(mode):
    cfg = llama.LlamaConfig.tiny()
    params = _port_params()
    tokens = torch.from_numpy(_tokens((1, 32), seed=6))
    with getattr(torch, mode)():
        model = llama.LlamaModel(cfg, params, attn_fn=fa.flash_attention)
        got = model(tokens)
    torch.testing.assert_close(
        got, llama.forward(params, tokens, cfg, fa.flash_attention),
        rtol=0, atol=0)
