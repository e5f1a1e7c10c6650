"""The port's dropless top-k expert layer (``models.moe.expert_layer``)
and Mixtral configs of ``models.llama`` against the plain float32
reference of the benchmark (``portbench/reference/mixtral.py``), at a
tiny size (8 experts, 2 a token, hidden 64, expert width 128, 2 layers)
on seeded random weights.

Tolerances, each with its reason:

- f32 against the reference: within 1e-5 of the largest element for one
  layer, 2e-5 for the logits. The same arithmetic in another order: the
  port gathers the pairs by expert and runs grouped products, then adds
  each token's two terms into its f32 row; the reference runs each
  expert on its rows (measured 2.1e-7 and 0 here);
- the shares of held experts against the whole layer, added here or by
  the all-reduce of two gloo ranks over 'ep': the same 1e-5, each share's
  terms being the whole layer's, added in another order (measured 0);
- bf16 against the f32 reference: logits within 0.05 of their largest
  element, at the positions whose routing choices all match the
  reference's. The port rounds the residual stream and every product's
  inputs and outputs to bf16 over two layers (measured 0.0078). A choice
  whose second and third probabilities lie within that rounding flips
  (1 of the 80 here), and moves its position by a whole expert's term
  (0.11 of the largest logit); dropping the second expert reads 0.58 at
  the positions that did not flip.

The last three cases (``cuda``) run on the card: one expert layer at
Mixtral's widths and a served expert model with K1, each under
``torch.cuda.set_sync_debug_mode("error")``, so that any read back to
the host inside a request raises; and one traced layer, so that the
kernels the ``moe.experts`` span counts end where the next span's marker
starts.
"""

import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import torch_world
from brpc_tpu_torch.models import llama, moe
from brpc_tpu_torch.obs import rpcz
from portbench.reference import llama as dense_reference
from portbench.reference import mixtral as reference

E, K, H, F, L = 8, 2, 64, 128, 2


def _cfg(dtype=torch.float32, **kw):
    return llama.LlamaConfig(
        vocab_size=256, hidden=H, n_layers=L, n_heads=2, n_kv_heads=1,
        head_dim=32, intermediate=F, rope_theta=10000.0, dtype=dtype,
        n_experts=E, experts_per_token=K, **kw)


class _Shape:
    """The reference's view of ``_cfg()``."""
    heads, kv_heads, head_dim, layers = 2, 1, 32, L
    rope_theta, norm_eps, per_token = 10000.0, 1e-5, K


def _params(seed=0, cfg=None):
    cfg = cfg or _cfg()
    params = llama.init_params(cfg, generator=torch.Generator()
                               .manual_seed(seed), device="cpu")
    # norms off one, so that a path that drops them shows
    g = torch.Generator().manual_seed(seed + 100)
    for name in ("attn_norm", "mlp_norm"):
        params["layers"][name] += 0.1 * torch.randn(
            params["layers"][name].shape, generator=g)
    return params


def _layer(params, i=0):
    return {name: w[i] for name, w in params["layers"].items()}


def _x(seed=1, shape=(2, 24, H)):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _expert_layer(x, lw, held=None):
    lo, hi = (0, E) if held is None else (held.start, held.stop)
    return moe.expert_layer(x, lw["w_router"], lw["w_gate"][lo:hi],
                            lw["w_up"][lo:hi], lw["w_down"][lo:hi], K,
                            held=held)


def test_expert_layer_matches_the_reference_at_f32():
    lw = _layer(_params())
    x = _x()
    got = _expert_layer(x, lw)
    want = torch.stack([reference.experts_block(row, lw, K)[0]
                        for row in x])
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_shares_of_held_experts_add_up_to_the_whole_layer():
    lw = _layer(_params(3))
    x = _x(4)
    parts = [_expert_layer(x, lw, range(0, 4)),
             _expert_layer(x, lw, range(4, 8))]
    want = torch.stack([reference.experts_block(row, lw, K)[0]
                        for row in x])
    assert (parts[0] + parts[1] - want).abs().max() \
        <= 1e-5 * want.abs().max()
    # each share is nonzero: both halves hold chosen experts
    assert all(p.abs().max() > 0 for p in parts)


def test_expert_layer_over_ep_matches_the_whole_layer(tmp_path):
    """Two gloo ranks hold 4 experts each; ``reduce_from`` over 'ep'
    completes each rank's share to the whole layer."""
    lw = _layer(_params(16))
    x = _x(17)
    np.savez(tmp_path / "inputs.npz", x=x.numpy(),
             **{k: v.numpy() for k, v in lw.items()})
    want = torch.stack([reference.experts_block(row, lw, K)[0]
                        for row in x])
    for got in torch_world.run("expert_layer", 2, tmp_path):
        assert np.abs(got["out"] - want.numpy()).max() \
            <= 1e-5 * want.abs().max().item()


def test_a_token_routed_elsewhere_adds_nothing():
    lw = _layer(_params(5))
    x = _x(6, (1, 16, H))
    _, experts = moe.route(x[0], lw["w_router"], K)
    elsewhere = (experts >= 4).all(-1)
    assert elsewhere.any() and not elsewhere.all()
    out = _expert_layer(x, lw, range(0, 4))[0]
    assert (out[elsewhere] == 0).all()
    assert (out[~elsewhere].abs().sum(-1) > 0).all()


def test_routing_renormalises_and_breaks_ties_to_the_lower_index():
    g = torch.Generator().manual_seed(7)
    xf = torch.randn(32, H, generator=g)
    w = torch.randn(H, E, generator=g)
    weights, experts = moe.route(xf, w, K)
    probs = torch.softmax(xf @ w, -1)
    assert torch.allclose(weights.sum(-1), torch.ones(32))
    top = probs.topk(K).values
    assert torch.allclose(weights, top / top.sum(-1, keepdim=True))
    # experts 2, 5 and 6 tie above the rest: 2 and 5 are chosen, in order
    w = torch.zeros(H, E)
    w[:, [2, 5, 6]] = 1.0
    _, experts = moe.route(torch.ones(4, H), w, K)
    assert experts.tolist() == [[2, 5]] * 4


def test_llama_model_of_an_expert_config_matches_the_reference(
        monkeypatch):
    params = _params(8)
    tokens = torch.randint(0, 256, (40,),
                           generator=torch.Generator().manual_seed(9))
    (((want, experts),), ((dropped, _),)) = reference.logits_at(
        _Shape, params, lambda i: dense_reference.layer_weights(params, i),
        [(tokens, torch.arange(40))], ({}, {"drop_second": True}))
    scale = want.abs().max()
    route, chosen = moe.route, []

    def recorded(*args):
        out = route(*args)
        chosen.append(out[1])
        return out

    monkeypatch.setattr(moe, "route", recorded)
    with torch.inference_mode():
        f32 = llama.LlamaModel(_cfg(), params)(tokens[None])[0]
        chosen.clear()
        bf16 = llama.LlamaModel(_cfg(torch.bfloat16),
                                params)(tokens[None])[0]
    assert (f32 - want).abs().max() <= 2e-5 * scale
    # at bf16 a choice flips where the second and third probabilities lie
    # within rounding: here 1 of the 80 (position, layer) choices
    same = torch.stack([(c.sort(-1).values == e.sort(-1).values).all(-1)
                        for c, e in zip(chosen, experts)]).all(0)
    assert 0.9 * len(same) <= same.sum() < len(same)
    assert (bf16 - want)[same].abs().max() <= 0.05 * scale
    assert (dropped - want)[same].abs().max() > 0.05 * scale
    # the functional forward serves the same logits from f32 params
    assert torch.equal(llama.forward(params, tokens[None],
                                     _cfg(torch.bfloat16))[0], bf16)


def test_expert_config_layout_and_no_sharded_layout():
    shapes = llama.param_shapes(_cfg())["layers"]
    assert shapes["w_router"] == (L, H, E)
    assert shapes["w_gate"] == shapes["w_up"] == (L, E, H, F)
    assert shapes["w_down"] == (L, E, F, H)
    assert "w_gate" in llama.param_shapes(llama.LlamaConfig.tiny())["layers"]
    with pytest.raises(ValueError, match="experts"):
        llama.param_specs(_cfg())
    with pytest.raises(ValueError, match="experts_per_token"):
        llama.LlamaConfig(n_experts=8, experts_per_token=9)


def test_dense_llama_model_is_bit_identical_to_forward():
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, generator=torch.Generator()
                               .manual_seed(10), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(11))
    with torch.inference_mode():
        served = llama.LlamaModel(cfg, params)(tokens)
    assert torch.equal(served, llama.forward(params, tokens, cfg))


def test_traced_expert_layer_counts_its_pairs_and_experts():
    lw = _layer(_params(12))
    x = _x(13, (2, 24, H))
    rpcz.clear()
    start = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        _expert_layer(x, lw, range(2, 6))
    spans = rpcz.captured(start, time.time_ns())
    names = [s.name for s in spans]
    assert names.count("moe.route") == 1
    assert {"moe.experts", "moe.combine"} <= set(names)
    route = next(s for s in spans if s.name == "moe.route")
    assert route.counts == {"pairs": 2 * 24 * K, "experts": 4}
    # untraced, the layer records nothing
    rpcz.clear()
    _expert_layer(x, lw)
    assert rpcz.captured() == []


def _cuda_layer(device):
    """One Mixtral-width expert layer (hidden 4096, 8 experts of 14336)
    in bf16 on ``device``, and a request's activations [1, 1024, 4096]."""
    g = torch.Generator(device=device).manual_seed(14)

    def w(*shape):
        return (torch.randn(shape, generator=g, device=device)
                * shape[-2] ** -0.5).to(torch.bfloat16)

    lw = {"w_router": w(4096, 8), "w_gate": w(8, 4096, 14336),
          "w_up": w(8, 4096, 14336), "w_down": w(8, 14336, 4096)}
    x = torch.randn((1, 1024, 4096), generator=g, device=device) \
        .to(torch.bfloat16)
    return lw, x


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the grouped products run there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_expert_layer_reads_nothing_back_on_the_card():
    device = _card()
    lw, x = _cuda_layer(device)
    want = torch.stack([reference.experts_block(
        row.float(), {k: v.float() for k, v in lw.items()}, K)[0]
        for row in x])
    _expert_layer(x, lw)  # warm: the first call may load libraries
    torch.cuda.synchronize(device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = _expert_layer(x, lw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # bf16 operands and products against f32: within a few bf16 steps
    assert (got.float() - want).abs().max() <= 0.02 * want.abs().max()


@pytest.mark.cuda
def test_served_expert_model_reads_nothing_back_on_the_card():
    from brpc_tpu_torch.ops.flash_attention import flash_attention

    device = _card()
    cfg = llama.LlamaConfig(vocab_size=4096, hidden=1024, n_layers=2,
                            n_heads=8, n_kv_heads=2, head_dim=128,
                            intermediate=1024, n_experts=E,
                            experts_per_token=K)
    model = llama.LlamaModel(cfg, llama.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(15),
        device=device), attn_fn=flash_attention)
    tokens = torch.randint(0, 4096, (1, 512), device=device)
    with torch.inference_mode():
        model(tokens)  # warm: builds K1 and loads the libraries
        torch.cuda.synchronize(device)
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits = model(tokens)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert logits.shape == (1, 512, 4096)


@pytest.mark.cuda
def test_counted_expert_kernels_end_where_the_combine_begins():
    device = _card()
    lw, x = _cuda_layer(device)
    _expert_layer(x, lw)
    torch.cuda.synchronize(device)
    rpcz.clear()
    start = time.time_ns()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the profiler can lose a session's first kernel records (up to 9
        # on an H100): these go first, so the layer's are kept
        pad = torch.zeros(1, device=device)
        for _ in range(16):
            pad.add_(1)
        _expert_layer(x, lw)
        torch.cuda.synchronize(device)
    end = time.time_ns()
    kernels = [(e.device_index(), e.name(), e.start_ns(), e.end_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and not e.is_user_annotation()]
    spans = {s.name: s for s in rpcz.captured(start, end, kernels=kernels)}
    ordered = sorted(kernels, key=lambda k: k[2])
    marks = [i for i, k in enumerate(ordered) if rpcz.is_marker(k[1])]
    # route: start and end; experts: start only; combine: start and end
    assert len(marks) == 5
    counted = spans["moe.experts"].counts["kernels"]
    assert marks[3] - marks[2] - 1 == counted
    assert spans["moe.experts"].device_end_ns == ordered[marks[3] - 1][3]
