"""``LlamaModel``'s CUDA graph path (``models/llama.py``).

On the CPU: the model serves ``forward`` as it is and captures nothing;
the graph path's rule (CUDA, a dense config, no weight that requires
grad), so an expert config never takes it; the graph's body,
``_forward`` on the model's weights, gives ``forward``'s logits bit for
bit before their f32 cast; a span of a call that replayed nothing counts
no ``graph``; and the rule of which shapes are captured (``_Graphs``),
driven as the model drives it: first calls while there is room, every
other shape eagerly, no held graph dropped or replaced, and never more
than ``GRAPHS`` captures or their budget of bytes, whatever lengths the
prompts have.

On the card (``cuda``): replayed logits bit-equal to the first, eager
call's and to ``forward``'s, at a tiny width and at Mistral-7B's widths
with two layers, in bf16 and in f32; the first call of a shape eager and
later ones replays; logits a caller holds unchanged by later calls; K1's
launches counted in eager calls only, a trace of a replay showing them;
weights loaded in place read by the replay and weights replaced dropping
the graphs; nothing read back to the host in a replay; a traced replay's
span holding as many device operations as an eager call's; and prompts
of many lengths keeping the captures and the card's reserved memory
bounded.
"""

import dataclasses
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from brpc_tpu_torch.models import llama
from brpc_tpu_torch.obs import rpcz
from brpc_tpu_torch.ops import flash_attention as fa
from brpc_tpu_torch.parallel.mesh import Ranks

#: Mistral-7B-v0.3's widths with two of its 32 layers
MISTRAL_L2 = llama.LlamaConfig(vocab_size=32768, hidden=4096, n_layers=2,
                               n_heads=32, n_kv_heads=8, head_dim=128,
                               intermediate=14336, rope_theta=1e6)
EXPERTS = dataclasses.replace(llama.LlamaConfig.tiny(), n_experts=4,
                              experts_per_token=2)


def _model(cfg, device="cpu", seed=0, attn_fn=fa.flash_attention):
    g = torch.Generator(device=device).manual_seed(seed)
    params = llama.init_params(cfg, generator=g, device=device)
    return llama.LlamaModel(cfg, params, attn_fn=attn_fn)


def _tokens(cfg, shape, device="cpu", seed=1):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, shape, generator=g,
                         device=device)


@pytest.fixture(autouse=True)
def _clean_rpcz():
    rpcz.clear()
    yield
    rpcz.clear()


# ---------------------------------------------------------------------------
# the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_the_cpu_serves_forward_and_captures_nothing(attn):
    cfg = llama.LlamaConfig.tiny()
    attn_fn = fa.flash_attention if attn == "flash" else None
    model = _model(cfg, attn_fn=attn_fn)
    tokens = _tokens(cfg, (2, 32))
    for _ in range(3):
        torch.testing.assert_close(
            model(tokens), llama.forward(model.params(), tokens, cfg,
                                         attn_fn), rtol=0, atol=0)
    assert model._graphs is None


@pytest.mark.parametrize("case, replays", [
    ("dense on cuda", True), ("dense on cpu", False),
    ("experts on cuda", False), ("a weight that requires grad", False)])
def test_the_graph_path_takes_frozen_dense_models_on_cuda_only(case,
                                                               replays):
    model = _model(EXPERTS if case.startswith("experts")
                   else llama.LlamaConfig.tiny())
    if case == "a weight that requires grad":
        model.lm_head.requires_grad_(True)
    device = torch.device("cpu" if case.endswith("cpu") else "cuda")
    assert model._replays(device) is replays


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_the_graph_body_gives_forward_s_logits_bit_for_bit(dtype, attn):
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=dtype)
    attn_fn = fa.flash_attention if attn == "flash" else None
    model = _model(cfg, attn_fn=attn_fn)
    for shape in ((1, 32), (2, 64)):
        tokens = _tokens(cfg, shape, seed=shape[1])
        tokens[0, :3] = torch.tensor([-1, cfg.vocab_size, -cfg.vocab_size])
        head = llama._forward(model.params(), tokens, cfg, attn_fn,
                              Ranks())
        assert head.dtype == dtype
        torch.testing.assert_close(
            head.float(), llama.forward(model.params(), tokens, cfg,
                                        attn_fn), rtol=0, atol=0)


@pytest.mark.parametrize("cfg", [llama.LlamaConfig.tiny(), EXPERTS],
                         ids=["dense", "experts"])
def test_a_call_that_replays_nothing_counts_no_graph(cfg):
    model = _model(cfg, attn_fn=None)
    tokens = _tokens(cfg, (1, 16))
    rpcz.clear()
    start = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            model(tokens)
    spans = [s for s in rpcz.captured(start, time.time_ns())
             if s.name == "llama.forward"]
    assert len(spans) == 2
    assert all(llama.GRAPH_COUNTER not in s.counts for s in spans)


class _Logits:
    """Stands for a graph's logits in the CPU tests of the rule."""

    def __init__(self, nbytes):
        self.nbytes = nbytes


def _serve(graphs, key, nbytes) -> str:
    """One call as ``LlamaModel.forward`` makes it: 'replay', 'capture'
    (served without a graph, then captured) or 'eager'."""
    if key in graphs.graphs:
        return "replay"
    if graphs.admit(key, nbytes):
        graphs.graphs[key] = llama._Graph(None, None, _Logits(nbytes))
        return "capture"
    return "eager"


def _bounded(graphs):
    assert len(graphs.graphs) <= llama.GRAPHS
    assert graphs.held() <= graphs.budget


def _kept(graphs, held: dict) -> bool:
    """Whether ``graphs`` holds exactly the graphs of ``held``, each the
    same object."""
    return graphs.graphs.keys() == held.keys() and all(
        graphs.graphs[key] is g for key, g in held.items())


def test_first_calls_are_captured_while_there_is_room():
    graphs = llama._Graphs(budget=10 * llama.GRAPHS, weights=())
    got = [_serve(graphs, (1, t), 10) for t in range(llama.GRAPHS + 2)]
    assert got == ["capture"] * llama.GRAPHS + ["eager"] * 2
    held = dict(graphs.graphs)
    # once the graphs are full, the shapes left out are served eagerly on
    # every call, however often they come, and no held graph changes
    for _ in range(8):
        assert [_serve(graphs, (1, t), 10)
                for t in range(llama.GRAPHS + 2)] == \
            ["replay"] * llama.GRAPHS + ["eager"] * 2
    assert _kept(graphs, held)
    _bounded(graphs)


def test_the_budget_of_bytes_bounds_the_graphs():
    graphs = llama._Graphs(budget=100, weights=())
    assert _serve(graphs, (1, 99), 101) == "eager"  # alone over the budget
    assert [_serve(graphs, (1, t), 40) for t in range(3)] == \
        ["capture", "capture", "eager"]
    assert _serve(graphs, (1, 98), 20) == "capture"  # fits beside them
    held = dict(graphs.graphs)
    for _ in range(8):
        assert [_serve(graphs, (1, t), 40) for t in range(3)] == \
            ["replay", "replay", "eager"]
        assert _serve(graphs, (1, 99), 101) == "eager"
    assert list(graphs.graphs) == [(1, 0), (1, 1), (1, 98)]
    assert _kept(graphs, held)
    _bounded(graphs)


@pytest.mark.parametrize("traffic", ["distinct", "jittered", "cycle"])
def test_many_lengths_keep_the_graphs_and_their_captures_bounded(traffic):
    """Prompts of lengths that never repeat, that repeat now and then (a
    chat mix's classes jittered by up to 64 tokens), or that cycle through
    more shapes than the model holds: the graphs stay within their count
    and bytes, no graph is dropped or replaced, and there are never more
    than ``GRAPHS`` captures."""
    import random
    rng = random.Random(0)
    graphs = llama._Graphs(budget=64 << 20, weights=())
    calls, held = [], {}
    for i in range(5000):
        if traffic == "distinct":
            t = 512 + i
        elif traffic == "jittered":
            t = rng.choice([512] * 4 + [1024] * 3 + [2048] * 2 + [4096]) \
                + rng.randrange(-64, 64)
        else:
            t = 128 * (1 + i % (2 * llama.GRAPHS))
        calls.append(_serve(graphs, (1, t), t * 1024))
        if calls[-1] == "capture":
            held[(1, t)] = graphs.graphs[(1, t)]
        assert _kept(graphs, held)
        _bounded(graphs)
    captures, replays = calls.count("capture"), calls.count("replay")
    assert captures == len(graphs.graphs) <= llama.GRAPHS
    if traffic == "distinct":
        assert captures == llama.GRAPHS and replays == 0



# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _replayed(model, tokens) -> bool:
    return model._graphs is not None and (
        tuple(tokens.shape), tokens.dtype, tokens.device) \
        in model._graphs.graphs


@pytest.mark.cuda
@pytest.mark.parametrize("width, length", [
    ("tiny", 128), ("tiny", 256), ("tiny", 1024),
    ("mistral", 512), ("mistral", 1024), ("mistral", 2048),
    ("tiny-f32", 256), ("mistral-f32", 512)])
def test_replayed_logits_are_the_eager_logits_bit_for_bit(width, length):
    """In bf16 and in f32, where K1's split-TF32 kernel is captured."""
    device = _card()
    cfg = llama.LlamaConfig.tiny() if width.startswith("tiny") \
        else MISTRAL_L2
    if width.endswith("f32"):
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    model = _model(cfg, device)
    tokens = _tokens(cfg, (1, length), device)
    with torch.inference_mode():
        assert not _replayed(model, tokens)
        eager = model(tokens)  # the shape's first call, then its capture
        assert _replayed(model, tokens)
        replayed = [model(tokens) for _ in range(2)]
        functional = llama.forward(model.params(), tokens, cfg,
                                   fa.flash_attention)
    assert replayed[0].dtype == torch.float32
    for got in replayed:
        assert torch.equal(got, eager) and torch.equal(got, functional)


@pytest.mark.cuda
def test_logits_returned_stay_as_they_were_after_later_calls():
    device = _card()
    cfg = MISTRAL_L2
    model = _model(cfg, device)
    first, second = (_tokens(cfg, (1, 512), device, seed=s) for s in (2, 3))
    with torch.inference_mode():
        model(first)
        held = model(first)
        kept = held.clone()
        other = model(second)
        other_shape = model(_tokens(cfg, (1, 1024), device))
        model(_tokens(cfg, (1, 1024), device, seed=4))
        want = llama.forward(model.params(), second, cfg, fa.flash_attention)
    torch.cuda.synchronize(device)
    assert torch.equal(held, kept)
    assert torch.equal(other, want) and not torch.equal(other, held)
    assert other_shape.shape == (1, 1024, cfg.vocab_size)
    assert len(model._graphs.graphs) == 2


@pytest.mark.cuda
def test_k1_counts_eager_launches_and_a_trace_shows_replayed_ones():
    """K1 counts the launches of the shape's eager first call; its capture
    and the replays count none, and the profiler sees K1's kernel once a
    layer in each replay."""
    device = _card()
    cfg = llama.LlamaConfig.tiny()
    model = _model(cfg, device)
    tokens = _tokens(cfg, (2, 256), device)
    with torch.inference_mode():
        before = dict(fa.launches)
        model(tokens)  # eager, then the capture
        assert fa.launches == {**before, "bf16": before["bf16"]
                               + cfg.n_layers}
        assert _replayed(model, tokens)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                model(tokens)
            torch.cuda.synchronize(device)
    assert fa.launches == {**before, "bf16": before["bf16"] + cfg.n_layers}
    k1 = [e for e in prof.events() if "flash_fwd" in e.name]
    assert len(k1) == 3 * cfg.n_layers, [e.name for e in k1]


@pytest.mark.cuda
def test_weights_loaded_in_place_are_replayed_and_replaced_ones_recaptured():
    device = _card()
    cfg = llama.LlamaConfig.tiny()
    model = _model(cfg, device)
    tokens = _tokens(cfg, (1, 128), device)
    with torch.no_grad():
        model(tokens)
        model.lm_head.mul_(-1)  # in place: the graph reads it
        got = model(tokens)
        assert torch.equal(got, llama.forward(model.params(), tokens, cfg,
                                              fa.flash_attention))
        model.lm_head.data = model.lm_head.data * 2  # a new tensor
        got = model(tokens)
        want = llama.forward(model.params(), tokens, cfg, fa.flash_attention)
        assert torch.equal(got, want)
        assert torch.equal(model(tokens), want)  # the new graph's replay


@pytest.mark.cuda
def test_a_replay_reads_nothing_back_on_the_card():
    device = _card()
    cfg = MISTRAL_L2
    model = _model(cfg, device)
    tokens = _tokens(cfg, (1, 512), device)
    with torch.inference_mode():
        model(tokens)
        model(tokens)
        torch.cuda.synchronize(device)
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits = model(tokens)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert logits.shape == (1, 512, cfg.vocab_size)


@pytest.mark.cuda
def test_a_traced_replay_holds_the_eager_call_s_device_operations():
    """The profiler sees the graph's kernels inside the replay's
    ``llama.forward`` span: as many device operations as an eager call
    of ``forward`` on the same weights and the copy of the tokens, and
    the span counts ``graph``."""
    from test_torch_trace import card_trace, inside

    device = _card()
    cfg = MISTRAL_L2
    model = _model(cfg, device)
    tokens = _tokens(cfg, (1, 512), device)
    with torch.inference_mode():
        model(tokens)
    counts = {}
    for name, serve in (("replay", model), ("eager", lambda t: llama.forward(
            model.params(), t, cfg, fa.flash_attention))):
        spans, ops = card_trace(serve, tokens)
        (span,) = [s for s in spans if s.name == "llama.forward"]
        assert span.counts.get(llama.GRAPH_COUNTER) == \
            (1 if name == "replay" else None)
        counts[name] = len(inside(span, ops))
    assert counts["eager"] > 60 * cfg.n_layers
    assert counts["replay"] == counts["eager"] + 1, counts


@pytest.mark.cuda
def test_many_lengths_keep_the_card_s_graphs_and_memory_bounded():
    """Prompts of 40 lengths up to 5120, each served twice a time, among
    four lengths served often: the model captures ``GRAPHS`` of the
    lengths and no more, within their budget, keeps every graph it
    captured unchanged, and the card's memory reserved once every length
    has been served grows no further than the largest shape's logits."""
    device = _card()
    cfg = MISTRAL_L2
    model = _model(cfg, device)
    hot = [_tokens(cfg, (1, 256 * k), device) for k in (1, 2, 3, 4)]
    reserved, held = [], {}
    with torch.inference_mode():
        for r in range(10):
            for i in range(8):
                for tokens in hot:
                    model(tokens)
                t = 128 * (1 + (8 * r + i) % 40)
                for _ in range(2):
                    model(_tokens(cfg, (1, t), device, seed=t))
                graphs = model._graphs
                # every graph captured so far is still held, unchanged
                assert all(graphs.graphs.get(key) is g
                           for key, g in held.items())
                held.update(graphs.graphs)
            torch.cuda.synchronize(device)
            assert len(held) <= llama.GRAPHS
            assert graphs.held() <= graphs.budget
            reserved.append(torch.cuda.memory_reserved(device))
    # the first 32 lengths' logits fit the budget: the cache is full and
    # the 8 longest lengths were served eagerly on every call
    assert len(held) == llama.GRAPHS, sorted(held)
    largest = 5120 * cfg.vocab_size * cfg.dtype.itemsize
    assert reserved[-1] <= reserved[4] + largest, reserved
