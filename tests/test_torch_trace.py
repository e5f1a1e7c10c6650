"""The port's spans: ``obs.rpcz`` ids, clock and capture store, and the
model path's spans (``llama.forward``, ``train.*``).

Every case but the last runs on the CPU with ``torch.profiler`` started
for CPU activity; the last (``cuda``) holds a served request to no weight
cast at all on the card.
"""

import dataclasses
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from brpc_tpu_torch import obs, optim
from brpc_tpu_torch.models import llama, mla
from brpc_tpu_torch.obs import rpcz
from brpc_tpu_torch.ops import flash_attention as fa


def _model_and_tokens(device="cpu", seed=0):
    cfg = llama.LlamaConfig.tiny()
    g = torch.Generator(device=device).manual_seed(seed)
    params = llama.init_params(cfg, generator=g, device=device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                           device=device)
    return cfg, params, tokens


def _traced(fn):
    """``fn()`` under the profiler; (its result, the spans captured, the
    host clock before and after)."""
    rpcz.clear()
    start = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    end = time.time_ns()
    return out, rpcz.captured(start, end), start, end


def _train_step(cfg, params):
    params = llama.trainable(params)
    opt = optim.adamw(params, 1e-3)
    return params, llama.make_train_step(cfg, opt)


@pytest.fixture(autouse=True)
def _clean_rpcz():
    rpcz.clear()
    yield
    rpcz.clear()


def test_untraced_model_path_makes_no_span_and_launches_nothing(
        monkeypatch):
    made = []

    class Counted(rpcz.Span):
        def __post_init__(self):
            made.append(self)

    monkeypatch.setattr(rpcz, "Span", Counted)
    monkeypatch.setattr(torch.cuda, "_sleep",
                        lambda *a, **k: made.append("marker kernel"))
    cfg, params, tokens = _model_and_tokens()
    ring = len(rpcz.default_ring())
    llama.LlamaModel(cfg, params)(tokens)
    params, step = _train_step(cfg, params)
    step(params, tokens)
    assert made == []
    assert len(rpcz.default_ring()) == ring
    assert rpcz._capture is None and rpcz.captured() == []


def test_observability_off_records_nothing_under_the_profiler():
    cfg, params, tokens = _model_and_tokens()
    obs.set_enabled(False)
    try:
        _, spans, _, _ = _traced(lambda: llama.LlamaModel(cfg, params)(
            tokens))
    finally:
        obs.set_enabled(True)
    assert spans == []


def test_forward_records_its_span_and_one_cast_span_a_layer_and_the_head():
    """The functional ``forward`` on f32 weights casts each layer's
    weights and the head's inside its one ``llama.forward`` span, and
    records no other span."""
    cfg, params, tokens = _model_and_tokens()
    assert params["lm_head"].dtype == torch.float32 != cfg.dtype
    _, spans, start, end = _traced(lambda: llama.forward(params, tokens,
                                                         cfg))
    (root,) = spans
    assert root.name == "llama.forward" and root.counts == {}
    assert root.parent_id == 0 and root.trace_id != root.span_id
    assert start <= root.start_ns <= root.end_ns <= end
    assert root.device is None and root.device_start_ns is None  # the CPU


def test_a_served_call_records_its_span_and_casts_nothing():
    cfg, params, tokens = _model_and_tokens()
    model = llama.LlamaModel(cfg, params)
    _, spans, _, _ = _traced(lambda: model(tokens))
    assert [s.name for s in spans] == ["llama.forward"]


def test_train_step_holds_forward_backward_and_optimizer_in_order():
    cfg, params, tokens = _model_and_tokens()
    params, step = _train_step(cfg, params)
    _, spans, _, _ = _traced(lambda: step(params, tokens))
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    assert set(by_name) == {"train.forward", "train.backward",
                            "train.optimizer", "llama.forward"}
    phases = [by_name[f"train.{p}"][0]
              for p in ("forward", "backward", "optimizer")]
    assert all(len(by_name[s.name]) == 1 for s in phases)
    assert all(s.parent_id == 0 for s in phases)
    assert len({s.trace_id for s in phases}) == 3
    edges = []
    for s in phases:
        edges += [s.start_ns, s.end_ns]
    assert edges == sorted(edges)
    (forward,) = by_name["llama.forward"]
    assert (forward.trace_id, forward.parent_id) == (phases[0].trace_id,
                                                     phases[0].span_id)
    assert phases[0].start_ns <= forward.start_ns <= forward.end_ns \
        <= phases[0].end_ns


@pytest.mark.parametrize("k1", [False, True])
def test_train_forward_counts_the_layers_whose_attention_ran_k1(
        monkeypatch, k1):
    """``train.forward`` counts ``K1_TRAIN_COUNTER`` once a layer whose
    attention the rule sent to K1 (on the CPU only where ``fa.trains`` is
    made to say so; the CPU's plain version then runs), and nothing where
    every layer ran dense attention."""
    if k1:
        monkeypatch.setattr(fa, "trains", lambda q: True)
    cfg, params, tokens = _model_and_tokens()
    params, step = _train_step(cfg, params)
    _, spans, _, _ = _traced(lambda: step(params, tokens))
    (forward,) = [s for s in spans if s.name == "train.forward"]
    assert forward.counts == ({llama.K1_TRAIN_COUNTER: cfg.n_layers}
                              if k1 else {})
    assert all(s.counts == {} for s in spans if s is not forward)
    step(params, tokens)  # untraced: no span, so nothing to count on


def _latent_expert_model(shared=2):
    """A tiny DeepSeek-V2 config (latent attention, one dense layer, then
    two expert layers) and its params."""
    cfg = llama.LlamaConfig(
        vocab_size=256, hidden=64, n_layers=3, n_heads=2, n_kv_heads=2,
        head_dim=24, intermediate=96, n_experts=4, experts_per_token=2,
        first_dense_layers=1, expert_intermediate=32,
        n_shared_experts=shared, norm_topk_prob=False, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        rope_scaling=mla.Yarn(40.0, 4096, mscale=0.707,
                              mscale_all_dim=0.707))
    g = torch.Generator().manual_seed(3)
    return cfg, llama.init_params(cfg, generator=g, device="cpu")


def test_latent_attention_records_one_latent_span_a_layer_counting_rows():
    """``mla.latent`` opens once a layer, a child of ``llama.forward``,
    counting the rows (B·T) it projected; each expert layer's
    ``moe.experts`` counts the rows its shared experts ran."""
    cfg, params = _latent_expert_model()
    tokens = torch.randint(0, 256, (2, 16),
                           generator=torch.Generator().manual_seed(4))
    model = llama.LlamaModel(cfg, params)
    _, spans, _, _ = _traced(lambda: model(tokens))
    (forward,) = [s for s in spans if s.name == "llama.forward"]
    latent = [s for s in spans if s.name == "mla.latent"]
    assert len(latent) == cfg.n_layers
    assert all(s.counts == {mla.ROWS_COUNTER: 32} for s in latent)
    assert all(s.parent_id == forward.span_id for s in latent)
    experts = [s for s in spans if s.name == "moe.experts"]
    assert len(experts) == cfg.n_layers - cfg.first_dense_layers
    assert all(s.counts == {"shared": 32} for s in experts)


def test_an_expert_layer_without_shared_experts_counts_none():
    cfg, params = _latent_expert_model(shared=0)
    cfg = dataclasses.replace(cfg, first_dense_layers=0)
    params = llama.init_params(cfg, generator=torch.Generator()
                               .manual_seed(5), device="cpu")
    tokens = torch.randint(0, 256, (1, 8),
                           generator=torch.Generator().manual_seed(6))
    _, spans, _, _ = _traced(lambda: llama.forward(params, tokens, cfg))
    experts = [s for s in spans if s.name == "moe.experts"]
    assert len(experts) == cfg.n_layers
    # on the CPU the grouped products count no kernels either
    assert all(s.counts == {"shared": 0} for s in experts)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tracing_changes_no_result(dtype):
    cfg, params, tokens = _model_and_tokens()
    cfg = dataclasses.replace(cfg, dtype=dtype)
    runs = []
    for traced in (False, True):
        fresh = llama.trainable(
            {"embed": params["embed"].clone(),
             "layers": {k: v.clone() for k, v in params["layers"].items()},
             "final_norm": params["final_norm"].clone(),
             "lm_head": params["lm_head"].clone()})
        step = llama.make_train_step(cfg, optim.adamw(fresh, 1e-3))

        def work(p=fresh, step=step):
            with torch.no_grad():
                logits = llama.forward(p, tokens, cfg)
            return logits, step(p, tokens), p

        if traced:
            (logits, loss, after), spans, _, _ = _traced(work)
            assert spans
        else:
            logits, loss, after = work()
        runs.append((logits, loss, after))
    (l0, loss0, p0), (l1, loss1, p1) = runs
    assert torch.equal(l0, l1) and torch.equal(loss0, loss1)
    for name in ("embed", "final_norm", "lm_head"):
        assert torch.equal(p0[name], p1[name])
    for name, w in p0["layers"].items():
        assert torch.equal(w, p1["layers"][name])


def test_the_capture_keeps_every_span_while_the_ring_stays_bounded():
    n = rpcz.DEFAULT_CAPACITY + 500

    def work():
        for i in range(n):
            with rpcz.trace("work", f"m{i}"):
                pass
        with obs.span("user", "outer"):
            pass

    _, spans, _, _ = _traced(work)
    assert [s.method for s in spans] == [f"m{i}" for i in range(n)] \
        + ["outer"]
    assert len(rpcz.default_ring()) == rpcz.default_ring().capacity
    # read again: the same spans; the next traced span opens a new capture
    assert len(rpcz.captured()) == n + 1
    _, again, _, _ = _traced(work)
    assert len(again) == n + 1 and again[0] is not spans[0]


def test_user_and_rpc_spans_stamp_the_profiler_clock_with_ids():
    from brpc_tpu_torch import rpc

    assert rpcz.clock_ns is time.time_ns
    before = time.time_ns()
    with obs.span("User", "outer") as outer:
        t0 = time.monotonic_ns()
        time.sleep(0.002)
        rpc._record_client_call("Echo", "Echo", "peer", t0, time.time(), 3,
                                4, 0, "")
    rpc._record_server_call("Echo", "Echo", t0, time.time(), 3, 4, None)
    after = time.time_ns()
    spans = list(rpcz.default_ring()._ring)[-3:]
    client, user, server = spans
    assert (client.side, user.side, server.side) == ("client", "user",
                                                     "server")
    for s in spans:
        assert before <= s.start_ns <= s.end_ns <= after
        assert s.end_ns - s.start_ns >= 2_000_000 or s is server
    assert (client.trace_id, client.parent_id) == (outer.trace_id,
                                                   outer.span_id)
    assert user.parent_id == 0 and server.parent_id == 0
    assert server.trace_id not in (user.trace_id, client.trace_id)
    assert rpcz.dump_rpcz(limit=1)[0].keys() == {
        "service", "method", "side", "peer", "request_bytes",
        "response_bytes", "start_ns", "end_ns", "wall_time", "latency_us",
        "error_code", "error_text", "annotations"}


class _Marked:
    """Stands for a tensor on a CUDA device."""

    is_cuda = True


def test_marked_spans_lie_between_their_marker_kernels(monkeypatch):
    launched, device = [], [0]
    monkeypatch.setattr(torch.cuda, "current_device", lambda: device[0])
    monkeypatch.setattr(torch.cuda, "_sleep",
                        lambda cycles: launched.append((device[0], cycles)))

    def work():
        with rpcz.trace("llama", "forward", mark=_Marked()):
            for n in (1, 0):
                # counts the kernels it launches: no marker at its end
                with rpcz.trace("moe", "experts", mark=_Marked()) as sp:
                    sp.count("kernels", n)
        device[0] = 1
        with rpcz.trace("train", "optimizer", mark=_Marked()):
            pass
        with rpcz.trace("train", "step"):  # unmarked: launches nothing
            pass

    _, spans, start, end = _traced(work)
    assert launched == [(0, 0)] * 4 + [(1, 0)] * 2
    # the trace: markers (spin_kernel) interleaved with the work, in the
    # order of launch, plus a kernel on card 1 between its two markers;
    # the device ran them after the host launched them all
    us = 1000

    def at(t):
        return end + t * us

    marker = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    kernels = [(0, marker, at(0), at(2)), (0, marker, at(10), at(12)),
               (0, "copy", at(12), at(20)), (0, marker, at(30), at(32)),
               (0, "add", at(50), at(60)), (0, marker, at(60), at(62)),
               (1, marker, at(5), at(6)), (1, "adam", at(6), at(9)),
               (1, marker, at(9), at(10))]
    got = {s.span_id: s for s in rpcz.captured(start, end, kernels)}
    moe1, moe2, forward, opt, step = [got[s.span_id] for s in spans]
    assert (forward.name, moe1.name, opt.name, step.name) == (
        "llama.forward", "moe.experts", "train.optimizer", "train.step")
    assert (forward.device_start_ns, forward.device_end_ns) == (at(2),
                                                                at(60))
    assert (moe1.device_start_ns, moe1.device_end_ns) == (at(12), at(20))
    assert (moe2.device_start_ns, moe2.device_end_ns) == (at(32), at(32))
    assert (opt.device, opt.device_start_ns, opt.device_end_ns) == (
        1, at(6), at(9))
    assert step.device is None and step.device_start_ns is None
    # the profiler lost card 0's first marker: the markers found line up
    # with the last launches, and the forward, which began at the lost
    # one, gets no interval
    rpcz.captured(start, end, kernels[1:])
    assert forward.device_start_ns is None
    assert (moe1.device_start_ns, moe1.device_end_ns) == (at(12), at(20))
    # a counted span whose kernels run into the next marker gets none
    rpcz.captured(start, end, kernels[:2] + kernels[3:])
    assert moe1.device_start_ns is None
    assert (moe2.device_start_ns, forward.device_end_ns) == (at(32),
                                                             at(60))
    # a marker the program did not launch: card 0 gets nothing
    rpcz.captured(start, end, kernels + [(0, marker, at(70), at(71))])
    assert moe1.device_start_ns is None and moe2.device_end_ns is None
    assert opt.device_start_ns == at(6)


def card_trace(serve, tokens):
    """One traced call of ``serve(tokens)`` on the card under the profiler
    (CPU and CUDA, shapes recorded), under ``inference_mode``. Returns the
    spans captured, with their device intervals, and the device operations,
    markers aside, each as ``(midpoint_ns, name, weight_cast)``. A weight
    cast is a kernel launched by an f32 → bf16 ``aten::copy_`` of a tensor
    of at most two dimensions: weights are [in, out] or [h], activations
    have three or more."""
    from torch.autograd import DeviceType

    rpcz.clear()
    torch.cuda.synchronize()
    start = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        with torch.inference_mode():
            # the profiler can lose a session's first kernel records (up
            # to 9 on an H100): these go first, so the call's are kept
            pad = torch.zeros(1, device=tokens.device)
            for _ in range(16):
                pad.add_(1)
            serve(tokens)
        torch.cuda.synchronize()
    end = time.time_ns()
    events = list(prof.profiler.kineto_results.events())
    device = [e for e in events if e.device_type() == DeviceType.CUDA
              and not e.is_user_annotation()]
    spans = rpcz.captured(start, end, [
        (e.device_index(), e.name(), e.start_ns(), e.end_ns())
        for e in device])
    # the ops' ids: CUDA runtime calls carry ids of another numbering
    ops = {e.correlation_id(): e for e in events
           if e.device_type() == DeviceType.CPU
           and e.name().startswith("aten::")}

    def weight_cast(e):
        op = ops.get(e.linked_correlation_id())
        return op is not None and op.name() == "aten::copy_" \
            and list(op.dtypes()[:2]) == ["c10::BFloat16", "float"] \
            and len(op.shapes()[1]) <= 2

    return spans, [((e.start_ns() + e.end_ns()) / 2, e.name()[:80],
                    weight_cast(e))
                   for e in device if not rpcz.is_marker(e.name())]


def inside(s, ops) -> list:
    """The operations of ``card_trace`` whose midpoint lies in the marked
    span ``s``'s device interval."""
    if s.device_start_ns is None:
        return []
    return [op for op in ops if s.device_start_ns <= op[0]
            <= s.device_end_ns]


def _card_model_and_forward():
    from brpc_tpu_torch.ops.flash_attention import flash_attention

    cfg, params, tokens = _model_and_tokens("cuda")
    model = llama.LlamaModel(cfg, params, attn_fn=flash_attention)

    def functional(t):
        return llama.forward(params, t, cfg, flash_attention)

    with torch.inference_mode():
        model(tokens)  # builds and loads the kernel
        functional(tokens)
    return cfg, model, functional, tokens


@pytest.mark.cuda
def test_a_served_request_casts_no_weight_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, model, functional, tokens = _card_model_and_forward()
    # a shape's first call runs eagerly; the warm-up's shape replays
    fresh = llama.LlamaModel(cfg, model.params(), attn_fn=model.attn_fn)
    kernels = []
    for serve in (fresh, model, functional):
        spans, ops = card_trace(serve, tokens)
        (forward,) = [s for s in spans if s.name == "llama.forward"]
        if serve is not functional:
            assert [op for op in ops if op[2]] == []
        kernels.append(len(inside(forward, ops)))
    eager, replay, want = kernels
    assert want - eager == 9 * cfg.n_layers + 2
    assert replay == eager + 1  # and the copy of the tokens into the graph
