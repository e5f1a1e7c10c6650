"""The plain references against the port at tiny sizes on the CPU, with
the port computing in float32 so that the two differ by the order of
float32 sums alone."""

import dataclasses

import pytest
import torch

from portbench import port, weights
from portbench.model_config import model_shape
from portbench.reference import allreduce, llama as ref_llama
from portbench.reference import train as ref_train
from portbench.tests.tiny import TINY_MODEL, TINY_MIXES

SEED = 2 ** 33 + 21


def tiny_f32():
    from brpc_tpu_torch.models import llama

    m = model_shape(TINY_MODEL)
    cfg = dataclasses.replace(port.llama_config(m, TINY_MODEL),
                              dtype=torch.float32)
    return m, cfg, llama


def test_forward_matches_the_port():
    m, cfg, llama = tiny_f32()
    w = weights.llama_weights(m, SEED, "cpu")
    tokens = weights.token_ids(m.vocab, (2, 96), SEED, "cpu", "test")
    got = llama.forward(w, tokens, cfg)
    positions = torch.tensor([0, 5, 47, 95])
    for b in range(2):
        want = ref_llama.logits_at(w, tokens[b], positions, m)
        torch.testing.assert_close(got[b, positions], want, rtol=0,
                                   atol=2e-5)


def test_blocked_attention_matches_one_block(monkeypatch):
    m = model_shape(TINY_MODEL)
    w = weights.llama_weights(m, SEED, "cpu")
    tokens = weights.token_ids(m.vocab, (128,), SEED, "cpu", "blocks")
    positions = torch.arange(128)
    whole = ref_llama.logits_at(w, tokens, positions, m)
    monkeypatch.setattr(ref_llama, "SCORE_BLOCK_BYTES", 4 * m.heads * 128 * 24)
    monkeypatch.setattr(ref_llama, "MLP_BLOCK_ROWS", 40)
    blocked = ref_llama.logits_at(w, tokens, positions, m)
    torch.testing.assert_close(blocked, whole, rtol=0, atol=2e-5)


def test_training_matches_the_port():
    from brpc_tpu_torch import optim

    m, cfg, llama = tiny_f32()
    mix = TINY_MIXES["tiny_train"]
    batches = list(weights.token_ids(m.vocab, (3, 2, 64), SEED, "cpu",
                                     "train"))
    want = ref_train.follow(m, SEED, batches, mix, "cpu")
    params = llama.trainable(weights.llama_weights(m, SEED, "cpu"))
    opt = optim.adamw(params, mix["lr"])
    step = llama.make_train_step(cfg, opt)
    leaves = weights.flat_leaves(params)
    losses = []
    for i, tokens in enumerate(batches):
        losses.append(step(params, tokens).item())
        if i == 0:
            grads = [ref_train.norm(opt.state[p]["exp_avg"]) / 0.1
                     for p in leaves]
    changes = [ref_train.norm(p.detach() - weights.llama_leaf(m, n, SEED,
                                                              "cpu"))
               for n, p in zip(weights.leaf_names(m), leaves)]
    assert losses == pytest.approx(want["losses"], abs=1e-5)
    assert grads == pytest.approx(want["grad_norms"], rel=1e-4)
    assert changes == pytest.approx(want["change_norms"], rel=1e-2)


def test_ordered_sum_is_the_fabric_rule():
    from brpc_tpu_torch.ops import device_programs

    xs = [torch.randn(5000, generator=torch.Generator().manual_seed(i))
          for i in range(4)]
    xs[1][:3] = torch.tensor([-0.0, 1e-40, 3e38])
    xs[2][2] = 3e38
    want = device_programs.all_reduce_sum_reference(xs)[0]
    got = allreduce.ordered_sum(xs)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    low = allreduce.ordered_sum(xs, torch.bfloat16)
    assert not torch.equal(low, got)


def test_e4m3_rounds_within_its_step():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    q = ref_llama.e4m3(x)
    scale = x.abs().max() / 448
    assert not torch.equal(q, x)
    # e4m3 keeps 3 mantissa bits: a relative step of 2**-3 above its
    # subnormals
    normal = x.abs() >= 2 ** -6 * scale
    assert ((q - x).abs()[normal] <= 2 ** -4 * x.abs()[normal]).all()
