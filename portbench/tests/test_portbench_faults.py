"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run at a tiny size on the CPU, past the look for
a card, with one fault planted in the port where the run's work is
produced, and sees ``correct`` false; the sound run beside it is correct.
The limits are the cells' own (``tiny.TINY_MIXES`` copies them).
"""

import time

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import tiny_root

CPU = [torch.device("cpu")]


def run(tmp_path, cell, chips=1):
    root = tiny_root(tmp_path)
    result, checks, _ = harness.run(root, cell, 2 ** 32 + 77, 0.4, False,
                                 time.perf_counter(), CPU * chips)
    return result, dict((name, value) for name, value, _ in checks)


def test_sound_runs_are_correct(tmp_path):
    for cell, chips in (("tiny.prefill", 1), ("tiny.train", 1),
                        ("tiny.sync", 4)):
        result, _ = run(tmp_path / cell, cell, chips)
        assert result["correct"], result["checks"]


def test_a_served_token_altered(tmp_path, monkeypatch):
    from brpc_tpu_torch.models import llama

    forward = llama.LlamaModel.forward

    def altered(self, tokens):
        logits = forward(self, tokens)
        logits[:, -1, 7] += 100.0  # the last position now serves token 7
        return logits

    monkeypatch.setattr(llama.LlamaModel, "forward", altered)
    result, numbers = run(tmp_path, "tiny.prefill")
    assert not result["correct"] and numbers["served_token_gap"] > 0.5


def test_a_step_that_leaves_its_state_unchanged(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    result, numbers = run(tmp_path, "tiny.train")
    assert not result["correct"]
    # no leaf moves: each change reads 1 against the reference's
    assert numbers["change_norm_gap"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(tmp_path, monkeypatch):
    from brpc_tpu_torch.models import llama

    loss_fn = llama.loss_fn

    def half(params, tokens, cfg, attn_fn=None):
        return loss_fn(params, tokens[: tokens.shape[0] // 2], cfg, attn_fn)

    monkeypatch.setattr(llama, "loss_fn", half)
    result, numbers = run(tmp_path, "tiny.train")
    assert not result["correct"]
    assert numbers["grad_norm_gap"] > 0.1


def test_the_exchange_between_cards_left_out(tmp_path, monkeypatch):
    from brpc_tpu_torch.ops import device_programs

    monkeypatch.setattr(device_programs, "all_reduce_sum",
                        lambda xs: [x.clone() for x in xs])
    result, numbers = run(tmp_path, "tiny.sync", 4)
    assert not result["correct"] and numbers["mismatched_floats"] > 0


def test_an_answer_altered(tmp_path, monkeypatch):
    from brpc_tpu_torch.ops import device_programs

    sound = device_programs.all_reduce_sum

    def altered(xs):
        outs = sound(xs)
        outs[-1][-1] += 1.0
        return outs

    monkeypatch.setattr(device_programs, "all_reduce_sum", altered)
    result, numbers = run(tmp_path, "tiny.sync", 4)
    assert not result["correct"] and numbers["mismatched_floats"] > 0
