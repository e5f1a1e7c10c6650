"""The port's training against the reference's, on the CPU.

The reference's ``init_params(PRNGKey(0), tiny(...))`` is loaded into the
port through ``params_from_jax``; both sides get the same tokens, drawn
with numpy, and the same optimizer settings. Tolerances, each with its
reason and the gap measured on this tree:

- gradients at f32 compute, dense: ``1e-5 * max|g_ref|`` per leaf, the
  same arithmetic summed in another order (measured: at most 9.8e-7 of
  max|g_ref|; the losses were equal);
- gradients at bf16 compute: loss within 0.1, as the forward's test
  (measured 3.8e-4), and a cosine of at least 0.99 per leaf (measured: at
  least 0.99988);
- the optimizer alone on equal gradients: params within 2e-6 absolute at
  |p| <= 4 (measured 7.2e-7);
- one SGD step at f32 compute: loss and params within 1e-5 (measured
  4.8e-7 and 1.5e-8);
- the single-device half of ``dryrun_multichip`` at its default bf16
  compute: that test's own gates, loss rtol/atol 2e-3 and params 5e-3
  (measured 0.0102 and 2.0e-3: after one AdamW step a param moves by about
  the learning rate in the direction of its gradient's sign, and bf16
  flips the sign of some gradients near zero);
- eleven AdamW steps at f32 compute: every loss within 1e-3 of the
  reference's (measured 1.4e-5).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from brpc_tpu.models import llama as ref
from brpc_tpu_torch import optim
from brpc_tpu_torch.models import llama
from brpc_tpu_torch.models.convert import params_from_jax
from brpc_tpu_torch.utils import checkpoint
from brpc_tpu_torch.utils.tree import tree_leaves, tree_map

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _ref_params(vocab_size=512):
    params = ref.init_params(jax.random.PRNGKey(0),
                             ref.LlamaConfig.tiny(vocab_size))
    return jax.tree_util.tree_map(np.asarray, params)


def _configs(dtype="f32", vocab_size=512):
    jdt, tdt = _DTYPES[dtype]
    return (dataclasses.replace(ref.LlamaConfig.tiny(vocab_size), dtype=jdt),
            dataclasses.replace(llama.LlamaConfig.tiny(vocab_size),
                                dtype=tdt))


def _port_params(cfg):
    return llama.trainable(params_from_jax(_ref_params(cfg.vocab_size), cfg,
                                           "cpu"))


def _tokens(shape=(2, 32), seed=0, vocab_size=512):
    return np.random.default_rng(seed).integers(0, vocab_size, shape,
                                                np.int32)


def _assert_tree_close(got, want, atol):
    got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(),
                                   np.asarray(w, np.float32), atol=atol,
                                   rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_loss_gradients_match_reference(dtype):
    ref_cfg, cfg = _configs(dtype)
    tokens = _tokens()
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p, t: ref.loss_fn(p, t, ref_cfg)))(_ref_params(),
                                                  jnp.asarray(tokens))
    params = _port_params(cfg)
    loss = llama.loss_fn(params, torch.from_numpy(tokens), cfg)
    loss.backward()
    got = tree_leaves(params)
    want = jax.tree_util.tree_leaves(want_grads)
    assert len(got) == len(want) == 12
    if dtype == "f32":
        assert abs(loss.item() - float(want_loss)) <= 1e-5
    else:
        assert abs(loss.item() - float(want_loss)) <= 0.1
    for p, w in zip(got, want):
        g, w = p.grad.numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape
        if dtype == "f32":
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())
        else:
            cos = (g * w).sum() / np.linalg.norm(g) / np.linalg.norm(w)
            assert cos >= 0.99


def test_adamw_equals_optax_on_equal_gradients():
    """Three gradient trees of magnitudes 1e-9 to 1e-1 through
    ``optax.adamw(1e-3)`` and the port's ``adamw``."""
    rng = np.random.default_rng(4)
    init = {"a": rng.uniform(-4, 4, (64, 32)).astype(np.float32),
            "b": {"c": rng.standard_normal((128,)).astype(np.float32),
                  "d": np.ones((16, 8), np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda x, i=i: (rng.standard_normal(x.shape)
                        * 10.0 ** rng.integers(-9, 0, x.shape)
                        ).astype(np.float32), init) for i in range(3)]

    opt = optax.adamw(1e-3)
    want = jax.tree_util.tree_map(jnp.asarray, init)
    state = opt.init(want)
    for g in grads:
        updates, state = opt.update(g, state, want)
        want = optax.apply_updates(want, updates)

    params = llama.trainable(tree_map(torch.from_numpy, init))
    port = optim.adamw(params, 1e-3)
    for g in grads:
        for p, gp in zip(tree_leaves(params), jax.tree_util.tree_leaves(g)):
            p.grad = torch.from_numpy(gp)
        port.step()
    assert all(abs(p).max() <= 4 for p in tree_leaves(init))
    _assert_tree_close(params, want, 2e-6)


def test_adamw_matches_optax_defaults():
    opt = optim.adamw({"w": torch.zeros(2, requires_grad=True)}, 3e-4)
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (3e-4, (0.9, 0.999), 1e-8, 1e-4)
    assert not group["amsgrad"] and not group["fused"]
    sgd = optim.sgd({"w": torch.zeros(2, requires_grad=True)}, 1e-2)
    assert sgd.param_groups[0]["momentum"] == 0


def test_sgd_step_matches_reference():
    """One step of ``make_train_step`` with ``sgd(1e-2)`` at f32 compute:
    the single-device half of ``tests/test_llama.py``'s sharded test."""
    ref_cfg, cfg = _configs("f32", vocab_size=64)
    tokens = _tokens((8, 16), seed=3, vocab_size=64)
    opt = optax.sgd(1e-2)
    ref_step = jax.jit(ref.make_train_step(ref_cfg, opt))
    want_params, _, want_loss = ref_step(
        _ref_params(64), opt.init(_ref_params(64)), jnp.asarray(tokens))

    params = _port_params(cfg)
    step = llama.make_train_step(cfg, optim.sgd(params, 1e-2))
    loss = step(params, torch.from_numpy(tokens))
    assert loss.dtype == torch.float32 and loss.grad_fn is None
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    _assert_tree_close(params, want_params, 1e-5)
    assert all(p.grad is None for p in tree_leaves(params))


def test_single_device_half_of_dryrun_multichip():
    """``__graft_entry__.dryrun_multichip``'s reference step on one device:
    ``tiny(vocab_size=256)`` at its default bf16 compute, ``adamw(1e-3)``,
    zero tokens (2, 32), one step, at that test's gates."""
    ref_cfg = ref.LlamaConfig.tiny(vocab_size=256)
    cfg = llama.LlamaConfig.tiny(vocab_size=256)
    tokens = np.zeros((2, 32), np.int32)
    opt = optax.adamw(1e-3)
    ref_step = jax.jit(ref.make_train_step(ref_cfg, opt))
    want_params, _, want_loss = ref_step(
        _ref_params(256), opt.init(_ref_params(256)), jnp.asarray(tokens))

    params = _port_params(cfg)
    loss = llama.make_train_step(cfg, optim.adamw(params, 1e-3))(
        params, torch.from_numpy(tokens))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-3,
                               atol=2e-3)
    for got, want in zip(tree_leaves(params),
                         jax.tree_util.tree_leaves(want_params)):
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(want, np.float32), rtol=5e-3,
                                   atol=5e-3)


def _ten_adamw_losses_ref(ref_cfg, tokens):
    opt = optax.adamw(3e-3)
    step = jax.jit(ref.make_train_step(ref_cfg, opt))
    params = _ref_params(64)
    state = opt.init(params)
    losses = []
    for _ in range(11):
        params, state, loss = step(params, state, jnp.asarray(tokens))
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_train_step_reduces_loss(dtype):
    """``tests/test_llama.py``'s ``test_train_step_reduces_loss``: vocab 64,
    ``adamw(3e-3)``, a first step and ten more on the same batch. At f32
    compute every loss is also held to the reference's."""
    ref_cfg, cfg = _configs(dtype, vocab_size=64)
    tokens = _tokens((4, 32), seed=2, vocab_size=64)
    params = _port_params(cfg)
    step = llama.make_train_step(cfg, optim.adamw(params, 3e-3))
    t = torch.from_numpy(tokens)
    losses = [step(params, t).item() for _ in range(11)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    if dtype == "f32":
        np.testing.assert_allclose(losses,
                                   _ten_adamw_losses_ref(ref_cfg, tokens),
                                   rtol=0, atol=1e-3)


def test_loss_graph_has_no_select_backward():
    """The layer loop unbinds each stacked leaf once: no ``w[i]``, whose
    backward would zero-fill a whole stack for every layer."""
    _, cfg = _configs("f32")
    loss = llama.loss_fn(_port_params(cfg), torch.from_numpy(_tokens()), cfg)
    seen, stack, names = set(), [loss.grad_fn], set()
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        stack.extend(fn for fn, _ in node.next_functions)
    assert "UnbindBackward0" in names
    assert "SelectBackward0" not in names


def test_trainable_shares_storage_and_requires_grad():
    _, cfg = _configs("f32")
    frozen = params_from_jax(_ref_params(), cfg, "cpu")
    params = llama.trainable(frozen)
    for p, f in zip(tree_leaves(params), tree_leaves(frozen)):
        assert p.requires_grad and p.is_leaf and not f.requires_grad
        assert p.data_ptr() == f.data_ptr()
    # tree_leaves walks keys sorted at every level, as jax.tree_util does
    want = jax.tree_util.tree_leaves(_ref_params())
    assert len(want) == len(tree_leaves(params)) == 12
    for got, w in zip(tree_leaves(params), want):
        np.testing.assert_array_equal(got.detach().numpy(), w)


# -- checkpoints ------------------------------------------------------------

def _train(cfg, params, opt, tokens, steps):
    step = llama.make_train_step(cfg, opt)
    return [step(params, tokens).item() for _ in range(steps)]


def _state(params, opt, step):
    return {"params": params, "opt_state": opt.state_dict(), "step": step}


def test_checkpoint_round_trip_and_retention(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    assert checkpoint.latest_step(ckpt) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(ckpt)
    _, cfg = _configs("f32")
    params = _port_params(cfg)
    opt = optim.adamw(params, 1e-3)
    tokens = torch.from_numpy(_tokens())
    saved = {}
    for step in range(1, 6):
        _train(cfg, params, opt, tokens, 1)
        checkpoint.save_checkpoint(ckpt, step, _state(params, opt, step),
                                   max_to_keep=3)
        saved[step] = [p.detach().clone() for p in tree_leaves(params)]
    assert checkpoint.latest_step(ckpt) == 5
    assert sorted(os.listdir(ckpt)) == ["3", "4", "5"]

    # into a template, at an older step
    fresh = _port_params(cfg)
    fresh_opt = optim.adamw(fresh, 1e-3)
    optim.init_state(fresh_opt)
    got = checkpoint.restore_checkpoint(ckpt, 4,
                                        template=_state(fresh, fresh_opt, 0))
    assert got["step"] == 4 and got["params"] is fresh
    for p, want in zip(tree_leaves(fresh), saved[4]):
        assert torch.equal(p, want)
    fresh_opt.load_state_dict(got["opt_state"])
    assert fresh_opt.state_dict()["state"][0]["step"].item() == 4

    # without a template: the latest step's whole tree, keys as strings
    raw = checkpoint.restore_checkpoint(ckpt)
    assert raw["step"] == 5
    for p, want in zip(tree_leaves(raw["params"]), saved[5]):
        assert torch.equal(p, want)
    moments = raw["opt_state"]["state"]
    assert sorted(moments, key=int) == [str(i) for i in range(12)]
    for i, p in enumerate(tree_leaves(params)):
        assert torch.equal(moments[str(i)]["exp_avg"],
                           opt.state[p]["exp_avg"])
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(ckpt, 1)


def test_resumed_step_equals_uninterrupted(tmp_path):
    """Save after step 2, restore into a fresh template, take step 3: the
    same loss and params, bit for bit, as three steps in one run
    (``tests/test_ps_ckpt.py``'s resume test, on one device)."""
    _, cfg = _configs("f32")
    tokens = torch.from_numpy(_tokens())
    params = _port_params(cfg)
    opt = optim.adamw(params, 1e-3)
    _train(cfg, params, opt, tokens, 2)
    checkpoint.save_checkpoint(str(tmp_path), 2, _state(params, opt, 2))
    want_loss = _train(cfg, params, opt, tokens, 1)

    fresh = _port_params(cfg)
    fresh_opt = optim.adamw(fresh, 1e-3)
    optim.init_state(fresh_opt)
    state = checkpoint.restore_checkpoint(
        str(tmp_path), template=_state(fresh, fresh_opt, 0))
    fresh_opt.load_state_dict(state["opt_state"])
    assert state["step"] == 2
    assert _train(cfg, fresh, fresh_opt, tokens, 1) == want_loss
    for got, want in zip(tree_leaves(fresh), tree_leaves(params)):
        assert torch.equal(got, want)


def test_init_state_moves_no_param():
    _, cfg = _configs("f32")
    params = _port_params(cfg)
    before = [p.detach().clone() for p in tree_leaves(params)]
    opt = optim.adamw(params, 1e-3)
    optim.init_state(opt)
    assert opt.param_groups[0]["lr"] == 1e-3
    for p, b in zip(tree_leaves(params), before):
        assert torch.equal(p, b) and p.grad is None
        assert not opt.state[p]["exp_avg"].any()
