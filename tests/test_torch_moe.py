"""The port's MoE layer (``brpc_tpu_torch.models.moe``) against the
reference's (``brpc_tpu.models.moe``).

Params are the reference's ``init_moe_params`` converted through
``moe_params_from_jax``; inputs are ``jax.random`` draws. The twins of
``tests/test_moe.py`` run in the test process on one rank; the expert-
parallel case runs on a gloo world of 8 processes with ``ep=4``
(``tests/torch_world.py``). Tolerances, each with its reason and the gap
measured on this tree:

- one rank against the reference at f32: the output within 1e-5, the
  aux loss within rtol 1e-5, and every gradient of sum(out²) + 0.01·aux
  (the three params and the input) within 1e-5 of its largest element,
  as ``tests/test_torch_train.py`` holds gradients: the same arithmetic in
  another order (measured at most 5.5e-7 of the largest);
- ep=4 against one rank: the reference's own 1e-4 for the output and rtol
  1e-5 for aux (measured 0: each expert's work is the same arithmetic on
  whichever rank it runs, and the all-reduce adds one nonzero term);
- ep=4 against the reference, the output and every gradient: as one
  rank's (measured at most 4.1e-7 of the largest).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world
from brpc_tpu.models import moe as ref
from brpc_tpu_torch.models import moe
from brpc_tpu_torch.models.convert import moe_params_from_jax

WORLD = 8
_REF_CFG = ref.MoeConfig(hidden=32, intermediate=64, n_experts=4,
                         dtype=jnp.float32)
_CFG = moe.MoeConfig(hidden=32, intermediate=64, n_experts=4,
                     dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _ref_params(seed=0, cfg=_REF_CFG):
    params = ref.init_moe_params(jax.random.PRNGKey(seed), cfg)
    return jax.tree_util.tree_map(np.asarray, params)


def _x(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                        jnp.float32))


def _ref_grads(params, x, cfg=_REF_CFG):
    """The reference's output, aux and the gradients of
    sum(out²) + 0.01·aux by params and x."""
    def loss(p, x):
        o, a = ref.moe_layer(p, x, cfg)
        return jnp.sum(o ** 2) + 0.01 * a

    out, aux = ref.moe_layer(params, x, cfg)
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    return np.asarray(out), float(aux), \
        {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx)


def _port_grads(x, cfg=_CFG, ref_cfg=_REF_CFG, seed=0):
    params = {k: v.requires_grad_(True) for k, v in moe_params_from_jax(
        _ref_params(seed, ref_cfg), cfg, "cpu").items()}
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    out, aux = moe.moe_layer(params, xt, cfg)
    (torch.sum(out ** 2) + 0.01 * aux).backward()
    return out.detach().numpy(), aux.item(), \
        {k: p.grad.numpy() for k, p in params.items()}, xt.grad.numpy()


def _assert_close(got, want, atol):
    """The output within ``atol``; each gradient within ``atol`` times
    its largest element (sum(out²) gives gradients of size ~35). Returns
    the largest gap, the gradients' as a share of their largest."""
    out, aux, gp, gx = got
    w_out, w_aux, w_gp, w_gx = want
    np.testing.assert_allclose(out, w_out, rtol=0, atol=atol)
    np.testing.assert_allclose(aux, w_aux, rtol=1e-5)
    gaps = [float(np.abs(out - w_out).max())]
    for name, g, w in [*((k, gp[k], w_gp[k]) for k in w_gp),
                       ("x", gx, w_gx)]:
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=atol * scale,
                                   err_msg=name)
        gaps.append(float(np.abs(g - w).max()) / scale)
    return max(gaps)


def test_moe_forward_shapes_and_grads_match_reference(record_property):
    """tests/test_moe.py:11, and the port against the reference."""
    x = _x(1, (2, 16, 32))
    got = _port_grads(x)
    out, aux, gp, gx = got
    assert out.shape == x.shape and np.isfinite(out).all() and aux > 0
    assert all(np.isfinite(g).all() for g in (*gp.values(), gx))
    record_property("max_abs_err", _assert_close(
        got, _ref_grads(_ref_params(), x), 1e-5))


def test_moe_capacity_overflow_matches_reference(record_property):
    """tests/test_moe.py:30: a capacity so small that most tokens drop
    (cap = int(0.1·64/2) = 3 of 64); dropped tokens give zeros."""
    ref_cfg = ref.MoeConfig(hidden=16, intermediate=32, n_experts=2,
                            capacity_factor=0.1, dtype=jnp.float32)
    cfg = moe.MoeConfig(hidden=16, intermediate=32, n_experts=2,
                        capacity_factor=0.1, dtype=torch.float32)
    x = _x(2, (1, 64, 16))
    got = _port_grads(x, cfg, ref_cfg)
    assert got[0].shape == x.shape
    assert (np.abs(got[0]).sum(-1) == 0).sum() == 64 - 2 * 3
    record_property("max_abs_err", _assert_close(
        got, _ref_grads(_ref_params(0, ref_cfg), x, ref_cfg), 1e-5))


def test_moe_ties_and_bf16_compute_match_reference():
    """Equal gate logits route to the first expert (argmax's first index,
    as jnp's), which keeps its capacity of 8 of the 16 tokens; at bf16
    compute the tanh gelu and the casts follow the reference's: within two
    bf16 steps of outputs under 1, 2**-7 (measured 0.0039, one step)."""
    ref_cfg = ref.MoeConfig(hidden=32, intermediate=64, n_experts=4)
    cfg = moe.MoeConfig(hidden=32, intermediate=64, n_experts=4)
    params = dict(_ref_params(0, ref_cfg))
    params["gate"] = np.zeros_like(params["gate"])  # every logit ties
    x = _x(3, (2, 8, 32))
    want, _ = ref.moe_layer(params, x, ref_cfg)
    got, _ = moe.moe_layer(moe_params_from_jax(params, cfg, "cpu"),
                           torch.from_numpy(x), cfg)
    got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                               atol=2 ** -7)
    assert (np.abs(got).sum(-1) > 0).sum() == 8


def test_moe_param_specs_match_reference():
    want = ref.moe_param_specs()
    got = moe.moe_param_specs()
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}


def test_init_moe_params_draws_from_its_generator():
    a = moe.init_moe_params(_CFG, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    b = moe.init_moe_params(_CFG, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    shapes = {k: v.shape for k, v in _ref_params().items()}
    for k, v in a.items():
        assert tuple(v.shape) == shapes[k] and v.dtype == torch.float32
        assert torch.equal(v, b[k])
    # normal * fan_in**-0.5, as the reference draws them
    assert abs(a["w_in"].std().item() - 32 ** -0.5) < 0.02
    assert abs(a["w_out"].std().item() - 64 ** -0.5) < 0.02


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("moe_world")
    np.savez(workdir / "inputs.npz", x=_x(3, (2, 16, 32)),
             **{f"params_{k}": v for k, v in _ref_params().items()})
    return torch_world.run("moe", WORLD, workdir)


def test_expert_parallel_matches_one_rank(ranks, record_property):
    """tests/test_moe.py:40: ep=4 against one rank."""
    x = _x(3, (2, 16, 32))
    want = _port_grads(x)
    gap = 0.0
    for got in ranks:
        np.testing.assert_allclose(got["out"], want[0], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(got["aux"]), want[1], rtol=1e-5)
        gap = max(gap, float(np.abs(got["out"] - want[0]).max()))
        assert tuple(got["w_in_local_shape"]) == (1, 32, 64)
    record_property("max_abs_err", gap)


def test_expert_parallel_gradients_match_reference(ranks, record_property):
    x = _x(3, (2, 16, 32))
    want = _ref_grads(_ref_params(), x)
    gap = 0.0
    for got in ranks:
        gap = max(gap, _assert_close(
            (got["out"], float(got["aux"]),
             {k: got[f"grad_{k}"] for k in want[2]}, got["grad_x"]),
            want, 1e-5))
    record_property("max_abs_err", gap)
