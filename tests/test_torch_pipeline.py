"""The port's pipeline (``brpc_tpu_torch.parallel.pipeline_apply``)
against the reference's.

One gloo world of 8 processes (``tests/torch_world.py``) runs the GPipe
schedule with ``tanh(m @ p)`` stages and 8 microbatches over pp = 1, 2, 4
and 8 (the other ranks on 'dp'); the reference runs the same on the 8
virtual CPU devices, with ``tests/test_parallel.py:122``'s inputs.
Tolerance 1e-5, the reference's own: the stages run the same products in
the same order, and each framework's matmul sums in its own order
(measured at most 4.8e-7).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_world
from brpc_tpu.parallel import make_mesh, pipeline_apply

WORLD = 8


@functools.lru_cache(maxsize=None)
def _inputs():
    w = jax.random.normal(jax.random.PRNGKey(3), (8, 16, 16),
                          jnp.float32) * 0.3
    x = jax.random.normal(jax.random.PRNGKey(4), (16, 16), jnp.float32)
    return {"w": np.asarray(w), "x": np.asarray(x)}


def _stage(params, x):
    return jnp.tanh(x @ params)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("pipeline_world")
    np.savez(workdir / "inputs.npz", **_inputs())
    return torch_world.run("pipeline", WORLD, workdir)


@pytest.mark.parametrize("pp", [1, 2, 4, 8])
def test_pipeline_matches_reference_and_sequential(ranks, pp,
                                                   record_property):
    w, x = (jnp.asarray(_inputs()[k]) for k in ("w", "x"))
    mesh = make_mesh({"pp": pp})
    want = jax.jit(lambda w, x: pipeline_apply(
        _stage, w, x, mesh=mesh, axis="pp", microbatches=8))(w[:pp], x)
    sequential = x
    for s in range(pp):
        sequential = _stage(w[s], sequential)
    by_device = {s.device.id: s.index for s in want.addressable_shards}
    want = np.asarray(want)
    np.testing.assert_allclose(want, np.asarray(sequential), rtol=1e-5,
                               atol=1e-5)
    gap = 0.0
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"pp{pp}"], want, rtol=1e-5,
                                   atol=1e-5, err_msg=f"rank {rank}")
        np.testing.assert_array_equal(got[f"pp{pp}_local"],
                                      got[f"pp{pp}"][by_device[rank]])
        gap = max(gap, float(np.abs(got[f"pp{pp}"] - want).max()))
    record_property("max_abs_err", gap)
