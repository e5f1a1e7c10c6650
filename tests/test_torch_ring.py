"""The port's ring and Ulysses attention against the reference's.

One gloo world of 8 processes (``tests/torch_world.py``) runs the port;
the reference runs ``tests/test_parallel.py``'s cases on the 8 virtual
CPU devices with the same q/k/v (``jax.random``, f32). Tolerances, each
with its reason and the gap measured on this tree:

- ring (sp=8, and sp=4 with the heads over tp=2, and sp=1) and Ulysses
  (sp=2) against dense ``attention``, causal and not: 2e-4, the
  reference's own (the online softmax sums in another order; measured at
  most 4.8e-7);
- the same outputs against the reference's ring and Ulysses: 2e-4
  (measured at most 4.8e-7);
- the gradient of sum(ring(q, k, v)²) over sp=4 against the reference's
  ring gradient: 1e-3, the reference's ring-against-dense tolerance
  (measured 1.9e-6);
- each rank's block of the result is its slice of the sequence (and of
  the heads, with ``head_axis``), as the reference's ``out_specs`` lay it
  out: exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_world
from brpc_tpu.models import llama
from brpc_tpu.parallel import make_mesh, ring_attention, ulysses_attention

WORLD = 8
_CASES = {"ring8": ({"sp": 8}, ring_attention, {}),
          "ring1": ({"sp": 1}, ring_attention, {}),
          "ring_tp": ({"tp": 2, "sp": 4}, ring_attention, {"head_axis": "tp"}),
          "ulysses2": ({"sp": 2}, ulysses_attention, {})}


def _attn_inputs(key, b=2, t=64, hq=4, hkv=2, d=8):
    kq, kk, kv = jax.random.split(key, 3)
    q = jax.random.normal(kq, (b, t, hq, d), jnp.float32)
    k = jax.random.normal(kk, (b, t, hkv, d), jnp.float32)
    v = jax.random.normal(kv, (b, t, hkv, d), jnp.float32)
    return q, k, v


@functools.lru_cache(maxsize=None)
def _inputs():
    out = {}
    for name, key, t in (("dense", 0, 64), ("grad", 2, 32)):
        for x, a in zip("qkv", _attn_inputs(jax.random.PRNGKey(key), t=t)):
            out[f"{name}_{x}"] = np.asarray(a)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("ring_world")
    np.savez(workdir / "inputs.npz", **_inputs())
    return torch_world.run("ring", WORLD, workdir)


def _qkv(name):
    return [jnp.asarray(_inputs()[f"{name}_{x}"]) for x in "qkv"]


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("causal", [True, False])
def test_matches_dense_and_reference(ranks, case, causal, record_property):
    axes, fn, kw = _CASES[case]
    mesh = make_mesh(axes)
    q, k, v = _qkv("dense")
    dense = np.asarray(llama.attention(q, k, v, causal=causal))
    ref = np.asarray(jax.jit(lambda q, k, v: fn(
        q, k, v, mesh=mesh, axis="sp", causal=causal, **kw))(q, k, v))
    gap = 0.0
    for rank, got in enumerate(ranks):
        out = got[f"{case}_{causal}"]
        np.testing.assert_allclose(out, dense, rtol=2e-4, atol=2e-4,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4,
                                   err_msg=f"rank {rank}")
        gap = max(gap, float(np.abs(out - dense).max()),
                  float(np.abs(out - ref).max()))
    record_property("max_abs_err", gap)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_each_rank_holds_its_block(ranks, case):
    """The DTensor's local block on each rank is the reference's
    ``out_specs`` shard of that device."""
    axes, fn, kw = _CASES[case]
    mesh = make_mesh(axes)
    q, k, v = _qkv("dense")
    ref = jax.jit(lambda q, k, v: fn(q, k, v, mesh=mesh, axis="sp", **kw))(
        q, k, v)
    by_device = {s.device.id: s.index for s in ref.addressable_shards}
    for rank, got in enumerate(ranks):
        whole = got[f"{case}_True"]
        np.testing.assert_array_equal(got[f"{case}_True_local"],
                                      whole[by_device[rank]])


def test_ulysses_raises_where_the_reference_does(ranks):
    q, k, v = _qkv("dense")
    with pytest.raises(ValueError):
        ulysses_attention(q, k, v, mesh=make_mesh({"sp": 8}), axis="sp")
    for got in ranks:
        assert "not divisible" in str(got["ulysses8_raises"])


def test_ring_gradient_matches_reference(ranks, record_property):
    mesh = make_mesh({"sp": 4})
    q, k, v = _qkv("grad")

    def loss_ring(q, k, v):
        return jnp.sum(ring_attention(q, k, v, mesh=mesh, axis="sp") ** 2)

    want = jax.grad(loss_ring, argnums=(0, 1, 2))(q, k, v)
    gap = 0.0
    for got in ranks:
        for name, w in zip("qkv", want):
            np.testing.assert_allclose(got[f"grad_{name}"], np.asarray(w),
                                       rtol=1e-3, atol=1e-3)
            gap = max(gap, float(np.abs(got[f"grad_{name}"] - w).max()))
    record_property("max_abs_err", gap)
