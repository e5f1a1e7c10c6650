"""The port's collective tier against the reference's on the same inputs.

``brpc_tpu_torch.parallel`` (``make_mesh``, ``shard_params``,
``shard_batch``, ``CollectiveChannel``, ``allreduce_benchmark``) runs on a
gloo world of 8 processes, one world for this module
(``tests/torch_world.py``), as the reference's run on the 8 virtual CPU
devices of ``tests/conftest.py``. Each case is compared, on every rank,
with the reference's function on the 8-device mesh: the collectives of
``tests/test_parallel.py``, the mesh's 'dp'-absorbs rule and its
``ValueError``, ``_norm_spec``'s axis-dropping and the shards that
``shard_params`` / ``shard_batch`` give each device. Collectives of small
integers in f32 are exact on both sides, so the comparisons are exact.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_world
from brpc_tpu.parallel import CollectiveChannel, allreduce_benchmark
from brpc_tpu.parallel import mesh as ref_mesh
from brpc_tpu_torch.parallel import PartitionSpec
from brpc_tpu_torch.parallel import mesh as port_mesh
from jax.sharding import PartitionSpec as JP

WORLD = 8


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_world.run("parallel", WORLD,
                           tmp_path_factory.mktemp("parallel_world"))


@pytest.fixture(scope="module")
def reference():
    """The reference's results of the same collectives on 8 devices."""
    chan = CollectiveChannel(ref_mesh.make_mesh({"dp": 8}), "dp")
    x = {k: jnp.asarray(v) for k, v in torch_world.parallel_inputs().items()}
    want = {f"all_reduce_{op}": jax.jit(
        lambda a, op=op: chan.all_reduce(a, op))(x["reduce"])
        for op in ("sum", "max", "min")}
    want["all_reduce_dtensor"] = want["all_reduce_sum"]
    want["all_reduce_inplace"] = jax.jit(chan.all_reduce_inplace)(x["grad"])
    want["all_gather"] = jax.jit(chan.all_gather)(x["gather"])
    rs = jax.jit(chan.reduce_scatter)(x["scatter"])
    want["reduce_scatter_full"] = rs
    want["reduce_scatter_then_gather"] = jax.jit(chan.all_gather)(rs)
    for k in torch_world.SHIFTS:
        want[f"shift_{k}"] = jax.jit(lambda a, k=k: chan.shift(a, k))(
            x["ring"])
    want["broadcast"] = jax.jit(
        lambda a: chan.broadcast(a, torch_world.BROADCAST_ROOT))(x["gather"])
    want["map_reduce"] = jax.jit(
        lambda a: chan.map_reduce(lambda s: jnp.sum(s * 2), a))(x["ones"])
    return {k: np.asarray(v) for k, v in want.items()}


_COLLECTIVES = ["all_reduce_sum", "all_reduce_max", "all_reduce_min",
                "all_reduce_dtensor", "all_reduce_inplace", "all_gather",
                "reduce_scatter_full", "reduce_scatter_then_gather",
                *(f"shift_{k}" for k in torch_world.SHIFTS), "broadcast",
                "map_reduce"]


@pytest.mark.parametrize("case", _COLLECTIVES)
def test_collective_matches_reference(ranks, reference, case):
    want = reference[case]
    for rank, got in enumerate(ranks):
        np.testing.assert_array_equal(got[case], want,
                                      err_msg=f"{case} on rank {rank}")


def test_parallel_py_expectations(ranks):
    """``tests/test_parallel.py``'s own asserts, on the port's results."""
    x = torch_world.parallel_inputs()
    for got in ranks:
        np.testing.assert_allclose(got["all_reduce_sum"], x["reduce"].sum(0))
        np.testing.assert_allclose(got["all_gather"], x["gather"])
        np.testing.assert_allclose(got["reduce_scatter_then_gather"],
                                   8 * x["scatter"])
        np.testing.assert_allclose(got["shift_1"].ravel(),
                                   np.roll(np.arange(8), 1))
        assert float(got["map_reduce"]) == 64.0


def test_reduce_scatter_leaves_each_rank_its_slice(ranks):
    full = WORLD * torch_world.parallel_inputs()["scatter"]
    for rank, got in enumerate(ranks):
        np.testing.assert_array_equal(got["reduce_scatter_local"],
                                      full[2 * rank:2 * rank + 2])


def test_all_reduce_inplace_sums_each_ranks_own_value(ranks):
    """The grad-sync use: every rank passes its own gradient."""
    g = torch_world.parallel_inputs()["grad"]
    want = sum(g + r for r in range(WORLD))
    for got in ranks:
        np.testing.assert_allclose(got["all_reduce_inplace_own"], want,
                                   rtol=1e-6)


def test_collective_counters(ranks):
    for got in ranks:
        assert int(got["counter_calls"]) == 1
        assert int(got["counter_bytes"]) == 64 * 4


def test_allreduce_benchmark_keeps_the_reference_formula(ranks):
    want = allreduce_benchmark(ref_mesh.make_mesh({"dp": 8}), "dp",
                               size_mb=0.01, iters=2)
    for got in ranks:
        assert int(got["bench_bytes"]) == want["bytes"]
        assert int(got["bench_devices"]) == want["devices"] == WORLD
        assert int(got["bench_world_size"]) == WORLD
        n, nbytes = WORLD, float(got["bench_bytes"])
        np.testing.assert_allclose(
            float(got["bench_gbps_per_chip"]),
            2 * (n - 1) / n * nbytes / float(got["bench_seconds"]) / 1e9,
            rtol=1e-5)


@pytest.mark.parametrize("name,axes", [("tp4", {"tp": 4}), ("all", None),
                                       ("tp2_sp2", {"tp": 2, "sp": 2})])
def test_make_mesh_dp_absorbs_leftover_ranks(ranks, name, axes):
    want = ref_mesh.make_mesh(axes)
    for rank, got in enumerate(ranks):
        assert tuple(got[f"mesh_{name}_names"]) == want.axis_names
        assert tuple(got[f"mesh_{name}_shape"]) == want.devices.shape
        # rank r sits where device r sits in the reference's mesh
        where = np.argwhere(np.vectorize(lambda d: d.id)(want.devices)
                            == rank)[0]
        assert tuple(got[f"mesh_{name}_coordinate"]) == tuple(where)


@pytest.mark.parametrize("name,axes", [("tp3", {"tp": 3}),
                                       ("dp2_tp2", {"dp": 2, "tp": 2})])
def test_make_mesh_raises_where_the_reference_does(ranks, name, axes):
    with pytest.raises(ValueError):
        ref_mesh.make_mesh(axes)
    for got in ranks:
        assert str(got[f"mesh_{name}_raises"]), f"{axes} did not raise"


_SPECS = [
    (("dp", ("tp", "sp"), None, "ep"), ("dp", "tp")),
    (("sp", "tp"), ("dp", "tp")),
    ((("dp", "tp"), None), ("dp",)),
    ((None, "pp"), ("dp", "tp", "sp")),
    ((), ("dp",)),
    (((), ("tp",), ["dp", "tp"]), ("dp", "tp")),
]


@pytest.mark.parametrize("spec,axes", _SPECS)
def test_norm_spec_drops_axes_the_mesh_lacks(spec, axes):
    ref = ref_mesh.make_mesh({a: 1 for a in axes[1:]} if len(axes) > 1
                             else None)
    assert ref.axis_names == axes
    want = ref_mesh._norm_spec(JP(*spec), ref)
    got = port_mesh._norm_spec(PartitionSpec(*spec),
                               types.SimpleNamespace(mesh_dim_names=axes))
    assert isinstance(got, PartitionSpec)
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize("key", ["w", "b", "e", "s", "batch"])
def test_shards_match_the_reference_devices(ranks, key):
    data = torch_world.shard_inputs()
    mesh = ref_mesh.make_mesh({"tp": 4})
    if key == "batch":
        arr = ref_mesh.shard_batch(jnp.asarray(data["batch"]),
                                   JP(*data["batch_spec"]), mesh)
        full = data["batch"]
    else:
        arr = ref_mesh.shard_params(
            {key: jnp.asarray(data["params"][key])},
            {key: JP(*data["specs"][key])}, mesh)[key]
        full = data["params"][key]
    by_device = {s.device.id: np.asarray(s.data)
                 for s in arr.addressable_shards}
    name = "shard_batch" if key == "batch" else f"shard_{key}"
    for rank, got in enumerate(ranks):
        np.testing.assert_array_equal(got[name], by_device[rank],
                                      err_msg=f"{key} on rank {rank}")
        if key != "batch":
            np.testing.assert_array_equal(got[f"{name}_full"], full)


@pytest.mark.parametrize("spec,ndim,want", [
    ((None, "tp"), 2, ["R", 1]),
    ((("dp", "tp"), None), 2, [0, 0]),
    (("sp", "dp"), 2, [1, "R"]),
])
def test_specs_map_to_placements(spec, ndim, want):
    from torch.distributed.tensor import Replicate, Shard

    got = port_mesh._placements(
        PartitionSpec(*spec), types.SimpleNamespace(mesh_dim_names=("dp",
                                                                    "tp")),
        ndim)
    assert got == [Replicate() if w == "R" else Shard(w) for w in want]


@pytest.mark.parametrize("spec,ndim", [
    ((("tp", "dp"),), 1),     # a tuple out of the mesh's axis order
    (("dp", "dp"), 2),        # one mesh axis on two dimensions
    (("dp", None, None), 2),  # more entries than dimensions
])
def test_specs_the_port_refuses(spec, ndim):
    with pytest.raises(ValueError):
        port_mesh._placements(
            PartitionSpec(*spec),
            types.SimpleNamespace(mesh_dim_names=("dp", "tp")), ndim)
