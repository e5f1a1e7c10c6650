"""The port's parameter-server tier (``brpc_tpu_torch.ps``) against the
reference's (``brpc_tpu.ps``) on the same tables.

The reference draws each table with ``create_embedding`` on its (dp=2,
ps=4) mesh of 8 CPU devices; the port loads it through
``models.convert.embedding_from_reference`` on a gloo world of 8 processes
with the same mesh (``tests/torch_world.py``), and both run
``tests/test_ps_ckpt.py``'s cases on the same ids, grads and targets. On the
CPU the port's gathers and scatters are K2's and K3's plain versions.
Tolerances are the reference's own: rtol 1e-6 for lookups, updates, the
first step's loss and table, and the table gradient; rtol 1e-4 for the
20-step loss curve. The max abs error of each exact-by-design comparison
is recorded in the test report (``max_abs_err``); 0 is expected.

Marked ``cuda``: the same calls on the card, where ``lookup`` launches K2
and ``apply_gradients`` and ``lookup``'s backward launch K3, against the
CPU's plain versions bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world
from brpc_tpu import ps as ref_ps
from brpc_tpu.parallel import make_mesh

WORLD, PS = 8, 4
LR_MIXED = 0.1  # not a power of two: lr * g rounds


@pytest.fixture(scope="module")
def reference():
    """(inputs for the ranks, the reference's results), by name."""
    mesh = make_mesh({"ps": PS})
    inputs, want = {}, {}

    emb = ref_ps.create_embedding(jax.random.PRNGKey(0), 64, 16, mesh, "ps")
    inputs["lookup_table"] = np.asarray(emb.table)
    inputs["lookup_ids"] = np.array([[0, 5, 17], [63, 32, 5]], np.int32)
    inputs["outside_ids"] = np.array([[64, -1, 100, 3], [-64, 7, 70, 0]],
                                     np.int32)
    for name in ("lookup_ids", "outside_ids"):
        want[name] = np.asarray(jax.jit(lambda e, i: ref_ps.lookup(
            e, i, mesh))(emb, jnp.asarray(inputs[name])))

    emb = ref_ps.create_embedding(jax.random.PRNGKey(1), 32, 8, mesh, "ps")
    inputs["apply_table"] = np.asarray(emb.table)
    inputs["apply_ids"] = np.array([3, 17, 31], np.int32)
    inputs["apply_grads"] = np.ones((3, 8), np.float32)
    want["apply"] = np.asarray(ref_ps.apply_gradients(
        emb, jnp.asarray(inputs["apply_ids"]),
        jnp.asarray(inputs["apply_grads"]), mesh, lr=0.5).table)

    # Repeated ids, ids past either end of the table (no shard owns them,
    # so both sides drop them), grads that are not powers of two.
    rng = np.random.default_rng(5)
    emb = ref_ps.create_embedding(jax.random.PRNGKey(5), 32, 8, mesh, "ps")
    inputs["mixed_table"] = np.asarray(emb.table)
    ids = (rng.zipf(1.3, 40) - 1) % 32
    ids[[3, 11, 29]] = [32, -1, 45]
    inputs["mixed_ids"] = ids.astype(np.int32).reshape(5, 8)
    inputs["mixed_grads"] = rng.standard_normal((5, 8, 8)).astype(np.float32)
    inputs["mixed_lr"] = np.float32(LR_MIXED)
    want["mixed"] = np.asarray(ref_ps.apply_gradients(
        emb, jnp.asarray(inputs["mixed_ids"]),
        jnp.asarray(inputs["mixed_grads"]), mesh, lr=LR_MIXED).table)

    emb = ref_ps.create_embedding(jax.random.PRNGKey(2), 64, 8, mesh, "ps")
    ids = jax.random.randint(jax.random.PRNGKey(3), (4, 8), 0, 64)
    targets = jax.random.normal(jax.random.PRNGKey(4), (4, 8, 8)) * 0.1
    inputs["train_table"] = np.asarray(emb.table)
    inputs["train_ids"] = np.asarray(ids, np.int32)
    inputs["train_targets"] = np.asarray(targets)
    want["train_grad"] = np.asarray(jax.grad(lambda table: jnp.mean((
        ref_ps.lookup(emb._replace(table=table), ids, mesh) - targets)
        ** 2))(emb.table))
    step = jax.jit(ref_ps.make_ps_train_step("ps", "dp", mesh, lr=0.5))
    emb1, loss0 = step(emb, ids, targets)
    want["train_table1"] = np.asarray(emb1.table)
    losses = [loss0]
    for _ in range(20):
        emb, loss = step(emb, ids, targets)
        losses.append(loss)
    want["train_losses"] = np.asarray(losses)
    return inputs, want


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """Each rank's results of the same cases."""
    workdir = tmp_path_factory.mktemp("ps_world")
    np.savez(workdir / "inputs.npz", **reference[0])
    return torch_world.run("ps", WORLD, workdir)


def _full(ranks, key):
    """A row-sharded table from the ranks at dp = 0 (ranks 0..3 hold ps
    shards 0..3; ranks 4..7 hold the same, replicated over dp)."""
    for rank in range(PS, WORLD):
        np.testing.assert_array_equal(ranks[rank][key],
                                      ranks[rank - PS][key])
    return np.concatenate([ranks[rank][key] for rank in range(PS)])


def _close(got, want, record_property, rtol=1e-6, atol=0.0):
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    record_property("max_abs_err", err)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=f"max abs err {err}")


def test_table_loads_row_sharded(ranks, reference):
    inputs, _ = reference
    np.testing.assert_array_equal(_full(ranks, "lookup_local"),
                                  inputs["lookup_table"])


@pytest.mark.parametrize("case", ["lookup_ids", "outside_ids"])
def test_lookup_matches_reference(ranks, reference, record_property, case):
    _, want = reference
    for got in ranks:
        _close(got[case], want[case], record_property)


def test_lookup_reads_ids_outside_the_table_as_zero_rows(ranks, reference):
    inputs, want = reference
    ids = inputs["outside_ids"]
    outside = (ids < 0) | (ids >= 64)
    for got in ranks:
        assert not got["outside_ids"][outside].any()
        np.testing.assert_array_equal(got["outside_ids"][~outside],
                                      inputs["lookup_table"][ids[~outside]])
    assert not want["outside_ids"][outside].any()


def test_apply_gradients_touches_only_hit_rows(ranks, reference,
                                              record_property):
    inputs, want = reference
    before, after = inputs["apply_table"], _full(ranks, "apply")
    _close(after, want["apply"], record_property)
    for r in range(32):
        if r in {3, 17, 31}:
            np.testing.assert_allclose(after[r], before[r] - 0.5, rtol=1e-6)
        else:
            np.testing.assert_allclose(after[r], before[r], rtol=1e-6)


def test_apply_gradients_with_repeats_and_outside_ids(ranks, reference,
                                                      record_property):
    inputs, want = reference
    got = _full(ranks, "mixed")
    _close(got, want["mixed"], record_property)
    ids = inputs["mixed_ids"].reshape(-1)
    inside = (ids >= 0) & (ids < 32)
    host = inputs["mixed_table"].copy()
    np.subtract.at(host, ids[inside], np.float32(LR_MIXED)
                   * inputs["mixed_grads"].reshape(-1, 8)[inside])
    assert got.tobytes() == host.tobytes()


def test_lookup_gradient_matches_reference(ranks, reference,
                                          record_property):
    """The table gradient through ``lookup``'s backward equals JAX's
    through ``psum`` under ``shard_map``: not scaled by the axis size."""
    _, want = reference
    _close(_full(ranks, "train_grad"), want["train_grad"], record_property)


def test_train_step_first_step_matches_reference(ranks, reference,
                                                 record_property):
    _, want = reference
    _close(_full(ranks, "train_table1"), want["train_table1"],
           record_property)
    for got in ranks:
        np.testing.assert_allclose(got["train_losses"][0],
                                   want["train_losses"][0], rtol=1e-6)


def test_train_step_losses_fall_as_the_reference(ranks, reference):
    _, want = reference
    for got in ranks:
        losses = got["train_losses"]
        np.testing.assert_allclose(losses, want["train_losses"], rtol=1e-4)
        assert losses[-1] < losses[0]


def test_create_embedding(ranks, reference):
    """Raises unless the 'ps' axis divides vocab; otherwise every rank
    keeps its rows of the one table its generator draws."""
    with pytest.raises(ValueError):
        ref_ps.create_embedding(jax.random.PRNGKey(0), 30, 4,
                                make_mesh({"ps": PS}), "ps")
    for rank, got in enumerate(ranks):
        assert "not divisible" in str(got["create_raises"])
        np.testing.assert_array_equal(got["created_full"],
                                      got["created_draw"])
        rows = rank % PS * 16
        np.testing.assert_array_equal(got["created_local"],
                                      got["created_draw"][rows:rows + 16])


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card_world(tmp_path):
    """A world of one process, gloo for CPU tensors and NCCL for the
    card's, with a mesh on each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    import torch.distributed as dist

    from brpc_tpu_torch.parallel import make_mesh as port_mesh

    torch.cuda.set_device(0)
    store = dist.FileStore(os.path.join(tmp_path, "store"), 1)
    dist.init_process_group("cpu:gloo,cuda:nccl", store=store, rank=0,
                            world_size=1)
    try:
        yield {d: port_mesh({"ps": 1}, device_type=d)
               for d in ("cpu", "cuda")}
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_ps_kernels_on_card_equal_plain_versions(card_world, monkeypatch):
    """lookup (K2), apply_gradients (K3) and lookup's backward (K3 with
    lr = -1) on the card against the same calls on the CPU, bit for bit,
    one launch each; the card's path never reaches a plain version."""
    from brpc_tpu_torch import ps
    from brpc_tpu_torch.models.convert import embedding_from_reference
    from brpc_tpu_torch.ops import embedding_rows as er

    rng = np.random.default_rng(3)
    vocab, dim, k = 4096, 256, 1024
    table = (rng.standard_normal((vocab, dim)) * 0.02).astype(np.float32)
    ids = ((rng.zipf(1.1, k) - 1) % (vocab + 64) - 32).astype(np.int32)
    grads = rng.standard_normal((k, dim)).astype(np.float32)
    results = {}
    for device, mesh in card_world.items():
        emb = embedding_from_reference(table, vocab, dim, "ps", mesh)
        i, g = torch.from_numpy(ids), torch.from_numpy(grads).to(device)
        if device == "cuda":
            for name in ("gather_rows_reference", "scatter_sub_reference"):
                monkeypatch.setattr(er, name, None)
            before = dict(er.launches)
        rows = ps.lookup(emb, i, mesh)
        new = ps.apply_gradients(emb, i, g, mesh, lr=0.05).table.to_local()
        leaf = emb.table.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(
            ps.lookup(emb._replace(table=leaf), i, mesh), leaf, g)
        torch.cuda.synchronize()
        results[device] = [t.cpu() for t in (rows, new, grad.to_local())]
    assert er.launches["gather_rows"] == before["gather_rows"] + 2
    assert er.launches["scatter_sub"] == before["scatter_sub"] + 2
    for got, want in zip(results["cuda"], results["cpu"]):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
