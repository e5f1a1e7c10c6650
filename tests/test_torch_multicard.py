"""``chip_smoke.py`` phase 15's rank program on a gloo world of 4 CPU
processes, held against the reference.

One world a module (``torch_world.run_multicard``): the phase's own
``multi_card_world`` and ``mc_rank`` at ``torch_world.multicard_plan``'s
tiny widths, ``device_type="cpu"``, so every check the chip run makes on
its ranks is made here too (the sharded steps against the unsharded one,
ring and Ulysses against dense attention, MoE at ep = 4 against ep = 1,
the pipeline against its stages in turn, the PS against host replays, the
``CollectiveChannel`` ops against their definitions, the dry run's summary
line against the mesh rule). The plan's ``keep`` makes each rank return
its inputs and whole results; the reference runs on the same inputs on a
mesh of 4 of ``tests/conftest.py``'s virtual CPU devices. Tolerances, each
with its reason (gaps measured on this tree in brackets):

- the PS at ps = 4: ``lookup`` and ``apply_gradients`` bit-equal to
  ``brpc_tpu.ps`` (the same gathers, and the same ordered subtractions);
  the first train step's table within rtol 1e-6 and the 5 losses within
  rtol 1e-4, ``tests/test_torch_ps.py``'s own (measured 0);
- the f32 sharded steps {tp 2, sp 2} (ring attention over 'sp', heads
  over 'tp') and {dp 2, tp 2} against the reference's gradient of its
  ``loss_fn`` on the same layout: the loss within 1e-5,
  ``tests/test_torch_sharded_train.py``'s, and every leaf's gradient
  within 1e-5 of its largest element, as ``tests/test_torch_train.py``
  holds gradients: the same arithmetic summed in another order (measured
  loss at most 4.8e-7, gradients 1.1e-6 of their largest);
- ring and Ulysses at sp = 4 against the reference's: 2e-4, and the ring's
  gradient 1e-3, ``tests/test_torch_ring.py``'s (measured 2.4e-7,
  3.8e-6);
- MoE at ep = 4 against the reference's layer, the output within 1e-5 and
  each gradient within 1e-5 of its largest, ``tests/test_torch_moe.py``'s
  (measured at most 4.1e-7);
- the pipeline at pp = 4 against the reference's: 1e-5,
  ``tests/test_torch_pipeline.py``'s (measured 2.1e-7).

The world's launcher (``brpc_tpu_torch.parallel.mesh.run_world``) is held
to its limits here as well: a world with a rank that never enters the
collective the others wait in is stopped within its time limit, with that
rank and its part named and no rank process left; a rank that raises is
named with its part; a world of more ranks than cards on ``cuda`` raises
before any process starts.
"""

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import chip_smoke
import torch_world
from brpc_tpu import ps as ref_ps
from brpc_tpu.models import llama as ref_llama
from brpc_tpu.models import moe as ref_moe
from brpc_tpu.parallel import (make_mesh, pipeline_apply, ring_attention,
                               shard_batch, shard_params, ulysses_attention)
from brpc_tpu_torch.parallel.mesh import WorldFailed, run_world

WORLD = 4
LAYOUTS = dict((name, (axes, batch)) for name, axes, batch in
               torch_world.multicard_plan().layouts[WORLD])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_world.run_multicard(
        WORLD, tmp_path_factory.mktemp("multicard_world"), "cpu")


def _mesh(axes):
    return make_mesh(axes, devices=jax.devices()[:WORLD])


def _tree(node):
    if isinstance(node, dict):
        return {k: _tree(v) for k, v in node.items()}
    return jnp.asarray(node)


def _within_largest(got, want, scale, what):
    """|got - want| within ``scale`` of want's largest element; returns
    the gap as a share of it."""
    largest = float(np.abs(want).max())
    gap = float(np.abs(got - want).max()) / largest
    assert gap <= scale, (what, gap)
    return gap


def test_every_rank_ran_every_part(ranks):
    """The world's summary: the dry run's line at the mesh rule, and every
    part recorded on every rank."""
    assert len(ranks) == WORLD
    for rank, got in enumerate(ranks):
        assert got["rank"] == rank
        assert got["dryrun"].startswith(
            "dryrun_multichip(4): mesh={'dp': 1, 'tp': 2, 'sp': 2} loss=")
        assert list(got["seconds"]) == [
            "(a) dryrun_multichip", "(b) Llama params drawn",
            *(f"(b) sharded step {name}" for name in LAYOUTS),
            "(c) ring and Ulysses attention", "(d) MoE over ep",
            "(e) pipeline", "(f) collective PS"]


# -- (f) the collective PS ----------------------------------------------------


@pytest.fixture(scope="module")
def ps_reference(ranks):
    vocab, dim, _ = torch_world.multicard_plan().ps
    mesh = _mesh({"ps": WORLD})
    got = ranks[0]["ps"]
    table = jax.device_put(jnp.asarray(torch_world.multicard_table()),
                           NamedSharding(mesh, JP("ps", None)))
    emb = ref_ps.EmbeddingShards(table, vocab, dim, "ps")
    ids, grads = jnp.asarray(got["ids"]), jnp.asarray(got["grads"])
    step = jax.jit(ref_ps.make_ps_train_step("ps", "dp", mesh,
                                             lr=chip_smoke.PS_LR))
    targets = jnp.zeros(grads.shape, jnp.float32)
    first, loss = step(emb, ids, targets)
    losses, state = [float(loss)], first
    for _ in range(chip_smoke.PS_TRAIN_STEPS - 1):
        state, loss = step(state, ids, targets)
        losses.append(float(loss))
    return {
        "rows": np.asarray(jax.jit(lambda e, i: ref_ps.lookup(e, i, mesh))(
            emb, ids)),
        "applied": np.asarray(ref_ps.apply_gradients(
            emb, ids, grads, mesh, lr=chip_smoke.PS_LR).table),
        "first": np.asarray(first.table), "losses": np.asarray(losses)}


@pytest.mark.parametrize("key", ["rows", "applied"])
def test_ps_bit_equal_to_reference(ranks, ps_reference, key,
                                   record_property):
    for got in ranks:
        np.testing.assert_array_equal(got["ps"][key].view(np.int32),
                                      ps_reference[key].view(np.int32))
    record_property("max_abs_err", 0.0)


def test_ps_train_steps_match_reference(ranks, ps_reference,
                                        record_property):
    gap = 0.0
    for got in ranks:
        np.testing.assert_allclose(got["ps"]["first"], ps_reference["first"],
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(got["ps"]["losses"],
                                   ps_reference["losses"], rtol=1e-4)
        gap = max(gap, float(np.abs(got["ps"]["first"]
                                    - ps_reference["first"]).max()))
    record_property("max_abs_err", gap)


# -- (b) the sharded steps -------------------------------------------------


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sharded_step_gradients_match_reference(ranks, layout,
                                                record_property):
    """The f32 loss and every leaf's gradient of the port's sharded step
    against ``jax.grad`` of the reference's ``loss_fn`` on the same
    layout, params and tokens."""
    axes, _ = LAYOUTS[layout]
    cfg = dataclasses.replace(ref_llama.LlamaConfig.tiny(256),
                              dtype=jnp.float32)
    mesh = _mesh(axes)
    attn = None
    if axes.get("sp", 1) > 1:
        def attn(q, k, v):
            return ring_attention(q, k, v, mesh=mesh, axis="sp",
                                  causal=True, head_axis="tp")
    params = shard_params(_tree(ranks[0]["llama_init"]),
                          ref_llama.param_specs(cfg), mesh)
    got0 = ranks[0][layout]
    tokens = shard_batch(got0["tokens"], JP("dp", "sp"), mesh)
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, t: ref_llama.loss_fn(p, t, cfg, attn)))(params, tokens)
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]
    loss_gap = grad_gap = 0.0
    for rank, got in enumerate(ranks):
        got = got[layout]
        np.testing.assert_allclose(got["f32_loss"], float(loss), rtol=0,
                                   atol=1e-5)
        loss_gap = max(loss_gap, abs(got["f32_loss"] - float(loss)))
        assert len(got["grads"]) == len(want)
        for i, (g, w) in enumerate(zip(got["grads"], want)):
            grad_gap = max(grad_gap, _within_largest(
                g, w, 1e-5, f"leaf {i} on rank {rank}"))
    record_property("loss_abs_err", loss_gap)
    record_property("grad_err_of_largest", grad_gap)


# -- (c) ring and Ulysses -----------------------------------------------------


@pytest.fixture(scope="module")
def attention_reference(ranks):
    got = ranks[0]["attention"]
    q, k, v = (jnp.asarray(got[x]) for x in "qkv")
    mesh = _mesh({"sp": WORLD})

    def ring(q, k, v):
        return ring_attention(q, k, v, mesh=mesh, axis="sp", causal=True)

    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(ring(q, k, v) ** 2),
                             argnums=(0, 1, 2)))(q, k, v)
    return {"ring_out": np.asarray(jax.jit(ring)(q, k, v)),
            "ulysses_out": np.asarray(jax.jit(
                lambda q, k, v: ulysses_attention(q, k, v, mesh=mesh,
                                                  axis="sp", causal=True))(
                q, k, v)),
            "grads": [np.asarray(g) for g in grads]}


@pytest.mark.parametrize("key", ["ring_out", "ulysses_out"])
def test_attention_matches_reference(ranks, attention_reference, key,
                                     record_property):
    gap = 0.0
    for got in ranks:
        out = got["attention"][key]
        np.testing.assert_allclose(out, attention_reference[key],
                                   rtol=2e-4, atol=2e-4)
        gap = max(gap, float(np.abs(out - attention_reference[key]).max()))
    record_property("max_abs_err", gap)


def test_ring_gradient_matches_reference(ranks, attention_reference,
                                         record_property):
    gap = 0.0
    for got in ranks:
        for g, w in zip(got["attention"]["grads"],
                        attention_reference["grads"]):
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3)
            gap = max(gap, float(np.abs(g - w).max()))
    record_property("max_abs_err", gap)


# -- (d) MoE and (e) the pipeline ---------------------------------------------


def test_moe_over_ep_matches_reference(ranks, record_property):
    """The output and the gradients of mean(out²) + 0.01·aux by the three
    params and the input, experts over ep = 4, against the reference's
    layer on one device."""
    hidden, intermediate, experts, _ = torch_world.multicard_plan().moe
    cfg = ref_moe.MoeConfig(hidden=hidden, intermediate=intermediate,
                            n_experts=experts, capacity_factor=2.0,
                            dtype=jnp.float32)
    got0 = ranks[0]["moe"]
    params = _tree(got0["init"])
    x = jnp.asarray(got0["x"])

    def loss(p, x):
        out, aux = ref_moe.moe_layer(p, x, cfg)
        return jnp.mean(out ** 2) + 0.01 * aux

    out, _ = ref_moe.moe_layer(params, x, cfg)
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
    want = [np.asarray(gp[k]) for k in ("gate", "w_in", "w_out")] + \
        [np.asarray(gx)]
    gap = 0.0
    for got in ranks:
        got = got["moe"]
        np.testing.assert_allclose(got["out_value"], np.asarray(out),
                                   rtol=0, atol=1e-5)
        gap = max(gap, float(np.abs(got["out_value"] - out).max()))
        for name, g, w in zip(("gate", "w_in", "w_out", "x"),
                              got["grad_values"], want):
            gap = max(gap, _within_largest(g, w, 1e-5, name))
    record_property("max_abs_err", gap)


def test_pipeline_matches_reference(ranks, record_property):
    got0 = ranks[0]["pipeline"]
    w, x = jnp.asarray(got0["w"]), jnp.asarray(got0["x"])
    microbatches = torch_world.multicard_plan().pipeline[2]
    mesh = _mesh({"pp": WORLD})
    want = np.asarray(jax.jit(lambda w, x: pipeline_apply(
        lambda p, m: jnp.tanh(m @ p), w, x, mesh=mesh, axis="pp",
        microbatches=microbatches))(w, x))
    gap = 0.0
    for got in ranks:
        np.testing.assert_allclose(got["pipeline"]["out"], want, rtol=1e-5,
                                   atol=1e-5)
        gap = max(gap, float(np.abs(got["pipeline"]["out"] - want).max()))
    record_property("max_abs_err", gap)


def test_world_of_one_runs_phases_9_and_10(tmp_path):
    """Phases 9 and 10 of the chip run are phase 15's bodies on a world of
    one rank: here on gloo at the tiny plan, every check of the rank
    program and of the reports made (the dry run's line at W = 1 without
    MoE or the pipeline, the ring over {tp 1, sp 1}, no allreduce figure
    on one rank)."""
    (got,) = torch_world.run_multicard(1, tmp_path, "cpu")
    assert got["dryrun"].startswith(
        "dryrun_multichip(1): mesh={'dp': 1, 'tp': 1, 'sp': 1} loss=")
    assert "moe_ep" not in got["dryrun"]
    step = got["tp1_sp1"]
    assert step["ring"] and step["mesh"] == {"dp": 1, "tp": 1, "sp": 1}
    assert max(step["grad_rel"]) <= chip_smoke.MP_GRAD_REL
    assert got["ps"]["bench"]["world_size"] == 1
    assert set(got["ps"]["timed"]) == {"lookup", "apply_gradients",
                                       "train_step"}


# -- the world's limits -------------------------------------------------------


def _gone(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


@pytest.mark.parametrize("how", ["hang", "raise"])
def test_failed_world_names_the_rank_and_leaves_no_process(how, tmp_path):
    """Rank 1 never enters the all-reduce that rank 0 waits in (it sleeps,
    or it raises): the world ends within its limit, the error names each
    unfinished rank with its part, and every rank process is gone."""
    limit = 45.0 if how == "hang" else 120.0
    t0 = time.monotonic()
    with pytest.raises(WorldFailed) as failed:
        run_world(torch_world.stuck_body, 2, args=(str(tmp_path), how),
                  device_type="cpu", timeout_s=limit)
    took = time.monotonic() - t0
    assert took < limit + 10, took
    parts = failed.value.parts
    if how == "hang":
        assert f"ran over its {limit} s" in str(failed.value)
        assert parts == {0: "all_reduce", 1: "rank 1 hangs"}
    else:
        assert took < limit / 2, took
        assert "rank 1 in 'rank 1 raises' raised ValueError: rank 1 " \
            "raised" in str(failed.value)
        assert parts[1] == "rank 1 raises"
    pids = [int((tmp_path / f"{r}.pid").read_text()) for r in range(2)]
    assert all(_gone(pid) for pid in pids), pids


def test_world_of_more_ranks_than_cards_raises(tmp_path):
    """No fallback to the CPU: a world of more ranks than CUDA cards
    raises before any process starts, and so does phase 15's world."""
    ranks = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="CUDA devices"):
        run_world(torch_world.stuck_body, ranks, args=(str(tmp_path),
                                                       "hang"),
                  timeout_s=5.0)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        chip_smoke.multi_card_world(ranks, torch_world.multicard_plan(),
                                    str(tmp_path / "table.npy"))
    assert not list(tmp_path.iterdir())
