"""The port's sharded train step and dry run against the reference's.

One gloo world of 8 processes (``tests/torch_world.py``) runs every case
of this module on the port's side; the reference runs on the 8 virtual CPU
devices of ``tests/conftest.py``. Params are the reference's
``init_params`` loaded through ``params_from_jax``. Tolerances, each with
its reason and the gap measured on this tree:

- ``tests/test_llama.py:44``'s mesh (dp=4 x tp=2, SGD 1e-2, tokens
  (8, 16)) at f32 compute, port-sharded against the reference's sharded
  step: loss and every updated leaf within 1e-5, the same arithmetic
  summed in another order (measured: loss 0, params 6.0e-8);
- the same at bf16, port-sharded against the port's one-rank step: that
  test's own gates, loss rtol 1e-4 and params 2e-2 (measured: loss 0,
  params 2.4e-6; the row-parallel products sum their partials in f32 and
  round once, as the unsharded product does, and their backward is the
  unsharded product's bf16 one; partials rounded to bf16 before the sum
  gave a loss rtol of 1.2e-4);
- the dry run's composition (dp=2 x tp=2 x sp=2, ``ring_attention`` over
  'sp' with the heads over 'tp', AdamW 1e-3, tokens (2, 32)) at f32
  against the reference's same composition: the loss within 1e-5
  (measured 9.5e-7 with zeros and with random tokens), and per leaf the
  update's relative L2 error, |Δport - Δref| / |Δref|, within
  ``chip_smoke.TINY_TRAIN_UPDATE_REL`` = 1e-2 (measured at most 5.8e-4
  with zeros, 8.3e-5 with random tokens; AdamW moves a param by about
  lr·sign(g), so where |g| is below the rounding of the two gradients a
  param moves by different fractions of lr and elementwise tolerances
  measure noise). With zeros, wq's and wk's gradients vanish in exact
  arithmetic and their updates are noise on both sides: they are held at
  the dry run's elementwise gate of 5e-3 (measured 9.4e-4);
- the tp shards and collectives: each rank's ``wq`` is [L, h, Hq·D/tp],
  and the step's collectives are the Megatron set, recorded by a
  dispatch mode: 4L + 2 all-reduces of activations over 'tp', one
  all-gather (the logits) over 'tp', one all-reduce over 'dp' for every
  gradient and one for the loss, and nothing else;
- checkpoints of tp-sharded params on 8 ranks: bit-equal after restore.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_world
from brpc_tpu.models import llama as ref
from brpc_tpu.parallel import (make_mesh, ring_attention, shard_batch,
                               shard_params)
from jax.sharding import PartitionSpec as JP

WORLD = 8
UPDATE_REL = 1e-2  # chip_smoke.TINY_TRAIN_UPDATE_REL
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flatten(prefix, tree):
    """``{prefix + 'layers.wq': array, ...}`` for the rank programs."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(f"{prefix}{key}.", value))
        else:
            out[f"{prefix}{key}"] = np.asarray(value, np.float32)
    return out


def _cfg(vocab, dtype=jnp.float32):
    return dataclasses.replace(ref.LlamaConfig.tiny(vocab), dtype=dtype)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(inputs of the ranks, the reference's results)."""
    inputs, want = {}, {}
    params = ref.init_params(jax.random.PRNGKey(0), _cfg(64))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (8, 16),
                                           0, 64), np.int32)
    inputs.update(_flatten("tp_params.", params))
    inputs["tp_tokens"] = tokens
    opt = optax.sgd(1e-2)
    step = jax.jit(ref.make_train_step(_cfg(64), opt))
    mesh = make_mesh({"tp": 2})
    sharded = shard_params(params, ref.param_specs(_cfg(64)), mesh)
    p, _, loss = step(sharded, opt.init(sharded),
                      shard_batch(tokens, ref.batch_specs(), mesh))
    want["tp_loss"] = float(loss)
    want["tp_params"] = [np.asarray(a) for a in jax.tree_util.tree_leaves(p)]

    cfg = _cfg(256)
    params = ref.init_params(jax.random.PRNGKey(0), cfg)
    inputs.update(_flatten("dry_params.", params))
    want["dry_init"] = [np.asarray(a)
                        for a in jax.tree_util.tree_leaves(params)]
    mesh = make_mesh({"tp": 2, "sp": 2})

    def ring(q, k, v):
        return ring_attention(q, k, v, mesh=mesh, axis="sp", causal=True,
                              head_axis="tp")

    opt = optax.adamw(1e-3)
    step = jax.jit(ref.make_train_step(cfg, opt, ring))
    inputs["dry_zeros"] = np.zeros((2, 32), np.int32)
    inputs["dry_random"] = np.random.default_rng(7).integers(
        0, 256, (2, 32), np.int32)
    for name in ("zeros", "random"):
        sharded = shard_params(params, ref.param_specs(cfg), mesh)
        with mesh:
            p, _, loss = step(sharded, opt.init(sharded), shard_batch(
                inputs[f"dry_{name}"], JP("dp", "sp"), mesh))
        want[f"dry_{name}_loss"] = float(loss)
        want[f"dry_{name}_params"] = [np.asarray(a) for a in
                                      jax.tree_util.tree_leaves(p)]
    inputs["ckpt_dir"] = np.array(str(tmp_path_factory.mktemp("ckpt")))
    return inputs, want


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    workdir = tmp_path_factory.mktemp("sharded_train_world")
    np.savez(workdir / "inputs.npz", **reference[0])
    return torch_world.run("sharded_train", WORLD, workdir)


def _leaves(got, prefix, n):
    return [got[f"{prefix}{i}"] for i in range(n)]


def test_tp_dp_step_matches_reference_at_f32(reference, ranks):
    want = reference[1]
    n = len(want["tp_params"])
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(float(got["tp_f32_loss"]), want["tp_loss"],
                                   rtol=0, atol=1e-5)
        for i, (g, w) in enumerate(zip(_leaves(got, "tp_f32_p", n),
                                       want["tp_params"])):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                       err_msg=f"leaf {i} on rank {rank}")


def test_tp_dp_step_matches_one_rank_at_bf16(ranks):
    """tests/test_llama.py:44's own gates, on the port's two steps."""
    n = sum(k.startswith("one_bf16_p") for k in ranks[0])
    for got in ranks:
        np.testing.assert_allclose(float(got["tp_bf16_loss"]),
                                   float(got["one_bf16_loss"]), rtol=1e-4)
        for g, w in zip(_leaves(got, "tp_bf16_p", n),
                        _leaves(got, "one_bf16_p", n)):
            np.testing.assert_allclose(g, w, rtol=2e-2, atol=2e-2)


def test_one_rank_step_matches_reference_at_f32(reference, ranks):
    """The port's unsharded step on the same batch: the sharded one's
    yardstick on the port's side."""
    want = reference[1]
    for got in ranks:
        np.testing.assert_allclose(float(got["one_f32_loss"]),
                                   want["tp_loss"], rtol=0, atol=1e-5)


def test_each_rank_computes_on_its_tp_shard(ranks):
    cfg = ref.LlamaConfig.tiny(64)
    for got in ranks:
        assert tuple(got["wq_local_shape"]) == (
            cfg.n_layers, cfg.hidden, cfg.n_heads * cfg.head_dim // 2)


def test_step_issues_the_megatron_collectives_and_no_weight_gather(ranks):
    cfg = ref.LlamaConfig.tiny(64)
    b, t, h, vocab = 8 // 4, 16, cfg.hidden, cfg.vocab_size
    n_leaves = 12
    for rank, got in enumerate(ranks):
        tp_group = (rank - rank % 2, rank - rank % 2 + 1)
        dp_group = tuple(range(rank % 2, WORLD, 2))
        reduces = {tp_group: [], dp_group: []}
        gathers = []
        for op, shapes, group in ast.literal_eval(str(got["calls"])):
            if op == "allreduce_":
                reduces[group].append(shapes)
            else:
                gathers.append((group, shapes))
        # forward: the embedding and each layer's two row-parallel
        # products; backward: each layer's two column-parallel inputs and
        # the LM head's
        assert reduces[tp_group] == [[(b, t, h)]] * (4 * cfg.n_layers + 2)
        # the logits, and no weight
        assert gathers == [(tp_group, [(2 * b, t, vocab // 2),
                                       (b, t, vocab // 2)])], gathers
        # every gradient's shard, then the loss
        assert len(reduces[dp_group]) == n_leaves + 1
        assert reduces[dp_group][-1] == [()]


# With every token the same, every value vector is the same, so attention
# returns it whatever its weights: wq's and wk's gradients are zero in
# exact arithmetic, and AdamW moves both by its normalisation of rounding
# noise, on either side. Those two leaves are held at the dry run's own
# elementwise gate.
_NOISE_ONLY = {"zeros": {"wk", "wq"}, "random": set()}
_LEAF_NAMES = ["embed", "final_norm", "attn_norm", "mlp_norm", "w_down",
               "w_gate", "w_up", "wk", "wo", "wq", "wv", "lm_head"]


@pytest.mark.parametrize("tokens", ["zeros", "random"])
def test_dryrun_composition_matches_reference(reference, ranks, tokens,
                                              record_property):
    inputs, want = reference
    init = want["dry_init"]
    loss_gap = rel_gap = 0.0
    for rank, got in enumerate(ranks):
        loss = float(got[f"dry_{tokens}_loss"])
        np.testing.assert_allclose(loss, want[f"dry_{tokens}_loss"],
                                   rtol=0, atol=1e-5)
        loss_gap = max(loss_gap, abs(loss - want[f"dry_{tokens}_loss"]))
        for name, g, w, p0 in zip(
                _LEAF_NAMES, _leaves(got, f"dry_{tokens}_p", len(init)),
                want[f"dry_{tokens}_params"], init):
            if name in _NOISE_ONLY[tokens]:
                np.testing.assert_allclose(g, w, rtol=5e-3, atol=5e-3)
                continue
            rel = float(np.linalg.norm(g - w) / np.linalg.norm(w - p0))
            assert rel <= UPDATE_REL, (rank, name, rel)
            rel_gap = max(rel_gap, rel)
    record_property("loss_abs_err", loss_gap)
    record_property("update_rel_err", rel_gap)


def test_step_refuses_a_tp_that_splits_heads_and_dense_sp(ranks):
    for got in ranks:
        assert "n_kv_heads" in str(got["tp4_raises"])
        assert "ring_attention" in str(got["sp_dense_raises"])


def test_tp_sharded_checkpoint_round_trip_on_eight_ranks(ranks):
    for got in ranks:
        assert int(got["ckpt_latest_7"]) == 7
        assert int(got["ckpt_step"]) == 7
        assert bool(got["ckpt_bit_equal"])
        assert int(got["ckpt_latest_9"]) == 9
        # steps saved by all ranks at once, one after another, the same
        # step twice, pruned to two: each restored in full (checked on
        # the ranks), no partial left behind
        assert list(got["ckpt_dirs"]) == ["12", "13"]


@pytest.mark.parametrize("n", [8, 4])
def test_dryrun_multichip_on_cpu(n):
    """``dryrun_multichip(n, device_type="cpu")`` runs its own gloo world
    of n ranks and passes the reference's gates; its summary line has the
    reference's form and mesh."""
    code = ("from brpc_tpu_torch.dryrun import dryrun_multichip; "
            f"dryrun_multichip({n}, device_type='cpu')")
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    mesh = {8: "{'dp': 2, 'tp': 2, 'sp': 2}", 4: "{'dp': 1, 'tp': 2, "
            "'sp': 2}"}[n]
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith(f"dryrun_multichip({n}): mesh={mesh} loss=")
    assert " moe_ep=2(loss=" in lines[0]
    assert lines[1] == "  pp=2 pipeline step ok"


def test_dryrun_on_cuda_without_the_cards_raises():
    """No fallback to the CPU: too few cards is an error."""
    from brpc_tpu_torch.dryrun import dryrun_multichip

    with pytest.raises(RuntimeError, match="CUDA devices"):
        dryrun_multichip(torch.cuda.device_count() + 1)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card_world(tmp_path):
    """A one-process world with gloo for CPU tensors and NCCL for the
    card's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    torch.cuda.set_device(0)
    store = dist.FileStore(os.path.join(tmp_path, "store"), 1)
    dist.init_process_group("cpu:gloo,cuda:nccl", store=store, rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_sharded_step_on_card_matches_one_rank(card_world):
    """The sharded step on a one-rank NCCL mesh, ring attention over 'sp',
    against the unsharded step on the card at f32, within 1e-5."""
    from brpc_tpu_torch import optim
    from brpc_tpu_torch.dryrun import dryrun_multichip
    from brpc_tpu_torch.models import llama
    from brpc_tpu_torch.parallel import PartitionSpec, make_mesh as mesh_of
    from brpc_tpu_torch.parallel import ring_attention as ring
    from brpc_tpu_torch.parallel import shard_batch as put
    from brpc_tpu_torch.parallel import shard_params as shard
    from brpc_tpu_torch.utils.tree import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(256),
                              dtype=torch.float32)
    init = llama.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 64), np.int32))
    mesh = mesh_of({"tp": 1, "sp": 1})
    params = llama.trainable(shard(init, llama.param_specs(cfg), mesh))
    loss = llama.make_train_step(
        cfg, optim.sgd(params, 1e-2),
        lambda q, k, v: ring(q, k, v, mesh=mesh, axis="sp",
                             head_axis="tp"))(
        params, put(tokens, PartitionSpec("dp", "sp"), mesh))
    one = llama.trainable(tree_map(lambda t: t.to("cuda", copy=True),
                                   init))
    want = llama.make_train_step(cfg, optim.sgd(one, 1e-2))(
        one, tokens.cuda())
    assert abs(loss.item() - want.item()) <= 1e-5
    for g, w in zip(tree_leaves(params), tree_leaves(one)):
        np.testing.assert_allclose(g.detach().full_tensor().cpu().numpy(),
                                   w.detach().cpu().numpy(), atol=1e-5,
                                   rtol=0)
    assert "mesh={'dp': 1, 'tp': 1, 'sp': 1}" in dryrun_multichip(1)

