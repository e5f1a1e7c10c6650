"""``chip_smoke.py`` phase 15 on NCCL worlds of 2 and 4 cards, one rank a
card, at ``tests/torch_world.py``'s small plan.

Each world runs the phase's own rank program (``chip_smoke.mc_rank``),
whose parts check themselves on every rank: the dry run's gates and its
mesh rule; the sharded steps' loss and gradients against the unsharded
step within ``MP_GRAD_REL``; ring and Ulysses against dense attention
within ``MP_ATTN_TOL``; MoE at ep = W against ep = 1 and the pipeline
against its stages in turn within ``MP_SMALL_TOL``; the PS bit-equal to
host replays, one K2 and one K3 launch a call on every card; the
``CollectiveChannel`` ops against their definitions. Here the PS's lookup
and update are also held bit for bit against the same world on the CPU
(gloo, the kernels' plain versions). No JAX here: the file runs on the
card's machine; ``tests/test_torch_multicard.py`` holds the CPU world
against the reference.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import torch_world


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_phase_15_world_on_cards(world, tmp_path):
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA devices, found "
                    f"{torch.cuda.device_count()}")
    (tmp_path / "cuda").mkdir()
    (tmp_path / "cpu").mkdir()
    cards = torch_world.run_multicard(world, tmp_path / "cuda", "cuda")
    hosts = torch_world.run_multicard(world, tmp_path / "cpu", "cpu")
    calls = 1 + chip_smoke.PS_TRAIN_STEPS
    for card, host in zip(cards, hosts):
        assert card["ps"]["launches"] == {"gather_rows": calls,
                                          "scatter_sub": calls}
        for key in ("rows", "applied"):
            np.testing.assert_array_equal(card["ps"][key].view(np.int32),
                                          host["ps"][key].view(np.int32))


@pytest.mark.cuda
def test_native_tpu_ps_with_its_shards_on_two_cards(tmp_path):
    """The port's native ``tpu_ps`` at Llama-3-8B's table with its two
    shards on cards 0 and 1 (the plugin's default: one device a card): its
    Pushes grow each card's default pool by 1 GB tables, then its
    collectives run across the cards. With those pools kept and opened to
    the peer card, the first collective's output failed to allocate on
    card 1 (cudaErrorMemoryAllocation, 83 GB free); the collectives now
    take their buffers from each card's released peer pool. Every check
    must pass."""
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs 2 CUDA devices, found "
                    f"{torch.cuda.device_count()}")
    import json
    import subprocess

    from brpc_tpu_torch import native_device as nd

    plugin = nd.build_plugin("cuda")
    program = nd.build_program(nd.CSRC / "examples" / "tpu_ps.cc")
    out = subprocess.run(
        [str(program), "--plugin", str(plugin), "--rows",
         str(chip_smoke.PS_VOCAB), "--dim", str(chip_smoke.PS_DIM), "--k",
         str(chip_smoke.PS_K), "--shards", "2"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert out.returncode == 0 and report["ok"], report["error"]
    assert all(report["checks"].values()), report["checks"]
    assert {c["replicas"] for c in report["collectives"]} >= {1, 2}
