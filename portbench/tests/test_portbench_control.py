"""The controls fail the cells' limits: the reference in the program's
place, one step below the configured precision, and each fault planted
in it. The CPU test does so at a tiny size; the ``cuda`` test at the
cells' own sizes on three seeds (``control.py`` prints the same readings
for ``PERF.md``)."""

import pytest
import torch

from portbench import control, harness
from portbench.tests.tiny import REPO, tiny_root

SEEDS = (2 ** 31 + 101, 2 ** 32 + 202, 2 ** 33 + 303)


def failed(readings: dict, limits: dict) -> bool:
    return any(v > limits[name] for name, v in readings.items())


def held(root, cell, seed, device):
    limits = harness.load_cell(root, cell, seed, [device])[0] \
        .traffic["limits"]
    for label, numbers in control.readings(root, cell, seed, device).items():
        assert failed(numbers, limits), (cell, seed, label, numbers, limits)


@pytest.mark.parametrize("cell", ["tiny.prefill", "tiny.train", "tiny.sync"])
def test_controls_fail_at_a_tiny_size(tmp_path, cell):
    held(tiny_root(tmp_path), cell, SEEDS[0], torch.device("cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mistral7b.prefill_long",
                                  "deepseek7b.train",
                                  "mistral7b.prefill_short"])
def test_controls_fail_at_the_cells_size(cuda_device, cell):
    for seed in SEEDS:
        held(REPO, cell, seed, cuda_device)
