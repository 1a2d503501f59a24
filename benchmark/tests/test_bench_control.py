"""The control, the reference put in the program's place one precision
below the configuration's (TF32 products for float32 with TF32 off), comes
out not correct against the cell's limits: on the CPU at a small size, its
products' operands rounded to TF32 as the card's tensor cores round them,
and on the card at the same size."""

import pytest
import torch

from bench_sizes import small
from benchmark import harness

CELLS = ["svgp32-train", "sgpr8-fit4"]


def _fails(cell, device):
    config, params = small(cell, dtype="float32")
    c = harness.cell(cell, config, params)
    checks = harness.generator(c["generator"]).control_checks(c, 11, device)
    assert checks
    return [ch.name for ch in checks if not ch.ok]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    assert _fails(cell, torch.device("cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(cell, card):
    assert _fails(cell, card)
