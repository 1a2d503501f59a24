"""A run with its timed path broken underneath comes out not correct: each
fault that a cell can have, driven on the CPU at a small size (the look for
a card skipped), against the cell's own limits. A sound run at the same
size comes out correct."""

import pytest

from bench_sizes import small

FAULTS = [("svgp32-train", "unchanged"), ("svgp32-train", "half_batch"),
          ("svgp32-train", "altered"),
          ("sgpr8-fit4", "unchanged"), ("sgpr8-fit4", "half_batch"), ("sgpr8-fit4", "altered"),
          ("sgpr8-fit4", "steepest")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_is_not_correct(run_module, cell, fault):
    config, params = small(cell)
    result = run_module.run(cell, 41, 0.3, False, device="cpu", overrides=config,
                            params=params, fault=fault)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("cell", sorted({c for c, _ in FAULTS}))
def test_a_sound_run_is_correct(run_module, cell):
    config, params = small(cell)
    result = run_module.run(cell, 41, 0.3, False, device="cpu", overrides=config,
                            params=params)
    assert result["correct"] is True
