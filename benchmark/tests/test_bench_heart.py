"""The cell ``heart-fit4`` on the CPU at a small size of its own (4 columns:
2 continuous, 1 binary, 1 categorical; the look for a card skipped): its
result lines, each fault and the control not correct, its set-up loading
no JAX, and the per-layer metrics read from the spans and the counter that
only a model with discrete columns and a Bernoulli likelihood opens."""

import json
import math
import subprocess
import sys

import pytest
import torch

from benchmark import harness

CELL = "heart-fit4"
SMALL = {"num_data": 80, "train_rows": 64, "num_dims": 4, "binary_feature": [1],
         "categorical_feature": [2], "categorical_levels": {"2": 3}, "num_inducing": 16,
         "max_interaction_depth": 3, "max_iters": 3, "warm_adam_steps": 2}
NEW_METRICS = ["quad_host_ms.train", "extra_host_ms.train", "extra_grams.train"]


def small(dtype="float64"):
    """The configuration's overrides; in float64 the port's jitter is 1e-6,
    which the reference then takes too."""
    config = dict(SMALL, dtype=dtype)
    if dtype == "float64":
        config["jitter"] = 1e-6
    return config


def _k_card_route(self, X, X2=None):
    from oak_tpu_torch.ops import oak_gram as og

    return og.fused_op(og._prep(self, X, X if X2 is None else X2), self.max_interaction_depth)


@pytest.fixture
def card_route(monkeypatch):
    """OAKKernel.K through the card's route (``_prep``, the registered op)
    on CPU tensors, as on the card."""
    from oak_tpu_torch.kernels.oak_kernel import OAKKernel

    monkeypatch.setattr(OAKKernel, "K", _k_card_route)


def test_the_result_line(run_module):
    line = json.loads(json.dumps(run_module.run(CELL, 2 ** 31 + 17, 0.5, False, device="cpu",
                                                overrides=small())))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    # the device metric is left out on the CPU
    assert set(line["metrics"]) == {"setup_s"}
    assert set(line["checks"]) == {"flow_gap", "lloyd_gain", "z_codes", "loss_rel", "grad_leaf",
                                   "adam_rel", "update_rel", "dir2_rel"}


def test_the_traced_line_reads_the_new_spans_and_counter(run_module, card_route):
    line = run_module.run(CELL, 2 ** 31 + 29, 0.3, True, device="cpu", overrides=small())
    assert line["correct"] is True
    names = {m["name"] for m in harness.cell(CELL)["per_layer"]}
    assert set(NEW_METRICS) <= names
    for name in NEW_METRICS + ["prep_host_ms.train", "bound_host_ms.train",
                               "lbfgs_trials.train", "host_reads.train"]:
        value = line["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
    # two grams a grad or value evaluation, one binary and one categorical
    # extra gram a lane, and at least one lane each
    assert line["metrics"]["extra_grams.train"]["value"] >= 4


@pytest.mark.parametrize("name", NEW_METRICS)
def test_a_new_reader_is_silent_without_its_span(run_module, name):
    """What an all-continuous Gaussian cell, or a program without the span
    or counter, records: evaluations and the prescale alone."""
    from oak_tpu_torch.utils import profiling

    with profiling.recording():
        with profiling.evaluation("grad", 1):
            with profiling.trace_annotation("oak.prep"):
                pass
    reader = harness.reader(name)
    assert reader(run_module.LayerRun(None, None, {"units": 1})) is None
    assert reader(run_module.LayerRun(None, None, None)) is None


def test_the_new_metrics_are_this_cell_s_alone():
    for cell in ("svgp32-train", "sgpr8-fit4"):
        assert not {m["name"] for m in harness.cell(cell)["per_layer"]} & set(NEW_METRICS)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "steepest"])
def test_a_fault_is_not_correct(run_module, fault):
    result = run_module.run(CELL, 41, 0.3, False, device="cpu", overrides=small(), fault=fault)
    assert result["correct"] is False
    assert any(not c["value"] <= c["limit"] for c in result["checks"].values())


def test_the_control_is_not_correct():
    c = harness.cell(CELL, small("float32"))
    checks = harness.generator(c["generator"]).control_checks(c, 11, torch.device("cpu"))
    assert checks
    assert [ch.name for ch in checks if not ch.ok]


@pytest.mark.gpu
def test_the_control_is_not_correct_on_the_card(card):
    c = harness.cell(CELL, small("float32"))
    checks = harness.generator(c["generator"]).control_checks(c, 11, card)
    assert [ch.name for ch in checks if not ch.ok]


SETUP = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from benchmark import harness
c = harness.cell("heart-fit4", {config!r})
harness.generator(c["generator"]).Workload(c, 5, torch.device("cpu"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_the_set_up_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", SETUP.format(root=str(harness.ROOT),
                                                             config=small())],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "oak_tpu_torch" in names
    assert not names & set(harness.FORBIDDEN)
