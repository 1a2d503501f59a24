"""The program's spans and counters as per-layer metrics: each cell's
``--trace 1`` result line, driven on the CPU at small sizes, carries every
metric read from ``benchmark/spans.py`` with a finite value, and a reader is
silent where the program's count of evaluations is not the generator's."""

import math

import pytest

from bench_sizes import small
from benchmark import harness

CELLS = ["svgp32-train", "sgpr8-fit4"]


SPAN_METRICS = ["prep_host_ms.train", "gram_host_ms.train", "linalg_host_ms.train",
                "bound_host_ms.train", "backward_host_ms.train", "update_host_ms.train",
                "host_reads.train", "lbfgs_trials.train"]


def _span_metrics(cell):
    """The cell's per-layer metrics read from the program's record."""
    return [m["name"] for m in harness.cell(cell)["per_layer"] if m["name"] in SPAN_METRICS]


@pytest.mark.parametrize("cell", CELLS)
def test_the_traced_line_carries_every_span_metric(run_module, cell):
    names = _span_metrics(cell)
    assert len(names) == (8 if cell == "sgpr8-fit4" else 7)
    config, params = small(cell)
    line = run_module.run(cell, 2 ** 31 + 29, 0.3, True, device="cpu", overrides=config,
                          params=params)
    assert line["correct"] is True
    for name in names:
        assert name in line["metrics"], name
        value = line["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, (name, value)
    if cell == "svgp32-train":
        # an Adam step reads nothing back from the device
        assert line["metrics"]["host_reads.train"]["value"] == 0
    else:
        assert line["metrics"]["lbfgs_trials.train"]["value"] >= 1
        assert line["metrics"]["host_reads.train"]["value"] > 0


def test_a_reader_is_silent_where_the_evaluations_differ(run_module):
    from oak_tpu_torch.utils import profiling

    with profiling.recording():
        with profiling.evaluation("grad", 1):
            with profiling.trace_annotation("oak.prep"):
                pass
    for name in _span_metrics("sgpr8-fit4"):
        reader = harness.reader(name)
        assert reader(run_module.LayerRun(None, None, {"units": 2})) is None, name
        assert reader(run_module.LayerRun(None, None, None)) is None, name
    value = harness.reader("prep_host_ms.train")(run_module.LayerRun(None, None, {"units": 1}))
    assert value is not None and value >= 0


def test_a_program_without_spans_gives_no_reading(run_module, monkeypatch):
    from oak_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "record")
    for name in _span_metrics("sgpr8-fit4"):
        assert harness.reader(name)(run_module.LayerRun(None, None, {"units": 1})) is None
