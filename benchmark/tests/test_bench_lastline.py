"""The result line of a run, driven on the CPU at small sizes (the look for
a card skipped), and the exits without a result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_sizes import small
from benchmark import devtrace, harness

CELLS = ["svgp32-train", "sgpr8-fit4"]


def _check_line(result, cell, trace):
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    c = harness.cell(cell)
    if trace:
        names = {m["name"] for m in c["per_layer"]}
        assert set(line["metrics"]) <= names
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        # on the CPU there is no device trace: its metrics are left out,
        # never written from the host
        expected = [m for m in c["end_to_end"] if m["source"] != "device_trace"]
        assert set(line["metrics"]) == {m["name"] for m in expected}
        assert "setup_s" in line["metrics"]
        for m in expected:
            assert line["metrics"][m["name"]]["unit"] == m["unit"]
            assert line["metrics"][m["name"]]["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(run_module, cell):
    config, params = small(cell)
    _check_line(run_module.run(cell, 2 ** 31 + 17, 0.5, False, device="cpu", overrides=config,
                               params=params), cell, trace=False)


def test_traced_result_line(run_module):
    config, params = small("svgp32-train")
    _check_line(run_module.run("svgp32-train", 3, 0.3, True, device="cpu", overrides=config,
                               params=params), "svgp32-train", trace=True)


def test_each_cell_reports_a_device_metric_end_to_end():
    for cell in CELLS:
        sources = {m["source"] for m in harness.cell(cell)["end_to_end"] if m["name"] != "setup_s"}
        assert "device_trace" in sources


def test_busy_time_counts_overlaps_once():
    assert devtrace.busy_seconds([(5, 9), (0, 2), (1, 3), (9, 10)], 0.5) == 4.0


def _main(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, script, "--workload", "svgp32-train", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _main(harness.ROOT, "benchmark/run.py")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _main(tmp_path, "benchmark/run.py")
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_an_unlisted_cell_is_no_cell_of_a_run():
    listed = {w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]}
    assert listed == set(CELLS)
    with pytest.raises(harness.CellError):
        harness.cell("svgp32-sobol")
