"""No run loads JAX or the JAX package, and the reference loads nothing of
the port: each cell's set-up in a process of its own, the top-level part of
every module name compared whole."""

import json
import subprocess
import sys

import pytest

from benchmark import harness

CELLS = ["svgp32-train", "sgpr8-fit4"]

SETUP = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import torch
from bench_sizes import small
from benchmark import harness
config, params = small({cell!r})
c = harness.cell({cell!r}, config, params)
harness.generator(c["generator"]).Workload(c, 5, torch.device("cpu"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import importlib, json, pkgutil, sys
sys.path.insert(0, {root!r})
import benchmark.reference as ref
for m in pkgutil.iter_modules(ref.__path__):
    importlib.import_module("benchmark.reference." + m.name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_s_set_up_loads_no_jax(cell):
    names = _top_level(SETUP.format(root=str(harness.ROOT), tests=str(harness.BENCH / "tests"),
                                    cell=cell))
    assert "oak_tpu_torch" in names
    assert not names & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    names = _top_level(REFERENCE.format(root=str(harness.ROOT)))
    assert "torch" in names
    assert not names & ({"oak_tpu_torch"} | set(harness.FORBIDDEN))


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "oak_tpu_torch_like", sys)
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.loaded_forbidden() == ["jax.numpy"]
