"""What every cell shares: finding a cell's files by name, the measured
window, the checks and the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. Its
file ``workloads/<cell>.json`` holds the same names, the traffic generator
(``traffic/<generator>.py``) and the generator's parameters; the configuration is
``configs/<config>.json``; each per-layer metric is read by
``metrics/<metric>.py``. A generator module defines ``Workload(cell, seed,
device, fault=None)``, whose construction is the set-up, and the methods
``window(seconds)``, ``traced_window(seconds)``, ``end_to_end(window)``,
``release()`` and ``checks()`` (see ``traffic/adam_steps.py``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"
# Top-level module names that no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "oak_tpu")


class CellError(RuntimeError):
    """The cell cannot run here; the run exits without a result."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The Python file ``path`` as a module of its own (names such as
    ``launches.train`` are not identifiers)."""
    name = "benchmark._loaded." + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise CellError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def cell(workload: str, overrides: Optional[dict] = None,
         params: Optional[dict] = None) -> dict:
    """The cell ``workload``: its ``BENCHMARK.json`` entry, joined with its
    cell file (``params``, ``generator``) and its configuration (``config``),
    the metrics it reports, and ``overrides`` merged into the configuration
    and ``params`` into the parameters (tests shrink sizes so)."""
    spec_path = ROOT / "BENCHMARK.json"
    if not spec_path.exists():
        raise CellError(f"{spec_path} is missing")
    spec = load_json(spec_path)
    cell_path = BENCH / "workloads" / f"{workload}.json"
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    if not cell_path.exists():
        raise CellError(f"{cell_path} is missing")
    body = load_json(cell_path)
    conf_path = BENCH / "configs" / f"{entry['config']}.json"
    if not conf_path.exists():
        raise CellError(f"{conf_path} is missing")
    for key in ("config", "traffic", "chips"):
        if body[key] != entry[key]:
            raise CellError(f"{cell_path.name}: {key} {body[key]!r} is not "
                            f"BENCHMARK.json's {entry[key]!r}")
    config = load_json(conf_path)
    config.update(overrides or {})
    body["params"].update(params or {})

    def reported(m):
        return workload in m.get("workloads", [workload])

    return {"name": workload, "chips": entry["chips"], "generator": body["generator"],
            "params": body["params"], "config": config,
            "end_to_end": [m for m in spec["end_to_end"] if reported(m)],
            "per_layer": [m for m in spec["per_layer"] if reported(m)]}


def generator(name: str):
    path = BENCH / "traffic" / f"{name}.py"
    if not path.exists():
        raise CellError(f"no traffic generator {path}")
    return load_module(path)


def reader(metric: str) -> Callable:
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.exists():
        raise CellError(f"no reader {path} for the metric {metric}")
    return load_module(path).read


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Window:
    """What a measured window did: ``units`` completed (steps, evaluations,
    calls or requests), ``failed`` of them, over ``seconds``; ``extra``
    holds what a generator reads its end-to-end metrics from."""
    units: int
    failed: int
    seconds: float
    extra: dict = dataclasses.field(default_factory=dict)


def closed_loop(unit: Callable[[], None], seconds: float, device: torch.device) -> Window:
    """``unit`` one after another until ``seconds`` have passed on the host
    clock, then a synchronisation: the window runs from the first call to
    the end of the device's work."""
    sync(device)
    t0 = time.perf_counter()
    end, n = t0 + seconds, 0
    while True:
        unit()
        n += 1
        if time.perf_counter() >= end:
            break
    sync(device)
    return Window(units=n, failed=0, seconds=time.perf_counter() - t0)


@dataclasses.dataclass
class Check:
    """One number that decides ``correct``: it passes at or under its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep: Optional[List[str]] = None) -> float:
    """The worst leaf's | |prog| - |ref| | (Euclidean norms), against the
    larger of that leaf's |ref| and the median leaf's |ref|; over the leaves
    ``keep`` (default all)."""
    names = list(ref) if keep is None else keep
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in ref}
    median = sorted(norms.values())[len(norms) // 2]
    worst = 0.0
    for k in names:
        p = float(torch.linalg.vector_norm(prog[k].double()))
        gap = abs(p - norms[k]) / max(norms[k], median, 1e-300)
        # a NaN would drop out of max(): no number is no match
        worst = max(worst, gap if math.isfinite(gap) else float("inf"))
    return worst


def loaded_forbidden() -> List[str]:
    """The modules in ``sys.modules`` whose top-level name is forbidden."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
