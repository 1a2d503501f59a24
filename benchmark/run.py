"""Run one cell of ``BENCHMARK.json`` once on the CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (building, warm-up, the first steps that the correctness check
reads) is timed from the start of this script to the first timed
operation. Then the cell's traffic runs for ``--seconds``: with
``--trace 0`` the window runs under torch.profiler with the device's
activity alone and the result's metrics are the cell's end-to-end metrics
(a device metric only on the card), with
``--trace 1`` a window runs under torch.profiler and the metrics are the
cell's per-layer ones. After the window the program's state is freed and
the plain reference (``benchmark/reference``) decides ``correct``. The last
line of standard output is one JSON object; the numbers compared, each with
its limit, end standard error and the result line.

Exits 1 without a result when there is no card (or fewer than the cell
asks for), when a file of the cell is missing, or when JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"
# Fixed cache directories inside the checkout, so that only a checkout's
# first run builds and compiles; set before torch (and triton) are imported.
# The port's CUDA library builds into <checkout>/.kernel_build.
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
# a library that would load JAX by itself does not
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if sys.path and Path(sys.path[0]).resolve() == BENCH:
    sys.path[0] = str(ROOT)
else:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import devtrace, harness  # noqa: E402


class LayerRun:
    """What a per-layer reader reads: the traced window's ``trace`` (None
    when the profiler saw no device), the ``window``, and ``work``, the
    generator's account of the traced units (``units``, ``K1`` and ``K2``
    lists of ``roofline.Work`` per launch, ``flops``)."""

    def __init__(self, trace, window, work):
        self.trace, self.window, self.work = trace, window, work


def card(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise harness.CellError("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise harness.CellError(f"{torch.cuda.device_count()} CUDA devices, the cell "
                                f"asks for {chips}")
    return torch.device("cuda", 0)


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def run(workload: str, seed: int, seconds: float, trace: bool, device=None,
        overrides=None, params=None, fault=None, log=sys.stderr) -> dict:
    """One run of the cell; returns the result object. ``device`` None means
    the card, checked; tests pass the CPU, ``overrides`` of the
    configuration's sizes and ``params`` of the traffic's, and ``fault``,
    which breaks the timed path underneath."""
    c = harness.cell(workload, overrides, params)
    if device is None:
        device = card(c["chips"])
        print(f"card: {power_limit()}", file=log)
    device = torch.device(device)
    # the configurations state float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = harness.generator(c["generator"]).Workload(c, seed, device, fault)
    harness.sync(device)
    setup_s = time.perf_counter() - T_START
    print(f"set-up: {setup_s:.3f} s", file=log)

    metrics, dev_extra, breakdown = {}, {}, None
    if trace:
        window, dtrace = work.traced_window(seconds)
        run_ = LayerRun(dtrace, window, work.work)
        for m in c["per_layer"]:
            value = harness.reader(m["name"])(run_)
            if value is None:
                print(f"per-layer {m['name']}: nothing to read", file=log)
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if dtrace is not None:
            dev_extra = {"busy_s": dtrace.busy_s, "window_s": dtrace.window_s}
            breakdown = {"device_ops": dtrace.device_ops, "idle_gaps": dtrace.idle_gaps}
    else:
        window, busy_s = devtrace.busy(lambda: work.window(seconds))
        window.extra["busy_s"] = busy_s
        values = dict(work.end_to_end(window), setup_s=setup_s)
        for m in c["end_to_end"]:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
            else:
                print(f"end-to-end {m['name']}: nothing to read", file=log)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print(f"window: {window.units} units in {window.seconds:.3f} s", file=log)

    # the program's state goes before the reference runs: it keeps only the
    # readings it is judged by
    work.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = work.checks()
    del work
    print(f"reference and checks: {time.perf_counter() - t_check:.3f} s", file=log)
    for ch in checks:
        print(f"check {ch.name}: {ch.value!r} limit {ch.limit!r} "
              f"{'ok' if ch.ok else 'FAILED'}", file=log)
    result = {
        "correct": bool(checks) and all(ch.ok for ch in checks),
        "attempted": window.units,
        "failed": window.failed,
        "metrics": metrics,
        "device": dict({"platform": "gpu" if device.type == "cuda" else device.type,
                        "kind": (torch.cuda.get_device_name(device)
                                 if device.type == "cuda" else "cpu"),
                        "count": c["chips"], "memory_peak_bytes": int(peak)}, **dev_extra),
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {ch.name: {"value": ch.value, "limit": ch.limit} for ch in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except harness.CellError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 1
    loaded = harness.loaded_forbidden()
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
