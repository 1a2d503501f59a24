"""The readings that a cell's limits are set from, in one process: the
program's numbers on many seeds, the control's (the reference in the
program's place, one precision below the configuration's) and each
fault's.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--faults unchanged half_batch altered] \
        [--fault-seeds 1 2 3] [--seconds 0] [--out chiprun_out/control.jsonl]

Each reading is one JSON line on standard output (and in ``--out``); the
last line sums them up: per number, the largest over the program's seeds
and the smallest over the control's and each fault's. The benchmark's own
runs never run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def readings(args, device=None, overrides=None, params=None, emit=print):
    c = harness.cell(args.workload, overrides, params)
    device = torch.device(device or "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    drv = harness.generator(c["generator"])
    summary = {}

    def record(kind, seed, checks, seconds):
        line = {"kind": kind, "seed": seed, "seconds": seconds,
                "checks": {ch.name: ch.value for ch in checks}}
        emit(json.dumps(line))
        agg = summary.setdefault(kind, {})
        pick = max if kind == "program" else min
        for ch in checks:
            agg[ch.name] = pick(agg.get(ch.name, ch.value), ch.value)

    def program(seed, fault=None):
        t = time.perf_counter()
        s = drv.Workload(c, seed, device, fault)
        if args.seconds:
            s.window(args.seconds)
        s.release()
        gc.collect()
        checks = s.checks()
        record(fault or "program", seed, checks, time.perf_counter() - t)

    for seed in args.seeds:
        program(seed)
    for seed in args.control_seeds:
        t = time.perf_counter()
        record("control", seed, drv.control_checks(c, seed, device), time.perf_counter() - t)
    for fault in args.faults:
        for seed in args.fault_seeds:
            program(seed, fault)
    emit(json.dumps({"summary": summary}))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = open(args.out, "a") if args.out else None

    def emit(line):
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        readings(args, emit=emit)
    finally:
        if out:
            out.close()


if __name__ == "__main__":
    main()
