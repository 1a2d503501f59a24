"""Seconds that ``serialize_predict`` takes against the depth of the
caller's Python stack.

``torch.export`` records the Python stack at every graph node it creates,
so a trace made on the caller's thread costs more the deeper the caller
sits (a server's handler, a script's phases). ``serving.serialize_predict``
traces on a thread of its own. This script times, for the committed
pumadyn fold-0 model (SGPR, D 8, depth 8, M 500) at the top level and
DEPTH frames deeper: ``serialize_predict``, and ``torch.export.export``
of the same module on the caller's thread. It prints one line per
measurement and, last, one JSON object with the seconds.

    python examples/uci_torch/export_timing.py               # on the card
    python examples/uci_torch/export_timing.py --device cpu
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from oak_tpu_torch import load_oak_model  # noqa: E402
from oak_tpu_torch.serving import serialize_predict  # noqa: E402

MODEL = REPO / "examples" / "uci" / "outputs" / "pumadyn" / "model_oak_0.npz"
DEPTH = 30


def _at_depth(depth, fn):
    if depth == 0:
        return fn()
    return _at_depth(depth - 1, fn)


def _seconds(fn):
    t = time.perf_counter()
    fn()
    return time.perf_counter() - t


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    args = parser.parse_args()
    if args.device is None and not torch.cuda.is_available():
        sys.exit("no CUDA device; give --device cpu")
    if torch.cuda.is_available() and args.device in (None, "cuda"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    oak = load_oak_model(MODEL, device=args.device)
    predict = oak.export_predict()
    sample = torch.stack([predict.xmin, predict.xmax])
    dims = {"X": {0: torch.export.Dim("batch")}}

    def on_caller():
        with torch.no_grad():
            torch.export.export(predict, (sample,), dynamic_shapes=dims)

    ways = {"serialize_predict": lambda: serialize_predict(oak),
            "export on the caller's thread": on_caller}
    print(f"warm-up serialize_predict {_seconds(ways['serialize_predict']):.3f} s "
          f"(torch {torch.__version__}, {oak.dtype} on {oak.device})", flush=True)
    result = {}
    for depth in (0, DEPTH):
        for name, fn in ways.items():
            s = _at_depth(depth, lambda: _seconds(fn))
            result[f"{name}, {depth} frames deeper"] = s
            print(f"{name}, {depth} frames deeper: {s:.3f} s", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
