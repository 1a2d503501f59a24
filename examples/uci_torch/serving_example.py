"""Serving-export walkthrough on the PyTorch port: train an OAK model,
serialize its predict path, and serve from the artifact.

The artifact (a graph with a dynamic batch dimension and the parameters
as constants) needs no model rebuild, no checkpoint and no preprocessing
objects at serving time: the flows and scalers are in the graph. On the
card it is compiled, as ``oak_tpu``'s StableHLO artifact is
(examples/serving_example.py): an AOTInductor package whose gram is the
Triton K1, which a process with torch alone loads with
``torch._inductor.aoti_load_package(path)``, without ``oak_tpu_torch`` or
the CUDA toolkit. On the CPU it is a ``torch.export`` program
(``torch.export.load(path).module()``).

    python examples/uci_torch/serving_example.py               # on the card
    python examples/uci_torch/serving_example.py --device cpu
"""

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

try:  # installed package
    from oak_tpu_torch import deserialize_predict, oak_model, serialize_predict
except ImportError:  # a checkout: put its root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from oak_tpu_torch import deserialize_predict, oak_model, serialize_predict


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?", default=None,
                    help="where to write the serialized predict artifact "
                         "(default: a temporary file)")
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--max_iters", type=int, default=1000)
    ap.add_argument("--device", default="cuda",
                    help="torch device the model is built and served on (float32)")
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    n = args.n
    n_train = (3 * n) // 4
    X = rng.normal(size=(n, 5))
    w = rng.normal(size=5)
    y = (np.sin(X @ w) + 0.4 * X[:, 0] * X[:, 1] + 0.05 * rng.normal(size=n)).reshape(-1, 1)

    oak = oak_model(max_interaction_depth=2, device=args.device)
    oak.fit(X[:n_train], y[:n_train], optimise=False)
    oak.optimise(max_iters=args.max_iters)

    with tempfile.TemporaryDirectory() as tmp:
        path = args.path or str(Path(tmp) / "oak_predict.pt2")
        blob = serialize_predict(oak, path, include_var=True)
        print(f"serialized predict artifact: {len(blob)} bytes -> {path}")

        # ---- another process would start here: the artifact only ----
        serve = deserialize_predict(path)
        mean, std = (t.cpu().numpy() for t in serve(X[n_train:]))
        if args.device.startswith("cuda"):
            # the card's package needs torch alone
            import torch

            package = torch._inductor.aoti_load_package(path)
            alone = package(torch.as_tensor(X[n_train:], dtype=torch.float32,
                                            device=args.device))[0]
            same = np.array_equal(alone.cpu().numpy(), mean)
            print(f"loaded with torch alone: the same means {same}")
    rmse = float(np.sqrt(np.mean((mean - y[n_train:, 0]) ** 2)))
    inside = float(np.mean(np.abs(mean - y[n_train:, 0]) < 2 * std))
    print(f"served {len(mean)} predictions: rmse={rmse:.4f}, "
          f"{inside:.0%} of targets inside the 2-sigma band")
    # dynamic batch dimension: the same artifact serves one row
    one = serve(X[:1])
    print(f"single-row request ok: mean={float(one[0][0]):.4f}")


if __name__ == "__main__":
    main()
