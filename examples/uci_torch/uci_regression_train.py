"""UCI regression benchmark on the PyTorch port: K-fold OAK regression with
Sobol analysis.

The port's counterpart of examples/uci/uci_regression_train.py: the same
CLI plus ``--device`` (default ``cuda``), the same seeded split, the same
per-fold ``out_<fold>.npz`` schema (rmse, nll, sobol, cumulative_sobol,
sobol_order, ...) and ``model_oak_<fold>.npz`` checkpoint, the same
cumulative-Sobol-vs-RMSE curve and the same check that the per-component
predictions sum to the predictive mean. Outputs go to
examples/uci_torch/outputs/<dataset_name>/ unless ``--output_dir`` says
otherwise; this script never writes to examples/uci/outputs/.

    python examples/uci_torch/uci_regression_train.py --dataset_name autoMPG
    python examples/uci_torch/uci_regression_train.py --device cpu --k 2 --max_iters 5
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from uci_common import add_paths, kfold_splits, provenance_stamp  # noqa: E402

add_paths()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset_name", default="autoMPG")
    ap.add_argument("--k", type=int, default=5, help="k-fold train-test splits")
    ap.add_argument("--max_iters", type=int, default=500)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--restarts", type=int, default=4,
                    help="multi-start L-BFGS restarts (default 4, as the JAX "
                         "script: single-start float32 fits can land in a worse "
                         "optimum that no per-run check catches); 0 = single "
                         "start with the degenerate-fit fallback")
    ap.add_argument("--binary_feature", default="auto",
                    help="comma-separated column indices for the constrained "
                         "binary kernel; 'auto' = the dataset's known types "
                         "(datasets.FEATURE_TYPES), 'none' = all continuous")
    ap.add_argument("--categorical_feature", default="auto",
                    help="comma-separated column indices for the constrained "
                         "categorical kernel; 'auto'/'none' as above")
    ap.add_argument("--optimizer", default="lbfgs", choices=["lbfgs", "scipy", "adam"])
    ap.add_argument("--output_dir", default=None,
                    help="where to write out_<fold>.npz and the checkpoints "
                         "(default: examples/uci_torch/outputs/<dataset_name>)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the models are built on (float32)")
    args = ap.parse_args()

    from artifact_io import write_fold_artifact
    from datasets import feature_types, load_regression, parse_feature_flag

    import torch

    from oak_tpu_torch.experiment import ExperimentConfig, FitConfig, ModelConfig

    X, y, provenance = load_regression(args.dataset_name)
    n, d = X.shape
    depth = args.depth if args.depth is not None else d
    auto_bin, auto_cat = feature_types(args.dataset_name)
    cfg = ExperimentConfig(
        dataset_name=args.dataset_name,
        task="regression",
        k_folds=args.k,
        data_provenance=provenance,
        # oak_model.fit switches to inducing points when the per-fold
        # training size exceeds 1000 (the reference's threshold)
        model=ModelConfig(max_interaction_depth=depth, num_inducing=500,
                          binary_feature=parse_feature_flag(args.binary_feature, auto_bin),
                          categorical_feature=parse_feature_flag(args.categorical_feature,
                                                                 auto_cat),
                          optimizer=args.optimizer),
        fit=FitConfig(max_iters=args.max_iters, restarts=args.restarts),
    )
    out_dir = (Path(args.output_dir) if args.output_dir is not None
               else Path(__file__).resolve().parent / "outputs" / args.dataset_name)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg.save(out_dir / "config.json")

    perm, folds = kfold_splits(n, cfg.k_folds, cfg.seed)
    X, y = X[perm], y[perm]
    stamp = provenance_stamp(args.restarts)
    failed_folds = []
    for fold, (train_index, test_index) in enumerate(folds):
        X_train, X_test = X[train_index], X[test_index]
        y_train, y_test = y[train_index], y[test_index]

        t0 = time.time()
        oak = cfg.run_fold(X_train, y_train, device=args.device)
        train_time = time.time() - t0

        y_pred = oak.predict(X_test, clip=True)
        rmse = float(np.sqrt(np.mean((y_pred - y_test[:, 0]) ** 2)))
        nll = float(-oak.get_loglik(X_test, y_test, clip=True))

        # Sobol and the cumulative-Sobol-vs-RMSE curve (reference :123-136)
        t1 = time.time()
        sobols = oak.get_sobol()
        sobol_time = time.time() - t1
        tuples = oak.tuple_of_indices
        order = np.argsort(sobols)[::-1]

        comps = oak.get_prediction_components(X_test, clip=True)  # [C, N]
        with torch.no_grad():
            alpha, _ = oak.m.posterior_stats()
            constant = float(alpha.sum() * oak.m.kernel.variances[0].value)
            mu_scaled = oak.m.predict_f(oak._tensor(oak._scaled_input(X_test, True)))[0]
        mu_scaled = mu_scaled[:, 0].cpu().numpy().astype(np.float64)
        y_base = np.ones(len(test_index)) * constant

        # components + constant reproduce the predictive mean within the
        # JAX script's float32 budget (1e-2 + 2e-2 |mean| per point)
        total_scaled = comps.sum(axis=0) + constant
        bad = np.abs(total_scaled - mu_scaled) > 1e-2 + 2e-2 * np.abs(mu_scaled)
        if bad.any():
            raise RuntimeError(
                f"component sum deviates from predictive mean beyond the f32 error "
                f"budget on {int(bad.sum())}/{bad.size} points: max diff "
                f"{float(np.abs(total_scaled - mu_scaled).max()):.4g}")

        cumulative_sobol, rmse_component = [], []
        acc = y_base.copy()
        for c in order:
            acc = acc + comps[c]
            y_unscaled = oak.scaler_y.inverse_transform(acc.reshape(-1, 1))[:, 0]
            rmse_component.append(float(np.sqrt(np.mean((y_unscaled - y_test[:, 0]) ** 2))))
            cumulative_sobol.append(sobols[c])
        cumulative_sobol = np.cumsum(cumulative_sobol)

        sobol_order = np.zeros(depth)
        for t, v in zip(tuples, sobols):
            sobol_order[len(t) - 1] += v

        oak.save(out_dir / f"model_oak_{fold}.npz")
        problems = write_fold_artifact(
            out_dir, fold, "regression",
            dict(
                rmse=rmse,
                nll=nll,
                order=order,
                sobol=sobols,
                cumulative_sobol=cumulative_sobol,
                rmse_component=rmse_component,
                sobol_order=sobol_order,
                train_time=train_time,
                sobol_time=sobol_time,
                synthetic=provenance["data_provenance"] == "synthetic_standin",
                data_generator_seed=(provenance["generator_seed"]
                                     if provenance["generator_seed"] is not None else -1),
            ), stamp)
        if problems:
            failed_folds.append(fold)
        print(json.dumps({
            "fold": fold, "rmse": round(rmse, 4), "nll": round(nll, 4),
            "train_s": round(train_time, 1), "sobol_s": round(sobol_time, 2),
            "sobol_order": [round(float(v), 4) for v in sobol_order[:4]],
            "problems": problems,
        }))
    if failed_folds:
        print(f"FAILED: folds {failed_folds} violated the committed-artifact "
              "sanity invariants; their out_<fold>.npz were NOT written")
        sys.exit(1)


if __name__ == "__main__":
    main()
