"""UCI binary classification benchmark on the PyTorch port: K-fold OAK
Bernoulli SVGP with Sobol analysis.

The port's counterpart of examples/uci/uci_classification_train.py: the
same CLI plus ``--device`` (default ``cuda``), the same seeded split, the
same per-fold ``out_<fold>.npz`` schema (classification_accuracy, nll,
sobol_order, normalised_sobols, ...) and ``model_oak_<fold>.npz``
checkpoint, and the same AUC-vs-cumulative-Sobol curve, with a rank-based
AUC in place of scikit-learn's. Outputs go to
examples/uci_torch/outputs/<dataset_name>/ unless ``--output_dir`` says
otherwise; this script never writes to examples/uci/outputs/.

    python examples/uci_torch/uci_classification_train.py --dataset_name heart
    python examples/uci_torch/uci_classification_train.py --device cpu --k 2 --max_iters 5
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from uci_common import add_paths, kfold_splits, provenance_stamp, roc_auc  # noqa: E402

add_paths()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset_name", default="breast")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--max_iters", type=int, default=1000)
    ap.add_argument("--restarts", type=int, default=4,
                    help="multi-start L-BFGS restarts (default 4, as the JAX "
                         "script); 0 = single start with the degenerate-fit "
                         "fallback")
    ap.add_argument("--binary_feature", default="auto",
                    help="comma-separated column indices for the constrained "
                         "binary kernel; 'auto' = the dataset's known types "
                         "(datasets.FEATURE_TYPES, e.g. heart sex/fbs/exang), "
                         "'none' = all continuous")
    ap.add_argument("--categorical_feature", default="auto",
                    help="comma-separated column indices for the constrained "
                         "categorical kernel; 'auto'/'none' as above")
    ap.add_argument("--optimizer", default="lbfgs",
                    choices=["lbfgs", "scipy", "adam", "natgrad"])
    ap.add_argument("--output_dir", default=None,
                    help="where to write out_<fold>.npz and the checkpoints "
                         "(default: examples/uci_torch/outputs/<dataset_name>)")
    ap.add_argument("--depth", type=int, default=None,
                    help="interaction depth (default: 4, or 2 for sonar, the "
                         "reference's rule)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the models are built on (float32)")
    args = ap.parse_args()

    from artifact_io import write_fold_artifact
    from datasets import feature_types, load_classification, parse_feature_flag

    import torch

    from oak_tpu_torch.experiment import ExperimentConfig, FitConfig, ModelConfig
    from oak_tpu_torch.models.likelihoods import inv_logit

    X, y, provenance = load_classification(args.dataset_name)
    n, d = X.shape
    auto_bin, auto_cat = feature_types(args.dataset_name)
    # sonar has 60 features: truncate interactions (reference :95-98)
    depth = args.depth if args.depth is not None else (4 if args.dataset_name != "sonar" else 2)
    cfg = ExperimentConfig(
        dataset_name=args.dataset_name,
        task="classification",
        k_folds=args.k,
        data_provenance=provenance,
        model=ModelConfig(max_interaction_depth=depth, num_inducing=200,
                          binary_feature=parse_feature_flag(args.binary_feature, auto_bin),
                          categorical_feature=parse_feature_flag(args.categorical_feature,
                                                                 auto_cat),
                          likelihood="bernoulli", optimizer=args.optimizer),
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

        prob = oak.predict_proba(X_test, clip=True)
        classification_error = float(np.mean((prob > 0.5).astype(float) != y_test[:, 0]))
        nll = float(-oak.get_loglik(X_test, y_test, clip=True))
        print(f"fold {fold}: err={classification_error:.4f} nll={nll:.4f}")

        sobol_order = None
        normalised_sobols = None
        auc_component = []
        cumulative_sobol = None
        try:
            t1 = time.time()
            normalised_sobols = oak.get_sobol()
            sobol_time = time.time() - t1
            tuples = oak.tuple_of_indices
            sobol_order = np.zeros(depth)
            for t, v in zip(tuples, normalised_sobols):
                sobol_order[len(t) - 1] += v

            # AUC as components are added in Sobol order (reference :178-186)
            comps = oak.get_prediction_components(X_test, clip=True)
            with torch.no_grad():
                alpha, _ = oak.m.posterior_stats()
                constant = float(alpha.sum() * oak.m.kernel.variances[0].value)
            acc = np.ones(len(test_index)) * constant
            cum = []
            for c in np.argsort(normalised_sobols)[::-1]:
                acc = acc + comps[c]
                p = inv_logit(torch.as_tensor(acc)).numpy()
                auc_component.append(roc_auc(y_test[:, 0], p))
                cum.append(normalised_sobols[c])
            cumulative_sobol = np.cumsum(cum)
        except RuntimeError as e:  # a failed Cholesky (reference :146-159)
            # the fold is then refused by write_fold_artifact below and the
            # script exits non-zero
            print(f"Sobol calculation failed: {e}")
            sobol_time = float("nan")

        oak.save(out_dir / f"model_oak_{fold}.npz")
        problems = write_fold_artifact(
            out_dir, fold, "classification",
            dict(
                normalised_sobols=normalised_sobols,
                classification_accuracy=classification_error,
                nll=nll,
                sobol_order=sobol_order,
                auc_component=auc_component,
                cumulative_sobol=cumulative_sobol,
                train_time=train_time,
                synthetic=provenance["data_provenance"] == "synthetic_standin",
                data_generator_seed=(provenance["generator_seed"]
                                     if provenance["generator_seed"] is not None else -1),
            ), stamp)
        if problems:
            failed_folds.append(fold)
        print(json.dumps({
            "fold": fold, "error": round(classification_error, 4),
            "nll": round(nll, 4), "train_s": round(train_time, 1),
            "sobol_s": round(sobol_time, 2), "problems": problems,
        }))
    if failed_folds:
        print(f"FAILED: folds {failed_folds} violated the committed-artifact "
              "sanity invariants; their out_<fold>.npz were NOT written")
        sys.exit(1)


if __name__ == "__main__":
    main()
