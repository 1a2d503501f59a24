"""Plot the top effects of a UCI fold's model with the PyTorch port.

The port's counterpart of examples/uci/uci_plotting.py. It reads fold
``--fold``'s checkpoint ``model_oak_<fold>.npz`` with ``load_oak_model``
from ``--checkpoint_dir`` (default: the committed oak_tpu models in
examples/uci/outputs/<dataset_name>/), optionally overwrites its parameters
from a checkpoint in the reference's positional layout (``--reference_npz``,
through ``load_reference_npz``), ranks the components by Sobol index and
saves the top ``--top_n`` effect figures as PDFs in
``<output_dir>/decomposition``. ``--output_dir`` defaults to
examples/uci_torch/outputs/<dataset_name>/; unlike the JAX script, this one
never writes into examples/uci/outputs/.

The posterior math runs on ``--device``; the figures are drawn with
matplotlib on the CPU, which must be installed where the script runs.

    python examples/uci_torch/uci_plotting.py --dataset_name autoMPG --device cpu
    python examples/uci_torch/uci_plotting.py --dataset_name heart --output_dir figures/heart
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from uci_common import REPO, add_paths  # noqa: E402

add_paths()

COMMITTED = REPO / "examples" / "uci" / "outputs"

# The feature names of the ten datasets (the reference's uci_plotting.py
# keys housing as "Housing"; both spellings are accepted)
COVARIATE_NAMES = {
    "autoMPG": ["cylinders", "displacement", "horsepower", "weight",
                "acceleration", "year", "origin"],
    "housing": ["crime", "zoned", "industrial", "river", "NOX", "rooms",
                "age", "empl. dist.", "highway acc.", "tax", "pupil ratio",
                "black pct", "low status pct"],
    "concrete": ["Cement", "Blast Furnace Slag", "Fly Ash", "Water",
                 "Superplasticizer", "Coarse Aggregate", "Fine Aggregate",
                 "Age"],
    "pumadyn": [f"input {i}" for i in range(8)],
    "breast": ["ClumpThickness", "CellSize", "CellShape", "MarginalAdhesion",
               "SingleEpithelialCellSize", "BareNuclei", "BlandChromatin",
               "NormalNucleoli", "Mitoses"],
    "pima": ["Pregnancies", "Glucose", "BloodPressure", "SkinThickness",
             "Insulin", "BMI", "DiabetesPedigreeFunction", "Age"],
    "sonar": [f"input {i}" for i in range(60)],
    "ionosphere": [f"input {i}" for i in range(32)],
    "liver": ["mcv", "alkphos", "sgpt", "sgot", "gammagt", "drinks"],
    "heart": ["age", "sex", "cp", "trestbps", "chol", "fbs", "restecg",
              "thelach", "exang", "oldpeak", "slope", "ca", "thal"],
}
COVARIATE_NAMES["Housing"] = COVARIATE_NAMES["housing"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset_name", default="autoMPG")
    ap.add_argument("--fold", type=int, default=0)
    ap.add_argument("--top_n", type=int, default=5)
    ap.add_argument("--checkpoint_dir", default=None,
                    help="where model_oak_<fold>.npz is read from "
                         "(default: examples/uci/outputs/<dataset_name>)")
    ap.add_argument("--reference_npz", default=None,
                    help="a checkpoint written by the reference's save_model "
                         "(positional hyperparams layout): its parameters "
                         "overwrite the fold model's")
    ap.add_argument("--output_dir", default=None,
                    help="the figures go to <output_dir>/decomposition "
                         "(default: examples/uci_torch/outputs/<dataset_name>); "
                         "never under examples/uci/outputs")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the posterior math (float32)")
    args = ap.parse_args(argv)

    ckpt_dir = (Path(args.checkpoint_dir) if args.checkpoint_dir is not None
                else COMMITTED / args.dataset_name)
    out_dir = (Path(args.output_dir) if args.output_dir is not None
               else REPO / "examples" / "uci_torch" / "outputs" / args.dataset_name)
    fig_dir = (out_dir / "decomposition").resolve()
    if fig_dir.is_relative_to(COMMITTED.resolve()):
        ap.error(f"--output_dir {out_dir} is under {COMMITTED}, whose committed "
                 "models this script only reads")

    from oak_tpu_torch import load_oak_model, load_reference_npz

    oak = load_oak_model(ckpt_dir / f"model_oak_{args.fold}.npz", device=args.device)
    if args.reference_npz:
        load_reference_npz(oak.m, args.reference_npz)
    figs = oak.plot(X_columns=COVARIATE_NAMES.get(args.dataset_name), top_n=args.top_n,
                    save_fig=str(fig_dir))
    print(f"saved {len(figs)} figures to {fig_dir}")
    return figs


if __name__ == "__main__":
    main()
