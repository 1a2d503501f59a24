"""The port's UCI scripts (examples/uci_torch/) on the CPU, and the port's
independence from JAX:

- both scripts, run with ``--device cpu --k 2 --max_iters 5 --depth 2`` in
  a process where ``jax`` and ``oak_tpu`` cannot be imported, exit 0 and
  write ``out_0.npz`` and ``out_1.npz`` with the field names of the
  committed artifacts that the JAX scripts wrote, the checkpoints and the
  config; they never touch examples/uci/outputs/;
- their split equals scikit-learn's KFold on the seeded permutation, and
  their AUC equals ``roc_auc_score``, ties included (scikit-learn is
  imported inside the tests: the card's machine has none);
- under the same import blocker, every module of ``oak_tpu_torch``,
  ``chip_smoke`` and the scripts' ``--help`` load.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "examples" / "uci_torch"
OUTPUTS = REPO / "examples" / "uci" / "outputs"
# sys.modules[name] = None makes "import name" raise ImportError
BLOCK = "import sys; sys.modules['jax'] = None; sys.modules['oak_tpu'] = None; "


def _run_blocked(code: str, cwd, timeout=600) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", BLOCK + code], cwd=cwd, capture_output=True,
                          text=True, timeout=timeout)


def _run_script(name, args, cwd):
    argv = [str(SCRIPTS / name)] + args
    return _run_blocked(f"import runpy; sys.argv = {argv!r}; "
                        f"runpy.run_path(sys.argv[0], run_name='__main__')", cwd)


def _uci_common():
    sys.path.insert(0, str(SCRIPTS))
    try:
        import uci_common
    finally:
        sys.path.pop(0)
    return uci_common


# classification trains with Adam here: L-BFGS on an SVGP first takes 300
# warm-up Adam steps, whatever --max_iters says (the card's smoke run drives
# L-BFGS); --restarts 0 is the single start
RUNS = [("uci_regression_train.py", "autoMPG", []),
        ("uci_classification_train.py", "heart", ["--optimizer", "adam"])]


@pytest.mark.parametrize("script,dataset,extra", RUNS, ids=["regression", "classification"])
def test_torch_script_writes_the_jax_scripts_fields(script, dataset, extra, tmp_path):
    out = tmp_path / "out"
    committed = sorted(p.stat().st_mtime_ns for p in (OUTPUTS / dataset).glob("*.npz"))
    proc = _run_script(script, ["--dataset_name", dataset, "--device", "cpu", "--k", "2",
                                "--max_iters", "5", "--depth", "2", "--restarts", "0",
                                "--output_dir", str(out)] + extra, tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert [line["fold"] for line in lines] == [0, 1]
    assert all(line["problems"] == [] for line in lines)
    with np.load(OUTPUTS / dataset / "out_0.npz", allow_pickle=True) as f:
        fields = sorted(f.files)
    for fold in (0, 1):
        with np.load(out / f"out_{fold}.npz", allow_pickle=True) as f:
            assert sorted(f.files) == fields
            assert int(f["restarts"]) == 0 and str(f["oak_tpu_version"]) == "0.1.0"
            assert np.isfinite(float(f["nll"]))
            assert abs(float(np.sum(f["sobol_order"])) - 1.0) < 1e-5
        assert (out / f"model_oak_{fold}.npz").exists()
    assert json.loads((out / "config.json").read_text())["model"]["max_interaction_depth"] == 2
    assert sorted(p.stat().st_mtime_ns for p in (OUTPUTS / dataset).glob("*.npz")) == committed


@pytest.mark.parametrize("n,k", [(392, 5), (297, 5), (8192, 5), (10, 3), (7, 2)])
def test_torch_script_split_equals_sklearn_kfold(n, k):
    from sklearn.model_selection import KFold

    np.random.seed(4)
    perm = np.random.permutation(n)
    ours_perm, ours = _uci_common().kfold_splits(n, k, seed=4)
    assert np.array_equal(ours_perm, perm)
    theirs = list(KFold(n_splits=k).split(np.zeros((n, 1))))
    assert len(ours) == len(theirs) == k
    for (tr, te), (tr2, te2) in zip(ours, theirs):
        assert np.array_equal(tr, tr2) and np.array_equal(te, te2)


def test_torch_script_auc_equals_roc_auc_score_with_ties():
    from sklearn.metrics import roc_auc_score

    roc_auc = _uci_common().roc_auc
    rng = np.random.default_rng(3)
    for n in (10, 61, 300):
        y = (rng.uniform(size=n) < 0.4).astype(float)
        y[:2] = [0.0, 1.0]
        for score in (rng.normal(size=n), np.round(rng.normal(size=n), 1),
                      np.where(rng.uniform(size=n) < 0.5, 0.25, 0.75)):
            assert roc_auc(y, score) == pytest.approx(roc_auc_score(y, score), abs=1e-12)


def test_port_imports_and_runs_its_help_without_jax(tmp_path):
    """With jax and oak_tpu unimportable, every module of oak_tpu_torch and
    chip_smoke import, and the four example scripts print their help."""
    code = ("import importlib, pkgutil, oak_tpu_torch; "
            "names = [m.name for m in pkgutil.walk_packages(oak_tpu_torch.__path__, "
            "'oak_tpu_torch.')]; [importlib.import_module(n) for n in names]; "
            "import chip_smoke; print(len(names))")
    proc = _run_blocked(code, REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert int(proc.stdout.split()[-1]) >= 30
    for script in ("uci_regression_train.py", "uci_classification_train.py",
                   "serving_example.py", "export_timing.py"):
        proc = _run_script(script, ["--help"], tmp_path)
        assert proc.returncode == 0 and "--device" in proc.stdout, proc.stderr[-4000:]
