"""The port's UCI scripts (examples/uci_torch/) on the CPU, and the port's
independence from JAX:

- in one process where ``jax``, ``oak_tpu`` and ``matplotlib`` cannot be
  imported, as on the card's machine: every module of ``oak_tpu_torch`` and
  ``chip_smoke`` import, the five example scripts print their ``--help``,
  and both training scripts, run with ``--device cpu --k 2 --max_iters 5
  --depth 2``, exit 0 and
  write ``out_0.npz`` and ``out_1.npz`` with the field names of the
  committed artifacts that the JAX scripts wrote, the checkpoints and the
  config; they never touch examples/uci/outputs/;
- their split equals scikit-learn's KFold on the seeded permutation, and
  their AUC equals ``roc_auc_score``, ties included (scikit-learn is
  imported inside the tests: the card's machine has none);
- ``uci_plotting.py`` reads the committed autoMPG fold 0 and writes the
  figure files that oak_tpu's ``plot_model`` names for that checkpoint,
  only under ``--output_dir``.
"""

import json
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "examples" / "uci_torch"
OUTPUTS = REPO / "examples" / "uci" / "outputs"
# Run in one process where jax, oak_tpu and matplotlib cannot be imported
# (sys.modules[name] = None makes "import name" raise ImportError), as on the
# card's machine, which has neither jax nor matplotlib: import every module
# of oak_tpu_torch and chip_smoke, print each example script's --help, then
# run the two training scripts. Prints one JSON line.
_BLOCKED_RUN = """
import contextlib, importlib, io, json, os, pkgutil, runpy, sys, traceback
for name in ("jax", "oak_tpu", "matplotlib"):
    sys.modules[name] = None
import oak_tpu_torch
names = [m.name for m in pkgutil.walk_packages(oak_tpu_torch.__path__, "oak_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke

def run(argv):
    sys.argv = list(argv)
    out, code = io.StringIO(), 0
    with contextlib.redirect_stdout(out):
        try:
            runpy.run_path(argv[0], run_name="__main__")
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
        except BaseException:
            code, out = 1, io.StringIO(out.getvalue() + traceback.format_exc())
    return code, out.getvalue()

scripts, helps, runs = sys.argv[1], sys.argv[2], sys.argv[3]
result = {"modules": len(names),
          "helps": {h: run([os.path.join(scripts, h), "--help"]) for h in json.loads(helps)},
          "runs": {key: run([os.path.join(scripts, argv[0])] + argv[1:])
                   for key, argv in json.loads(runs).items()}}
print(json.dumps(result))
"""

HELP_SCRIPTS = ("uci_regression_train.py", "uci_classification_train.py", "serving_example.py",
                "export_timing.py", "uci_plotting.py")
# classification trains with Adam here: L-BFGS on an SVGP first takes 300
# warm-up Adam steps, whatever --max_iters says (the card's smoke run drives
# L-BFGS); --restarts 0 is the single start
RUNS = {"regression": ("uci_regression_train.py", "autoMPG", []),
        "classification": ("uci_classification_train.py", "heart", ["--optimizer", "adam"])}


@pytest.fixture(scope="module")
def blocked(tmp_path_factory):
    """The blocked process's result and the training runs' output dirs;
    the committed npz files' mtimes before it ran."""
    tmp = tmp_path_factory.mktemp("scripts")
    committed = {d: sorted(p.stat().st_mtime_ns for p in (OUTPUTS / d).glob("*.npz"))
                 for _, d, _ in RUNS.values()}
    runs = {key: [script, "--dataset_name", dataset, "--device", "cpu", "--k", "2",
                  "--max_iters", "5", "--depth", "2", "--restarts", "0",
                  "--output_dir", str(tmp / key)] + extra
            for key, (script, dataset, extra) in RUNS.items()}
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, str(SCRIPTS),
                           json.dumps(HELP_SCRIPTS), json.dumps(runs)],
                          cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return json.loads(proc.stdout.splitlines()[-1]), tmp, committed


def _uci_common():
    sys.path.insert(0, str(SCRIPTS))
    try:
        import uci_common
    finally:
        sys.path.pop(0)
    return uci_common


@pytest.mark.parametrize("key", list(RUNS))
def test_torch_script_writes_the_jax_scripts_fields(key, blocked):
    result, tmp, committed = blocked
    _, dataset, _ = RUNS[key]
    out = tmp / key
    code, stdout = result["runs"][key]
    assert code == 0, stdout[-4000:]
    lines = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
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
    assert sorted(p.stat().st_mtime_ns for p in (OUTPUTS / dataset).glob("*.npz")) == \
        committed[dataset]


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


def test_port_imports_and_runs_its_help_without_jax(blocked):
    """With jax, oak_tpu and matplotlib unimportable, every module of
    oak_tpu_torch and chip_smoke import, and the five example scripts print
    their help."""
    result, _, _ = blocked
    assert result["modules"] >= 34
    assert sorted(result["helps"]) == sorted(HELP_SCRIPTS)
    for script, (code, text) in result["helps"].items():
        assert code == 0 and "--device" in text, (script, code, text[-2000:])


def test_torch_uci_plotting_writes_the_figures_oak_tpu_names(tmp_path, monkeypatch):
    """uci_plotting.py on the committed autoMPG fold 0 (on the CPU, the
    port's default dtype set to float64) saves the top 5 effect figures
    under the names oak_tpu's plot_model gives the same checkpoint, writes
    only under --output_dir, and refuses an output directory inside the
    committed outputs."""
    import torch

    import oak_tpu.plotting as jplot
    from oak_tpu_torch import config
    from tests.test_torch_plotting import _compiled_oak
    from tests.test_torch_uci_artifacts import committed_pair

    script = runpy.run_path(str(SCRIPTS / "uci_plotting.py"), run_name="uci_plotting")
    names = script["COVARIATE_NAMES"]["autoMPG"]
    committed = sorted(p.stat().st_mtime_ns for p in (OUTPUTS / "autoMPG").rglob("*"))
    monkeypatch.setattr(config, "DEFAULT_DTYPE", torch.float64)
    figs = script["main"](["--dataset_name", "autoMPG", "--device", "cpu",
                           "--output_dir", str(tmp_path)])
    j, _, _, _ = committed_pair("autoMPG", "regression")
    # oak_tpu's plot_model ranks and names the figures; drawing them is
    # tests/test_torch_plotting.py's comparison, so it is skipped here
    for name in ("plot_single_effect", "plot_second_order", "plot_single_effect_binary",
                 "plot_second_order_binary", "plot_single_effect_categorical"):
        monkeypatch.setattr(jplot, name,
                            lambda *args, title="", **kwargs: jplot.FigureDescription(None, title))
    ref = jplot.plot_model(_compiled_oak(j), X_columns=names, top_n=5)
    try:
        assert [f.description for f in figs] == [f.description for f in ref]
        written = sorted(p.name for p in (tmp_path / "decomposition").iterdir())
        assert written == sorted(f.description.replace("/", "_") + ".pdf" for f in ref)
        assert sorted(p.relative_to(tmp_path).parts[0] for p in tmp_path.rglob("*.pdf")) == \
            ["decomposition"] * 5
        assert sorted(p.stat().st_mtime_ns for p in (OUTPUTS / "autoMPG").rglob("*")) == committed
        with pytest.raises(SystemExit):
            script["main"](["--device", "cpu", "--output_dir", str(OUTPUTS / "autoMPG")])
    finally:
        jplot.plt.close("all")
