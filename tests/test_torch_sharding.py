"""The port's multi-device layer (``oak_tpu_torch.parallel`` and the
``mesh=`` / ``data_mesh=`` arguments) held against ``oak_tpu`` unsharded and
against the port's own unsharded paths, at float64 on the CPU.

One 4-process gloo job (``torch_sharding_worker.py``) runs every case once,
on a 1-D mesh of the 4 ranks and on a 2 x 2 ("restart", "data") mesh, and
writes its results; each test below reads its case. The job is joined with
a time limit and killed on expiry or on a rank's failure, so a deadlocked
collective fails these tests instead of hanging the run. The data-sharded
loss's lanes form (3 lanes in one vmapped program) is held against the
lanes in turn and against ``oak_tpu``'s ``jax.vmap``. Tolerances: loss,
gradient, predictions and Sobol values within 1e-10 relative of
``oak_tpu`` (under ``jax.jit``); trajectories and fits after a few
iterations within 1e-8 of the port's unsharded run (they differ by
reduction order only).
"""

import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oak_tpu.checkpoint as jckpt
import oak_tpu.params as jp
import oak_tpu.parallel as jparallel
import oak_tpu.sobol as jsobol
from oak_tpu.kernels import OAKKernel as JOAKKernel
from oak_tpu.models import GPR as JGPR
from oak_tpu.models import SGPR as JSGPR
from oak_tpu.models import SVGP as JSVGP
from oak_tpu.models import Bernoulli as JBernoulli
from oak_tpu.models import Gaussian as JGaussian

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_sharding_worker as worker  # noqa: E402

WORKER = Path(__file__).resolve().parent / "torch_sharding_worker.py"
WORLD = 4
JOB_TIMEOUT_S = 120
REL = 1e-10
FIT_REL = 1e-8
MESHES = ["m4", "m22"]


def _jax_model(name):
    kind, n, _, _, _, lik = worker.SPECS[name]
    X, Y, Z = worker.data(name)
    k = JOAKKernel.create(**worker.kernel_kwargs(name), dtype=jnp.float64)
    if kind == "svgp":
        likelihood = (JBernoulli.create("logit") if lik == "bernoulli"
                      else JGaussian.create(0.1, dtype=jnp.float64))
        return JSVGP.create(k, likelihood, Z, num_data=n, dtype=jnp.float64)
    if kind == "sgpr":
        return JSGPR.create(X, Y, k, Z, noise_variance=0.1)
    return JGPR.create(X, Y, k, noise_variance=0.1)


def _save_perturbed(name, folder):
    """oak_tpu's model with its raws moved by seeded noise and q_mu drawn
    N(0, 1), saved as a keypath npz and loaded back."""
    jm = _jax_model(name)
    path = folder / f"{name}.npz"
    jckpt.save_params(jm, path)
    rng = np.random.default_rng(91)
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
    for key in arrays:
        if key == "m.q_mu.raw":
            arrays[key] = rng.normal(size=arrays[key].shape)
        elif key.endswith(".raw") and key != "m.Z.raw":
            arrays[key] = arrays[key] + rng.normal(scale=0.3, size=arrays[key].shape)
    np.savez(path, **arrays)
    return jckpt.load_params(jm, path)


def _jax_references(models):
    """oak_tpu's unsharded values, each under one jax.jit; the lanes of
    ``worker.lane_vectors`` through ``jax.vmap(jax.value_and_grad(...))``
    of all three models under one."""
    refs, losses, lanes = {}, {}, {}
    for name in ("svgp", "sgpr", "gpr"):
        jm = models[name]
        X, Y, _ = worker.data(name)
        vec, unflatten = jp.flatten_trainable(jm)
        if name == "svgp":
            losses[name] = lambda v, u=unflatten, X=X, Y=Y: u(v).training_loss(X, Y)
        else:
            losses[name] = lambda v, u=unflatten: u(v).training_loss()
        fn = jax.jit(jax.value_and_grad(losses[name]))
        refs[f"{name}_loss"], refs[f"{name}_grad"] = map(np.asarray, fn(vec))
        lanes[name] = worker.lane_vectors(name, np.asarray(vec))
    vmapped = jax.jit(lambda vecs: {name: jax.vmap(jax.value_and_grad(fn))(vecs[name])
                                    for name, fn in losses.items()})
    for name, (values, grads) in vmapped(lanes).items():
        refs[f"{name}_lane_loss"], refs[f"{name}_lane_grad"] = np.asarray(values), np.asarray(grads)
    Xt = np.random.default_rng(7).normal(size=(worker.PREDICT_ROWS, worker.SPECS["svgp"][2]))
    refs["mean"], refs["var"] = map(np.asarray,
                                    jax.jit(lambda m, x: m.predict_f(x))(models["svgp"], Xt))
    gpr = models["gpr"]
    refs["sobol_values"] = np.asarray(jsobol.compute_sobol_oak(gpr)[1])
    refs["sobol_by_order"] = np.asarray(jsobol.compute_sobol_by_order(gpr))
    refs["sobol_components"] = np.asarray(jsobol.get_prediction_component(gpr))
    return refs


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    folder = tmp_path_factory.mktemp("sharding")
    models = {name: _save_perturbed(name, folder) for name in worker.SPECS}
    env = dict(os.environ, OMP_NUM_THREADS="1")
    logs = [open(folder / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(WORLD), str(folder)],
                              stdout=log, stderr=subprocess.STDOUT, env=env)
             for r, log in enumerate(logs)]
    try:
        refs = _jax_references(models)
        deadline = time.monotonic() + JOB_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                _stop(procs)
                what = f"ranks {failed} failed" if failed else f"timed out ({JOB_TIMEOUT_S} s)"
                pytest.fail(f"the gloo job {what}:\n" + "\n".join(
                    (folder / f"rank{r}.log").read_text()[-3000:] for r in range(WORLD)))
            time.sleep(0.1)
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        assert not bad, "\n".join((folder / f"rank{r}.log").read_text()[-3000:] for r in bad)
    finally:
        _stop(procs)
        for log in logs:
            log.close()
    ranks = []
    for r in range(WORLD):
        with np.load(folder / f"rank{r}.npz") as f:
            ranks.append({k: f[k] for k in f.files})
    errors = [json.loads((folder / f"rank{r}.json").read_text()) for r in range(WORLD)]
    return {"ranks": ranks, "errors": errors, "jax": refs}


def _case(job, name):
    """Each rank's results of one worker case, after checking it ran."""
    for r, errors in enumerate(job["errors"]):
        assert name not in errors, f"rank {r}:\n{errors[name]}"
    prefix = f"{name}/"
    return [{k[len(prefix):]: v for k, v in rank.items() if k.startswith(prefix)}
            for rank in job["ranks"]]


def _close(a, b, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * max(np.abs(b).max(), 1e-300))


def _same_on_every_rank(results, key):
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], results[0][key])


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ["svgp", "sgpr", "gpr"])
def test_sharded_loss_and_gradient_match_oak_tpu(job, name, mesh):
    """The gradient of the reduced loss counts the replicated tail once: a
    gradient ×(data ranks) in the tail's parameters would fail here."""
    res = _case(job, "loss_grad")
    key = f"{name}_{mesh}"
    _close(res[0][f"{key}_loss"], job["jax"][f"{name}_loss"])
    _close(res[0][f"{key}_grad"], job["jax"][f"{name}_grad"])
    _close(res[0][f"{key}_value"], job["jax"][f"{name}_loss"])
    for k in ("loss", "grad", "value"):
        _same_on_every_rank(res, f"{key}_{k}")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ["svgp", "sgpr", "gpr"])
def test_lanes_form_matches_the_lanes_in_turn(job, name, mesh):
    """``fit.LaneLoss`` of a ``MeshLoss`` at 3 lanes (its lanes form, one
    vmapped program) against each lane's ``loss_and_grads``, on every rank
    the same bits."""
    res = _case(job, "lanes_form")
    key = f"{name}_{mesh}"
    for r in res:
        _close(r[f"{key}_loss"], r[f"{key}_turn_loss"])
        _close(r[f"{key}_grad"], r[f"{key}_turn_grad"])
        _close(r[f"{key}_values"], r[f"{key}_turn_loss"])
    for k in ("loss", "grad", "values"):
        _same_on_every_rank(res, f"{key}_{k}")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ["svgp", "sgpr", "gpr"])
def test_lanes_form_matches_oak_tpu_vmap(job, name, mesh):
    """The lanes form against oak_tpu's unsharded vmapped value_and_grad: a
    tail counted once per data rank would fail here."""
    r = _case(job, "lanes_form")[0]
    key = f"{name}_{mesh}"
    _close(r[f"{key}_loss"], job["jax"][f"{name}_lane_loss"])
    _close(r[f"{key}_grad"], job["jax"][f"{name}_lane_grad"])
    _close(r[f"{key}_values"], job["jax"][f"{name}_lane_loss"])


@pytest.mark.parametrize("mesh", MESHES)
def test_lanes_form_of_the_minibatch_loss(job, mesh):
    """``minibatch_loss``'s lanes form with its batch of rows shared by
    every lane, against each lane's ``loss_and_grads``."""
    res = _case(job, "lanes_form")
    key = f"minibatch_{mesh}"
    for r in res:
        _close(r[f"{key}_loss"], r[f"{key}_turn_loss"])
        _close(r[f"{key}_grad"], r[f"{key}_turn_grad"])
        _close(r[f"{key}_values"], r[f"{key}_turn_loss"])
    _same_on_every_rank(res, f"{key}_grad")


@pytest.mark.parametrize("lanes", [1, 2, 3])
def test_lanes_form_makes_two_all_reduces(job, lanes):
    """Two all-reduces per evaluation, value and gradient or value alone,
    whatever the lane count; one lane goes through ``loss_and_grads``,
    more through the lanes form."""
    for r in _case(job, "lanes_form"):
        for mesh in MESHES:
            for name in ("svgp", "sgpr", "gpr"):
                grads, values, form = r[f"{name}_{mesh}_reduces_{lanes}"]
                assert (grads, values) == (2, 2), (name, mesh)
                assert form == (lanes > 1), (name, mesh)


def test_lanes_form_runs_each_gram_once_for_all_lanes(job):
    """Through FusedGram and the registered ops (the card's route, on CPU
    tensors): the vjp of the vmapped local terms and the vmapped tail's
    grad enter each gram's plain version once for all lanes, as one lane's
    evaluation does. The backward's count also pins ``og.fused_op``'s
    batched check: the local terms' vjp enters it only through
    ``FusedGram``."""
    res = _case(job, "lanes_form_fused")
    for r in res:
        _close(r["loss"], r["turn_loss"])
        _close(r["grad"], r["turn_grad"])
        one_fwd, one_bwd, fwd, bwd = r["plain_entries"]
        assert one_fwd > 0 and one_bwd > 0
        assert (fwd, bwd) == (one_fwd, one_bwd)
    _same_on_every_rank(res, "grad")


class _OneRank:
    """The data axis of a world of one, without a process group: its
    all-reduce is the identity, counted."""

    size, index, is_first, calls = 1, 0, True, 0

    def rows(self, n):
        return slice(0, n)

    def first_only(self, t):
        return t

    def all_reduce(self, t):
        self.calls += 1
        return t.detach().clone()


def _one_rank_gpr():
    import torch

    from oak_tpu_torch.optim.fit import LaneLoss
    from oak_tpu_torch.parallel.sharding import mesh_loss

    m, _, _ = worker.build("gpr")
    axis = _OneRank()
    vecs = torch.as_tensor(worker.lane_vectors("gpr", worker._vec(m)))
    return LaneLoss(m, mesh_loss(m, axis)), vecs, axis


def test_lanes_form_chunks_lanes_of_large_terms(monkeypatch):
    """A GPR's lanes form all-reduces an [N, N] block a lane: under a cap
    of two lanes' blocks its 3 lanes go in chunks of 2 and 1, two
    all-reduces each, and give what one chunk gives."""
    from oak_tpu_torch.parallel import mesh

    lanes, vecs, axis = _one_rank_gpr()
    whole = lanes.value_and_grad(vecs)
    assert axis.calls == 2
    n = worker.SPECS["gpr"][1]
    monkeypatch.setattr(mesh, "LANES_BYTES_CAP", 2 * n * n * vecs.element_size())
    axis.calls = 0
    chunked = lanes.value_and_grad(vecs)
    assert axis.calls == 4
    for a, b in zip(chunked, whole):
        _close(a.numpy(), b.numpy(), 1e-14)
    axis.calls = 0
    _close(lanes.values(vecs).numpy(), whole[0].numpy(), 1e-14)
    assert axis.calls == 4


def test_lanes_form_raises_instead_of_taking_the_lanes_in_turn(monkeypatch):
    """A loss that cannot run under vmap (a host read of a tensor) raises
    from the lanes form; the lanes are never evaluated in turn instead."""
    import torch

    from oak_tpu_torch.models import GPR
    from oak_tpu_torch.parallel.mesh import MeshLoss

    lanes, vecs, _ = _one_rank_gpr()
    turns = []
    monkeypatch.setattr(MeshLoss, "loss_and_grads", lambda *a: turns.append(a))
    read = GPR.training_loss_from_gram
    monkeypatch.setattr(GPR, "training_loss_from_gram",
                        lambda m, K: read(m, K) * float(K.sum() > 0))
    with pytest.raises(RuntimeError, match="vmap"):
        lanes.value_and_grad(vecs)
    assert turns == [] and torch.is_grad_enabled()


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_predict_matches_oak_tpu(job, mesh):
    res = _case(job, "predict")
    _close(res[0][f"{mesh}_mean"], job["jax"]["mean"])
    _close(res[0][f"{mesh}_var"], job["jax"]["var"])
    _same_on_every_rank(res, f"{mesh}_mean")
    _same_on_every_rank(res, f"{mesh}_var")


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_sobol_matches_oak_tpu(job, mesh):
    """compute_sobol_oak (order 3 on the prefix ladder, and handed to the
    chunked route midway under a lowered cap), compute_sobol_by_order and
    get_prediction_component of a GPR with mesh= against oak_tpu."""
    res = _case(job, "sobol")
    for key in ("values", "by_order", "components"):
        _close(res[0][f"{mesh}_{key}"], job["jax"][f"sobol_{key}"])
        _same_on_every_rank(res, f"{mesh}_{key}")
    _close(res[0][f"{mesh}_values_chunked"], job["jax"]["sobol_values"])


def test_dp_step_matches_single_device(job):
    res = _case(job, "dp_step")
    _close(res[0]["loss"], job["jax"]["svgp_loss"])
    _close(res[0]["vec"], res[0]["ref_vec"])
    _same_on_every_rank(res, "vec")
    assert all(r["unflatten_same"] == 1.0 for r in res)


def test_dp_training_improves(job):
    res = _case(job, "dp_improves")
    assert res[0]["losses"][-1] < res[0]["losses"][0]
    _same_on_every_rank(res, "losses")


def test_dp_works_on_subset_mesh(job):
    res = _case(job, "subset_mesh")
    assert [float(r["in_mesh"]) for r in res] == [1.0, 1.0, 0.0, 0.0]
    for r in res[:2]:
        assert np.isfinite(r["loss"])
        _close(r["loss"], r["ref"])


@pytest.mark.parametrize("optimizer", ["adam", "natgrad"])
def test_minibatch_trajectory_parity(job, optimizer):
    """optimise_minibatch(mesh=): the same batch stream on every rank, each
    rank a block of every batch; the single-device trajectory."""
    res = _case(job, "minibatch")
    _close(res[0][f"{optimizer}_vec"], res[0][f"{optimizer}_ref_vec"], FIT_REL)
    _close(res[0][f"{optimizer}_fun"], res[0][f"{optimizer}_ref_fun"], FIT_REL)
    _same_on_every_rank(res, f"{optimizer}_vec")


def test_minibatch_mesh_batch_divisibility(job):
    res = _case(job, "minibatch")
    assert "divisible" in str(res[0]["divisible_error"])


def test_mesh_sharded_sobol_oak_model_entry(job):
    """oak_model.get_sobol(mesh=) and the chunked ladder route under a mesh."""
    res = _case(job, "oak_model_sobol")
    _close(res[0]["s1"], res[0]["s0"])
    _close(res[0]["chunked"], res[0]["full"])
    _same_on_every_rank(res, "s1")


@pytest.mark.parametrize("name", ["sgpr", "svgp"])
def test_data_sharded_lbfgs_matches_single_device(job, name):
    res = _case(job, "lbfgs_sharded")
    r = res[0]
    assert r[f"{name}_iters"] == r[f"{name}_ref_iters"]
    _close(r[f"{name}_fun"], r[f"{name}_ref_fun"], FIT_REL)
    _close(r[f"{name}_vec"], r[f"{name}_ref_vec"], FIT_REL)
    _same_on_every_rank(res, f"{name}_vec")
    assert r["sgpr_rows"] == worker.SPECS["sgpr"][1]  # the model keeps all its rows


def test_data_sharded_lbfgs_validation(job):
    res = _case(job, "lbfgs_validation")[0]
    assert "divisible" in str(res["divisible"])
    assert "pass X= and Y=" in str(res["no_data"])


def test_oak_model_optimise_data_mesh(job):
    res = _case(job, "optimise_data_mesh")
    _close(res[0]["fun"], res[0]["ref_fun"], FIT_REL)
    assert "2-D mesh" in str(res[0]["restarts"])
    assert "checkpoint_path" in str(res[0]["checkpoint"])
    assert "lbfgs" in str(res[0]["optimizer"])


def test_dp_natgrad_matches_single_device(job):
    res = _case(job, "dp_natgrad")
    _close(res[0]["vec"], res[0]["ref_vec"])
    _close(res[0]["loss"], res[0]["ref_loss"])
    _same_on_every_rank(res, "vec")


@pytest.mark.parametrize("name", ["sgpr", "svgp"])
def test_multistart_2d_mesh_matches_unsharded(job, name):
    """fit_lbfgs_multistart_sharded on the (restart x data) mesh: each lane
    as the unsharded multistart's (the SVGP with its Adam warm-up)."""
    res = _case(job, "multistart_2d")
    r = res[0]
    _close(r[f"{name}_lanes"], r[f"{name}_ref_lanes"], FIT_REL)
    _close(r[f"{name}_fun"], r[f"{name}_ref_fun"], FIT_REL)
    _close(r[f"{name}_vec"], r[f"{name}_ref_vec"], FIT_REL)
    _same_on_every_rank(res, f"{name}_vec")
    assert "2x2 (restart x data) mesh" in str(r[f"{name}_message"])
    assert all(x[f"{name}_lanes_form"] > 0 for x in res)  # 2 lanes a rank, batched


def test_multistart_2d_mesh_validation(job):
    res = _case(job, "multistart_2d_validation")[0]
    assert "2-D mesh" in str(res["one_axis"])
    assert "divisible" in str(res["n_starts"])
    assert "divisible" in str(res["rows"])


def test_oak_model_optimise_restarts_data_mesh(job):
    res = _case(job, "optimise_restarts_2d")
    _close(res[0]["fun"], res[0]["ref_fun"], FIT_REL)
    _same_on_every_rank(res, "fun")
    assert all(x["lanes_form"] > 0 for x in res)


@pytest.mark.parametrize("kind", ["lbfgs", "adam", "natgrad"])
def test_restarts_only_mesh_lanes_match_unsharded(job, kind):
    res = _case(job, "restarts_mesh")
    _close(res[0][f"{kind}_lanes"], res[0][f"{kind}_ref_lanes"], FIT_REL)
    _close(res[0][f"{kind}_vec"], res[0][f"{kind}_ref_vec"], FIT_REL)
    _same_on_every_rank(res, f"{kind}_vec")


def test_restarts_mesh_checkpoint_resumes(job):
    """The mesh's first rank writes every lane to the checkpoint; a rerun
    resumes from it to the same fit."""
    res = _case(job, "restarts_mesh")[0]
    assert res["checkpoint_lanes"] == 4
    np.testing.assert_array_equal(res["resumed_vec"], res["lbfgs_vec"])


def test_sgpr_clamps_on_reduced_statistics(job):
    """With Kuu's factor shifted, one shard's Σ K_diag/σ² − tr(AAᵀ) is
    negative while the global one is positive: clamped per shard the bound
    would differ; clamped on the reduced sums it is the unsharded one."""
    res = _case(job, "sgpr_clamps")
    gaps = res[0]["local_gaps"]
    assert gaps.min() < 0.0 < float(res[0]["global_gap"])
    _close(gaps.sum(), res[0]["global_gap"])
    _close(res[0]["loss"], res[0]["ref_loss"])
    _close(res[0]["grad"], res[0]["ref_grad"])


def test_make_mesh_shard_and_replicate(job):
    res = _case(job, "mesh_basics")
    assert "n_devices=5" in str(res[0]["too_many"])
    assert "divisible" in str(res[0]["shard"])
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["replicated"], np.zeros(3))
        np.testing.assert_array_equal(out["block"], [2.0 * r, 2.0 * r + 1])


def test_ranks_imported_no_jax(job):
    for r in _case(job, "hygiene"):
        assert str(r["bad"]) == "[]"


def test_parallel_api_matches_oak_tpu():
    """The 8 names of oak_tpu.parallel with their parameters, and the mesh
    arguments of the entry points that reach them."""
    from oak_tpu_torch import experiment, parallel, sobol
    from oak_tpu_torch.model import oak_model
    from oak_tpu_torch.optim import multistart

    assert sorted(parallel.__all__) == sorted(jparallel.__all__)
    for name in jparallel.__all__:
        ours = list(inspect.signature(getattr(parallel, name)).parameters)
        theirs = list(inspect.signature(getattr(jparallel, name)).parameters)
        assert ours == theirs, name
    takes = {oak_model.optimise: ("mesh", "data_mesh"),
             oak_model.optimise_minibatch: ("mesh",), oak_model.get_sobol: ("mesh",),
             multistart.fit_lbfgs_multistart: ("mesh",),
             multistart.fit_adam_multistart: ("mesh",),
             multistart.fit_natgrad_multistart: ("mesh",),
             sobol.compute_sobol_oak: ("mesh",), sobol.compute_sobol_by_order: ("mesh",),
             sobol.get_prediction_component: ("mesh",),
             experiment.FitConfig.run: ("mesh",), experiment.ExperimentConfig.run_fold: ("mesh",)}
    for fn, names in takes.items():
        params = inspect.signature(fn).parameters
        assert all(n in params for n in names), fn.__qualname__


FAKE_NVCC = """#!{python}
import sys, time
from pathlib import Path
args = sys.argv[1:]
out = Path(args[args.index("-o") + 1])
with open(Path(sys.argv[0]).parent / "calls.log", "a") as log:
    log.write(("link" if "-shared" in args else "compile") + "\\n")
time.sleep(0.5)
out.write_bytes(b"built")
"""

BUILD_RACE = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("_build", sys.argv[1])
b = importlib.util.module_from_spec(spec)
sys.modules["_build"] = b
spec.loader.exec_module(b)
b._nvcc = lambda: sys.argv[2]
r = b.build()
print(json.dumps({"path": str(r.path), "seconds": r.seconds}))
"""


def test_kernel_build_is_safe_across_processes(tmp_path):
    """Two processes building into one empty directory at once: one
    compiles (a stand-in nvcc), the other waits on the file lock and takes
    its library, and both name the same file."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    build_py = Path(__file__).resolve().parents[1] / "oak_tpu_torch" / "_build.py"
    env = dict(os.environ, OAK_TPU_TORCH_BUILD_DIR=str(tmp_path / "build"))
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_RACE, str(build_py), str(nvcc)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env) for _ in range(2)]
    outs = [p.communicate(timeout=60) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    results = [json.loads(o) for o, _ in outs]
    assert results[0]["path"] == results[1]["path"]
    assert sorted(r["seconds"] > 0 for r in results) == [False, True]
    calls = (nvcc.parent / "calls.log").read_text().split()
    assert calls.count("link") == 1
    built = sorted(p.name for p in (tmp_path / "build").iterdir() if p.suffix == ".so")
    assert built == [Path(results[0]["path"]).name]
