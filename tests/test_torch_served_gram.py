"""The served gram (oak_tpu_torch.ops.oak_gram_triton) and the compiled card
artifact (oak_tpu_torch.serving), on the CPU.

The Triton kernel runs only on the card (tests/test_torch_gpu.py,
chip_smoke.py). Here: the module imports without triton; the op's CPU
kernel against oak_tpu's Pallas gram in interpret mode and its XLA
reference at float64; opcheck; the swap of a program's CUDA-gram nodes for
the Triton op, on a program whose card route was forced onto CPU tensors;
one AOTInductor compile of that program through ``serving.compile_package``,
loaded in a ``python -I`` process that cannot import oak_tpu_torch; a CPU
artifact loaded there with ``torch.export.load``; a failed compile raising
before anything is written; and the kernel's launch configuration (tile,
warps and unroll from the depth alone, within the register budget; one
program a tile)."""

import io
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from oak_tpu.ops import oak_gram_pallas as ogp
from oak_tpu_torch import serving
from oak_tpu_torch.kernels.oak_kernel import OAKKernel
from oak_tpu_torch.model import oak_model
from oak_tpu_torch.ops import oak_gram as og
from oak_tpu_torch.ops import oak_gram_triton as ogt
from oak_tpu_torch.testing import counted
from oak_tpu_torch.utils import profiling
from tests.test_torch_oak_gram import REL, _close, _jax_args, _prescaled, _torch_args

REPO = Path(__file__).resolve().parents[1]
FWD = torch.ops.oak_tpu_torch.oak_gram_fwd.default
TRITON = torch.ops.oak_tpu_torch.oak_gram_triton.default


def _isolated(code, cwd):
    """``code`` in ``python -I`` from the empty directory ``cwd``: no
    PYTHONPATH, no user site, no script directory on the path, so this
    checkout's packages cannot be imported. Its last stdout line as JSON."""
    out = subprocess.run([sys.executable, "-I", "-c", code], cwd=cwd, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# every run first shows that it cannot import the port
_NO_PORT = """
try:
    import oak_tpu_torch
except ImportError:
    pass
else:
    raise SystemExit("oak_tpu_torch is importable")
"""


def test_module_imports_without_triton(tmp_path):
    code = ("import sys\nsys.modules['triton'] = None\nsys.path.insert(0, %r)\n"
            "from oak_tpu_torch.ops import oak_gram_triton as m\n"
            "import json\nprint(json.dumps([m.tl is None, sys.modules['triton'] is None]))\n"
            % str(REPO))
    assert _isolated(code, tmp_path) == [True, True]  # blocked, and never imported


CASES = [(E, depth) for E in (0, 2) for depth in list(range(1, 9)) + [12, 32]]


@pytest.mark.parametrize("E,depth", CASES, ids=[f"E{e}-P{p}" for e, p in CASES])
def test_cpu_kernel_matches_xla_reference(E, depth):
    """The op on CPU tensors at float64 against oak_tpu's straight-XLA
    gram; 30 RBF dims plus E extra grams, so depth 32 is clamped only at E
    0 (the XLA reference runs every order; those above the grams are 0)."""
    a = _prescaled(np.random.default_rng(100 + depth + E), D=30, N=11, M=9, E=E, depth=depth)
    with profiling.recording():
        out = ogt.oak_gram_triton_op(*_torch_args(a), depth)
    assert counted("k1_triton.launches") == 0 and out.dtype == torch.float64
    _close(out, ogp._xla_gram_from_prep(*_jax_args(a), depth), rel=REL)


@pytest.mark.parametrize("E", [0, 2])
def test_cpu_kernel_matches_pallas_interpret(E):
    """The op on CPU tensors against the Pallas kernel in interpret mode, on
    one float32 tile (the kernel's f32 output; rtol 1e-5, atol 1e-6, as
    tests/test_torch_oak_gram.py holds the plain version, since the f32
    sums run in another order)."""
    a = _prescaled(np.random.default_rng(120 + E), D=5, N=ogp.TILE_N, M=ogp.TILE_M, E=E,
                   depth=3)
    a = {k: v.astype(np.float32) for k, v in a.items()}
    with pltpu.force_tpu_interpret_mode():
        ref = ogp._pallas_gram(*_jax_args(a), 3)
    out = ogt.oak_gram_triton_op(*_torch_args(a, torch.float32), 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_op_passes_opcheck_on_cpu():
    a = _prescaled(np.random.default_rng(130), D=4, N=7, M=5, E=1, depth=3)
    args = _torch_args(a)
    torch.library.opcheck(ogt.oak_gram_triton_op, (*args, 3))
    assert torch.equal(ogt.oak_gram_triton_op(*args, 3), og.oak_gram_plain(*args, 3))


# --------------------------------------------------------------------------- #
def _card_route_K(plain_K):
    """OAKKernel.K taking the card's route on any tensors: the registered
    CUDA-gram op, whose CPU kernel is the plain version."""
    def K(self, X, X2=None):
        if og.supports_fused(self):
            args = og._prep(self, X, X if X2 is None else X2)
            return og.oak_gram_fwd_op(*args, self.max_interaction_depth)
        return plain_K(self, X, X2)

    return K


def _targets(ep):
    return [n.target for n in ep.graph.nodes if n.op == "call_function"]


@pytest.fixture(scope="module")
def card_route(tmp_path_factory):
    """A float64 model on the CPU, its rows, and the (mean, std) program of
    its predict traced on the card's route (forced onto CPU tensors), the
    package ``serving.compile_package`` makes of it (the one compile of
    this file), and its mean-only CPU artifact (the plain route)."""
    rng = np.random.default_rng(131)
    X = rng.normal(size=(40, 3))
    y = (np.sin(X[:, 0]) + 0.3 * X[:, 1]).reshape(-1, 1)
    oak = oak_model(max_interaction_depth=2, dtype=torch.float64, device="cpu")
    oak.fit(X, y, optimise=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(OAKKernel, "K", _card_route_K(OAKKernel.K))
        predict = oak.export_predict(include_var=True)
        sample = torch.stack([predict.xmin, predict.xmax])
        ep = serving._export(predict, sample, {"X": {0: torch.export.Dim("batch")}})
        blob = serving.compile_package(ep)
    return dict(oak=oak, X=X, ep=ep, blob=blob, cpu_blob=serving.serialize_predict(oak),
                tmp=tmp_path_factory.mktemp("served"))


def test_swap_replaces_every_cuda_gram_node(card_route):
    ep = card_route["ep"]
    swapped = serving.with_triton_gram(ep)
    assert _targets(ep).count(FWD) >= 1
    assert FWD not in _targets(swapped)
    assert _targets(swapped).count(TRITON) == _targets(ep).count(FWD)
    X = torch.as_tensor(card_route["X"])
    for a, b in zip(ep.module()(X), swapped.module()(X)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-12, atol=1e-12)


def test_package_holds_the_program_and_serves_it_on_the_cpu(card_route):
    """The package blob's PROGRAM record is the program as traced; asked
    onto the CPU (where it was traced here), the blob serves it: the live
    predict within 1e-12, as tests/test_torch_serving.py holds a CPU
    artifact at float64."""
    blob, oak, X = card_route["blob"], card_route["oak"], card_route["X"]
    program = torch.export.load(io.BytesIO(serving._program(blob)))
    assert _targets(program).count(FWD) == _targets(card_route["ep"]).count(FWD)
    mean, std = serving.deserialize_predict(blob, device="cpu")(X)
    np.testing.assert_allclose(mean.numpy(), oak.predict(X, clip=True), rtol=1e-12,
                               atol=1e-12)
    assert bool((std > 0).all())


@pytest.fixture(scope="module")
def isolated_run(card_route):
    """One ``python -I`` process in an empty directory, with the package and
    the CPU artifact on disk: it cannot import oak_tpu_torch, serves the
    package through ``torch._inductor.aoti_load_package`` and the CPU
    artifact through ``torch.export.load``, on the same rows."""
    tmp = card_route["tmp"]
    (tmp / "package.pt2").write_bytes(card_route["blob"])
    (tmp / "cpu.pt2").write_bytes(card_route["cpu_blob"])
    np.save(tmp / "x.npy", card_route["X"])
    work = tmp / "empty"
    work.mkdir()
    code = _NO_PORT + """
import json, numpy, torch
X = torch.as_tensor(numpy.load("../x.npy"))
mean, std = torch._inductor.aoti_load_package("../package.pt2")(X)
cpu = torch.export.load("../cpu.pt2").module()(X)
print(json.dumps({"mean": mean.tolist(), "std": std.tolist(), "cpu": cpu.tolist()}))
"""
    return _isolated(code, work)


def test_package_loads_with_torch_alone(card_route, isolated_run):
    """The subprocess's package output equals this process's (bitwise), and
    both are the traced program's within 1e-12 (Inductor's fused f64
    arithmetic)."""
    X = torch.as_tensor(card_route["X"])
    mean, std = torch._inductor.aoti_load_package(io.BytesIO(card_route["blob"]))(X)
    assert isolated_run["mean"] == mean.tolist() and isolated_run["std"] == std.tolist()
    ref_mean, ref_std = card_route["ep"].module()(X)
    np.testing.assert_allclose(mean.numpy(), ref_mean.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(std.numpy(), ref_std.numpy(), rtol=1e-12, atol=1e-12)


def test_cpu_artifact_loads_with_torch_export_alone(card_route, isolated_run):
    """A CPU artifact is a torch.export program with no custom op: the
    subprocess serves it equal to deserialize_predict here."""
    blob = card_route["cpu_blob"]
    assert serving._program(blob) is None
    assert not any(str(t).startswith("oak_tpu_torch")
                   for t in _targets(torch.export.load(io.BytesIO(blob))))
    ours = serving.deserialize_predict(blob)(card_route["X"])
    assert isolated_run["cpu"] == ours.tolist()


def test_failed_compile_raises_and_writes_nothing(monkeypatch, card_route, tmp_path):
    def fail(ep):
        raise RuntimeError("compile failed")

    monkeypatch.setattr(serving, "_compiled_on", lambda device: True)
    monkeypatch.setattr(serving, "_compile", fail)
    path = tmp_path / "predict.pt2"
    with pytest.raises(RuntimeError, match="compile failed"):
        serving.serialize_predict(card_route["oak"], path=path)
    assert not path.exists()


# --------------------------------------------------------------------------- #
# The launch configuration (ops/oak_gram_triton.py _config, _launch). The
# kernel runs only on the card; its tile, warps and grid are plain Python.
SERVED = {"pumadyn": (8, 500), "heart": (4, 200)}  # (clamped depth, inducing points)
BUCKET_EDGES = (1, 4, 5, 8, 9, 16, 17, 32, 33, 64)  # each depth bucket's first and last


@pytest.mark.parametrize("P", BUCKET_EDGES)
def test_launch_config_fits_the_register_budget(P):
    """Each depth bucket, at both its edges, gets power-of-two tiles, 4 or 8
    warps, an unroll of the dim loop of 1 or 2, and at most ORDER_REGISTERS
    registers of orders e_1..e_P a thread (the budget grows with P, so a
    bucket that fits at its last depth fits at every depth in it)."""
    BN, BM, warps, unroll = ogt._config(P)
    assert BN & (BN - 1) == 0 and BM & (BM - 1) == 0 and BN >= 2 and BM >= 16
    assert warps in (4, 8) and unroll in (1, 2)
    assert P * BN * BM <= ogt.ORDER_REGISTERS * 32 * warps


class _Recorder:
    """Stands in for the jitted kernel: records each launch's grid and
    keyword arguments."""

    def __init__(self):
        self.launches = []

    def __getitem__(self, grid):
        return lambda *args, **kw: self.launches.append((grid, kw))


@pytest.mark.parametrize("name", SERVED)
def test_launch_takes_its_tile_from_the_depth_only(name, monkeypatch):
    """``_launch`` on a served Kus at batches of 1, 37, 1639 and 8192 rows
    (the input checks and the kernel stubbed, CPU tensors): one tile, warps
    and unroll for every batch, and a 1-D grid of one program a tile."""
    P, rows = SERVED[name]
    recorder = _Recorder()
    monkeypatch.setattr(og, "_check_cuda_inputs", lambda *args, **kw: None)
    monkeypatch.setattr(ogt, "_kernel", lambda: recorder)
    for M in (1, 37, 1639, 8192):
        a = _prescaled(np.random.default_rng(M), D=P, N=rows, M=M, E=0, depth=P)
        out = ogt._launch(_torch_args(a, torch.float32), P, traced=False)
        assert out.shape == (rows, M)
    configs = {(kw["BN"], kw["BM"], kw["num_warps"], kw["UNROLL"])
               for _, kw in recorder.launches}
    assert configs == {ogt._config(P)}
    for (grid, kw), M in zip(recorder.launches, (1, 37, 1639, 8192)):
        assert grid == (-(-rows // kw["BN"]) * -(-M // kw["BM"]),)
