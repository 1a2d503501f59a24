"""oak_tpu_torch.utils: diagnostics and profiling against oak_tpu.utils on the
CPU at float64.

- ``assert_finite`` names the same non-finite leaves as oak_tpu's, by the
  JAX key path, on a bridged model and on a dict of tensors;
- ``finite_or_debug`` is the identity and prints oak_tpu's message;
- ``cholesky_health`` gives oak_tpu's report on the same matrix (1e-12);
- ``checked`` raises, naming the op, on a NaN or inf made in a forward, in
  a backward, and by the registered gram op, and gives no false alarm
  through a clean ``FusedGram`` forward and backward;
- ``Timer`` adds up its names and reads ``block_on`` when the block ends;
  ``trace_annotation`` shows in a ``torch.profiler`` table, and ``profile``
  writes a trace file.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oak_tpu.utils as jutils
from oak_tpu_torch.kernels import OAKKernel
from oak_tpu_torch.ops import oak_gram as og
from oak_tpu_torch.utils import (Timer, assert_finite, checked, cholesky_health,
                                 finite_or_debug, profile, trace_annotation)
from tests.test_torch_regression import regression_pair

KW = dict(dtype=torch.float64, device="cpu")


def _message(fn, *args):
    with pytest.raises(FloatingPointError) as info:
        fn(*args)
    return str(info.value)


def test_assert_finite_names_oak_tpus_key_paths(tmp_path):
    jm, tm, _, _ = regression_pair(tmp_path, "sgpr", mixed=True)
    assert_finite(tm, "model")
    jutils.assert_finite(jm, "model")
    with torch.no_grad():
        tm.kernel.kernels[3].lengthscale.raw.fill_(float("nan"))
        tm.likelihood.variance.raw.fill_(float("inf"))
    k3 = jm.kernel.kernels[3]
    jkernels = list(jm.kernel.kernels)
    jkernels[3] = k3.replace(lengthscale=k3.lengthscale.replace(raw=jnp.nan))
    jm = jm.replace(kernel=jm.kernel.replace(kernels=tuple(jkernels)),
                    likelihood=jm.likelihood.replace(
                        variance=jm.likelihood.variance.replace(raw=jnp.inf)))
    ours = _message(assert_finite, tm, "model")
    assert ours == _message(jutils.assert_finite, jm, "model")
    assert ".kernel.kernels[3].lengthscale.raw" in ours and ".likelihood.variance.raw" in ours

    tree = {"a": [torch.ones(2, **KW), torch.tensor([1.0, float("nan")], **KW)],
            "b": torch.arange(3)}
    jtree = {"a": [jnp.ones(2), jnp.array([1.0, jnp.nan])], "b": jnp.arange(3)}
    assert _message(assert_finite, tree, "d") == _message(jutils.assert_finite, jtree, "d")


def test_finite_or_debug_is_the_identity_and_reports(capsys):
    x = torch.tensor([1.0, float("nan"), float("inf")], **KW)
    assert finite_or_debug(x, "x") is x
    assert capsys.readouterr().out.strip() == "[oak-tpu] non-finite in x: 2"
    finite_or_debug(torch.ones(3, **KW), "ones")
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("kind", ["spd", "rank_deficient"])
def test_cholesky_health_equals_oak_tpus(kind):
    rng = np.random.default_rng(5)
    A = rng.normal(size=(12, 12 if kind == "spd" else 3))
    K = A @ A.T + (12 * np.eye(12) if kind == "spd" else 0.0)
    ours = cholesky_health(torch.as_tensor(K))
    ref = jutils.cholesky_health(jnp.asarray(K))
    assert ours.keys() == ref.keys()
    for key in ref:
        if isinstance(ref[key], float):
            assert ours[key] == pytest.approx(ref[key], rel=1e-12, abs=1e-12 * ref["eig_max"])
        else:
            assert ours[key] == ref[key]


def _checked_error(fn):
    with pytest.raises(FloatingPointError) as info:
        checked(fn)()
    return str(info.value)


def test_checked_raises_on_a_nan_made_in_a_forward():
    x = torch.tensor([1.0, -1.0], **KW)
    assert "aten.log" in _checked_error(lambda: torch.log(x).sum())
    # inf alone raises too, and errors=("nan",) lets it through
    y = torch.tensor([0.0, 1.0], **KW)
    assert "aten.reciprocal" in _checked_error(lambda: torch.reciprocal(y))
    out = checked(lambda: torch.reciprocal(y), errors=("nan",))()
    assert torch.isinf(out[0])
    with pytest.raises(ValueError):
        checked(lambda: y, errors=("overflow",))


def test_checked_raises_on_a_nan_made_in_a_backward():
    # sqrt is finite at 0 and its derivative is not: only the backward
    # makes the inf, and it multiplies into the upstream gradient
    x = torch.tensor([4.0, 0.0], requires_grad=True, **KW)

    def loss_and_grad():
        loss = torch.sqrt(x).sum()
        return loss, torch.autograd.grad(loss, x)[0]

    message = _checked_error(loss_and_grad)
    assert "aten.div" in message or "aten.mul" in message or "aten.pow" in message


def _gram_inputs(requires_grad=True):
    rng = np.random.default_rng(8)
    k = OAKKernel.create(num_dims=3, max_interaction_depth=2, p0=[None, 0.3, None], **KW)
    X, X2 = torch.as_tensor(rng.normal(size=(7, 3))), torch.as_tensor(rng.normal(size=(5, 3)))
    X[:, 1] = torch.as_tensor(rng.integers(0, 2, 7), dtype=torch.float64)
    X2[:, 1] = torch.as_tensor(rng.integers(0, 2, 5), dtype=torch.float64)
    with torch.no_grad():
        args = [t.clone().requires_grad_(requires_grad) for t in og._prep(k, X, X2)]
    return args, k.max_interaction_depth


def test_checked_passes_a_clean_fused_gram_and_names_the_registered_op():
    args, depth = _gram_inputs()

    def gram_and_grads():
        out = og.FusedGram.apply(*args, depth)
        return out, torch.autograd.grad((out * out).sum(), args)

    out, grads = checked(gram_and_grads)()
    ref = og.oak_gram_plain(*[a.detach() for a in args], depth)
    torch.testing.assert_close(out.detach(), ref, rtol=1e-12, atol=0)
    assert all(torch.isfinite(g).all() for g in grads)
    # a NaN order variance given from outside: the first op that makes a
    # NaN is the registered gram op itself
    args[6] = args[6].detach().clone()
    args[6][1] = float("nan")
    args = [a.detach() for a in args]
    message = _checked_error(lambda: og.oak_gram_fwd_op(*args, depth))
    assert "oak_tpu_torch.oak_gram_fwd" in message


def test_timer_adds_up_and_reads_block_on_at_the_end():
    timer = Timer()
    holder = []
    for _ in range(2):
        with timer("step", block_on=holder):
            holder.append(torch.ones(3, **KW) * 2)
    with timer("other"):
        pass
    assert set(timer.results) == {"step", "other"}
    assert all(v >= 0.0 for v in timer.results.values())
    assert len(holder) == 2


def test_trace_annotation_shows_in_the_profiler_table_and_profile_writes_a_trace(tmp_path):
    x = torch.ones(64, 64, **KW)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace_annotation("oak.test_range"):
            (x @ x).sum()
    assert "oak.test_range" in {e.key for e in prof.key_averages()}
    with profile(None) as nothing:
        assert nothing is None
    with profile(tmp_path / "trace"):
        with trace_annotation("oak.traced"):
            (x @ x).sum()
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "oak.traced" in names


def test_checked_leaves_fills_and_selections_to_the_ops_that_compute():
    # ops.psd.cholesky_lower keeps a NaN literal where a factorisation failed:
    # torch.where passes it on and makes nothing, so only computing with it
    # raises
    x = torch.tensor([1.0, 2.0], **KW)
    ok = torch.tensor([True, False])
    kept = checked(lambda: torch.where(ok, x, torch.nan))()
    assert torch.isnan(kept[1])
    assert "aten.mul" in _checked_error(lambda: torch.where(ok, x, torch.nan) * 2.0)
    assert torch.equal(checked(lambda: torch.full((2, 2), 3.0, **KW).tril() + 1)(),
                       torch.tensor([[4.0, 1.0], [4.0, 4.0]], **KW))
