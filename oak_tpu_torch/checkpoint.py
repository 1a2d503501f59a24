"""The parameter bridge: keypath npz files shared with ``oak_tpu``.

``oak_tpu.checkpoint.save_params`` writes one array per pytree leaf, keyed
``m`` + the leaf's JAX key path (``m.kernel.kernels[0].lengthscale.raw``).
``load_params`` fills a port model built with the same structure from such a
file ("rebuild, then load"), reading it with numpy alone; ``save_params``
writes the same keys from a port model.

``reference_param_order`` / ``load_reference_npz`` read the reference's
positional layout (GPflow's parameter order, constrained values) onto a
model built with the checkpoint's structure.

``save_oak_model`` / ``load_oak_model`` persist a whole ``oak_model`` in
``oak_tpu``'s layout (the JSON ``config``, ``m.*``, ``flow{i}.*``, the
scalers, ``xmin`` / ``xmax``, the scaled and SVGP training data), so that an
artifact written by either package loads in the other.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from .params import Param, keypath_nodes

PREFIX = "m"


def _leaves(model: nn.Module, prefix: str = PREFIX) -> Dict[str, torch.Tensor]:
    out = {}
    for key, node in keypath_nodes(model):
        if isinstance(node, Param):
            out[f"{prefix}{key}.raw"] = node.raw
        else:
            out[f"{prefix}{key}"] = node
    return out


def _arrays(model: nn.Module, prefix: str) -> Dict[str, np.ndarray]:
    return {k: t.detach().cpu().numpy() for k, t in _leaves(model, prefix).items()}


def save_params(model: nn.Module, path) -> None:
    """Save every array leaf of ``model`` under its JAX key path."""
    np.savez(path, **_arrays(model, PREFIX))


@torch.no_grad()
def load_params(model: nn.Module, path_or_mapping: Union[str, Mapping],
                prefix: str = PREFIX) -> nn.Module:
    """Fill ``model``'s raw values and buffers in place from a keypath npz
    (or a mapping of the same keys), casting to each tensor's dtype and
    device. A missing key, an extra key under ``prefix`` or a shape mismatch
    raises."""
    if isinstance(path_or_mapping, Mapping):
        data = dict(path_or_mapping)
    else:
        with np.load(path_or_mapping) as f:
            data = {k: f[k] for k in f.files}
    leaves = _leaves(model, prefix)
    missing = sorted(set(leaves) - set(data))
    extra = sorted(k for k in set(data) - set(leaves)
                   if k.startswith(f"{prefix}.") or k.startswith(f"{prefix}["))
    if missing or extra:
        raise KeyError(f"checkpoint does not match the model: missing {missing}, "
                       f"unexpected {extra}")
    for key, t in leaves.items():
        arr = np.array(data[key])  # a writable copy
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape}, model shape "
                             f"{tuple(t.shape)}")
        t.copy_(torch.as_tensor(arr).to(dtype=t.dtype, device=t.device))
    return model


# --------------------------------------------------------------------------- #
# The reference's positional layout
# --------------------------------------------------------------------------- #
def reference_param_order(model) -> List[str]:
    """The slot names of the reference checkpoint's positional parameter
    layout for ``model``, in the order the reference's ``save_model`` writes
    them (the reference's oak/model_utils.py:44-64; ``oak_tpu.checkpoint``).

    The reference saves ``[p.numpy() for p in model.(trainable_)parameters]``
    in GPflow 2.2's tf.Module order: attribute names sorted at each level,
    list attributes in index order. So:

    - GPR/SGPR save *trainable* parameters only; SVGP saves ALL parameters
      (a fixed inducing ``Z`` appears for SVGP but not for a fixed-Z SGPR).
    - model level: ``inducing_variable`` < ``kernel`` < ``likelihood`` <
      ``q_mu`` < ``q_sqrt``.
    - kernel level: ``kernels[0..D-1]`` then ``variances[0..P]``.
    - with shared variances the reference replaces the pinned base
      variances by plain tensors (oak_kernel.py:163-166,178,186), so they
      are not in the file, except for empirical and GMM RBF dims, whose
      pinning it skips.
    - per kernel: RBF ``lengthscales`` < ``variance``; categorical ``W`` <
      ``kappa`` < ``variance`` ('W' sorts before lowercase); binary just
      ``variance``."""
    from .kernels.oak_kernel import UnconstrainedRBF
    from .kernels.ortho_binary import OrthogonalBinary
    from .kernels.ortho_categorical import OrthogonalCategorical
    from .kernels.ortho_rbf import OrthogonalRBF
    from .measures import GaussianMeasure
    from .models import SGPR, SVGP

    oak = model.kernel
    shared = oak.share_var_across_orders
    slots = []
    if isinstance(model, SVGP) or (isinstance(model, SGPR) and model.Z.trainable):
        slots.append("Z")
    for i, k in enumerate(oak.kernels):
        if isinstance(k, (OrthogonalRBF, UnconstrainedRBF)):
            slots.append(f"kernels[{i}].lengthscale")
            pinned = shared and (isinstance(k, UnconstrainedRBF)
                                 or isinstance(k.measure, GaussianMeasure))
            if not pinned:
                slots.append(f"kernels[{i}].variance")
        elif isinstance(k, OrthogonalCategorical):
            slots += [f"kernels[{i}].W", f"kernels[{i}].kappa"]
            if not shared:
                slots.append(f"kernels[{i}].variance")
        elif isinstance(k, OrthogonalBinary):
            if not shared:
                slots.append(f"kernels[{i}].variance")
        else:
            raise NotImplementedError(type(k))
    slots += [f"variances[{j}]" for j in range(len(oak.variances))]
    if hasattr(model.likelihood, "variance"):
        slots.append("likelihood.variance")
    if isinstance(model, SVGP):
        slots += ["q_mu", "q_sqrt"]
    return slots


def _slot_param(model, slot: str) -> Param:
    if slot.startswith("variances["):
        return model.kernel.variances[int(slot[len("variances["):-1])]
    if slot.startswith("kernels["):
        i = int(slot[len("kernels["):slot.index("]")])
        return getattr(model.kernel.kernels[i], slot.split(".")[1])
    if slot == "likelihood.variance":
        return model.likelihood.variance
    return getattr(model, slot)  # Z, q_mu, q_sqrt


def load_reference_npz(model: nn.Module, path) -> nn.Module:
    """Fill ``model`` in place from a checkpoint written by the reference's
    ``save_model`` (a positional ``hyperparams`` object array of
    *constrained* values) and return it. The caller builds the model with
    the checkpoint's structure first, as the reference's consumers do
    (uci_plotting.py:163-200). Each value goes through its ``Param``'s
    bijector inverse (``Param.assign``); a count that does not match the
    layout raises with the slot list."""
    vals = list(np.load(path, allow_pickle=True)["hyperparams"])
    slots = reference_param_order(model)
    if len(vals) != len(slots):
        raise ValueError(f"checkpoint has {len(vals)} parameters but the model layout "
                         f"expects {len(slots)}: {slots}")
    for slot, v in zip(slots, vals):
        p = _slot_param(model, slot)
        p.assign(torch.as_tensor(np.asarray(v, np.float64).reshape(tuple(p.raw.shape))))
    return model


# --------------------------------------------------------------------------- #
# Whole oak_model persistence, oak_tpu's layout
# --------------------------------------------------------------------------- #
def save_oak_model(oak, path) -> None:
    """Write an ``oak_model`` to one npz: the JSON constructor and structure
    ``config``, the model's leaves under ``m``, each flow's under
    ``flow{i}``, the scalers, the input range, the scaled data and, for an
    SVGP, its training data; ``oak_tpu.checkpoint.load_oak_model`` reads it."""
    from .models import SVGP

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    config = {
        "max_interaction_depth": oak.max_interaction_depth,
        "num_inducing": oak.num_inducing,
        "lengthscale_bounds": oak.lengthscale_bounds,
        "binary_feature": oak.binary_feature,
        "categorical_feature": oak.categorical_feature,
        "empirical_measure": oak.empirical_measure,
        "use_sparsity_prior": oak.use_sparsity_prior,
        "gmm_measure": list(oak.gmm_measure) if oak.gmm_measure is not None else None,
        "sparse": oak.sparse,
        "use_normalising_flow": oak.use_normalising_flow,
        "share_var_across_orders": oak.share_var_across_orders,
        "likelihood": oak.likelihood,
        "optimizer": oak.optimizer,
        "num_dims": oak.num_dims,
        "continuous_index": oak.continuous_index,
        "binary_index": oak.binary_index,
        "categorical_index": oak.categorical_index,
        "model_kind": type(oak.m).__name__,
        "flow_dims": [i for i, f in enumerate(oak.input_flows) if f is not None],
        "q_diag": bool(getattr(oak.m, "q_diag", True)),
        "whiten": bool(getattr(oak.m, "whiten", True)),
    }
    arrays = {"config": np.frombuffer(json.dumps(config).encode(), np.uint8)}
    arrays.update(_arrays(oak.m, PREFIX))
    for i, flow in enumerate(oak.input_flows):
        if flow is not None:
            arrays.update(_arrays(flow, f"flow{i}"))
    arrays["scaler_y_mean"] = oak.scaler_y.mean_
    arrays["scaler_y_scale"] = oak.scaler_y.scale_
    if oak.scaler_X_empirical is not None:
        arrays["scaler_Xemp_mean"] = oak.scaler_X_empirical.mean_
        arrays["scaler_Xemp_scale"] = oak.scaler_X_empirical.scale_
    if oak.scaler_X_continuous is not None:
        arrays["scaler_Xcont_mean"] = oak.scaler_X_continuous.mean_
        arrays["scaler_Xcont_scale"] = oak.scaler_X_continuous.scale_
    arrays["xmin"] = oak.xmin
    arrays["xmax"] = oak.xmax
    arrays["X_scaled"] = oak.X_scaled
    arrays["Y_scaled"] = oak.Y_scaled
    if isinstance(oak.m, SVGP):
        arrays["train_X"], arrays["train_Y"] = oak._train_data
    np.savez(path, **arrays)


def load_oak_model(path, dtype: Optional[torch.dtype] = None, device=None):
    """Rebuild an ``oak_model`` saved by either package, in ``dtype`` on
    ``device`` (``config.resolve``), as ``oak_tpu`` rebuilds it: the
    structural part of ``fit`` re-run on the stored scaled data (feature
    classes, empirical measures, GMM measures re-estimated by the port's EM),
    then every leaf of the model and the flows filled from the file."""
    from .flows import Normalizer
    from .kernels import OAKKernel
    from .model import oak_model
    from .preprocessing import (StandardScaler, calculate_features,
                                empirical_measure_from_column, estimate_one_dim_gmm)

    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    config = json.loads(bytes(data["config"]).decode())
    oak = oak_model(**{k: config[k] for k in (
        "max_interaction_depth", "num_inducing", "lengthscale_bounds", "binary_feature",
        "categorical_feature", "empirical_measure", "use_sparsity_prior", "gmm_measure",
        "sparse", "use_normalising_flow", "share_var_across_orders", "likelihood",
        "optimizer")}, dtype=dtype, device=device)
    kw = dict(dtype=oak.dtype, device=oak.device)
    oak.num_dims = config["num_dims"]
    oak.continuous_index = config["continuous_index"]
    oak.binary_index = config["binary_index"]
    oak.categorical_index = config["categorical_index"]
    oak.xmin, oak.xmax = data["xmin"], data["xmax"]
    oak.X_scaled, oak.Y_scaled = data["X_scaled"], data["Y_scaled"]
    oak.scaler_y = StandardScaler(mean_=data["scaler_y_mean"], scale_=data["scaler_y_scale"])
    if "scaler_Xemp_mean" in data:
        oak.scaler_X_empirical = StandardScaler(mean_=data["scaler_Xemp_mean"],
                                                scale_=data["scaler_Xemp_scale"])
    if "scaler_Xcont_mean" in data:
        oak.scaler_X_continuous = StandardScaler(mean_=data["scaler_Xcont_mean"],
                                                 scale_=data["scaler_Xcont_scale"])

    oak.input_flows = [None] * oak.num_dims
    for i in config["flow_dims"]:
        flow = Normalizer.create(np.array([0.5, 1.0, 2.0]), log=True, **kw)
        oak.input_flows[i] = load_params(flow, data, prefix=f"flow{i}")

    # discrete columns are untouched by the scaling, so the scaled data
    # classify as the raw data did
    X = data["X_scaled"]
    _, _, _, p0, p = calculate_features(X, config["categorical_feature"],
                                        config["binary_feature"])
    oak.empirical_locations = [None] * oak.num_dims
    oak.empirical_weights = [None] * oak.num_dims
    for i in config["empirical_measure"] or []:
        oak.empirical_locations[i], oak.empirical_weights[i] = \
            empirical_measure_from_column(X[:, i])
    oak.estimated_gmm_measures = [None] * oak.num_dims
    if config["gmm_measure"] is not None:
        for i in np.flatnonzero(config["gmm_measure"]):
            oak.estimated_gmm_measures[i] = estimate_one_dim_gmm(
                int(config["gmm_measure"][i]), X[:, i], **kw)
    kernel = OAKKernel.create(
        num_dims=oak.num_dims,
        max_interaction_depth=config["max_interaction_depth"],
        p0=p0,
        p=p,
        lengthscale_bounds=config["lengthscale_bounds"],
        empirical_locations=oak.empirical_locations,
        empirical_weights=oak.empirical_weights,
        gmm_measures=oak.estimated_gmm_measures,
        share_var_across_orders=config["share_var_across_orders"],
        use_sparsity_prior=(config["use_sparsity_prior"]
                            and config["share_var_across_orders"]),
        **kw,
    )
    kind = config["model_kind"]
    Z = (np.zeros((data["m.Z.raw"].shape[0], oak.num_dims))
         if kind in ("SVGP", "SGPR") else None)
    if kind == "SVGP":
        oak._train_data = (data["train_X"], data["train_Y"])
    oak.m = oak._build_model(kernel, Z, q_diag=config.get("q_diag", True),
                             whiten=config.get("whiten", True))
    load_params(oak.m, data, prefix=PREFIX)
    return oak
