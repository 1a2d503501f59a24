"""Experiment configuration (``oak_tpu.experiment``): one dataclass tree
(model + fit + experiment) serialized as JSON beside the outputs and
checkpoints, with ``oak_tpu``'s fields, defaults and JSON, so that a
``config.json`` written by either package loads in the other.

``ModelConfig`` mirrors the ``oak_model`` constructor's arguments,
``FitConfig`` the optimise and minibatch options, ``ExperimentConfig`` the
script-level choices. ``build`` and ``run`` also take the port's ``dtype``
and ``device`` (float32 on the CUDA card when None). ``run``'s and
``run_fold``'s ``mesh`` (a ``DeviceMesh``, every process making the same
call) goes to ``optimise_minibatch`` only, as in ``oak_tpu``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional, Sequence

import torch


@dataclasses.dataclass
class ModelConfig:
    """Constructor arguments of ``oak_model`` (reference model_utils.py:195-208)."""

    max_interaction_depth: int = 2
    num_inducing: int = 200
    lengthscale_bounds: Optional[Sequence[float]] = (1e-3, 1e3)
    binary_feature: Optional[List[int]] = None
    categorical_feature: Optional[List[int]] = None
    empirical_measure: Optional[List[int]] = None
    use_sparsity_prior: bool = True
    gmm_measure: Optional[List[int]] = None
    sparse: bool = False
    use_normalising_flow: bool = True
    share_var_across_orders: bool = True
    likelihood: str = "gaussian"
    optimizer: str = "lbfgs"

    def build(self, dtype: Optional[torch.dtype] = None, device=None):
        """The port's ``oak_model`` with these arguments, in ``dtype`` on
        ``device`` (``config.resolve``)."""
        from .model import oak_model

        return oak_model(**dataclasses.asdict(self), dtype=dtype, device=device)


@dataclasses.dataclass
class FitConfig:
    optimise: bool = True
    max_iters: int = 500
    compile: bool = True
    # multi-start L-BFGS (optim/multistart.py); 0 = single start with the
    # degenerate-fit fallback
    restarts: int = 0
    # minibatch (SVGP) options; used when minibatch=True
    minibatch: bool = False
    batch_size: int = 256
    steps: int = 2000
    learning_rate: float = 1e-2
    seed: int = 0

    def run(self, oak, X, Y, mesh=None):
        """fit + optimise an oak_model according to this config.
        ``optimise`` is the train/no-train switch for BOTH modes; with it
        off, ``minibatch`` is ignored. ``mesh`` makes the minibatch mode
        data-parallel."""
        oak.fit(X, Y, optimise=False)
        if not self.optimise:
            return oak
        if self.minibatch:
            oak.optimise_minibatch(batch_size=self.batch_size, steps=self.steps,
                                   lr=self.learning_rate, seed=self.seed, mesh=mesh)
        else:
            oak.optimise(max_iters=self.max_iters, compile=self.compile,
                         restarts=self.restarts)
        return oak


def artifact_provenance(path) -> dict:
    """Machine-readable provenance of a per-fold metrics artifact
    (``out_<fold>.npz``).

    The UCI scripts of both packages and the reference's write per-fold npz
    metric files with shared field names. This repo's scripts also stamp
    ``synthetic`` (bool) and ``data_generator_seed``, so that a consumer can
    tell synthetic stand-in data from real data without reading prose.
    Reference-written files carry neither field: they are reported as
    ``{"synthetic": None, "source": "reference-layout"}``, unknown
    provenance, not assumed real.
    """
    import numpy as np

    with np.load(Path(path), allow_pickle=True) as d:
        if "synthetic" in d.files:
            seed = (int(d["data_generator_seed"])
                    if "data_generator_seed" in d.files else None)
            return {
                "synthetic": bool(d["synthetic"]),
                "generator_seed": (None if seed in (None, -1) else seed),
                "source": "oak_tpu",
                "fields": sorted(d.files),
            }
        return {
            "synthetic": None,
            "generator_seed": None,
            "source": "reference-layout",
            "fields": sorted(d.files),
        }


@dataclasses.dataclass
class ExperimentConfig:
    """Script-level experiment description (dataset, CV, outputs)."""

    dataset_name: str = "autoMPG"
    task: str = "regression"  # or "classification"
    k_folds: int = 5
    seed: int = 4  # the reference's data-shuffle seed (uci_*_train.py)
    output_dir: Optional[str] = None
    # which branch fed the run: {"data_provenance": "real_mat" |
    # "synthetic_standin", "path", "generator_seed", "shape"}, stamped by the
    # UCI scripts
    data_provenance: Optional[dict] = None
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    fit: FitConfig = dataclasses.field(default_factory=FitConfig)

    # ------------------------------------------------------------------ #
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=list)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentConfig":
        raw = json.loads(text)
        model = ModelConfig(**raw.pop("model", {}))
        fit = FitConfig(**raw.pop("fit", {}))
        return cls(model=model, fit=fit, **raw)

    def save(self, path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json())

    @classmethod
    def load(cls, path) -> "ExperimentConfig":
        return cls.from_json(Path(path).read_text())

    # ------------------------------------------------------------------ #
    def build_model(self, dtype: Optional[torch.dtype] = None, device=None):
        return self.model.build(dtype=dtype, device=device)

    def run_fold(self, X_train, y_train, mesh=None, dtype: Optional[torch.dtype] = None,
                 device=None):
        """Build + train one fold's model."""
        return self.fit.run(self.build_model(dtype=dtype, device=device), X_train, y_train,
                            mesh=mesh)
