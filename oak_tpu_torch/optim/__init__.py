"""Optimizers over the flat trainable vector (``oak_tpu.optim``): Adam, full
batch and minibatch, with checkpoint and resume, and natural gradients on
q(u) alternated with Adam. L-BFGS, ``fit_scipy``, ``fit_natgrad_scan`` and
the multistarts are not ported yet (ROADMAP P10)."""

from .fit import (
    FitResult,
    fit_adam,
    fit_adam_scan,
    load_train_state,
    save_train_state,
)
from .natgrad import fit_natgrad_adam

__all__ = ["FitResult", "fit_adam", "fit_adam_scan", "fit_natgrad_adam",
           "load_train_state", "save_train_state"]
