"""Optimizers over the flat trainable vector (``oak_tpu.optim``): scipy,
L-BFGS with a zoom linesearch, Adam (full batch and minibatch), natural
gradients on q(u) alternated with Adam, with checkpoint and resume, and the
multi-start forms of L-BFGS, Adam and natural gradients."""

from .fit import (
    FitResult,
    fit_adam,
    fit_adam_scan,
    fit_lbfgs,
    fit_scipy,
    load_train_state,
    save_train_state,
)
from .multistart import (
    fit_adam_multistart,
    fit_lbfgs_multistart,
    fit_natgrad_multistart,
)
from .natgrad import fit_natgrad_adam, fit_natgrad_scan

__all__ = ["FitResult", "fit_scipy", "fit_lbfgs", "fit_adam", "fit_adam_scan",
           "fit_natgrad_adam", "fit_natgrad_scan", "fit_lbfgs_multistart",
           "fit_adam_multistart", "fit_natgrad_multistart", "save_train_state",
           "load_train_state"]
