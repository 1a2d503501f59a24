"""What the PyTorch port's UCI scripts share, with numpy and scipy only (the
card's machine has no scikit-learn): the path set-up that lets them run
from a checkout, the seeded K-fold split, a rank-based AUC and the
artifacts' provenance stamp.

The scripts take the data loaders from ``examples/uci/datasets.py`` and the
fold writer from ``examples/uci/artifact_io.py`` (both numpy only), but not
its ``provenance_stamp``, which imports ``oak_tpu``.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import List, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]


def add_paths() -> None:
    """Put the checkout's root (for ``oak_tpu_torch``, unless it is
    installed) and ``examples/uci`` (for ``datasets`` and ``artifact_io``)
    on ``sys.path``."""
    try:
        import oak_tpu_torch  # noqa: F401
    except ImportError:
        sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "examples" / "uci"))


def kfold_splits(n: int, k: int, seed: int) -> Tuple[np.ndarray, List[Tuple[np.ndarray, np.ndarray]]]:
    """The JAX scripts' split without scikit-learn: rows permuted by
    ``np.random.seed(seed)`` then ``np.random.permutation(n)``, then
    scikit-learn's unshuffled ``KFold(k)`` folds, which are
    ``np.array_split(np.arange(n), k)`` (the first n % k folds take one row
    more). Returns (perm, [(train_index, test_index)]) over permuted rows."""
    np.random.seed(seed)
    perm = np.random.permutation(n)
    rows = np.arange(n)
    return perm, [(np.setdiff1d(rows, test), test) for test in np.array_split(rows, k)]


def roc_auc(y: np.ndarray, score: np.ndarray) -> float:
    """Area under the ROC curve as the Mann–Whitney statistic, ties
    averaged through ``scipy.stats.rankdata`` (scikit-learn's
    ``roc_auc_score`` for binary labels)."""
    from scipy.stats import rankdata

    y = np.asarray(y).reshape(-1) > 0.5
    ranks = rankdata(np.asarray(score).reshape(-1))
    n_pos, n_neg = int(y.sum()), int((~y).sum())
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def provenance_stamp(restarts: int) -> dict:
    """The npz provenance fields of ``artifact_io.provenance_stamp``, with
    the port's version under the same key."""
    import oak_tpu_torch
    from artifact_io import git_commit_sha

    return {"code_commit": git_commit_sha(), "restarts": int(restarts),
            "oak_tpu_version": oak_tpu_torch.__version__}
