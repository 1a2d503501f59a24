"""Parameter summary tables (``oak_tpu.utils.summary``), the counterpart of
``gpflow.utilities.print_summary``: one row per ``Param`` of a module, in
``params.iter_params``' key-path order, with its constrained value."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from ..params import Param, iter_params


def _format_value(v: np.ndarray, max_elems: int = 6) -> str:
    v = np.asarray(v)
    if v.ndim == 0:
        return f"{float(v):.5g}"
    flat = v.ravel()
    body = ", ".join(f"{float(x):.4g}" for x in flat[:max_elems])
    return f"[{body}, ...]" if flat.size > max_elems else f"[{body}]"


def _transform_name(p: Param) -> str:
    bij = p.bij
    name = type(bij).__name__
    try:
        defaults = type(bij)()
    except TypeError:
        defaults = None
    extras = []
    for field in ("low", "high"):
        val = getattr(bij, field, None)
        if val is None:
            continue
        # a Sigmoid's bounds are always shown (the caller chose them); other
        # bijectors' class-default fields (Softplus's low=0) are not
        if (name != "Sigmoid" and defaults is not None
                and val == getattr(defaults, field, None)):
            continue
        extras.append(f"{field}={val:g}")
    return name + (f"({', '.join(extras)})" if extras else "")


def _prior_name(p: Param) -> str:
    if p.prior is None:
        return ""
    fields = ", ".join(f"{k}={v:g}" for k, v in vars(p.prior).items()
                       if isinstance(v, (int, float)))
    return f"{type(p.prior).__name__}({fields})"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def parameter_table(module: nn.Module) -> List[Tuple[str, ...]]:
    """Rows of (name, class, transform, prior, trainable, shape, dtype,
    value), one per ``Param``, with ``oak_tpu``'s names and columns; the
    value is the constrained one."""
    rows = []
    for name, p in iter_params(module):
        with torch.no_grad():
            value = p.value.detach().cpu()
        rows.append((name.lstrip("."), type(p).__name__, _transform_name(p),
                     _prior_name(p), str(bool(p.trainable)), str(tuple(value.shape)),
                     _dtype_name(value.dtype), _format_value(value.numpy())))
    return rows


_HEADER = ("name", "class", "transform", "prior", "trainable", "shape", "dtype", "value")


def summary_string(module: nn.Module) -> str:
    """The table as one aligned string."""
    rows = parameter_table(module)
    if not rows:
        return "(no parameters)"
    widths = [max(len(r[i]) for r in rows + [_HEADER]) for i in range(len(_HEADER))]
    lines = ["  ".join(h.ljust(w) for h, w in zip(_HEADER, widths)),
             "  ".join("-" * w for w in widths)]
    lines += ["  ".join(c.ljust(w) for c, w in zip(r, widths)) for r in rows]
    return "\n".join(lines)


def print_summary(module: nn.Module, fmt: str = "simple") -> None:
    """Print the parameter table; ``fmt`` is accepted for gpflow's call
    sites, and every format prints the same text."""
    del fmt
    print(summary_string(module))
