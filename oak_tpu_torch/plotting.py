"""Effect plots with credible bands (``oak_tpu.plotting``).

Two parts:

- **The posterior of a component on a grid**, on the model's device and in
  its dtype. With alpha and Qinv the posterior statistics of any model type,

      mean(s) = σ²_order K_c(s, Xcond) alpha
      var(s)  = σ²_order K_c_diag(s) - diag(K_c Qinv K_cᵀ)

  with K_c the product of the component's per-dim grams. It is the model's
  own predict_f with K_c in place of its kernel, so the quadratic form goes
  through the model's triangular factors; ``oak_tpu`` forms Qinv, whose
  float32 rounding the subtraction magnifies. The variance is clamped at
  0: in float32 the subtraction cancels to the prior's rounding. The
  results come back as numpy, for matplotlib.
- **The drawing**: ``EffectFigure``, the one layout every effect plot uses
  (a main panel and marginal histogram strips), the six ``plot_*``
  functions, ``plot_model`` and ``save_fig_list``. matplotlib is imported
  when a figure is drawn, not with this module: the card's machine has no
  matplotlib, and the posterior math runs there all the same. Drawing runs
  on the CPU. A tikz file is written only where ``tikzplotlib`` is
  installed.

``plot_single_effect_binary`` computes the data with the other effects
removed, which the reference meant to plot (its plotting_utils.py:427 names
an undefined variable). The layout is ``oak_tpu``'s, panel for panel.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from .kernels.oak_kernel import UnconstrainedRBF, kernel_K, kernel_K_diag, per_group
from .kernels.ortho_rbf import OrthogonalRBF
from .sobol import check_single_latent


def _pyplot():
    """matplotlib's pyplot on the Agg backend, imported on first use."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    return plt


@dataclass
class FigureDescription:
    fig: "matplotlib.figure.Figure"  # noqa: F821
    description: str


def save_fig_list(fig_list: List[FigureDescription], dirname: Path) -> None:
    """Each figure as ``<description>.pdf`` in ``dirname`` ('/' becomes '_')."""
    dirname = Path(dirname)
    dirname.mkdir(parents=True, exist_ok=True)
    for f in fig_list:
        safe = f.description.replace("/", "_")
        f.fig.savefig(dirname / (safe + ".pdf"), bbox_inches="tight")


def _save_tikz(tikz_path, title):
    if tikz_path is None:
        return
    try:
        import tikzplotlib
    except ImportError:
        return
    tikzplotlib.save(str(tikz_path) + f"{title}.tex")


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _model_data(m, data=None):
    data = m.data if data is None else data
    return _host(data[0]), _host(data[1])


def _conditioning_inputs(m) -> torch.Tensor:
    Z = m.inducing_points
    return m.data[0] if Z is None else Z


def _order_variance(m, order: int, like: torch.Tensor) -> torch.Tensor:
    k = m.kernel
    if k.share_var_across_orders:
        return k.variances[order].value.reshape(())
    return like.new_ones(())


def _on(a, like: torch.Tensor) -> torch.Tensor:
    """A grid or data column as a tensor of ``like``'s dtype on its device."""
    return torch.as_tensor(np.ascontiguousarray(a), dtype=like.dtype, device=like.device)


class _EffectKernel:
    """The kernel of an effect: v·Π_d k_d over the factors' dims (one
    additive component, ``product=True``), or v·Σ_d k_d (the summed
    order-1 profile), with K and K_diag on full-width inputs."""

    def __init__(self, factors, v: torch.Tensor, product: bool = True):
        self.factors, self.v, self.product = factors, v, product

    def _combine(self, groups) -> torch.Tensor:
        """v times the product (or sum) over the factors, each group's
        stacked [G, ...] values reduced over its group axis."""
        out = None
        for _, g in groups:
            part = g.prod(0) if self.product else g.sum(0)
            out = part if out is None else (out * part if self.product else out + part)
        return self.v * out

    def K(self, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
        X2 = X if X2 is None else X2
        return self._combine(per_group(self.factors, X, kernel_K, X2))

    def K_diag(self, X: torch.Tensor) -> torch.Tensor:
        return self._combine(per_group(self.factors, X, kernel_K_diag))


def _effect_posterior(m, kernel: _EffectKernel, dims, grid_cols):
    """Mean and variance [S] of the effect with kernel ``kernel`` at the
    grid (grid_cols[k] the points of dims[k]), as numpy. It is the model's
    predict_f with the effect's kernel in place of the model's
    (``predict_f_from(..., kernel=)``): mean K_c(s, Xc) alpha, variance
    v K_c_diag(s) - diag(K_c Qinv K_cᵀ), the quadratic form taken through
    the model's triangular factors rather than an explicit Qinv, whose
    float32 rounding the subtraction would magnify."""
    check_single_latent(m)
    Xc = _conditioning_inputs(m)
    Xg = Xc.new_zeros((len(grid_cols[0]), m.kernel.num_dims))
    for d, col in zip(dims, grid_cols):
        Xg[:, m.kernel.kernels[d].active_dim] = _on(col, Xc)
    mu, var = m.predict_f_from(m.predict_factors(), Xg, kernel=kernel)
    return _host(mu[:, 0]), _host(torch.clamp_min(var[:, 0], 0.0))


@torch.no_grad()
def _component_posterior(m, dims: List[int], grid_cols: List[np.ndarray]):
    """Mean and variance [S] of one additive component on a grid, as numpy.

    grid_cols[k] is the column of evaluation points for dims[k]; all columns
    have the same length S."""
    Xc = _conditioning_inputs(m)
    kernel = _EffectKernel([m.kernel.kernels[d] for d in dims],
                           _order_variance(m, len(dims), Xc))
    return _effect_posterior(m, kernel, dims, grid_cols)


@torch.no_grad()
def _summed_order1_posterior(m, xx: np.ndarray):
    """Mean and variance of the SUM of the continuous dims' order-1 effects
    on a shared grid (the latent-effect plot, i == D), as numpy.

    Binary and categorical dims are left out: their kernels look up integer
    levels and mean nothing on a continuous grid. The components share one
    posterior, so Var(Σ_d f_d) = Σ_d prior_d - (Σ_d Kxx_d) Qinv (Σ_d Kxx_d)ᵀ,
    not the sum of the marginal variances."""
    kernels = [k for k in m.kernel.kernels if isinstance(k, (OrthogonalRBF, UnconstrainedRBF))]
    if not kernels:
        raise ValueError("latent-effect plot needs at least one continuous dim")
    dims = [k.active_dim for k in kernels]
    kernel = _EffectKernel(kernels, _order_variance(m, 1, _conditioning_inputs(m)),
                           product=False)
    return _effect_posterior(m, kernel, dims, [xx] * len(dims))


@torch.no_grad()
def _corrected_data(m, X: np.ndarray, Y: np.ndarray, i: int) -> np.ndarray:
    """Y with every effect but dim i's order-1 effect removed, through the
    posterior mean: Y - (K(X, Xc) - K_i(X, Xc)) alpha."""
    alpha = m.posterior_alpha()
    Xc = _conditioning_inputs(m)
    kd = m.kernel.kernels[i]
    K_full = m.kernel.K(_on(X, Xc), Xc)
    K_i = _order_variance(m, 1, Xc) * kernel_K(kd, _on(X[:, kd.active_dim], Xc),
                                               Xc[:, kd.active_dim])
    return Y - _host((K_full - K_i) @ alpha)


def _apply(t, x):
    return np.asarray(x) if t is None else np.asarray(t(x))


# --------------------------------------------------------------------------- #
# The figure layout.
#
# Every effect plot has a main panel with the effect (a credible band, a
# labelled contour field, or interval marks per level), a thin histogram
# strip under it showing where the training data lie on that axis, and, when
# the effect has a second continuous axis, a strip along the left edge.
# EffectFigure owns the panel geometry, the mark styles, the binning, the
# raw-data overlay, tick hygiene and tikz export; the plot functions below
# never touch the geometry.

# Panel rectangles in figure fractions (x0, y0, width, height).
_PANEL_GEOMETRY = {
    "main": (0.2, 0.2, 0.75, 0.75),
    "bottom": (0.2, 0.05, 0.75, 0.15),
    "left": (0.08, 0.2, 0.12, 0.75),
}


class EffectFigure:
    """The layout every effect figure shares (see the comment above)."""

    BAND_COLOR = "C0"
    BAND_ALPHA = 0.2
    HIST_STYLE = {"color": "grey", "alpha": 0.2}
    #: overlay histograms comparing two populations (the X_list option)
    OVERLAY_SERIES = (("orange", "data 1"), ("blue", "data 2"))

    def __init__(self, figsize=(8, 4), n_main: int = 1, main_rect=None,
                 main_gap: float = 0.08):
        self.fig = _pyplot().figure(figsize=figsize)
        x0, y0, w, h = main_rect if main_rect is not None else _PANEL_GEOMETRY["main"]
        self._main_rect = (x0, y0, w, h)
        if n_main == 1:
            rows = [(x0, y0, w, h)]
        else:
            panel_h = (h - main_gap * (n_main - 1)) / n_main
            rows = [(x0, y0 + (n_main - 1 - k) * (panel_h + main_gap), w, panel_h)
                    for k in range(n_main)]
        first = self.fig.add_axes(rows[0])
        self.mains = [first] + [self.fig.add_axes(r, sharex=first) for r in rows[1:]]
        self.main = first
        self.bottom = None
        self.left = None

    # ---- main-panel marks -------------------------------------------------
    def band(self, x, mean, lower, upper, ax=None, mean_style=None):
        """The posterior mean in a ±2σ credible band: a translucent fill with
        thin dark edges, and a heavier dark mean unless ``mean_style`` says
        otherwise (the stacked binary panels label a coloured mean)."""
        ax = self.main if ax is None else ax
        ax.fill_between(x, lower, upper, alpha=self.BAND_ALPHA, color=self.BAND_COLOR)
        for edge in (lower, upper):
            ax.plot(x, edge, color="k", linewidth=0.5, zorder=11)
        style = mean_style if mean_style is not None else {
            "color": "k", "linewidth": 1, "zorder": 11}
        ax.plot(x, mean, **style)
        return ax

    def contour_field(self, gx, gy, z, label_fontsize: int = 20):
        """A labelled contour field of a two-dim effect on the main panel."""
        marks = self.main.contour(gx, gy, z, colors=self.BAND_COLOR, linewidths=1.4)
        self.main.clabel(marks, inline=1, fontsize=label_fontsize)
        return marks

    def interval_marks(self, lower, upper, mean, level_names, bar_color, point_color):
        """A discrete effect: a vertical credible bar and a mean cross per
        level, the level names on the x axis."""
        levels = np.arange(len(level_names))
        for c in levels:
            self.main.plot([c, c], [lower[c], upper[c]], linewidth=8, color=bar_color)
        self.main.plot(levels, mean, "x", color=point_color, linestyle="none")
        self.main.set_xticks(levels)
        self.main.set_xticklabels(level_names)
        self.main.set_xlim(-1, len(level_names))

    def raw_overlay(self, x, y, semilogy: bool = False):
        """The raw observations on a right-hand axis, behind the band (the
        main panel is lifted above it)."""
        twin = self.main.twinx()
        twin.plot(x, y, "C1x")
        twin.set_ylabel("Raw data", color="C1")
        if semilogy:
            twin.semilogy()
        self.main.set_zorder(twin.get_zorder() + 1)
        self.main.patch.set_visible(False)
        return twin

    # ---- marginal histogram strips -----------------------------------------
    @staticmethod
    def _bins(values, num_bin: int, log: bool):
        if not log:
            return num_bin
        lo, hi = np.log10(values.min() + 1), np.log10(values.max() + 1)
        return np.logspace(lo, hi, num_bin)

    def _strip_rect(self, side: str):
        """A strip's rectangle from the main panel's: the bottom strip shares
        its x0 and width and splits the margin under it 1:3, the left strip
        shares its y0 and height and splits the margin left of it 2:3. For
        the default main panel these are _PANEL_GEOMETRY's."""
        x0, y0, w, h = self._main_rect
        if side == "bottom":
            return (x0, 0.25 * y0, w, 0.75 * y0)
        return (0.4 * x0, y0, 0.6 * x0, h)

    def bottom_hist(self, values, xlabel: str, num_bin: int = 100,
                    log_bins: bool = False, overlay=None):
        """The marginal histogram strip under the main panel (shared x)."""
        ax = self.fig.add_axes(self._strip_rect("bottom"), sharex=self.main)
        values = np.ravel(np.asarray(values))
        bins = self._bins(values, num_bin, log_bins)
        if overlay is not None:
            for series, (color, name) in zip(overlay, self.OVERLAY_SERIES):
                ax.hist(series, bins=bins, alpha=0.3, color=color, label=name)
            ax.legend(loc="upper right", prop={"size": 12})
        else:
            ax.hist(values, bins=bins, **self.HIST_STYLE)
        ax.set_yticks([])
        ax.set_xlabel(xlabel)
        self.bottom = ax
        return ax

    def left_hist(self, values, ylabel: str, num_bin: int = 100, log_bins: bool = False):
        """The marginal histogram strip left of the main panel (shared y),
        its counts growing leftwards."""
        ax = self.fig.add_axes(self._strip_rect("left"), sharey=self.main)
        values = np.ravel(np.asarray(values))
        ax.hist(values, bins=self._bins(values, num_bin, log_bins),
                orientation="horizontal", **self.HIST_STYLE)
        ax.set_xticks([])
        ax.invert_xaxis()
        ax.set_ylabel(ylabel)
        self.left = ax
        return ax

    # ---- finishing ----------------------------------------------------------
    def finish(self, title: str, tikz_path=None) -> FigureDescription:
        """Tick hygiene and export: a main-panel axis that shares an axis
        with a strip hides its tick labels there; the strip carries them."""
        plt = _pyplot()
        if self.bottom is not None:
            for ax in self.mains:
                plt.setp(ax.get_xticklabels(), visible=False)
        if self.left is not None:
            plt.setp(self.main.get_yticklabels(), visible=False)
        _save_tikz(tikz_path, title)
        return FigureDescription(fig=self.fig, description=title)


def _band_limits(mu, var):
    sd = np.sqrt(var)
    return mu - 2 * sd, mu + 2 * sd


# --------------------------------------------------------------------------- #
def plot_single_effect(
    m, i: int, covariate_name: str = "", title: str = "",
    x_transform=None, y_transform=None, semilogy=False,
    plot_corrected_data=False, plot_raw_data=False, X_list=None,
    fontsize=22, tikz_path=None, ylim=None,
    quantile_range: Optional[List] = None, log_bin=False, num_bin: int = 100,
    data=None,
) -> FigureDescription:
    """The order-1 effect of continuous dim i on 100 points between the
    quantiles ``quantile_range`` of its data; i == D plots the summed
    order-1 latent profile over [-3, 3] (the reference's latent branch,
    which raised there)."""
    import matplotlib

    matplotlib.rcParams.update({"font.size": fontsize})
    X, Y = _model_data(m, data)
    latent = i == m.kernel.num_dims
    if latent:
        Xi = np.random.default_rng(0).normal(size=1000)
        xx = np.linspace(-3.0, 3.0, 100)
        mu, var = _summed_order1_posterior(m, xx)
    else:
        Xi = X[:, m.kernel.kernels[i].active_dim]
        lo, hi = [0, 100] if quantile_range is None else quantile_range
        xmin, xmax = np.percentile(Xi, (lo, hi))
        xx = np.linspace(xmin, xmax, 100)
        mu, var = _component_posterior(m, [i], [xx])
    lower, upper = _band_limits(mu, var)

    # the latent branch's grid has no data rows to pair with Y
    plot_corrected_data = plot_corrected_data and not latent
    plot_raw_data = plot_raw_data and not latent

    xx_r = _apply(x_transform, xx)
    Xi_r = _apply(x_transform, Xi)
    ef = EffectFigure()
    ef.band(xx_r, _apply(y_transform, mu), _apply(y_transform, lower),
            _apply(y_transform, upper))
    if plot_corrected_data:
        Yc = _apply(y_transform, _corrected_data(m, X, Y, i))
        ef.main.plot(Xi_r, Yc[:, 0], "C0x", label="data with other effects removed")
        ef.main.set_ylim(*np.percentile(Yc, (2, 98)))
    elif ylim is not None:
        ef.main.set_ylim(ylim)
    ef.main.set_xlim(xx_r.min(), xx_r.max())
    if plot_raw_data:
        ef.raw_overlay(Xi_r, _apply(y_transform, Y)[:, 0], semilogy=semilogy)
    ef.main.set_ylabel("$f_{" + covariate_name + "}$")
    ef.main.set_title(title)
    ef.bottom_hist(Xi_r, covariate_name, num_bin=num_bin, log_bins=log_bin, overlay=X_list)
    if semilogy:
        ef.main.semilogy()
    return ef.finish(title, tikz_path)


def plot_second_order(
    m, i: int, j: int, covariate_names=None, x_transforms=None, y_transform=None,
    title: str = "", tikz_path=None, quantile_range=((2, 98), (2, 98)),
    log_axis=(False, False), xx=None, yy=None, num_bin: int = 100, data=None,
) -> FigureDescription:
    """The mean of the order-2 effect of continuous dims (i, j) as contours
    on a 50 x 50 grid between their quantiles (or on ``xx``, ``yy``)."""
    if covariate_names is None:
        covariate_names = [f"input {i}", f"input {j}"]
    X, _ = _model_data(m, data)
    Xi, Xj = X[:, i], X[:, j]

    qr = list(quantile_range) if quantile_range is not None else [None, None]
    xmin, xmax = np.percentile(Xi, tuple(qr[0])) if qr[0] is not None else (Xi.min(), Xi.max())
    ymin, ymax = np.percentile(Xj, tuple(qr[1])) if qr[1] is not None else (Xj.min(), Xj.max())
    xx_range = np.linspace(xmin, xmax, 50) if xx is None else xx
    yy_range = np.linspace(ymin, ymax, 50) if yy is None else yy
    gx, gy = np.meshgrid(xx_range, yy_range)
    mu, _ = _component_posterior(m, [i, j], [gx.flatten(), gy.flatten()])

    tx, ty = [None, None] if x_transforms is None else x_transforms
    gx_r, Xi_r = _apply(tx, gx), _apply(tx, Xi)
    gy_r, Xj_r = _apply(ty, gy), _apply(ty, Xj)
    mu_r = _apply(y_transform, mu)

    log_x = bool(log_axis and log_axis[0])
    log_y = bool(log_axis and log_axis[1])
    ef = EffectFigure()
    if log_x:  # a log axis shows x + 1
        ef.main.set_xscale("log")
        gx_r, Xi_r = gx_r + 1, Xi_r + 1
    if log_y:
        ef.main.set_yscale("log")
        gy_r, Xj_r = gy_r + 1, Xj_r + 1
    ef.contour_field(gx_r, gy_r, mu_r.reshape(gx.shape))
    ef.main.set_title(title)
    ef.bottom_hist(Xi_r, covariate_names[0], num_bin=num_bin, log_bins=log_x)
    ef.left_hist(Xj_r, covariate_names[1], num_bin=num_bin, log_bins=log_y)
    ef.main.set_xlim(gx_r.min(), gx_r.max())
    ef.main.set_ylim(gy_r.min(), gy_r.max())
    return ef.finish(title, tikz_path)


def plot_single_effect_binary(
    m, i: int, binary_name: list, covariate_name: str = "",
    title: str = "Output Effect", y_transform=None, semilogy=False, tikz_path=None,
    data=None,
) -> FigureDescription:
    """The order-1 effect of binary dim i at its two levels, over box plots
    of the data with the other effects removed."""
    X, Y = _model_data(m, data)
    Xi = X[:, i]
    mu, var = _component_posterior(m, [i], [np.array([0.0, 1.0])])
    lower, upper = _band_limits(mu, var)
    Yc_r = _apply(y_transform, _corrected_data(m, X, Y, i))

    ef = EffectFigure(figsize=(10, 6), main_rect=(0.12, 0.12, 0.76, 0.8))
    box = ef.main.twinx()
    box.boxplot([Yc_r[Xi == 0][:, 0], Yc_r[Xi == 1][:, 0]], positions=[0, 1])
    box.set_ylabel("data with other effects removed", color="k")
    try:
        ef.main.sharey(box)
    except Exception:
        pass
    ef.interval_marks(_apply(y_transform, lower), _apply(y_transform, upper),
                      _apply(y_transform, mu), [binary_name[0], binary_name[1]],
                      bar_color="r", point_color="b")
    ef.main.set_ylabel(title, color="r")
    ef.main.set_title(covariate_name)
    if semilogy:
        ef.main.semilogy()
        box.semilogy()
    return ef.finish(title, tikz_path)


def plot_second_order_binary(
    m, i: int, j: int, binary_name: list, covariate_names=None, title: str = "",
    x_transforms=None, y_transform=None, tikz_path=None, data=None,
) -> FigureDescription:
    """The order-2 effect of continuous dim i and binary dim j: one band
    panel per level of j, on 100 points between i's 2 % and 98 % quantiles."""
    if covariate_names is None:
        covariate_names = [f"input {i}", f"input {j}"]
    X, _ = _model_data(m, data)
    Xi = X[:, i]
    xmin, xmax = np.percentile(Xi, (2, 98))
    xx, yy = np.mgrid[xmin:xmax:100j, 0:1:2j]
    mu, var = _component_posterior(m, [i, j], [xx.flatten(), yy.flatten()])
    lower, upper = _band_limits(mu, var)

    if x_transforms is None:
        xx_r, Xi_r = 1.0 * xx[:, 0], 1.0 * Xi
    else:
        xx_r, Xi_r = _apply(x_transforms[0], xx[:, 0]), _apply(x_transforms[0], Xi)
    mu_r, lower_r, upper_r = (_apply(y_transform, a) for a in (mu, lower, upper))

    ef = EffectFigure(figsize=(10, 6), n_main=2)
    levels = yy.flatten()
    for ax, level, name in ((ef.mains[0], 0, binary_name[0]),
                            (ef.mains[1], 1, binary_name[1])):
        sel = levels == level
        ef.band(xx_r, mu_r[sel], lower_r[sel], upper_r[sel], ax=ax,
                mean_style={"linewidth": 2, "color": "C0", "zorder": 10, "label": name})
        ax.legend()
    ef.mains[0].set_title(title)
    ef.mains[0].set_xlim(xx_r.min(), xx_r.max())
    ef.bottom_hist(Xi_r, covariate_names[0], num_bin=50)
    return ef.finish(title, tikz_path)


def plot_single_effect_categorical(
    m, i: int, categorical_name: list, title: str = "Output Effect",
    y_transform=None, semilogy=False, tikz_path=None,
) -> FigureDescription:
    """The order-1 effect of categorical dim i at each of its levels."""
    num_cat = m.kernel.kernels[i].num_cat
    mu, var = _component_posterior(m, [i], [np.arange(num_cat, dtype=float)])
    lower, upper = _band_limits(mu, var)

    ef = EffectFigure(figsize=(10, 6), main_rect=(0.12, 0.12, 0.76, 0.8))
    ef.interval_marks(_apply(y_transform, lower), _apply(y_transform, upper),
                      _apply(y_transform, mu),
                      [categorical_name[c] for c in range(num_cat)],
                      bar_color="cornflowerblue", point_color="r")
    ef.main.set_ylabel("Output Effect")
    ef.main.set_title(title)
    if semilogy:
        ef.main.semilogy()
    return ef.finish(title, tikz_path)


# --------------------------------------------------------------------------- #
def plot_model(
    oak, transformer_y=None, X_columns=None, X_lists=None, top_n=None,
    likelihood_variance=False, semilogy=False, save_fig=None, tikz_path=None,
    ylim=None, quantile_range=None, log_axis=(False, False), grid_range=None,
    log_bin=None, num_bin: int = 100,
) -> List[FigureDescription]:
    """Rank the components of an ``oak_model`` by Sobol index and plot the
    top_n of orders 1 and 2 (the dispatch of the reference's
    ``oak_model.plot``, model_utils.py:526-700); with ``save_fig``, save
    them there as PDFs. Higher orders are skipped (the reference raises)."""
    num_dims = oak.num_dims
    if X_columns is None:
        X_columns = ["feature %d" % d for d in range(num_dims)]
    X_lists = X_lists or [None] * num_dims
    grid_range = grid_range or [None] * num_dims
    ylim = ylim or [None] * num_dims
    quantile_range = quantile_range or [None] * num_dims
    log_bin = log_bin or [False] * num_dims

    data = (oak.X_scaled, oak.Y_scaled)
    oak.get_sobol(likelihood_variance=likelihood_variance)
    order = np.argsort(oak.normalised_sobols)[::-1]
    tuples = oak.tuple_of_indices
    m = oak.m
    cont, binary = oak.continuous_index, oak.binary_index
    fig_list: List[FigureDescription] = []
    top_n = len(order) if top_n is None else top_n
    for n in order[: min(top_n, len(order))]:
        dims = tuples[n]
        r = oak.normalised_sobols[n]
        if len(dims) == 1:
            i = dims[0]
            title = f"{X_columns[i]} (R={r:.3f})"
            if i in cont:
                fig_list.append(plot_single_effect(
                    m, i, covariate_name=X_columns[i], title=title,
                    x_transform=oak._get_x_inverse_transformer(i),
                    y_transform=transformer_y, semilogy=semilogy,
                    X_list=X_lists[i], tikz_path=tikz_path, ylim=ylim[i],
                    quantile_range=quantile_range[i], log_bin=log_bin[i],
                    num_bin=num_bin, data=data))
            elif i in binary:
                fig_list.append(plot_single_effect_binary(
                    m, i, ["0", "1"], title=title, y_transform=transformer_y,
                    semilogy=semilogy, tikz_path=tikz_path, data=data))
            else:
                fig_list.append(plot_single_effect_categorical(
                    m, i, [str(c) for c in range(m.kernel.kernels[i].num_cat)],
                    title=title, y_transform=transformer_y, semilogy=semilogy,
                    tikz_path=tikz_path))
        elif len(dims) == 2:
            i, j = dims
            if i in cont and j in cont:
                fig_list.append(plot_second_order(
                    m, i, j, [X_columns[i], X_columns[j]],
                    [oak._get_x_inverse_transformer(i), oak._get_x_inverse_transformer(j)],
                    transformer_y, title=f"{X_columns[i]}&{X_columns[j]} (R={r:.3f})",
                    tikz_path=tikz_path, quantile_range=[quantile_range[i], quantile_range[j]],
                    log_axis=log_axis, xx=grid_range[i], yy=grid_range[j],
                    num_bin=num_bin, data=data))
            elif i in cont and j in binary:
                fig_list.append(plot_second_order_binary(
                    m, i, j, ["0", "1"], [X_columns[i], X_columns[j]],
                    x_transforms=[oak._get_x_inverse_transformer(i)],
                    y_transform=transformer_y, title=f"{X_columns[i]} (R={r:.3f})",
                    tikz_path=tikz_path, data=data))
            elif i in binary and j in cont:
                fig_list.append(plot_second_order_binary(
                    m, j, i, ["0", "1"], [X_columns[j], X_columns[i]],
                    x_transforms=[oak._get_x_inverse_transformer(j)],
                    y_transform=transformer_y,
                    title=f"{X_columns[i]}&{X_columns[j]} (R={r:.3f})",
                    tikz_path=tikz_path, data=data))

    if save_fig is not None:
        save_fig_list(fig_list, Path(save_fig))
    return fig_list
