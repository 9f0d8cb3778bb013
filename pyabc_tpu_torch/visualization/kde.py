"""Posterior KDE plots (port of ``pyabc_tpu/visualization/kde.py``).

The density grids are evaluated with the weighted-KDE kernel the run
proposes with (``transition/multivariatenormal.py``), on ``device``: the
card unless the caller passes ``device="cpu"``.  matplotlib only
renders the resulting numpy grids.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device


def _default_kde(device=None):
    """Default visualization KDE: an MVN transition with a
    cross-validated scaling (``GridSearchCV``'s defaults), its bootstrap
    on ``device``."""
    from ..transition import GridSearchCV

    return GridSearchCV(device=device)


def _fitted_density(kde, device, support, w, pts_eval) -> np.ndarray:
    """Fit ``kde`` (the CV default when None) to the weighted
    ``support`` and return its density at ``pts_eval`` as host numpy;
    the density runs on ``device``.  A transition that carries a
    ``device`` of None (a ``GridSearchCV``) runs its bootstrap there
    too, as under ``ABCSMC``."""
    dev = resolve_device(device)
    tr = kde or _default_kde(dev)
    if getattr(tr, "device", False) is None:
        tr.device = dev
    tr.fit(np.array(support, dtype=np.float32),
           np.asarray(w, dtype=np.float32))
    x = torch.as_tensor(np.asarray(pts_eval, dtype=np.float32), device=dev)
    return tr.pdf(x).cpu().numpy()


def kde_1d(df, w, x: str, xmin=None, xmax=None, numx: int = 50,
           kde=None, device=None):
    """Weighted 1D KDE over a ``numx``-point grid: ``(grid, density)``."""
    vals = df[x].to_numpy()
    if xmin is None:
        xmin = vals.min()
    if xmax is None:
        xmax = vals.max()
    pad = 0.05 * max(xmax - xmin, 1e-10)
    grid = np.linspace(xmin - pad, xmax + pad, numx)
    dens = _fitted_density(kde, device, vals[:, None], w, grid[:, None])
    return grid, dens


def plot_kde_1d(df, w, x: str, xmin=None, xmax=None, numx: int = 50,
                ax=None, refval=None, kde=None, device=None, **kwargs):
    import matplotlib.pyplot as plt

    grid, dens = kde_1d(df, w, x, xmin, xmax, numx, kde, device)
    if ax is None:
        _, ax = plt.subplots()
    ax.plot(grid, dens, **kwargs)
    ax.set_xlabel(x)
    ax.set_ylabel("Posterior")
    if refval is not None and x in refval:
        ax.axvline(refval[x], color="C1", linestyle="dotted")
    return ax


def kde_2d(df, w, x: str, y: str, xmin=None, xmax=None, ymin=None,
           ymax=None, numx: int = 50, numy: int = 50, kde=None,
           device=None):
    """Weighted 2D KDE over a ``numy x numx`` mesh: ``(mx, my,
    density)``."""
    xv, yv = df[x].to_numpy(), df[y].to_numpy()
    xmin = xv.min() if xmin is None else xmin
    xmax = xv.max() if xmax is None else xmax
    ymin = yv.min() if ymin is None else ymin
    ymax = yv.max() if ymax is None else ymax
    gx = np.linspace(xmin, xmax, numx)
    gy = np.linspace(ymin, ymax, numy)
    mx, my = np.meshgrid(gx, gy)
    pts = np.stack([mx.ravel(), my.ravel()], axis=-1)
    dens = _fitted_density(kde, device, np.stack([xv, yv], axis=-1), w,
                           pts)
    return mx, my, dens.reshape(numy, numx)


def plot_kde_2d(df, w, x: str, y: str, ax=None, colorbar: bool = True,
                refval=None, shading="auto", **kwargs):
    import matplotlib.pyplot as plt

    mx, my, dens = kde_2d(df, w, x, y, **{k: v for k, v in kwargs.items()
                                          if k in ("xmin", "xmax", "ymin",
                                                   "ymax", "numx", "numy",
                                                   "kde", "device")})
    if ax is None:
        _, ax = plt.subplots()
    mesh = ax.pcolormesh(mx, my, dens, shading=shading)
    ax.set_xlabel(x)
    ax.set_ylabel(y)
    if colorbar:
        plt.colorbar(mesh, ax=ax, label="Posterior")
    if refval is not None:
        ax.scatter([refval[x]], [refval[y]], color="C1", marker="x")
    return ax


def plot_kde_1d_highlevel(history, x: str, m: int = 0, t=None, **kwargs):
    """:func:`plot_kde_1d` of model ``m``'s generation ``t``."""
    df, w = history.get_distribution(m=m, t=t)
    return plot_kde_1d(df, w, x, **kwargs)


def plot_kde_2d_highlevel(history, x: str, y: str, m: int = 0, t=None,
                          **kwargs):
    """:func:`plot_kde_2d` of model ``m``'s generation ``t``."""
    df, w = history.get_distribution(m=m, t=t)
    return plot_kde_2d(df, w, x, y, **kwargs)


def plot_kde_matrix_highlevel(history, m: int = 0, t=None, **kwargs):
    """:func:`plot_kde_matrix` of model ``m``'s generation ``t``."""
    df, w = history.get_distribution(m=m, t=t)
    return plot_kde_matrix(df, w, **kwargs)


def plot_kde_matrix(df, w, limits: Optional[dict] = None, refval=None,
                    kde=None, names: Optional[list] = None, device=None):
    """Pairwise KDE matrix: 1D KDEs on the diagonal, 2D below it.
    ``limits`` maps parameter name -> (min, max) plot range."""
    import matplotlib.pyplot as plt

    names = names or list(df.columns)
    n = len(names)
    limits = limits or {}
    fig, axes = plt.subplots(n, n, figsize=(2.5 * n, 2.5 * n),
                             squeeze=False)
    for i, yi in enumerate(names):
        for j, xj in enumerate(names):
            ax = axes[i][j]
            # limits values may be tuples or arrays — test for presence,
            # never truthiness (ambiguous for arrays)
            xlo, xhi = limits.get(xj, (None, None))
            if i == j:
                plot_kde_1d(df, w, xj, ax=ax, refval=refval, kde=kde,
                            xmin=xlo, xmax=xhi, device=device)
            elif i > j:
                ylo, yhi = limits.get(yi, (None, None))
                plot_kde_2d(df, w, xj, yi, ax=ax, colorbar=False,
                            refval=refval, kde=kde, device=device,
                            xmin=xlo, xmax=xhi, ymin=ylo, ymax=yhi)
            else:
                ax.axis("off")
    fig.tight_layout()
    return axes
