"""Run-trajectory plots: epsilons, sample numbers, acceptance rates, model
probabilities, ESS, credible intervals, histograms and data plots (port
of ``pyabc_tpu/visualization/run_plots.py``).  The posterior mode
(:func:`compute_kde_max`) evaluates its KDE on ``device``, the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from ..weighted_statistics import effective_sample_size, weighted_quantile


def _axes(ax):
    import matplotlib.pyplot as plt
    if ax is None:
        _, ax = plt.subplots()
    return ax


def _histories(histories):
    return histories if isinstance(histories, (list, tuple)) else [histories]


def plot_epsilons(histories, labels: Optional[List[str]] = None, ax=None,
                  scale: str = "log"):
    ax = _axes(ax)
    for i, h in enumerate(_histories(histories)):
        pops = h.get_all_populations()
        pops = pops[pops.t >= 0]
        label = labels[i] if labels else f"run {h.id}"
        ax.plot(pops.t, pops.epsilon, "x-", label=label)
    if scale == "log":
        ax.set_yscale("log")
    ax.set_xlabel("Population index t")
    ax.set_ylabel("Epsilon")
    ax.legend()
    return ax


def plot_sample_numbers(histories, labels=None, ax=None, rotation: int = 0):
    ax = _axes(ax)
    for i, h in enumerate(_histories(histories)):
        pops = h.get_all_populations()
        pops = pops[pops.t >= 0]
        label = labels[i] if labels else f"run {h.id}"
        ax.bar(pops.t + i * 0.2, pops.samples, width=0.2, label=label)
    ax.set_xlabel("Population index t")
    ax.set_ylabel("Samples")
    ax.legend()
    return ax


def plot_total_sample_numbers(histories, labels=None, ax=None):
    ax = _axes(ax)
    hs = _histories(histories)
    totals = [h.get_all_populations().samples.sum() for h in hs]
    names = labels or [f"run {h.id}" for h in hs]
    ax.bar(names, totals)
    ax.set_ylabel("Total samples")
    return ax


def plot_sample_numbers_trajectory(histories, labels=None, ax=None,
                                   yscale: str = "log",
                                   rotation: int = 0):
    """Required-samples trajectory over generations (sample.py:174-255)."""
    ax = _axes(ax)
    for i, h in enumerate(_histories(histories)):
        pops = h.get_all_populations()
        pops = pops[pops.t >= 0]
        label = labels[i] if labels else f"run {h.id}"
        ax.plot(pops.t, pops.samples, "x-", label=label)
    ax.set_yscale(yscale)
    ax.set_xlabel("Population index t")
    ax.set_ylabel("Samples")
    ax.tick_params(axis="x", rotation=rotation)
    ax.legend()
    return ax


def plot_acceptance_rates_trajectory(histories, labels=None, ax=None):
    ax = _axes(ax)
    for i, h in enumerate(_histories(histories)):
        pops = h.get_all_populations()
        pops = pops[pops.t >= 0]
        n_particles = h.get_nr_particles_per_population()
        rates = [n_particles.get(t, 0) / s if s else np.nan
                 for t, s in zip(pops.t, pops.samples)]
        label = labels[i] if labels else f"run {h.id}"
        ax.plot(pops.t, rates, "x-", label=label)
    ax.set_xlabel("Population index t")
    ax.set_ylabel("Acceptance rate")
    ax.legend()
    return ax


def plot_model_probabilities(history, ax=None):
    ax = _axes(ax)
    probs = history.get_model_probabilities()
    probs.plot.bar(ax=ax)
    ax.set_ylabel("Model probability")
    return ax


def plot_effective_sample_sizes(histories, labels=None, ax=None):
    ax = _axes(ax)
    for i, h in enumerate(_histories(histories)):
        ts, esss = [], []
        for t in range(h.max_t + 1):
            df = h.get_weighted_distances(t)
            if len(df):
                ts.append(t)
                esss.append(float(effective_sample_size(df["w"].to_numpy())))
        label = labels[i] if labels else f"run {h.id}"
        ax.plot(ts, esss, "x-", label=label)
    ax.set_xlabel("Population index t")
    ax.set_ylabel("ESS")
    ax.legend()
    return ax


def plot_credible_intervals(history, m: int = 0, par_names=None,
                            levels=(0.95,), show_mean: bool = True,
                            axes=None):
    """Per-generation credible-interval trajectories (credible.py:12-392)."""
    import matplotlib.pyplot as plt

    df0, _ = history.get_distribution(m=m)
    par_names = par_names or list(df0.columns)
    n = len(par_names)
    if axes is None:
        _, axes = plt.subplots(n, 1, figsize=(6, 2.5 * n), squeeze=False)
        axes = axes[:, 0]
    for k, par in enumerate(par_names):
        ax = axes[k]
        ts = list(range(history.max_t + 1))
        for level in levels:
            lows, highs = [], []
            for t in ts:
                df, w = history.get_distribution(m=m, t=t)
                vals = df[par].to_numpy()
                lows.append(float(weighted_quantile(
                    vals, w, alpha=(1 - level) / 2)))
                highs.append(float(weighted_quantile(
                    vals, w, alpha=1 - (1 - level) / 2)))
            ax.fill_between(ts, lows, highs, alpha=0.3,
                            label=f"{level:.0%} CI")
        if show_mean:
            means = []
            for t in ts:
                df, w = history.get_distribution(m=m, t=t)
                means.append(float(np.sum(df[par].to_numpy() * w)))
            ax.plot(ts, means, "x-", label="mean")
        ax.set_xlabel("Population index t")
        ax.set_ylabel(par)
        ax.legend()
    return axes


def compute_quantile(vals, weights, alpha: float) -> float:
    """Weighted quantile (credible.py:387-397)."""
    return float(weighted_quantile(np.asarray(vals), np.asarray(weights),
                                   alpha=alpha))


def compute_credible_interval(vals, weights, confidence: float = 0.95):
    """(lower, upper) weighted credible interval (credible.py:356-373)."""
    lb = compute_quantile(vals, weights, (1 - confidence) / 2)
    ub = compute_quantile(vals, weights, 1 - (1 - confidence) / 2)
    return lb, ub


def compute_kde_max(kde, df, w, device=None) -> np.ndarray:
    """Posterior mode: the sample point where the KDE fitted to the
    weighted sample is densest (the density runs on ``device``)."""
    import torch

    from ..device import resolve_device
    vals = df.to_numpy()
    kde.fit(vals.astype(np.float32), np.asarray(w, dtype=np.float32))
    dens = kde.pdf(torch.tensor(vals, dtype=torch.float32,
                                device=resolve_device(device)))
    return vals[int(np.argmax(dens.cpu().numpy()))]


def plot_credible_intervals_for_time(histories, labels=None, ms=None,
                                     ts=None, par_names=None,
                                     levels=(0.95,), show_mean: bool = False,
                                     show_kde_max: bool = False,
                                     refvals=None, kde=None, axes=None,
                                     rotation: int = 0, device=None):
    """Credible intervals of several runs side by side at one time point
    each (credible.py:177-353): one subplot per parameter, one x position
    per history, nested error bars per confidence level."""
    import matplotlib.pyplot as plt

    hs = _histories(histories)
    n_run = len(hs)
    labels = labels or [f"run {h.id}" for h in hs]
    ms = ms if isinstance(ms, (list, tuple)) else [ms or 0] * n_run
    ts = ts if isinstance(ts, (list, tuple)) else \
        [h.max_t if ts is None else ts for h in hs]
    if refvals is not None and not isinstance(refvals, list):
        refvals = [refvals] * n_run
    if par_names is None:
        df0, _ = hs[0].get_distribution(m=ms[0], t=ts[0])
        par_names = list(df0.columns)
    levels = sorted(levels)
    n_par = len(par_names)
    if axes is None:
        _, axes = plt.subplots(n_par, 1, figsize=(6, 2.5 * n_par),
                               squeeze=False)
        axes = axes[:, 0]
    xs = np.arange(n_run)
    # one DB read (and at most one KDE fit) per history, not per parameter
    dists = [h.get_distribution(m=m, t=t) for h, m, t in zip(hs, ms, ts)]
    modes = None
    if show_kde_max:
        from ..transition import MultivariateNormalTransition
        modes = [compute_kde_max(kde or MultivariateNormalTransition(),
                                 df, w, device=device) for df, w in dists]
    for k, par in enumerate(par_names):
        ax = axes[k]
        for i, (df, w) in enumerate(dists):
            vals = df[par].to_numpy()
            median = compute_quantile(vals, w, 0.5)
            for li, level in enumerate(levels):
                lb, ub = compute_credible_interval(vals, w, level)
                ax.errorbar(x=[i], y=[median],
                            yerr=[[median - lb], [ub - median]],
                            capsize=10 / (li + 1), color=f"C{li}")
            if show_mean:
                ax.plot([i], [float(np.sum(vals * w))], "x", color="C6")
            if modes is not None:
                ax.plot([i], [modes[i][list(df.columns).index(par)]], "+",
                        color="C7")
            if refvals is not None and par in refvals[i]:
                ax.plot([i], [refvals[i][par]], "o", color="C4",
                        fillstyle="none")
        ax.set_xticks(xs)
        ax.set_xticklabels(labels, rotation=rotation)
        ax.set_ylabel(par)
    return axes


# ---------------------------------------------------------------------------
# histograms (histogram.py:8-253): highlevel takes a History, lowlevel arrays
# ---------------------------------------------------------------------------

def plot_histogram_1d_lowlevel(vals, weights=None, bins: int = 50, ax=None,
                               xname: str = "", refval=None, **kwargs):
    """histogram.py:49-84."""
    ax = _axes(ax)
    ax.hist(np.asarray(vals), weights=weights, bins=bins, density=True,
            **kwargs)
    if refval is not None:
        ax.axvline(refval, color="C1", linestyle="dotted")
    ax.set_xlabel(xname)
    ax.set_ylabel("Posterior")
    return ax


def plot_histogram_2d_lowlevel(xvals, yvals, weights=None, bins: int = 50,
                               ax=None, xname: str = "", yname: str = "",
                               refval=None, **kwargs):
    """histogram.py:128-169."""
    ax = _axes(ax)
    ax.hist2d(np.asarray(xvals), np.asarray(yvals), weights=weights,
              bins=bins, **kwargs)
    if refval is not None:
        ax.scatter([refval[0]], [refval[1]], color="C1", marker="x")
    ax.set_xlabel(xname)
    ax.set_ylabel(yname)
    return ax


def _dist_args(obj, w_or_x, args, kwargs):
    """Dispatch highlevel (History, x[, y], m=, t=) vs lowlevel-style
    (df, w, x[, y]) first arguments, returning (df, w, names)."""
    if hasattr(obj, "get_distribution"):  # History
        m = kwargs.pop("m", 0)
        t = kwargs.pop("t", None)
        df, w = obj.get_distribution(m=m, t=t)
        names = [w_or_x, *args]
        return df, w, names
    names = list(args)
    return obj, w_or_x, names


def plot_histogram_1d(obj, w_or_x, *args, bins: int = 50, ax=None,
                      refval=None, **kwargs):
    """Weighted 1D marginal histogram (histogram.py:8-46).

    Accepts the reference's highlevel form ``(history, x, m=..., t=...)``
    or array form ``(df, w, x)``.
    """
    df, w, names = _dist_args(obj, w_or_x, args, kwargs)
    x = names[0]
    return plot_histogram_1d_lowlevel(
        df[x].to_numpy(), w, bins=bins, ax=ax, xname=x,
        refval=refval[x] if refval else None, **kwargs)


def plot_histogram_2d(obj, w_or_x, *args, bins: int = 50, ax=None,
                      refval=None, **kwargs):
    """Weighted 2D histogram (histogram.py:87-125); highlevel form
    ``(history, x, y, m=..., t=...)`` or array form ``(df, w, x, y)``."""
    df, w, names = _dist_args(obj, w_or_x, args, kwargs)
    x, y = names[0], names[1]
    return plot_histogram_2d_lowlevel(
        df[x].to_numpy(), df[y].to_numpy(), w, bins=bins, ax=ax,
        xname=x, yname=y,
        refval=(refval[x], refval[y]) if refval else None, **kwargs)


def plot_histogram_matrix_lowlevel(df, w=None, bins: int = 50, refval=None,
                                   **kwargs):
    """histogram.py:206-253: hist 1d on the diagonal, scatter off it."""
    import matplotlib.pyplot as plt

    names = list(df.columns)
    n = len(names)
    fig, axes = plt.subplots(n, n, figsize=(2.5 * n, 2.5 * n),
                             squeeze=False)
    for i, yi in enumerate(names):
        for j, xj in enumerate(names):
            ax = axes[i][j]
            if i == j:
                plot_histogram_1d_lowlevel(
                    df[xj].to_numpy(), w, bins=bins, ax=ax, xname=xj,
                    refval=refval[xj] if refval else None)
            else:
                ax.scatter(df[xj].to_numpy(), df[yi].to_numpy(),
                           s=4, alpha=0.5)
                if refval is not None:
                    ax.scatter([refval[xj]], [refval[yi]], color="C1",
                               marker="x")
                ax.set_xlabel(xj)
                ax.set_ylabel(yi)
    fig.tight_layout()
    return axes


def plot_histogram_matrix(history, m: int = 0, t=None, bins: int = 50,
                          refval=None, **kwargs):
    """histogram.py:172-203."""
    df, w = history.get_distribution(m=m, t=t)
    return plot_histogram_matrix_lowlevel(df, w, bins=bins, refval=refval,
                                          **kwargs)


# ---------------------------------------------------------------------------
# data plots (data.py:13-175)
# ---------------------------------------------------------------------------

def plot_data_callback_lowlevel(sum_stats: List, weights,
                                f_plot: Optional[Callable] = None,
                                f_plot_aggregated: Optional[Callable] = None,
                                ax=None, **kwargs):
    """data.py:50-78: ``f_plot(sum_stat, weight, ax, **kw)`` per particle,
    ``f_plot_aggregated(sum_stats, weights, ax, **kw)`` once."""
    ax = _axes(ax)
    if f_plot is not None:
        for sum_stat, weight in zip(sum_stats, weights):
            f_plot(sum_stat, weight, ax, **kwargs)
    if f_plot_aggregated is not None:
        f_plot_aggregated(sum_stats, weights, ax, **kwargs)
    return ax


def plot_data_callback(history, f_plot: Optional[Callable] = None,
                       f_plot_aggregated: Optional[Callable] = None,
                       t=None, n: Optional[int] = None, ax=None, **kwargs):
    """Plot stored sum-stats via callbacks (data.py:13-47). ``n`` bounds
    how many particles are drawn (extension: the reference draws all)."""
    weights, sum_stats = history.get_weighted_sum_stats(t=t)
    if n is not None and len(sum_stats) > n:
        idx = np.linspace(0, len(sum_stats) - 1, n).astype(int)
        sum_stats = [sum_stats[i] for i in idx]
        weights = weights[idx]
    return plot_data_callback_lowlevel(
        sum_stats, weights, f_plot, f_plot_aggregated, ax, **kwargs)


def plot_data_default(obs_data: dict, sim_data: dict, keys=None):
    """Default observed-vs-simulated grid (data.py:81-175): line plot for
    1d values, coordinate scatter for 2d, DataFrame columns supported."""
    import matplotlib.pyplot as plt
    import pandas as pd

    if keys is None:
        keys = list(obs_data.keys())
    if not isinstance(keys, list):
        keys = [keys]
    obs_data = {k: obs_data[k] for k in keys}
    sim_data = {k: sim_data[k] for k in keys}
    ndata = len(obs_data)
    ncols = int(np.ceil(np.sqrt(ndata)))
    nrows = ncols
    while ncols * (nrows - 1) >= ndata:
        nrows -= 1
    fig, arr_ax = plt.subplots(nrows, ncols, squeeze=False)
    flat_axes = arr_ax.flatten()
    for idx, key in enumerate(keys):
        ax = flat_axes[idx]
        obs, sim = obs_data[key], sim_data[key]
        if isinstance(obs, pd.DataFrame):
            if len(obs.columns) == 1:
                ax.plot(np.asarray(sim).flatten(), "-x", label="Simulation")
                ax.plot(np.asarray(obs).flatten(), "-x", label="Data")
                ax.set_xlabel("Index")
                ax.set_ylabel(obs.columns[0])
            else:
                for col in obs.columns:
                    ax.scatter(obs[col].to_numpy(), sim[col].to_numpy(),
                               label=col)
                ax.set_xlabel("Data")
                ax.set_ylabel("Simulation")
        else:
            obs = np.atleast_1d(np.asarray(obs))
            sim = np.atleast_1d(np.asarray(sim))
            if obs.ndim == 1:
                ax.plot(sim, "-x", color="C0", label="Simulation")
                ax.plot(obs, "-x", color="C1", label="Data")
                ax.set_xlabel("Index")
                ax.set_ylabel(str(key))
            else:
                for j, (ov, sv) in enumerate(zip(obs, sim)):
                    ax.scatter(ov, sv, label=f"Coordinate {j}")
                ax.set_xlabel("Data")
                ax.set_ylabel("Simulation")
        ax.set_title(str(key))
        ax.legend()
    for ax in flat_axes[ndata:]:
        ax.axis("off")
    fig.tight_layout()
    return arr_ax
