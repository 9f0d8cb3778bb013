"""The port's ``visualization`` package against the JAX package's.

One small run of config #2 written by the JAX package (pop 300, three
generations) is read through each package's ``History``, and every
plot of both is drawn on an Agg canvas: the data of each figure (line
vertices, bar and histogram patches, filled bands, meshes) agrees
within 1e-6, and the KDE densities within the KDE tolerance of
``tests/test_ops_kde_pallas.py`` (density rtol 5e-3, atol 1e-8).  The
port evaluates its KDEs with ``device="cpu"``; two-parameter plots take
a two-column sample made from a seed with numpy.
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
import pyabc_tpu.visualization as jviz  # noqa: E402
import pyabc_tpu_torch as pt  # noqa: E402
from pyabc_tpu.models import make_two_gaussians_problem as jax_problem  # noqa: E402
from pyabc_tpu.storage.history import History as JaxHistory  # noqa: E402
from pyabc_tpu.transition import \
    MultivariateNormalTransition as JaxMVN  # noqa: E402
from pyabc_tpu_torch import visualization as viz  # noqa: E402
from pyabc_tpu_torch.storage import History  # noqa: E402
from pyabc_tpu_torch.transition import (GridSearchCV,  # noqa: E402
                                        MultivariateNormalTransition)

KDE_RTOL, KDE_ATOL = 5e-3, 1e-8
TOL = 1e-6


@pytest.fixture(scope="module")
def histories(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("viz") / "jax.db")
    models, priors, distance, observed, _ = jax_problem()
    abc = jpt.ABCSMC(models, priors, distance, population_size=300,
                     sampler=jpt.VectorizedSampler(), seed=3)
    abc.new(path, observed)
    abc.run(max_nr_populations=3)
    return JaxHistory(path, abc_id=1), History(path, abc_id=1)


def _sample2d(n=300, seed=5):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({"a": rng.normal(0.0, 1.0, n),
                       "b": rng.normal(1.0, 0.5, n)})
    w = rng.uniform(0.5, 1.5, n)
    return df, w / w.sum()


def _figure_data(axes_like):
    """Every drawn datum of the figure of ``axes_like``, in draw order."""
    ax0 = np.ravel(np.asarray(axes_like, dtype=object))[0]
    fig = ax0.figure
    out = []
    for ax in fig.axes:
        out.append([ln.get_xydata() for ln in ax.lines])
        out.append([np.array([p.get_x(), p.get_y(), p.get_width(),
                              p.get_height()])
                    for p in ax.patches if hasattr(p, "get_height")])
        coll = []
        for c in ax.collections:
            arr = c.get_array()
            coll.append(np.asarray(arr if arr is not None
                                   else c.get_offsets()))
            for path in c.get_paths()[:50]:
                coll.append(path.vertices)
        out.append(coll)
    plt.close(fig)
    return out


def _assert_close(a, b, rtol, atol):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, list):
            _assert_close(x, y, rtol, atol)
        else:
            np.testing.assert_allclose(np.asarray(x, float),
                                       np.asarray(y, float), rtol=rtol,
                                       atol=atol)


# ---- the density grids -----------------------------------------------------


@pytest.mark.parametrize("t", [0, 2])
def test_kde_1d_equals_the_jax_package(histories, t):
    jh, ph = histories
    for m in (0, 1):
        df, w = ph.get_distribution(m=m, t=t)
        jdf, jw = jh.get_distribution(m=m, t=t)
        grid, dens = viz.kde_1d(df, w, "mu", numx=64,
                                kde=MultivariateNormalTransition(),
                                device="cpu")
        jgrid, jdens = jviz.kde_1d(jdf, jw, "mu", numx=64,
                                   kde=JaxMVN(scaling=1.0))
        np.testing.assert_array_equal(grid, jgrid)
        np.testing.assert_allclose(dens, jdens, rtol=KDE_RTOL,
                                   atol=KDE_ATOL)


def test_kde_2d_equals_the_jax_package():
    df, w = _sample2d()
    mx, my, dens = viz.kde_2d(df, w, "a", "b", numy=40,
                              kde=MultivariateNormalTransition(),
                              device="cpu")
    jmx, jmy, jdens = jviz.kde_2d(df, w, "a", "b", numy=40,
                                  kde=JaxMVN(scaling=1.0))
    assert dens.shape == (40, 50)
    np.testing.assert_array_equal(mx, jmx)
    np.testing.assert_array_equal(my, jmy)
    np.testing.assert_allclose(dens, jdens, rtol=KDE_RTOL, atol=KDE_ATOL)


def test_plot_kde_matrix_data_equals_the_jax_package():
    df, w = _sample2d()
    limits = {"a": (-3.0, 3.0)}
    got = _figure_data(viz.plot_kde_matrix(
        df, w, limits=limits, kde=MultivariateNormalTransition(),
        refval={"a": 0.0, "b": 1.0}, device="cpu"))
    ref = _figure_data(jviz.plot_kde_matrix(
        df, w, limits=limits, kde=JaxMVN(scaling=1.0),
        refval={"a": 0.0, "b": 1.0}))
    _assert_close(got, ref, KDE_RTOL, KDE_ATOL)


def test_compute_kde_max_picks_the_same_point(histories):
    jh, ph = histories
    df, w = ph.get_distribution(m=0, t=2)
    jdf, jw = jh.get_distribution(m=0, t=2)
    got = viz.compute_kde_max(MultivariateNormalTransition(), df, w,
                              device="cpu")
    ref = jviz.compute_kde_max(JaxMVN(), jdf, jw)
    np.testing.assert_array_equal(got, ref)
    df2, w2 = _sample2d()
    np.testing.assert_array_equal(
        viz.compute_kde_max(MultivariateNormalTransition(), df2, w2,
                            device="cpu"),
        jviz.compute_kde_max(JaxMVN(), df2, w2))


def test_kde_default_is_cv_scaled():
    """``kde=None`` fits a cross-validated scaling (the JAX package's
    ``test_kde_default_is_cv_scaled``), its bootstrap on ``device``."""
    from pyabc_tpu_torch.visualization.kde import _default_kde

    kde = _default_kde("cpu")
    assert isinstance(kde, GridSearchCV)
    assert len(kde.param_grid["scaling"]) > 1
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.normal(-2, 0.3, 150),
                           rng.normal(2, 0.3, 150)]).astype(np.float32)
    df = pd.DataFrame({"p": vals})
    w = np.ones(len(vals), dtype=np.float32) / len(vals)
    grid, dens = viz.kde_1d(df, w, "p", device="cpu")
    ref = _default_kde("cpu")
    ref.fit(vals[:, None], w)
    assert ref.best_params_ is not None
    x = torch.as_tensor(grid[:, None].astype(np.float32))
    dens_ref = ref.pdf(x).numpy()
    np.testing.assert_allclose(dens, dens_ref, rtol=1e-4)
    assert np.all(np.isfinite(dens)) and np.all(dens >= 0)
    if ref.best_params_["scaling"] != 1.0:
        tr1 = MultivariateNormalTransition(scaling=1.0)
        tr1.fit(vals[:, None], w)
        dens1 = tr1.pdf(x).numpy()
        assert not np.allclose(dens, dens1, rtol=1e-3)


# ---- statistics and trajectories ------------------------------------------


def test_quantiles_and_credible_intervals(histories):
    jh, ph = histories
    for t in range(3):
        df, w = ph.get_distribution(m=0, t=t)
        vals = df["mu"].to_numpy()
        for alpha in (0.05, 0.5, 0.975):
            assert viz.compute_quantile(vals, w, alpha) == pytest.approx(
                jviz.compute_quantile(vals, w, alpha), abs=TOL)
        for conf in (0.5, 0.95):
            np.testing.assert_allclose(
                viz.compute_credible_interval(vals, w, conf),
                jviz.compute_credible_interval(vals, w, conf), atol=TOL)


#: every run-level plot, with its arguments (H: the History)
PLOTS = {
    "epsilons": lambda v, H: v.plot_epsilons(H),
    "epsilons_lin": lambda v, H: v.plot_epsilons([H], labels=["r"],
                                                 scale="lin"),
    "sample_numbers": lambda v, H: v.plot_sample_numbers(H),
    "total_sample_numbers": lambda v, H: v.plot_total_sample_numbers([H]),
    "sample_numbers_trajectory":
        lambda v, H: v.plot_sample_numbers_trajectory(H),
    "acceptance_rates_trajectory":
        lambda v, H: v.plot_acceptance_rates_trajectory(H),
    "model_probabilities": lambda v, H: v.plot_model_probabilities(H),
    "effective_sample_sizes": lambda v, H: v.plot_effective_sample_sizes(H),
    "credible_intervals": lambda v, H: v.plot_credible_intervals(
        H, m=0, levels=(0.5, 0.95)),
    "credible_intervals_for_time": lambda v, H:
        v.plot_credible_intervals_for_time(
            [H, H], ts=[1, 2], levels=(0.5, 0.95), show_mean=True,
            refvals={"mu": 0.5}),
    "histogram_1d": lambda v, H: v.plot_histogram_1d(H, "mu", t=2,
                                                     bins=20),
    "histogram_matrix": lambda v, H: v.plot_histogram_matrix(H, m=1,
                                                             bins=10),
    "data_callback": lambda v, H: v.plot_data_callback(
        H, f_plot=lambda s, w, ax: ax.plot(
            np.ravel(next(iter(s.values()))), [w], "o"), n=20),
}


@pytest.mark.parametrize("name", sorted(PLOTS))
def test_plot_data_equals_the_jax_package(histories, name):
    jh, ph = histories
    got = _figure_data(PLOTS[name](viz, ph))
    ref = _figure_data(PLOTS[name](jviz, jh))
    assert any(len(x) for x in got)
    _assert_close(got, ref, 0.0, TOL)


def test_plots_of_arrays_and_helpers_equal_the_jax_package():
    df, w = _sample2d()
    rng = np.random.default_rng(3)
    obs = {"y": rng.normal(size=8), "xy": rng.normal(size=(2, 5))}
    sim = {"y": rng.normal(size=8), "xy": rng.normal(size=(2, 5))}
    for draw in (
            lambda v: v.plot_histogram_2d(df, w, "a", "b", bins=12),
            lambda v: v.plot_histogram_1d_lowlevel(df["a"], w, bins=15),
            lambda v: v.plot_histogram_matrix_lowlevel(df, w, bins=8),
            lambda v: v.plot_data_default(obs, sim)):
        _assert_close(_figure_data(draw(viz)), _figure_data(draw(jviz)),
                      0.0, TOL)
    assert viz.to_lists_or_default("h1") == jviz.to_lists_or_default("h1")
    assert viz.__all__ == jviz.__all__


def test_highlevel_kde_plots_render(histories):
    _, ph = histories
    for axes in (viz.plot_kde_1d_highlevel(ph, "mu", m=0, t=2,
                                           device="cpu"),
                 viz.plot_kde_matrix_highlevel(ph, m=1, device="cpu")):
        fig = np.ravel(np.asarray(axes, dtype=object))[0].figure
        fig.canvas.draw()
        plt.close(fig)


def test_the_package_imports_lazily():
    assert pt.visualization is viz
    import pyabc_tpu_torch.visserver as vs
    assert pt.visserver is vs
