"""Visualization (port of ``pyabc_tpu/visualization/``): matplotlib
plots of a run's History.  matplotlib and pandas are imported inside
the functions, so the package imports without them.  Every KDE density
is evaluated on ``device`` (the card unless the caller passes
``device="cpu"``), through the weighted-KDE kernel."""

from .kde import (
    kde_1d,
    kde_2d,
    plot_kde_1d,
    plot_kde_1d_highlevel,
    plot_kde_2d,
    plot_kde_2d_highlevel,
    plot_kde_matrix,
    plot_kde_matrix_highlevel,
)
from .run_plots import (
    compute_credible_interval,
    compute_kde_max,
    compute_quantile,
    plot_acceptance_rates_trajectory,
    plot_credible_intervals,
    plot_credible_intervals_for_time,
    plot_data_callback,
    plot_data_callback_lowlevel,
    plot_data_default,
    plot_effective_sample_sizes,
    plot_epsilons,
    plot_histogram_1d,
    plot_histogram_1d_lowlevel,
    plot_histogram_2d,
    plot_histogram_2d_lowlevel,
    plot_histogram_matrix,
    plot_histogram_matrix_lowlevel,
    plot_model_probabilities,
    plot_sample_numbers,
    plot_sample_numbers_trajectory,
    plot_total_sample_numbers,
)
from .util import format_plot_matrix, to_lists_or_default

__all__ = [
    "kde_1d", "kde_2d", "plot_kde_1d", "plot_kde_2d", "plot_kde_matrix",
    "plot_kde_1d_highlevel", "plot_kde_2d_highlevel",
    "plot_kde_matrix_highlevel",
    "plot_epsilons", "plot_sample_numbers", "plot_total_sample_numbers",
    "plot_sample_numbers_trajectory",
    "plot_acceptance_rates_trajectory", "plot_model_probabilities",
    "plot_effective_sample_sizes", "plot_credible_intervals",
    "plot_credible_intervals_for_time",
    "compute_credible_interval", "compute_quantile", "compute_kde_max",
    "plot_histogram_1d", "plot_histogram_2d", "plot_histogram_matrix",
    "plot_histogram_1d_lowlevel", "plot_histogram_2d_lowlevel",
    "plot_histogram_matrix_lowlevel",
    "plot_data_callback", "plot_data_callback_lowlevel", "plot_data_default",
    "format_plot_matrix", "to_lists_or_default",
]
