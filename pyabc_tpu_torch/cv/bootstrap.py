"""Bootstrap CV of fitted transitions across models (port of
``pyabc_tpu/cv/bootstrap.py``): the model-weighted mean of each model's
:meth:`~pyabc_tpu_torch.transition.Transition.mean_cv` at its share of
``n_samples`` rows.  Used by ``AdaptivePopulationSize``."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def calc_cv(n_samples: int, model_weights, transitions: List,
            n_bootstrap: int, test_points_per_model: List,
            generator: torch.Generator) -> Tuple[float, list]:
    """``(Σ_m w_m · cv_m, [cv_m])`` with ``cv_m`` the bootstrap CV of the
    fitted ``transitions[m]`` from ``max(round(w_m · n_samples), 2)``
    rows at ``test_points_per_model[m]``, drawn from ``generator`` (its
    device runs the densities)."""
    model_weights = np.asarray(model_weights, dtype=np.float64)
    model_weights = model_weights / model_weights.sum()
    cvs = []
    for m, trans in enumerate(transitions):
        n_m = max(int(round(float(model_weights[m]) * n_samples)), 2)
        cvs.append(trans.mean_cv(generator, n_samples=n_m,
                                 n_bootstrap=n_bootstrap,
                                 test_points=test_points_per_model[m]))
    total = float(np.sum(model_weights * np.asarray(cvs)))
    return total, [float(c) for c in cvs]
