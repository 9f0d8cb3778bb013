"""Hyperparameter search for transitions (port of
``pyabc_tpu/transition/model_selection.py``): an exhaustive grid over
the base transition's constructor arguments, each point scored by the
bootstrap :meth:`~pyabc_tpu_torch.transition.Transition.mean_cv` of its
fit, the lowest kept.  The bootstrap draws come from one
``torch.Generator`` seeded from ``seed`` on ``device`` (the run's when an
``ABCSMC`` owns it, else the card unless the caller asks for the CPU)."""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence

from ..device import make_generator, resolve_device
from .base import Transition


class GridSearchCV(Transition):
    """Fit every grid point, keep the one with the lowest mean CV."""

    def __init__(self, base: Optional[Transition] = None,
                 param_grid: Optional[Dict[str, Sequence]] = None,
                 n_bootstrap: int = 3, seed: int = 0, device=None):
        super().__init__()
        if base is None:
            from .multivariatenormal import MultivariateNormalTransition
            base = MultivariateNormalTransition()
        if param_grid is None:
            param_grid = {"scaling": [0.25, 0.5, 1.0, 2.0]}
        self.base = base
        self.param_grid = dict(param_grid)
        self.n_bootstrap = int(n_bootstrap)
        self.seed = seed
        #: where the bootstrap runs (None: the owning run's device, or
        #: the card)
        self.device = device
        self.best_params_: Optional[dict] = None
        self.best_estimator_: Optional[Transition] = None

    def _fit(self, theta, w):
        generator = make_generator(resolve_device(self.device), self.seed)
        names = list(self.param_grid)
        best_cv, best = float("inf"), None
        for combo in itertools.product(*(self.param_grid[n] for n in names)):
            params = dict(zip(names, combo))
            cand = type(self.base)(**{**self._base_kwargs(), **params})
            cand.fit(theta, w)
            cv = cand.mean_cv(generator, n_bootstrap=self.n_bootstrap)
            if cv < best_cv:
                best_cv, best, self.best_params_ = cv, cand, params
        self.best_estimator_ = best

    def _base_kwargs(self) -> dict:
        return {k: v for k, v in self.base.__dict__.items()
                if k not in ("theta", "w", "_fitted")
                and not k.startswith("_")}

    @property
    def device_support_ok(self) -> bool:
        return getattr(self.best_estimator_ or self.base,
                       "device_support_ok", False)

    def get_params(self):
        return self.best_estimator_.get_params()

    def pad_params(self, params, n_pad):
        return (self.best_estimator_ or self.base).pad_params(params, n_pad)

    def rvs(self, generator, size=None):
        self._check_fitted()
        return self.best_estimator_.rvs(generator, size)

    def log_pdf(self, x):
        self._check_fitted()
        return self.best_estimator_.log_pdf(x)

    def static_fns(self):
        # the grid varies hyperparameters, not the estimator class
        cls = type(self.base)
        return (cls.rvs_from_params, cls.log_pdf_from_params)
