"""Population-size strategies (port of ``pyabc_tpu/populationstrategy.py``):
a constant size, a per-generation list, and the adaptive size that
targets a coefficient of variation of the fitted proposal densities.

``AdaptivePopulationSize`` estimates the bootstrap CV of the fitted
transitions at three sizes around the current one
(:func:`~pyabc_tpu_torch.cv.calc_cv`), fits ``cv(n) = a·n^b`` and inverts
it at the target.  Its bootstrap draws come from its own
``torch.Generator`` (seeded from ``seed``) on its ``device``: the run's
device when an ``ABCSMC`` owns it, else the card unless the caller asks
for the CPU.  The density of every bootstrap refit runs there.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .cv.bootstrap import calc_cv
from .device import make_generator, resolve_device


class PopulationStrategy:
    """Base: a fixed number of particles per generation."""

    def __init__(self, nr_particles: int, nr_samples_per_parameter: int = 1):
        if int(nr_samples_per_parameter) != 1:
            raise ValueError("only one simulation per parameter is ported")
        self.nr_particles = int(nr_particles)
        self.nr_samples_per_parameter = 1

    def update(self, transitions: List, model_weights,
               t: Optional[int] = None,
               test_points_per_model: Optional[List] = None):
        pass

    def __call__(self, t: Optional[int] = None) -> int:
        return self.nr_particles

    def get_config(self) -> dict:
        return {"name": type(self).__name__, "nr_particles": self.nr_particles}

    def to_json(self) -> str:
        import json
        return json.dumps(self.get_config())


class ConstantPopulationSize(PopulationStrategy):
    """Fixed N."""


class ListPopulationSize(PopulationStrategy):
    """Per-generation sizes; past the list's end its last entry."""

    def __init__(self, values: List[int], nr_samples_per_parameter: int = 1):
        super().__init__(values[0], nr_samples_per_parameter)
        self.values = [int(v) for v in values]

    def __call__(self, t: Optional[int] = None) -> int:
        if t is None:
            return self.values[0]
        return self.values[min(t, len(self.values) - 1)]


class AdaptivePopulationSize(PopulationStrategy):
    """The size whose bootstrap KDE CV meets ``mean_cv``, quantized up to
    a power of two by default and clipped to ``[min_population_size,
    max_population_size]``."""

    def __init__(self, start_nr_particles: int,
                 mean_cv: float = 0.05,
                 max_population_size: int = 10**6,
                 min_population_size: int = 10,
                 n_bootstrap: int = 5,
                 quantize: bool = True,
                 seed: int = 0,
                 device=None):
        super().__init__(start_nr_particles)
        self.mean_cv = float(mean_cv)
        self.max_population_size = int(max_population_size)
        self.min_population_size = int(min_population_size)
        self.n_bootstrap = int(n_bootstrap)
        self.quantize = quantize
        self.seed = int(seed)
        #: where the bootstrap runs (None: the owning run's device, or
        #: the card)
        self.device = device
        self._generator = None
        #: one record per update: t, the size before and after, the alive
        #: models, the sizes tried with their CVs, and the bootstrap
        #: densities' ``(test rows, support rows, d)``, size by size
        self.updates = []

    def _gen(self):
        if self._generator is None:
            self._generator = make_generator(resolve_device(self.device),
                                             self.seed)
        return self._generator

    def update(self, transitions: List, model_weights, t=None,
               test_points_per_model: Optional[List] = None):
        """CVs at half, all and twice the current size (as far as the
        bounds allow), the power law through them, inverted at the
        target."""
        from .transition.predict_population_size import \
            predict_population_size

        if test_points_per_model is None:
            test_points_per_model = [tr.theta for tr in transitions]
        reference_nr = self.nr_particles
        sizes = sorted({
            int(max(reference_nr // 2, self.min_population_size, 8)),
            int(reference_nr),
            int(min(reference_nr * 2, self.max_population_size)),
        })
        cvs, shapes = {}, []
        record = {"t": t, "before": reference_nr, "alive": len(transitions),
                  "sizes": sizes, "cvs": cvs, "density_shapes": shapes}
        self.updates.append(record)
        for nn in sizes:
            cv_n, _ = calc_cv(nn, model_weights, transitions,
                              self.n_bootstrap, test_points_per_model,
                              self._gen())
            shapes.extend(tr.cv_density_shape for tr in transitions)
            if cv_n > 0:
                cvs[nn] = float(cv_n)
        record["after"] = reference_nr
        if not cvs:
            return
        n_req = predict_population_size(
            cvs, self.mean_cv, min_size=self.min_population_size,
            max_size=self.max_population_size, fallback=reference_nr)
        if self.quantize:
            n_req = 1 << int(np.ceil(np.log2(max(n_req, 2))))
            n_req = min(n_req, self.max_population_size)
        self.nr_particles = record["after"] = int(n_req)

    def get_config(self):
        return {"name": type(self).__name__,
                "max_population_size": self.max_population_size,
                "mean_cv": self.mean_cv}
