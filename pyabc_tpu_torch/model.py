"""Models: batched stochastic forward simulators.

Port of ``Model``, ``SimpleModel``, ``ModelResult`` and
``IntegratedModel`` from ``pyabc_tpu/model.py``.  A
model is a batched function

    sample_fn(generator, theta[N, D]) -> {stat_name: tensor[N, ...]}

called once per candidate round on the whole batch; ``generator`` is the
run's ``torch.Generator`` and ``theta`` lies on its device.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional

import torch

from .device import device_of, resolve_device


class ModelResult:
    """What a model hands the round: summary statistics and, for an
    :class:`IntegratedModel`, the candidates it rejected early."""

    def __init__(self, sum_stats=None, distance=None, accepted=None,
                 weight=None, early_reject=None):
        self.sum_stats = sum_stats
        self.distance = distance
        self.accepted = accepted
        self.weight = weight
        self.early_reject = early_reject


class Model:
    """A stochastic forward model over batches of parameters."""

    #: set True (with :meth:`low_fidelity`) to declare that the
    #: low-fidelity variant emits the same summary-statistic layout (keys
    #: and shapes) as the full model, so one distance and one observed
    #: layout serve both stages of the fidelity cascade
    screen_stats_compatible: bool = False

    def __init__(self, name: str = "model"):
        self.name = name

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"

    def sample(self, generator: torch.Generator, theta: torch.Tensor):
        """Raw model output for ``theta[N, D]``."""
        raise NotImplementedError

    def low_fidelity(self) -> Optional["Model"]:
        """A cheap surrogate of this model for the fidelity cascade's
        screen (coarser steps, a shorter horizon), or None — the default,
        which keeps a ``fidelity="screen"`` run on the exact unscreened
        path.  The surrogate's statistics must have the full model's
        layout (declare ``screen_stats_compatible``); their values need
        only correlate with the full model's: the calibrator measures the
        correlation every generation and disables the screen when it is
        weak."""
        return None

    def summary_statistics(self, raw) -> Dict[str, torch.Tensor]:
        """Reduce raw output to summary statistics (identity for dicts)."""
        if isinstance(raw, Mapping):
            return dict(raw)
        return {"y": raw}

    def simulate(self, generator: torch.Generator,
                 theta: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.summary_statistics(self.sample(generator, theta))

    def accept(self, generator: torch.Generator, theta, distance_fn, eps,
               acceptor, x_0, device=None) -> ModelResult:
        """One batch through the reference's accept chain (simulate,
        ``distance_fn(stats, x_0)``, ``acceptor.accept``), eagerly — for
        the reference's interface and tests; the sampler's rounds run
        the same chain on whole batches.  ``theta`` and ε go to
        ``device`` (default: the generator's), where the generator draws
        the simulation and then the acceptor's uniforms."""
        dev = (device_of(generator) if device is None
               else resolve_device(device))
        theta = torch.as_tensor(theta, dtype=torch.float32, device=dev)
        stats = self.simulate(generator, theta)
        d = distance_fn(stats, x_0)
        acc, w = acceptor.accept(
            generator, d,
            {"eps": torch.tensor(float(eps), dtype=torch.float32,
                                 device=dev)})
        return ModelResult(sum_stats=stats, distance=d, accepted=acc,
                           weight=w)


class SimpleModel(Model):
    """Wrap a batched ``sample_fn(generator, theta[N, D]) -> dict``."""

    def __init__(self, fn: Callable, name: Optional[str] = None):
        super().__init__(name or getattr(fn, "__name__", "model"))
        self._fn = fn

    def sample(self, generator, theta):
        return self._fn(generator, theta)

    @staticmethod
    def assert_model(maybe_model) -> "Model":
        """Coerce callables to models."""
        if isinstance(maybe_model, Model):
            return maybe_model
        return SimpleModel(maybe_model)


class IntegratedModel(Model):
    """Simulation fused with an early reject: the round passes its
    epsilon (``eps``: a 0-d tensor, or inf at calibration and for a plain
    ``simulate``), and the model returns a :class:`ModelResult` whose
    ``early_reject[N]`` (bool, or None) marks candidates that cannot be
    accepted; the round does not accept them whatever their distance."""

    def integrated_simulate(self, generator: torch.Generator,
                            theta: torch.Tensor, eps) -> ModelResult:
        raise NotImplementedError

    def simulate(self, generator, theta):
        return self.integrated_simulate(generator, theta,
                                        math.inf).sum_stats
