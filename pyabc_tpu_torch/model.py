"""Models: batched stochastic forward simulators.

Port of ``Model`` and ``SimpleModel`` from ``pyabc_tpu/model.py``.  A
model is a batched function

    sample_fn(generator, theta[N, D]) -> {stat_name: tensor[N, ...]}

called once per candidate round on the whole batch; ``generator`` is the
run's ``torch.Generator`` and ``theta`` lies on its device.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch


class Model:
    """A stochastic forward model over batches of parameters."""

    def __init__(self, name: str = "model"):
        self.name = name

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"

    def sample(self, generator: torch.Generator, theta: torch.Tensor):
        """Raw model output for ``theta[N, D]``."""
        raise NotImplementedError

    def summary_statistics(self, raw) -> Dict[str, torch.Tensor]:
        """Reduce raw output to summary statistics (identity for dicts)."""
        if isinstance(raw, Mapping):
            return dict(raw)
        return {"y": raw}

    def simulate(self, generator: torch.Generator,
                 theta: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.summary_statistics(self.sample(generator, theta))


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
