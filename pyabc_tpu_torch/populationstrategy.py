"""Population-size strategies (port of ``ConstantPopulationSize`` from
``pyabc_tpu/populationstrategy.py``; list and adaptive sizes come later)."""

from __future__ import annotations

from typing import Optional


class PopulationStrategy:
    """Base: a fixed number of particles per generation."""

    def __init__(self, nr_particles: int, nr_samples_per_parameter: int = 1):
        if int(nr_samples_per_parameter) != 1:
            raise ValueError("only one simulation per parameter is ported")
        self.nr_particles = int(nr_particles)
        self.nr_samples_per_parameter = 1

    def update(self, transitions, model_weights, t: Optional[int] = None):
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
