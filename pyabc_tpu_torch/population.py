"""Population: struct-of-arrays particle container.

Port of ``pyabc_tpu/population.py``.  A population handed to the control
plane (transition fits, epsilon, History) is host numpy:

    m:         int32[N]    model index per particle
    theta:     float32[N, D]  parameters (padded to the max model dimension)
    weight:    float32[N]  importance weight
    distance:  float32[N]  accepted distance
    sum_stats: {"__flat__": float32[N, S]} (optional)

Model probabilities are each model's weight share (reference
population.py:123-145).  :class:`Particle` is the reference's
per-particle view, built only on request (``Population.to_particles``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class Particle:
    """One particle, the reference's view of a population row."""

    def __init__(self, m: int, parameter: dict, weight: float,
                 accepted_sum_stats=None, accepted_distances=None,
                 rejected_sum_stats=None, rejected_distances=None,
                 accepted: bool = True):
        self.m = int(m)
        self.parameter = parameter
        self.weight = float(weight)
        self.accepted_sum_stats = accepted_sum_stats or []
        self.accepted_distances = accepted_distances or []
        self.rejected_sum_stats = rejected_sum_stats or []
        self.rejected_distances = rejected_distances or []
        self.accepted = bool(accepted)

    def __repr__(self):
        return (f"Particle(m={self.m}, parameter={self.parameter}, "
                f"weight={self.weight:.3g}, accepted={self.accepted})")


class Population:
    """Dense weighted particle population (host arrays)."""

    def __init__(self, m, theta, weight, distance,
                 sum_stats: Optional[Dict[str, np.ndarray]] = None):
        self.m = m
        self.theta = theta
        self.weight = weight
        self.distance = distance
        self.sum_stats = sum_stats if sum_stats is not None else {}

    def __len__(self):
        return int(self.m.shape[0])

    def get_list(self) -> list:
        """One dict per particle: ``m``, ``parameter`` (its theta row),
        ``weight``, ``distance``."""
        m, theta = np.asarray(self.m), np.asarray(self.theta)
        w, d = np.asarray(self.weight), np.asarray(self.distance)
        return [{"m": int(m[i]), "parameter": theta[i],
                 "weight": float(w[i]), "distance": float(d[i])}
                for i in range(len(m))]

    def to_particles(self, param_names=None) -> list:
        """One :class:`Particle` per row, its parameters named by
        ``param_names`` (default ``p0``, ``p1``, ...)."""
        m, theta = np.asarray(self.m), np.asarray(self.theta)
        w, d = np.asarray(self.weight), np.asarray(self.distance)
        names = param_names or [f"p{i}" for i in range(theta.shape[1])]
        return [Particle(m=int(m[i]),
                         parameter={k: float(theta[i, j])
                                    for j, k in enumerate(names)},
                         weight=float(w[i]),
                         accepted_distances=[float(d[i])])
                for i in range(len(m))]

    def get_model_probabilities(self, nr_models: Optional[int] = None
                                ) -> np.ndarray:
        nr = (nr_models if nr_models is not None
              else int(np.max(self.m)) + 1)
        totals = np.bincount(self.m, weights=self.weight, minlength=nr)
        return totals / totals.sum()

    def get_alive_models(self):
        probs = self.get_model_probabilities()
        return [int(m) for m in np.nonzero(probs > 0)[0]]

    def nr_of_models_alive(self) -> int:
        return len(self.get_alive_models())

    def normalized_weights(self) -> np.ndarray:
        """Weights normalized globally (Σ = 1)."""
        return self.weight / self.weight.sum()

    def get_weighted_distances(self):
        """(distances[N], normalized weights[N])."""
        return self.distance, self.normalized_weights()

    def __repr__(self):
        return (f"<Population n={len(self)} dim={self.theta.shape[-1]} "
                f"models={int(np.max(self.m)) + 1 if len(self) else 0}>")
