"""Acceptors (port of ``Acceptor`` and ``UniformAcceptor`` from
``pyabc_tpu/acceptor/acceptor.py``).

Host lifecycle (``initialize`` / ``update`` / ``get_params``) plus a pure
batched kernel ``accept(generator, distance, params) -> (accept[N],
weight[N])`` on tensors.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


class Acceptor:
    """Abstract acceptor."""

    def initialize(self, t: int, get_weighted_distances: Optional[Callable],
                   distance_function=None, x_0=None):
        pass

    def update(self, t: int, get_weighted_distances: Optional[Callable] = None,
               prev_temperature: Optional[float] = None,
               acceptance_rate: Optional[float] = None):
        pass

    def get_epsilon_config(self, t: int) -> dict:
        return {}

    def get_params(self, t: int, epsilon) -> dict:
        """Host params for :meth:`accept` (float32 scalars)."""
        return {"eps": np.float32(epsilon(t))}

    def accept(self, generator: torch.Generator, distance: torch.Tensor,
               params: dict):
        raise NotImplementedError

    def get_config(self):
        return {"name": type(self).__name__}


class UniformAcceptor(Acceptor):
    """Accept iff distance ≤ ε; with ``use_complete_history`` against the
    smallest ε so far."""

    def __init__(self, use_complete_history: bool = False):
        self.use_complete_history = use_complete_history
        self._eps_history: dict = {}

    def get_params(self, t: int, epsilon) -> dict:
        eps = float(epsilon(t))
        self._eps_history[t] = eps
        if self.use_complete_history:
            eps = min(v for s, v in self._eps_history.items() if s <= t)
        return {"eps": np.float32(eps)}

    def accept(self, generator, distance, params):
        acc = distance <= params["eps"]
        return acc, torch.ones_like(distance)
