"""Distance base contract (port of ``pyabc_tpu/distance/base.py``; the
adaptive lifecycle — ``configure_sampler``/``update`` — comes with the
adaptive distances).

A distance splits into host lifecycle state and a pure batched kernel:

- ``get_params(t)`` -> dict of host arrays, moved to the run's device once
  per generation by the sampler;
- ``compute(stats[N, S], obs[S], params) -> [N]`` on tensors.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from ..sumstat import SumStatSpec


class Distance:
    """Abstract distance over flattened summary statistics."""

    def __init__(self):
        self.spec: Optional[SumStatSpec] = None

    def bind(self, spec: SumStatSpec, x_0: Optional[Mapping] = None):
        """Bind the sum-stat layout before any sampling."""
        self.spec = spec
        self._on_bind(x_0)

    def _on_bind(self, x_0):
        pass

    def initialize(self, t: int, get_sample_stats: Optional[Callable],
                   x_0: Mapping, spec: SumStatSpec):
        if self.spec is None or spec is not self.spec:
            self.bind(spec, x_0)

    def get_params(self, t: int) -> dict:
        return {}

    def compute(self, stats: torch.Tensor, obs: torch.Tensor,
                params) -> torch.Tensor:
        raise NotImplementedError

    def get_config(self) -> dict:
        return {"name": type(self).__name__}

    def to_json(self) -> str:
        import json
        return json.dumps(self.get_config())
