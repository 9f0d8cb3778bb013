"""Epsilon base contract (port of ``pyabc_tpu/epsilon/base.py``).

Epsilons are control plane: they run once per generation on the host and
emit one scalar that the acceptor hands to the candidate rounds.
"""

from __future__ import annotations

from typing import Callable, Optional


class Epsilon:
    """Acceptance-threshold schedule: ``initialize`` with calibration
    distances, ``update`` each generation, ``__call__(t) -> float``."""

    def initialize(self, t: int,
                   get_weighted_distances: Optional[Callable] = None,
                   get_all_records: Optional[Callable] = None,
                   max_nr_populations: Optional[int] = None,
                   acceptor_config: Optional[dict] = None):
        pass

    def update(self, t: int,
               get_weighted_distances: Optional[Callable] = None,
               get_all_records: Optional[Callable] = None,
               acceptance_rate: Optional[float] = None,
               acceptor_config: Optional[dict] = None):
        pass

    def __call__(self, t: int) -> float:
        raise NotImplementedError

    def get_config(self) -> dict:
        return {"name": type(self).__name__}

    def to_json(self) -> str:
        import json
        return json.dumps(self.get_config())
