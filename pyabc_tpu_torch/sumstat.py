"""Summary statistics: named dicts <-> dense ``[N, S]`` blocks.

Port of ``pyabc_tpu/sumstat.py``.  Sum-stats of a batch live as a dict of
batched tensors ``{key: [N, ...]}`` and are flattened once, in sorted key
order, into one float32 ``[N, S]`` block for the distance.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch


class SumStatSpec:
    """Fixed (sorted) ordering and shapes of summary-statistic keys."""

    def __init__(self, shapes: Mapping[str, Tuple[int, ...]]):
        self.keys: tuple = tuple(sorted(shapes.keys()))
        self.shapes: Dict[str, Tuple[int, ...]] = {
            k: tuple(shapes[k]) for k in self.keys}
        self.sizes: Dict[str, int] = {
            k: int(np.prod(self.shapes[k], dtype=int)) for k in self.keys}
        offsets = np.cumsum([0] + [self.sizes[k] for k in self.keys])
        self.offsets: Dict[str, int] = {
            k: int(offsets[i]) for i, k in enumerate(self.keys)}
        self.total_size: int = int(offsets[-1])

    @classmethod
    def from_example(cls, x: Mapping, batched: bool = False
                     ) -> "SumStatSpec":
        """Infer the spec from one observed dict (or a batched dict)."""
        shapes = {}
        for k, v in x.items():
            shape = tuple(np.shape(v.cpu() if torch.is_tensor(v) else v))
            shapes[k] = shape[1:] if batched else shape
        return cls(shapes)

    def flatten(self, x: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """``{key: [N, ...]} -> float32 [N, S]``."""
        parts = []
        for k in self.keys:
            v = torch.as_tensor(x[k]).to(torch.float32)
            # explicit width: a block of 0 rows has no -1 to infer
            parts.append(v.reshape(v.shape[0], self.sizes[k]))
        return torch.cat(parts, dim=-1)

    def flatten_single(self, x0: Mapping, device=None) -> torch.Tensor:
        """``{key: [...]} -> float32 [S]`` for the observed data."""
        parts = [torch.as_tensor(np.asarray(x0[k], dtype=np.float32)
                                 if not torch.is_tensor(x0[k]) else x0[k],
                                 dtype=torch.float32,
                                 device=device).reshape(-1)
                 for k in self.keys]
        return torch.cat(parts, dim=-1)

    def unflatten(self, flat):
        """``[..., S] -> {key: [..., *shape]}`` (tensor or numpy)."""
        out = {}
        for k in self.keys:
            o, s = self.offsets[k], self.sizes[k]
            out[k] = flat[..., o:o + s].reshape(
                tuple(flat.shape[:-1]) + self.shapes[k])
        return out

    def expand_key_values(self, per_key: Mapping[str, float],
                          default: float = 1.0) -> np.ndarray:
        """Per-key scalars -> per-component ``float32 [S]`` vector."""
        vec = np.full(self.total_size, default, dtype=np.float32)
        for k, val in per_key.items():
            if k not in self.offsets:
                raise KeyError(f"unknown sum-stat key {k!r}; have {self.keys}")
            o, s = self.offsets[k], self.sizes[k]
            vec[o:o + s] = np.asarray(val, dtype=np.float32).reshape(-1)
        return vec

    def __repr__(self):
        return f"SumStatSpec({self.shapes})"
