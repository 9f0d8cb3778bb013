"""Parameter handling: named parameter spaces over dense tensors.

Port of ``pyabc_tpu/parameters.py``.  A whole population's parameters are
one dense float32 ``[N, D]`` tensor; :class:`ParameterSpace` is the fixed,
ordered name -> column map resolved once at setup, and :class:`Parameter`
a dict view of one particle for user-facing scalar access.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Sequence, Union

import numpy as np
import torch

from .device import resolve_device


def flatten_dict(dct: Mapping, sep: str = ".") -> dict:
    """Flatten a nested dict into one level, joining keys with ``sep``."""
    out = {}
    for key, value in dct.items():
        if isinstance(value, Mapping):
            for sub_key, sub_value in flatten_dict(value, sep).items():
                out[f"{key}{sep}{sub_key}"] = sub_value
        else:
            out[key] = value
    return out


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class Parameter(dict):
    """A single particle's parameters: dict with attribute access and
    arithmetic.  Nested dicts are flattened on construction."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        merged: dict = {}
        for arg in args:
            merged.update(arg if isinstance(arg, Mapping) else dict(arg))
        merged.update(kwargs)
        super().update(flatten_dict(merged))

    def __getattr__(self, item):
        try:
            return self[item]
        except KeyError as e:
            raise AttributeError(item) from e

    def __add__(self, other: "Parameter") -> "Parameter":
        return Parameter({key: self[key] + other[key] for key in self})

    def __sub__(self, other: "Parameter") -> "Parameter":
        return Parameter({key: self[key] - other[key] for key in self})

    def __repr__(self):
        return f"<Parameter {dict(self)}>"

    def copy(self) -> "Parameter":
        return Parameter(self)


class ParameterSpace:
    """Fixed, ordered mapping between parameter names and tensor columns."""

    def __init__(self, names: Sequence[str]):
        self.names: tuple = tuple(names)
        self._index: Dict[str, int] = {n: i for i, n in enumerate(self.names)}
        if len(self._index) != len(self.names):
            raise ValueError(f"duplicate parameter names: {names}")

    @property
    def dim(self) -> int:
        return len(self.names)

    def index(self, name: str) -> int:
        return self._index[name]

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def __len__(self) -> int:
        return len(self.names)

    def __iter__(self):
        return iter(self.names)

    def __eq__(self, other) -> bool:
        return isinstance(other, ParameterSpace) and self.names == other.names

    def __repr__(self):
        return f"ParameterSpace({list(self.names)})"

    def dict_to_array(self, par: Mapping[str, Union[float, np.ndarray]],
                      device=None) -> torch.Tensor:
        """Pack a name -> scalar dict into a float32 ``[dim]`` tensor (a
        row of theta) on ``device`` (default: the card)."""
        par = flatten_dict(par)
        return torch.as_tensor(
            np.asarray([par[name] for name in self.names], np.float32),
            device=resolve_device(device))

    def dicts_to_array(self, pars: Iterable[Mapping[str, float]],
                       device=None) -> torch.Tensor:
        """Pack an iterable of dicts into a float32 ``[N, dim]`` tensor on
        ``device`` (default: the card)."""
        rows = [[flatten_dict(p)[name] for name in self.names] for p in pars]
        return torch.as_tensor(np.asarray(rows, dtype=np.float32),
                               device=resolve_device(device))

    def array_to_dict(self, row) -> Parameter:
        """Unpack a ``[dim]`` row into a :class:`Parameter`."""
        row = _host(row)
        return Parameter({n: float(row[i]) for i, n in enumerate(self.names)})

    def array_to_dicts(self, theta) -> list:
        """Unpack ``[N, dim]`` into a list of :class:`Parameter`."""
        theta = _host(theta)
        return [Parameter({n: float(theta[j, i])
                           for i, n in enumerate(self.names)})
                for j in range(theta.shape[0])]

    def columns(self, theta) -> dict:
        """``[..., dim]`` as name -> ``[...]`` column views."""
        return {name: theta[..., i] for i, name in enumerate(self.names)}

    def pad_to(self, theta, dim: int):
        """Zero-pad the trailing parameter axis of ``theta`` (a tensor or
        an array) up to ``dim``."""
        d = theta.shape[-1]
        if d == dim:
            return theta
        if d > dim:
            raise ValueError(f"cannot pad dim {d} down to {dim}")
        if isinstance(theta, torch.Tensor):
            return torch.nn.functional.pad(theta, (0, dim - d))
        return np.pad(theta, [(0, 0)] * (theta.ndim - 1) + [(0, dim - d)])
