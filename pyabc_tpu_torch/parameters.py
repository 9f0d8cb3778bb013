"""Parameter handling: named parameter spaces over dense tensors.

Port of ``pyabc_tpu/parameters.py``.  A whole population's parameters are
one dense float32 ``[N, D]`` tensor; :class:`ParameterSpace` is the fixed,
ordered name -> column map resolved once at setup, and :class:`Parameter`
a dict view of one particle for user-facing scalar access.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np


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

    def array_to_dict(self, row) -> Parameter:
        """Unpack a ``[dim]`` row into a :class:`Parameter`."""
        row = np.asarray(row)
        return Parameter({n: float(row[i]) for i, n in enumerate(self.names)})
