"""Tagged bytes (de)serialization for observed summary statistics.

Port of ``pyabc_tpu/storage/bytes_storage.py`` as far as the History of
this slice needs it: numeric arrays, tensors and scalars as plain
``.npy`` (``allow_pickle=False``), plain Python values as JSON.  Other
types (DataFrames, arbitrary objects) are refused rather than pickled;
they come later.
"""

from __future__ import annotations

import io
import json
from typing import Any, Tuple

import numpy as np

TAG_NPY = "npy"
TAG_JSON = "json"


def to_bytes(obj: Any) -> Tuple[str, bytes]:
    """Serialize ``obj`` to a ``(tag, blob)`` pair."""
    if hasattr(obj, "detach"):  # a torch tensor
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, (np.ndarray, np.generic)) and \
            np.asarray(obj).dtype != object:
        buf = io.BytesIO()
        np.save(buf, np.asarray(obj), allow_pickle=False)
        return TAG_NPY, buf.getvalue()
    if isinstance(obj, (bool, int, float, str)) or obj is None:
        return TAG_JSON, json.dumps(obj).encode()
    if isinstance(obj, (list, tuple, dict)):
        return TAG_JSON, json.dumps(obj).encode()
    raise TypeError(f"cannot store an observed value of type {type(obj)}")


def from_bytes(tag: str, blob: bytes) -> Any:
    """Inverse of :func:`to_bytes`; a 0-d array decodes to its scalar."""
    if tag == TAG_NPY:
        arr = np.load(io.BytesIO(blob), allow_pickle=False)
        return arr[()] if arr.ndim == 0 else arr
    if tag == TAG_JSON:
        return json.loads(blob.decode())
    raise ValueError(f"unknown storage tag {tag!r}")
