"""Tagged bytes (de)serialization for summary statistics and observed
data.

Port of ``pyabc_tpu/storage/bytes_storage.py``: each object serializes to
``(tag, bytes)`` and the tag picks the decoder on read, so a value one
package stored reads back in the other.  Numeric arrays, tensors and
numpy scalars as ``.npy`` (``allow_pickle=False``); DataFrames and
Series as parquet; raw bytes as themselves; plain Python values as JSON;
anything else, last, as a (cloud)pickle — only load databases you
trust.
"""

from __future__ import annotations

import io
import json
import pickle
from typing import Any, Tuple

import numpy as np
import pandas as pd

TAG_NPY = "npy"
TAG_DF = "df"
TAG_SERIES = "series"
TAG_JSON = "json"
TAG_BYTES = "bytes"
TAG_PICKLE = "pickle"


def _npy(arr) -> Tuple[str, bytes]:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr), allow_pickle=False)
    return TAG_NPY, buf.getvalue()


def to_bytes(obj: Any) -> Tuple[str, bytes]:
    """Serialize ``obj`` to a ``(tag, blob)`` pair."""
    if hasattr(obj, "detach"):  # a torch tensor
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, pd.DataFrame):
        buf = io.BytesIO()
        obj.to_parquet(buf)
        return TAG_DF, buf.getvalue()
    if isinstance(obj, pd.Series):
        buf = io.BytesIO()
        obj.to_frame(name=obj.name if obj.name is not None else "__series__"
                     ).to_parquet(buf)
        return TAG_SERIES, buf.getvalue()
    if isinstance(obj, (np.ndarray, np.generic)) and \
            not isinstance(obj, np.character) and \
            np.asarray(obj).dtype != object:
        # a numeric numpy scalar before the plain-scalar branch: np.float64
        # subclasses float, and .npy keeps its dtype
        return _npy(obj)
    if isinstance(obj, (bytes, bytearray)):
        return TAG_BYTES, bytes(obj)
    if isinstance(obj, (bool, int, float, str)) or obj is None:
        return TAG_JSON, json.dumps(obj).encode()
    try:
        arr = np.asarray(obj)
    except Exception:  # any array-like that numpy cannot take
        arr = None
    if arr is not None and arr.dtype != object:
        return _npy(arr)
    if isinstance(obj, (list, tuple, dict)):
        try:
            return TAG_JSON, json.dumps(obj).encode()
        except (TypeError, ValueError):
            pass
    try:  # cloudpickle handles locally defined classes
        import cloudpickle
        return TAG_PICKLE, cloudpickle.dumps(obj)
    except ImportError:
        return TAG_PICKLE, pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def from_bytes(tag: str, blob: bytes) -> Any:
    """Inverse of :func:`to_bytes`; a 0-d array decodes to its scalar."""
    if tag == TAG_NPY:
        arr = np.load(io.BytesIO(blob), allow_pickle=False)
        return arr[()] if arr.ndim == 0 else arr
    if tag == TAG_DF:
        return pd.read_parquet(io.BytesIO(blob))
    if tag == TAG_SERIES:
        s = pd.read_parquet(io.BytesIO(blob)).iloc[:, 0]
        if s.name == "__series__":
            s.name = None
        return s
    if tag == TAG_JSON:
        return json.loads(blob.decode())
    if tag == TAG_BYTES:
        return blob
    if tag == TAG_PICKLE:
        return pickle.loads(blob)
    raise ValueError(f"unknown storage tag {tag!r}")
