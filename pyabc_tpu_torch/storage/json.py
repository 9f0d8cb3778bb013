"""Side-channel JSON logs of adaptive-component trajectories.

Port of ``pyabc_tpu/storage/json.py``: ``save_dict_to_json`` writes e.g.
an adaptive distance's per-generation weights ``{t: w[S]}`` beside the
database (atomically, through a temporary file); ``load_dict_from_json``
reads it back with integer keys.
"""

from __future__ import annotations

import json
import numbers
import os


def _sanitize(obj):
    if isinstance(obj, dict):
        return {str(k): _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if isinstance(obj, numbers.Number):
        return float(obj)
    if hasattr(obj, "tolist"):
        return _sanitize(obj.tolist())
    return obj


def save_dict_to_json(dct: dict, log_file: str):
    tmp = f"{log_file}.tmp"
    with open(tmp, "w") as f:
        json.dump(_sanitize(dct), f)
    os.replace(tmp, log_file)


def load_dict_from_json(log_file: str, key_type=int) -> dict:
    with open(log_file) as f:
        raw = json.load(f)
    try:
        return {key_type(k): v for k, v in raw.items()}
    except (ValueError, TypeError):
        return raw
