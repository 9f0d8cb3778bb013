"""Run storage (port of ``pyabc_tpu/storage``: the sqlite History and the
JSON side-channel logs)."""

from .history import PRE_TIME, History
from .json import load_dict_from_json, save_dict_to_json

__all__ = ["History", "PRE_TIME", "save_dict_to_json",
           "load_dict_from_json"]
