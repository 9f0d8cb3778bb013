"""Run storage (port of ``pyabc_tpu/storage``: the sqlite History)."""

from .history import PRE_TIME, History

__all__ = ["History", "PRE_TIME"]
