"""Small SGE helpers (parity: pyabc/sge/util.py)."""

from .sge import SGE


def sge_available() -> bool:
    return SGE.sge_available()
