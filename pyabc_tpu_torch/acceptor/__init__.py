"""Acceptors (port of ``pyabc_tpu/acceptor``; uniform only in this
slice)."""

from .acceptor import Acceptor, UniformAcceptor

__all__ = ["Acceptor", "UniformAcceptor"]
