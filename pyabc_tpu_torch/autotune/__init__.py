"""Batch autotuning (the tuner only; the compiled ladder and its
ahead-of-time guard have no counterpart in an eager port)."""

from .tuner import EWMA_ALPHA, BatchAutotuner

__all__ = ["BatchAutotuner", "EWMA_ALPHA"]
