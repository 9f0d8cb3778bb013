"""Batch autotuning: the per-generation tuner and the joint (K, max_T,
rung) occupancy tuner (the compiled ladder and its ahead-of-time guard
have no counterpart in an eager port)."""

from .occupancy import JOINT_AUTOTUNE_ENV, OccupancyTuner
from .tuner import EWMA_ALPHA, BatchAutotuner

__all__ = ["BatchAutotuner", "EWMA_ALPHA", "JOINT_AUTOTUNE_ENV",
           "OccupancyTuner"]
