"""Batch autotuning and the program ladder: the per-generation tuner, the
joint (K, max_T, rung) occupancy tuner, the bounded LRU of built engine
programs with its build accounting, and the kernel build cache's
location (the JAX package's ahead-of-time guard has no counterpart in an
eager port)."""

from .cache import COMPILE_CACHE_ENV, configure_compile_cache
from .ladder import (CompiledLadder, compile_counters, compile_delta,
                     install_compile_listener, record_build)
from .occupancy import JOINT_AUTOTUNE_ENV, OccupancyTuner
from .tuner import EWMA_ALPHA, BatchAutotuner

__all__ = ["BatchAutotuner", "COMPILE_CACHE_ENV", "CompiledLadder",
           "EWMA_ALPHA", "JOINT_AUTOTUNE_ENV", "OccupancyTuner",
           "compile_counters", "compile_delta", "configure_compile_cache",
           "install_compile_listener", "record_build"]
