"""Batch autotuning and the program ladder: the per-generation tuner, the
joint (K, max_T, rung) occupancy tuner, the bounded LRU of built engine
programs with its build accounting, the kernel build cache's location,
and the ahead-of-time surface — ``jit_compile``, ``aot_compile``,
``AotGuard``, ``aval_of``, ``avals_like`` — as CUDA-graph capture: on the
card a round of the rejection loop and its finalize replay as captured
graphs (``sampler/device_loop.py``)."""

from .cache import COMPILE_CACHE_ENV, configure_compile_cache
from .ladder import (AotGuard, CaptureRefused, CompiledLadder, TensorSpec,
                     aot_compile, aval_of, avals_like, check_capturable,
                     compile_counters, compile_delta,
                     install_compile_listener, jit_compile,
                     note_uncapturable, record_build,
                     register_launch_counter)
from .occupancy import JOINT_AUTOTUNE_ENV, OccupancyTuner
from .tuner import EWMA_ALPHA, BatchAutotuner

__all__ = ["AotGuard", "BatchAutotuner", "COMPILE_CACHE_ENV",
           "CaptureRefused", "CompiledLadder", "EWMA_ALPHA",
           "JOINT_AUTOTUNE_ENV", "OccupancyTuner", "TensorSpec",
           "aot_compile", "aval_of", "avals_like", "check_capturable",
           "compile_counters", "compile_delta", "configure_compile_cache",
           "install_compile_listener", "jit_compile", "note_uncapturable",
           "record_build", "register_launch_counter"]
