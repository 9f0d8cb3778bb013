"""Distributed helpers (port of ``pyabc_tpu/parallel/``): the particle
mesh over ``torch.distributed`` (:mod:`.mesh`), worker heartbeats,
liveness and the clean-stop sentinel over a shared run directory
(:mod:`.health`), and the worker/manager CLI (``python -m
pyabc_tpu_torch.parallel.cli``)."""

from . import health
from .health import (
    RUN_DIR_ENV,
    STOP_SENTINEL,
    Heartbeat,
    clear_stop,
    healthy,
    request_stop,
    reset_workers,
    run_dir,
    stop_requested,
    worker_status,
)
from .mesh import (
    PARTICLE_AXIS,
    initialize_distributed,
    make_mesh,
    particle_sharding,
    replicated,
)

__all__ = ["PARTICLE_AXIS", "make_mesh", "particle_sharding", "replicated",
           "initialize_distributed", "health", "Heartbeat", "healthy",
           "worker_status", "stop_requested", "request_stop", "clear_stop",
           "reset_workers", "run_dir", "RUN_DIR_ENV", "STOP_SENTINEL"]
