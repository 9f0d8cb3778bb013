"""Distributed helpers (port of ``pyabc_tpu/parallel/``): worker
heartbeats, liveness and the clean-stop sentinel over a shared run
directory.  The device mesh and the worker/manager CLI are not ported
yet."""

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

__all__ = ["health", "Heartbeat", "healthy", "worker_status",
           "stop_requested", "request_stop", "clear_stop", "reset_workers",
           "run_dir", "RUN_DIR_ENV", "STOP_SENTINEL"]
