"""Elastic fleet scheduling: the control plane over the serving tier
(port of ``pyabc_tpu/sched/``; host code, copied).

- :mod:`pyabc_tpu_torch.sched.scheduler` — the reconciliation loop
  (``python -m pyabc_tpu_torch.sched.scheduler``): joins worker
  heartbeats (``parallel/health.py``) to claim leases
  (``serve/queue.py``), requeues dead workers' tickets with bounce
  accounting, quarantines poison tickets with a flight dump, sweeps
  expired tombstones, and publishes ``sched_*`` telemetry;
- :mod:`pyabc_tpu_torch.sched.autoscale` — hysteresis-filtered desired-
  replica targeting from queue depth and aging pressure;
- :mod:`pyabc_tpu_torch.sched.platform` — the actuator behind the
  target: worker platform drivers (``--platform subprocess``) that
  start/stop/restart serve workers to match it.

All scheduler knobs are environment variables (the JAX package's names).
"""

from .autoscale import Autoscaler
from .platform import SubprocessPlatform, WorkerPlatform
from .scheduler import Scheduler

__all__ = ["Autoscaler", "Scheduler", "SubprocessPlatform",
           "WorkerPlatform"]
