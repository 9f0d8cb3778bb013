"""Desired-replica targeting from queue depth and aging pressure (port
of ``pyabc_tpu/sched/autoscale.py``; host code, copied).

The scheduler does not start workers itself (that is the operator's or
a wrapper script's job — a k8s HPA analog, ``kubectl scale``, or a
plain loop spawning serve worker processes); it *emits a target*:
``sched_desired_replicas``, published in every scheduler snapshot and
printed by the scheduler's CLI.  The raw target is capacity arithmetic —
enough workers to hold the current backlog at
``PYABC_TPU_SCHED_STUDIES_PER_WORKER`` studies each, plus one when the
oldest pending study has aged past
``PYABC_TPU_SCHED_AGING_PRESSURE_S`` (an aged queue means the fleet is
too small even when it is shallow) — clamped to
``[PYABC_TPU_SCHED_MIN_REPLICAS, PYABC_TPU_SCHED_MAX_REPLICAS]``.

The *published* target applies hysteresis in BOTH directions: the raw
target must hold strictly above the current value for
``PYABC_TPU_SCHED_UP_TICKS`` consecutive ticks before the target moves
up, and strictly below for ``PYABC_TPU_SCHED_DOWN_TICKS`` ticks before
it moves down.  Scale-down is deliberately slower than scale-up
(defaults 5 vs 2): killing a warm worker throws away its compiled
ladder, so a transient lull must not thrash the pool that took real
compile seconds to build.
"""

from __future__ import annotations

import math
import os
from typing import Optional

MIN_REPLICAS_ENV = "PYABC_TPU_SCHED_MIN_REPLICAS"
MAX_REPLICAS_ENV = "PYABC_TPU_SCHED_MAX_REPLICAS"
STUDIES_PER_WORKER_ENV = "PYABC_TPU_SCHED_STUDIES_PER_WORKER"
AGING_PRESSURE_ENV = "PYABC_TPU_SCHED_AGING_PRESSURE_S"
UP_TICKS_ENV = "PYABC_TPU_SCHED_UP_TICKS"
DOWN_TICKS_ENV = "PYABC_TPU_SCHED_DOWN_TICKS"

_DEFAULT_MIN_REPLICAS = 1
_DEFAULT_MAX_REPLICAS = 16
_DEFAULT_STUDIES_PER_WORKER = 8
_DEFAULT_AGING_PRESSURE_S = 120.0
_DEFAULT_UP_TICKS = 2
_DEFAULT_DOWN_TICKS = 5


def _env_int(name: str, default: int) -> int:
    try:
        return max(int(os.environ.get(name, str(default))), 1)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return max(float(os.environ.get(name, str(default))), 1e-3)
    except ValueError:
        return default


class Autoscaler:
    """Hysteresis-filtered replica targeting (module docstring).

    Pure bookkeeping over the observations fed to :meth:`observe` —
    no filesystem, no clocks — so the hysteresis contract is unit
    testable tick by tick.
    """

    def __init__(self, min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 studies_per_worker: Optional[int] = None,
                 aging_pressure_s: Optional[float] = None,
                 up_ticks: Optional[int] = None,
                 down_ticks: Optional[int] = None):
        self.min_replicas = (
            _env_int(MIN_REPLICAS_ENV, _DEFAULT_MIN_REPLICAS)
            if min_replicas is None else max(int(min_replicas), 0))
        self.max_replicas = max(
            _env_int(MAX_REPLICAS_ENV, _DEFAULT_MAX_REPLICAS)
            if max_replicas is None else int(max_replicas),
            self.min_replicas)
        self.studies_per_worker = (
            _env_int(STUDIES_PER_WORKER_ENV, _DEFAULT_STUDIES_PER_WORKER)
            if studies_per_worker is None else max(
                int(studies_per_worker), 1))
        self.aging_pressure_s = (
            _env_float(AGING_PRESSURE_ENV, _DEFAULT_AGING_PRESSURE_S)
            if aging_pressure_s is None else float(aging_pressure_s))
        self.up_ticks = (_env_int(UP_TICKS_ENV, _DEFAULT_UP_TICKS)
                         if up_ticks is None else max(int(up_ticks), 1))
        self.down_ticks = (
            _env_int(DOWN_TICKS_ENV, _DEFAULT_DOWN_TICKS)
            if down_ticks is None else max(int(down_ticks), 1))
        self.desired: Optional[int] = None
        self._up_streak = 0
        self._down_streak = 0

    def target(self, pending: int, claimed: int,
               oldest_pending_s: float = 0.0) -> int:
        """The raw (un-filtered) capacity target for this instant."""
        backlog = max(int(pending), 0) + max(int(claimed), 0)
        raw = math.ceil(backlog / self.studies_per_worker)
        if oldest_pending_s > self.aging_pressure_s:
            raw += 1  # aged queue: depth alone understates the need
        return min(max(raw, self.min_replicas), self.max_replicas)

    def observe(self, pending: int, claimed: int,
                oldest_pending_s: float = 0.0) -> int:
        """Feed one tick's queue observation; returns the
        hysteresis-filtered desired replica count.  The first
        observation seeds the target directly (there is no previous
        value to defend)."""
        raw = self.target(pending, claimed, oldest_pending_s)
        if self.desired is None:
            self.desired = raw
            return self.desired
        if raw > self.desired:
            self._up_streak += 1
            self._down_streak = 0
            if self._up_streak >= self.up_ticks:
                self.desired = raw
                self._up_streak = 0
        elif raw < self.desired:
            self._down_streak += 1
            self._up_streak = 0
            if self._down_streak >= self.down_ticks:
                self.desired = raw
                self._down_streak = 0
        else:
            self._up_streak = 0
            self._down_streak = 0
        return self.desired
