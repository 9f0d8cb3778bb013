"""Worker platform drivers: the actuator behind the autoscaler (port of
``pyabc_tpu/sched/platform.py``; host code, copied).

:class:`~pyabc_tpu_torch.sched.autoscale.Autoscaler` computes a desired
replica count and publishes it as the ``sched_desired_replicas`` gauge.
A *platform* closes the loop: ``Scheduler.tick()`` hands it the desired
count every tick and the platform makes reality match.

The interface is three methods (everything else is implementation):

- ``reconcile(desired) -> dict`` — converge the running worker set
  toward ``desired`` and return an accounting dict (``running``,
  ``started``, ``stopped``, ``crashed``);
- ``replicas() -> int`` — how many workers the platform currently
  believes are running;
- ``shutdown()`` — stop everything the platform started (scheduler
  exit).

:class:`SubprocessPlatform` is the single-host reference implementation:
it starts serve workers (``python -m pyabc_tpu_torch.serve.worker``) as
child processes of the scheduler, SIGTERM-drains the newest workers on
scale-down (the worker's drain path requeues all claims), and restarts
crashed workers with exponential backoff
(``PYABC_TPU_SCHED_RESTART_BACKOFF_S`` base, capped) so a crash-looping
fleet does not hot-spin.  Wire it in with ``python -m
pyabc_tpu_torch.sched.scheduler --platform subprocess``.

A cluster platform (k8s, a wrapper around your scheduler of choice)
implements the same three methods; the scheduler does not care what a
"worker" is (the JAX package's module docstring sketches a k8s one).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

from ..telemetry.metrics import REGISTRY

#: base seconds of restart backoff after a worker crash (doubles per
#: consecutive crash, capped at ``_MAX_BACKOFF_S``)
RESTART_BACKOFF_S_ENV = "PYABC_TPU_SCHED_RESTART_BACKOFF_S"

_DEFAULT_BACKOFF_S = 1.0
_MAX_BACKOFF_S = 30.0


def restart_backoff_default() -> float:
    try:
        return max(float(os.environ.get(RESTART_BACKOFF_S_ENV,
                                        str(_DEFAULT_BACKOFF_S))), 0.0)
    except ValueError:
        return _DEFAULT_BACKOFF_S


class WorkerPlatform:
    """The 3-method platform interface (module docstring)."""

    def reconcile(self, desired: int) -> dict:
        raise NotImplementedError

    def replicas(self) -> int:
        raise NotImplementedError

    def shutdown(self, timeout_s: float = 10.0):
        raise NotImplementedError


class _Managed:
    """One platform-started worker process."""

    __slots__ = ("proc", "started_unix", "stopping")

    def __init__(self, proc: subprocess.Popen):
        self.proc = proc
        self.started_unix = time.time()
        self.stopping = False  # SIGTERM sent: an exit is a drain, not
        # a crash


class SubprocessPlatform(WorkerPlatform):
    """Single-host reference platform: serve workers as child processes
    of the scheduler.

    Scale-up spawns; scale-down SIGTERMs the NEWEST workers (they hold
    the least engine warmth — the drain requeues their claims and the
    survivors pick the studies up); a crash (any exit the platform did
    not ask for) schedules a respawn after an exponential backoff.  A
    worker surviving ``3 * backoff`` clears the crash streak."""

    def __init__(self, serve_dir: Optional[str] = None,
                 argv: Optional[List[str]] = None,
                 env: Optional[dict] = None,
                 backoff_s: Optional[float] = None):
        from ..serve.queue import serve_root
        self.serve_dir = serve_root(serve_dir)
        #: the worker command; override for tests or custom entry
        #: points — the default is the port's serve worker bound to this
        #: platform's serve root (on the card: add ``--device cpu`` to
        #: run it on the CPU)
        self.argv = list(argv) if argv is not None else [
            sys.executable, "-m", "pyabc_tpu_torch.serve.worker",
            "--serve-dir", self.serve_dir]
        self.env = dict(os.environ, **(env or {}))
        self.backoff_s = (restart_backoff_default()
                          if backoff_s is None else float(backoff_s))
        self._procs: List[_Managed] = []
        self._crash_streak = 0
        self._next_start_unix = 0.0

    # ---- internals -------------------------------------------------------

    def _spawn(self) -> _Managed:
        m = _Managed(subprocess.Popen(self.argv, env=self.env))
        self._procs.append(m)
        REGISTRY.counter(
            "sched_platform_starts_total",
            "worker processes started by the platform").inc()
        return m

    def _reap(self) -> int:
        """Collect exited children; count the unrequested exits as
        crashes and push the restart backoff out."""
        crashed = 0
        for m in list(self._procs):
            if m.proc.poll() is None:
                if (self._crash_streak and not m.stopping
                        and time.time() - m.started_unix
                        > 3.0 * max(self.backoff_s, 1.0)):
                    self._crash_streak = 0  # survived: streak over
                continue
            self._procs.remove(m)
            if m.stopping:
                continue  # asked-for drain exit
            crashed += 1
            self._crash_streak += 1
            backoff = min(
                self.backoff_s * (2.0 ** (self._crash_streak - 1)),
                _MAX_BACKOFF_S)
            self._next_start_unix = max(self._next_start_unix,
                                        time.time() + backoff)
            REGISTRY.counter(
                "sched_platform_crashes_total",
                "platform workers that exited without being asked"
            ).inc()
        return crashed

    # ---- the 3-method interface ------------------------------------------

    def replicas(self) -> int:
        return sum(1 for m in self._procs
                   if not m.stopping and m.proc.poll() is None)

    def reconcile(self, desired: int) -> dict:
        desired = max(int(desired), 0)
        report = {"desired": desired, "started": 0, "stopped": 0,
                  "crashed": self._reap()}
        live = [m for m in self._procs if not m.stopping]
        # scale down: drain the newest first (least warmth invested)
        for m in sorted(live, key=lambda m: m.started_unix,
                        reverse=True)[:max(len(live) - desired, 0)]:
            m.stopping = True
            try:
                m.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
            report["stopped"] += 1
            REGISTRY.counter(
                "sched_platform_stops_total",
                "workers SIGTERM-drained by scale-down").inc()
        live = [m for m in self._procs if not m.stopping]
        # scale up, unless a crash streak has us backing off
        while (len(live) < desired
               and time.time() >= self._next_start_unix):
            live.append(self._spawn())
            report["started"] += 1
        report["running"] = len(live)
        report["backoff_until_unix"] = (
            round(self._next_start_unix, 2)
            if self._next_start_unix > time.time() else 0)
        REGISTRY.gauge(
            "sched_platform_replicas",
            "worker processes the platform is running").set(len(live))
        return report

    def shutdown(self, timeout_s: float = 10.0):
        """SIGTERM everything (drain), escalate to SIGKILL past the
        deadline — the scheduler-exit path."""
        for m in self._procs:
            m.stopping = True
            try:
                m.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
        deadline = time.time() + timeout_s
        for m in self._procs:
            try:
                m.proc.wait(timeout=max(deadline - time.time(), 0.1))
            except subprocess.TimeoutExpired:
                try:
                    m.proc.kill()
                    m.proc.wait(timeout=5.0)
                except (OSError, subprocess.TimeoutExpired):
                    pass
        self._procs = []


def platform_from_name(name: Optional[str],
                       serve_dir: Optional[str] = None,
                       env: Optional[dict] = None
                       ) -> Optional[WorkerPlatform]:
    """CLI factory: ``none``/``None`` → no platform (gauge-only
    autoscaling), ``subprocess`` → :class:`SubprocessPlatform` on this
    host."""
    if not name or name == "none":
        return None
    if name == "subprocess":
        return SubprocessPlatform(serve_dir=serve_dir, env=env)
    raise ValueError(f"unknown platform {name!r} "
                     "(expected 'none' or 'subprocess')")
