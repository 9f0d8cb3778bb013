"""The elastic fleet scheduler (port of ``pyabc_tpu/sched/scheduler.py``;
host code, copied; CLI ``python -m pyabc_tpu_torch.sched.scheduler``).

One reconciliation loop over the shared run-dir mount — the control
plane that treats preemption as the common case.  Each :meth:`tick`:

1. reads worker liveness from the heartbeat files
   (``parallel/health.py`` — the monotonic staleness cross-check, so a
   wall-clock step can never declare a beating worker dead);
2. walks ``queue/claimed/``: a claim held by a worker whose heartbeat
   is ALIVE is never touched (live-but-slow studies are not stolen —
   the heartbeat thread renews its leases); a claim whose worker is
   declared DEAD, or whose lease outlived ``PYABC_TPU_SERVE_LEASE_S``
   without renewal (no heartbeat at all: partitioned host, custom
   worker id), is reaped;
3. reaped tickets are requeued with bounce accounting
   (``last_worker`` / ``last_error`` / ``bounce_history`` breadcrumbs)
   — a requeued durable study RESUMES from its journaled generation on
   the next worker (``serve/worker.py``, ``PYABC_TPU_SERVE_DURABLE``),
   not from generation 0;
4. a ticket whose next bounce would reach
   ``PYABC_TPU_SERVE_MAX_BOUNCES`` is a poison ticket: it is
   quarantined into ``failed/`` with the flight-recorder dump attached
   instead of being handed to yet another worker;
5. the autoscaler (:mod:`pyabc_tpu_torch.sched.autoscale`) folds queue depth
   and aging pressure into ``sched_desired_replicas``, and — when a
   platform driver is wired in (:mod:`pyabc_tpu_torch.sched.platform`,
   ``--platform subprocess``) — the platform reconciles the
   actual worker set toward that target (spawn on scale-up, SIGTERM
   drain on scale-down, crash restart with backoff);
6. done/failed tombstones past retention are swept
   (:meth:`StudyQueue.sweep`) — GC belongs on the control loop, not
   the workers' idle path, because a busy fleet never idles.

The scheduler is stateless between ticks apart from the autoscaler's
hysteresis streaks: every decision re-derives from the mount, so any
number of scheduler replicas may run (requeues converge by ticket id,
exactly like worker drains).  Its own ``sched_*`` metrics ride the
normal telemetry snapshot into ``fleet_rollup`` / ``parallel.cli top`` /
``/api/sched`` / the Prometheus exporter.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

from ..parallel import health
from ..serve.queue import (StudyQueue, Ticket, max_bounces_default,
                           serve_root)
from ..telemetry.metrics import REGISTRY
from .autoscale import Autoscaler

#: scheduler loop cadence (seconds between reconciliation ticks)
INTERVAL_ENV = "PYABC_TPU_SCHED_INTERVAL_S"
_DEFAULT_INTERVAL_S = 5.0


def interval_default() -> float:
    try:
        val = float(os.environ.get(INTERVAL_ENV, _DEFAULT_INTERVAL_S))
    except ValueError:
        return _DEFAULT_INTERVAL_S
    return val if val > 0 else _DEFAULT_INTERVAL_S


class Scheduler:
    """One scheduler instance: a queue, a heartbeat directory, and an
    autoscaler (module docstring has the tick contract)."""

    def __init__(self, run_dir: Optional[str] = None,
                 serve_dir: Optional[str] = None,
                 queue: Optional[StudyQueue] = None,
                 lease_s: Optional[float] = None,
                 max_bounces: Optional[int] = None,
                 stale_after_s: Optional[float] = None,
                 autoscaler: Optional[Autoscaler] = None,
                 platform=None):
        self.run_dir = run_dir if run_dir is not None else health.run_dir()
        self.queue = queue if queue is not None else StudyQueue(
            root=serve_root(serve_dir), lease_s=lease_s)
        self.lease_s = (self.queue.lease_s if lease_s is None
                        else float(lease_s))
        self.max_bounces = (max_bounces_default() if max_bounces is None
                            else max(int(max_bounces), 1))
        self.stale_after_s = stale_after_s
        self.autoscaler = autoscaler or Autoscaler()
        #: optional worker platform (sched/platform.py): when set,
        #: every tick reconciles the running worker set toward the
        #: autoscaler's desired count
        self.platform = platform
        self.ticks = 0
        self._publisher = None
        if self.run_dir:
            from ..telemetry import aggregate
            try:
                self._publisher = aggregate.TelemetryPublisher(
                    self.run_dir)
            except OSError:
                self._publisher = None

    # ---- liveness --------------------------------------------------------

    def worker_liveness(self) -> Dict[str, bool]:
        """``{"<host>_<pid>": alive}`` for every worker that ever
        heartbeat into the run dir — the join key is exactly the
        default serve worker id, so heartbeat liveness maps onto
        ``queue/claimed/<worker>/`` directories.  Empty when no run dir
        is configured (lease lapse is then the only death signal)."""
        if not self.run_dir:
            return {}
        return {
            f"{e.get('host')}_{e.get('pid')}": bool(e.get("alive"))
            for e in health.worker_status(
                self.run_dir, stale_after_s=self.stale_after_s)}

    # ---- reconciliation --------------------------------------------------

    def _bounce(self, t: Ticket, reason: str,
                report: dict):
        """Requeue a reaped claim — or quarantine it when the bounce
        budget is exhausted (the poison-ticket path)."""
        if t.requeues + 1 >= self.max_bounces:
            from ..telemetry.flight import RECORDER
            RECORDER.note("sched_quarantine", ticket=t.id,
                          worker=t.worker, requeues=t.requeues,
                          reason=reason)
            flight = RECORDER.dump(
                reason=f"quarantine:{t.id}", run_id=t.id,
                directory=os.path.dirname(self.queue.root))
            self.queue.quarantine(
                t, error=f"poison ticket: {t.requeues + 1} bounces "
                         f"(last: {reason})",
                flight_path=flight)
            REGISTRY.counter(
                "sched_quarantines_total",
                "poison tickets quarantined by the scheduler").inc()
            report["quarantined"].append(t.id)
        elif self.queue.requeue(t, worker=t.worker, error=reason):
            REGISTRY.counter(
                "sched_requeues_total",
                "claims requeued by the scheduler (dead worker or "
                "lapsed lease)").inc()
            report["requeued"].append(t.id)

    def tick(self) -> dict:
        """One reconciliation pass; returns the tick report."""
        t0 = time.perf_counter()
        self.ticks += 1
        report: dict = {"alive": 0, "dead": 0, "lapsed": 0,
                        "requeued": [], "quarantined": [],
                        "desired_replicas": 0}
        liveness = self.worker_liveness()
        report["alive"] = sum(1 for a in liveness.values() if a)
        report["dead"] = sum(1 for a in liveness.values() if not a)
        now = self.queue.fs_now()
        for t in self.queue.claimed():
            if liveness.get(t.worker) is True:
                continue  # beating worker: its leases are its own
            dead = liveness.get(t.worker) is False
            lapsed = self.queue.lease_age_s(t, now=now) > self.lease_s
            if not (dead or lapsed):
                continue  # unknown worker, lease still live: wait
            if lapsed:
                report["lapsed"] += 1
                REGISTRY.counter(
                    "sched_leases_lapsed_total",
                    "claim leases that outlived their TTL").inc()
            if dead:
                REGISTRY.counter(
                    "sched_dead_worker_reaps_total",
                    "claims reaped from heartbeat-dead workers").inc()
            self._bounce(
                t, "worker dead (stale heartbeat)" if dead
                else f"lease lapsed (> {self.lease_s:g}s)", report)
        stats = self.queue.stats()
        pending = self.queue.pending()
        oldest_s = (time.time() - min(t.submitted_unix for t in pending)
                    if pending else 0.0)
        report["desired_replicas"] = self.autoscaler.observe(
            stats["pending"], stats["claimed"],
            oldest_pending_s=oldest_s)
        if self.platform is not None:
            # close the autoscale loop: the platform converges the
            # running worker set toward the desired count
            report["platform"] = self.platform.reconcile(
                report["desired_replicas"])
        # tombstone GC on the control loop (the worker idle-loop call
        # is only a fallback — a busy fleet never idles)
        report["swept"] = self.queue.sweep()
        # GC the per-worker slo/ latency snapshots alongside the
        # tombstones: a dead worker's last (often worst) p99 would
        # otherwise pollute the fleet max for the rest of its
        # freshness window and shed traffic a healthy fleet could
        # take — and stale files accumulate forever as workers churn
        from ..serve.admission import sweep_snapshots
        report["slo_swept"] = sweep_snapshots(
            os.path.dirname(self.queue.root), liveness=liveness)
        # and the trace event log's expired segments
        report["trace_swept"] = self.queue.trace.sweep()
        self._gauges(report, stats, oldest_s,
                     (time.perf_counter() - t0) * 1e3)
        if self._publisher is not None:
            self._publisher.publish(force=True)
        return report

    def _gauges(self, report: dict, stats: dict, oldest_s: float,
                tick_ms: float):
        REGISTRY.counter("sched_ticks_total",
                         "scheduler reconciliation passes").inc()
        g = REGISTRY.gauge
        g("sched_workers_alive",
          "workers with a live heartbeat").set(report["alive"])
        g("sched_workers_dead",
          "workers declared dead by the staleness cross-check"
          ).set(report["dead"])
        g("sched_desired_replicas",
          "autoscaler replica target from depth + aging pressure"
          ).set(report["desired_replicas"])
        g("sched_queue_pending",
          "pending studies seen by the scheduler").set(stats["pending"])
        g("sched_queue_claimed",
          "claimed studies seen by the scheduler").set(stats["claimed"])
        g("sched_oldest_pending_s",
          "age of the oldest pending study").set(round(oldest_s, 3))
        g("sched_last_tick_ms",
          "wall clock of the last reconciliation tick"
          ).set(round(tick_ms, 3))

    def run_forever(self, interval_s: Optional[float] = None,
                    max_ticks: Optional[int] = None,
                    on_tick: Optional[callable] = None) -> int:
        """Tick at the configured cadence until ``max_ticks`` (None:
        forever).  Returns the number of ticks executed."""
        interval_s = (interval_default() if interval_s is None
                      else float(interval_s))
        n = 0
        while max_ticks is None or n < max_ticks:
            rep = self.tick()
            n += 1
            if on_tick is not None:
                on_tick(rep)
            if max_ticks is not None and n >= max_ticks:
                break
            time.sleep(interval_s)
        return n


def main(argv=None) -> int:
    """``python -m pyabc_tpu_torch.sched.scheduler``: the JAX package's
    ``abc-sched`` options (argparse: the card machine has no click)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="pyabc_tpu_torch.sched.scheduler",
        description="Elastic fleet scheduler: lease reaping, bounce "
                    "accounting, poison-ticket quarantine and replica "
                    "targeting over a serve queue on the shared run-dir "
                    "mount.")
    ap.add_argument("--run-dir", default=None,
                    help="Shared run dir with the worker heartbeats "
                         "(default $PYABC_TPU_RUN_DIR).")
    ap.add_argument("--serve-dir", default=None,
                    help="Serve root (default $PYABC_TPU_SERVE_DIR, else "
                         "$PYABC_TPU_RUN_DIR/serve).")
    ap.add_argument("--interval-s", type=float, default=None,
                    help="Tick cadence (default "
                         "$PYABC_TPU_SCHED_INTERVAL_S / 5 s).")
    ap.add_argument("--lease-s", type=float, default=None,
                    help="Claim lease TTL (default "
                         "$PYABC_TPU_SERVE_LEASE_S / 60 s).")
    ap.add_argument("--max-bounces", type=int, default=None,
                    help="Poison-ticket budget (default "
                         "$PYABC_TPU_SERVE_MAX_BOUNCES / 3).")
    ap.add_argument("--once", action="store_true",
                    help="One reconciliation tick, then exit.")
    ap.add_argument("--max-ticks", type=int, default=None,
                    help="Exit after this many ticks.")
    ap.add_argument("--platform", default="none",
                    choices=["none", "subprocess"],
                    help="Worker platform to actuate the autoscaler's "
                         "replica target: 'subprocess' starts/stops serve "
                         "workers on this host (default none).")
    args = ap.parse_args(argv)

    from .platform import platform_from_name
    platform = platform_from_name(args.platform, serve_dir=args.serve_dir)
    sched = Scheduler(run_dir=args.run_dir, serve_dir=args.serve_dir,
                      lease_s=args.lease_s, max_bounces=args.max_bounces,
                      platform=platform)

    def show(rep):
        plat = rep.get("platform") or {}
        extra = f" replicas={plat.get('running', 0)}" if plat else ""
        print(f"tick: alive={rep['alive']} dead={rep['dead']} "
              f"lapsed={rep['lapsed']} "
              f"requeued={len(rep['requeued'])} "
              f"quarantined={len(rep['quarantined'])} "
              f"desired={rep['desired_replicas']}" + extra, flush=True)

    try:
        sched.run_forever(interval_s=args.interval_s,
                          max_ticks=1 if args.once else args.max_ticks,
                          on_tick=show)
    finally:
        if platform is not None:
            platform.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
