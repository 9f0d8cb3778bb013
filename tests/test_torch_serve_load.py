"""Twins of ``tests/test_serve_load.py`` for the port: the closed-loop
load generator (``pyabc_tpu_torch.tools.loadgen``) and the subprocess
worker platform (``pyabc_tpu_torch.sched.platform``) on the CPU.

- the generator drives the real submit path (queue → partition → claim
  → tombstone) against a worker thread (``device="cpu"``), measures
  end-to-end latency, derives the cache-tier split from the tombstones
  and counts sheds apart from quota rejections;
- the platform converges the process set to the desired count,
  SIGTERM-drains the newest on scale-down, counts crashes and backs off
  before respawning; ``Scheduler.tick`` drives it, here over real port
  serve workers (``python -m pyabc_tpu_torch.serve.worker --device
  cpu``).
"""

import os
import signal
import sys
import threading
import time

import torch

import pyabc_tpu_torch as pt
from pyabc_tpu_torch.sched.platform import SubprocessPlatform
from pyabc_tpu_torch.serve import ServeWorker, StudyQueue, StudySpec
from pyabc_tpu_torch.tools.loadgen import ClosedLoopLoadGen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(generator, theta):
    noise = 0.1 * torch.randn(theta.shape[0], 1, generator=generator,
                              device=theta.device)
    return {"y": theta[:, :1] + noise}


def _spec(pop=100, seed=0, y=0.4):
    return StudySpec(
        model=_model,
        prior=pt.Distribution(mu=pt.RV("uniform", -1.0, 2.0)),
        observed={"y": float(y)}, population_size=pop,
        seed=seed, tenant="load", max_generations=2)


def test_loadgen_closed_loop_end_to_end(tmp_path):
    root = str(tmp_path)
    queue = StudyQueue(root=root)
    worker = ServeWorker(root=root, worker_id="w_load", device="cpu")
    t = threading.Thread(target=worker.run_forever, args=(queue,),
                         kwargs={"poll_s": 0.01}, daemon=True)
    t.start()
    try:
        pool = [_spec(seed=s) for s in range(3)]
        report = ClosedLoopLoadGen(queue, pool, n_studies=12, clients=4,
                                   seed=7, study_timeout_s=120.0).run()
    finally:
        worker.drain()
        t.join(timeout=30.0)
    assert not t.is_alive()
    assert report["completed"] == 12
    assert report["failed"] == 0 and report["timeouts"] == 0
    assert report["studies_per_s"] > 0
    assert 0 < report["p50_ms"] <= report["p99_ms"]
    assert report["cache_hit_tier1"] >= 0.5
    assert report["shed_rate"] == 0.0
    assert queue.stats()["done"] == 12


def test_loadgen_counts_sheds_separately(tmp_path):
    from pyabc_tpu_torch.serve import AdmissionController
    root = str(tmp_path)
    queue = StudyQueue(root=root, partitions=1,
                       admission=AdmissionController(
                           root, slo_depth=1, retry_s=0.01))
    report = ClosedLoopLoadGen(queue, [_spec(seed=s) for s in range(4)],
                               n_studies=4, clients=2, seed=3,
                               study_timeout_s=1.0).run()
    assert report["completed"] == 0
    assert report["sheds"] > 0
    assert report["shed_rate"] > 0
    assert report["rejected"] == 0
    assert report["timeouts"] + report["sheds"] >= 4


def _idle_platform(tmp_path, backoff_s=0.05):
    """'Workers' that are inert sleepers: the process lifecycle is under
    test, not the serving."""
    return SubprocessPlatform(
        serve_dir=str(tmp_path),
        argv=[sys.executable, "-c",
              "import signal, time\n"
              "signal.signal(signal.SIGTERM, lambda *_: exit(0))\n"
              "time.sleep(600)"],
        backoff_s=backoff_s)


def test_platform_scales_up_and_down(tmp_path):
    platform = _idle_platform(tmp_path)
    try:
        rep = platform.reconcile(2)
        assert rep["started"] == 2 and rep["running"] == 2
        assert platform.replicas() == 2
        rep = platform.reconcile(1)  # SIGTERM-drains the newest
        assert rep["stopped"] == 1
        deadline = time.time() + 10.0
        while time.time() < deadline and platform.replicas() > 1:
            time.sleep(0.05)
        assert platform.replicas() == 1
        assert platform.reconcile(1)["crashed"] == 0
    finally:
        platform.shutdown()
    assert platform.replicas() == 0


def test_platform_restarts_crashed_worker_with_backoff(tmp_path):
    platform = _idle_platform(tmp_path, backoff_s=0.2)
    try:
        platform.reconcile(1)
        victim = platform._procs[0].proc
        os.kill(victim.pid, signal.SIGKILL)
        victim.wait(timeout=10)
        rep = platform.reconcile(1)
        assert rep["crashed"] == 1
        assert rep["started"] == 0 and rep["running"] == 0
        assert rep["backoff_until_unix"] > 0
        deadline = time.time() + 10.0
        while time.time() < deadline and platform.replicas() < 1:
            platform.reconcile(1)
            time.sleep(0.05)
        assert platform.replicas() == 1
        assert victim.pid not in [m.proc.pid for m in platform._procs]
    finally:
        platform.shutdown()


def test_scheduler_tick_drives_platform(tmp_path):
    """``Scheduler.tick`` hands the autoscaler's count to the platform,
    whose default command is the port's serve worker."""
    from pyabc_tpu_torch.sched import Scheduler
    from pyabc_tpu_torch.sched.autoscale import Autoscaler
    queue = StudyQueue(root=str(tmp_path))
    platform = SubprocessPlatform(serve_dir=str(tmp_path),
                                  env={"PYTHONPATH": REPO})
    assert platform.argv[1:4] == ["-m", "pyabc_tpu_torch.serve.worker",
                                  "--serve-dir"]
    platform.argv += ["--device", "cpu"]
    sched = Scheduler(run_dir=None, queue=queue,
                      autoscaler=Autoscaler(min_replicas=2, max_replicas=2),
                      platform=platform)
    try:
        rep = sched.tick()
        assert rep["desired_replicas"] == 2
        assert rep["platform"]["started"] == 2
        assert rep["platform"]["running"] == 2
        assert "swept" in rep
        procs = [m.proc for m in platform._procs]
    finally:
        platform.shutdown(timeout_s=60.0)
    assert all(p.poll() is not None for p in procs)
