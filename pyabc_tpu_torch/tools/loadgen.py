"""Closed-loop load generator for the serving data plane (port of
``tools/loadgen.py``; host code, copied)::

    python -m pyabc_tpu_torch.tools.loadgen --serve-dir DIR \
        --studies 10000 --clients 32 --rate-hz 200

Drives a fleet of serve workers (``python -m
pyabc_tpu_torch.serve.worker``) through the real submit path
(:meth:`StudyQueue.submit` → partitioned ``pending/`` → worker claim →
``done/`` tombstone) with the closed-loop discipline of LLM-serving
benchmarks: N concurrent clients, each submitting one study, waiting
for its tombstone, then thinking for an exponentially-distributed
pause — Poisson arrivals at a controlled aggregate rate, never an
unbounded open loop that measures nothing but queue growth.

Each client records per-study end-to-end latency (submit → settled
tombstone) and the engine the study was served from (the tombstone's
``engine`` field: ``cache`` = tier-1, ``cache_t2`` = shared tier-2,
``multiplex``/``solo`` = dispatched).  When tracing is on the
tombstone also carries the server-attributed phase breakdown
(``trace.phases``); the report compares client-observed latency
against the server-attributed total and prints the gap explicitly —
it is the tombstone-poll artifact (bounded by ``poll_s``), not
hidden inside either number — plus queue-wait percentiles.  Shed
responses (:class:`ServeOverloaded`) honor the computed
``retry_after_s`` (capped) and count into the shed rate;
quota/backpressure rejections retry after a short fixed pause.

The generator only touches the queue directories, so it load-tests
whatever is draining them: a worker thread in a test, platform-managed
subprocess workers (``sched.platform.SubprocessPlatform``), a fleet.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Callable, List, Optional, Sequence

from ..serve.admission import ServeOverloaded
from ..serve.queue import QueueFull, StudyQueue

#: cap on how long a shed's retry_after_s is honored (a pathological
#: quote must not stall the run)
_MAX_RETRY_S = 5.0

#: fixed pause after a quota/backpressure rejection
_REJECT_RETRY_S = 0.05


def _percentile(values: Sequence[float], q: float) -> float:
    if not values:
        return 0.0
    vs = sorted(values)
    idx = min(int(q * len(vs)), len(vs) - 1)
    return float(vs[idx])


class ClosedLoopLoadGen:
    """N closed-loop clients over one study queue.

    ``specs`` is the submission pool; each client draws from it with
    its own seeded RNG (duplicates in the pool are the point — they
    exercise the cache tiers).  ``rate_hz`` is the target AGGREGATE
    arrival rate: each client thinks ``Exp(rate_hz / clients)``
    between completions, so arrivals are Poisson at ``rate_hz`` when
    the fleet keeps up and gracefully throttle to fleet capacity when
    it does not (closed loop).  ``rate_hz=None`` disables think time
    (max-pressure mode).

    ``unique=True`` flips the draw to a seed-shuffled pass over the
    pool without replacement (cycling if ``n_studies`` exceeds it):
    every submission is a FRESH study, so the fleet's dispatch path —
    not the cache tiers — is what gets priced.  That is the traffic
    shape the continuous-batching A/B needs: lane work per arrival,
    mixed durations, no dedup shortcut."""

    def __init__(self, queue: StudyQueue, specs: Sequence,
                 n_studies: int, clients: int = 8,
                 rate_hz: Optional[float] = None, seed: int = 0,
                 poll_s: float = 0.005, study_timeout_s: float = 120.0,
                 unique: bool = False,
                 on_progress: Optional[Callable[[int], None]] = None):
        self.queue = queue
        self.specs = list(specs)
        self.n_studies = int(n_studies)
        order = list(range(len(self.specs)))
        random.Random(seed).shuffle(order)
        self._order = order if unique else None
        self.clients = max(int(clients), 1)
        self.rate_hz = rate_hz
        self.seed = int(seed)
        self.poll_s = float(poll_s)
        self.study_timeout_s = float(study_timeout_s)
        self.on_progress = on_progress
        self._lock = threading.Lock()
        self._submitted = 0
        self._lat_ms: List[float] = []
        self._server_ms: List[float] = []
        self._queue_wait_ms: List[float] = []
        self._engines: dict = {}
        self._sheds = 0
        self._shed_wait_s = 0.0
        self._rejects = 0
        self._failed = 0
        self._timeouts = 0

    # ---- client loop -----------------------------------------------------

    def _take_slot(self) -> Optional[int]:
        """Claim the next submission slot; its index drives the
        without-replacement draw in ``unique`` mode."""
        with self._lock:
            if self._submitted >= self.n_studies:
                return None
            slot = self._submitted
            self._submitted += 1
            return slot

    def _settled(self, ticket) -> Optional[dict]:
        """The ticket's tombstone payload once it reaches done/failed,
        else ``None`` while still in flight."""
        for state in ("done", "failed"):
            path = os.path.join(self.queue.root, state,
                                f"{ticket.id}.json")
            try:
                with open(path, encoding="utf-8") as f:
                    payload = json.load(f)
            except (OSError, ValueError):
                continue  # not settled (or torn mid-write): keep waiting
            payload["_state"] = state
            return payload
        return None

    def _run_client(self, idx: int):
        rng = random.Random((self.seed << 16) ^ idx)
        think_hz = (None if not self.rate_hz
                    else self.rate_hz / self.clients)
        while True:
            slot = self._take_slot()
            if slot is None:
                break
            if self._order is not None:
                spec = self.specs[self._order[slot % len(self._order)]]
            else:
                spec = self.specs[rng.randrange(len(self.specs))]
            t0 = time.perf_counter()
            ticket = None
            deadline = time.monotonic() + self.study_timeout_s
            while ticket is None:
                try:
                    ticket = self.queue.submit(spec)
                except ServeOverloaded as shed:
                    wait = min(max(shed.retry_after_s, 0.01),
                               _MAX_RETRY_S)
                    with self._lock:
                        self._sheds += 1
                        self._shed_wait_s += wait
                    time.sleep(wait)
                except QueueFull:
                    with self._lock:
                        self._rejects += 1
                    time.sleep(_REJECT_RETRY_S)
                if time.monotonic() > deadline:
                    break
            if ticket is None:
                with self._lock:
                    self._timeouts += 1
                continue
            tomb = None
            while time.monotonic() < deadline:
                tomb = self._settled(ticket)
                if tomb is not None:
                    break
                time.sleep(self.poll_s)
            lat_ms = (time.perf_counter() - t0) * 1e3
            with self._lock:
                if tomb is None:
                    self._timeouts += 1
                elif tomb["_state"] == "failed":
                    self._failed += 1
                else:
                    self._lat_ms.append(lat_ms)
                    eng = str(tomb.get("engine", "unknown"))
                    self._engines[eng] = self._engines.get(eng, 0) + 1
                    phases = (tomb.get("trace") or {}).get("phases")
                    if phases:
                        self._server_ms.append(
                            float(phases.get("total_s", 0.0)) * 1e3)
                        self._queue_wait_ms.append(
                            float(phases.get("queue_wait_s", 0.0)) * 1e3)
                done = len(self._lat_ms)
            if self.on_progress is not None:
                self.on_progress(done)
            if think_hz:
                time.sleep(rng.expovariate(think_hz))

    # ---- driver ----------------------------------------------------------

    def run(self) -> dict:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=self._run_client, args=(i,),
                                    daemon=True,
                                    name=f"loadgen-{i}")
                   for i in range(self.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall_s = time.perf_counter() - t0
        with self._lock:
            lats = list(self._lat_ms)
            server_ms = list(self._server_ms)
            queue_wait_ms = list(self._queue_wait_ms)
            engines = dict(self._engines)
            sheds, rejects = self._sheds, self._rejects
            failed, timeouts = self._failed, self._timeouts
            shed_wait_s = self._shed_wait_s
        completed = len(lats)
        attempts = completed + failed + timeouts + sheds
        t1 = engines.get("cache", 0)
        t2 = engines.get("cache_t2", 0)
        client_p50 = _percentile(lats, 0.50)
        server_p50 = _percentile(server_ms, 0.50)
        # Client-observed minus server-attributed at the median: the
        # tombstone-poll artifact (bounded by poll_s plus scheduling
        # jitter).  Reported, never folded into either latency.
        gap_ms = client_p50 - server_p50 if server_ms else 0.0
        return {
            "studies_per_s": round(completed / wall_s, 3) if wall_s
            else 0.0,
            "p50_ms": round(client_p50, 3),
            "p99_ms": round(_percentile(lats, 0.99), 3),
            "server_p50_ms": round(server_p50, 3),
            "server_p99_ms": round(_percentile(server_ms, 0.99), 3),
            "client_server_gap_ms": round(gap_ms, 3),
            "queue_wait_p50_ms": round(
                _percentile(queue_wait_ms, 0.50), 3),
            "queue_wait_p99_ms": round(
                _percentile(queue_wait_ms, 0.99), 3),
            "traced": len(server_ms),
            "shed_rate": round(sheds / attempts, 5) if attempts
            else 0.0,
            "cache_hit_tier1": round(t1 / completed, 5) if completed
            else 0.0,
            "cache_hit_tier2": round(t2 / completed, 5) if completed
            else 0.0,
            "completed": completed,
            "failed": failed,
            "timeouts": timeouts,
            "sheds": sheds,
            "shed_wait_s": round(shed_wait_s, 3),
            "rejected": rejects,
            "wall_s": round(wall_s, 3),
            "clients": self.clients,
            "rate_hz": self.rate_hz,
            "engines": engines,
        }


def _model(generator, theta):
    """The CLI's study model: y = mu + 0.1·N(0, 1), module-level because
    a submitted spec is pickled."""
    import torch
    noise = 0.1 * torch.randn(theta.shape[0], 1, generator=generator,
                              device=theta.device)
    return {"y": theta[:, :1] + noise}


def main(argv=None) -> int:
    import argparse

    import pyabc_tpu_torch as pt
    from ..serve.spec import StudySpec

    ap = argparse.ArgumentParser(
        prog="pyabc_tpu_torch.tools.loadgen",
        description="Closed-loop load generator for serve worker fleets")
    ap.add_argument("--serve-dir", default=None)
    ap.add_argument("--studies", type=int, default=10_000)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--rate-hz", type=float, default=None)
    ap.add_argument("--pool", type=int, default=16,
                    help="distinct specs in the submission pool")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    pops = (100, 300, 1000)
    specs = [StudySpec(
        model=_model,
        prior=pt.Distribution(mu=pt.RV("uniform", -1.0, 2.0)),
        observed={"y": 0.1 * (i % 4)},
        population_size=pops[i % len(pops)],
        seed=i, max_generations=2,
        tenant=f"tenant{i % 3}") for i in range(args.pool)]
    queue = StudyQueue(root=args.serve_dir)
    gen = ClosedLoopLoadGen(queue, specs, n_studies=args.studies,
                            clients=args.clients, rate_hz=args.rate_hz,
                            seed=args.seed)
    print(json.dumps(gen.run(), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
