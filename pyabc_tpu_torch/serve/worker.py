"""The persistent warm worker.

Port of ``pyabc_tpu/serve/worker.py``.  One worker process owns one card
and serves studies for as long as it lives.  What it protects is
warmth: the engines an :class:`~pyabc_tpu_torch.ABCSMC` builds for its
first study (the sampler's :class:`~..autotune.CompiledLadder` of fused
and one-dispatch engines) are kept in a bounded pool keyed by
:func:`.spec.problem_key` and re-armed with :meth:`ABCSMC.renew`, so a
study that differs only in seed, ``minimum_epsilon`` or
``max_generations`` runs on the same built engines with no new build.

Serving order per claimed batch:

1. the content-addressed cache (:mod:`.cache`): a hit on the (digest,
   engine) key is returned without any dispatch;
2. the study axis (:mod:`.multiplex`): every lane-eligible miss, grouped
   by ``batch_key`` (a group of one runs as a ``StudyBatch`` of one);
3. the warm solo ``run_mode="onedispatch"`` engine on a pooled
   ``ABCSMC`` for everything the study axis cannot take.

:meth:`ServeWorker._engine_of` picks the engine from the spec content
and the worker configuration alone, so the same spec returns the same
bits whatever else was in the queue; the cache is keyed by digest and
engine.  Continuous batching (``PYABC_TPU_SERVE_CB``) retires, publishes
and refills lanes at window boundaries, with the ``serve.window`` fault
site between windows.  SIGTERM starts a drain: the current window
finishes, every study still claimed is requeued, and the loop exits.
The worker runs on the card unless given ``device="cpu"``; it catches no
device error to serve a study elsewhere.

Run: ``python -m pyabc_tpu_torch.serve.worker --serve-dir DIR [--once]
[--max-studies N] [--poll-s S] [--worker-id ID] [--durable] [--device
cpu]``.
"""

from __future__ import annotations

import os
import re
import signal
import threading
import time
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..device import resolve_device
from ..resilience.faults import SITE_SERVE_WINDOW, fault_point
from ..telemetry import studytrace
from ..telemetry.metrics import REGISTRY
from .admission import publish_latency_snapshot, slo_p99_ms_configured
from .cache import StudyCache, TieredStudyCache
from .multiplex import (STOP_NAMES, ShapeHysteresis, StudyBatch,
                        batch_key, cb_enabled, lane_eligible,
                        multiplex_eligible, multiplex_width)
from .queue import StudyQueue, Ticket, default_worker_id, serve_root
from .spec import StudySpec, problem_key, study_digest

#: warm engines held per worker (LRU beyond this)
_MAX_ENGINES = 4

#: built study-axis window programs held per worker (LRU beyond this)
_MAX_BATCH_PROGRAMS = 8

#: opt-in durable solo studies: each miss runs against a file-backed
#: DB under <serve root>/studies/ so an interrupted study RESUMES from
#: its journaled generation (ABCSMC.load → recover_lazy) instead of
#: restarting at generation 0 when the scheduler requeues its ticket
DURABLE_ENV = "PYABC_TPU_SERVE_DURABLE"

_TENANT_SAFE = re.compile(r"[^A-Za-z0-9_]")


def durable_default() -> bool:
    return os.environ.get(DURABLE_ENV, "0").lower() in (
        "1", "true", "yes", "on")


def _tenant_counter(tenant: str):
    safe = _TENANT_SAFE.sub("_", tenant or "default")[:40]
    return REGISTRY.counter(
        f"serve_tenant_{safe}_studies_total",
        "studies served, attributed per tenant")


class ServeWorker:
    """Multi-tenant study server on one warm accelerator process."""

    def __init__(self, root: Optional[str] = None,
                 worker_id: Optional[str] = None,
                 cache: Optional[StudyCache] = None,
                 max_engines: int = _MAX_ENGINES,
                 run_mode: str = "onedispatch",
                 durable: Optional[bool] = None, device=None):
        self.root = serve_root(root)
        #: where every engine of this worker runs (the card by default)
        self.device = resolve_device(device)
        self.worker_id = worker_id or default_worker_id()
        if cache is None:
            # two-tier default (docs/serving.md "Data plane"): the
            # tier-1 spill is worker-private (restart warmth), the
            # tier-2 store is shared across the fleet (any worker
            # serves any worker's duplicates)
            safe = _TENANT_SAFE.sub("_", self.worker_id)[:64]
            cache = TieredStudyCache(
                root=os.path.join(self.root, "cache", "t1", safe),
                shared_root=os.path.join(self.root, "cache", "shared"))
        self.cache = cache
        self.max_engines = max(int(max_engines), 1)
        self.run_mode = run_mode
        #: durable solo studies (``PYABC_TPU_SERVE_DURABLE``): misses
        #: run on a file-backed DB under <root>/studies/ and an
        #: interrupted study resumes from its journaled generation
        self.durable = (durable_default() if durable is None
                        else bool(durable))
        self.studies_dir = os.path.join(self.root, "studies")
        self._engines: "OrderedDict[str, object]" = OrderedDict()
        self._batch_programs: "OrderedDict[tuple, object]" = OrderedDict()
        self._draining = threading.Event()
        self.served = 0
        self.walls_ms: List[float] = []
        self._last_slo_pub = 0.0
        #: in-flight lifecycle-trace contexts, keyed ``id(spec)`` —
        #: populated per claimed batch by :meth:`_trace_begin`, folded
        #: into the tombstone by :meth:`_trace_fold` (empty, and every
        #: ``_emit`` a no-op, when tracing is off or the study came in
        #: without a ticket)
        self._trace_ctx: dict = {}

    # ---- engine routing --------------------------------------------------

    @staticmethod
    def _engine_of(spec: StudySpec) -> str:
        """The engine that defines this spec's result — decided by the
        spec content and worker config alone (``lane_eligible``), so a
        digest always maps to one engine and one reproducible result."""
        return "multiplex" if lane_eligible(spec) else "solo"

    @staticmethod
    def _cache_key(digest: str, engine: str) -> str:
        """Result-cache key: the two engines are statistically but not
        bitwise equivalent, so entries are engine-scoped — a worker
        with different multiplex knobs sharing this serve root misses
        rather than aliasing."""
        return f"{digest}.{engine}"

    def _cache_lookup(self, key: str):
        """Tier-labelled cache probe: ``(summary, served_from)`` where
        ``served_from`` is ``"cache"`` for a tier-1 hit, ``"cache_t2"``
        for a shared-store hit, ``None`` on a miss.  Degrades to a
        plain probe when the injected cache has no tiers."""
        lookup = getattr(self.cache, "lookup", None)
        if lookup is None:
            hit = self.cache.get(key)
            return hit, ("cache" if hit is not None else None)
        hit, tier = lookup(key)
        if hit is None:
            return None, None
        return hit, ("cache_t2" if tier == "t2" else "cache")

    # ---- lifecycle tracing -----------------------------------------------

    def _trace_begin(self, queue: StudyQueue,
                     loaded: Sequence[Tuple[Ticket, StudySpec]]):
        """Open a trace context per claimed study carrying a trace id.

        The context replays the ticket's already-known instants
        (``submitted`` at the payload's submit stamp, ``claimed`` at
        this process's claim stamp) as SYNTHETIC local events so the
        completion fold never scans the shared log on the hot path —
        the log is re-read only for bounced studies, where earlier
        workers' events must join the fold."""
        for tk, spec in loaded:
            trace_id = tk.trace_id
            if not trace_id:
                continue  # tracing off at submit: stay byte-identical
            events = [{"trace_id": trace_id, "event": "submitted",
                       "unix": tk.submitted_unix, "ticket": tk.id},
                      {"trace_id": trace_id, "event": "claimed",
                       "unix": tk.claimed_unix or time.time(),
                       "ticket": tk.id, "worker": self.worker_id,
                       "bounce": tk.requeues}]
            self._trace_ctx[id(spec)] = {
                "trace_id": trace_id, "ticket": tk.id,
                "digest": tk.digest, "requeues": tk.requeues,
                "log": queue.trace, "events": events,
            }

    def _emit(self, spec: StudySpec, event: str, **fields):
        """Append one lifecycle event for an in-flight traced study —
        to the shared log AND to the local context the completion fold
        reads (so folding costs no log scan).  No-op for untraced
        studies (direct ``serve_spec`` calls, tracing off)."""
        ctx = self._trace_ctx.get(id(spec))
        if ctx is None:
            return
        rec = ctx["log"].emit(ctx["trace_id"], event,
                              digest=ctx["digest"],
                              ticket=ctx["ticket"],
                              worker=self.worker_id, **fields)
        if rec is None:  # log write failed: the fold still gets it
            rec = {"trace_id": ctx["trace_id"], "event": event,
                   "unix": time.time(), "ticket": ctx["ticket"],
                   "worker": self.worker_id, **fields}
        ctx["events"].append(rec)

    def _trace_fold(self, spec: StudySpec) -> Optional[dict]:
        """Close a study's trace: fold its events into the critical
        path, record the fleet latency/SLO accounting, and return the
        tombstone ``trace`` block (``None`` for untraced studies).

        A bounced study (``requeues > 0``) re-reads the shared log so
        the earlier workers' claim/requeue events join the fold — the
        trace is continuous across workers; an unbounced study folds
        from the local context alone."""
        ctx = self._trace_ctx.pop(id(spec), None)
        if ctx is None:
            return None
        events = ctx["events"]
        if ctx["requeues"] > 0:
            # every local event also reached the log (emit falls back
            # to local-only just on a failed mount write), so the log
            # IS the superset — local context only backstops a log
            # that cannot be read back
            logged = ctx["log"].events_for(ctx["trace_id"])
            if logged:
                events = logged
        now = time.time()
        phases = studytrace.fold_phases(events, end_unix=now)
        studytrace.record_study_slo(
            e2e_ms=phases["total_s"] * 1e3,
            queue_wait_ms=phases["queue_wait_s"] * 1e3,
            slo_p99_ms=slo_p99_ms_configured())
        return {
            "trace_id": ctx["trace_id"],
            "worker": self.worker_id,
            "bounces": phases.pop("bounces"),
            "events_n": phases.pop("events_n"),
            "phases": phases,
        }

    # ---- engine pool -----------------------------------------------------

    def _build_engine(self, spec: StudySpec):
        import pyabc_tpu_torch as pt
        return pt.ABCSMC(
            pt.SimpleModel(spec.model),
            spec.prior,
            pt.PNormDistance(p=spec.distance_p),
            population_size=int(spec.population_size),
            eps=pt.QuantileEpsilon(alpha=spec.alpha),
            run_mode=self.run_mode,
            # one-dispatch eligibility needs fused blocks; 4 matches
            # the bench one-dispatch rows
            fuse_generations=4,
            seed=int(spec.seed),
            # SimpleModel ships no low_fidelity(), so "screen" only
            # engages for model classes that do — the flag still enters
            # the engine's compile-cache identity via FidelityConfig
            fidelity=getattr(spec, "fidelity", "off"),
            device=self.device)

    def _engine_for(self, spec: StudySpec, db: str = "sqlite://"):
        """Warm :class:`ABCSMC` for this spec's problem, renewed for
        this study.  A pool hit re-arms the SAME kernel and ladder —
        zero new compiles for eligible repeats."""
        pk = problem_key(spec)
        abc = self._engines.get(pk)
        if abc is not None:
            self._engines.move_to_end(pk)
            REGISTRY.counter(
                "serve_engine_hits_total",
                "studies served on an already-warm engine").inc()
            abc.renew(db, dict(spec.observed), seed=spec.seed)
            return abc
        REGISTRY.counter(
            "serve_engine_builds_total",
            "warm engines built (first study of a problem)").inc()
        abc = self._build_engine(spec)
        abc.new(db, dict(spec.observed))
        self._engines[pk] = abc
        while len(self._engines) > self.max_engines:
            self._engines.popitem(last=False)
            REGISTRY.counter(
                "serve_engine_evictions_total",
                "warm engines dropped by the pool LRU").inc()
        return abc

    # ---- serving ---------------------------------------------------------

    def _finish(self, spec: StudySpec, summary: dict, wall_s: float,
                served_from: str) -> dict:
        summary = dict(summary)
        summary["served_from"] = served_from
        summary["tenant"] = spec.tenant
        summary["wall_ms"] = round(wall_s * 1e3, 3)
        if spec.name:
            summary["name"] = spec.name
        self.served += 1
        self.walls_ms.append(wall_s * 1e3)
        del self.walls_ms[:-512]
        REGISTRY.counter("serve_studies_total",
                         "studies served (cache + device)").inc()
        _tenant_counter(spec.tenant).inc()
        REGISTRY.gauge("serve_last_study_ms",
                       "wall clock of the last served study"
                       ).set(round(wall_s * 1e3, 3))
        return summary

    def serve_spec(self, spec: StudySpec) -> dict:
        """Serve one study: cache, else the engine its content routes
        to — a ``StudyBatch`` of one for lane-eligible specs, the warm
        solo one-dispatch engine otherwise."""
        t0 = time.perf_counter()
        digest = study_digest(spec)
        engine = self._engine_of(spec)
        hit, tier = self._cache_lookup(self._cache_key(digest, engine))
        if hit is not None:
            self._emit(spec, "cache_hit",
                       tier="t2" if tier == "cache_t2" else "t1")
            return self._finish(spec, hit, time.perf_counter() - t0,
                                tier)
        summary = self._dispatch_miss(spec, digest, engine)
        return self._finish(spec, summary, time.perf_counter() - t0,
                            engine)

    def _dispatch_miss(self, spec: StudySpec, digest: str,
                       engine: str) -> dict:
        """Run one miss on its content-routed engine and cache the
        summary under the engine-scoped key."""
        if engine == "multiplex":
            self._emit(spec, "batched", engine="multiplex",
                       batch_key=batch_key(spec)[:12], width=1)
            res = self._run_batch(
                [spec],
                on_built=lambda b: self._emit(
                    spec, "dispatched", **b.trace_info()))[0]
            self._emit(spec, "drained")
            summary = self._batch_summary(spec, res, digest)
        else:
            summary = self._solo_summary(spec, digest)
        tier = self.cache.put(self._cache_key(digest, engine), summary)
        self._emit(spec, "published", tier=tier or "t1")
        return summary

    def _note_batch_program(self, batch: StudyBatch):
        """Program-pool LRU bookkeeping for one resolved batch."""
        if batch.program_cache_hit:
            self._batch_programs.move_to_end(batch.program_key)
            REGISTRY.counter(
                "serve_batch_program_hits_total",
                "study-axis dispatches on an already-built program"
            ).inc()
        else:
            REGISTRY.counter(
                "serve_batch_program_builds_total",
                "study-axis programs built (first batch of a shape)"
            ).inc()
        while len(self._batch_programs) > _MAX_BATCH_PROGRAMS:
            self._batch_programs.popitem(last=False)
            REGISTRY.counter(
                "serve_batch_program_evictions_total",
                "study-axis programs dropped by the pool LRU").inc()

    def _run_batch(self, group: Sequence[StudySpec],
                   on_built=None) -> List[dict]:
        """Dispatch one study-axis batch through the worker's program
        pool — a repeat (batch shape, rung, window) reuses the built
        window program, so sequential eligible studies after the first
        build nothing."""
        from ..autotune import install_compile_listener
        install_compile_listener()
        batch = StudyBatch(group, program_cache=self._batch_programs,
                           device=self.device)
        self._note_batch_program(batch)
        if on_built is not None:
            # the program is resolved (built or pool-warm): the trace's
            # compile phase ends here, the device phase starts with run
            on_built(batch)
        return batch.run()

    @staticmethod
    def _history_summary(spec: StudySpec, digest: str, abc,
                         history) -> dict:
        df, w = history.get_distribution()
        pops = history.get_all_populations()
        names = list(df.columns)
        wn = np.asarray(w, dtype=np.float64)
        mean = {c: float(np.sum(df[c].to_numpy() * wn)) for c in names}
        std = {c: float(np.sqrt(max(np.sum(
            wn * (df[c].to_numpy() - mean[c]) ** 2), 0.0)))
            for c in names}
        return {
            "digest": digest,
            "engine": "solo",
            "gens": int(len(pops)),
            "eps": float(pops["epsilon"].iloc[-1]) if len(pops) else None,
            "n_sims": int(pops["samples"].sum()) if len(pops) else 0,
            "stop_reason": getattr(abc.timeline, "stop_reason", None),
            "population_size": int(spec.population_size),
            "posterior_mean": mean,
            "posterior_std": std,
        }

    def _solo_summary(self, spec: StudySpec, digest: str) -> dict:
        if self.durable:
            return self._durable_solo_summary(spec, digest)
        self._emit(spec, "batched", engine="solo", width=1)
        abc = self._engine_for(spec)
        self._emit(spec, "dispatched")
        history = abc.run(
            minimum_epsilon=float(spec.minimum_epsilon),
            max_nr_populations=int(spec.max_generations),
            min_acceptance_rate=float(spec.min_acceptance_rate))
        self._emit(spec, "drained")
        return self._history_summary(spec, digest, abc, history)

    def _durable_solo_summary(self, spec: StudySpec,
                              digest: str) -> dict:
        """Durable solo path (``PYABC_TPU_SERVE_DURABLE``): the study
        runs on a file-backed DB keyed by its digest, so a worker dying
        mid-study leaves generations behind.  When the scheduler
        bounces the ticket to another worker, that worker finds the DB,
        replays the spill journal (:meth:`ABCSMC.load` →
        ``recover_lazy`` — the checkpoint-splice contract from the
        resilience tier) and continues at ``max_t + 1`` instead of
        generation 0.  The DB and its journal are deleted once the
        summary is cached — results live in the cache, ``studies/``
        holds only in-flight state."""
        os.makedirs(self.studies_dir, exist_ok=True)
        db_path = os.path.join(self.studies_dir, f"{digest}.solo.db")
        db_url = "sqlite:///" + db_path
        self._emit(spec, "batched", engine="solo", width=1)
        resumed_from = 0
        abc = None
        if os.path.exists(db_path):
            try:
                # a fresh (cold) engine: load() rebinds from the DB's
                # own observed stats, which must win over the pool's
                abc = self._build_engine(spec)
                history = abc.load(db_url)
                resumed_from = int(history.max_t) + 1
            except Exception:
                abc, resumed_from = None, 0  # unreadable: start over
            else:
                REGISTRY.counter(
                    "serve_study_resumes_total",
                    "interrupted durable studies resumed from their "
                    "journaled generation").inc()
                self._emit(spec, "rescued",
                           resumed_from_gen=resumed_from)
        if abc is None:
            abc = self._engine_for(spec, db=db_url)
            history = abc.history
        self._emit(spec, "dispatched")
        remaining = int(spec.max_generations) - resumed_from
        if remaining > 0:
            history = abc.run(
                minimum_epsilon=float(spec.minimum_epsilon),
                max_nr_populations=remaining,
                min_acceptance_rate=float(spec.min_acceptance_rate))
        self._emit(spec, "drained")
        summary = self._history_summary(spec, digest, abc, history)
        if resumed_from:
            summary["resumed_from_gen"] = resumed_from
        try:
            history.close()
        except Exception:
            pass
        try:
            os.unlink(db_path)
        except OSError:
            pass
        from ..resilience.journal import purge_for_db
        purge_for_db(db_path)
        return summary

    def _batch_summary(self, spec: StudySpec, res: dict,
                       digest: str) -> dict:
        names = spec.prior.get_parameter_names()
        theta = np.asarray(res["theta"], dtype=np.float64)
        w = np.asarray(res["w"], dtype=np.float64)
        mean = {c: float(np.sum(theta[:, i] * w))
                for i, c in enumerate(names)}
        std = {c: float(np.sqrt(max(np.sum(
            w * (theta[:, i] - mean[c]) ** 2), 0.0)))
            for i, c in enumerate(names)}
        return {
            "digest": digest,
            "engine": "multiplex",
            "gens": int(res["gens"]),
            "eps": float(res["eps"]),
            # exact for this engine: every active rejection round
            # simulates pop candidates, plus the generation-0 draw
            "n_sims": int(res["rounds"]) * int(spec.population_size)
            + int(spec.population_size),
            "stop_reason": STOP_NAMES[int(res["stop_code"])],
            "population_size": int(spec.population_size),
            "posterior_mean": mean,
            "posterior_std": std,
        }

    def serve_many(self, specs: Sequence[StudySpec]) -> List[dict]:
        """Serve a claimed batch: cache hits first, then every
        lane-eligible miss through the study axis (grouped by
        ``batch_key``; a group of one is a batch of one — the engine,
        and therefore the result bits, never depend on co-traffic),
        then warm solo runs for the rest."""
        out: List[Optional[dict]] = [None] * len(specs)
        misses: List[Tuple[int, StudySpec, str]] = []
        waiters: List[Tuple[int, StudySpec, str]] = []
        seen_digests = set()
        for i, spec in enumerate(specs):
            t0 = time.perf_counter()
            digest = study_digest(spec)
            if digest in seen_digests:
                # in-batch duplicate: its original is being served in
                # THIS call — fill it from the cache afterwards rather
                # than dispatching the same study twice
                waiters.append((i, spec, digest))
                continue
            hit, tier = self._cache_lookup(
                self._cache_key(digest, self._engine_of(spec)))
            if hit is not None:
                self._emit(spec, "cache_hit",
                           tier="t2" if tier == "cache_t2" else "t1")
                out[i] = self._finish(
                    spec, hit, time.perf_counter() - t0, tier)
            else:
                seen_digests.add(digest)
                misses.append((i, spec, digest))
        lanes = [(i, s, d) for i, s, d in misses if lane_eligible(s)]
        solos = [(i, s, d) for i, s, d in misses
                 if not lane_eligible(s)]
        if lanes:
            by_id = {id(s): (i, d) for i, s, d in lanes}
            for group in multiplex_eligible([s for _i, s, _d in lanes]):
                t0 = time.perf_counter()
                for spec in group:
                    self._emit(spec, "batched", engine="multiplex",
                               batch_key=batch_key(spec)[:12],
                               width=len(group))
                results = self._run_batch(
                    group,
                    on_built=lambda b: [
                        self._emit(s, "dispatched", **b.trace_info())
                        for s in b.specs])
                wall = time.perf_counter() - t0
                for spec in group:
                    self._emit(spec, "drained")
                REGISTRY.counter(
                    "serve_multiplexed_studies_total",
                    "studies served fused on the study axis"
                ).inc(len(group))
                for spec, res in zip(group, results):
                    i, digest = by_id[id(spec)]
                    summary = self._batch_summary(spec, res, digest)
                    tier = self.cache.put(
                        self._cache_key(digest, "multiplex"), summary)
                    self._emit(spec, "published", tier=tier or "t1")
                    out[i] = self._finish(
                        spec, summary, wall / len(group), "multiplex")
        for i, spec, digest in solos:
            t0 = time.perf_counter()
            summary = self._solo_summary(spec, digest)
            tier = self.cache.put(self._cache_key(digest, "solo"),
                                  summary)
            self._emit(spec, "published", tier=tier or "t1")
            out[i] = self._finish(
                spec, summary, time.perf_counter() - t0, "solo")
        for i, spec, digest in waiters:
            t0 = time.perf_counter()
            engine = self._engine_of(spec)
            hit, tier = self._cache_lookup(
                self._cache_key(digest, engine))
            if hit is not None:
                self._emit(spec, "cache_hit",
                           tier="t2" if tier == "cache_t2" else "t1")
                out[i] = self._finish(
                    spec, hit, time.perf_counter() - t0, tier)
            else:  # original evicted between put and here: serve it
                summary = self._dispatch_miss(spec, digest, engine)
                out[i] = self._finish(
                    spec, summary, time.perf_counter() - t0, engine)
        return [s for s in out if s is not None]

    # ---- continuous batching (the windowed queue loop) -------------------

    def _serve_static(self, queue: StudyQueue,
                      loaded: Sequence[Tuple[Ticket, StudySpec]]):
        """Serve one claimed batch statically (``serve_many``) and
        settle every ticket at batch drain — the pre-CB data plane,
        still the path for solo-routed work and ``PYABC_TPU_SERVE_CB=0``."""
        t0 = time.perf_counter()
        try:
            summaries = self.serve_many([s for _tk, s in loaded])
        except Exception as exc:
            for tk, s in loaded:
                queue.fail(tk, repr(exc), trace=self._trace_fold(s))
            return
        wall = time.perf_counter() - t0
        for (tk, s), summary in zip(loaded, summaries):
            queue.complete(tk, wall_s=wall,
                           engine=summary.get("served_from", "solo"),
                           trace=self._trace_fold(s))

    def _serve_continuous(self, queue: StudyQueue,
                          loaded: Sequence[Tuple[Ticket, StudySpec]]):
        """Serve one claimed batch with continuous batching: every
        lane-eligible miss joins a windowed ``StudyBatch`` session
        (:meth:`_cb_session`) whose lanes retire, publish and refill at
        window boundaries; cache hits, in-claim duplicates and
        solo-routed work ride the static path unchanged."""
        lanes: List[Tuple[Ticket, StudySpec, str]] = []
        static: List[Tuple[Ticket, StudySpec]] = []
        seen = set()
        for tk, spec in loaded:
            digest = study_digest(spec)
            if not lane_eligible(spec) or digest in seen:
                static.append((tk, spec))
                continue
            hit, tier = self._cache_lookup(
                self._cache_key(digest, "multiplex"))
            if hit is not None:
                t0 = time.perf_counter()
                self._emit(spec, "cache_hit",
                           tier="t2" if tier == "cache_t2" else "t1")
                summary = self._finish(
                    spec, hit, time.perf_counter() - t0, tier)
                queue.complete(tk, wall_s=time.perf_counter() - t0,
                               engine=tier,
                               trace=self._trace_fold(spec))
                continue
            seen.add(digest)
            lanes.append((tk, spec, digest))
        by_id = {id(s): (tk, d) for tk, s, d in lanes}
        for group in multiplex_eligible([s for _tk, s, _d in lanes]):
            self._cb_session(queue, [(by_id[id(s)][0], s,
                                      by_id[id(s)][1])
                                     for s in group])
            if self.draining:
                break
        if static and not self.draining:
            self._serve_static(queue, static)

    def _cb_publish_lane(self, queue: StudyQueue, batch: StudyBatch,
                         slot: int, tk: Ticket, spec: StudySpec,
                         digest: str, t0: float):
        """Retire one finished lane at its OWN window boundary: result
        extracted, cached, trace-``published``, ticket tombstoned —
        the early publish that takes a lane's client latency from
        O(longest peer) to O(own run + one window)."""
        res = batch.result(slot)
        batch.retire(slot)
        summary = self._batch_summary(spec, res, digest)
        self._emit(spec, "drained")
        tier = self.cache.put(
            self._cache_key(digest, "multiplex"), summary)
        self._emit(spec, "published", tier=tier or "t1")
        self._emit(spec, "lane_retired", slot=slot,
                   windows=batch.windows)
        REGISTRY.counter(
            "serve_multiplexed_studies_total",
            "studies served fused on the study axis").inc()
        REGISTRY.counter(
            "serve_cb_lane_turnovers_total",
            "lanes retired at a window boundary (continuous "
            "batching)").inc()
        wall = time.perf_counter() - t0
        self._finish(spec, summary, wall, "multiplex")
        queue.complete(tk, wall_s=wall, engine="multiplex",
                       trace=self._trace_fold(spec))

    def _cb_admit_lane(self, batch: StudyBatch, lanes: dict,
                       tk: Ticket, spec: StudySpec, digest: str):
        """Seat one study in a free lane and emit its join events."""
        slot = batch.admit(spec)
        lanes[slot] = (tk, spec, digest, time.perf_counter())
        self._emit(spec, "batched", engine="multiplex",
                   batch_key=batch.key[:12], width=batch.occupied())
        self._emit(spec, "lane_joined", slot=slot,
                   window=batch.windows)
        self._emit(spec, "dispatched", **batch.trace_info())

    def _cb_refill(self, queue: StudyQueue, batch: StudyBatch,
                   lanes: dict) -> bool:
        """Claim one same-``batch_key`` pending study into a free lane
        (the keyed claim keeps incompatible work for other workers).
        A claimed duplicate of an already-published digest completes
        straight from the cache without burning a lane; a duplicate of
        a still-running lane gets its own lane — bit-identity makes
        the two results equal, so correctness never depends on dedup.
        Returns False when no matching work is pending."""
        tk = queue.claim(self.worker_id, batch_key=batch.key)
        if tk is None:
            return False
        try:
            spec = tk.load_spec()
        except Exception as exc:  # poison ticket
            queue.fail(tk, f"unpicklable spec: {exc!r}")
            return True
        digest = study_digest(spec)
        self._trace_begin(queue, [(tk, spec)])
        hit, tier = self._cache_lookup(
            self._cache_key(digest, "multiplex"))
        if hit is not None:
            t0 = time.perf_counter()
            self._emit(spec, "cache_hit",
                       tier="t2" if tier == "cache_t2" else "t1")
            self._finish(spec, hit, time.perf_counter() - t0, tier)
            queue.complete(tk, wall_s=time.perf_counter() - t0,
                           engine=tier, trace=self._trace_fold(spec))
            return True
        self._cb_admit_lane(batch, lanes, tk, spec, digest)
        return True

    def _cb_session(self, queue: StudyQueue,
                    group: Sequence[Tuple[Ticket, StudySpec, str]]):
        """One continuous-batching session: window dispatches over one
        ``batch_key``'s built window program, retiring finished lanes and
        admitting queued same-key studies between windows — zero new
        program builds on lane turnover (the program pool key is
        (batch_key, rung, window, rounds); budgets are operands).

        Drain (SIGTERM) finishes the CURRENT window, publishes the
        lanes that stopped, and leaves unfinished lanes claimed for
        ``run_forever``'s requeue — retired lanes' publishes survive,
        unfinished studies bounce whole.  A session that dies on an
        exception fails every unfinished lane's ticket (retired lanes
        keep their tombstones)."""
        from ..autotune import install_compile_listener
        install_compile_listener()
        batch = StudyBatch([s for _tk, s, _d in group],
                           program_cache=self._batch_programs,
                           device=self.device)
        self._note_batch_program(batch)
        hyst = ShapeHysteresis()
        lanes: dict = {}
        now = time.perf_counter()
        for slot, (tk, spec, digest) in enumerate(group):
            lanes[slot] = (tk, spec, digest, now)
            self._emit(spec, "batched", engine="multiplex",
                       batch_key=batch.key[:12], width=len(group))
            self._emit(spec, "lane_joined", slot=slot, window=0)
            self._emit(spec, "dispatched", **batch.trace_info())
        try:
            while lanes:
                finished = batch.step_window()
                REGISTRY.counter(
                    "serve_cb_windows_total",
                    "continuous-batching window dispatches").inc()
                for slot in finished:
                    tk, spec, digest, t0 = lanes.pop(slot)
                    self._cb_publish_lane(queue, batch, slot, tk,
                                          spec, digest, t0)
                # chaos hook: a kill here lands BETWEEN windows —
                # after this window's publishes are durable, before
                # the next refill/dispatch (tools/chaos_soak.py "cb")
                fault_point(SITE_SERVE_WINDOW,
                            data={"window": batch.windows})
                if not lanes or self.draining:
                    break
                while batch.free_slots():
                    if not self._cb_refill(queue, batch, lanes):
                        break
                if hyst.observe(batch.occupied(), batch.rung):
                    batch, slot_map = batch.shrink(
                        program_cache=self._batch_programs)
                    self._note_batch_program(batch)
                    lanes = {slot_map[i]: v for i, v in lanes.items()}
                    REGISTRY.counter(
                        "serve_cb_shrinks_total",
                        "batch-shape shrinks after sustained "
                        "underfill (hysteresis)").inc()
                REGISTRY.gauge(
                    "serve_cb_occupancy",
                    "occupied fraction of the open batch's lanes"
                ).set(round(batch.occupancy(), 4))
        except Exception as exc:
            for slot, (tk, spec, _digest, _t0) in list(lanes.items()):
                queue.fail(tk, repr(exc),
                           trace=self._trace_fold(spec))
            lanes.clear()
        finally:
            # drained mid-run: unfinished lanes stay claimed; their
            # tickets bounce via run_forever's requeue_worker and the
            # local trace contexts are dropped (the rescue worker
            # starts its own)
            for slot, (tk, spec, _digest, _t0) in lanes.items():
                self._trace_ctx.pop(id(spec), None)

    # ---- queue loop ------------------------------------------------------

    def drain(self):
        """Start a graceful drain (idempotent; signal-safe)."""
        self._draining.set()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def install_signal_handlers(self):
        signal.signal(signal.SIGTERM, lambda _s, _f: self.drain())
        signal.signal(signal.SIGINT, lambda _s, _f: self.drain())

    def _snapshot_gauges(self, queue: StudyQueue):
        REGISTRY.gauge("serve_queue_depth",
                       "pending studies in the serve queue"
                       ).set(queue.depth())
        pdepths = queue.partition_depths()
        REGISTRY.gauge("serve_partitions",
                       "configured queue partitions (shard count)"
                       ).set(queue.partitions)
        REGISTRY.gauge("serve_partition_depth_max",
                       "deepest queue partition (the hot shard)"
                       ).set(max(pdepths) if pdepths else 0)
        for i, d in enumerate(pdepths):
            REGISTRY.gauge(
                f"serve_partition_p{i:04d}_depth",
                "pending studies in one queue partition").set(d)
        REGISTRY.gauge("serve_engines_warm",
                       "warm engines held by this worker"
                       ).set(len(self._engines))
        stats = self.cache.stats()
        REGISTRY.gauge("serve_cache_hit_ratio",
                       "study cache hit ratio since worker start"
                       ).set(round(stats["hit_ratio"], 4))
        if "hit_ratio_t1" in stats:
            REGISTRY.gauge(
                "serve_cache_hit_ratio_t1",
                "tier-1 (worker LRU) share of cache lookups"
            ).set(round(stats["hit_ratio_t1"], 4))
            REGISTRY.gauge(
                "serve_cache_hit_ratio_t2",
                "tier-2 (shared store) share of cache lookups"
            ).set(round(stats["hit_ratio_t2"], 4))
        # publish this worker's rolling served-latency snapshot for
        # the admission controller's fleet-p99 read (throttled; a
        # failed publish never fails a serve)
        now = time.time()
        if self.walls_ms and now - self._last_slo_pub >= 2.0:
            publish_latency_snapshot(self.root, self.worker_id,
                                     self.walls_ms)
            self._last_slo_pub = now

    def run_forever(self, queue: Optional[StudyQueue] = None,
                    poll_s: float = 0.5,
                    max_studies: Optional[int] = None,
                    once: bool = False) -> int:
        """Claim/serve until drained (or ``max_studies`` / one empty
        poll with ``once``).  Returns the number of studies served by
        this call.  On drain, every still-claimed study is requeued."""
        queue = queue or StudyQueue(root=self.root)
        served0 = self.served
        # ride the fleet telemetry mount when a run dir is advertised:
        # serve_* counters land in snapshots for abc-top / /api/serve /
        # the Prometheus exporter
        from ..parallel import health
        from ..telemetry import aggregate
        publisher = aggregate.publisher_from_env()
        # heartbeat into the run dir and renew claim leases on the same
        # thread: the scheduler joins hb_<host>_<pid> to this worker's
        # claimed/ directory, and a worker that stops beating stops
        # renewing — one liveness signal, two consumers
        hb = None
        rd = health.run_dir()
        if rd is not None:
            hb = health.Heartbeat(
                rd, on_beat=lambda: queue.renew_leases(self.worker_id)
            ).start()
        clean_exit = False
        try:
            while not self.draining:
                if (max_studies is not None
                        and self.served - served0 >= max_studies):
                    break
                tickets: List[Ticket] = []
                head = queue.claim(self.worker_id)
                if head is None:
                    self._snapshot_gauges(queue)
                    # fallback GC for scheduler-less deployments; the
                    # authoritative sweep runs from Scheduler.tick()
                    # (a busy fleet never reaches this branch)
                    queue.sweep()
                    if once:
                        break
                    time.sleep(poll_s)
                    continue
                tickets.append(head)
                while len(tickets) < multiplex_width():
                    more = queue.claim(self.worker_id)
                    if more is None:
                        break
                    tickets.append(more)
                if self.draining:
                    break  # finally-block requeues the claims
                loaded = []
                for tk in tickets:
                    try:
                        loaded.append((tk, tk.load_spec()))
                    except Exception as exc:  # poison ticket
                        queue.fail(tk, f"unpicklable spec: {exc!r}")
                if not loaded:
                    continue
                self._trace_begin(queue, loaded)
                if cb_enabled():
                    # continuous batching: lane-eligible misses join a
                    # windowed batch that retires/publishes/refills at
                    # window boundaries (claiming MORE same-key work
                    # mid-batch); everything else rides the static path
                    self._serve_continuous(queue, loaded)
                else:
                    self._serve_static(queue, loaded)
                self._snapshot_gauges(queue)
                if publisher is not None:
                    publisher.publish()
            clean_exit = True
        finally:
            if hb is not None:
                # clean exit deregisters; an exception leaves the last
                # heartbeat so the fleet sees STALE, not silently absent
                hb.stop(remove=clean_exit)
            requeued = queue.requeue_worker(self.worker_id)
            if requeued:
                REGISTRY.gauge(
                    "serve_drain_requeued",
                    "studies requeued by the last drain").set(requeued)
            self._snapshot_gauges(queue)
            if publisher is not None:
                publisher.publish(force=True)
        return self.served - served0


def main(argv=None):
    """``python -m pyabc_tpu_torch.serve.worker``: the JAX package's
    ``abc-serve`` options (argparse: the card machine has no click), and
    ``--device``."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="pyabc_tpu_torch.serve.worker",
        description="Persistent warm study server on this card.")
    ap.add_argument("--serve-dir", default=None,
                    help="Serve root (default $PYABC_TPU_SERVE_DIR, else "
                         "$PYABC_TPU_RUN_DIR/serve).")
    ap.add_argument("--worker-id", default=None,
                    help="Stable worker identity (default host_pid).")
    ap.add_argument("--poll-s", type=float, default=0.5,
                    help="Idle poll interval (default 0.5).")
    ap.add_argument("--max-studies", type=int, default=None,
                    help="Exit after serving this many studies.")
    ap.add_argument("--once", action="store_true",
                    help="Drain the current queue once and exit.")
    ap.add_argument("--durable", action="store_true", default=None,
                    help="Durable solo studies: file-backed DBs under "
                         "<serve root>/studies/ so interrupted studies "
                         "resume (default $PYABC_TPU_SERVE_DURABLE).")
    ap.add_argument("--device", default=None,
                    help="Device of the engines (default: the card).")
    args = ap.parse_args(argv)
    worker = ServeWorker(root=args.serve_dir, worker_id=args.worker_id,
                         durable=args.durable, device=args.device)
    worker.install_signal_handlers()
    queue = StudyQueue(root=worker.root)
    n = worker.run_forever(queue, poll_s=args.poll_s,
                           max_studies=args.max_studies, once=args.once)
    print(f"served {n} studies "
          f"({'drained' if worker.draining else 'done'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
