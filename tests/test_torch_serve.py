"""Twins of ``tests/test_serve.py`` for the port's serving tier, and its
parity with the JAX package.

The queue, shard, admission, cache and worker tests are the JAX
package's, run against ``pyabc_tpu_torch.serve`` on the CPU (the model
is the quickstart simulator written for torch).  The warm solo test uses
seeds 1 and 4: like the JAX test's seeds, they keep the batch ladder on
rungs the first study already built (seeds 2 and 3 move the port to a
new rung, and such a study legitimately builds one engine).

Parity with the JAX package:

- ``study_digest`` and ``problem_key`` of one declaration (one model
  callable, a uniform, a normal and a truncated prior) are equal in both
  packages, so are the ``_prior_config`` lists and the ``shards``
  placement of a digest;
- the study axis's deterministic part: the JAX ``StudyBatch`` runs one
  window at pop 100 and 1000, its lane is carried into the port with
  ``convert.lane_carry_to_torch``, and from that population the port's
  weighted quantile equals the JAX ε exactly, and its importance weights
  (the denominator through K1's plain version) match the JAX ``new_w``
  within atol 1e-6 + rtol 1e-5.  The two differ by float32 rounding
  only: K1 forms each logit from whitened, centred differences, the JAX
  expression from raw ones (measured: at most 1e-6 relative);
- sampled: both packages' ``StudyBatch`` on the same three specs pass
  the posterior-mean gate ``|mean - y| < 0.15``, and under the
  generation budget both stop at the same generation with the same stop
  code.
"""

import base64
import functools
import json
import os
import pickle
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.sampler.fused import lane_extract as jax_lane_extract
from pyabc_tpu.serve import StudyBatch as JaxStudyBatch
from pyabc_tpu.serve import StudySpec as JaxStudySpec
from pyabc_tpu.serve import problem_key as jax_problem_key
from pyabc_tpu.serve import shards as jax_shards
from pyabc_tpu.serve import study_digest as jax_study_digest
from pyabc_tpu.serve.spec import _prior_config as jax_prior_config
from pyabc_tpu_torch.convert import lane_carry_to_torch
from pyabc_tpu_torch.serve import (QueueFull, ServeWorker, SpecAuthError,
                                   StudyBatch, StudyCache, StudyQueue,
                                   StudySpec, TenantQuotaExceeded,
                                   problem_key, shards, study_digest)
from pyabc_tpu_torch.serve.multiplex import (STOP_NAMES, _LaneEngine,
                                             lane_seed)
from pyabc_tpu_torch.serve.queue import serve_root
from pyabc_tpu_torch.serve.spec import _prior_config

from torch_process_state import clean_process_state  # noqa: F401

#: the importance weights' tolerance against the JAX expression
W_ATOL, W_RTOL = 1e-6, 1e-5

_worker = functools.partial(ServeWorker, device="cpu")
_batch = functools.partial(StudyBatch, device="cpu")


def _model(generator, theta):
    """Quickstart-shaped simulator; module-level because queue
    submissions pickle the spec, like a tenant's importable model."""
    noise = 0.1 * torch.randn(theta.shape[0], 1, generator=generator,
                              device=theta.device)
    return {"y": theta[:, :1] + noise}


def _jax_model(key, theta):
    noise = 0.1 * jax.random.normal(key, (theta.shape[0], 1))
    return {"y": theta[:, :1] + noise}


def _spec(pop=100, seed=0, tenant="default", y=0.4, **kw):
    return StudySpec(
        model=_model,
        prior=pt.Distribution(mu=pt.RV("uniform", -1.0, 2.0)),
        observed={"y": float(y)}, population_size=pop,
        seed=seed, tenant=tenant,
        max_generations=kw.pop("max_generations", 3), **kw)


def _jax_spec(pop=100, seed=0, y=0.4, **kw):
    return JaxStudySpec(
        model=_jax_model,
        prior=jpt.Distribution(mu=jpt.RV("uniform", -1.0, 2.0)),
        observed={"y": float(y)}, population_size=pop, seed=seed,
        max_generations=kw.pop("max_generations", 3), **kw)


# ---------------------------------------------------------------------------
# admission queue
# ---------------------------------------------------------------------------

def test_queue_backpressure(tmp_path):
    q = StudyQueue(root=str(tmp_path), max_depth=3, tenant_quota=10)
    for seed in range(3):
        q.submit(_spec(seed=seed))
    with pytest.raises(QueueFull):
        q.submit(_spec(seed=99))
    assert q.depth() == 3


def test_tenant_quota_isolates_tenants(tmp_path):
    q = StudyQueue(root=str(tmp_path), max_depth=100, tenant_quota=2)
    q.submit(_spec(seed=0, tenant="noisy"))
    q.submit(_spec(seed=1, tenant="noisy"))
    with pytest.raises(TenantQuotaExceeded):
        q.submit(_spec(seed=2, tenant="noisy"))
    # the quota is per tenant — another tenant is still admitted
    q.submit(_spec(seed=0, tenant="quiet"))
    assert q.stats()["pending_by_tenant"] == {"noisy": 2, "quiet": 1}


def test_claim_orders_by_aged_priority(tmp_path):
    # aging so slow it cannot matter: raw priority decides.  ONE
    # partition: the strict-order contract is per partition (claim
    # order across partitions is rotation-approximate by design)
    q = StudyQueue(root=str(tmp_path), aging_s=1e9, partitions=1)
    low = q.submit(_spec(seed=0, priority=0))
    high = q.submit(_spec(seed=1, priority=5))
    assert q.claim("w1").id == high.id
    assert q.claim("w1").id == low.id
    assert q.claim("w1") is None


def test_aging_lets_old_low_priority_win(tmp_path):
    q = StudyQueue(root=str(tmp_path), aging_s=30.0, partitions=1)
    old = q.submit(_spec(seed=0, priority=0))
    q.submit(_spec(seed=1, priority=5))
    # age the low-priority ticket by 10 aging intervals on disk —
    # effective priority 0 + 300/30 = 10 beats a fresh 5
    with open(old.path, encoding="utf-8") as f:
        payload = json.load(f)
    payload["submitted_unix"] -= 300.0
    with open(old.path, "w", encoding="utf-8") as f:
        json.dump(payload, f)
    assert q.claim("w1").id == old.id


def test_requeue_keeps_age_and_counts_bounces(tmp_path):
    q = StudyQueue(root=str(tmp_path))
    t = q.submit(_spec(seed=0))
    submitted = t.submitted_unix
    claimed = q.claim("w1")
    assert claimed.id == t.id
    assert q.depth() == 0
    q.requeue(claimed)
    (back,) = q.pending()
    assert back.requeues == 1
    assert back.submitted_unix == pytest.approx(submitted)


def test_requeue_worker_sweeps_all_claims(tmp_path):
    q = StudyQueue(root=str(tmp_path))
    for seed in range(2):
        q.submit(_spec(seed=seed))
    assert q.claim("w1") is not None
    assert q.claim("w1") is not None
    assert q.depth() == 0
    assert q.requeue_worker("w1") == 2
    assert q.depth() == 2
    assert q.requeue_worker("w1") == 0


# ---------------------------------------------------------------------------
# sharded queue + admission shedding
# ---------------------------------------------------------------------------

def test_sharded_placement_is_digest_stable(tmp_path):
    """Every pending ticket lives in exactly the partition its digest
    hashes to — and equal content ALWAYS lands in the same partition
    (the locality the tier-2 cache and hot-bucket shedding rely on)."""
    from pyabc_tpu_torch.serve import shards
    q = StudyQueue(root=str(tmp_path), partitions=4)
    specs = [_spec(seed=s, tenant=f"t{s % 2}") for s in range(8)]
    for spec in specs:
        t = q.submit(spec)
        part = shards.partition_of(study_digest(spec), q.partitions)
        assert os.path.exists(os.path.join(
            q.root, "pending", shards.partition_name(part),
            f"{t.id}.json"))
    assert q.depth() == 8
    assert sum(q.partition_depths()) == 8
    # same digest, fresh submission (new id): same partition
    dup = _spec(seed=0, tenant="t0")
    t2 = q.submit(dup)
    part = shards.partition_of(study_digest(dup), q.partitions)
    assert os.path.exists(os.path.join(
        q.root, "pending", shards.partition_name(part),
        f"{t2.id}.json"))


def test_sharded_claim_never_double_claims(tmp_path):
    """Two workers draining a sharded queue see disjoint tickets and
    between them see EVERY ticket (rename atomicity per partition)."""
    q = StudyQueue(root=str(tmp_path), partitions=4)
    submitted = {q.submit(_spec(seed=s)).id for s in range(10)}
    got = {"wa": set(), "wb": set()}
    while True:
        before = sum(len(v) for v in got.values())
        for wid in got:
            t = q.claim(wid)
            if t is not None:
                got[wid].add(t.id)
        if sum(len(v) for v in got.values()) == before:
            break
    assert not got["wa"] & got["wb"]
    assert got["wa"] | got["wb"] == submitted


def test_migrate_layout_loses_zero_tickets(tmp_path):
    """A flat (pre-sharding) pending/ layout is migrated into
    partition dirs losing nothing, and an in-progress submission (a
    .tmp not yet renamed) is left alone rather than destroyed."""
    q = StudyQueue(root=str(tmp_path), partitions=4)
    tickets = [q.submit(_spec(seed=s)) for s in range(6)]
    # rewind the layout: drop every ticket back into the flat root
    for t in tickets:
        for sub in os.listdir(os.path.join(q.root, "pending")):
            p = os.path.join(q.root, "pending", sub, f"{t.id}.json")
            if os.path.exists(p):
                os.rename(p, os.path.join(q.root, "pending",
                                          f"{t.id}.json"))
    torn = os.path.join(q.root, "pending", "torn.json.tmp")
    with open(torn, "w", encoding="utf-8") as f:
        f.write("{not json")
    assert q.migrate_layout() == 6
    assert q.depth() == 6
    assert os.path.exists(torn)  # skipped, not eaten
    drained = set()
    while True:
        t = q.claim("w1")
        if t is None:
            break
        drained.add(t.id)
    assert drained == {t.id for t in tickets}


def test_shed_is_distinct_from_quota(tmp_path):
    """Depth shedding raises ServeOverloaded (a QueueFull subclass,
    NOT a tenant-quota error) with a computed retry_after_s scaled by
    the overload ratio."""
    from pyabc_tpu_torch.serve import AdmissionController, ServeOverloaded
    q = StudyQueue(root=str(tmp_path), partitions=1,
                   admission=AdmissionController(
                       str(tmp_path), slo_depth=2, retry_s=2.0))
    q.submit(_spec(seed=0))
    q.submit(_spec(seed=1))
    with pytest.raises(ServeOverloaded) as err:
        q.submit(_spec(seed=2))
    assert isinstance(err.value, QueueFull)
    assert not isinstance(err.value, TenantQuotaExceeded)
    assert err.value.reason == "depth"
    assert err.value.retry_after_s == pytest.approx(2.0)
    assert q.depth() == 2
    # drain below the SLO: admission opens again
    assert q.claim("w1") is not None
    q.submit(_spec(seed=2))


def test_p99_shed_reads_fleet_snapshots(tmp_path):
    """Latency shedding closes the loop on the workers' published
    rolling p99 — and ignores stale snapshots from dead workers."""
    from pyabc_tpu_torch.serve.admission import (AdmissionController,
                                           ServeOverloaded,
                                           publish_latency_snapshot)
    root = str(tmp_path)
    adm = AdmissionController(root, slo_p99_ms=100.0, retry_s=1.0)
    adm.check(0)  # no snapshots: no shed
    publish_latency_snapshot(root, "w_slow", [250.0] * 20)
    with pytest.raises(ServeOverloaded) as err:
        adm.check(0)
    assert err.value.reason == "p99"
    assert err.value.retry_after_s == pytest.approx(2.5)
    # the slow worker dies; its last word goes stale and stops mattering
    publish_latency_snapshot(root, "w_slow", [250.0] * 20,
                             now=time.time() - 3600)
    adm.check(0)


def test_serve_root_resolution(tmp_path, monkeypatch):
    monkeypatch.delenv("PYABC_TPU_SERVE_DIR", raising=False)
    monkeypatch.delenv("PYABC_TPU_RUN_DIR", raising=False)
    assert serve_root("/explicit") == "/explicit"
    monkeypatch.setenv("PYABC_TPU_RUN_DIR", str(tmp_path / "run"))
    assert serve_root() == str(tmp_path / "run" / "serve")
    monkeypatch.setenv("PYABC_TPU_SERVE_DIR", str(tmp_path / "srv"))
    assert serve_root() == str(tmp_path / "srv")


# ---------------------------------------------------------------------------
# content addressing
# ---------------------------------------------------------------------------

def test_digest_moves_with_every_posterior_knob():
    base = _spec(pop=100, seed=0, y=0.4)
    d0 = study_digest(base)
    assert d0 == study_digest(_spec(pop=100, seed=0, y=0.4))
    # tenant/priority/name are routing, not inference
    assert d0 == study_digest(_spec(pop=100, seed=0, y=0.4,
                                    tenant="other", priority=7,
                                    name="x"))
    perturbed = [
        _spec(pop=101, seed=0, y=0.4),
        _spec(pop=100, seed=1, y=0.4),
        _spec(pop=100, seed=0, y=0.41),
        _spec(pop=100, seed=0, y=0.4, alpha=0.4),
        _spec(pop=100, seed=0, y=0.4, minimum_epsilon=0.01),
        _spec(pop=100, seed=0, y=0.4, max_generations=4),
    ]
    digests = [study_digest(s) for s in perturbed]
    assert d0 not in digests
    assert len(set(digests)) == len(digests)


def test_cache_hit_miss_eviction_and_disk_spill(tmp_path):
    cache = StudyCache(capacity=2, root=str(tmp_path))
    assert cache.get("a" * 64) is None  # miss
    cache.put("a" * 64, {"x": 1})
    cache.put("b" * 64, {"x": 2})
    assert cache.get("a" * 64) == {"x": 1}  # hit
    cache.put("c" * 64, {"x": 3})  # evicts lru ("b")
    stats = cache.stats()
    assert (stats["hits"], stats["misses"], stats["evictions"]) \
        == (1, 1, 1)
    # a fresh cache over the same root re-hits from the JSON spill
    again = StudyCache(capacity=2, root=str(tmp_path))
    assert again.get("b" * 64) == {"x": 2}


def test_spill_corruption_degrades_to_miss(tmp_path):
    """A torn/bit-rotted tier-1 spill is detected by its CRC frame and
    degrades to a miss (recompute), never a crash or a wrong result."""
    cache = StudyCache(capacity=4, root=str(tmp_path))
    cache.put("a" * 64, {"x": 1})
    cache.put("b" * 64, {"x": 2})
    (spill_a,) = [p for p in os.listdir(str(tmp_path))
                  if p.startswith("a")]
    with open(os.path.join(str(tmp_path), spill_a), "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        f.seek(size // 2)
        f.write(b"\xff\xff\xff\xff")
    fresh = StudyCache(capacity=4, root=str(tmp_path))
    assert fresh.get("a" * 64) is None  # corrupt: miss, file reaped
    assert fresh.get("b" * 64) == {"x": 2}  # intact neighbor survives
    assert not os.path.exists(os.path.join(str(tmp_path), spill_a))


def test_shared_store_single_writer_and_crc(tmp_path):
    """Tier-2 publish is first-writer-wins (a racing duplicate is a
    counted collision, not an overwrite) and reads are CRC-verified."""
    from pyabc_tpu_torch.serve.cache import SharedResultStore
    store = SharedResultStore(str(tmp_path))
    assert store.publish("k" * 64, {"mean": 1.0})
    assert not store.publish("k" * 64, {"mean": 2.0})  # collision
    assert store.get("k" * 64) == {"mean": 1.0}  # first writer kept
    ok, corrupt = store.verify_all()
    assert (ok, corrupt) == (1, 0)
    # bit-rot the entry: the CRC catches it and the read degrades to
    # a miss (dispatch fallback), reaping the bad file
    (entry,) = [p for p in os.listdir(str(tmp_path))
                if p.endswith(".json")]
    path = os.path.join(str(tmp_path), entry)
    with open(path, "r+b") as f:
        f.seek(10)
        f.write(b"\xff\xff")
    assert store.get("k" * 64) is None
    assert not os.path.exists(path)


def test_tiered_cache_promotes_t2_hits(tmp_path):
    """A tier-2 hit is promoted into tier-1: the second lookup of the
    same key is a local LRU hit with no shared-store read."""
    from pyabc_tpu_torch.serve.cache import TieredStudyCache
    shared = str(tmp_path / "shared")
    a = TieredStudyCache(capacity=8, root=str(tmp_path / "a"),
                         shared_root=shared)
    b = TieredStudyCache(capacity=8, root=str(tmp_path / "b"),
                         shared_root=shared)
    a.put("k" * 64, {"mean": 3.0})
    summary, tier = b.lookup("k" * 64)
    assert (summary, tier) == ({"mean": 3.0}, "t2")
    summary, tier = b.lookup("k" * 64)
    assert (summary, tier) == ({"mean": 3.0}, "t1")
    stats = b.stats()
    assert stats["t2_hits"] == 1 and stats["t1_hits"] == 1
    assert b.lookup("z" * 64) == (None, None)


# ---------------------------------------------------------------------------
# the study axis: bit identity
# ---------------------------------------------------------------------------

def test_multiplex_lane_is_isolated_from_co_tenants():
    """The isolation contract: a lane's result is bitwise identical no
    matter WHAT shares the batch — same compiled program, different
    co-tenant operands, zero cross-study math."""
    probe = _spec(pop=1000, seed=0, y=0.2)
    a = _batch([probe, _spec(pop=1000, seed=1, y=-0.1),
                    _spec(pop=1000, seed=2, y=0.5)]).run()[0]
    b = _batch([probe, _spec(pop=1000, seed=7, y=0.9),
                    _spec(pop=1000, seed=8, y=-0.6)]).run()[0]
    assert set(a) == set(b)
    for k in sorted(a):
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_multiplex_batch_matches_solo():
    """A lane of a batch-of-3 reproduces the same study run as a
    batch-of-1: populations (particles, weights), eps trajectory and
    stop state are BITWISE equal.  The per-particle distance
    diagnostic is compared to 1 float32 ULP instead — XLA's
    elementwise codegen may fuse differently for different leading
    extents (observed only under the 8-virtual-device test mesh), but
    that is compiler instruction selection, not cross-study math."""
    specs = [_spec(pop=1000, seed=s, y=y)
             for s, y in ((0, 0.2), (1, -0.1), (2, 0.5))]
    batched = _batch(specs).run()
    for spec, got in zip(specs, batched):
        solo = _batch([spec]).run()[0]
        assert set(got) == set(solo)
        for k in sorted(got):
            a, b = np.asarray(got[k]), np.asarray(solo[k])
            if k == "dist":
                assert np.all(np.abs(a - b)
                              <= np.spacing(np.float32(0.5))), k
            else:
                assert np.array_equal(a, b), k
    # and the lanes actually inferred: posterior mean tracks observed
    for spec, got in zip(specs, batched):
        w = np.asarray(got["w"], dtype=np.float64)
        mean = float(np.sum(np.asarray(got["theta"])[:, 0] * w))
        assert abs(mean - spec.observed["y"]) < 0.15


# ---------------------------------------------------------------------------
# the warm worker
# ---------------------------------------------------------------------------

def test_duplicate_served_from_cache_without_dispatch(tmp_path):
    worker = _worker(root=str(tmp_path))
    first = worker.serve_spec(_spec(pop=100, seed=0))
    assert first["served_from"] == "multiplex"  # content-routed
    # any dispatch path would now blow up — the duplicate must not
    # touch an engine at all
    def _boom(*_a, **_k):
        raise AssertionError("duplicate digest dispatched")
    worker._solo_summary = _boom
    worker._run_batch = _boom
    again = worker.serve_spec(_spec(pop=100, seed=0))
    assert again["served_from"] == "cache"
    assert again["posterior_mean"] == first["posterior_mean"]
    assert worker.cache.stats()["hits"] >= 1


def test_cross_worker_warm_hit_via_tier2(tmp_path):
    """The fleet-wide dedup contract: worker A completes a study and
    publishes to the shared tier-2 store; worker B — which has NEVER
    seen the digest — serves the duplicate from tier-2 with ZERO
    dispatches, bitwise equal, and promotes it into its own tier-1."""
    a = _worker(root=str(tmp_path), worker_id="wa")
    first = a.serve_spec(_spec(pop=100, seed=0))
    assert first["served_from"] == "multiplex"
    b = _worker(root=str(tmp_path), worker_id="wb")

    def _boom(*_a, **_k):
        raise AssertionError("tier-2 duplicate dispatched")
    b._solo_summary = _boom
    b._run_batch = _boom
    warm = b.serve_spec(_spec(pop=100, seed=0))
    assert warm["served_from"] == "cache_t2"
    assert warm["posterior_mean"] == first["posterior_mean"]
    # promoted: the next duplicate is a LOCAL tier-1 hit on B
    again = b.serve_spec(_spec(pop=100, seed=0))
    assert again["served_from"] == "cache"
    stats = b.cache.stats()
    assert stats["t2_hits"] == 1 and stats["t1_hits"] >= 1


def test_warm_worker_zero_recompiles_after_first(tmp_path, monkeypatch):
    """Studies 2 and 3 on the same problem shape (different seeds) ride
    the renewed engine's pinned programs: compile delta 0.  Multiplex
    is disabled so the SOLO warm path is the one under test.  Seeds are
    chosen so the adaptive batch ladder stays on rungs the first study
    already compiled — a study whose acceptance path visits a NEW rung
    legitimately pays one compile, which the ladder then caches for
    every later study."""
    from pyabc_tpu_torch.autotune import compile_counters
    monkeypatch.setenv("PYABC_TPU_SERVE_MULTIPLEX", "1")
    worker = _worker(root=str(tmp_path))
    worker.serve_spec(_spec(pop=200, seed=0))
    n0 = compile_counters()["n_compiles"]
    for seed in (1, 4):
        summary = worker.serve_spec(_spec(pop=200, seed=seed))
        assert summary["served_from"] == "solo"
    assert compile_counters()["n_compiles"] == n0
    assert len(worker._engines) == 1  # one problem shape, one engine


def test_warm_worker_zero_recompiles_on_study_axis(tmp_path):
    """The same warmth contract on the multiplex engine: sequential
    eligible studies (singleton claims, the everyday serving stream)
    reuse the pooled compiled batch program — compile delta 0 after
    the first."""
    from pyabc_tpu_torch.autotune import compile_counters
    worker = _worker(root=str(tmp_path))
    first = worker.serve_spec(_spec(pop=100, seed=0))
    assert first["served_from"] == "multiplex"
    n0 = compile_counters()["n_compiles"]
    for seed in (2, 3):
        summary = worker.serve_spec(_spec(pop=100, seed=seed))
        assert summary["served_from"] == "multiplex"
    assert compile_counters()["n_compiles"] == n0
    assert len(worker._batch_programs) == 1  # one shape, one program


def test_engine_routing_is_content_deterministic(tmp_path):
    """The review contract: the same spec returns the same BITS
    whether it was claimed alone or alongside co-traffic.  Every
    lane-eligible miss runs on the study-axis engine (a batch of one
    when alone), and lanes are batch-shape invariant, so the digest →
    result mapping never depends on what else was in the queue."""
    alone = _worker(root=str(tmp_path / "a")).serve_many(
        [_spec(pop=300, seed=0, y=0.2)])[0]
    crowded = _worker(root=str(tmp_path / "b")).serve_many(
        [_spec(pop=300, seed=0, y=0.2),
         _spec(pop=300, seed=1, y=-0.3),
         _spec(pop=300, seed=2, y=0.6)])[0]
    assert alone["served_from"] == "multiplex"
    assert crowded["served_from"] == "multiplex"
    for k in ("posterior_mean", "posterior_std", "eps", "gens",
              "n_sims", "stop_reason", "digest"):
        assert alone[k] == crowded[k], k


def test_cache_is_engine_scoped(tmp_path, monkeypatch):
    """The two engines are statistically, not bitwise, equivalent — a
    multiplex-engine entry must never be returned once the worker
    config routes the same digest to the solo engine.  The cache key
    carries the engine, so a knob change misses and recomputes
    instead of aliasing."""
    worker = _worker(root=str(tmp_path))
    first = worker.serve_spec(_spec(pop=100, seed=0))
    assert first["served_from"] == "multiplex"
    monkeypatch.setenv("PYABC_TPU_SERVE_MULTIPLEX", "1")
    second = worker.serve_spec(_spec(pop=100, seed=0))
    assert second["served_from"] == "solo"
    assert second["engine"] == "solo"
    assert second["digest"] == first["digest"]
    # the summary schema is engine-independent (review: schema parity)
    assert set(first) == set(second)


def test_hmac_gates_spec_unpickling(tmp_path, monkeypatch):
    """With PYABC_TPU_SERVE_HMAC_KEY set, a tampered or unsigned spec
    payload raises before pickle.loads ever runs — the poison-ticket
    path, not code execution."""
    monkeypatch.setenv("PYABC_TPU_SERVE_HMAC_KEY", "s3cret")
    q = StudyQueue(root=str(tmp_path))
    t = q.submit(_spec(seed=0))
    assert t.load_spec().seed == 0  # signed at submit: verifies
    # tamper the pending file: swap in a different pickled spec
    with open(t.path, encoding="utf-8") as f:
        payload = json.load(f)
    payload["spec_b64"] = base64.b64encode(
        pickle.dumps(_spec(seed=9))).decode("ascii")
    with open(t.path, "w", encoding="utf-8") as f:
        json.dump(payload, f)
    with pytest.raises(SpecAuthError):
        q.claim("w1").load_spec()
    # a ticket submitted WITHOUT the key (unsigned) is refused too
    monkeypatch.delenv("PYABC_TPU_SERVE_HMAC_KEY")
    q.submit(_spec(seed=1))
    monkeypatch.setenv("PYABC_TPU_SERVE_HMAC_KEY", "s3cret")
    with pytest.raises(SpecAuthError):
        q.claim("w1").load_spec()


def test_done_tickets_are_stripped_and_swept(tmp_path):
    """done/ holds tombstones: no pickled spec, and the retention
    sweep reaps them once they age out — the serve root is bounded."""
    q = StudyQueue(root=str(tmp_path))
    q.submit(_spec(seed=0))
    t = q.claim("w1")
    q.complete(t, wall_s=0.1, engine="solo")
    with open(t.path, encoding="utf-8") as f:
        tomb = json.load(f)
    assert "spec_b64" not in tomb
    assert "spec_hmac" not in tomb
    assert tomb["engine"] == "solo"
    assert q.sweep(retain_s=3600) == 0  # fresh tombstone: retained
    old = time.time() - 7200
    os.utime(t.path, (old, old))
    assert q.sweep(retain_s=0) == 0  # 0 disables the sweep entirely
    assert q.sweep(retain_s=3600) == 1
    assert q.stats()["done"] == 0


def test_requeue_worker_reaps_completed_stale_claims(tmp_path):
    """A crash between complete()'s write and its unlink leaves the
    claimed copy behind the done tombstone; the janitor sweep reaps it
    by id instead of serving the study twice."""
    q = StudyQueue(root=str(tmp_path))
    q.submit(_spec(seed=0))
    t = q.claim("w1")
    stale = t.path
    with open(stale, encoding="utf-8") as f:
        claimed_payload = f.read()
    q.complete(t, wall_s=0.1, engine="solo")
    # resurrect the claimed copy — the simulated crash artifact
    with open(stale, "w", encoding="utf-8") as f:
        f.write(claimed_payload)
    assert q.requeue_worker("w1") == 0
    assert q.depth() == 0
    assert not os.path.exists(stale)
    assert q.stats()["claimed"] == 0


def test_queue_to_worker_end_to_end_with_multiplex(tmp_path):
    """Three same-shape misses fuse onto the study axis; the in-batch
    duplicate comes back from the cache; all tickets land in done/
    with their serving path stamped."""
    queue = StudyQueue(root=str(tmp_path))
    for s, y in ((0, 0.2), (1, 0.3), (2, 0.5)):
        queue.submit(_spec(pop=100, seed=s, y=y))
    queue.submit(_spec(pop=100, seed=1, y=0.3))  # duplicate digest
    worker = _worker(root=str(tmp_path))
    served = worker.run_forever(queue, once=True)
    assert served == 4
    stats = queue.stats()
    assert (stats["pending"], stats["claimed"], stats["done"],
            stats["failed"]) == (0, 0, 4, 0)
    engines = sorted(
        json.load(open(os.path.join(queue.root, "done", n),
                       encoding="utf-8"))["engine"]
        for n in os.listdir(os.path.join(queue.root, "done"))
        if n.endswith(".json"))
    assert engines.count("cache") == 1
    assert engines.count("multiplex") == 3


def test_sigterm_drain_requeues_in_flight(tmp_path):
    queue = StudyQueue(root=str(tmp_path))
    for seed in range(3):
        queue.submit(_spec(seed=seed))
    worker = _worker(root=str(tmp_path))
    # the handlers go back with clean_process_state
    worker.install_signal_handlers()
    # two studies already claimed when the drain signal lands
    assert queue.claim(worker.worker_id) is not None
    assert queue.claim(worker.worker_id) is not None
    signal.raise_signal(signal.SIGTERM)
    assert worker.draining
    served = worker.run_forever(queue, once=True)
    assert served == 0  # drained before dispatching anything
    pending = queue.pending()
    assert len(pending) == 3  # both claims bounced back, nothing lost
    assert sorted(t.requeues for t in pending) == [0, 1, 1]
    assert queue.stats()["claimed"] == 0


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def _priors(pkg):
    return pkg.Distribution(
        a=pkg.RV("uniform", -1.0, 2.0), b=pkg.RV("norm", 0.3, 0.1),
        c=pkg.LowerBoundDecorator(pkg.RV("norm", 0.0, 1.3), 0.1))


@pytest.mark.parametrize("kw", [{}, {"seed": 5, "alpha": 0.3},
                                {"minimum_epsilon": 0.02,
                                 "max_generations": 7, "distance_p": 1.0}])
def test_digests_and_placement_equal_the_jax_package(kw):
    """One declaration, one content address: the same model callable
    (the digest hashes its source, never calls it), the same prior
    declared in each package, the same observed data and budgets."""
    assert _prior_config(_priors(pt)) == jax_prior_config(_priors(jpt))
    common = dict(model=_model, observed={"y": 0.4, "z": [1.0, 2.5]},
                  population_size=300, **kw)
    port = StudySpec(prior=_priors(pt), **common)
    ref = JaxStudySpec(prior=_priors(jpt), **common)
    assert study_digest(port) == jax_study_digest(ref)
    assert problem_key(port) == jax_problem_key(ref)
    for parts in (1, 3, 8, 16):
        assert shards.partition_of(study_digest(port), parts) == \
            jax_shards.partition_of(jax_study_digest(ref), parts)
    assert shards.rotation(8, "w1", 3) == jax_shards.rotation(8, "w1", 3)


def test_lane_seeds_are_keyed_by_the_lane_alone():
    seeds = {lane_seed(s, g, r, k) for s in range(3) for g in range(3)
             for r in range(3) for k in range(5)}
    assert len(seeds) == 3 * 3 * 3 * 5
    assert all(0 <= x < 2 ** 63 for x in seeds)


@pytest.mark.parametrize("pop", [100, 1000])
def test_lane_generation_equals_the_jax_package(pop):
    """From one JAX lane population: the port's ε equals the JAX ε
    exactly, and its importance weights match the JAX ``new_w``."""
    jb = JaxStudyBatch([_jax_spec(pop=pop, seed=4, y=0.3,
                                  max_generations=6)], window=2)
    jb.step_window()
    lane = jax_lane_extract(jb._carry, 0)
    assert int(lane[4]) == 3 and bool(lane[5])  # two generations in
    success, eps_t, new_theta, new_w, _d, _r = jax.jit(jb._gen_step)(
        jax.random.PRNGKey(4), *(jnp.asarray(x) for x in lane[:3]),
        jnp.asarray(jb._y_obs[0]), jnp.int32(lane[4]))
    assert bool(success)
    eng = _LaneEngine(_batch([_spec(pop=pop, seed=4, y=0.3)]))
    theta, w, dist = lane_carry_to_torch(lane, "cpu")[:3]
    eps = eng.weighted_quantile(dist, w)
    assert eps.dtype == torch.float32
    assert float(eps) == float(eps_t)
    got = eng.importance_weights(torch.as_tensor(np.asarray(new_theta)),
                                 theta, w, eng.kernel_scale(theta, w))
    np.testing.assert_allclose(got.numpy(), np.asarray(new_w),
                               atol=W_ATOL, rtol=W_RTOL)


def test_lane_carry_converter_seats_a_jax_lane():
    jb = JaxStudyBatch([_jax_spec(pop=100, seed=1)], window=1)
    jb.step_window()
    lane = jax_lane_extract(jb._carry, 0)
    batch = _batch([_spec(pop=100, seed=1), _spec(pop=100, seed=2)])
    from pyabc_tpu_torch.sampler.fused import lane_splice
    batch._carry = lane_splice(batch._carry, 1,
                               lane_carry_to_torch(lane, batch.device))
    res = batch.result(1)
    for key, ref in (("theta", lane[0]), ("w", lane[1]),
                     ("dist", lane[2]), ("eps", lane[3]),
                     ("gens", lane[4]), ("accepted", lane[7]),
                     ("rounds", lane[8])):
        assert np.array_equal(res[key], np.asarray(ref)), key
        assert res[key].dtype == np.asarray(ref).dtype, key


def test_study_axis_passes_the_jax_packages_posterior_gate():
    specs = [((0, 0.2), 1000), ((1, -0.1), 1000), ((2, 0.5), 1000)]
    port = _batch([_spec(pop=p, seed=s, y=y) for (s, y), p in specs]).run()
    ref = JaxStudyBatch([_jax_spec(pop=p, seed=s, y=y)
                         for (s, y), p in specs]).run()
    for ((_s, y), _p), got, want in zip(specs, port, ref):
        for res in (got, want):
            w = np.asarray(res["w"], dtype=np.float64)
            mean = float(np.sum(np.asarray(res["theta"])[:, 0] * w))
            assert abs(mean - y) < 0.15
        # under the generation budget both stop alike
        assert int(got["gens"]) == int(want["gens"]) == 3
        assert STOP_NAMES[int(got["stop_code"])] == \
            STOP_NAMES[int(want["stop_code"])] == "budget"
        assert np.isfinite(got["eps"]) and float(got["eps"]) > 0


def test_study_axis_runs_k1_once_per_lane_generation(monkeypatch):
    """Every lane's importance weights go through the K1 entry point,
    once per lane and successful generation, never for a padded lane."""
    from pyabc_tpu_torch.serve import multiplex
    calls = []
    inner = multiplex.weighted_kde_logpdf_auto

    def counted(x, support, *args):
        calls.append((x.shape[0], support.shape[0]))
        return inner(x, support, *args)

    monkeypatch.setattr(multiplex, "weighted_kde_logpdf_auto", counted)
    specs = [_spec(pop=100, seed=s, max_generations=g)
             for s, g in ((0, 3), (1, 2), (2, 4))]
    res = _batch(specs).run()  # rung 4: one padded lane
    assert len(calls) == sum(int(r["gens"]) - 1 for r in res) == 6
    assert set(calls) == {(100, 100)}
