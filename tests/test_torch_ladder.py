"""The port's program ladder, kernel build cache and warm rebind.

Twins of ``tests/test_autotune.py``'s ``CompiledLadder`` and
persistent-cache tests (:220-285, :304-349) against
``pyabc_tpu_torch.autotune``: LRU eviction and its counter, single-flight
builds, prewarm and drain, a contained prewarm error, the cache
directory's precedence (argument, then ``$PYABC_TPU_COMPILE_CACHE``, then
the default ``build/kernels/``) beside the JAX package's, and
``ABCSMC(compile_cache=)``.  Then ``ABCSMC.renew``: with the same
observed stats it keeps the round kernel (``_uid``) and builds no engine
for the second study; the same seed reproduces the first study bit for
bit, another seed draws another one; the quantile look-up is cleared;
different observed stats bind a new kernel.  CPU, pop 200.
"""

import os
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import pyabc_tpu_torch as pt
from pyabc_tpu.autotune import configure_compile_cache as jax_configure
from pyabc_tpu_torch.autotune import (COMPILE_CACHE_ENV, CompiledLadder,
                                      compile_counters, compile_delta,
                                      configure_compile_cache,
                                      record_build)
from pyabc_tpu_torch.ops import _build
from pyabc_tpu_torch.sampler.vectorized import LADDER_CAPACITY
from pyabc_tpu_torch.telemetry.metrics import REGISTRY


def _count(name):
    c = REGISTRY.get(name)
    return c.value if c else 0.0


# ---------------------------------------------------------------------------
# CompiledLadder
# ---------------------------------------------------------------------------

def test_ladder_lru_eviction_and_counter():
    led = CompiledLadder(capacity=2)
    evict0 = _count("autotune_ladder_evictions_total")
    led.get("a", lambda: "A")
    led.get("b", lambda: "B")
    led.get("a", lambda: "A")  # touch: "a" is now most-recent
    led.get("c", lambda: "C")  # evicts "b"
    assert "b" not in led and "a" in led and "c" in led
    assert len(led) == 2
    assert _count("autotune_ladder_evictions_total") == evict0 + 1
    assert led.summary() == {"hits": 1, "misses": 3, "evictions": 1,
                             "size": 2, "capacity": 2}
    with pytest.raises(ValueError):
        CompiledLadder(capacity=0)


def test_ladder_get_builds_once_single_flight():
    led = CompiledLadder()
    builds = []
    gate = threading.Event()

    def build():
        gate.wait(timeout=5)
        builds.append(1)
        return "X"

    results = [None] * 4

    def worker(i):
        results[i] = led.get("k", build)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    gate.set()
    for th in threads:
        th.join(timeout=10)
    assert results == ["X"] * 4
    assert len(builds) == 1


def test_ladder_prewarm_background_build_and_drain():
    led = CompiledLadder()
    assert led.prewarm("warm", lambda: "W") is True
    led.drain(timeout=10)
    assert "warm" in led
    # a later get() serves the prewarmed value, not a rebuild
    assert led.get("warm", lambda: pytest.fail("rebuilt")) == "W"
    # prewarming a cached key is a no-op
    assert led.prewarm("warm", lambda: "V") is False


def test_ladder_prewarm_build_error_is_contained():
    led = CompiledLadder()
    errs0 = _count("autotune_aot_errors_total")

    def bad():
        raise RuntimeError("boom")

    assert led.prewarm("bad", bad) is True
    led.drain(timeout=10)
    assert "bad" not in led
    assert _count("autotune_aot_errors_total") == errs0 + 1
    # the failed key builds on demand
    assert led.get("bad", lambda: "ok") == "ok"


def test_ladder_builds_count_as_compiles():
    before = compile_counters()
    led = CompiledLadder()
    led.get("x", lambda: 1)
    led.get("x", lambda: 2)
    record_build(0.5)
    delta = compile_delta(before)
    assert delta["n_compiles"] == 2
    assert delta["compile_s"] >= 0.5
    assert delta["cache_hits"] == delta["cache_misses"] == 0


# ---------------------------------------------------------------------------
# the kernel build cache's location
# ---------------------------------------------------------------------------

@pytest.fixture
def _restore_caches(monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    old_dir = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    yield
    jax.config.update("jax_compilation_cache_dir", old_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old_min)
    try:
        from jax._src.compilation_cache import reset_cache
        reset_cache()
    except Exception:
        pass


def test_configure_compile_cache_paths(tmp_path, monkeypatch,
                                       _restore_caches):
    default = _build.BUILD_DIR
    assert default == Path(_build.__file__).resolve().parents[2] \
        / "build" / "kernels"
    monkeypatch.delenv(COMPILE_CACHE_ENV, raising=False)
    # no path, no env: no-op, in both packages
    assert configure_compile_cache() is None is jax_configure()
    assert _build.BUILD_DIR == default
    # the environment variable
    env_dir = str(tmp_path / "from_env")
    monkeypatch.setenv(COMPILE_CACHE_ENV, env_dir)
    assert configure_compile_cache() == env_dir == jax_configure()
    assert os.path.isdir(env_dir) and _build.BUILD_DIR == Path(env_dir)
    assert _build.library_path("kde_logpdf").parent == Path(env_dir)
    # an explicit path beats the environment
    exp_dir = str(tmp_path / "explicit")
    assert configure_compile_cache(exp_dir) == exp_dir == jax_configure(
        exp_dir)
    assert _build.BUILD_DIR == Path(exp_dir)


def test_abcsmc_compile_cache_kwarg(tmp_path, monkeypatch, _restore_caches):
    monkeypatch.delenv(COMPILE_CACHE_ENV, raising=False)
    cache = str(tmp_path / "cc")
    abc = pt.ABCSMC(_model, _prior(), pt.PNormDistance(p=2),
                    population_size=32, compile_cache=cache, device="cpu")
    assert abc.compile_cache_dir == cache and abc.compile_cache == cache
    assert _build.BUILD_DIR == Path(cache)
    default = pt.ABCSMC(_model, _prior(), pt.PNormDistance(p=2),
                        population_size=32, device="cpu")
    assert default.compile_cache_dir is None
    assert _build.BUILD_DIR == Path(cache)  # None changes nothing


# ---------------------------------------------------------------------------
# ABCSMC.renew
# ---------------------------------------------------------------------------

def _model(generator, theta):
    noise = 0.1 * torch.randn(theta.shape[0], 1, generator=generator,
                              device=theta.device)
    return {"y": theta[:, :1] + noise}


def _prior():
    return pt.Distribution(mu=pt.RV("uniform", -1.0, 2.0))


def _engine(seed=0):
    return pt.ABCSMC(pt.SimpleModel(_model), _prior(), pt.PNormDistance(p=2),
                     population_size=200, eps=pt.QuantileEpsilon(alpha=0.5),
                     run_mode="onedispatch", fuse_generations=4, seed=seed,
                     device="cpu")


def _posterior(abc):
    df, w = abc.history.get_distribution()
    return df["mu"].to_numpy(), np.asarray(w)


def test_renew_keeps_the_kernel_and_builds_nothing():
    abc = _engine(seed=0)
    abc.new("sqlite://", {"y": 0.4})
    uid = abc._kernel._uid
    abc.run(max_nr_populations=4)
    first = _posterior(abc)
    eps_first = list(abc.history.get_all_populations()["epsilon"])
    assert abc.eps._look_up  # the schedule ran
    ladder = abc.sampler._ladder
    assert ladder.capacity == LADDER_CAPACITY == 16
    misses0, hits0 = ladder.summary()["misses"], ladder.summary()["hits"]
    n0 = compile_counters()["n_compiles"]

    abc.renew("sqlite://", {"y": 0.4}, seed=0)
    assert abc._kernel._uid == uid
    assert abc.eps._look_up == {} and abc._fused_carry is None
    assert len(abc.timeline) == 0 and abc.history.max_t == -1
    abc.run(max_nr_populations=4)
    # the same seed on the warm engine: the same study, bit for bit, from
    # engines the ladder already held
    again = _posterior(abc)
    np.testing.assert_array_equal(again[0], first[0])
    np.testing.assert_array_equal(again[1], first[1])
    assert list(abc.history.get_all_populations()["epsilon"]) == eps_first
    assert compile_counters()["n_compiles"] == n0
    assert ladder.summary()["misses"] == misses0
    assert ladder.summary()["hits"] > hits0
    assert any(r["path"] == "onedispatch" for r in abc.timeline)

    # another seed is another study on the same kernel
    abc.renew("sqlite://", {"y": 0.4}, seed=1)
    assert abc._kernel._uid == uid
    abc.run(max_nr_populations=4)
    assert not np.array_equal(_posterior(abc)[0], first[0])


def test_renew_with_other_observed_stats_binds_anew():
    abc = _engine()
    abc.new("sqlite://", {"y": 0.4})
    uid = abc._kernel._uid
    abc.renew("sqlite://", {"y": 0.4})
    assert abc._kernel._uid == uid
    abc.renew("sqlite://", {"y": 0.3})
    assert abc._kernel._uid != uid
    np.testing.assert_array_equal(abc.x_0["y"], np.float32(0.3))
    # a fresh engine has no binding: renew is new()
    cold = _engine()
    cold.renew("sqlite://", {"y": 0.4})
    assert cold._kernel is not None
