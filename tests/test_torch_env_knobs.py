"""The port reads the JAX package's environment knobs and takes its
constructor arguments.

``ABCSMC(run_mode=None)`` defers to ``$PYABC_TPU_RUN_MODE`` and
``onedispatch_max_t=None`` to ``$PYABC_TPU_ONEDISPATCH_MAX_T``
(``pyabc_tpu/smc.py:246-247``, ``:279-280``); ``History.flush_lazy``
defers to ``$PYABC_TPU_LAZY_FINAL_ONLY`` (``pyabc_tpu/storage/
history.py:827-853``); ``show_progress`` and ``compile_cache`` are
accepted.  Each knob is set in both packages and the results compared.
"""

import sqlite3

import numpy as np
import pytest

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.models import make_two_gaussians_problem as jax_problem
from pyabc_tpu_torch.models import make_two_gaussians_problem

KNOBS = ("PYABC_TPU_RUN_MODE", "PYABC_TPU_ONEDISPATCH_MAX_T",
         "PYABC_TPU_LAZY_FINAL_ONLY")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)


def _both(**port_kwargs):
    """``(jax ABCSMC, port ABCSMC)`` of config #2, built with no engine
    arguments."""
    models, priors, distance, _, _ = jax_problem()
    a_j = jpt.ABCSMC(models, priors, distance, population_size=100,
                     sampler=jpt.VectorizedSampler())
    models, priors, distance, _, _ = make_two_gaussians_problem()
    a_p = pt.ABCSMC(models, priors, distance, population_size=100,
                    sampler=pt.VectorizedSampler(device="cpu"),
                    **port_kwargs)
    return a_j, a_p


@pytest.mark.parametrize("env", [
    {},
    {"PYABC_TPU_RUN_MODE": "onedispatch"},
    {"PYABC_TPU_RUN_MODE": "classic", "PYABC_TPU_ONEDISPATCH_MAX_T": "5"},
    {"PYABC_TPU_RUN_MODE": "onedispatch", "PYABC_TPU_ONEDISPATCH_MAX_T": "0"},
], ids=["unset", "onedispatch", "classic_window5", "window0"])
def test_run_mode_and_window_follow_the_environment(monkeypatch, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    a_j, a_p = _both()
    assert a_p.run_mode == a_j.run_mode == env.get("PYABC_TPU_RUN_MODE",
                                                   "auto")
    assert a_p.onedispatch_max_t == a_j.onedispatch_max_t


def test_explicit_arguments_win_and_bad_modes_raise(monkeypatch):
    monkeypatch.setenv("PYABC_TPU_RUN_MODE", "onedispatch")
    monkeypatch.setenv("PYABC_TPU_ONEDISPATCH_MAX_T", "4")
    _, a_p = _both(run_mode="classic", onedispatch_max_t=7)
    assert (a_p.run_mode, a_p.onedispatch_max_t) == ("classic", 7)
    monkeypatch.setenv("PYABC_TPU_RUN_MODE", "pipelined")
    models, priors, distance, _, _ = make_two_gaussians_problem()
    with pytest.raises(ValueError, match="run_mode"):
        pt.ABCSMC(models, priors, distance,
                  sampler=pt.VectorizedSampler(device="cpu"))


def test_show_progress_and_compile_cache_construct(tmp_path, monkeypatch):
    from pyabc_tpu_torch.ops import _build
    # compile_cache= repoints the process-wide kernel build directory:
    # put it back after this test
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    _, a_p = _both(show_progress=True, compile_cache=None)
    assert a_p.show_progress is True and a_p.compile_cache is None
    _, a_p = _both(compile_cache=str(tmp_path))
    assert a_p.compile_cache == str(tmp_path) and a_p.show_progress is False


def _od_run(**kwargs):
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=200,
                    eps=pt.ConstantEpsilon(0.2),
                    sampler=pt.VectorizedSampler(min_batch_size=2048,
                                                 max_batch_size=2048,
                                                 device="cpu"),
                    fuse_generations=2, seed=0, **kwargs)
    abc.new("sqlite://", observed)
    abc.run(max_nr_populations=7)
    return abc


def test_environment_run_equals_the_explicit_twin(monkeypatch):
    """Under the two knobs a run with no engine arguments is the run
    that passes them: the same dispatches, paths and populations."""
    monkeypatch.setenv("PYABC_TPU_RUN_MODE", "onedispatch")
    monkeypatch.setenv("PYABC_TPU_ONEDISPATCH_MAX_T", "2")
    a_env = _od_run()
    monkeypatch.delenv("PYABC_TPU_RUN_MODE")
    monkeypatch.delenv("PYABC_TPU_ONEDISPATCH_MAX_T")
    a_arg = _od_run(run_mode="onedispatch", onedispatch_max_t=2)
    assert a_env.run_dispatches == a_arg.run_dispatches == 3
    paths = [r["path"] for r in a_env.timeline]
    assert paths == [r["path"] for r in a_arg.timeline]
    assert paths == ["sequential"] + ["onedispatch"] * 6
    for t in range(7):
        p_e, p_a = a_env.history.get_population(t), \
            a_arg.history.get_population(t)
        for key in ("m", "theta", "weight", "distance"):
            np.testing.assert_array_equal(getattr(p_e, key),
                                          getattr(p_a, key))


def _blob_rows(db: str) -> list:
    with sqlite3.connect(db) as conn:
        return sorted({t for (t,) in conn.execute(
            "SELECT t FROM model_populations WHERE theta IS NOT NULL "
            "AND t >= 0")})


@pytest.mark.parametrize("final_only", ["1", "0"])
def test_lazy_final_only_keeps_the_jax_packages_blob_rows(
        monkeypatch, tmp_path, final_only):
    """A lazy fused run (pop 512, K = 3, 5 generations) in each package
    under ``$PYABC_TPU_LAZY_FINAL_ONLY``: the same generations hold blobs
    after ``done``."""
    monkeypatch.setenv("PYABC_TPU_LAZY_FINAL_ONLY", final_only)
    rows = {}
    for name, mod, problem, kw in (
            ("jax", jpt, jax_problem, {}),
            ("port", pt, make_two_gaussians_problem, {"device": "cpu"})):
        models, priors, distance, observed, _ = problem()
        abc = mod.ABCSMC(models, priors, distance, population_size=512,
                         sampler=mod.VectorizedSampler(**kw), seed=7,
                         history_mode="lazy", fuse_generations=3,
                         ingest_mode="sequential")
        db = str(tmp_path / f"{name}.db")
        abc.new(db, observed)
        abc.run(max_nr_populations=5)
        rows[name] = _blob_rows(db)
    assert rows["port"] == rows["jax"]
    if final_only == "1":
        assert rows["port"][-1] == 4 and len(rows["port"]) < 5
    else:
        assert rows["port"] == list(range(5))
