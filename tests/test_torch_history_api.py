"""The port's ``History`` read API against the JAX package's.

One small run of config #2 written by the JAX package (pop 300, three
generations, lazy rows flushed at its end) is read through both
packages' ``History``; each of the read methods below returns the same
frames and values, exactly.  A lazy, device-resident generation of a
port run reads as its eager twin does.
"""

import numpy as np
import pandas as pd
import pytest

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.models import make_two_gaussians_problem as jax_problem
from pyabc_tpu.storage.history import History as JaxHistory
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.storage import History


@pytest.fixture(scope="module")
def histories(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("api") / "jax.db")
    models, priors, distance, observed, _ = jax_problem()
    abc = jpt.ABCSMC(models, priors, distance, population_size=300,
                     sampler=jpt.VectorizedSampler(), seed=3)
    abc.new(path, observed, gt_par={"mu": 0.5})
    abc.run(max_nr_populations=3)
    return JaxHistory(path, abc_id=1), History(path, abc_id=1)


def _same(a, b):
    if isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b)
    elif isinstance(a, pd.Series):
        pd.testing.assert_series_equal(a, b)
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    else:
        assert a == b and type(a) is type(b)


#: (method, arguments) — a property when the arguments are None
CALLS = {
    "n_populations": None,
    "db_size": None,
    "total_nr_simulations": None,
    "all_runs": [()],
    "get_ground_truth_parameter": [()],
    "get_population_strategy": [()],
    "nr_of_models_alive": [(), (0,), (2,)],
    "get_weighted_distances": [(), (0,), (1,)],
    "get_weighted_sum_stats": [(), (0,)],
    "get_weighted_sum_stats_for_model": [(0,), (1, 1), (0, 2)],
    "get_population_extended": [(), (0,), (None, "all"), (1, 0),
                                (None, -1)],
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_read_method_equals_the_jax_package(histories, name):
    jh, ph = histories
    calls = CALLS[name]
    if calls is None:
        _same(getattr(jh, name), getattr(ph, name))
        return
    for args in calls:
        _same(getattr(jh, name)(*args), getattr(ph, name)(*args))


def test_values_are_those_of_the_run(histories):
    _, ph = histories
    assert ph.n_populations == 3
    assert ph.get_ground_truth_parameter() == {"mu": 0.5}
    assert ph.total_nr_simulations == int(
        ph.get_all_populations().samples.sum())
    assert ph.db_size > 0
    ext = ph.get_population_extended(t="all")
    assert sorted(ext.t.unique()) == [-1, 0, 1, 2]
    assert list(ext.columns[:4]) == ["t", "m", "w", "distance"]
    w, stats = ph.get_weighted_sum_stats()
    assert abs(w.sum() - 1.0) < 1e-12 and len(stats) == len(w) == 300


def test_lazy_rows_read_like_eager_rows():
    """A one-dispatch run's lazy generations, read while still
    device-resident, give the answers of its eager twin (same seed,
    same bits)."""
    def run(mode):
        models, priors, distance, observed, _ = make_two_gaussians_problem()
        abc = pt.ABCSMC(models, priors, distance, population_size=200,
                        eps=pt.ConstantEpsilon(0.2),
                        sampler=pt.VectorizedSampler(min_batch_size=2048,
                                                     max_batch_size=2048,
                                                     device="cpu"),
                        fuse_generations=2, run_mode="onedispatch", seed=4,
                        history_mode=mode)
        abc.new("sqlite://", observed)
        return abc

    lazy, eager = run("lazy"), run("eager")
    eager.run(max_nr_populations=4)
    # the run without its closing flush: generations 1-3 stay resident
    lazy.history.done = lambda: None
    lazy._configure_telemetry()
    h_lazy = lazy._run_master(0.0, 4, 0.0, np.inf)
    h_eager = eager.history
    for t in (1, 2, 3):
        assert h_lazy._lazy_flag(t)[0] == 1
    for name, args in [("get_weighted_distances", (1,)),
                       ("get_weighted_sum_stats", (2,)),
                       ("get_weighted_sum_stats_for_model", (0, 3)),
                       ("get_population_extended", (None, "all")),
                       ("nr_of_models_alive", (2,)),
                       ("n_populations", None),
                       ("total_nr_simulations", None)]:
        if args is None:
            _same(getattr(h_eager, name), getattr(h_lazy, name))
        else:
            _same(getattr(h_eager, name)(*args),
                  getattr(h_lazy, name)(*args))
    assert [h_lazy._lazy_flag(t)[0] for t in (1, 2, 3)] == [0, 0, 0]
