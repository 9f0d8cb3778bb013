"""BASELINE configs #3 (Lotka-Volterra SDE) and #4 (SIR tau-leap)
through ``ABCSMC.run`` in both packages on the CPU, at a small size
(pop 1000, 4 generations, LV cut to 60 steps and SIR to 40), with the
factories' adaptive distance, ``MedianEpsilon`` and
``stores_sum_stats=False`` — so the refit reads the record stream.

- Posterior means: the JAX package runs the workload; the port replays
  its ε schedule and its fitted weight schedule (installed with
  ``convert.install_weights``, so every ``update`` re-evaluates the
  population under the installed weights).  ABC-SMC's last generation
  targets ``π(θ)·P(d_t(x, x0) ≤ ε_t | θ)`` whatever the proposals
  before it, so with the same metric and ε each parameter's weighted
  mean agrees within ``4·√(var_jax/ESS_jax + var_port/ESS_port)``.
  Two runs that fit their own weights do not: the median absolute
  deviation of a column that is 0 in about half the trajectories (an
  extinct species) jumps between 0 and a large weight from one
  calibration sample to the next.
- The port's own adaptive run: the weights change every generation,
  each fitted from at least ``pop`` records.
- Resume: a fresh ``ABCSMC`` and distance ``load`` a stored run and
  continue it; the weight schedule continues at the next generation.
"""

import numpy as np
import pytest

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.models import LotkaVolterraSDE as JaxLV
from pyabc_tpu.models import SIRTauLeap as JaxSIR
from pyabc_tpu_torch.convert import install_weights
from pyabc_tpu_torch.models import (LV_TRUTH, SIR_TRUTH, LotkaVolterraSDE,
                                    SIRTauLeap)

POP, GENS = 1000, 4


def _prior(pkg, name):
    if name == "lv":
        return pkg.Distribution(
            log_a=pkg.RV("uniform", -1.0, 2.0),
            log_b=pkg.RV("uniform", -3.0, 2.0),
            log_c=pkg.RV("uniform", -2.0, 2.0),
            log_d=pkg.RV("uniform", -1.0, 2.0))
    return pkg.Distribution(log_beta=pkg.RV("uniform", -2.0, 3.0),
                            log_gamma=pkg.RV("uniform", -3.0, 3.0))


def _model(name, jax=False):
    if name == "lv":
        return (JaxLV if jax else LotkaVolterraSDE)(n_steps=60)
    return (JaxSIR if jax else SIRTauLeap)(n_steps=40)


def _observed(name, seed=100):
    """One simulation at the truth, made by the port from a seed."""
    import torch
    g = torch.Generator()
    g.manual_seed(seed)
    truth = LV_TRUTH if name == "lv" else SIR_TRUTH
    out = _model(name).simulate(g, torch.log(torch.tensor([truth])))
    return {k: v[0].numpy() for k, v in out.items()}


def _port_abc(name, distance, eps, seed, stores_sum_stats=False):
    return pt.ABCSMC(_model(name), _prior(pt, name), distance,
                     population_size=POP, eps=eps,
                     sampler=pt.VectorizedSampler(device="cpu"),
                     stores_sum_stats=stores_sum_stats, seed=seed)


def _moments(history):
    df, w = history.get_distribution(m=0, t=history.max_t)
    x = df.to_numpy()
    w = np.asarray(w, np.float64)
    w = w / w.sum()
    mu = (x * w[:, None]).sum(0)
    var = (w[:, None] * (x - mu) ** 2).sum(0)
    return mu, var, 1.0 / np.sum(w ** 2)


@pytest.mark.parametrize("name", ["lv", "sir"])
def test_posterior_means_agree_with_jax(name):
    observed = _observed(name)
    j_dist = jpt.AdaptivePNormDistance(p=2)
    j_abc = jpt.ABCSMC(_model(name, jax=True), _prior(jpt, name), j_dist,
                       population_size=POP, eps=jpt.MedianEpsilon(),
                       sampler=jpt.VectorizedSampler(),
                       stores_sum_stats=False, seed=1)
    j_abc.new("sqlite://", observed)
    j_hist = j_abc.run(max_nr_populations=GENS)
    j_eps = j_hist.get_all_populations().epsilon.to_numpy()[1:]
    assert sorted(j_dist.weights) == list(range(GENS))

    dist = pt.AdaptivePNormDistance(p=2)
    abc = _port_abc(name, dist, pt.ListEpsilon(j_eps), seed=2)
    abc.new("sqlite://", observed)
    install_weights(dist, j_dist.weights)
    hist = abc.run(max_nr_populations=GENS)
    assert hist.max_t == GENS - 1
    for t in range(1, GENS):
        np.testing.assert_array_equal(dist.weights[t], j_dist.weights[t])

    mu_j, var_j, ess_j = _moments(j_hist)
    mu, var, ess = _moments(hist)
    tol = 4.0 * np.sqrt(var_j / ess_j + var / ess)
    assert np.all(np.abs(mu - mu_j) < tol), (mu, mu_j, tol)


@pytest.mark.parametrize("max_records", [0, 1 << 21])
def test_refit_reads_records_or_else_the_accepted_stats(max_records):
    """Without a record budget the refit reads the accepted stats, which
    then go to the host; with records they stay on the device."""
    dist = pt.AdaptivePNormDistance(p=2)
    abc = pt.ABCSMC(_model("sir"), _prior(pt, "sir"), dist,
                    population_size=500,
                    sampler=pt.VectorizedSampler(device="cpu"),
                    stores_sum_stats=False,
                    max_nr_recorded_particles=max_records, seed=5)
    abc.new("sqlite://", _observed("sir"))
    abc.run(max_nr_populations=3)
    assert sorted(dist.weights) == [0, 1, 2]
    assert not np.allclose(dist.weights[2], dist.weights[1])
    records = [row["records"] for row in abc.timeline]
    if max_records:
        assert min(records) >= 500 and not abc.sampler.fetch_stats
    else:
        assert records == [0, 0, 0] and abc.sampler.fetch_stats


@pytest.mark.parametrize("name", ["lv", "sir"])
def test_port_refits_every_generation_and_resumes(name, tmp_path):
    observed = _observed(name)
    db = f"sqlite:///{tmp_path / 'run.db'}"
    dist = pt.AdaptivePNormDistance(p=2)
    abc = _port_abc(name, dist, pt.MedianEpsilon(), seed=3,
                    stores_sum_stats=True)
    abc.new(db, observed)
    abc.run(max_nr_populations=GENS - 1)
    assert sorted(dist.weights) == list(range(GENS - 1))
    for t in range(1, GENS - 1):
        assert not np.allclose(dist.weights[t], dist.weights[t - 1])
    for row in abc.timeline:
        assert row["records"] >= POP
        assert np.isfinite(row["eps"]) and row["eps"] > 0

    # a new process: fresh components load the run and continue it
    resumed = pt.AdaptivePNormDistance(p=2)
    abc2 = _port_abc(name, resumed, pt.MedianEpsilon(), seed=4,
                     stores_sum_stats=True)
    abc2.load(db)
    hist = abc2.run(max_nr_populations=2)
    assert hist.max_t == GENS
    # fitted at load from the stored generation, then refit from records
    assert sorted(resumed.weights) == [GENS - 1, GENS]
    for w in resumed.weights.values():
        assert np.all(np.isfinite(w)) and w.sum() > 0
    assert not np.allclose(resumed.weights[GENS], resumed.weights[GENS - 1])
    eps = hist.get_all_populations().epsilon.to_numpy()
    assert np.all(np.isfinite(eps[1:])) and np.all(eps[1:] > 0)
