"""BASELINE config #5 through ``ABCSMC.run`` in both packages on the CPU:
the JAX package's ``petab_ode_pop100k`` problem (one rate ``k``, uniform
on [0.01, 3], ``rhs = −k·y``, RK4 at dt = 0.1, four observations with
σ = 0.05, data from ``default_rng(0)``) through ``ODEPetabImporter``,
``Temperature(aggregate_fun=max)`` and ``StochasticAcceptor()``, at pop
2000 with a pinned batch of 4096 and 6 generations.

- The exact posterior: at T = 1 the weighted population samples the
  Bayes posterior of the model's likelihood, here the quadrature of the
  same RK4 likelihood over 40001 points of the prior (closed form: one
  step multiplies by the RK4 factor of ``k·dt``).  Both packages' last
  generation: |mean − μ_q| ≤ max(1e-3, 4·σ_q/√ESS) and |std/σ_q − 1| ≤
  0.05 + 4/√(2·ESS).
- Replay: the JAX run's temperatures and pdf norms installed in the port
  (``convert.install_annealing``); the port's last-generation mean is
  within 4·σ_q/√ESS of the JAX run's (ESS the smaller of the two).
- Both stop on "Stopping: temperature reached 1"; the port's own run
  anneals monotonically to 1 with its acceptance-rate proposals read
  from records that carry real proposal densities.
- Resume: a fresh run ``load``s the database and continues from the
  stored temperature; both packages refuse a stochastic acceptor with a
  threshold epsilon.
"""

import numpy as np
import pandas as pd
import pytest

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.petab import ODEPetabImporter as JaxODEImporter
from pyabc_tpu_torch.convert import install_annealing
from pyabc_tpu_torch.petab import ODEPetabImporter

POP, GENS, BATCH = 2000, 6, 4096
T_MAX, N_STEPS, SIGMA = 2.0, 20, 0.05
OBS_IDX = np.asarray([4, 9, 14, 19])
TIMES = (OBS_IDX + 1) * (T_MAX / N_STEPS)
DATA = np.exp(-0.7 * TIMES) + SIGMA * np.random.default_rng(0).normal(
    size=TIMES.shape)
STOP = "Stopping: temperature reached 1"


def quadrature(points: int = 40001):
    """(mean, std) of the exact posterior of k by quadrature of the RK4
    likelihood over the uniform prior."""
    k = np.linspace(0.01, 3.0, points)
    h = k * (T_MAX / N_STEPS)
    factor = 1 - h + h ** 2 / 2 - h ** 3 / 6 + h ** 4 / 24
    y = factor[:, None] ** (OBS_IDX + 1)[None, :]
    llh = np.sum(-0.5 * ((y - DATA) / SIGMA) ** 2
                 - 0.5 * np.log(2 * np.pi * SIGMA ** 2), axis=1)
    p = np.exp(llh - llh.max())
    p /= p.sum()
    mean = float(np.sum(k * p))
    return mean, float(np.sqrt(np.sum(p * (k - mean) ** 2)))


MU_Q, SD_Q = quadrature()


def _parameter_df():
    return pd.DataFrame({
        "parameterId": ["k"], "parameterScale": ["lin"],
        "lowerBound": [0.01], "upperBound": [3.0], "estimate": [1],
        "objectivePriorType": ["uniform"],
        "objectivePriorParameters": ["0.01;3.0"]}).set_index("parameterId")


def _importer(cls):
    return cls(_parameter_df(), rhs=lambda y, th: -th[:, 0:1] * y,
               y0=[1.0], t_max=T_MAX, n_steps=N_STEPS, obs_idx=OBS_IDX,
               measurements={"y0": DATA}, sigma=SIGMA)


def _port_abc(eps=None, acceptor=None, seed=1):
    imp = _importer(ODEPetabImporter)
    return pt.ABCSMC(
        imp.create_model(), imp.create_prior(), imp.create_kernel(),
        population_size=POP,
        eps=eps if eps is not None else pt.Temperature(aggregate_fun=max),
        acceptor=acceptor if acceptor is not None
        else pt.StochasticAcceptor(),
        sampler=pt.VectorizedSampler(min_batch_size=BATCH,
                                     max_batch_size=BATCH, device="cpu"),
        seed=seed), imp


def _moments(history):
    pop = history.get_population(history.max_t)
    k = np.asarray(pop.theta, np.float64)[:, 0]
    w = np.asarray(pop.weight, np.float64)
    w /= w.sum()
    mean = float(np.sum(w * k))
    return mean, float(np.sqrt(np.sum(w * (k - mean) ** 2))), \
        float(1.0 / np.sum(w ** 2))


def _gate(mean, std, ess):
    assert abs(mean - MU_Q) <= max(1e-3, 4 * SD_Q / np.sqrt(ess)), \
        (mean, MU_Q, ess)
    assert abs(std / SD_Q - 1) <= 0.05 + 4 / np.sqrt(2 * ess), \
        (std, SD_Q, ess)


@pytest.fixture(scope="module")
def jax_run():
    imp = _importer(JaxODEImporter)
    eps = jpt.Temperature(aggregate_fun=max)
    acc = jpt.StochasticAcceptor()
    abc = jpt.ABCSMC(
        models=imp.create_model(), parameter_priors=imp.create_prior(),
        distance_function=imp.create_kernel(), population_size=POP,
        eps=eps, acceptor=acc,
        sampler=jpt.VectorizedSampler(min_batch_size=BATCH,
                                      max_batch_size=BATCH), seed=0)
    abc.new("sqlite://", imp.get_observed())
    history = abc.run(max_nr_populations=GENS)
    return abc, eps, acc, history


@pytest.fixture(scope="module")
def port_run():
    abc, imp = _port_abc()
    abc.new("sqlite://", imp.get_observed())
    return abc, abc.run(max_nr_populations=GENS)


def test_quadrature_posterior():
    assert (round(MU_Q, 3), round(SD_Q, 4)) == (0.685, 0.0523)


def test_jax_posterior_is_exact(jax_run):
    abc, eps, _, history = jax_run
    assert history.max_t == GENS - 1 and eps(GENS - 1) == 1.0
    _gate(*_moments(history))


def test_port_posterior_is_exact(port_run):
    abc, history = port_run
    assert history.max_t == GENS - 1
    temps = [abc.eps(t) for t in range(GENS)]
    assert temps[-1] == 1.0
    assert all(a >= b for a, b in zip(temps, temps[1:]))
    # the acceptance-rate proposals come from records with real proposal
    # densities: a NaN-poisoned solve would give the 1/exp(-100) limit
    for t in range(1, GENS - 1):
        assert 1.0 <= abc.eps.temperature_proposals[t][
            "AcceptanceRateScheme"] < 1e6
    for row in abc.timeline:
        assert row["records"] > 0 and row["record_batches"] >= 1
    assert abc.sampler.record_rejected and \
        abc.sampler.record_proposal_density
    assert set(abc.acceptor.pdf_norms) == set(range(GENS))
    _gate(*_moments(history))


def test_port_replays_the_jax_schedule(jax_run):
    _, j_eps, j_acc, j_history = jax_run
    temp, acc = install_annealing(pt.Temperature(aggregate_fun=max),
                                  pt.StochasticAcceptor(),
                                  j_eps.temperatures, j_acc.pdf_norms)
    abc, imp = _port_abc(eps=temp, acceptor=acc, seed=2)
    abc.new("sqlite://", imp.get_observed())
    history = abc.run(max_nr_populations=GENS)
    assert temp.temperatures == {int(t): float(v)
                                 for t, v in j_eps.temperatures.items()}
    assert acc.pdf_norms == {int(t): float(v)
                             for t, v in j_acc.pdf_norms.items()}
    mean, std, ess = _moments(history)
    j_mean, _, j_ess = _moments(j_history)
    _gate(mean, std, ess)
    assert abs(mean - j_mean) <= 4 * SD_Q / np.sqrt(min(ess, j_ess)), \
        (mean, j_mean)


def test_stop_reason_is_the_same(jax_run, port_run):
    assert jax_run[0].timeline.stop_reason == STOP
    assert port_run[0].stop_reason == STOP


def test_resume_continues_from_the_stored_temperature(tmp_path):
    """The first process stops on its simulation budget while T > 1; a
    second one loads the database and anneals on from the stored T (the
    populations' epsilon column), not from T = inf."""
    db = f"sqlite:///{tmp_path / 'run.db'}"
    abc, imp = _port_abc(seed=3)
    abc.new(db, imp.get_observed())
    abc.run(max_nr_populations=GENS, max_total_nr_simulations=3 * BATCH)
    t_stop = abc.history.max_t
    stored = float(abc.history.get_all_populations().epsilon.iloc[-1])
    assert t_stop < GENS - 1 and stored == abc.eps(t_stop) > 1.0

    temp = pt.Temperature(aggregate_fun=max)
    abc2, _ = _port_abc(eps=temp, seed=4)
    abc2.load(db)
    history = abc2.run(max_nr_populations=GENS)
    assert temp.temperatures[t_stop] == stored
    # the resumed first generation has no records yet: the acceptance-rate
    # scheme proposes its numerics limit and the clamp keeps the stored T
    assert temp(t_stop + 1) == stored
    assert abc2.stop_reason == STOP and temp(history.max_t) == 1.0
    eps = history.get_all_populations().epsilon.to_numpy()[1:]
    assert np.all(np.diff(eps) <= 0) and eps[t_stop] == stored


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_stochastic_acceptor_needs_a_temperature(pkg):
    if pkg == "jax":
        imp = _importer(JaxODEImporter)
        with pytest.raises(ValueError, match="together"):
            jpt.ABCSMC(imp.create_model(), imp.create_prior(),
                       imp.create_kernel(), eps=jpt.MedianEpsilon(),
                       acceptor=jpt.StochasticAcceptor())
        return
    with pytest.raises(ValueError, match="together"):
        _port_abc(eps=pt.MedianEpsilon())
    with pytest.raises(ValueError, match="together"):
        pt.ABCSMC(lambda g, th: {"y": th[:, 0]},
                  pt.Distribution(k=pt.RV("uniform", 0.0, 1.0)),
                  pt.PNormDistance(), eps=pt.Temperature(),
                  device="cpu")
