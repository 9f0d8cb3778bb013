"""The generation's resampling CDFs, built once before its rounds.

``RoundKernel.prepare`` builds the model mix's CDF and each model's
support CDF once a generation; the rounds only draw uniforms and invert
them.  A run with the prepare step made a no-op builds the same CDFs in
every round with the same ops, so both runs must write the same History
bit for bit: populations, weights, model probabilities, every blob and
the digest column, in the sequential engine and in fused blocks.  A spy
on ``resampling_cdf`` counts M + 1 CDFs a generation with the prepare
step and none inside a round, and no softmax runs inside a round.
"""

import contextlib
import sqlite3

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import pyabc_tpu_torch as pt
from pyabc_tpu_torch.convert import to_torch
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.ops.choice import (choice_from_cdf,
                                        fast_weighted_choice,
                                        resampling_cdf)
from pyabc_tpu_torch.sampler import rounds
from pyabc_tpu_torch.sampler.device_loop import RoundProgram
from pyabc_tpu_torch.sampler.rounds import RoundKernel
from pyabc_tpu_torch.transition import (DiscreteRandomWalkTransition,
                                        LocalTransition,
                                        MultivariateNormalTransition)
from pyabc_tpu_torch.transition import base as transition_base

ENGINES = {"sequential": {"ingest_mode": "sequential",
                          "history_mode": "eager"},
           "fused": {"fuse_generations": 2}}
GENS = 5


_SOFTMAX = (torch.softmax, torch.Tensor.softmax, torch.nn.functional.softmax,
            torch.log_softmax, torch.Tensor.log_softmax,
            torch.nn.functional.log_softmax)


class _CountSoftmax(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _SOFTMAX:
            self.calls += 1
        return func(*args, **(kwargs or {}))


class _CdfBuilds:
    """The resampling CDFs built (``resampling_cdf`` calls, under each
    name the prepare step and a round's draws call it by) for each
    generation from t = 1: ``gens[i]`` is ``[built by its prepare step,
    built inside its rounds]``; ``prior``: built inside the rounds before
    the first prepare step (t = 0)."""

    def __init__(self):
        self.gens = []
        self.prior = 0
        self._where = None

    def spy(self, fn):
        def resampling_cdf(log_w):
            if self._where == "prepare":
                self.gens[-1][0] += 1
            elif self._where == "round":
                if self.gens:
                    self.gens[-1][1] += 1
                else:
                    self.prior += 1
            return fn(log_w)
        return resampling_cdf

    @contextlib.contextmanager
    def inside(self, where: str):
        outer, self._where = self._where, where
        try:
            yield
        finally:
            self._where = outer


def _run(db, engine, monkeypatch, prepared: bool):
    """Config #2 at pop 2000 on the CPU; ``(abc, softmax calls inside
    rounds, the CDFs built)``."""
    counter = _CountSoftmax()
    builds = _CdfBuilds()
    run = RoundProgram.run
    prepare = (RoundKernel.prepare if prepared
               else lambda self, params, into=None: params)

    def counted_run(self, generator, params):
        with counter, builds.inside("round"):
            return run(self, generator, params)

    def counted_prepare(self, params, into=None):
        if "transition" in params:
            builds.gens.append([0, 0])
        with builds.inside("prepare"):
            return prepare(self, params, into=into)

    with monkeypatch.context() as mp:
        mp.setattr(RoundProgram, "run", counted_run)
        mp.setattr(RoundKernel, "prepare", counted_prepare)
        for module in (rounds, transition_base):
            mp.setattr(module, "resampling_cdf",
                       builds.spy(module.resampling_cdf))
        models, priors, distance, observed, _ = make_two_gaussians_problem()
        abc = pt.ABCSMC(models, priors, distance, population_size=2000,
                        sampler=pt.VectorizedSampler(device="cpu"), seed=3,
                        device="cpu", **ENGINES[engine])
        abc.new("sqlite:///" + str(db), observed)
        abc.run(max_nr_populations=GENS)
    return abc, counter.calls, builds


def _tables(db):
    with sqlite3.connect(str(db)) as conn:
        pops = conn.execute(
            "SELECT t, epsilon, nr_samples, lazy, summary, summary_grid "
            "FROM populations ORDER BY t").fetchall()
        models = conn.execute(
            "SELECT t, m, name, p_model, n_particles, theta, weight, "
            "distance, stats, digest FROM model_populations "
            "ORDER BY t, m").fetchall()
    return pops, models


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_prepared_cdfs_write_the_history_of_rounds_that_build_their_own(
        engine, tmp_path, monkeypatch):
    a, a_softmax, a_builds = _run(tmp_path / "prepared.db", engine,
                                  monkeypatch, True)
    b, b_softmax, b_builds = _run(tmp_path / "per_round.db", engine,
                                  monkeypatch, False)
    paths = [r["path"] for r in a.timeline]
    assert paths == [r["path"] for r in b.timeline]
    if engine == "fused":
        assert set(paths[1:]) - {"sequential"}, paths
    ha, hb = a.history, b.history
    for t in range(GENS):
        pa, pb = ha.get_population(t), hb.get_population(t)
        for key in ("m", "theta", "weight", "distance"):
            np.testing.assert_array_equal(np.asarray(getattr(pa, key)),
                                          np.asarray(getattr(pb, key)))
    assert ha.get_model_probabilities().equals(hb.get_model_probabilities())
    pops_a, models_a = _tables(tmp_path / "prepared.db")
    pops_b, models_b = _tables(tmp_path / "per_round.db")
    assert pops_a == pops_b
    assert models_a == models_b and all(row[-1] for row in models_a)

    M = len(a.models)
    assert a_builds.prior == 0
    assert a_builds.gens == [[M + 1, 0]] * (GENS - 1)
    assert a_softmax == 0
    # the rounds that build their own: M + 1 CDFs each round, and the
    # softmax inside them
    assert b_builds.prior == 0
    assert b_builds.gens == [
        [0, (M + 1) * (r.get("rounds") or r["evaluations"] // r["batch"])]
        for r in b.timeline[1:]]
    assert b_softmax >= (M + 1) * (GENS - 1)


def test_choice_from_a_prepared_cdf_is_fast_weighted_choice():
    log_w = torch.randn(5000)
    log_w[-700:] = -1e30   # pad rows
    g1 = torch.Generator().manual_seed(11)
    g2 = torch.Generator().manual_seed(11)
    a = fast_weighted_choice(g1, log_w, 4096)
    b = choice_from_cdf(g2, resampling_cdf(log_w), 4096)
    assert torch.equal(a, b)
    assert torch.equal(g1.get_state(), g2.get_state())
    assert int(a.max()) < 5000 - 700


@pytest.mark.parametrize("transition", [
    MultivariateNormalTransition, LocalTransition,
    DiscreteRandomWalkTransition])
def test_transitions_draw_the_same_from_a_prepared_cdf(transition):
    rng = np.random.default_rng(4)
    theta = rng.normal(size=(300, 2)).astype(np.float32)
    if transition is DiscreteRandomWalkTransition:
        theta = np.round(theta * 3)
        tr = transition()
    elif transition is LocalTransition:
        tr = transition(device="cpu")
    else:
        tr = transition()
    tr.fit(theta, rng.uniform(0.1, 1.0, 300).astype(np.float32))
    params = to_torch(tr.pad_params(tr.get_params(), 512), "cpu")
    prepared = {k: v for k, v in params.items() if k != "log_w"}
    prepared["cdf"] = resampling_cdf(params["log_w"])
    g1 = torch.Generator().manual_seed(2)
    g2 = torch.Generator().manual_seed(2)
    a = tr.rvs_from_params(g1, params, 1000)
    b = tr.rvs_from_params(g2, prepared, 1000)
    assert torch.equal(a, b)
    assert torch.equal(g1.get_state(), g2.get_state())


def test_prepare_counts_its_builds_and_writes_into_the_graphs_inputs(
        monkeypatch):
    """``into`` (a captured round's own params): a CDF of the same spec
    is written into that tensor in place; the prior round's params pass
    through untouched."""
    log_w = torch.randn(64)
    params = {"model_log_probs": torch.log(torch.tensor([0.3, 0.7])),
              "transition": ({"support": torch.randn(64, 1),
                              "log_w": log_w, "chol": torch.ones(1, 1)},),
              "distance": {}}
    k = RoundKernel.__new__(RoundKernel)
    built = []
    monkeypatch.setattr(rounds, "resampling_cdf",
                        lambda log_w: built.append(log_w)
                        or resampling_cdf(log_w))
    out = k.prepare(params)
    assert len(built) == 2
    assert "log_w" not in out["transition"][0]
    assert "model_log_probs" not in out
    assert torch.equal(out["transition"][0]["cdf"], resampling_cdf(log_w))
    assert torch.equal(out["model_cdf"],
                       resampling_cdf(params["model_log_probs"]))
    own = {"model_cdf": torch.zeros(2),
           "transition": ({"cdf": torch.zeros(64)},)}
    again = k.prepare(params, into=own)
    assert again["transition"][0]["cdf"] is own["transition"][0]["cdf"]
    assert again["model_cdf"] is own["model_cdf"]
    assert torch.equal(own["transition"][0]["cdf"], resampling_cdf(log_w))
    prior = {"distance": {}, "acceptor": {}}
    assert k.prepare(prior) is prior


def test_a_capture_donates_the_tensors_under_the_round_programs_own_keys():
    """The round graph takes the prepared CDFs as its own inputs: every
    leaf under an ``OWN_KEYS`` dict key is donated, with the donated
    argument's leaves, and no other."""
    from pyabc_tpu_torch.autotune.ladder import _flatten
    from pyabc_tpu_torch.sampler.device_loop import OWN_KEYS

    cdf, model_cdf, support, buf = (torch.zeros(3), torch.zeros(2),
                                    torch.zeros(3, 1), torch.zeros(4))
    params = {"transition": ({"support": support, "cdf": cdf},),
              "model_cdf": model_cdf, "distance": {}}
    gen = torch.Generator()
    leaves, _, donated = _flatten((gen, params, {"bufs": {"m": buf}}),
                                  (2,), OWN_KEYS)
    assert {id(leaves[i]) for i in donated} == {id(cdf), id(model_cdf),
                                                id(buf)}
    _, _, plain = _flatten((gen, params, {"bufs": {"m": buf}}), (2,))
    assert {id(leaves[i]) for i in plain} == {id(buf)}
