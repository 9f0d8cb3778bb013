"""Population-size strategies of the port against the JAX package's.

- ``ListPopulationSize`` through ``ABCSMC.run`` in both packages: the
  same size in every generation.
- ``AdaptivePopulationSize.update`` on one fitted transition: both
  packages' power-law inversions within 30 % (their bootstrap draws
  differ).
- ``AdaptivePopulationSize`` through ``ABCSMC.run`` on config #2 in both
  packages: each generation has the size the strategy set after the
  previous one, the size moves off its start in both, and both p(B) lie
  within 2·2.5/√n of the analytic value at the last size.
- A numerical failure of the adaptation is logged and the size kept;
  a device fault propagates.
"""

import logging

import numpy as np
import pytest

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.models import make_two_gaussians_problem as jax_problem
from pyabc_tpu_torch.convert import install_population_size
from pyabc_tpu_torch.models import make_two_gaussians_problem

OBSERVED_Y = float(make_two_gaussians_problem()[3]["y"])


def _run(pkg, strategy, gens, seed=1):
    problem = jax_problem if pkg is jpt else make_two_gaussians_problem
    kw = {"device": "cpu"} if pkg is pt else {}
    models, priors, distance, observed, posterior = problem()
    abc = pkg.ABCSMC(models, priors, distance, population_size=strategy,
                     sampler=pkg.VectorizedSampler(**kw), seed=seed, **kw)
    abc.new("sqlite://", observed)
    h = abc.run(max_nr_populations=gens)
    pops = h.get_all_populations()
    sizes = [len(h.get_distribution(m=0, t=t)[1])
             + len(h.get_distribution(m=1, t=t)[1])
             for t in range(h.max_t + 1)]
    return h, sizes, posterior, pops


def test_list_population_size_in_both_packages():
    values = [300, 500]
    _, jax_sizes, _, _ = _run(jpt, jpt.ListPopulationSize(values), 3)
    _, port_sizes, _, _ = _run(pt, pt.ListPopulationSize(values), 3)
    assert port_sizes == jax_sizes == [300, 500, 500]


def test_adaptive_update_within_bootstrap_noise_of_the_jax_one():
    """Unquantized, both packages' inversions land within 30 % of each
    other (their bootstrap resamples differ)."""
    rng = np.random.default_rng(3)
    theta = rng.normal(size=(1024, 1)).astype(np.float32)
    w = np.full(1024, 1 / 1024, np.float32)
    jtr = jpt.MultivariateNormalTransition().fit(theta, w)
    ptr = pt.MultivariateNormalTransition().fit(theta, w)
    for target in (0.05, 0.02):
        j = jpt.AdaptivePopulationSize(1024, mean_cv=target, quantize=False)
        p = pt.AdaptivePopulationSize(1024, mean_cv=target, quantize=False,
                                      device="cpu")
        j.update([jtr], [1.0])
        p.update([ptr], [1.0])
        assert p.nr_particles == pytest.approx(j.nr_particles, rel=0.3)
    q = pt.AdaptivePopulationSize(1024, mean_cv=0.02, device="cpu")
    q.update([ptr], [1.0])
    assert q.nr_particles == 8192  # 4948 quantized up to a power of 2


@pytest.fixture(scope="module")
def adaptive_runs():
    def strategy(pkg):
        kw = {"device": "cpu"} if pkg is pt else {}
        return pkg.AdaptivePopulationSize(400, mean_cv=0.08,
                                          max_population_size=2048,
                                          n_bootstrap=3, **kw)
    return {pkg: (_run(pkg, s, 3, seed=2), s)
            for pkg, s in ((jpt, strategy(jpt)), (pt, strategy(pt)))}


def test_adaptive_population_size_through_run(adaptive_runs):
    for pkg in (jpt, pt):
        (h, sizes, posterior, _), strategy = adaptive_runs[pkg]
        assert sizes[0] == 400
        assert any(s != 400 for s in sizes[1:]), sizes
        p_b = float(h.get_model_probabilities(h.max_t).get(1, 0.0))
        analytic = posterior(OBSERVED_Y)
        assert abs(p_b - analytic) < 2 * 2.5 / np.sqrt(sizes[-1])


def test_each_generation_has_the_size_the_strategy_set(monkeypatch):
    seen = []
    real = pt.AdaptivePopulationSize.update

    def spy(self, *args, **kwargs):
        real(self, *args, **kwargs)
        seen.append(self.nr_particles)

    monkeypatch.setattr(pt.AdaptivePopulationSize, "update", spy)
    strategy = pt.AdaptivePopulationSize(400, mean_cv=0.08,
                                         max_population_size=2048,
                                         n_bootstrap=3, device="cpu")
    _, sizes, _, _ = _run(pt, strategy, 3, seed=2)
    assert sizes[1:] == seen[:len(sizes) - 1]


def test_updates_record_the_bootstrap_shapes():
    """Each update leaves a record: the size before and after (the next
    generation's size), the alive models, the sizes tried and, per size
    and model, the bootstrap density's (test rows, support rows, d)."""
    strategy = pt.AdaptivePopulationSize(400, mean_cv=0.08,
                                         max_population_size=2048,
                                         n_bootstrap=3, device="cpu")
    h, sizes, _, _ = _run(pt, strategy, 3, seed=2)
    assert [u["t"] for u in strategy.updates] == [1, 2]
    for u, size, nxt in zip(strategy.updates, sizes, sizes[1:]):
        assert (u["before"], u["after"]) == (size, nxt)
        assert u["sizes"] == sorted({size // 2, size, min(2 * size, 2048)})
        t = u["t"] - 1
        probs = h.get_model_probabilities(t)
        alive = [m for m in (0, 1) if float(probs.get(m, 0.0)) > 0]
        assert u["alive"] == len(alive)
        want = []
        for nn in u["sizes"]:
            for m in alive:
                w = float(probs[m]) / sum(float(probs[k]) for k in alive)
                want.append((len(h.get_distribution(m=m, t=t)[1]),
                             max(int(round(w * nn)), 2), 1))
        assert u["density_shapes"] == want


@pytest.mark.parametrize("error", [
    ValueError("power law through no point"),
    np.linalg.LinAlgError("singular bootstrap covariance"),
    OverflowError("cannot convert float infinity to integer")])
def test_failed_adaptation_keeps_the_size(caplog, error):
    """A numerical failure of the adaptation is logged, the size kept."""
    class Broken(pt.AdaptivePopulationSize):
        def update(self, *args, **kwargs):
            raise error

    strategy = Broken(300, device="cpu")
    with caplog.at_level(logging.WARNING, logger="ABC"):
        _, sizes, _, _ = _run(pt, strategy, 3)
    assert sizes == [300, 300, 300]
    assert any("adaptation failed" in r.message for r in caplog.records)


def test_device_fault_in_adaptation_propagates():
    """A RuntimeError (a CUDA fault, a KDE launch that failed) inside the
    bootstrap refits ends the run instead of passing as a kept size."""
    class Faulty(pt.AdaptivePopulationSize):
        def update(self, *args, **kwargs):
            raise RuntimeError("CUDA error: an illegal memory access")

    with pytest.raises(RuntimeError, match="illegal memory access"):
        _run(pt, Faulty(300, device="cpu"), 3)


def test_install_population_size():
    s = install_population_size(pt.AdaptivePopulationSize(100), 2048)
    assert s(5) == 2048
