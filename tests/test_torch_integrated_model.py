"""The port's IntegratedModel and the round's early-reject branch, twin
of tests/test_integrated_model.py: the mask comes back from
``integrated_simulate``, a plain ``simulate`` drops it, and in a run no
early-rejected candidate is accepted although its distance would be.
One theta batch and one eps go through both packages' round evaluation,
which must give the same early-reject and accept masks (exact), the
same statistics and distances (rtol 1e-6) and the same eps."""

import math

import numpy as np
import pytest
import torch

import pyabc_tpu_torch as pt
from pyabc_tpu_torch.model import IntegratedModel, ModelResult


class ThresholdModel(IntegratedModel):
    """y = theta + noise; candidates with theta > cut reject early."""

    def __init__(self, cut: float = 0.5):
        super().__init__(name="threshold")
        self.cut = cut
        self.eps_seen = []

    def integrated_simulate(self, generator, theta, eps):
        self.eps_seen.append(float(eps))
        mu = theta[:, 0]
        y = mu + 0.1 * torch.randn(mu.shape, generator=generator,
                                   device=mu.device)
        return ModelResult(sum_stats={"y": y}, early_reject=mu > self.cut)


def test_integrated_simulate_masks():
    m = ThresholdModel(cut=0.5)
    theta = torch.tensor([[0.2], [0.8]])
    gen = torch.Generator().manual_seed(0)
    res = m.integrated_simulate(gen, theta, math.inf)
    assert res.early_reject.tolist() == [False, True]
    assert m.simulate(gen, theta)["y"].shape == (2,)


def test_integrated_model_early_reject_e2e(db_path):
    model = ThresholdModel(cut=0.5)
    abc = pt.ABCSMC(
        models=model,
        parameter_priors=pt.Distribution(mu=pt.RV("uniform", 0.0, 1.0)),
        distance_function=pt.PNormDistance(p=2),
        population_size=200,
        sampler=pt.VectorizedSampler(device="cpu"),
        seed=6)
    abc.new(db_path, {"y": 0.5})
    h = abc.run(max_nr_populations=2)
    df, w = h.get_distribution(m=0)
    mu = df["mu"].to_numpy()
    assert float(mu.max()) <= 0.5 + 1e-6
    assert len(mu) == 200
    # calibration runs at eps = inf, the generations at their epsilon
    assert math.isinf(model.eps_seen[0])
    assert any(math.isfinite(e) for e in model.eps_seen)


def test_plain_models_keep_their_accepts(db_path):
    """Without an IntegratedModel the round's accept mask is unchanged:
    the posterior crosses the cut."""
    def model(generator, theta):
        mu = theta[:, 0]
        return {"y": mu + 0.1 * torch.randn(mu.shape, generator=generator)}

    abc = pt.ABCSMC(model, pt.Distribution(mu=pt.RV("uniform", 0.0, 1.0)),
                    pt.PNormDistance(p=2), population_size=200,
                    sampler=pt.VectorizedSampler(device="cpu"), seed=6)
    abc.new(db_path, {"y": 0.5})
    df, _ = abc.run(max_nr_populations=2).get_distribution(m=0)
    assert float(np.max(df["mu"].to_numpy())) > 0.5


# ---- the round's early-reject branch against the JAX package -------------

CUT = 0.6


def _early(mu, y, eps, cut, absolute):
    """Reject early above the cut, and where y is farther from 0.5 than
    twice the round's epsilon (so the mask depends on the eps passed in)."""
    return (mu > cut) | (absolute(y - 0.5) > 2.0 * eps)


class PortShifted(IntegratedModel):
    """Deterministic y = mu + 0.25 sin(7 mu) with the early mask above."""

    def __init__(self):
        super().__init__(name="shifted")
        self.eps_seen = []

    def integrated_simulate(self, generator, theta, eps):
        self.eps_seen.append(float(eps))
        mu = theta[:, 0]
        y = mu + 0.25 * torch.sin(7.0 * mu)
        return ModelResult(sum_stats={"y": y},
                           early_reject=_early(mu, y, eps, CUT, torch.abs))


def _jax_kernel_and_port_kernel(n_models):
    """The same one- or two-model problem as a RoundKernel in each
    package: model 0 is the IntegratedModel, model 1 a plain y = mu."""
    import jax.numpy as jnp

    import pyabc_tpu as jpt
    from pyabc_tpu.model import IntegratedModel as JaxIntegratedModel
    from pyabc_tpu.model import ModelResult as JaxModelResult
    from pyabc_tpu.sampler.rounds import RoundKernel as JaxRoundKernel
    from pyabc_tpu.sumstat import SumStatSpec as JaxSpec
    from pyabc_tpu.transition import MultivariateNormalTransition as JaxMVN
    from pyabc_tpu_torch.sampler.rounds import RoundKernel
    from pyabc_tpu_torch.sumstat import SumStatSpec

    class JaxShifted(JaxIntegratedModel):
        def __init__(self):
            super().__init__(name="shifted")
            self.eps_seen = []

        def integrated_simulate(self, key, theta, eps):
            self.eps_seen.append(float(eps))
            mu = theta[:, 0]
            y = mu + 0.25 * jnp.sin(7.0 * mu)
            return JaxModelResult(sum_stats={"y": y},
                                  early_reject=_early(mu, y, eps, CUT,
                                                      jnp.abs))

    obs = {"y": np.float32(0.5)}
    j_models = [JaxShifted(),
                jpt.SimpleModel(lambda key, th: {"y": th[:, 0]})][:n_models]
    models = [PortShifted(),
              pt.SimpleModel(lambda gen, th: {"y": th[:, 0]})][:n_models]
    j_spec = JaxSpec.from_example({"y": jnp.float32(0.5)})
    j_dist = jpt.PNormDistance(p=2)
    j_dist.bind(j_spec, obs)
    j_kernel = JaxRoundKernel(
        j_models, [jpt.Distribution(mu=jpt.RV("uniform", 0.0, 1.0))]
        * n_models, np.zeros(n_models, np.float32),
        jpt.ModelPerturbationKernel(n_models, 0.7), [JaxMVN()] * n_models,
        j_dist, jpt.UniformAcceptor(), j_spec, j_spec.flatten_single(obs),
        dim=1)
    spec = SumStatSpec.from_example(obs)
    dist = pt.PNormDistance(p=2)
    dist.bind(spec, obs)
    kernel = RoundKernel(
        models, [pt.Distribution(mu=pt.RV("uniform", 0.0, 1.0))] * n_models,
        np.zeros(n_models, np.float32),
        pt.ModelPerturbationKernel(n_models, 0.7),
        [pt.MultivariateNormalTransition()] * n_models, dist,
        pt.UniformAcceptor(), spec, spec.flatten_single(obs), dim=1)
    return j_kernel, kernel


@pytest.mark.parametrize("n_models", [1, 2])
@pytest.mark.parametrize("eps", [0.05, 0.2, math.inf])
def test_early_reject_round_matches_jax(n_models, eps):
    """One theta batch and one eps through both packages' round
    evaluation: the same statistics and distances (float32, rtol 1e-6),
    the same early-reject mask, the same accept mask (exact) and the
    same eps handed to the IntegratedModel.  Calibration (all accepted)
    ignores the early mask in both."""
    import jax
    import jax.numpy as jnp

    from pyabc_tpu_torch.convert import to_torch

    j_kernel, kernel = _jax_kernel_and_port_kernel(n_models)
    rng = np.random.default_rng(17)
    theta = rng.uniform(0.0, 1.0, (257, 1)).astype(np.float32)
    m = rng.integers(0, n_models, 257).astype(np.int32)
    j_params = {"distance": j_kernel.distance.get_params(0),
                "acceptor": j_kernel.acceptor.get_params(0, lambda t: eps)}
    params = to_torch({"distance": kernel.distance.get_params(0),
                       "acceptor": kernel.acceptor.get_params(
                           0, lambda t: eps)}, "cpu")
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    t_theta = torch.as_tensor(theta)
    t_m = torch.as_tensor(m.astype(np.int64))
    j_eps = j_kernel._eps_hint(j_params["acceptor"])
    _, j_early = j_kernel._simulate_all(key, jnp.asarray(theta),
                                        jnp.asarray(m), j_eps)
    _, early = kernel._simulate_all(gen, t_theta, t_m,
                                    params["acceptor"]["eps"])
    np.testing.assert_array_equal(early.numpy(), np.asarray(j_early))
    for all_accepted in (False, True):
        j_out = j_kernel._replicated_evaluate(
            key, key, jnp.asarray(theta), jnp.asarray(m), j_params,
            all_accepted=all_accepted)
        out = kernel._evaluate(gen, t_theta, t_m, params,
                               all_accepted=all_accepted)
        np.testing.assert_allclose(out[0].numpy(), np.asarray(j_out[0]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(out[1].numpy(), np.asarray(j_out[1]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(out[2].numpy(), np.asarray(j_out[2]))
    j_seen = j_kernel.models[0].eps_seen
    seen = kernel.models[0].eps_seen
    assert seen == j_seen and len(seen) == 3
    assert seen[0] == pytest.approx(eps)
    # the early mask removed candidates the acceptor alone would take
    early = early.numpy()
    would = np.asarray(j_out[1]) <= eps
    assert (early & would & (m == 0)).any()
    assert not (early & (m == 1)).any()
