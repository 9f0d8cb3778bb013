"""The port's StochasticAcceptor and pdf normalizations against the JAX
package's.

- The pdf-norm methods on the same float64 inputs: equal.
- The accept step: the port's pure ``stochastic_accept`` on the uniforms
  that ``jax.random.uniform`` draws for the JAX acceptor's key gives the
  same decisions, bit for bit, on both kernel scales, with and without
  importance weighting, NaN and ±inf densities included; the float32
  weights to rtol 1e-6 (the two libraries' log and exp differ in the
  last place).
- ``initialize`` / ``update`` sequences: the per-generation norms, the
  epsilon config and the round params agree exactly.
- A round's decision (``RoundKernel._evaluate``): a density of −inf and
  a NaN density are rejected in both packages, a density above the norm
  is accepted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.acceptor.pdf_norm import ScaledPDFNorm as JaxScaled
from pyabc_tpu.sampler.rounds import RoundKernel as JaxRoundKernel
from pyabc_tpu.sumstat import SumStatSpec as JaxSpec
from pyabc_tpu_torch.acceptor import stochastic_accept
from pyabc_tpu_torch.sampler.rounds import RoundKernel
from pyabc_tpu_torch.sumstat import SumStatSpec


def _densities(lin: bool, n: int = 4096) -> np.ndarray:
    rng = np.random.default_rng(3)
    logd = rng.normal(-2.0, 3.0, n).astype(np.float32)
    logd[:4] = [np.nan, -np.inf, np.inf, 0.0]
    return np.exp(logd).astype(np.float32) if lin else logd


# ---------------------------------------------------------------- pdf norms


def _weighted(seed, n=50):
    rng = np.random.default_rng(seed)
    return rng.normal(1.0, 2.0, n), rng.dirichlet(np.ones(n))


@pytest.mark.parametrize("prev", [None, 1.5, -np.inf, 9.0])
def test_pdf_norm_methods_equal(prev):
    dens, w = _weighted(1)
    get = lambda: (dens, w)  # noqa: E731
    for kernel_val in (None, 2.5):
        assert pt.pdf_norm_max_found(kernel_val, prev, get) == \
            jpt.pdf_norm_max_found(kernel_val, prev, get)
        assert pt.pdf_norm_max_found(kernel_val, prev, None) == \
            jpt.pdf_norm_max_found(kernel_val, prev, None)
    assert pt.pdf_norm_from_kernel(2.5) == jpt.pdf_norm_from_kernel(2.5)
    for prev_temp in (None, 0.5, 1.0, 7.0, 300.0):
        for factor, alpha in ((10.0, 0.5), (3.0, 0.9)):
            assert pt.ScaledPDFNorm(factor, alpha)(
                None, prev, get, prev_temp) == JaxScaled(factor, alpha)(
                None, prev, get, prev_temp)


# ---------------------------------------------------------------- accept


@pytest.mark.parametrize("importance", [True, False])
@pytest.mark.parametrize("scale", ["SCALE_LOG", "SCALE_LIN"])
def test_accept_bit_for_bit(scale, importance):
    lin = scale == "SCALE_LIN"
    dens = _densities(lin)
    key = jax.random.PRNGKey(7)
    j_acc = jpt.StochasticAcceptor(apply_importance_weighting=importance)
    j_acc.kernel_scale = scale
    for pdf_norm, temp in ((0.5, 1.0), (-1.0, 3.7), (4.0, 250.0)):
        params = {"pdf_norm": jnp.float32(pdf_norm),
                  "temp": jnp.float32(temp)}
        j_a, j_w = j_acc.accept(key, jnp.asarray(dens), params)
        u = np.array(jax.random.uniform(key, dens.shape))
        a, w = stochastic_accept(torch.as_tensor(dens), torch.as_tensor(u),
                                 np.float32(pdf_norm), np.float32(temp),
                                 lin, importance)
        np.testing.assert_array_equal(a.numpy(), np.asarray(j_a))
        # the two libraries' float32 log and exp differ in the last place
        np.testing.assert_allclose(w.numpy(), np.asarray(j_w), rtol=1e-6,
                                   atol=0)
        assert w.dtype == torch.float32
        # NaN and -inf never accept
        assert not a[0] and not a[1]


def test_acceptor_draws_its_uniforms_from_the_generator():
    dens = torch.as_tensor(_densities(False))
    acc = pt.StochasticAcceptor()
    params = {"pdf_norm": torch.tensor(0.5), "temp": torch.tensor(2.0)}
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(4)
    g2.manual_seed(4)
    a, w = acc.accept(g1, dens, params)
    u = torch.rand(dens.shape, generator=g2)
    a2, w2 = stochastic_accept(dens, u, params["pdf_norm"], params["temp"],
                               False, True)
    assert torch.equal(a, a2)
    torch.testing.assert_close(w, w2, rtol=0, atol=0, equal_nan=True)


# ---------------------------------------------------------------- lifecycle


def _bound_kernel(pkg, scale):
    x0 = {"y": np.array([1.0, 2.0], np.float32)}
    kernel = pkg.IndependentNormalKernel(var=[0.5, 2.0], ret_scale=scale)
    spec = (JaxSpec if pkg is jpt else SumStatSpec).from_example(x0)
    kernel.bind(spec, x0)
    return kernel, x0


@pytest.mark.parametrize("scale", ["SCALE_LOG", "SCALE_LIN"])
@pytest.mark.parametrize("method", ["max_found", "from_kernel", "scaled"])
def test_initialize_update_sequence(method, scale, tmp_path):
    methods = {"max_found": (None, None),
               "from_kernel": (jpt.pdf_norm_from_kernel,
                               pt.pdf_norm_from_kernel),
               "scaled": (JaxScaled(5.0, 0.5), pt.ScaledPDFNorm(5.0, 0.5))}
    j_m, m = methods[method]
    j_acc = jpt.StochasticAcceptor(pdf_norm_method=j_m,
                                   log_file=str(tmp_path / "jax.json"))
    acc = pt.StochasticAcceptor(pdf_norm_method=m,
                                log_file=str(tmp_path / "port.json"))
    j_kernel, x0 = _bound_kernel(jpt, scale)
    kernel, _ = _bound_kernel(pt, scale)
    assert kernel.pdf_max == pytest.approx(j_kernel.pdf_max, rel=1e-6)
    kernel.pdf_max = j_kernel.pdf_max
    lin = scale == "SCALE_LIN"
    seq = [_weighted(s) for s in range(5)]
    if lin:
        seq = [(np.exp(d), w) for d, w in seq]
    temps = [None, 40.0, 8.0, 2.0, 1.0]
    for t, ((d, w), temp) in enumerate(zip(seq, temps)):
        get = lambda d=d, w=w: (d, w)  # noqa: E731
        if t == 0:
            j_acc.initialize(0, get, j_kernel, x0)
            acc.initialize(0, get, kernel, x0)
        else:
            j_acc.update(t, get, temp, 0.3)
            acc.update(t, get, temp, 0.3)
        assert acc.pdf_norms == j_acc.pdf_norms
        assert acc.get_epsilon_config(t) == j_acc.get_epsilon_config(t)
        eps = lambda t: 3.0  # noqa: E731
        j_params = j_acc.get_params(t, eps)
        params = acc.get_params(t, eps)
        for k in ("pdf_norm", "temp"):
            assert np.float32(params[k]) == np.float32(j_params[k])
    assert acc.kernel_scale == scale
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()


def test_installed_norms_are_kept():
    acc = pt.StochasticAcceptor()
    pt.convert.install_annealing(pt.Temperature(), acc, {}, {1: -3.5})
    get = lambda: (np.array([2.0, 5.0]), np.array([0.5, 0.5]))  # noqa: E731
    acc.initialize(0, get)
    acc.update(1, get, 10.0)
    acc.update(2, get, 5.0)
    assert acc.pdf_norms == {0: 5.0, 1: -3.5, 2: 5.0}


# ---------------------------------------------------------------- rounds


def test_round_decisions_on_log_densities():
    """The model's stat is the log density itself (theta's column);
    densities 5 (above the norm 0), −inf, NaN and −1e30."""
    theta = np.array([[5.0], [-np.inf], [np.nan], [-1e30]], np.float32)
    m = np.zeros(4, np.int32)
    x0 = {"llh": np.float32(0.0)}
    params = {"distance": {}, "acceptor": {"pdf_norm": np.float32(0.0),
                                           "temp": np.float32(1.0)}}
    expected = [True, False, False, False]

    j_kernel = jpt.SimpleFunctionKernel(
        lambda x, x_0: jnp.reshape(x["llh"], (-1,)), ret_scale="SCALE_LOG")
    j_spec = JaxSpec.from_example(x0)
    j_kernel.bind(j_spec, x0)
    j_round = JaxRoundKernel(
        models=[jpt.SimpleModel(lambda key, th: {"llh": th[:, 0]})],
        parameter_priors=[jpt.Distribution(k=jpt.RV("uniform", 0, 1))],
        model_prior_logits=np.zeros(1, np.float32),
        model_perturbation_kernel=jpt.ModelPerturbationKernel(1),
        transitions=[jpt.MultivariateNormalTransition()],
        distance=j_kernel, acceptor=jpt.StochasticAcceptor(),
        spec=j_spec, obs_flat=j_spec.flatten_single(x0), dim=1)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    _, j_d, j_acc, _ = j_round._replicated_evaluate(
        k1, k2, jnp.asarray(theta), jnp.asarray(m),
        {"distance": {}, "acceptor": {k: jnp.asarray(v) for k, v in
                                      params["acceptor"].items()}})

    kernel = pt.SimpleFunctionKernel(lambda x, x_0: x["llh"].reshape(-1),
                                     ret_scale="SCALE_LOG")
    spec = SumStatSpec.from_example(x0)
    kernel.bind(spec, x0)
    rk = RoundKernel(
        models=[pt.SimpleModel(lambda g, th: {"llh": th[:, 0]})],
        parameter_priors=[pt.Distribution(k=pt.RV("uniform", 0, 1))],
        model_prior_logits=np.zeros(1, np.float32),
        model_perturbation_kernel=pt.ModelPerturbationKernel(1),
        transitions=[pt.MultivariateNormalTransition()],
        distance=kernel, acceptor=pt.StochasticAcceptor(), spec=spec,
        obs_flat=spec.flatten_single(x0), dim=1)
    gen = torch.Generator()
    gen.manual_seed(0)
    _, d, acc, _ = rk._evaluate(
        gen, torch.as_tensor(theta), torch.as_tensor(m, dtype=torch.int64),
        {"distance": {}, "acceptor": {k: torch.as_tensor(v) for k, v in
                                      params["acceptor"].items()}})
    np.testing.assert_array_equal(d.numpy(), np.asarray(j_d))
    assert acc.tolist() == expected
    assert np.asarray(j_acc).tolist() == expected
