"""The port's stochastic kernels against the JAX package's.

Each of the seven concrete kernels is built in both packages with the
same arguments, bound to the same observed stats, and evaluated on the
same numpy stats block on both ``ret_scale``s: ``compute`` and
``log_density`` to atol 1e-5 / rtol 1e-5, ``pdf_max`` to rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.sumstat import SumStatSpec as JaxSpec
from pyabc_tpu_torch.sumstat import SumStatSpec

X0 = {"a": np.array([3.0, 5.0, 0.0], np.float32),
      "b": np.array([2.0, 7.0], np.float32)}
S = 5
RTOL = ATOL = 1e-5

_RNG = np.random.default_rng(11)
_COV = _RNG.standard_normal((S, S))
COV = (_COV @ _COV.T + S * np.eye(S)).astype(np.float32)


def _jax_fn(x, x0):
    return -jnp.sum((x["a"] - x0["a"]) ** 2, axis=-1) - jnp.sum(
        jnp.abs(x["b"] - x0["b"]), axis=-1)


def _torch_fn(x, x0):
    return -((x["a"] - x0["a"]) ** 2).sum(-1) - (
        x["b"] - x0["b"]).abs().sum(-1)


def _kernels(pkg, ret_scale):
    """name -> (kernel, counts): the same seven kernels in one package;
    ``counts`` marks the kernels that read counts."""
    fn = _jax_fn if pkg is jpt else _torch_fn
    return {
        "simple_function": (pkg.SimpleFunctionKernel(fn, ret_scale=ret_scale),
                            False),
        "normal": (pkg.NormalKernel(cov=COV, ret_scale=ret_scale), False),
        "independent_normal": (pkg.IndependentNormalKernel(
            var=[0.5, 1.0, 2.0, 1.5, 0.25], ret_scale=ret_scale), False),
        "independent_laplace": (pkg.IndependentLaplaceKernel(
            scale=[1.0, 0.5, 2.0, 1.0, 3.0], ret_scale=ret_scale), False),
        "binomial": (pkg.BinomialKernel(p=0.6, ret_scale=ret_scale), True),
        "poisson": (pkg.PoissonKernel(ret_scale=ret_scale), True),
        "negative_binomial": (pkg.NegativeBinomialKernel(
            p=0.4, ret_scale=ret_scale), True),
    }


def _stats(counts: bool, rows: int = 64) -> np.ndarray:
    rng = np.random.default_rng(5)
    if counts:
        # counts around the observed ones, zeros included
        x = np.round(rng.uniform(0.0, 12.0, (rows, S)))
        x[0] = 0.0
        return x.astype(np.float32)
    x0 = np.concatenate([X0["a"], X0["b"]])
    return (x0 + rng.standard_normal((rows, S))).astype(np.float32)


@pytest.mark.parametrize("ret_scale", ["SCALE_LOG", "SCALE_LIN"])
@pytest.mark.parametrize("name", list(_kernels(pt, "SCALE_LOG")))
def test_kernel_matches_jax(name, ret_scale):
    j_kernel, counts = _kernels(jpt, ret_scale)[name]
    kernel, _ = _kernels(pt, ret_scale)[name]
    j_kernel.bind(JaxSpec.from_example(X0), X0)
    kernel.bind(SumStatSpec.from_example(X0), X0)
    stats = _stats(counts)
    obs = np.concatenate([X0["a"], X0["b"]])

    j_out = np.asarray(j_kernel.compute(jnp.asarray(stats),
                                        jnp.asarray(obs), {}))
    out = kernel.compute(torch.as_tensor(stats), torch.as_tensor(obs),
                         {}).numpy()
    assert out.shape == (stats.shape[0],)
    np.testing.assert_allclose(out, j_out, rtol=RTOL, atol=ATOL)
    if name != "simple_function":
        np.testing.assert_allclose(
            kernel.log_density(torch.as_tensor(stats),
                               torch.as_tensor(obs)).numpy(),
            np.asarray(j_kernel.log_density(jnp.asarray(stats),
                                            jnp.asarray(obs))),
            rtol=RTOL, atol=ATOL)

    if j_kernel.pdf_max is None:
        assert kernel.pdf_max is None
    else:
        np.testing.assert_allclose(kernel.pdf_max, j_kernel.pdf_max,
                                   rtol=1e-6)
    assert kernel.ret_scale == ret_scale
    assert kernel.keys == ["a", "b"]


def test_count_kernels_reject_impossible_counts():
    """A binomial count above its n, and a negative count, have density
    0 (log −inf) in both packages."""
    x0 = {"k": np.array([4.0, -1.0], np.float32)}
    stats = np.array([[3.0, 2.0], [5.0, 2.0]], np.float32)
    for j_k, k in ((jpt.BinomialKernel(p=0.5), pt.BinomialKernel(p=0.5)),
                   (jpt.PoissonKernel(), pt.PoissonKernel())):
        j_k.bind(JaxSpec.from_example(x0), None)
        k.bind(SumStatSpec.from_example(x0), None)
        obs = np.asarray(x0["k"])
        j_out = np.asarray(j_k.log_density(jnp.asarray(stats),
                                           jnp.asarray(obs)))
        out = k.log_density(torch.as_tensor(stats),
                            torch.as_tensor(obs)).numpy()
        assert np.all(np.isneginf(out)) and np.all(np.isneginf(j_out))


def test_invalid_arguments_raise():
    with pytest.raises(ValueError):
        pt.BinomialKernel(p=0.0)
    with pytest.raises(ValueError):
        pt.NegativeBinomialKernel(p=1.5)
    with pytest.raises(ValueError):
        pt.PoissonKernel(ret_scale="SCALE_SQRT")
