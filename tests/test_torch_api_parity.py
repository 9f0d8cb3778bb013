"""Public-API parity of the port with the JAX package.

Every name of ``pyabc_tpu.__all__`` resolves in ``pyabc_tpu_torch``, and the parity classes compute what
the JAX ones compute on the same numpy inputs (exactly, or to float32
rounding where a density is evaluated).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt

#: names of ``pyabc_tpu.__all__`` the port leaves out, with the reason
#: (none since the sharded data plane was ported)
LEFT_OUT = {}


@pytest.mark.parametrize("name", sorted(jpt.__all__))
def test_every_jax_export_resolves(name):
    if name in LEFT_OUT:
        assert not hasattr(pt, name), f"{name} is ported: drop it from LEFT_OUT"
        return
    assert hasattr(pt, name), f"missing port export: {name}"
    assert name in pt.__all__


def test_subpackages_and_version():
    for name in ("autotune", "resilience", "telemetry"):
        assert getattr(pt, name).__name__ == f"pyabc_tpu_torch.{name}"
    assert pt.__version__ == jpt.__version__


def test_new_parity_classes_are_functional():
    """The port's twin of ``tests/test_api_parity.py``'s test, each
    output held to the JAX package's."""
    d = np.asarray([0.1, 5.0, 2.0], np.float32)
    fun = lambda dist, eps: dist <= eps * 2  # noqa: E731
    mask_j, w_j = jpt.SimpleFunctionAcceptor(fun).accept(
        None, jnp.asarray(d), {"eps": jnp.float32(1.0)})
    mask_p, w_p = pt.SimpleFunctionAcceptor(fun).accept(
        None, torch.from_numpy(d), {"eps": torch.tensor(1.0)})
    np.testing.assert_array_equal(mask_p.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(w_p.numpy(), np.asarray(w_j))
    assert mask_p.tolist() == [True, False, True]

    rv = pt.TruncatedRV(pt.RV("norm", 0.0, 1.0), lower=0.0)
    assert isinstance(rv, pt.RVDecorator)

    args = dict(m=np.array([0, 1, 0], np.int32),
                theta=np.arange(6, dtype=np.float32).reshape(3, 2),
                weight=np.array([0.2, 0.3, 0.5], np.float32),
                distance=np.array([0.5, 0.25, 0.125], np.float32))
    parts_j = jpt.Population(**args).to_particles(param_names=["a", "b"])
    parts_p = pt.Population(**args).to_particles(param_names=["a", "b"])
    assert [vars(p) for p in parts_p] == [vars(p) for p in parts_j]
    assert parts_p[1].parameter == {"a": 2.0, "b": 3.0}
    list_j = jpt.Population(**args).get_list()
    list_p = pt.Population(**args).get_list()
    for a, b in zip(list_p, list_j):
        assert a.keys() == b.keys()
        assert (a["m"], a["weight"], a["distance"]) == \
            (b["m"], b["weight"], b["distance"])
        np.testing.assert_array_equal(a["parameter"], b["parameter"])

    assert isinstance(pt.AcceptanceRateScheme(), pt.TemperatureScheme)
    res = pt.AcceptorResult(0.5, True)
    assert (res.distance, res.accept, res.weight) == (0.5, True, 1.0)


@pytest.mark.parametrize("cls", ["NoDistance", "AcceptAllDistance",
                                 "IdentityFakeDistance"])
def test_placeholder_distances(cls):
    stats = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)
    obs = np.zeros(3, np.float32)
    ref = np.asarray(getattr(jpt, cls)().compute(
        jnp.asarray(stats), jnp.asarray(obs), ()))
    got = getattr(pt, cls)().compute(torch.from_numpy(stats),
                                     torch.from_numpy(obs), {}).numpy()
    np.testing.assert_array_equal(got, ref)


def test_no_epsilon_and_db_id(tmp_path):
    assert np.isnan(pt.NoEpsilon()(3)) and np.isnan(jpt.NoEpsilon()(3))
    assert pt.create_sqlite_db_id() == jpt.create_sqlite_db_id()
    assert pt.create_sqlite_db_id(str(tmp_path), "x.db") == \
        jpt.create_sqlite_db_id(str(tmp_path), "x.db")


def test_sampler_aliases_are_vectorized():
    for name in ("SingleCoreSampler", "MulticoreEvalParallelSampler",
                 "MulticoreParticleParallelSampler"):
        cls = getattr(pt, name)
        assert issubclass(cls, pt.VectorizedSampler)
        assert cls(device="cpu").device.type == "cpu"


def test_scalar_distribution_api():
    """``Distribution.rvs()`` / ``pdf(dict)``: a draw inside the support
    whose density the JAX package gives too, to float32 rounding."""
    spec = dict(a=("norm", 0.5, 2.0), b=("uniform", -1.0, 3.0),
                c=("gamma", 2.0))
    dist_j = jpt.Distribution(**{k: jpt.RV(*v) for k, v in spec.items()})
    dist_p = pt.Distribution(**{k: pt.RV(*v) for k, v in spec.items()})
    draw = dist_p.rvs()
    assert isinstance(draw, pt.Parameter) and sorted(draw) == ["a", "b", "c"]
    assert -1.0 <= draw["b"] <= 2.0 and draw["c"] > 0
    assert dist_p.rvs() == draw  # no generator: a fixed seed
    gen = torch.Generator().manual_seed(3)
    assert dist_p.rvs(gen) != draw
    for point in (draw, {"a": 0.0, "b": 0.5, "c": 1.5},
                  {"a": 0.0, "b": 2.5, "c": 1.5}):
        assert dist_p.pdf(point) == pytest.approx(dist_j.pdf(point),
                                                  rel=1e-5, abs=1e-12)
    assert dist_p.pdf({"a": 0.0, "b": 2.5, "c": 1.5}) == 0.0


@pytest.mark.parametrize("n_models,stay", [(1, 0.7), (3, 0.7), (2, 0.0)])
def test_model_perturbation_pmf(n_models, stay):
    m_new = np.array([0, 1, 2, 0, -1])
    m_old = np.array([0, 0, 2, 1, 0])
    ref = np.asarray(jpt.ModelPerturbationKernel(n_models, stay).pmf(
        m_new, m_old))
    got = pt.ModelPerturbationKernel(n_models, stay).pmf(m_new, m_old)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    assert float(pt.ModelPerturbationKernel(n_models, stay).pmf(0, 0)) == \
        pytest.approx(float(ref[0]), rel=1e-6)


def test_transfer_alias_warns():
    import importlib
    import sys
    sys.modules.pop("pyabc_tpu_torch.utils.transfer", None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        alias = importlib.import_module("pyabc_tpu_torch.utils.transfer")
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    from pyabc_tpu_torch.wire import transfer
    assert alias.snapshot is transfer.snapshot
