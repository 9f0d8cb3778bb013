"""The port's History reads a database that ``pyabc_tpu`` wrote.

The JAX package packs its History blobs with the PTW1 codec (delta +
zlib); the port writes ``.npy`` and decodes both.  A two-model run of
config #2 written by the JAX package in ``tmp_path`` must read back
through the port's ``History`` with the same populations, weights and
model probabilities, bit for bit.
"""

import numpy as np
import pytest

import pyabc_tpu as jpt
from pyabc_tpu.models import make_two_gaussians_problem as jax_problem
from pyabc_tpu.storage.history import _pack as jax_pack
from pyabc_tpu.storage.history import History as JaxHistory
from pyabc_tpu.wire import transfer as jax_transfer
from pyabc_tpu_torch.storage import History
from pyabc_tpu_torch.wire import transfer


@pytest.fixture(scope="module")
def jax_db(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ptw1") / "jax.db")
    models, priors, distance, observed, _ = jax_problem()
    abc = jpt.ABCSMC(models, priors, distance, population_size=300,
                     sampler=jpt.VectorizedSampler(), seed=3)
    abc.new(path, observed)
    abc.run(max_nr_populations=3)
    return path


@pytest.mark.parametrize("arr", [
    np.arange(12, dtype=np.float32).reshape(4, 3) * 0.37,
    np.array([3, 1, 4, 1, 5], dtype=np.int64),
    np.array(2.5, dtype=np.float64),
    np.zeros((1, 2), dtype=np.float16),
    np.array([True, False, True]),
])
def test_codec_matches_the_jax_package(arr):
    """Same bytes out of both encoders; each decoder reads both."""
    blob = transfer.encode_array(arr)
    assert blob == jax_transfer.encode_array(arr, codec="delta")
    for out in (transfer.decode_array(blob),
                transfer.decode_array(jax_transfer.encode_array(arr))):
        assert out.dtype == arr.dtype and out.shape == arr.shape
        np.testing.assert_array_equal(out, arr)


def test_jax_history_blobs_are_ptw1(jax_db):
    assert transfer.is_ptw1(jax_pack(np.ones((3, 2), np.float32)))


def test_port_reads_a_jax_database(jax_db):
    jh = JaxHistory(jax_db, abc_id=1)
    ph = History(jax_db, abc_id=1)
    assert ph.max_t == jh.max_t == 2
    for t in range(ph.max_t + 1):
        np.testing.assert_array_equal(
            ph.get_model_probabilities(t).to_numpy(),
            jh.get_model_probabilities(t).to_numpy())
        for m in (0, 1):
            df_p, w_p = ph.get_distribution(m=m, t=t)
            df_j, w_j = jh.get_distribution(m=m, t=t)
            np.testing.assert_array_equal(w_p, w_j)
            np.testing.assert_array_equal(df_p.to_numpy(), df_j.to_numpy())
        pop_p, pop_j = ph.get_population(t), jh.get_population(t)
        np.testing.assert_array_equal(np.asarray(pop_p.distance),
                                      np.asarray(pop_j.distance))
        np.testing.assert_array_equal(np.asarray(pop_p.weight),
                                      np.asarray(pop_j.weight))
    pops_p, pops_j = ph.get_all_populations(), jh.get_all_populations()
    np.testing.assert_array_equal(pops_p.epsilon.to_numpy(),
                                  pops_j.epsilon.to_numpy())
    np.testing.assert_array_equal(pops_p.samples.to_numpy(),
                                  pops_j.samples.to_numpy())
