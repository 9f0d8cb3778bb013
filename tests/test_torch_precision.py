"""The at-rest carry codec of the port (``pyabc_tpu_torch/ops/precision.py``)
against the JAX package's (``pyabc_tpu/ops/precision.py``): the same numpy
carries through both.

f32 is the identity (the same object) in both; bf16 is bit-equal; int8
codes are equal and decoded values agree within one quantum (the
column's scale); the codec is idempotent and total on non-finite input.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyabc_tpu.ops import precision as jprec
from pyabc_tpu_torch.convert import carry_to_numpy, carry_to_torch
from pyabc_tpu_torch.ops import precision as pprec


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    monkeypatch.delenv("PYABC_TPU_CARRY_PRECISION", raising=False)


def _carry_np(n=64, d=3, s=5, seed=0, non_finite=False):
    rng = np.random.default_rng(seed)
    c = {
        "m": rng.integers(0, 2, n).astype(np.int64),
        "log_weight": rng.normal(size=n).astype(np.float32),
        "theta": (rng.normal(size=(n, d)) * 10.0).astype(np.float32),
        "distance": rng.uniform(0.0, 5.0, n).astype(np.float32),
        "stats": rng.normal(size=(n, s)).astype(np.float32),
        "count": np.int64(n),
    }
    if non_finite:
        c["theta"][3, 1] = np.inf
        c["theta"][7, 0] = np.nan
        c["distance"][5] = -np.inf
        c["stats"][:, 2] = np.nan      # a column with no finite row
    return c


def _jax(c):
    return {k: jnp.asarray(v.astype(np.int32) if k == "m" else v)
            for k, v in c.items()}


def _torch(c):
    return carry_to_torch(c, "cpu")


@pytest.mark.parametrize("package", ["jax", "port"])
def test_f32_is_the_same_object(package):
    c = _jax(_carry_np()) if package == "jax" else _torch(_carry_np())
    mod = jprec if package == "jax" else pprec
    assert mod.encode_carry(c, "f32") is c
    assert mod.decode_carry(c, "f32") is c


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_is_bit_equal_to_jax(seed):
    c = _carry_np(seed=seed)
    j_enc = jprec.encode_carry(_jax(c), "bf16")
    p_enc = pprec.encode_carry(_torch(c), "bf16")
    for k in pprec.CARRY_COMPRESSED_LANES:
        assert p_enc[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            p_enc[k].to(torch.float32).numpy(),
            np.asarray(j_enc[k]).astype(np.float32))
    j_dec = jprec.decode_carry(j_enc, "bf16")
    p_dec = pprec.decode_carry(p_enc, "bf16")
    for k in pprec.CARRY_COMPRESSED_LANES:
        assert p_dec[k].dtype == torch.float32
        np.testing.assert_array_equal(p_dec[k].numpy(), np.asarray(j_dec[k]))
    # the accumulator lanes are the same objects
    for k in ("m", "log_weight", "count"):
        assert p_enc[k] is p_dec[k]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("non_finite", [False, True])
def test_int8_codes_equal_jax_and_decode_within_a_quantum(seed, non_finite):
    c = _carry_np(seed=seed, non_finite=non_finite)
    j_enc = jprec.encode_carry(_jax(c), "int8")
    p_enc = pprec.encode_carry(_torch(c), "int8")
    for k in pprec.CARRY_COMPRESSED_LANES:
        assert p_enc[k].dtype == torch.int8
        np.testing.assert_array_equal(p_enc[k].numpy(), np.asarray(j_enc[k]))
        for aux in ("_qs", "_qm"):
            assert p_enc[k + aux].dtype == torch.float32
            assert tuple(p_enc[k + aux].shape) == c[k].shape[1:]
            np.testing.assert_allclose(p_enc[k + aux].numpy(),
                                       np.asarray(j_enc[k + aux]),
                                       rtol=1e-6)
    j_dec = jprec.decode_carry(j_enc, "int8")
    p_dec = pprec.decode_carry(p_enc, "int8")
    for k in pprec.CARRY_COMPRESSED_LANES:
        assert k + "_qs" not in p_dec and k + "_qm" not in p_dec
        quantum = p_enc[k + "_qs"].numpy()
        got = p_dec[k].numpy()
        assert np.all(np.isfinite(got))
        assert np.all(np.abs(got - np.asarray(j_dec[k])) <= quantum)
        # against the input: one grid step where the input was finite
        x = c[k]
        fin = np.isfinite(x)
        assert np.all(np.abs(got - x)[fin]
                      <= np.broadcast_to(quantum, x.shape)[fin] + 1e-6)


def test_int8_non_finite_takes_the_column_floor():
    c = _carry_np(non_finite=True)
    dec = pprec.decode_carry(pprec.encode_carry(_torch(c), "int8"), "int8")
    theta = dec["theta"].numpy()
    floor = c["theta"][np.isfinite(c["theta"][:, 1]), 1].min()
    assert theta[3, 1] == pytest.approx(floor, abs=1e-5)
    # a column with no finite row decodes to finite zeros
    np.testing.assert_array_equal(dec["stats"][:, 2].numpy(), 0.0)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_codec_is_idempotent(mode):
    enc = pprec.encode_carry(_torch(_carry_np()), mode)
    again = pprec.encode_carry(enc, mode)
    for k in pprec.CARRY_COMPRESSED_LANES:
        assert again[k] is enc[k]
    if mode == "int8":
        assert again["theta_qs"] is enc["theta_qs"]
    dec = pprec.decode_carry(enc, mode)
    assert pprec.decode_carry(dec, mode)["theta"] is dec["theta"]


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_codec_is_deterministic(mode):
    a = pprec.encode_carry(_torch(_carry_np(seed=7)), mode)
    b = pprec.encode_carry(_torch(_carry_np(seed=7)), mode)
    for k in a:
        assert torch.equal(a[k], b[k]), (mode, k)


def test_codec_rejects_unknown_modes():
    with pytest.raises(ValueError, match="bad mode"):
        pprec.encode_carry(_torch(_carry_np()), "f16")
    with pytest.raises(ValueError, match="bad mode"):
        pprec.decode_carry(_torch(_carry_np()), "f64")


def test_resolve_carry_precision(monkeypatch):
    assert pprec.resolve_carry_precision() == "f32"
    monkeypatch.setenv("PYABC_TPU_CARRY_PRECISION", "bf16")
    assert pprec.resolve_carry_precision() == "bf16"
    assert pprec.resolve_carry_precision("int8") == "int8"
    with pytest.raises(ValueError, match="PYABC_TPU_CARRY_PRECISION"):
        pprec.resolve_carry_precision("fp8")
    assert pprec.CARRY_MODES == jprec.CARRY_MODES
    assert pprec.CARRY_COMPRESSED_LANES == jprec.CARRY_COMPRESSED_LANES
    assert pprec.CARRY_ITEMSIZE == jprec.CARRY_ITEMSIZE


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_narrowed_carry_crosses_between_the_packages(mode):
    """A JAX carry encoded at rest converts into the port's at-rest
    layout (int8 codes and aux lanes, bfloat16 lanes) and back."""
    c = _carry_np()
    j_enc = {k: np.asarray(v) for k, v in
             jprec.encode_carry(_jax(c), mode).items()}
    p = carry_to_torch(j_enc, "cpu")
    want = torch.int8 if mode == "int8" else torch.bfloat16
    for k in pprec.CARRY_COMPRESSED_LANES:
        assert p[k].dtype == want
    back = carry_to_numpy(p)
    for k in pprec.CARRY_COMPRESSED_LANES:
        np.testing.assert_array_equal(back[k].astype(np.float32),
                                      j_enc[k].astype(np.float32))
    p_dec = pprec.decode_carry(p, mode)
    j_dec = jprec.decode_carry(jprec.encode_carry(_jax(c), mode), mode)
    for k in pprec.CARRY_COMPRESSED_LANES:
        np.testing.assert_allclose(p_dec[k].numpy(), np.asarray(j_dec[k]),
                                   rtol=1e-6, atol=1e-5)
