"""Weighted-KDE log-density of the PyTorch port against the JAX package.

The same numpy inputs (``numpy.random.default_rng``) go through
``pyabc_tpu.ops.kde`` (the XLA scan, and the Pallas kernel in interpret
mode) and ``pyabc_tpu_torch.ops.kde`` (the plain version, which is the
CPU path and the reference of the CUDA kernel).  Tolerances:

- against the XLA scan: atol 1e-4, rtol 1e-5 — the same float32 algorithm
  with a different summation order;
- against the Pallas kernel: atol 5e-3, rtol 1e-4 — the Pallas test's own
  tolerances (tests/test_ops_kde_pallas.py), set by its bf16x3 product;
- pad rows at -1e30: atol 1e-5.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyabc_tpu.ops.kde import weighted_kde_logpdf as jax_kde
from pyabc_tpu.ops.kde_pallas import weighted_kde_logpdf_pallas
from pyabc_tpu.transition import \
    MultivariateNormalTransition as JaxMVN
from pyabc_tpu_torch.convert import to_torch
from pyabc_tpu_torch.ops import kde, kde_cuda
from pyabc_tpu_torch.transition import MultivariateNormalTransition


def _problem(m=500, n=1000, d=3, seed=0):
    rng = np.random.default_rng(seed)
    support = rng.standard_normal((n, d)).astype(np.float32)
    x = rng.standard_normal((m, d)).astype(np.float32)
    log_w = (0.3 * rng.standard_normal(n)).astype(np.float32)
    log_w = (log_w - np.log(np.sum(np.exp(log_w)))).astype(np.float32)
    chol = (np.eye(d) * 0.3).astype(np.float32)
    log_norm = np.float32(-d / 2 * np.log(2 * np.pi) - d * np.log(0.3))
    return x, support, log_w, chol, log_norm


def _port(x, support, log_w, chol, log_norm, **kw):
    t = [torch.as_tensor(a) for a in (x, support, log_w, chol)]
    return kde.weighted_kde_logpdf(*t, float(log_norm), **kw).numpy()


@pytest.mark.parametrize("d,n", [(1, 1000), (2, 1000), (5, 1000),
                                 (3, 1537)])
def test_plain_matches_jax_scan(d, n):
    args = _problem(n=n, d=d, seed=d)
    ref = np.asarray(jax_kde(*[jnp.asarray(a) for a in args]))
    got = _port(*args)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def test_plain_blocking_is_invisible():
    """Query/support block sizes change the summation order only."""
    args = _problem(m=300, n=1537, d=2, seed=7)
    a = _port(*args)
    b = _port(*args, query_block=64, support_block=256)
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("d", [1, 2, 5])
def test_plain_matches_pallas_interpret(d):
    args = _problem(d=d, seed=10 + d)
    ref = np.asarray(weighted_kde_logpdf_pallas(
        *[jnp.asarray(a) for a in args], interpret=True))
    got = _port(*args)
    np.testing.assert_allclose(got, ref, atol=5e-3, rtol=1e-4)


@pytest.mark.parametrize("n_pad", [537, 2048])
def test_pad_rows_are_noops(n_pad):
    """-1e30 pad rows (pad_params, empty grid cells) contribute nothing,
    including a whole streamed block of pads."""
    x, support, log_w, chol, log_norm = _problem(n=1000, d=2, seed=3)
    support2 = np.concatenate([support, np.zeros((n_pad, 2), np.float32)])
    log_w2 = np.concatenate([log_w, np.full(n_pad, -1e30, np.float32)])
    ref = _port(x, support, log_w, chol, log_norm)
    padded = _port(x, support2, log_w2, chol, log_norm, support_block=512)
    np.testing.assert_allclose(padded, ref, atol=1e-5)


def _fitted_params(n, seed=0):
    rng = np.random.default_rng(seed)
    theta = (1.0 + 0.3 * rng.standard_normal((n, 1))).astype(np.float32)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    tr = JaxMVN()
    tr.fit(theta, w)
    params = tr.pad_params(tr.get_params(), 1 << int(np.ceil(np.log2(n))))
    x = (1.0 + 0.25 * rng.standard_normal((400, 1))).astype(np.float32)
    return params, x, tr


@pytest.mark.parametrize("compressed", [True, False])
def test_log_pdf_from_params_via_convert(compressed):
    """The JAX transition's padded params, carried over by convert.py,
    give the same density in both packages — against the grid-compressed
    support (``c_support``) and against the full support."""
    params, x, tr = _fitted_params(20000)
    assert "c_support" in params
    if not compressed:
        params = {k: v for k, v in params.items()
                  if k not in ("c_support", "c_log_w")}
    ref = np.asarray(tr.log_pdf_from_params(jnp.asarray(x), params))
    got = MultivariateNormalTransition.log_pdf_from_params(
        torch.as_tensor(x), to_torch(params, "cpu")).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def test_auto_on_cpu_is_the_plain_version():
    args = _problem(m=100, n=300, d=2, seed=5)
    t = [torch.as_tensor(a) for a in args[:4]]
    auto = kde.weighted_kde_logpdf_auto(*t, float(args[4]))
    plain = kde.weighted_kde_logpdf(*t, float(args[4]))
    assert torch.equal(auto, plain)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back: a CPU tensor is an error."""
    args = _problem(m=10, n=30, d=2)
    t = [torch.as_tensor(a) for a in args[:4]]
    with pytest.raises(ValueError, match="CUDA"):
        kde_cuda.weighted_kde_logpdf_cuda(*t, float(args[4]))


@pytest.mark.parametrize("m,n", [(16384, 16384), (1_000_000, 65536),
                                 (65536, 65536), (1000, 1537), (1, 1),
                                 (5, 300), (3, 20_000_000)])
def test_split_plan_covers_support(m, n):
    chunk, splits = kde_cuda.split_plan(m, n)
    assert chunk % kde_cuda.TILE == 0
    assert splits * chunk >= n > (splits - 1) * chunk
    assert 1 <= splits <= 65535
    if n <= kde_cuda.MAX_CHUNK * 65535:
        assert chunk <= max(kde_cuda.MAX_CHUNK, kde_cuda.TILE)


def test_bound_is_the_slower_of_exp_and_fp32_issue():
    f = 1.98e9
    m, n = 1_000_000, 65536
    exp_s = m * n / (132 * 16 * f)
    assert math.isclose(kde_cuda.bound_seconds(m, n, 1, f), exp_s)
    assert kde_cuda.bound_seconds(m, n, 32, f) > exp_s


def _fake_nvcc(tmp_path, body):
    exe = tmp_path / "nvcc"
    exe.write_text("#!/bin/sh\n" + body + "\n")
    exe.chmod(0o755)
    return str(exe)


def test_failed_build_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    from pyabc_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "nvcc", lambda: _fake_nvcc(
        tmp_path, 'echo "kde_logpdf.cu(1): error: boom" >&2; exit 2'))
    with pytest.raises(RuntimeError, match="boom"):
        _build.build_all()
    assert not list((tmp_path / "kernels").iterdir())  # no partial library


def test_build_is_keyed_by_source_hash(tmp_path, monkeypatch):
    """One build per source hash: a second call finds the library."""
    from pyabc_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    calls = tmp_path / "calls"
    monkeypatch.setattr(_build, "nvcc", lambda: _fake_nvcc(
        tmp_path, f'echo x >> {calls}; '
                  'while [ $# -gt 0 ]; do [ "$1" = -o ] && out="$2"; '
                  'shift; done; touch "$out"'))
    built = _build.build_all()
    assert set(built) == set(_build.SOURCES)
    assert _build.library_path("kde_logpdf").exists()
    assert _build.build_all() == {}
    assert calls.read_text().count("x") == len(_build.SOURCES)
