"""The weighted-KDE CUDA kernel on the card, against its plain version.

Marked ``cuda``: without a card every test here skips.  The file imports
neither JAX nor the JAX package, so it runs on the machine with the card
(which has no JAX), from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kde_cuda.py

Tolerance ``1e-4 + 1e-5·|ref|``, the chip smoke's: the kernel and the
plain version do the same float32 arithmetic in another summation order,
in base 2 and with ``ex2.approx``.
"""

import math

import numpy as np
import pytest
import torch

from pyabc_tpu_torch.ops import kde, kde_cuda
from pyabc_tpu_torch.transition import MultivariateNormalTransition

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (see the module docstring)")
    return torch.device("cuda")


def _problem(dev, m, n, d, seed=0, n_pad=0):
    rng = np.random.default_rng(seed)
    support = rng.standard_normal((n, d)).astype(np.float32)
    x = rng.standard_normal((m, d)).astype(np.float32)
    log_w = (0.3 * rng.standard_normal(n)).astype(np.float32)
    if n_pad:
        support[-n_pad:] = 0.0
        log_w[-n_pad:] = -1e30
    h = (4.0 / (n * (d + 2.0))) ** (1.0 / (d + 4.0))
    chol = (np.eye(d) * h).astype(np.float32)
    log_norm = -0.5 * d * math.log(2 * math.pi) - d * math.log(h)
    t = [torch.as_tensor(a, device=dev) for a in (x, support, log_w, chol)]
    return t, log_norm


def _close(got, ref):
    return bool(torch.isfinite(got).all()
                and torch.all((got - ref).abs() <= 1e-4 + 1e-5 * ref.abs()))


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 20, 32])
def test_every_dimension_matches_plain(dev, d):
    """Each fixed-d template (1..8) and the generic path (9..32)."""
    t, ln = _problem(dev, 1500, 2500, d, seed=d)
    assert _close(kde_cuda.weighted_kde_logpdf_cuda(*t, ln),
                  kde.weighted_kde_logpdf(*t, ln))


@pytest.mark.parametrize("m,n,n_pad", [(1, 1, 0), (257, 1, 0),
                                       (1000, 1537, 257), (4097, 9000, 2000),
                                       (70000, 300, 44)])
def test_ragged_shapes_and_pad_tiles(dev, m, n, n_pad):
    """Ragged M and N, and a tail of -1e30 rows covering a whole tile."""
    t, ln = _problem(dev, m, n, 2, seed=m, n_pad=n_pad)
    assert _close(kde_cuda.weighted_kde_logpdf_cuda(*t, ln),
                  kde.weighted_kde_logpdf(*t, ln))


def test_pad_rows_contribute_nothing(dev):
    t, ln = _problem(dev, 2000, 3000, 1, seed=5)
    x, support, log_w, chol = t
    support2 = torch.cat([support, torch.zeros(1000, 1, device=dev)])
    log_w2 = torch.cat([log_w, torch.full((1000,), -1e30, device=dev)])
    a = kde_cuda.weighted_kde_logpdf_cuda(x, support, log_w, chol, ln)
    b = kde_cuda.weighted_kde_logpdf_cuda(x, support2, log_w2, chol, ln)
    assert torch.allclose(a, b, atol=1e-5, rtol=0)


def test_compressed_transition_density_runs_the_kernel(dev):
    """``log_pdf_from_params`` with a grid-compressed support goes through
    the kernel (the launch count rises) and matches the plain version."""
    rng = np.random.default_rng(7)
    theta = (1.0 + 0.3 * rng.standard_normal((40000, 1))).astype(np.float32)
    tr = MultivariateNormalTransition().fit(theta, np.ones(40000))
    params = tr.pad_params(tr.get_params(), 1 << 16)
    assert "c_support" in params
    params = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
              for k, v in params.items()}
    x = torch.as_tensor(theta[:5000], device=dev)
    before = kde_cuda.weighted_kde_logpdf_cuda.launches
    got = tr.log_pdf_from_params(x, params)
    assert kde_cuda.weighted_kde_logpdf_cuda.launches == before + 1
    ref = kde.weighted_kde_logpdf(x, params["c_support"], params["c_log_w"],
                                  params["chol"], params["log_norm"])
    assert _close(got, ref)


@pytest.mark.parametrize("d,n,n_pad", [(4, 6000, 6000), (2, 6000, 8192)])
def test_finalize_geometry_of_the_adaptive_workloads(dev, d, n, n_pad):
    """The Lotka-Volterra (d = 4) and SIR (d = 2) finalize in small form:
    the queries are the new population, the support the previous one with
    its fitted full covariance, unweighted rows padded to the bucket as
    ``ABCSMC._fit_transitions`` pads them; one launch per call."""
    rng = np.random.default_rng(d)
    mix = rng.standard_normal((d, d)) * 0.3 + np.eye(d)

    def population(size):
        return (rng.standard_normal((size, d)) @ mix.T).astype(np.float32)

    tr = MultivariateNormalTransition().fit(population(n),
                                            rng.uniform(0.5, 1.5, n))
    params = tr.pad_params(tr.get_params(), n_pad)
    assert "c_support" not in params
    params = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
              for k, v in params.items()}
    x = torch.as_tensor(population(n), device=dev)
    before = kde_cuda.weighted_kde_logpdf_cuda.launches
    got = tr.log_pdf_from_params(x, params)
    assert kde_cuda.weighted_kde_logpdf_cuda.launches == before + 1
    ref = kde.weighted_kde_logpdf(x, params["support"], params["log_w"],
                                  params["chol"], params["log_norm"])
    assert _close(got, ref)


def test_record_density_of_the_stochastic_workload(dev):
    """Config #5's record shape in small form, d = 1: the records are
    every candidate of a generation (the proposal's draws, tails past the
    population included), the support the previous population's
    grid-compressed cells; the density is taken at record ingest, one
    launch per record batch."""
    from pyabc_tpu_torch.sampler.base import RECORD_KEYS, Sample

    rng = np.random.default_rng(5)
    pop = (0.685 + 0.05 * rng.standard_normal((40000, 1))).astype(np.float32)
    tr = MultivariateNormalTransition().fit(pop, rng.uniform(0.5, 1.5, 40000))
    params = tr.pad_params(tr.get_params(), 1 << 16)
    assert "c_support" in params
    params = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
              for k, v in params.items()}
    n = 5 * 40000
    records = {"rec_" + k: torch.zeros(n, device=dev) for k in RECORD_KEYS}
    records["rec_theta"] = torch.as_tensor(
        (0.685 + 0.12 * rng.standard_normal((n, 1))).astype(np.float32),
        device=dev)
    records["rec_m"] = torch.zeros(n, dtype=torch.int64, device=dev)
    records["rec_count"] = n
    records["record_density_fn"] = (
        lambda m, th: tr.log_pdf_from_params(th, params))
    sample = Sample(record_rejected=True)
    before = kde_cuda.weighted_kde_logpdf_cuda.launches
    sample.append_record_batch(records)
    assert kde_cuda.weighted_kde_logpdf_cuda.launches == before + 1
    got = sample.get_records()["log_proposal"]
    ref = kde.weighted_kde_logpdf(records["rec_theta"], params["c_support"],
                                  params["c_log_w"], params["chol"],
                                  params["log_norm"])
    assert got.shape == (n,) and _close(got, ref)


@pytest.mark.parametrize("d,n_cap", [(1, 2048), (4, 4096)])
def test_capped_uniform_support_of_the_fused_engine(dev, d, n_cap):
    """The fused engine's proposal density above the support cap in small
    form: the queries are the population, the support ``n_cap`` rows
    resampled from it (systematic inverse CDF) at uniform log weight
    ``-log n_cap``, the covariance refit on the device; one launch."""
    from pyabc_tpu_torch.sampler.fused import _refit_model
    from pyabc_tpu_torch.transition.multivariatenormal import \
        silverman_rule_of_thumb

    rng = np.random.default_rng(d)
    n = 5 * n_cap
    theta = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32),
                            device=dev)
    log_w = torch.as_tensor((0.3 * rng.standard_normal(n)).astype(
        np.float32), device=dev)
    m = torch.zeros(n, dtype=torch.int64, device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    params, _ = _refit_model(theta, log_w, valid, m, 0, d, n,
                             silverman_rule_of_thumb, 1.0,
                             support_cap=n_cap,
                             u0=torch.tensor(0.37, device=dev))
    assert params["support"].shape == (n_cap, d)
    assert bool(torch.all(params["log_w"] == params["log_w"][0]))
    args = (theta, params["support"], params["log_w"], params["chol"],
            params["log_norm"])
    before = kde_cuda.weighted_kde_logpdf_cuda.launches
    got = kde_cuda.weighted_kde_logpdf_cuda(*args)
    assert kde_cuda.weighted_kde_logpdf_cuda.launches == before + 1
    assert _close(got, kde.weighted_kde_logpdf(*args))


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    t, ln = _problem(dev, 100, 200, 2)
    x, support, log_w, chol = t
    with pytest.raises(TypeError):
        kde_cuda.weighted_kde_logpdf_cuda(x.double(), support, log_w,
                                          chol, ln)
    with pytest.raises(ValueError):
        kde_cuda.weighted_kde_logpdf_cuda(x, support[:10], log_w, chol, ln)
    z = torch.zeros(10, 33, device=dev)
    with pytest.raises(ValueError, match="d <="):
        kde_cuda.weighted_kde_logpdf_cuda(
            z, z, torch.zeros(10, device=dev),
            torch.eye(33, device=dev), ln)
    with pytest.raises(ValueError, match="log_norm"):
        kde_cuda.weighted_kde_logpdf_cuda(x, support, log_w, chol,
                                          torch.zeros(2, device=dev))


def test_non_contiguous_inputs_and_tensor_log_norm(dev):
    """Strided inputs are made contiguous by the wrapper; a log_norm given
    as a one-element card tensor is read on the card."""
    t, ln = _problem(dev, 700, 900, 2, seed=11)
    x, support, log_w, chol = t
    a = kde_cuda.weighted_kde_logpdf_cuda(x, support, log_w, chol, ln)
    xt = x.T.contiguous().T
    lnt = torch.tensor(ln, device=dev)
    b = kde_cuda.weighted_kde_logpdf_cuda(xt, support, log_w, chol, lnt)
    assert not xt.is_contiguous()
    assert torch.equal(a, b)


def _grid_problem(dev, x, n=8192, empty=0.1, seed=3):
    """A grid-compressed 1-D support as _compress_support makes it: sorted
    cell centroids, Gaussian mass, empty cells at -1e30, bandwidth 64
    cells."""
    rng = np.random.default_rng(seed)
    centers = np.linspace(-1.0, 3.0, n, dtype=np.float32)
    mass = np.exp(-0.5 * ((centers - 1.0) / 0.4) ** 2)
    mass *= rng.uniform(size=n) > empty
    log_w = np.where(mass > 0, np.log(np.maximum(mass, 1e-38) / mass.sum()),
                     -1e30).astype(np.float32)
    h = 64 * 4.0 / n
    t = [torch.as_tensor(a, device=dev) for a in (
        np.asarray(x, np.float32).reshape(-1, 1), centers[:, None], log_w,
        np.array([[h]], np.float32))]
    return t, -0.5 * math.log(2 * math.pi) - math.log(h)


def test_sorted_grid_support_with_queries_inside_and_beyond_both_ends(dev):
    rng = np.random.default_rng(5)
    x = np.concatenate([1.0 + 0.4 * rng.standard_normal(20000),
                        rng.uniform(-3.0, -1.0, 500),
                        rng.uniform(3.0, 5.0, 500)])
    t, ln = _grid_problem(dev, x)
    assert _close(kde_cuda.weighted_kde_logpdf_cuda(*t, ln),
                  kde.weighted_kde_logpdf(*t, ln))


def test_far_queries_underflow_except_near_the_max(dev):
    """Queries hundreds of bandwidths away: every term but those near the
    max is below float32's range, and the result is still right."""
    x = np.array([-40.0, -12.0, -2.5, 4.5, 17.0, 60.0] * 50, np.float32)
    t, ln = _grid_problem(dev, x, n=4096)
    got = kde_cuda.weighted_kde_logpdf_cuda(*t, ln)
    ref = kde.weighted_kde_logpdf(*t, ln)
    assert float(ref.min()) < -1e4
    assert _close(got, ref)


@pytest.mark.parametrize("d", [1, 2, 5])
def test_whitened_z_of_a_few_tens(dev, d):
    t, ln = _problem(dev, 3000, 5000, d, seed=20 + d)
    x, support, log_w, chol = t
    x, support = 10.0 * x, 10.0 * support     # |z| up to ~40 / h
    chol = chol * 3.0
    ln = ln - d * math.log(3.0)
    got = kde_cuda.weighted_kde_logpdf_cuda(x, support, log_w, chol, ln)
    ref = kde.weighted_kde_logpdf(x, support, log_w, chol, ln)
    assert float(((x - support.mean(0)) / chol[0, 0]).abs().max()) > 20
    assert _close(got, ref)


@pytest.mark.parametrize("d", [1, 3])
def test_all_pad_split_and_all_pad_support(dev, d):
    """A split of pads only (-1e30 rows filling whole splits) adds
    nothing; an all-pad support gives what the plain version gives."""
    t, ln = _problem(dev, 2000, 20000, d, seed=9, n_pad=12000)
    assert kde_cuda.split_plan(2000, 20000, d)[0] < 12000
    assert _close(kde_cuda.weighted_kde_logpdf_cuda(*t, ln),
                  kde.weighted_kde_logpdf(*t, ln))
    x, support, log_w, chol = t
    log_w = torch.full_like(log_w, -1e30)
    got = kde_cuda.weighted_kde_logpdf_cuda(x, support, log_w, chol, ln)
    ref = kde.weighted_kde_logpdf(x, support, log_w, chol, ln)
    assert _close(got, ref)
    assert torch.all(ref == -1e30)


@pytest.mark.parametrize("m,n,d", [(513, 17, 1), (511, 4111, 1),
                                   (2049, 1001, 2), (1023, 33, 5),
                                   (257, 4095, 8), (130, 19, 12)])
def test_ragged_m_and_n(dev, m, n, d):
    """M not a multiple of Q * BLOCK, N not a multiple of K or of G: the
    edges are masked, not counted."""
    p, q, k, _ = kde_cuda.geometry(d)
    assert m % (q * kde_cuda.BLOCK) and n % k and n % kde_cuda.G
    t, ln = _problem(dev, m, n, d, seed=m + n)
    assert _close(kde_cuda.weighted_kde_logpdf_cuda(*t, ln),
                  kde.weighted_kde_logpdf(*t, ln))


def test_kernel_matches_its_base2_mirror(dev):
    """The CPU tests hold kde_cuda.base2_logpdf to the plain version; on
    the card the kernel agrees with that mirror too."""
    t, ln = _problem(dev, 3000, 7001, 2, seed=13, n_pad=1000)
    got = kde_cuda.weighted_kde_logpdf_cuda(*t, ln)
    mirror = kde_cuda.base2_logpdf(*t, ln)
    assert _close(got, mirror)
