"""The weighted-KDE CUDA kernel on the card, against its plain version.

Marked ``cuda``: without a card every test here skips.  The file imports
neither JAX nor the JAX package, so it runs on the machine with the card
(which has no JAX), from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kde_cuda.py

Tolerance ``1e-4 + 1e-5·|ref|``, the chip smoke's: the kernel and the
plain version do the same float32 arithmetic in another summation order
and with ``__expf``.
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


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 6, 7, 8, 12, 32])
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
        kde_cuda.kde_logpdf_whitened(z, z, torch.zeros(10, device=dev),
                                     torch.zeros(1, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        kde_cuda.kde_logpdf_whitened(
            x.T.contiguous().T, support, log_w, torch.zeros(1, device=dev))
