"""The component library on the card against its CPU results.

Marked ``cuda``: without a card every test here skips.  The file imports
neither JAX nor the JAX package (the machine with the card has no JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_library_cuda.py

- ``TruncatedRV``: rejection on the card keeps every draw in bounds,
  clips what no pass fills, and its draws follow the truncated law (KS
  against scipy at p > 1e-3); its density and cdf equal the CPU's to
  1e-5.
- ``LocalTransition``: the fit on the card gives the CPU fit's Cholesky
  factors and log norms (rtol 1e-4), its log-density the CPU's (atol
  1e-4), and its draws the weighted support mean.
"""

import numpy as np
import pytest
import scipy.stats as ss
import torch

import pyabc_tpu_torch as pt
from pyabc_tpu_torch.convert import to_torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (see the module docstring)")
    return torch.device("cuda")


def _gen(dev, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


@pytest.mark.parametrize("lower,upper", [(0.0, np.inf), (1.0, 1.5),
                                         (-0.5, 2.0)])
def test_truncated_rejection_on_the_card(dev, lower, upper):
    rv = pt.TruncatedRV(pt.RV("norm", 0.0, 1.0), lower=lower, upper=upper)
    x = rv.sample(_gen(dev, 7), (200_000,))
    assert x.device.type == "cuda"
    assert bool(((x >= lower) & (x <= upper)).all())
    law = ss.truncnorm(lower, upper)
    assert ss.kstest(x.cpu().numpy().astype(np.float64),
                     law.cdf).pvalue > 1e-3
    grid = torch.linspace(-1.0, 3.0, 401)
    for fn in (rv.log_pdf, rv.cdf):
        card, host = fn(grid.to(dev)).cpu(), fn(grid)
        np.testing.assert_allclose(card.numpy(), host.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_truncated_clips_on_the_card(dev):
    rv = pt.TruncatedRV(pt.RV("norm", 0.0, 1.0), lower=6.0, max_iter=4)
    x = rv.sample(_gen(dev, 1), (1000,))
    assert bool((x >= 6.0).all())
    assert float((x == 6.0).float().mean()) > 0.99


@pytest.fixture(scope="module")
def local_data():
    rng = np.random.default_rng(4)
    theta = rng.normal(0.0, [1.0, 2.0, 0.5], (3000, 3)).astype(np.float32)
    theta[:, 1] += 0.5 * theta[:, 0]
    w = rng.uniform(0.5, 1.5, 3000).astype(np.float32)
    query = rng.normal(0.0, 1.5, (2500, 3)).astype(np.float32)
    return theta, w, query


def test_local_transition_fit_on_the_card(dev, local_data):
    theta, w, query = local_data
    card = pt.LocalTransition(device=dev).fit(theta, w)
    host = pt.LocalTransition(device="cpu").fit(theta, w)
    np.testing.assert_allclose(card._chols, host._chols, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(card._log_norms, host._log_norms, rtol=1e-4,
                               atol=1e-5)
    got = card.log_pdf(torch.as_tensor(query, device=dev)).cpu().numpy()
    want = host.log_pdf(torch.as_tensor(query)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_local_transition_padded_params_on_the_card(dev, local_data):
    theta, w, query = local_data
    tr = pt.LocalTransition(device="cpu").fit(theta, w)
    params = tr.pad_params(tr.get_params(), 4096)
    got = pt.LocalTransition.log_pdf_from_params(
        torch.as_tensor(query, device=dev), to_torch(params, dev)).cpu()
    want = pt.LocalTransition.log_pdf_from_params(
        torch.as_tensor(query), to_torch(params, "cpu"))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-5)
    x = tr.rvs(_gen(dev, 3), 100_000)
    assert x.device.type == "cuda"
    mean = (theta * (w / w.sum())[:, None]).sum(0)
    np.testing.assert_allclose(x.mean(0).cpu().numpy(), mean, atol=0.03)
