"""Inverse-CDF weighted choice of the PyTorch port against the JAX package.

On one shared capped CDF the port's ``torch.searchsorted`` inversion must
give exactly the JAX package's two-level blocked count
(``_invert_cdf(cdf, _cap_draws(cdf, u))``), index for index, and a
zero-weight pad row must never be drawn.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyabc_tpu.ops.choice import _cap_draws, _invert_cdf
from pyabc_tpu_torch.ops.choice import (SCAN_ROW, cap_draws,
                                        fast_weighted_choice, invert_cdf,
                                        ordered_cumsum)


def _cdf(n, n_pad, seed):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.0, 1.0, n).astype(np.float32)
    w[rng.uniform(size=n) < 0.2] = 0.0          # interior flat segments
    w = np.concatenate([w, np.zeros(n_pad, np.float32)])  # pad tail
    w = w / w.sum()
    return np.cumsum(w, dtype=np.float32)


@pytest.mark.parametrize("n,n_pad", [(50, 14), (1000, 24), (5000, 3192)])
def test_inversion_is_index_exact(n, n_pad):
    cdf = _cdf(n, n_pad, seed=n)
    rng = np.random.default_rng(n + 1)
    u = (rng.uniform(size=20000).astype(np.float32) * cdf[-1])
    # draws exactly on CDF values and on the top: the capped edge cases
    u = np.concatenate([u, cdf[::7], np.full(5, cdf[-1], np.float32)])
    ref = np.asarray(_invert_cdf(jnp.asarray(cdf),
                                 _cap_draws(jnp.asarray(cdf),
                                            jnp.asarray(u))))
    tc = torch.as_tensor(cdf)
    got = invert_cdf(tc, cap_draws(tc, torch.as_tensor(u))).numpy()
    np.testing.assert_array_equal(got, ref)


def test_pad_rows_are_never_drawn():
    rng = np.random.default_rng(9)
    log_w = np.log(rng.uniform(0.1, 1.0, 300)).astype(np.float32)
    log_w = np.concatenate([log_w, np.full(212, -1e30, np.float32)])
    gen = torch.Generator().manual_seed(1)
    idx = fast_weighted_choice(gen, torch.as_tensor(log_w), 200000).numpy()
    assert idx.max() < 300 and idx.min() >= 0


def test_draw_frequencies_follow_weights():
    w = np.array([0.1, 0.0, 0.6, 0.3], np.float32)
    gen = torch.Generator().manual_seed(2)
    with np.errstate(divide="ignore"):
        log_w = torch.as_tensor(np.log(w))
    idx = fast_weighted_choice(gen, log_w, 400000).numpy()
    freq = np.bincount(idx, minlength=4) / idx.size
    np.testing.assert_allclose(freq, w, atol=3e-3)


@pytest.mark.parametrize("n", [1, 7, SCAN_ROW, SCAN_ROW + 1, 5 * SCAN_ROW,
                               SCAN_ROW * SCAN_ROW + 3])
def test_ordered_cumsum_is_a_cumsum(n):
    """Rows, the rows' totals, and a second level of totals past
    SCAN_ROW^2 elements: float32 rounding of the float64 scan."""
    rng = np.random.default_rng(n)
    x = rng.uniform(size=n).astype(np.float32)
    got = ordered_cumsum(torch.as_tensor(x))
    assert got.dtype == torch.float32 and got.shape == (n,)
    exact = np.cumsum(x.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), exact, rtol=2e-6,
                               atol=1e-6 * exact[-1])
