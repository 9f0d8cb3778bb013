"""The port's scale functions against ``pyabc_tpu.distance.scale``.

Each of the 13 ``SCALE_FUNCTIONS`` runs on the same ``[R, S]`` block in
both packages, for each input case: NaN rows, a whole NaN column, even
and odd counts of non-NaN values per column, ties.  Tolerance rtol 1e-5,
atol 1e-6; NaN must sit in the same places.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyabc_tpu.distance import scale as jscale
from pyabc_tpu_torch.distance import scale

NAMES = sorted(scale.SCALE_FUNCTIONS)


def _case(name):
    rng = np.random.default_rng(CASES.index(name))
    if name == "odd_count":
        data = rng.normal(1.0, 2.0, (101, 6))
    elif name == "even_count":
        data = rng.normal(-1.0, 0.5, (100, 6))
    elif name == "nan_rows":
        data = rng.standard_normal((200, 6))
        data[rng.choice(200, 37, replace=False)] = np.nan
    elif name == "nan_column":
        data = rng.standard_normal((64, 5))
        data[:, 2] = np.nan
    elif name == "mixed_counts":
        # per column 0..5 extra NaNs: even and odd non-NaN counts side by
        # side in one block
        data = rng.exponential(1.0, (31, 6))
        for j in range(6):
            data[rng.choice(31, j, replace=False), j] = np.nan
    elif name == "ties":
        data = rng.integers(0, 4, (48, 5)).astype(float)
        data[:, 4] = 2.0   # a constant column: zero spread
    else:
        raise ValueError(name)
    x0 = rng.standard_normal(data.shape[1])
    return data.astype(np.float32), x0.astype(np.float32)


CASES = ["odd_count", "even_count", "nan_rows", "nan_column",
         "mixed_counts", "ties"]


def test_all_thirteen_are_ported():
    assert NAMES == sorted(jscale.SCALE_FUNCTIONS)
    assert len(NAMES) == 13


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", NAMES)
def test_scale_matches_jax(name, case):
    data, x0 = _case(case)
    ref = np.asarray(jscale.SCALE_FUNCTIONS[name](jnp.asarray(data),
                                                  jnp.asarray(x0)))
    got = scale.SCALE_FUNCTIONS[name](torch.as_tensor(data),
                                      torch.as_tensor(x0)).numpy()
    assert got.shape == ref.shape == (data.shape[1],)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_even_count_median_averages_the_middle_pair():
    """Where torch.nanmedian takes the lower middle value."""
    data = torch.tensor([[1.0], [2.0], [10.0], [20.0], [float("nan")]])
    assert float(scale.nanmedian(data)[0]) == 6.0
    assert float(torch.nanmedian(data, 0).values[0]) == 2.0


def test_std_is_ddof0_and_nan_aware():
    data = torch.tensor([[1.0], [3.0], [float("nan")]])
    assert float(scale.nanstd(data)[0]) == 1.0


def test_median_above_torch_nanquantile_limit():
    """A record-sized block of more than 2^24 elements (torch.nanquantile
    refuses it) against numpy's nanmedian."""
    rng = np.random.default_rng(5)
    data = rng.standard_normal(((1 << 21) + 3, 8)).astype(np.float32)
    data[rng.choice(data.shape[0], 1001, replace=False), 3] = np.nan
    assert data.size > 1 << 24
    got = scale.nanmedian(torch.as_tensor(data)).numpy()
    np.testing.assert_allclose(got, np.nanmedian(data, axis=0), rtol=1e-6,
                               atol=1e-7)
