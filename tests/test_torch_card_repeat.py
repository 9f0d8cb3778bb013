"""Runs of the port repeat on the card.

Marked ``cuda``: without a card every test here skips.  The file imports
neither JAX nor the JAX package (the machine with the card has no JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kde_cuda.py tests/test_torch_card_repeat.py

A 1-D ``torch.cumsum`` on the card adds its tiles' totals in an order set
by which tiles finish first, so from ~1e5 elements the float32 CDF of the
resampling step differs in the last place from call to call, and at pop
1e6 two runs of one seed drew different particles in their first fused
generation.  ``ops.choice.ordered_cumsum`` fixes the order; the draws of
both resampling schemes must now repeat bit for bit.
"""

import pytest
import torch

from pyabc_tpu_torch.ops.choice import (fast_weighted_choice,
                                        ordered_cumsum,
                                        systematic_weighted_choice)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (see the module docstring)")
    return torch.device("cuda")


def _log_w(dev, n):
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    return torch.randn(n, generator=gen, device=dev)


@pytest.mark.parametrize("n", [100_000, 1_000_000, 3_000_000])
def test_ordered_cumsum_repeats(dev, n):
    x = torch.softmax(_log_w(dev, n), 0)
    ref = ordered_cumsum(x)
    assert all(torch.equal(ordered_cumsum(x), ref) for _ in range(20))
    exact = torch.cumsum(x.double(), 0)
    assert float((ref.double() - exact).abs().max()) <= 1e-5


@pytest.mark.parametrize("choice", ["fast", "systematic"])
def test_resampling_draws_repeat_at_pop_1e6(dev, choice):
    log_w = _log_w(dev, 1_000_000)

    def draw():
        gen = torch.Generator(device=dev)
        gen.manual_seed(11)
        if choice == "fast":
            return fast_weighted_choice(gen, log_w, 1 << 19)
        return systematic_weighted_choice(gen, log_w, 1 << 14)

    ref = draw()
    assert all(torch.equal(draw(), ref) for _ in range(10))
