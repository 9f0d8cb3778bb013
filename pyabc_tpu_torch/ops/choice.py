"""Weighted index sampling by inverse CDF.

Port of ``pyabc_tpu/ops/choice.py:fast_weighted_choice``.  The JAX
package inverts the CDF with a two-level blocked count (a TPU-shaped way
around ``searchsorted``'s serial gathers); here the inversion is
``torch.searchsorted(cdf, u, right=True)`` — the same index (the first i
with ``cdf[i] > u``) — and stays plain PyTorch until a card profile shows
it hot.
"""

from __future__ import annotations

import torch


def cap_draws(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Cap draws strictly below ``cdf[-1]``.

    A draw scaled by ``cdf[-1]`` can round up to exactly ``cdf[-1]`` in
    float32; no ``cdf[i] > u`` then exists and a plain ``N - 1`` clamp
    would land on a zero-weight pad row.  Capping at the float just below
    ``cdf[-1]`` routes such a draw to the LAST positive-weight index, and
    makes flat (zero-weight) CDF segments unhittable even when ``u`` lands
    exactly on their value.
    """
    top = torch.nextafter(cdf[-1:], torch.zeros_like(cdf[-1:]))
    return torch.minimum(u, top)


def invert_cdf(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``idx = smallest i with cdf[i] > u`` for every (capped) draw."""
    idx = torch.searchsorted(cdf, u, right=True)
    return torch.clamp(idx, max=cdf.shape[0] - 1)


def fast_weighted_choice(generator: torch.Generator, log_w: torch.Tensor,
                         n: int) -> torch.Tensor:
    """``n`` indices sampled ∝ ``exp(log_w)`` (unnormalized log weights);
    rows with ``log_w`` ≈ -inf (pads at -1e30) are never drawn."""
    cdf = torch.cumsum(torch.softmax(log_w, dim=0), dim=0)
    u = torch.rand(n, generator=generator, device=log_w.device,
                   dtype=cdf.dtype) * cdf[-1]
    return invert_cdf(cdf, cap_draws(cdf, u))
