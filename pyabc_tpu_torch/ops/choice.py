"""Weighted index sampling by inverse CDF.

Port of ``fast_weighted_choice``, ``systematic_weighted_choice`` and
``residual_weighted_choice`` from ``pyabc_tpu/ops/choice.py``.  The JAX package inverts the CDF with a
two-level blocked count (a TPU-shaped way around ``searchsorted``'s
serial gathers); here the inversion is ``torch.searchsorted(cdf, u,
right=True)`` — the same index (the first i with ``cdf[i] > u``) — and
stays plain PyTorch until a card profile shows it hot.
"""

from __future__ import annotations

from typing import Optional

import torch


#: row width of :func:`ordered_cumsum`'s scans
SCAN_ROW = 1024


def ordered_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum(x, 0)`` of a 1-D tensor, added in an order that
    depends on its length alone.

    On the card a 1-D ``torch.cumsum`` is one single-pass scan whose tiles
    add the totals of the tiles before them as those finish, so a float
    CDF can round differently from call to call, and a run that draws
    from it does not repeat.  Here rows of ``SCAN_ROW`` are scanned one
    block per row (PyTorch's scan along the last dimension of a tensor of
    two rows or more), then the rows' totals the same way."""
    n = x.shape[0]
    if n <= SCAN_ROW:
        # a second row keeps the scan off the 1-D path
        return torch.cumsum(torch.stack([x, torch.zeros_like(x)]), 1)[0]
    rows = -(-n // SCAN_ROW)
    padded = torch.zeros(rows * SCAN_ROW, dtype=x.dtype, device=x.device)
    padded[:n] = x
    within = torch.cumsum(padded.view(rows, SCAN_ROW), 1)
    before = torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device),
                        ordered_cumsum(within[:, -1])[:-1]])
    return (within + before[:, None]).view(-1)[:n]


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
    cdf = ordered_cumsum(torch.softmax(log_w, dim=0))
    u = torch.rand(n, generator=generator, device=log_w.device,
                   dtype=cdf.dtype) * cdf[-1]
    return invert_cdf(cdf, cap_draws(cdf, u))


def systematic_weighted_choice(generator: Optional[torch.Generator],
                               log_w: torch.Tensor, n: int,
                               u0: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Systematic (stratified) resampling: ``n`` indices ∝ ``exp(log_w)``
    from ONE uniform ``u0``, ``u_i = (u0 + i)/n · cdf[-1]``.

    Every index with weight ≥ 1/n appears ⌊n·w⌋ or ⌈n·w⌉ times, so the
    resampled rows keep the weighted moments to O(1/n) — what the fused
    engine's capped-support refit wants.  ``u0`` (a scalar in [0, 1))
    replaces the draw from ``generator`` when given, so tests can feed
    both packages the same uniform.  Capped draws never land on a
    zero-weight row (:func:`cap_draws`)."""
    cdf = ordered_cumsum(torch.softmax(log_w, dim=0))
    if u0 is None:
        u0 = torch.rand((), generator=generator, device=log_w.device,
                        dtype=cdf.dtype)
    else:
        u0 = torch.as_tensor(u0, dtype=cdf.dtype, device=log_w.device)
    u = (u0 + torch.arange(n, dtype=cdf.dtype, device=log_w.device)) \
        / n * cdf[-1]
    return invert_cdf(cdf, cap_draws(cdf, u))


def residual_weighted_choice(log_w: torch.Tensor, n: int,
                             rank_cap: Optional[int] = None
                             ) -> torch.Tensor:
    """Deterministic residual resampling: ``n`` indices ∝ ``exp(log_w)``
    with no sampling noise — ⌊n·w⌋ copies each, the remaining slots to
    the largest remainders (exact stable ranking up to ``rank_cap``
    support points, default ``weighted_statistics.RESIDUAL_RANK_CAP``,
    the sort-free top-k sketch above).  The copies are expanded by an
    integer prefix sum, which repeats exactly on the card."""
    from ..weighted_statistics import (RESIDUAL_RANK_CAP,
                                       resample_indices_deterministic)
    if rank_cap is None:
        rank_cap = RESIDUAL_RANK_CAP
    return resample_indices_deterministic(torch.softmax(log_w, dim=0), n,
                                          rank_cap=rank_cap)
