"""Screening ops: survivor compaction and scatter-back.

Port of ``pyabc_tpu/fidelity/screen.py``.  The staged round
(``sampler/rounds.py`` ``staged_generation_round``) runs the cheap
low-fidelity stage on the whole round batch ``B``, screens each
candidate's low-fidelity distance against the calibrated threshold,
compacts the first ``n_full`` survivors into a fixed block of slots for
the full-fidelity stage, and scatters the results back to batch shape.

No op here reads the card: the JAX package's ``jnp.nonzero(size=,
fill_value=)`` becomes a cumsum rank and a scatter into ``n_full + 1``
slots (``torch.nonzero`` would wait for the card to learn its output
size), and the scatter-back writes through a dump row, as
``mode="drop"`` does.

Slot truncation (more than ``n_full`` survivors in one round) drops
candidates by row position, which is independent of theta — the rows of
a round batch are exchangeable — so the accepted population stays
unbiased; truncation costs only throughput.
"""

from __future__ import annotations

import torch


def screen_mask(d_lo: torch.Tensor, tau, valid: torch.Tensor
                ) -> torch.Tensor:
    """Survival mask ``valid & ~(d_lo > tau)``: a NaN low-fidelity
    distance survives to full fidelity, and ``tau = +inf`` passes every
    valid candidate."""
    return valid & ~(d_lo > tau)


def compact_survivors(survive: torch.Tensor, n_full: int):
    """First-``n_full`` survivor slots: ``(idx, slot_ok, idx_clamped)``.

    ``idx[n_full]`` indexes into the round batch (``B`` marks a fill
    slot), ``slot_ok`` marks genuine survivors, ``idx_clamped`` is safe to
    gather with (fill slots re-read row ``B - 1``; their outputs are
    masked by ``slot_ok`` and dropped by :func:`scatter_back`)."""
    B = survive.shape[0]
    dev = survive.device
    rank = torch.cumsum(survive.to(torch.int64), 0) - 1
    dst = torch.where(survive & (rank < n_full), rank,
                      torch.full_like(rank, n_full))
    slots = torch.full((n_full + 1,), B, dtype=torch.int64, device=dev)
    slots.scatter_(0, dst, torch.arange(B, device=dev))
    idx = slots[:n_full]
    return idx, idx < B, torch.clamp(idx, max=B - 1)


def scatter_back(idx: torch.Tensor, values: torch.Tensor, B: int, fill
                 ) -> torch.Tensor:
    """Slot results at batch shape: ``out[idx[i]] = values[i]``, ``fill``
    elsewhere; fill slots (``idx == B``) land on a dump row that is cut
    off."""
    out = torch.full((B + 1,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    out[idx] = values
    return out[:B]
