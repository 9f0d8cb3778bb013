"""Default sampler per platform (port of
``pyabc_tpu/platform_factory.py``).

One card gives :class:`VectorizedSampler` on the resolved device.  When
the caller names the run's shape (``population`` and the widths), the
capacity model (:mod:`.capacity.model`) plans it first, as the JAX
package does (engine ``"fused"``, batch ``min(population, 4096)``): under
an active memory budget a shape no (precision, rung) point can fit raises
:class:`~.capacity.CapacityError` here, at construction, with its ledger.

The JAX package returns its ``ShardedSampler`` when several devices are
visible.  The port has no sharded sampler yet, so more than one visible
card raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from .capacity import model as _capacity
from .device import resolve_device
from .sampler.vectorized import VectorizedSampler


def DefaultSampler(population=None, param_dim=None, stat_dim=None,
                   device=None, **kwargs):
    dev = resolve_device(device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    if population is not None:
        _capacity.plan(
            population=int(population),
            param_dim=int(param_dim or 1),
            stat_dim=int(stat_dim or 1),
            engine="fused",
            batch=min(int(population), 4096),
            devices=max(n_dev, 1),
            device=dev)
    if n_dev > 1:
        raise NotImplementedError(
            f"{n_dev} CUDA devices are visible: the JAX package would "
            "return its ShardedSampler, which the port does not have yet; "
            "make one card visible (CUDA_VISIBLE_DEVICES) or construct "
            "VectorizedSampler(device=...) yourself")
    return VectorizedSampler(device=dev, **kwargs)
