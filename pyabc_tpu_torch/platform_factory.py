"""Default sampler per platform (port of
``pyabc_tpu/platform_factory.py``).

One card gives :class:`VectorizedSampler` on the resolved device.  When
the caller names the run's shape (``population`` and the widths), the
capacity model (:mod:`.capacity.model`) plans it first, as the JAX
package does (engine ``"fused"``, batch ``min(population, 4096)``): under
an active memory budget a shape no (precision, rung) point can fit raises
:class:`~.capacity.CapacityError` here, at construction, with its ledger.

With more than one device — several visible cards, or a
``torch.distributed`` world above one rank — it returns
:class:`~.sampler.sharded.ShardedSampler` over
:func:`~.parallel.mesh.make_mesh` (one shard per rank on this rank's
device), as the JAX package does (``pyabc_tpu/platform_factory.py:41``).
A process drives one card: to use every card of a host, run one rank
per card (``python -m pyabc_tpu_torch.parallel.cli``).
"""

from __future__ import annotations

import torch

from .capacity import model as _capacity
from .device import resolve_device
from .parallel.mesh import world_size
from .sampler.sharded import ShardedSampler
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
    if n_dev > 1 or world_size() > 1:
        return ShardedSampler(device=dev, **kwargs)
    return VectorizedSampler(device=dev, **kwargs)
