"""Mesh-sharded sampler: rejection rounds split over the shards of a
:class:`~pyabc_tpu_torch.parallel.mesh.Mesh` (port of
``pyabc_tpu/sampler/sharded.py``).

The JAX package ``shard_map``s each round over the mesh's "particles"
axis: every device runs the round on its share of the batch with a key
folded from the round's key and its shard index, and the rows come back
as one array sharded over the mesh.  Here each shard runs the round at
``B / shards`` from a generator of its own, derived from the sampler's
generator and the shard index (``transition.base.sub_generators``: a
hash of the generator's host state and the index — the counterpart of
``fold_in(split(key, nd)[i], i)``); every rank derives every shard's
seed the same way, so the rows do not depend on how the shards are
spread over ranks.  A rank runs its own shards, concatenates their rows
in shard order, and with more than one rank joins every rank's rows
with one ``all_gather`` (``parallel.mesh.all_gather_rows``).

The device loop and its finalize then run replicated on every rank on
the whole batch, as the JAX package's ``while_loop`` does in the
replicated program (``pyabc_tpu/sampler/sharded.py:12-15``): one
generation, one fused engine, one dispatch per rank.  Departure: the
JAX package keeps the round's rows and the carry sharded, each host
holding ``1/hosts`` of them; the port's carry is replicated, so every
rank holds the whole population and runs K1 over the whole accepted
buffer (bit-identical across ranks).

A one-shard mesh is :class:`VectorizedSampler` bit for bit: its round
draws from the sampler's generator itself.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np

from ..parallel.mesh import (PARTICLE_AXIS, Mesh, all_gather_rows,
                             make_mesh)
from ..transition.base import sub_generators
from .base import RoundResult
from .vectorized import VectorizedSampler, _pow2_at_least

_FIELDS = ("m", "theta", "distance", "accepted", "log_weight", "stats",
           "valid", "log_proposal")


def _concat_rows(parts: list):
    """Shard results joined along the batch: ``RoundResult`` fields and
    the staged round's calibration pairs row-concatenated, its survivor
    count (``[1]``) summed."""
    import torch
    first = parts[0]
    if isinstance(first, RoundResult):
        return RoundResult(**{f: torch.cat([getattr(p, f) for p in parts])
                              for f in _FIELDS})
    rr = _concat_rows([p[0] for p in parts])
    plo, pfull, npass = (list(x) for x in zip(*(p[1] for p in parts)))
    return rr, (torch.cat(plo), torch.cat(pfull),
                torch.stack(npass).sum(0))


def _gather_rows(result, mesh: Mesh):
    """Every rank's rows of a (local) shard result, in rank order."""
    if isinstance(result, RoundResult):
        return RoundResult(**dict(zip(_FIELDS, all_gather_rows(
            [getattr(result, f) for f in _FIELDS], mesh.group))))
    rr, (plo, pfull, npass) = result
    plo, pfull, npass = all_gather_rows([plo, pfull, npass], mesh.group)
    return _gather_rows(rr, mesh), (plo, pfull, npass.sum(0, keepdim=True))


class ShardedSampler(VectorizedSampler):
    """:class:`VectorizedSampler` whose rounds are split over a mesh.

    ``mesh`` None is :func:`~pyabc_tpu_torch.parallel.mesh.make_mesh`
    over this rank's device (``device=``, default the card): one shard
    per rank.  The sampler runs on the mesh's device for this rank.

    Its rounds stay eager (``round_graphs`` False): a round gathers its
    shards' rows through the host over gloo, which a CUDA graph cannot
    capture."""

    #: a round's collective is staged through the host: no capture
    round_graphs = False

    def __init__(self, mesh: Optional[Mesh] = None,
                 axis_name: str = PARTICLE_AXIS, **kwargs):
        from ..device import resolve_device
        device = kwargs.pop("device", None)
        dev = None if device is None else resolve_device(device)
        if mesh is None:
            mesh = make_mesh(None if dev is None else [dev], axis_name)
        elif dev is not None and (
                dev.type != mesh.local_device.type
                or dev.index not in (None, mesh.local_device.index)):
            raise ValueError(f"device {dev} is not this rank's mesh "
                             f"device {mesh.local_device}")
        super().__init__(device=resolve_device(mesh.local_device), **kwargs)
        self.mesh = mesh
        self.axis_name = axis_name
        self.n_devices = int(np.prod([mesh.shape[a]
                                      for a in mesh.axis_names]))
        # every round's batch must split evenly over the shards
        self.min_batch_size = max(self.min_batch_size, self.n_devices)

    def capacity_shard_devices(self) -> int:
        """The device count the capacity model divides the population
        terms by (``pyabc_tpu/sampler/sharded.py:51-56``).  The port's
        carry is replicated on every rank, so each rank plans the whole
        population: 1."""
        return 1

    def _round_to_valid_batch(self, b: float) -> int:
        nd = self.n_devices
        # power-of-two ladder + power-of-two shard counts always divide
        if nd & (nd - 1) == 0:
            return super()._round_to_valid_batch(b)
        # other shard counts (e.g. 6): the ladder's rungs become
        # nd * 2^k — still geometric (a bounded number of engines),
        # still evenly divisible
        per_device = max(int(np.ceil(b / nd)), 1)
        B = nd * _pow2_at_least(per_device)
        # clamp along the rung ladder so divisibility survives
        while B < self.min_batch_size:
            B *= 2
        while B > self.max_batch_size and B // 2 >= self.min_batch_size:
            B //= 2
        return B

    def round_at(self, round_fn, B: int, **round_kwargs):
        nd = self.n_devices
        if nd == 1:
            return super().round_at(round_fn, B, **round_kwargs)
        if B % nd:
            raise ValueError(f"batch {B} does not split over {nd} shards")
        B_local = B // nd
        mine = self.mesh.local_shards
        ranks = self.mesh.world_size

        def run(generator, params):
            gens = sub_generators(generator, nd)
            parts = [round_fn(gens[i], params, B_local, **round_kwargs)
                     for i in mine]
            local = _concat_rows(parts) if len(parts) > 1 else parts[0]
            return _gather_rows(local, self.mesh) if ranks > 1 else local

        return run


class RedisEvalParallelSampler(ShardedSampler):
    """Reference-compatible name for the distributed sampler
    (``pyabc/sampler/redis_eps/sampler.py:15-153``): the broker protocol
    becomes sharded rounds over a mesh with ``torch.distributed``
    collectives.  The broker arguments (``host``/``port``/``password``)
    are accepted and ignored, with one ``UserWarning`` per process
    naming them; ``batch_size`` becomes ``min_batch_size``."""

    #: process-wide once-latch for the ignored-arguments warning
    _warned_ignored_kwargs = False

    def __init__(self, host=None, port=None, password=None, batch_size=None,
                 **kwargs):
        ignored = [name for name, value in
                   (("host", host), ("port", port), ("password", password))
                   if value is not None]
        if ignored and not RedisEvalParallelSampler._warned_ignored_kwargs:
            RedisEvalParallelSampler._warned_ignored_kwargs = True
            warnings.warn(
                f"RedisEvalParallelSampler ignores {', '.join(ignored)}: "
                "there is no Redis broker in pyabc_tpu_torch — the sampler "
                "runs sharded rounds over the mesh of this process group. "
                "Remove the broker arguments, or run the reference pyABC "
                "if you need a networked broker.",
                UserWarning, stacklevel=2)
        if batch_size is not None:  # the reference's amortization knob
            kwargs.setdefault("min_batch_size", batch_size)
        super().__init__(**kwargs)
