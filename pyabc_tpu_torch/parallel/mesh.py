"""The particle mesh over ``torch.distributed`` (port of
``pyabc_tpu/parallel/mesh.py``).

The JAX package shards the candidate batch over a ``jax.sharding.Mesh``
whose "particles" axis spans every chip, and scales out to several
hosts under ``jax.distributed``.  The port's :class:`Mesh` is the small
object that plays that part: the ordered list of shards (one device
each), the axis names, the process group, and which shards this rank
runs.  A sharded round (:class:`~pyabc_tpu_torch.sampler.sharded.
ShardedSampler`) runs each of this rank's shards at ``B / shards`` and
joins the shards' rows in shard order with :func:`all_gather_rows`.

Shard order is host-major (``pyabc_tpu/parallel/mesh.py:63-72``): the
shards of rank 0 come first, then those of rank 1, and so on, so each
rank's rows of a row-sharded array are one contiguous slice
(:func:`host_shard_slice`), which it can journal without talking to the
other ranks.

A device may repeat in a mesh: ``make_mesh(devices=[torch.device("cpu")]
* 8)`` is eight shards in one process on the CPU, the port's counterpart
of the JAX test rig's ``--xla_force_host_platform_device_count=8``, and
``make_mesh(devices=[cuda0, cuda0])`` is two shards on one card.  A
process runs all its shards on one device: the round function's static
state (observed data, priors) lives there.

Backends (:func:`initialize_distributed`): NCCL when every rank has a
card of its own; gloo on the CPU and when several ranks share one card
(NCCL refuses two ranks on one GPU).  gloo has no CUDA ``all_gather``,
so :func:`all_gather_rows` stages CUDA tensors through pinned host
memory under gloo, as ``parallel/health.py`` picks the vote's device by
backend.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..device import resolve_device

PARTICLE_AXIS = "particles"

# DCN (inter-host) x ICI (intra-host) axis names for the 2-D hybrid
# mesh; the flat run mesh collapses both into PARTICLE_AXIS.
DCN_AXIS = "dcn"
ICI_AXIS = "ici"

# logical array axes on the left, mesh axes they may shard over on the
# right: the particle batch is the only sharded logical axis
LOGICAL_AXIS_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("particles", PARTICLE_AXIS),
    ("batch", PARTICLE_AXIS),
    ("params", None),
    ("stats", None),
)


def world() -> Tuple[int, int]:
    """``(rank, world size)`` of the default process group, ``(0, 1)``
    when ``torch.distributed`` is not initialized."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def world_size() -> int:
    return world()[1]


class Mesh:
    """Shards in host-major order over the ranks of a process group.

    ``devices[i]`` is shard ``i``'s device and ``ranks[i]`` the rank
    that runs it; ``axis_names``/``shape`` name the axes (a flat mesh
    has one, the hybrid mesh two).  ``local_shards`` are this rank's
    shard indices, contiguous."""

    def __init__(self, devices: Sequence[torch.device],
                 ranks: Sequence[int],
                 axis_names: Tuple[str, ...] = (PARTICLE_AXIS,),
                 shape: Optional[Tuple[int, ...]] = None,
                 group=None, rank: int = 0):
        self.devices = [torch.device(d) for d in devices]
        self.ranks = [int(r) for r in ranks]
        if len(self.devices) != len(self.ranks) or not self.devices:
            raise ValueError("a mesh needs one rank per shard, and a shard")
        self.axis_names = tuple(axis_names)
        dims = shape if shape is not None else (len(self.devices),)
        if len(dims) != len(self.axis_names):
            raise ValueError(f"shape {dims} does not match the axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, (int(s) for s in dims)))
        self.group = group
        self.rank = int(rank)
        self.local_shards = [i for i, r in enumerate(self.ranks)
                             if r == self.rank]
        if self.local_shards != list(range(
                self.local_shards[0] if self.local_shards else 0,
                self.local_shards[-1] + 1 if self.local_shards else 0)):
            raise ValueError("a rank's shards must be contiguous "
                             "(host-major order)")
        local_devs = {self.devices[i] for i in self.local_shards}
        if len(local_devs) > 1:
            raise ValueError(
                f"rank {self.rank} runs its shards on one device, got "
                f"{sorted(map(str, local_devs))}")

    @property
    def size(self) -> int:
        """The number of shards."""
        return len(self.devices)

    @property
    def world_size(self) -> int:
        return len(set(self.ranks))

    @property
    def local_device(self) -> torch.device:
        """The device this rank's shards run on."""
        return self.devices[self.local_shards[0]]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, ranks={self.world_size}, "
                f"local={self.local_shards} on {self.local_device})")


def default_device() -> torch.device:
    """This rank's card: ``cuda:{local rank}`` (ranks beyond the card
    count share them round-robin), named ``cuda`` when it is the current
    one, as the port's entry points name their default device.  Raises
    without a card (:func:`~pyabc_tpu_torch.device.resolve_device`): a
    mesh on the CPU is asked for with ``devices=[torch.device("cpu")]``."""
    resolve_device(None)
    idx = _local_rank() % torch.cuda.device_count()
    if idx == torch.cuda.current_device():
        return torch.device("cuda")
    return torch.device("cuda", idx)


def _local_rank() -> int:
    rank = world()[0]
    return int(os.environ.get("LOCAL_RANK", rank))


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = PARTICLE_AXIS) -> Mesh:
    """A 1-D mesh over this rank's shards and every other rank's.

    ``devices`` lists this rank's shards, one device each (a device may
    repeat); None is one shard on :func:`default_device`.  With more
    than one rank the ranks exchange their shard counts (one collective
    on the default group, so every rank calls this at the same point)
    and the mesh is the pod mesh of :func:`make_pod_mesh`."""
    local = ([default_device()] if devices is None
             else [torch.device(d) for d in devices])
    rank, size = world()
    if size == 1:
        return Mesh(local, [0] * len(local), (axis_name,))
    return _pod_mesh(local, axis_name)


def _shard_counts(n_local: int) -> List[int]:
    import torch.distributed as dist
    out = [None] * world_size()
    dist.all_gather_object(out, int(n_local))
    return [int(c) for c in out]


def _pod_mesh(local: List[torch.device], axis_name: str) -> Mesh:
    rank, size = world()
    counts = _shard_counts(len(local))
    if len(set(counts)) != 1:
        raise ValueError(f"every rank needs the same number of shards, "
                         f"got {counts}")
    devices, ranks = [], []
    for r, c in enumerate(counts):
        # another rank's device is named by this rank's type: only the
        # count and the order matter off-rank
        devices += local if r == rank else [local[0]] * c
        ranks += [r] * c
    import torch.distributed as dist
    return Mesh(devices, ranks, (axis_name,), group=dist.group.WORLD,
                rank=rank)


def make_pod_mesh(axis_name: str = PARTICLE_AXIS) -> Mesh:
    """The flat pod mesh: one shard per rank on :func:`default_device`,
    host-major (``pyabc_tpu/parallel/mesh.py:75-96``)."""
    return make_mesh(None, axis_name)


def make_hybrid_mesh(axis_names: Tuple[str, str] = (DCN_AXIS, ICI_AXIS),
                     devices: Optional[Sequence] = None) -> Mesh:
    """The 2-D (ranks, local shards) mesh: the slow axis between ranks
    outermost, this rank's shards innermost.  ``devices`` lists this
    rank's shards as in :func:`make_mesh`."""
    flat = make_mesh(devices)
    n_local = len(flat.local_shards)
    return Mesh(flat.devices, flat.ranks, tuple(axis_names),
                shape=(flat.world_size, n_local), group=flat.group,
                rank=flat.rank)


class Sharding(NamedTuple):
    """A layout over a mesh: ``spec[i]`` is the mesh axis array axis
    ``i`` is split over, or None (replicated along it)."""
    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def logical_sharding(mesh: Mesh, *logical_axes: Optional[str]
                     ) -> Sharding:
    """Resolve logical axis names through ``LOGICAL_AXIS_RULES``
    against ``mesh`` (axes the mesh does not carry are replicated)."""
    rules = dict(LOGICAL_AXIS_RULES)
    spec = []
    for ax in logical_axes:
        mesh_ax = rules.get(ax) if ax is not None else None
        spec.append(mesh_ax if mesh_ax in mesh.axis_names else None)
    return Sharding(mesh, tuple(spec))


def particle_sharding(mesh: Mesh, axis_name: str = PARTICLE_AXIS
                      ) -> Sharding:
    """The leading (particle) axis split over the mesh."""
    return Sharding(mesh, (axis_name,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def host_shard_slice(mesh: Optional[Mesh], n: int) -> slice:
    """This rank's contiguous rows of a length-``n`` row-sharded array:
    the rows it may journal without any cross-rank traffic.  ``mesh``
    None is the pod layout of one shard per rank, read from the default
    group's rank and size (no collective: a journal spill may run while
    a peer is dying).  Where ``n`` does not divide evenly the last shard
    takes the remainder, so the ranks' slices always cover all rows."""
    if mesh is None:
        rank, size = world()
        mine, nd = [rank], size
    else:
        mine, nd = mesh.local_shards, mesh.size
    if not mine:
        return slice(0, 0)
    per = n // nd
    stop = n if mine[-1] == nd - 1 else (mine[-1] + 1) * per
    return slice(mine[0] * per, stop)


def per_device_hbm_bytes() -> int:
    """Total memory of this rank's card, or 0 where there is none: the
    capacity model's auto-detect source (``capacity/model.py``)."""
    from ..capacity.model import detect_hbm_bytes
    if not torch.cuda.is_available():
        return 0
    return detect_hbm_bytes(default_device())


def backend_for(num_processes: int, local_world: Optional[int] = None
                ) -> str:
    """The backend rule: ``nccl`` when every rank on this host has a
    card of its own, else ``gloo`` (the CPU, and several ranks sharing
    one card)."""
    if not torch.cuda.is_available():
        return "gloo"
    local_world = num_processes if local_world is None else local_world
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None):
    """Join the run's process group (``pyabc_tpu/parallel/mesh.py:157``):
    ``torch.distributed.init_process_group`` over
    ``tcp://<coordinator_address>`` with ``num_processes`` ranks, this
    one ``process_id``.  Without arguments the rendezvous comes from the
    environment (``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``,
    as ``torchrun`` sets them).  The backend follows :func:`backend_for`
    (``LOCAL_WORLD_SIZE`` counts the ranks on this host, default all of
    them); with a card, this rank's is made current first.  A backend that fails to initialise raises: a rank
    never carries on alone.  Joining twice is a no-op."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
        size, rank = int(num_processes), int(process_id)
    else:
        init_method = "env://"
        size = int(os.environ.get("WORLD_SIZE", num_processes or 1))
        rank = int(os.environ.get("RANK", process_id or 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    backend = backend_for(size, local_world)
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank % local_world))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=size, rank=rank)


@contextmanager
def deterministic_kernels():
    """PyTorch's deterministic kernels inside the block, without the NaN
    fill of new tensors; the previous settings are restored after it.

    A multi-rank run computes its replicated carry on every rank, so
    every rank must compute the same bits: an order-dependent float
    reduction on the card (``index_add_``'s atomics, in the quantile
    sketch and the KDE grid) would let the ranks' ε or supports drift
    apart by an ulp, and then their rounds and collectives.  An op that
    has no deterministic form therefore raises (``warn_only=False``)
    rather than run on and leave the ranks to block at their next
    collective.  The deterministic forms of index writes sort their
    indices, which is slow where many rows share an index: the rounds'
    accepted rows are gathered instead there
    (``sampler.device_loop.append_accepted``).  ``ABCSMC.run`` enters it
    when the world has more than one rank; a one-process twin of a pod
    run enters it to compute the same bits."""
    import torch.utils.deterministic as det
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=False)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        det.fill_uninitialized_memory = prev[2]


def all_gather_rows(tensors: Sequence[torch.Tensor], group=None
                    ) -> List[torch.Tensor]:
    """Every rank's rows of each tensor, concatenated along dim 0 in
    rank order: the port's one collective.

    Each rank passes tensors of the same shapes and dtypes.  They travel
    as one byte buffer per rank (one collective whatever their number
    and dtypes); under gloo a CUDA buffer is staged through pinned host
    memory.  The host seconds of the call are booked to the wire
    ledger's ``collective_s`` (``wire.transfer.record_collective``)."""
    import torch.distributed as dist

    from ..wire import transfer

    t0 = time.perf_counter()
    size = dist.get_world_size(group)
    dev = tensors[0].device
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    sizes = [f.numel() for f in flat]
    # each segment starts on an 8-byte boundary, so that every slice can
    # be viewed as its dtype again
    starts = [0]
    for n in sizes:
        starts.append(starts[-1] + -(-n // 8) * 8)
    packed = torch.zeros(starts[-1], dtype=torch.uint8, device=dev)
    for f, s in zip(flat, starts):
        packed[s:s + f.numel()] = f
    staged = dev.type == "cuda" and dist.get_backend(group) != "nccl"
    if staged:
        host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(packed)
        packed = host
    parts = [torch.empty_like(packed) for _ in range(size)]
    dist.all_gather(parts, packed, group=group)
    if staged:
        parts = [p.to(dev, non_blocking=True) for p in parts]
    out = []
    for j, t in enumerate(tensors):
        s = starts[j]
        rows = [p[s:s + sizes[j]].view(t.dtype).reshape(t.shape)
                for p in parts]
        out.append(torch.cat(rows))
    transfer.record_collective(time.perf_counter() - t0)
    return out
