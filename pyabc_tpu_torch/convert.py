"""Carry state between the JAX package and the port.

``to_torch`` turns round params as host numpy — the JAX package's
``{"model_log_probs", "transition": (per-model dicts of support, log_w,
chol, log_norm[, c_support, c_log_w]), "distance", "acceptor"}`` or the
port's own, which has the same layout — into tensors on one device.
Floating arrays and scalars become float32 (JAX without x64 runs in
float32), integer arrays int64, booleans stay booleans.  The sampler uses
it to pin each generation's params on the run's device once.

``to_numpy`` is the converse for anything the port holds (a population's
``m``/``theta`` tensors, a params dict), so both packages can evaluate
e.g. ``proposal_log_density`` on one identical input.

``install_weights`` puts a distance weight schedule ``{t: w[S]}`` — host
numpy in both packages, e.g. the JAX package's fitted
``AdaptivePNormDistance.weights`` — into a port distance.
``install_annealing`` puts an annealing schedule — e.g. a JAX run's
``Temperature.temperatures`` and ``StochasticAcceptor.pdf_norms`` — into
a port ``Temperature`` and ``StochasticAcceptor``.  ``carry_to_torch``,
``carry_to_numpy`` and ``install_block_state`` move a fused block's carry
between the packages — its narrowed lanes included — and put in the
block state (ε/T, rate, safety, distance weights, record ring,
calibration rings), so that one generation of both can start from an
identical carry.  ``install_local_transition`` puts a fitted
``LocalTransition``'s state (support, weights, Cholesky factors and log
norms, e.g. from the JAX package's fit) into a port ``LocalTransition``;
``install_population_size`` sets an ``AdaptivePopulationSize``'s current
size.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch


def to_torch(tree, device):
    """Nested dicts / tuples / lists of arrays and scalars -> tensors on
    ``device`` (float32 for floating values)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(v, device) for v in tree)
    if torch.is_tensor(tree):
        t = tree.to(device)
        return t.to(torch.float32) if t.is_floating_point() else t
    arr = np.asarray(tree)
    if arr.dtype == np.bool_:
        return torch.as_tensor(arr, device=device)
    if np.issubdtype(arr.dtype, np.integer):
        return torch.as_tensor(arr.astype(np.int64), device=device)
    if np.issubdtype(arr.dtype, np.floating) or isinstance(
            tree, numbers.Real):
        return torch.as_tensor(arr.astype(np.float32), device=device)
    raise TypeError(f"cannot convert {type(tree)} to a tensor")


def to_numpy(tree):
    """Nested dicts / tuples / lists of tensors -> host numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def install_weights(distance, weights: dict, sub_weights=None):
    """Replace ``distance.weights`` with ``{int(t): float32 w}`` copied
    from ``weights`` — for an (adaptive) aggregated distance its
    sub-distance weights — and, given ``sub_weights`` (one schedule or
    None per sub-distance of an aggregated distance), each sub-distance's
    own; returns the distance."""
    distance.weights = {int(t): np.array(to_numpy(w), dtype=np.float32)
                        for t, w in weights.items()}
    for sub, sched in zip(getattr(distance, "distances", ()),
                          sub_weights or ()):
        if sched is not None:
            install_weights(sub, sched)
    return distance


def install_local_transition(transition, support, w, chols, log_norms):
    """Put a fitted state into a port ``LocalTransition``: the support
    ``[N, D]``, its normalized weights ``[N]``, the per-particle Cholesky
    factors ``[N, D, D]`` and log norms ``[N]`` (host arrays or tensors,
    e.g. a JAX fit's ``theta``, ``w``, ``_chols``, ``_log_norms``).
    Returns the transition."""
    transition.theta = np.array(to_numpy(support), dtype=np.float32)
    transition.w = np.array(to_numpy(w), dtype=np.float32)
    transition._chols = np.array(to_numpy(chols), dtype=np.float32)
    transition._log_norms = np.array(to_numpy(log_norms), dtype=np.float32)
    transition._fitted = True
    return transition


def install_population_size(strategy, nr_particles: int):
    """Set a population strategy's current size (an
    ``AdaptivePopulationSize`` resumes from it); returns the strategy."""
    strategy.nr_particles = int(nr_particles)
    return strategy


def _carry_lane_to_torch(v, device):
    """One carry lane: an int8 array (a narrowed lane's code) stays int8,
    a bfloat16 one (``ml_dtypes``, as JAX hands it out) becomes a
    bfloat16 tensor; anything else goes through :func:`to_torch`."""
    if torch.is_tensor(v):
        if v.dtype in (torch.int8, torch.bfloat16):
            return v.to(device)
        return to_torch(v, device)
    arr = np.asarray(v)
    if arr.dtype == np.int8:
        return torch.as_tensor(np.array(arr), device=device)
    if arr.dtype.name == "bfloat16":
        return torch.as_tensor(arr.astype(np.float32),
                               device=device).to(torch.bfloat16)
    return to_torch(v, device)


def carry_to_torch(carry_np: dict, device) -> dict:
    """A fused block's carry from host arrays — e.g. a JAX block's carry
    read back with ``np.asarray`` — as tensors on ``device``: floats
    float32, integers int64 (``count`` and the model index), 0-d arrays
    0-d tensors; a narrowed lane keeps its at-rest dtype (int8 codes with
    their float32 ``_qs``/``_qm`` aux lanes, or bfloat16), and the
    calibration rings ``cal_lo``/``cal_full`` are float32 lanes."""
    return {k: _carry_lane_to_torch(v, device) for k, v in carry_np.items()}


def carry_to_numpy(carry: dict) -> dict:
    """The converse of :func:`carry_to_torch`: every lane as a host
    array (the JAX package's ``fused`` takes these as its carry).  int8
    codes stay int8; a bfloat16 lane comes back as the float32 array of
    the same values (numpy has no bfloat16)."""
    return {k: to_numpy(v.to(torch.float32) if torch.is_tensor(v)
                        and v.dtype == torch.bfloat16 else v)
            for k, v in carry.items()}


def install_block_state(carry: dict, eps=None, rate=None, safety=None,
                        dist_w=None, ring=None, cal=None) -> dict:
    """A copy of ``carry`` (host arrays or tensors) with the block state
    that a sequential generation does not hold put in: ε or T, the EWMA
    rate and safety, the adaptive distance's raw weights ``dist_w``, the
    record ring ``{"rec_m", "rec_theta", "rec_dist", "rec_loggen"}`` and
    the calibration rings ``{"cal_lo", "cal_full"}``.  Scalars become
    float32 of the carry's kind, so both packages can start a generation
    from one identical state."""
    out = dict(carry)
    device = next((v.device for v in carry.values() if torch.is_tensor(v)),
                  None)

    def lane(v, dtype=np.float32):
        arr = np.asarray(to_numpy(v), dtype=dtype)
        return to_torch(arr, device) if device is not None else arr

    for key, val in (("eps", eps), ("rate", rate), ("safety", safety),
                     ("dist_w", dist_w)):
        if val is not None:
            out[key] = lane(val)
    if ring is not None:
        for key, val in ring.items():
            out[key] = lane(val, np.int64 if key == "rec_m" else np.float32)
    for key, val in (cal or {}).items():
        out[key] = lane(val)
    return out


def install_annealing(temperature, acceptor, temperatures: dict,
                      pdf_norms: dict):
    """Install ``{t: T}`` into ``temperature`` and ``{t: log c}`` into
    ``acceptor``: in a run, each installed generation keeps its
    temperature and pdf norm instead of computing them (its schemes and
    norm method are not consulted).  Returns ``(temperature, acceptor)``."""
    temperature.installed = {int(t): float(v)
                             for t, v in temperatures.items()}
    acceptor.installed_norms = {int(t): float(v)
                                for t, v in pdf_norms.items()}
    return temperature, acceptor
