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
e.g. ``proposal_log_density`` on one identical input.  Loading a
database written by ``pyabc_tpu`` needs its PTW1 blob codec and comes
later.
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
