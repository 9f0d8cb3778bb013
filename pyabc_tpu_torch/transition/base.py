"""Transition (perturbation-kernel) base contract.

Port of ``pyabc_tpu/transition/base.py``.  ``fit`` runs once per
(generation, model) on host numpy float arrays — control-plane math, as
in the JAX package — and exposes the fitted state as a params dict that
the static kernels ``rvs_from_params`` / ``log_pdf_from_params`` consume
on the run's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class Transition:
    """Abstract perturbation kernel over parameter space."""

    #: keys passed through :meth:`pad_params` unchanged (shared state)
    NO_PAD_KEYS: tuple = ()
    #: fill value of padded support rows per key; other keys zero-pad
    PAD_FILL: dict = {"log_w": -1e30}  # padded rows carry ~zero weight
    #: whether the fused engine may refit this transition inside a block
    #: (``ABCSMC._device_chain_eligible``); concrete classes opt in
    device_support_ok = False

    def __init__(self):
        self.theta: Optional[np.ndarray] = None   # support [N, D]
        self.w: Optional[np.ndarray] = None       # normalized weights [N]
        self._fitted = False

    def fit(self, theta, w):
        """Fit from weighted particles ``theta[N, D]``, ``w[N]`` (host)."""
        theta = np.atleast_2d(np.asarray(theta, dtype=np.float32))
        w = np.asarray(w, dtype=np.float32)
        w = w / w.sum()
        self.theta, self.w = theta, w
        self._fitted = True
        if theta.shape[-1] > 0:
            self._fit(theta, w)
        return self

    def _fit(self, theta: np.ndarray, w: np.ndarray):
        raise NotImplementedError

    def get_params(self) -> dict:
        raise NotImplementedError

    def pad_params(self, params: dict, n_pad: int) -> dict:
        """Pad the per-row arrays of ``params`` to ``n_pad`` rows (host):
        keys in ``NO_PAD_KEYS`` and scalars pass through, ``PAD_FILL``
        keys pad with their fill, every other array zero-pads."""
        out = {}
        for k, v in params.items():
            if (k in self.NO_PAD_KEYS or not hasattr(v, "shape")
                    or np.ndim(v) == 0):
                out[k] = v
                continue
            v = np.asarray(v)
            n = v.shape[0]
            if n >= n_pad:
                out[k] = v[:n_pad]
                continue
            fill = self.PAD_FILL.get(k)
            pad_rows = (n_pad - n,) + v.shape[1:]
            if fill is not None:
                out[k] = np.concatenate(
                    [v, np.full(pad_rows, fill, dtype=v.dtype)])
            else:
                out[k] = np.concatenate([v, np.zeros(pad_rows, v.dtype)])
        return out

    @staticmethod
    def rvs_from_params(generator: torch.Generator, params: dict,
                        n: int) -> torch.Tensor:
        raise NotImplementedError

    @staticmethod
    def log_pdf_from_params(x: torch.Tensor, params: dict) -> torch.Tensor:
        raise NotImplementedError

    def static_fns(self):
        """(rvs_from_params, log_pdf_from_params) of this transition."""
        return (type(self).rvs_from_params, type(self).log_pdf_from_params)
