"""Transition (perturbation-kernel) base contract.

Port of ``pyabc_tpu/transition/base.py``.  ``fit`` runs once per
(generation, model) on host numpy float arrays — control-plane math, as
in the JAX package — and exposes the fitted state as a params dict that
the static kernels ``rvs_from_params`` / ``log_pdf_from_params`` consume
on the run's device.

The bootstrap estimate of the fitted density's uncertainty,
:meth:`Transition.mean_cv` and :meth:`Transition.required_nr_samples`,
draws the bootstrap indices from a ``torch.Generator`` on its device,
refits on the host and evaluates each refit's density at the test points
on that device (for the Gaussian KDE: the KDE kernel).

:class:`AggregatedTransition` composes transitions over disjoint blocks
of parameter columns.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np
import torch

from ..convert import to_torch
from ..device import device_of, note_uncapturable, resolve_device
from ..ops.choice import fast_weighted_choice


class Transition:
    """Abstract perturbation kernel over parameter space."""

    #: keys passed through :meth:`pad_params` unchanged (shared state)
    NO_PAD_KEYS: tuple = ()
    #: fill value of padded support rows per key ("eye" fills a ``[*, D,
    #: D]`` stack with identity matrices); other keys zero-pad
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
            if isinstance(fill, str) and fill == "eye":
                out[k] = np.concatenate([v, np.broadcast_to(
                    np.eye(v.shape[-1], dtype=v.dtype), pad_rows)])
            elif fill is not None:
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

    # ---- eager convenience ---------------------------------------------

    def _check_fitted(self):
        if not self._fitted:
            raise NotFittedError(type(self).__name__)

    def _as_device_tensor(self, x) -> torch.Tensor:
        """``x`` as float32 on its own device (a tensor) or on the
        transition's ``device`` attribute (the card by default)."""
        if torch.is_tensor(x):
            return x.to(torch.float32)
        dev = resolve_device(getattr(self, "device", None))
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)

    def rvs(self, generator: torch.Generator, size: Optional[int] = None
            ) -> torch.Tensor:
        self._check_fitted()
        n = 1 if size is None else int(size)
        dev = device_of(generator)
        if self.theta.shape[-1] == 0:
            out = torch.zeros(n, 0, device=dev)
        else:
            out = self.rvs_from_params(
                generator, to_torch(self.get_params(), dev), n)
        return out[0] if size is None else out

    def log_pdf(self, x) -> torch.Tensor:
        self._check_fitted()
        x = self._as_device_tensor(x)
        single = x.ndim == 1
        x2 = torch.atleast_2d(x)
        if self.theta.shape[-1] == 0:
            out = torch.zeros(x2.shape[0], device=x.device)
        else:
            out = self.log_pdf_from_params(
                x2, to_torch(self.get_params(), x.device))
        return out[0] if single else out

    def pdf(self, x) -> torch.Tensor:
        return torch.exp(self.log_pdf(x))

    # ---- bootstrap density uncertainty -----------------------------------

    def mean_cv(self, generator: torch.Generator,
                n_samples: Optional[int] = None, n_bootstrap: int = 5,
                test_points=None) -> float:
        """Mean coefficient of variation of the fitted density over the
        test points (default: the support), weighted by the support
        weights, from ``n_bootstrap`` refits on multinomial resamples of
        ``n_samples`` rows.  Each refit's density runs on the generator's
        device; the last refit's density shape is kept as
        ``cv_density_shape`` = ``(test rows, support rows, d)``."""
        self._check_fitted()
        dev = device_of(generator)
        n = int(self.theta.shape[0]) if n_samples is None else int(n_samples)
        test = self.theta if test_points is None else test_points
        test = torch.as_tensor(np.asarray(test, dtype=np.float32),
                               device=dev)
        log_w = torch.as_tensor(np.log(np.maximum(self.w, 1e-38)),
                                device=dev)
        hyper = {k: v for k, v in self.__dict__.items()
                 if k not in ("theta", "w", "_fitted")}
        densities = []
        for _ in range(n_bootstrap):
            idx = fast_weighted_choice(generator, log_w, n).cpu().numpy()
            boot = type(self)()
            boot.__dict__.update(hyper)
            boot.fit(self.theta[idx], np.ones(n, dtype=np.float32))
            params = boot.get_params()
            densities.append(torch.exp(boot.log_pdf_from_params(
                test, to_torch(params, dev))))
        self.cv_density_shape = (
            int(test.shape[0]),
            int(params.get("c_support", params["support"]).shape[0]),
            int(test.shape[1]))
        dens = torch.stack(densities)  # [n_bootstrap, M]
        cv = dens.std(0, correction=0) / dens.mean(0).clamp(min=1e-30)
        w = torch.as_tensor(self.w, device=dev)
        return float((w * cv).sum())

    def required_nr_samples(self, generator: torch.Generator,
                            coefficient_of_variation: float,
                            n_bootstrap: int = 5) -> int:
        """The population size whose bootstrap CV meets the target: CVs
        at a quarter, half and all of the current size, a power law
        through them, inverted (``predict_population_size``)."""
        from .predict_population_size import predict_population_size
        current = int(self.theta.shape[0])
        cvs = {n: self.mean_cv(generator, n_samples=n,
                               n_bootstrap=n_bootstrap)
               for n in sorted({max(current // 4, 8), max(current // 2, 8),
                                current})}
        return predict_population_size(cvs, coefficient_of_variation,
                                       fallback=current)


class NotFittedError(Exception):
    """Raised when rvs / pdf is called before fit."""


def sub_generators(generator: torch.Generator, k: int) -> list:
    """``k`` generators on ``generator``'s device, one stream each, seeded
    from a hash of ``generator``'s state (host bytes: a CUDA generator
    keeps its seed and offset on the host, so nothing is read from the
    card); ``generator`` then advances by one draw, so the next call
    seeds new streams.  The same state gives the same streams."""
    # a CUDA graph would freeze these seeds at its capture
    note_uncapturable("sub_generators seeds new generators from the host "
                      "state of the run's")
    state = generator.get_state().numpy().tobytes()
    dev = device_of(generator)
    out = []
    for i in range(k):
        digest = hashlib.blake2b(state + i.to_bytes(4, "little"),
                                 digest_size=8).digest()
        sub = torch.Generator(device=dev)
        sub.manual_seed(int.from_bytes(digest, "little") & (2 ** 63 - 1))
        out.append(sub)
    torch.empty(1, device=dev).uniform_(generator=generator)
    return out


class AggregatedTransition(Transition):
    """Disjoint contiguous blocks of parameter columns, each with a
    transition of its own (``pyabc_tpu/transition/base.py:210``).

    ``mapping`` is ``{(start, stop): Transition}``; the blocks must tile
    the columns from 0 without gaps or overlaps, and they are always
    visited in ascending column order, whatever the dict's order.  The
    composed kernels draw each block from its own generator stream
    (:func:`sub_generators`) and sum the blocks' log densities; a
    :class:`MultivariateNormalTransition` block runs the KDE kernel on
    its own columns."""

    def __init__(self, mapping: dict):
        super().__init__()
        self.mapping = dict(mapping)
        expected_start = 0
        for a, b in sorted(self.mapping):
            if b <= a:
                raise ValueError(f"empty mapping slice ({a}, {b})")
            if a != expected_start:
                raise ValueError(
                    f"mapping slices must tile columns contiguously from "
                    f"0; got {sorted(self.mapping)} (gap/overlap at column "
                    f"{a})")
            expected_start = b

    def _blocks(self):
        """``(start, stop, key, transition)`` in ascending column order."""
        return [(a, b, f"{a}:{b}", sub)
                for (a, b), sub in sorted(self.mapping.items(),
                                          key=lambda item: item[0])]

    def _fit(self, theta, w):
        for a, b, _, sub in self._blocks():
            sub.fit(theta[:, a:b], w)

    def get_params(self) -> dict:
        return {key: sub.get_params() for _, _, key, sub in self._blocks()}

    def pad_params(self, params: dict, n_pad: int) -> dict:
        # each block pads its own params
        return {key: sub.pad_params(params[key], n_pad)
                for _, _, key, sub in self._blocks()}

    def static_fns(self):
        """The composed ``(rvs_from_params, log_pdf_from_params)`` over
        the blocks' own static kernels."""
        blocks = [(a, b, key, sub.static_fns())
                  for a, b, key, sub in self._blocks()]

        def rvs_from_params(generator, params: dict, n: int):
            gens = sub_generators(generator, len(blocks))
            return torch.cat(
                [torch.atleast_2d(rvs(g, params[key], n))
                 for g, (_, _, key, (rvs, _)) in zip(gens, blocks)], dim=-1)

        def log_pdf_from_params(x, params: dict):
            total = torch.zeros(x.shape[0], device=x.device)
            for a, b, key, (_, log_pdf) in blocks:
                total = total + log_pdf(x[:, a:b], params[key])
            return total

        return rvs_from_params, log_pdf_from_params

    def rvs_from_params(self, generator, params: dict, n: int):
        return self.static_fns()[0](generator, params, n)

    def log_pdf_from_params(self, x, params: dict):
        return self.static_fns()[1](x, params)
