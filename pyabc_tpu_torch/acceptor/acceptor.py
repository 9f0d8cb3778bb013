"""Acceptors (port of ``pyabc_tpu/acceptor/acceptor.py``: ``Acceptor``,
``UniformAcceptor``, ``StochasticAcceptor``, ``SimpleFunctionAcceptor``
and the reference's ``AcceptorResult`` triple).

Host lifecycle (``initialize`` / ``update`` / ``get_params``) plus a
batched kernel ``accept(generator, distance, params) -> (accept[N],
weight[N])`` on tensors.  The stochastic accept step is the pure
function :func:`stochastic_accept` of the log densities and the
uniforms; ``StochasticAcceptor.accept`` draws the uniforms from the
round's generator.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..distance.kernel import SCALE_LIN, SCALE_LOG, StochasticKernel
from .pdf_norm import pdf_norm_from_kernel, pdf_norm_max_found


class AcceptorResult:
    """The reference's result triple of one acceptance decision."""

    def __init__(self, distance, accept, weight=1.0):
        self.distance = distance
        self.accept = accept
        self.weight = weight


class Acceptor:
    """Abstract acceptor."""

    #: fused-chain capability flag: True when :meth:`get_params` can be
    #: reproduced on the device for every generation of a fused block
    #: (the in-block ε or temperature, at most baked constants); concrete
    #: classes opt in, and ``ABCSMC._device_chain_eligible`` reads it
    device_accept_ok = False

    #: fidelity-cascade capability flag: True when the accept decision is
    #: a deterministic threshold on the distance (d <= eps), the decision
    #: the screen's calibration bounds; a randomized acceptor's depends on
    #: the exact density, which a surrogate does not reproduce
    device_screen_ok = False

    def initialize(self, t: int, get_weighted_distances: Optional[Callable],
                   distance_function=None, x_0=None):
        pass

    def update(self, t: int, get_weighted_distances: Optional[Callable] = None,
               prev_temperature: Optional[float] = None,
               acceptance_rate: Optional[float] = None):
        pass

    def get_epsilon_config(self, t: int) -> dict:
        return {}

    def requires_calibration(self) -> bool:
        return False

    def get_params(self, t: int, epsilon) -> dict:
        """Host params for :meth:`accept` (float32 scalars)."""
        return {"eps": np.float32(epsilon(t))}

    def accept(self, generator: torch.Generator, distance: torch.Tensor,
               params: dict):
        raise NotImplementedError

    def get_config(self):
        return {"name": type(self).__name__}


class SimpleFunctionAcceptor(Acceptor):
    """A plain function as an acceptor: ``fun(distance[N], eps) ->
    accept[N]`` (bool), batched over tensors on the round's device, with
    unit weights."""

    def __init__(self, fun: Callable):
        self.fun = fun

    def accept(self, generator, distance, params):
        return self.fun(distance, params["eps"]), torch.ones_like(distance)

    def get_config(self):
        return {"name": type(self).__name__,
                "fun": getattr(self.fun, "__name__", "custom")}


class UniformAcceptor(Acceptor):
    """Accept iff distance ≤ ε; with ``use_complete_history`` against the
    smallest ε so far."""

    def __init__(self, use_complete_history: bool = False):
        self.use_complete_history = use_complete_history
        self._eps_history: dict = {}

    @property
    def device_accept_ok(self) -> bool:
        """d ≤ ε against the fused engine's in-block epsilon; the
        complete-history minimum needs the host's ε history every
        generation, and a subclass may override :meth:`get_params`."""
        return type(self) is UniformAcceptor and not self.use_complete_history

    @property
    def device_screen_ok(self) -> bool:
        """The deterministic d <= eps test, under the same guards as
        :attr:`device_accept_ok`."""
        return (type(self) is UniformAcceptor
                and not self.use_complete_history)

    def get_params(self, t: int, epsilon) -> dict:
        eps = float(epsilon(t))
        self._eps_history[t] = eps
        if self.use_complete_history:
            eps = min(v for s, v in self._eps_history.items() if s <= t)
        return {"eps": np.float32(eps)}

    def accept(self, generator, distance, params):
        acc = distance <= params["eps"]
        return acc, torch.ones_like(distance)


def stochastic_accept(density: torch.Tensor, u: torch.Tensor,
                      pdf_norm, temp, lin_scale: bool,
                      importance: bool = True):
    """Exact stochastic acceptance of kernel values ``density[N]`` (log
    densities, or densities when ``lin_scale``) given uniforms ``u[N]``:
    accept iff ``log u < (log density − pdf_norm) / temp``; the weight is
    ``exp(max(log_acc_prob, 0))`` with importance weighting, else 1.  A
    density on the linear scale is clamped at 1e-30 before its log."""
    logdens = density
    if lin_scale:
        logdens = torch.log(torch.clamp(density, min=1e-30))
    log_acc_prob = (logdens - pdf_norm) / temp
    acc = torch.log(u) < log_acc_prob
    if importance:
        weight = torch.exp(torch.clamp(log_acc_prob, min=0.0))
    else:
        weight = torch.ones_like(density)
    return acc, weight


class StochasticAcceptor(Acceptor):
    """Exact stochastic acceptance: accept with probability
    ``min(1, (pdf/c)^(1/T))``; a candidate whose density exceeds the
    normalization c carries the importance weight ``(pdf/c)^(1/T)``.
    ``pdf_norms[t]`` holds log c per generation."""

    def __init__(self, pdf_norm_method: Callable = None,
                 apply_importance_weighting: bool = True,
                 log_file: Optional[str] = None):
        self.pdf_norm_method = pdf_norm_method or pdf_norm_max_found
        self.apply_importance_weighting = apply_importance_weighting
        self.log_file = log_file
        self.pdf_norms: dict = {}
        #: norms installed by ``convert.install_annealing``: a generation
        #: found here keeps its norm instead of computing one
        self.installed_norms: dict = {}
        self.kernel_scale: str = SCALE_LOG
        self.kernel_pdf_max: Optional[float] = None

    def requires_calibration(self) -> bool:
        return True

    @property
    def device_accept_ok(self) -> bool:
        """(pdf norm, T) acceptance with T from the fused engine's
        in-block temperature solve: the norm must stay one constant for a
        whole block, which only the kernel-derived method guarantees
        (``pdf_norm_max_found`` follows the realized densities on the
        host)."""
        return (type(self) is StochasticAcceptor
                and self.pdf_norm_method is pdf_norm_from_kernel)

    def initialize(self, t, get_weighted_distances=None,
                   distance_function=None, x_0=None):
        if isinstance(distance_function, StochasticKernel):
            self.kernel_scale = distance_function.ret_scale
            self.kernel_pdf_max = distance_function.pdf_max
        self._update_pdf_norm(t, get_weighted_distances, None)

    def update(self, t, get_weighted_distances=None, prev_temperature=None,
               acceptance_rate=None):
        self._update_pdf_norm(t, get_weighted_distances, prev_temperature)

    def _log_scale(self, values):
        values = np.asarray(values, dtype=np.float64)
        if self.kernel_scale == SCALE_LIN:
            with np.errstate(divide="ignore"):
                values = np.log(np.maximum(values, 1e-290))
        return values

    def _update_pdf_norm(self, t, get_weighted_distances, prev_temperature):
        if t in self.installed_norms:
            self.pdf_norms[t] = float(self.installed_norms[t])
        else:
            kernel_val = self.kernel_pdf_max
            if kernel_val is not None and self.kernel_scale == SCALE_LIN:
                kernel_val = float(np.log(max(kernel_val, 1e-290)))

            def get_log_weighted():
                dens, w = get_weighted_distances()
                return self._log_scale(dens), w

            self.pdf_norms[t] = float(self.pdf_norm_method(
                kernel_val=kernel_val,
                prev_pdf_norm=self.pdf_norms.get(t - 1),
                get_weighted_distances=(get_log_weighted
                                        if get_weighted_distances else None),
                prev_temp=prev_temperature))
        if self.log_file:
            from ..storage.json import save_dict_to_json
            save_dict_to_json(self.pdf_norms, self.log_file)

    def get_epsilon_config(self, t: int) -> dict:
        """For the temperature schemes: ``pdf_norm`` (log scale) and the
        kernel's ``ret_scale`` (the scale of the record values)."""
        return {"pdf_norm": self.pdf_norms.get(t, 0.0),
                "kernel_scale": self.kernel_scale}

    def get_params(self, t: int, epsilon) -> dict:
        return {"pdf_norm": np.float32(self.pdf_norms[t]),
                "temp": np.float32(epsilon(t))}

    def accept(self, generator, distance, params):
        """``distance`` is each candidate's kernel (log-)density."""
        u = torch.rand(distance.shape, generator=generator,
                       device=distance.device)
        return stochastic_accept(distance, u, params["pdf_norm"],
                                 params["temp"],
                                 self.kernel_scale == SCALE_LIN,
                                 self.apply_importance_weighting)

    def get_config(self):
        return {"name": type(self).__name__,
                "pdf_norm_method": getattr(
                    self.pdf_norm_method, "__name__",
                    type(self.pdf_norm_method).__name__)}
