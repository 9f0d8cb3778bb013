"""Random variables, priors and the model-perturbation kernel.

Port of the parts of ``pyabc_tpu/random_variables.py`` that the
sequential path of configs #1/#2 uses: ``RV("norm")``, ``RV("uniform")``,
:class:`Distribution` (batched ``rvs_array`` / ``log_pdf_array`` over
dense ``[N, D]`` tensors) and :class:`ModelPerturbationKernel`.
Randomness comes from an explicit ``torch.Generator``; samples land on
the generator's device.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Union

import torch

from .device import device_of
from .parameters import ParameterSpace

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class RVBase:
    """A 1-D random variable: ``sample`` and ``log_pdf`` over tensors."""

    def sample(self, generator: torch.Generator, shape=()) -> torch.Tensor:
        raise NotImplementedError

    def log_pdf(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def get_config(self) -> dict:
        cfg = {"name": type(self).__name__}
        cfg.update({k: float(v) for k, v in self.__dict__.items()
                    if isinstance(v, (int, float))})
        return cfg

    def __repr__(self):
        return f"<{type(self).__name__} {self.get_config()}>"


class Norm(RVBase):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc = float(loc)
        self.scale = float(scale)

    def sample(self, generator, shape=()):
        z = torch.randn(shape, generator=generator,
                        device=device_of(generator))
        return self.loc + self.scale * z

    def log_pdf(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * z * z - math.log(self.scale) - _LOG_SQRT_2PI


class Uniform(RVBase):
    """Uniform on ``[loc, loc + scale]`` (scipy.stats.uniform convention)."""

    def __init__(self, loc=0.0, scale=1.0):
        self.loc = float(loc)
        self.scale = float(scale)

    def sample(self, generator, shape=()):
        u = torch.rand(shape, generator=generator,
                       device=device_of(generator))
        return self.loc + self.scale * u

    def log_pdf(self, x):
        inside = (x >= self.loc) & (x <= self.loc + self.scale)
        return torch.where(inside, torch.full_like(x, -math.log(self.scale)),
                           torch.full_like(x, -math.inf))


#: the native families this slice ports; the rest come later (ROADMAP)
_NAME_MAP = {"norm": Norm, "uniform": Uniform}


def RV(name: Union[str, RVBase], *args, **kwargs) -> RVBase:
    """Factory with reference API parity: ``RV("norm", 0, 1)``."""
    if isinstance(name, RVBase):
        return name
    cls = _NAME_MAP.get(name)
    if cls is None:
        raise ValueError(f"RV family {name!r} is not ported yet; have "
                         f"{sorted(_NAME_MAP)}")
    return cls(*args, **kwargs)


class Distribution:
    """A product distribution over named parameters: ``rvs_array(gen, n)``
    draws ``[n, dim]`` and ``log_pdf_array(theta)`` evaluates
    ``[N, dim] -> [N]``."""

    def __init__(self, rvs: Optional[Mapping[str, RVBase]] = None, **kwargs):
        items: Dict[str, RVBase] = {}
        if rvs:
            items.update(rvs)
        items.update(kwargs)
        self._rvs: Dict[str, RVBase] = {k: RV(v) for k, v in items.items()}
        self.space = ParameterSpace(list(self._rvs.keys()))

    def __len__(self):
        return len(self._rvs)

    def __iter__(self):
        return iter(self._rvs)

    def __getitem__(self, name) -> RVBase:
        return self._rvs[name]

    def __repr__(self):
        return f"<Distribution {list(self._rvs)}>"

    def get_parameter_names(self) -> list:
        return list(self._rvs)

    @property
    def dim(self) -> int:
        return len(self._rvs)

    def rvs_array(self, generator: torch.Generator,
                  n: Optional[int] = None) -> torch.Tensor:
        """``[n, dim]`` (or ``[dim]`` if n is None) prior samples, one
        column per parameter in name order."""
        shape = () if n is None else (n,)
        if not self._rvs:
            return torch.zeros(shape + (0,), device=device_of(generator))
        cols = [rv.sample(generator, shape) for rv in self._rvs.values()]
        return torch.stack(cols, dim=-1)

    def log_pdf_array(self, theta: torch.Tensor) -> torch.Tensor:
        """Joint log-density ``[..., dim] -> [...]``."""
        parts = [rv.log_pdf(theta[..., i])
                 for i, rv in enumerate(self._rvs.values())]
        if not parts:
            return torch.zeros(theta.shape[:-1], device=theta.device)
        return sum(parts[1:], parts[0])


class ModelPerturbationKernel:
    """Model-jump proposal for model selection: with probability
    ``1 - probability_to_stay`` jump uniformly to one of the other models.
    ``rvs(gen, m[N]) -> m'[N]``; ``log_pmf(m_new, m_old) -> [...]``."""

    def __init__(self, nr_of_models: int, probability_to_stay: float = 0.7):
        self.nr_of_models = int(nr_of_models)
        if self.nr_of_models == 1:
            self.probability_to_stay = 1.0
        else:
            self.probability_to_stay = float(
                min(max(probability_to_stay, 0.0), 1.0))

    def rvs(self, generator: torch.Generator, m: torch.Tensor
            ) -> torch.Tensor:
        if self.nr_of_models == 1:
            return m
        stay = torch.rand(m.shape, generator=generator,
                          device=m.device) < self.probability_to_stay
        jump = torch.randint(0, self.nr_of_models - 1, m.shape,
                             generator=generator, device=m.device)
        jump = torch.where(jump >= m, jump + 1, jump)
        return torch.where(stay, m, jump)

    def log_pmf(self, m_new: torch.Tensor, m_old: torch.Tensor
                ) -> torch.Tensor:
        m_new, m_old = torch.broadcast_tensors(m_new, m_old)
        if self.nr_of_models == 1:
            return torch.where(m_new == m_old, 0.0, -math.inf).to(
                torch.float32)
        p_stay = self.probability_to_stay
        p_jump = (1.0 - p_stay) / (self.nr_of_models - 1)
        logp = torch.where(m_new == m_old,
                           math.log(p_stay) if p_stay > 0 else -math.inf,
                           math.log(p_jump) if p_jump > 0 else -math.inf)
        valid = (m_new >= 0) & (m_new < self.nr_of_models)
        return torch.where(valid, logp, -math.inf).to(torch.float32)
