"""Random variables, priors and the model-perturbation kernel.

Port of ``pyabc_tpu/random_variables.py``: the 15 native families
(``RV("norm")``, ``"uniform"``, ``"lognorm"``, ``"expon"``, ``"laplace"``,
``"cauchy"``, ``"gamma"``, ``"beta"``, ``"randint"``, ``"poisson"``,
``"t"``, ``"chi2"``, ``"weibull_min"``, ``"binom"``, ``"nbinom"``), each
with ``sample``, ``log_pdf`` and ``cdf`` over tensors (``ppf`` where the
JAX class has one); the decorators :class:`TruncatedRV` /
:func:`LowerBoundDecorator`; :class:`ScipyRV` (any other ``scipy.stats``
name, evaluated on the host) and :class:`TabulatedRV` (table
approximation on the device); :class:`Distribution` (batched
``rvs_array`` / ``log_pdf_array`` over dense ``[N, D]`` tensors) and
:class:`ModelPerturbationKernel`.

Randomness comes from an explicit ``torch.Generator``; samples land on
the generator's device.  The gamma, beta, chi², t and negative-binomial
draws go through ``torch._standard_gamma``, ``torch.poisson`` and
``torch.binomial``, which take the generator
(``torch.distributions.*.sample`` does not).  torch has no regularized
incomplete beta: :func:`betainc` is the port's own (a continued fraction
in float64), behind the Beta, t, binomial and negative-binomial cdfs.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from .device import device_of, make_generator
from .parameters import Parameter, ParameterSpace

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)

#: continued-fraction steps of :func:`betainc` (two partial numerators
#: each); enough for shape parameters up to ~1e4
BETAINC_STEPS = 300
_TINY = 1e-300


def _full(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full_like(x, float(value))


def _rand(generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=generator,
                      device=device_of(generator))


def _standard_gamma(generator, a: float, shape) -> torch.Tensor:
    """Gamma(a, 1) draws from ``generator``."""
    alpha = torch.full(shape, float(a), device=device_of(generator))
    return torch._standard_gamma(alpha, generator=generator)


def _lbeta(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def betainc(a, b, x) -> torch.Tensor:
    """Regularized incomplete beta ``I_x(a, b)`` (``scipy.special.
    betainc``), elementwise over broadcast tensors.

    torch has none.  This is the continued fraction of Numerical Recipes
    §6.4 (modified Lentz, :data:`BETAINC_STEPS` steps, no data-dependent
    stop) in float64, on ``x``'s device, with the symmetry ``I_x(a, b) =
    1 − I_{1−x}(b, a)`` above ``x = (a + 1)/(a + b + 2)`` where the
    fraction converges fast.  Result in ``x``'s floating dtype.  Against
    ``scipy.special.betainc`` for ``a, b`` in [0.05, 1e3] it agrees to
    ~1e-12 absolute (tests/test_torch_random_variables.py).
    """
    x = torch.as_tensor(x)
    out_dtype = x.dtype if x.is_floating_point() else torch.float32
    a, b, x = torch.broadcast_tensors(
        torch.as_tensor(a, dtype=torch.float64, device=x.device),
        torch.as_tensor(b, dtype=torch.float64, device=x.device),
        x.to(torch.float64))
    xc = x.clamp(0.0, 1.0)
    swap = xc > (a + 1.0) / (a + b + 2.0)
    aa = torch.where(swap, b, a)
    bb = torch.where(swap, a, b)
    xx = torch.where(swap, 1.0 - xc, xc)
    qab, qap, qam = aa + bb, aa + 1.0, aa - 1.0

    def fix(v):
        return torch.where(v.abs() < _TINY, torch.full_like(v, _TINY), v)

    c = torch.ones_like(xx)
    d = 1.0 / fix(1.0 - qab * xx / qap)
    h = d
    for m in range(1, BETAINC_STEPS + 1):
        m2 = 2.0 * m
        num = m * (bb - m) * xx / ((qam + m2) * (aa + m2))
        d = 1.0 / fix(1.0 + num * d)
        c = fix(1.0 + num / c)
        h = h * d * c
        num = -(aa + m) * (qab + m) * xx / ((aa + m2) * (qap + m2))
        d = 1.0 / fix(1.0 + num * d)
        c = fix(1.0 + num / c)
        h = h * d * c
    safe = xx.clamp(min=_TINY)
    log_front = (aa * torch.log(safe) + bb * torch.log1p(-safe)
                 - _lbeta(aa, bb) - torch.log(aa))
    val = torch.exp(log_front) * h
    val = torch.where(xx <= 0.0, torch.zeros_like(val), val)
    val = torch.where(swap, 1.0 - val, val)
    val = torch.where(x <= 0.0, torch.zeros_like(val), val)
    val = torch.where(x >= 1.0, torch.ones_like(val), val)
    return val.to(out_dtype)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor,
            left: Optional[float] = None,
            right: Optional[float] = None) -> torch.Tensor:
    """``numpy.interp`` over tensors (``xp`` increasing)."""
    idx = torch.searchsorted(xp, x.contiguous(), right=True).clamp(
        1, xp.shape[0] - 1)
    x0, x1 = xp[idx - 1], xp[idx]
    f0, f1 = fp[idx - 1], fp[idx]
    span = x1 - x0
    frac = torch.where(span > 0, (x - x0) / torch.where(
        span > 0, span, torch.ones_like(span)), torch.zeros_like(span))
    out = f0 + frac * (f1 - f0)
    lo = fp[0] if left is None else torch.full_like(out, left)
    hi = fp[-1] if right is None else torch.full_like(out, right)
    out = torch.where(x < xp[0], lo, out)
    return torch.where(x > xp[-1], hi, out)


class RVBase:
    """A 1-D random variable: ``sample``, ``log_pdf`` and ``cdf`` over
    tensors."""

    #: True for integer-valued RVs (the density is a pmf)
    discrete: bool = False

    def sample(self, generator: torch.Generator, shape=()) -> torch.Tensor:
        raise NotImplementedError

    def log_pdf(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def pdf(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.log_pdf(x))

    def cdf(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            f"{type(self).__name__} has no closed-form cdf")

    def rvs(self, generator: torch.Generator, size=None) -> torch.Tensor:
        return self.sample(generator, () if size is None else (size,))

    def pmf(self, x: torch.Tensor) -> torch.Tensor:
        if not self.discrete:
            raise AttributeError("pmf is only defined for discrete RVs")
        return self.pdf(x)

    def get_config(self) -> dict:
        """The JAX package's canonical config: the name and every numeric
        attribute as the float of its float32 value (the JAX package
        holds them as float32), so one declaration gives one study
        digest in both packages."""
        cfg = {"name": type(self).__name__}
        cfg.update({k: float(np.float32(v)) for k, v in self.__dict__.items()
                    if isinstance(v, (int, float))
                    and k not in self._CONFIG_SKIP})
        return cfg

    #: numeric attributes that are not part of the JAX package's config
    _CONFIG_SKIP: tuple = ()

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

    def cdf(self, x):
        return torch.special.ndtr((x - self.loc) / self.scale)

    def ppf(self, q):
        return self.loc + self.scale * torch.special.ndtri(q)


class Uniform(RVBase):
    """Uniform on ``[loc, loc + scale]`` (scipy.stats.uniform convention)."""

    def __init__(self, loc=0.0, scale=1.0):
        self.loc = float(loc)
        self.scale = float(scale)

    def sample(self, generator, shape=()):
        return self.loc + self.scale * _rand(generator, shape)

    def log_pdf(self, x):
        inside = (x >= self.loc) & (x <= self.loc + self.scale)
        return torch.where(inside, _full(x, -math.log(self.scale)),
                           _full(x, -math.inf))

    def cdf(self, x):
        return ((x - self.loc) / self.scale).clamp(0.0, 1.0)

    def ppf(self, q):
        return self.loc + self.scale * q


class LogNorm(RVBase):
    """scipy.stats.lognorm(s, scale) convention: ``X = scale · exp(s·Z)``."""

    def __init__(self, s=1.0, scale=1.0):
        self.s = float(s)
        self.scale = float(scale)

    def sample(self, generator, shape=()):
        z = torch.randn(shape, generator=generator,
                        device=device_of(generator))
        return self.scale * torch.exp(self.s * z)

    def log_pdf(self, x):
        safe = torch.where(x > 0, x, torch.ones_like(x))
        logx = torch.log(safe / self.scale)
        val = (-(logx * logx) / (2.0 * self.s ** 2)
               - torch.log(safe * (self.s * math.sqrt(2.0 * math.pi))))
        return torch.where(x > 0, val, _full(x, -math.inf))

    def cdf(self, x):
        safe = torch.where(x > 0, x, torch.ones_like(x))
        val = torch.special.ndtr(torch.log(safe / self.scale) / self.s)
        return torch.where(x > 0, val, torch.zeros_like(val))


class Expon(RVBase):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc = float(loc)
        self.scale = float(scale)

    def sample(self, generator, shape=()):
        e = torch.empty(shape, device=device_of(generator)).exponential_(
            generator=generator)
        return self.loc + self.scale * e

    def log_pdf(self, x):
        z = (x - self.loc) / self.scale
        return torch.where(z >= 0, -z - math.log(self.scale),
                           _full(x, -math.inf))

    def cdf(self, x):
        z = (x - self.loc) / self.scale
        return torch.where(z > 0, 1.0 - torch.exp(-z.clamp(min=0.0)),
                           torch.zeros_like(z))


class Laplace(RVBase):
    """Laplace with location ``loc`` and scale ``scale``."""

    def __init__(self, loc=0.0, scale=1.0):
        self.loc = float(loc)
        self.scale = float(scale)

    def sample(self, generator, shape=()):
        # inverse cdf of u in (-1/2, 1/2): -sign(u) log(1 - 2|u|)
        u = _rand(generator, shape) - 0.5
        return self.loc - self.scale * torch.sign(u) * torch.log1p(
            -2.0 * u.abs())

    def log_pdf(self, x):
        return -(x - self.loc).abs() / self.scale - math.log(2.0 * self.scale)

    def cdf(self, x):
        z = (x - self.loc) / self.scale
        return torch.where(z < 0, 0.5 * torch.exp(z.clamp(max=0.0)),
                           1.0 - 0.5 * torch.exp(-z.clamp(min=0.0)))


class Cauchy(RVBase):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc = float(loc)
        self.scale = float(scale)

    def sample(self, generator, shape=()):
        c = torch.empty(shape, device=device_of(generator)).cauchy_(
            generator=generator)
        return self.loc + self.scale * c

    def log_pdf(self, x):
        z = (x - self.loc) / self.scale
        return -math.log(math.pi * self.scale) - torch.log1p(z * z)

    def cdf(self, x):
        return 0.5 + torch.atan((x - self.loc) / self.scale) / math.pi


class Gamma(RVBase):
    def __init__(self, a, scale=1.0):
        self.a = float(a)
        self.scale = float(scale)

    def sample(self, generator, shape=()):
        return self.scale * _standard_gamma(generator, self.a, shape)

    def log_pdf(self, x):
        y = x / self.scale
        val = (torch.special.xlogy(_full(x, self.a - 1.0), y) - y
               - math.lgamma(self.a) - math.log(self.scale))
        return torch.where(x < 0, _full(x, -math.inf), val)

    def cdf(self, x):
        return torch.special.gammainc(_full(x, self.a),
                                      x.clamp(min=0.0) / self.scale)


class Beta(RVBase):
    def __init__(self, a, b):
        self.a = float(a)
        self.b = float(b)

    def sample(self, generator, shape=()):
        ga = _standard_gamma(generator, self.a, shape)
        gb = _standard_gamma(generator, self.b, shape)
        return ga / (ga + gb)

    def log_pdf(self, x):
        lbeta = (math.lgamma(self.a) + math.lgamma(self.b)
                 - math.lgamma(self.a + self.b))
        val = (torch.special.xlogy(_full(x, self.a - 1.0), x)
               + torch.special.xlog1py(_full(x, self.b - 1.0), -x) - lbeta)
        return torch.where((x >= 0) & (x <= 1), val, _full(x, -math.inf))

    def cdf(self, x):
        return betainc(self.a, self.b, x.clamp(0.0, 1.0))


class Randint(RVBase):
    """Discrete uniform on ``{low, …, high-1}`` (scipy.stats.randint)."""

    discrete = True

    def __init__(self, low, high):
        self.low = int(low)
        self.high = int(high)

    def sample(self, generator, shape=()):
        return torch.randint(self.low, self.high, shape, generator=generator,
                             device=device_of(generator)).to(torch.float32)

    def log_pdf(self, x):
        ok = (x >= self.low) & (x < self.high) & (x == torch.round(x))
        return torch.where(ok, _full(x, -math.log(self.high - self.low)),
                           _full(x, -math.inf))

    def cdf(self, x):
        k = torch.floor(x)
        val = (k - self.low + 1.0) / (self.high - self.low)
        return val.clamp(0.0, 1.0)


class Poisson(RVBase):
    discrete = True

    def __init__(self, mu):
        self.mu = float(mu)

    def sample(self, generator, shape=()):
        rate = torch.full(shape, self.mu, device=device_of(generator))
        return torch.poisson(rate, generator=generator)

    def log_pdf(self, x):
        return x * math.log(self.mu) - self.mu - torch.lgamma(x + 1.0)

    def cdf(self, x):
        # P(X <= k) = Q(k + 1, mu), the upper regularized gamma
        k = torch.floor(x)
        val = torch.special.gammaincc(k.clamp(min=0.0) + 1.0,
                                      _full(x, self.mu))
        return torch.where(k < 0, torch.zeros_like(val), val)


class T(RVBase):
    """Student's t with ``df`` degrees of freedom (scipy.stats.t)."""

    def __init__(self, df, loc=0.0, scale=1.0):
        self.df = float(df)
        self.loc = float(loc)
        self.scale = float(scale)

    def sample(self, generator, shape=()):
        z = torch.randn(shape, generator=generator,
                        device=device_of(generator))
        g = _standard_gamma(generator, self.df / 2.0, shape)
        return self.loc + self.scale * z * torch.rsqrt(2.0 * g / self.df)

    def log_pdf(self, x):
        z = (x - self.loc) / self.scale
        nu = self.df
        const = (math.lgamma((nu + 1.0) / 2.0) - math.lgamma(nu / 2.0)
                 - 0.5 * math.log(nu * math.pi) - math.log(self.scale))
        return const - (nu + 1.0) / 2.0 * torch.log1p(z * z / nu)

    def cdf(self, x):
        # symmetric incomplete-beta form: F(t) = 1 − I_{ν/(ν+t²)}(ν/2, ½)/2
        z = (x - self.loc) / self.scale
        tail = 0.5 * betainc(self.df / 2.0, 0.5, self.df / (self.df + z * z))
        return torch.where(z >= 0, 1.0 - tail, tail)


class Chi2(RVBase):
    """Chi-squared with ``df`` degrees of freedom (scipy.stats.chi2)."""

    def __init__(self, df, loc=0.0, scale=1.0):
        self.df = float(df)
        self.loc = float(loc)
        self.scale = float(scale)

    def sample(self, generator, shape=()):
        return self.loc + self.scale * 2.0 * _standard_gamma(
            generator, self.df / 2.0, shape)

    def log_pdf(self, x):
        y = (x - self.loc) / self.scale
        k = self.df / 2.0
        val = (torch.special.xlogy(_full(x, k - 1.0), y) - y / 2.0
               - math.lgamma(k) - k * math.log(2.0) - math.log(self.scale))
        return torch.where(y < 0, _full(x, -math.inf), val)

    def cdf(self, x):
        z = (x - self.loc) / self.scale
        return torch.special.gammainc(_full(x, self.df / 2.0),
                                      z.clamp(min=0.0) / 2.0)


class WeibullMin(RVBase):
    """Weibull with shape ``c`` (scipy.stats.weibull_min convention)."""

    def __init__(self, c, loc=0.0, scale=1.0):
        self.c = float(c)
        self.loc = float(loc)
        self.scale = float(scale)

    def sample(self, generator, shape=()):
        # inverse cdf: X = scale·(−ln U)^{1/c}, U in [1e-7, 1)
        u = 1e-7 + (1.0 - 1e-7) * _rand(generator, shape)
        return self.loc + self.scale * (-torch.log(u)) ** (1.0 / self.c)

    def log_pdf(self, x):
        z = (x - self.loc) / self.scale
        safe = z.clamp(min=1e-38)
        val = (math.log(self.c / self.scale)
               + (self.c - 1.0) * torch.log(safe) - safe ** self.c)
        return torch.where(z > 0, val, _full(x, -math.inf))

    def cdf(self, x):
        z = ((x - self.loc) / self.scale).clamp(min=0.0)
        return 1.0 - torch.exp(-(z ** self.c))


class Binom(RVBase):
    """Binomial(n, p) (scipy.stats.binom)."""

    discrete = True

    def __init__(self, n, p):
        self.n = float(n)
        self.p = float(p)

    def sample(self, generator, shape=()):
        dev = device_of(generator)
        return torch.binomial(torch.full(shape, self.n, device=dev),
                              torch.full(shape, self.p, device=dev),
                              generator=generator)

    def log_pdf(self, x):
        k = torch.round(x)
        # xlogy / xlog1py: 0·log 0 = 0, so p in {0, 1} stays exact
        logp = (math.lgamma(self.n + 1.0) - torch.lgamma(k + 1.0)
                - torch.lgamma(self.n - k + 1.0)
                + torch.special.xlogy(k, _full(x, self.p))
                + torch.special.xlog1py(self.n - k, _full(x, -self.p)))
        ok = (x == k) & (k >= 0) & (k <= self.n)
        return torch.where(ok, logp, _full(x, -math.inf))

    def cdf(self, x):
        k = torch.floor(x).clamp(-1.0, self.n)
        # P(X <= k) = I_{1−p}(n − k, k + 1)
        val = betainc((self.n - k).clamp(min=1e-7), k + 1.0,
                      _full(x, 1.0 - self.p))
        val = torch.where(k >= self.n, torch.ones_like(val), val)
        return torch.where(k < 0, torch.zeros_like(val), val)


class Nbinom(RVBase):
    """Negative binomial (failures before the n-th success;
    scipy.stats.nbinom convention)."""

    discrete = True

    def __init__(self, n, p):
        self.n = float(n)
        self.p = float(p)

    def sample(self, generator, shape=()):
        # gamma–Poisson mixture: λ ~ Gamma(n, (1−p)/p), X ~ Poisson(λ)
        lam = (_standard_gamma(generator, self.n, shape)
               * (1.0 - self.p) / self.p)
        return torch.poisson(lam, generator=generator)

    def log_pdf(self, x):
        k = torch.round(x)
        logp = (torch.lgamma(k + self.n) - math.lgamma(self.n)
                - torch.lgamma(k + 1.0)
                + self.n * math.log(self.p)
                + torch.special.xlog1py(k, _full(x, -self.p)))
        ok = (x == k) & (k >= 0)
        return torch.where(ok, logp, _full(x, -math.inf))

    def cdf(self, x):
        k = torch.floor(x)
        # P(X <= k) = I_p(n, k + 1)
        val = betainc(self.n, k.clamp(min=0.0) + 1.0, _full(x, self.p))
        return torch.where(k < 0, torch.zeros_like(val), val)


class ScipyRV(RVBase):
    """Any ``scipy.stats`` distribution, evaluated on the host.

    The JAX package runs these through one batched host callback per
    compiled round.  Here ``sample`` draws one seed from the run's
    generator, samples the whole batch with numpy on the host
    (``numpy.random.default_rng(seed)``) and moves it to the generator's
    device once; ``log_pdf`` and ``cdf`` copy their argument to the host
    once, evaluate with scipy in float64 and copy the float32 result
    back.  One host round-trip per call, so once per round for a prior.
    """

    def __init__(self, name: str, *args, **kwargs):
        import scipy.stats as ss

        dist = getattr(ss, name, None)
        if dist is None or not hasattr(dist, "rvs"):
            raise ValueError(f"'{name}' is not a scipy.stats distribution")
        self.name = name
        self.args = args
        self.kwargs = kwargs
        self._frozen = dist(*args, **kwargs)
        self.discrete = not hasattr(self._frozen.dist, "pdf")

    def __reduce__(self):
        return (_rebuild_scipy, (self.name, self.args, self.kwargs))

    def sample(self, generator, shape=()):
        dev = device_of(generator)
        seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                                 device=dev))
        rng = np.random.default_rng(seed)
        out = self._frozen.rvs(size=tuple(shape) or (1,), random_state=rng)
        out = np.asarray(out, dtype=np.float32).reshape(shape)
        return torch.as_tensor(out, device=dev)

    def _host_eval(self, fn, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        with np.errstate(all="ignore"):
            out = fn(x.detach().cpu().numpy().astype(np.float64))
        return torch.as_tensor(np.asarray(out, dtype=np.float32),
                               device=x.device).reshape(x.shape)

    def log_pdf(self, x):
        f = self._frozen.logpmf if self.discrete else self._frozen.logpdf
        return self._host_eval(f, x)

    def cdf(self, x):
        return self._host_eval(self._frozen.cdf, x)

    def get_config(self) -> dict:
        return {"name": self.name, "args": list(map(float, self.args)),
                "kwargs": {k: float(v) for k, v in self.kwargs.items()}}


def _rebuild_scipy(name, args, kwargs):
    return ScipyRV(name, *args, **kwargs)


#: widest discrete support TabulatedRV will tabulate (f32 table = 4 MB)
_TABULATED_MAX_DISCRETE_SUPPORT = 1 << 20


class TabulatedRV(RVBase):
    """A table approximation of any ``scipy.stats`` distribution that
    samples and evaluates on the device.

    Built once on the host, as in the JAX package: for a continuous
    family a ``table_size``-point inverse-CDF table over the central
    ``1 − 2·tail_mass`` of the mass plus a log-pdf grid (renormalized
    for the cut tails), interpolated linearly; for a discrete family the
    pmf over the integer support between the ``tail_mass`` quantiles
    (the whole support when it is bounded), renormalized, sampled by
    inverting the cumulative table.  The tables move to a tensor's device
    on first use there.
    """

    def __init__(self, name: str, *args, table_size: int = 4096,
                 tail_mass: float = 1e-6, **kwargs):
        import scipy.stats as ss

        dist = getattr(ss, name, None)
        if dist is None or not hasattr(dist, "rvs"):
            raise ValueError(f"'{name}' is not a scipy.stats distribution")
        frozen = dist(*args, **kwargs)
        self.name, self.args, self.kwargs = name, args, kwargs
        self.table_size, self.tail_mass = int(table_size), float(tail_mass)
        self._discrete = not hasattr(frozen.dist, "pdf")
        self._tables: Dict[str, np.ndarray] = {}
        self._on: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        if self._discrete:
            self._build_discrete(frozen)
        else:
            self._build_continuous(frozen)

    def _build_continuous(self, frozen):
        tail_mass, table_size = self.tail_mass, self.table_size
        q = np.linspace(tail_mass, 1.0 - tail_mass, table_size)
        x_of_q = np.asarray(frozen.ppf(q), dtype=np.float64)
        grid = np.linspace(x_of_q[0], x_of_q[-1], table_size)
        with np.errstate(all="ignore"):
            logpdf = np.asarray(frozen.logpdf(grid), dtype=np.float64)
        logpdf -= np.log1p(-2.0 * tail_mass)
        self._tables = {
            "q": q.astype(np.float32), "x_of_q": x_of_q.astype(np.float32),
            "grid": grid.astype(np.float32),
            "logpdf": np.where(np.isfinite(logpdf), logpdf,
                               -1e30).astype(np.float32)}

    def _build_discrete(self, frozen):
        tail = self.tail_mass
        a, b = (float(v) for v in frozen.support())
        k_lo = a if np.isfinite(a) else float(np.asarray(frozen.ppf(tail)))
        k_hi = b if np.isfinite(b) else float(
            np.asarray(frozen.ppf(1.0 - tail)))
        if not (np.isfinite(k_lo) and np.isfinite(k_hi)):
            raise ValueError(
                f"'{self.name}': could not bound the discrete support "
                f"(quantiles at tail_mass={tail} are non-finite)")
        if int(k_hi - k_lo) + 1 > _TABULATED_MAX_DISCRETE_SUPPORT:
            k_lo = float(np.asarray(frozen.ppf(tail)))
            k_hi = float(np.asarray(frozen.ppf(1.0 - tail)))
        width = int(k_hi - k_lo) + 1
        if width > _TABULATED_MAX_DISCRETE_SUPPORT:
            raise ValueError(
                f"'{self.name}': discrete support of {width} points "
                f"exceeds the tabulation bound "
                f"({_TABULATED_MAX_DISCRETE_SUPPORT}); raise tail_mass")
        ks = np.arange(width, dtype=np.float64) + k_lo
        with np.errstate(all="ignore"):
            logpmf = np.asarray(frozen.logpmf(ks), dtype=np.float64)
        logpmf = np.where(np.isfinite(logpmf), logpmf, -np.inf)
        pmf = np.exp(logpmf)
        total = pmf.sum()
        if not (total > 0):
            raise ValueError(
                f"'{self.name}': pmf mass over the tabulated support is 0")
        self._k_lo, self._k_hi = float(k_lo), float(k_hi)
        self._tables = {
            "log_pmf": np.where(np.isfinite(logpmf), logpmf - np.log(total),
                                -1e30).astype(np.float32),
            "cum": np.cumsum(pmf / total).astype(np.float32)}

    @property
    def discrete(self) -> bool:
        return self._discrete

    def _t(self, device) -> Dict[str, torch.Tensor]:
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = {k: torch.as_tensor(v, device=device)
                                for k, v in self._tables.items()}
        return self._on[device]

    def __reduce__(self):
        return (_rebuild_tabulated,
                (self.name, self.args, self.table_size, self.tail_mass,
                 self.kwargs))

    def sample(self, generator, shape=()):
        tb = self._t(device_of(generator))
        u = _rand(generator, shape)
        if self._discrete:
            cum = tb["cum"]
            idx = torch.searchsorted(cum, u.contiguous())
            return self._k_lo + idx.clamp(0, cum.shape[0] - 1).to(
                torch.float32)
        u = self.tail_mass + (1.0 - 2.0 * self.tail_mass) * u
        return _interp(u, tb["q"], tb["x_of_q"])

    def log_pdf(self, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        tb = self._t(x.device)
        if self._discrete:
            k = torch.round(x)
            lp = tb["log_pmf"]
            idx = (k - self._k_lo).clamp(0, lp.shape[0] - 1).to(torch.int64)
            val = lp[idx]
            ok = (k >= self._k_lo) & (k <= self._k_hi) & (val > -1e29)
            return torch.where(ok, val, _full(x, -math.inf))
        grid = tb["grid"]
        inside = (x >= grid[0]) & (x <= grid[-1])
        val = _interp(x, grid, tb["logpdf"])
        return torch.where(inside & (val > -1e29), val, _full(x, -math.inf))

    def cdf(self, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        tb = self._t(x.device)
        if self._discrete:
            cum = tb["cum"]
            idx = torch.floor(x - self._k_lo).to(torch.int64)
            val = cum[idx.clamp(0, cum.shape[0] - 1)]
            val = torch.where(idx >= cum.shape[0], torch.ones_like(val), val)
            return torch.where(idx < 0, torch.zeros_like(val), val)
        raw = _interp(x, tb["x_of_q"], tb["q"], left=0.0, right=1.0)
        return raw.clamp(0.0, 1.0)

    def get_config(self) -> dict:
        return {"name": f"tabulated:{self.name}",
                "args": list(map(float, self.args)),
                "kwargs": {k: float(v) for k, v in self.kwargs.items()}}


def _rebuild_tabulated(name, args, table_size, tail_mass, kwargs):
    return TabulatedRV(name, *args, table_size=table_size,
                       tail_mass=tail_mass, **kwargs)


class RVDecorator(RVBase):
    """Base of the decorators around a component RV: delegates the RV
    surface to ``base``; subclasses override what they modify."""

    def __init__(self, base: RVBase):
        self.base = base

    @property
    def discrete(self) -> bool:
        return self.base.discrete

    def sample(self, generator, shape=()):
        return self.base.sample(generator, shape)

    def log_pdf(self, x):
        return self.base.log_pdf(x)

    def cdf(self, x):
        return self.base.cdf(x)

    def __repr__(self):
        return f"{type(self).__name__}({self.base!r})"


def _cdf_at(rv: RVBase, v: float) -> float:
    return float(rv.cdf(torch.tensor([v], dtype=torch.float32))[0])


class TruncatedRV(RVDecorator):
    """Truncate ``base`` to ``[lower, upper]`` with exact renormalization.

    Sampling is the JAX package's bounded rejection: a first draw, then
    up to ``max_iter`` passes that fill the rows still out of bounds from
    a fresh full-shape draw, and whatever is still out after them is
    clipped to the bounds.  The loop reads the device only after passes
    1, 2, 4, 8, … (whether every row is in bounds), never once per pass.
    The density is renormalized by ``cdf(upper) − cdf(lower)``.
    """

    _CONFIG_SKIP = ("_lo_cdf",)

    def __init__(self, base: RVBase, lower=-math.inf, upper=math.inf,
                 max_iter=100):
        self.base = base
        self.lower = float(lower)
        self.upper = float(upper)
        self.max_iter = int(max_iter)
        lo_cdf = (_cdf_at(base, self.lower) if math.isfinite(self.lower)
                  else 0.0)
        hi_cdf = (_cdf_at(base, self.upper) if math.isfinite(self.upper)
                  else 1.0)
        self._log_z = float(np.log(np.float32(hi_cdf - lo_cdf)))
        self._lo_cdf = lo_cdf

    def _inside(self, x):
        return (x >= self.lower) & (x <= self.upper)

    def sample(self, generator, shape=()):
        x = self.base.sample(generator, shape)
        ok = self._inside(x)
        check = 1
        for i in range(1, self.max_iter + 1):
            if i == check:
                if bool(ok.all()):
                    break
                check *= 2
            cand = self.base.sample(generator, shape)
            good = self._inside(cand)
            x = torch.where(ok, x, torch.where(good, cand, x))
            ok = ok | good
        return torch.where(ok, x, x.clamp(self.lower, self.upper))

    def log_pdf(self, x):
        return torch.where(self._inside(x), self.base.log_pdf(x) - self._log_z,
                           _full(x, -math.inf))

    def cdf(self, x):
        raw = (self.base.cdf(x) - self._lo_cdf) / math.exp(self._log_z)
        return raw.clamp(0.0, 1.0)


def LowerBoundDecorator(rv: RVBase, lower: float) -> TruncatedRV:
    """Reference-compatible alias: ``rv`` truncated below at ``lower``."""
    return TruncatedRV(rv, lower=lower)


_NAME_MAP = {
    "norm": Norm, "uniform": Uniform, "lognorm": LogNorm, "expon": Expon,
    "laplace": Laplace, "cauchy": Cauchy, "gamma": Gamma, "beta": Beta,
    "randint": Randint, "poisson": Poisson, "t": T, "chi2": Chi2,
    "weibull_min": WeibullMin, "binom": Binom, "nbinom": Nbinom,
}


def RV(name: Union[str, RVBase], *args, **kwargs) -> RVBase:
    """Factory with reference API parity: ``RV("norm", 0, 1)``.  The
    native families resolve to the classes above; any other
    ``scipy.stats`` name to :class:`ScipyRV` (host-evaluated)."""
    if isinstance(name, RVBase):
        return name
    cls = _NAME_MAP.get(name)
    if cls is not None:
        return cls(*args, **kwargs)
    try:
        return ScipyRV(name, *args, **kwargs)
    except ValueError:
        raise ValueError(
            f"unknown RV '{name}': not a native family "
            f"({sorted(_NAME_MAP)}) nor a scipy.stats distribution"
        ) from None


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

    @classmethod
    def from_dictionary_of_dictionaries(cls, dict_of_dicts: Mapping
                                        ) -> "Distribution":
        """``{name: {"type": ..., "args": [...], "kwargs": {...}}}``."""
        return cls({key: RV(spec["type"], *spec.get("args", ()),
                            **spec.get("kwargs", {}))
                    for key, spec in dict_of_dicts.items()})

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

    # ---- the reference's scalar API -------------------------------------

    def rvs(self, generator: Optional[torch.Generator] = None) -> Parameter:
        """One draw as a :class:`Parameter`; without a generator, from a
        CPU generator seeded 0 (the JAX package draws from
        ``PRNGKey(0)``)."""
        if generator is None:
            generator = make_generator(torch.device("cpu"), 0)
        return self.space.array_to_dict(
            self.rvs_array(generator).cpu().numpy())

    def pdf(self, x: Mapping[str, float]) -> float:
        """The joint density at one named point, on the CPU."""
        theta = torch.tensor([float(x[n]) for n in self.space.names],
                             dtype=torch.float32)
        return float(torch.exp(self.log_pdf_array(theta)))


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

    def pmf(self, m_new, m_old) -> torch.Tensor:
        """``exp(log_pmf)`` of model indices given as ints, arrays or
        tensors."""
        return torch.exp(self.log_pmf(torch.as_tensor(m_new),
                                      torch.as_tensor(m_old)))
