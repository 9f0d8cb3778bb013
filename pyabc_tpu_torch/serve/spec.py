"""Study specs and their content-address digests.

Port of ``pyabc_tpu/serve/spec.py`` (host code).  A *study* is the
serving tier's unit of work: one ABC-SMC inference problem (prior, model,
distance, eps config, observed data) plus its run budget and tenant.
The canonical serving shape is the quickstart study: a batched torch
simulator ``model(generator, theta[N, d]) -> {stat: [N, k]}``, an
independent-RV :class:`~pyabc_tpu_torch.Distribution` prior, a p-norm
distance and a quantile epsilon schedule — served by the warm solo
one-dispatch engine (:meth:`ABCSMC.renew`) or the study axis
(:mod:`.multiplex`).

Two digests, over deliberately different sets:

- :func:`study_digest` hashes everything that can change the posterior
  (model, prior, distance, eps config, observed data, budgets, seed).
  It addresses the result per serving engine: the worker keys its cache
  by ``(study_digest, engine)`` and routes each spec to one engine from
  its content alone (``multiplex.lane_eligible``).
- :func:`problem_key` hashes only what the built engine depends on
  (model, prior, distance, eps mode, observed data, population size):
  the warm-engine pool's key.  Studies that differ only in seed,
  ``minimum_epsilon`` or ``max_generations`` share a warm engine.

The hashed canonical form is the JAX package's: the model's source
text, the prior's ``get_config()`` list (the port's RVs give the JAX
package's float32-valued configs), the observed values as float64 lists
and the carry-precision policy, so one declaration hashes the same in
both packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
from typing import Callable, Dict, Optional

import numpy as np

#: digest schema version — bump when the hashed canonical form changes
#: (a stale persisted cache entry must miss, not alias)
DIGEST_VERSION = 2


@dataclasses.dataclass
class StudySpec:
    """One study submission.

    ``model`` is the quickstart-shaped batched simulator ``(generator,
    theta[N, d]) -> {stat: [N, k]}``; ``observed`` the observed
    summary-stat dict; ``prior`` an independent-RV ``Distribution``.
    ``distance_p`` and ``alpha`` are the canonical serving forms of the
    distance (p-norm) and eps schedule (quantile); ``seed`` isolates
    replicate chains.  ``tenant`` and ``priority`` drive admission
    (queue quotas, ordering); neither changes the result, so neither is
    part of the digest.
    """

    model: Callable
    prior: object                      # pyabc_tpu_torch.Distribution
    observed: Dict
    population_size: int
    distance_p: float = 2.0
    alpha: float = 0.5                 # quantile eps schedule
    minimum_epsilon: float = 0.0
    max_generations: int = 8
    min_acceptance_rate: float = 0.0
    seed: int = 0
    #: multi-fidelity screening mode: ``"off"`` (exact unscreened
    #: program) or ``"screen"`` (fidelity/config.py) — digest-bearing in
    #: BOTH digests: screening changes the traced program AND the
    #: accepted sample, so a screened study must never alias an
    #: unscreened one in any cache
    fidelity: str = "off"
    tenant: str = "default"
    priority: int = 0
    name: Optional[str] = None

    def __post_init__(self):
        if self.fidelity not in ("off", "screen"):
            raise ValueError(f"fidelity must be 'off' or 'screen' "
                             f"(got {self.fidelity!r})")


def _callable_fingerprint(fn: Callable) -> str:
    """Stable identity for a model callable: its source when available
    (same code ⇒ same study, across processes), else its qualified
    name.  ``id()`` is deliberately never used — a restarted worker
    must re-hit its persisted cache."""
    try:
        return inspect.getsource(fn)
    except (OSError, TypeError):
        return f"{getattr(fn, '__module__', '?')}." \
               f"{getattr(fn, '__qualname__', repr(fn))}"


def _prior_config(prior) -> list:
    """Canonical (name, rv-config) list in the prior's declared
    parameter order (the order defines the theta axis)."""
    out = []
    for pname in prior.get_parameter_names():
        rv = prior[pname]
        try:
            cfg = rv.get_config()
        except Exception:
            cfg = {"repr": repr(rv)}
        out.append([pname, cfg])
    return out


def _observed_canonical(observed: Dict) -> list:
    """Sorted-key, value-exact encoding of the observed stats (the
    same canonical stat order the multiplexer flattens with)."""
    return [[k, np.asarray(observed[k], dtype=np.float64).tolist()]
            for k in sorted(observed)]


def _carry_policy() -> str:
    """The at-rest carry-precision POLICY string (including "auto" —
    the planner's resolution depends on the local HBM budget, but the
    policy itself is what the submitter controls and what must key the
    caches)."""
    from ..ops.precision import resolve_carry_precision
    return resolve_carry_precision()


def _digest_of(parts: dict) -> str:
    blob = json.dumps(parts, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def study_digest(spec: StudySpec) -> str:
    """Content address of the study RESULT: every field that can move
    the posterior participates; tenant/priority/name do not.  Bitwise
    reproducibility is per engine — the worker pairs this digest with
    the engine the spec content routes to (module docstring)."""
    return _digest_of({
        "v": DIGEST_VERSION,
        "model": _callable_fingerprint(spec.model),
        "prior": _prior_config(spec.prior),
        "distance_p": float(spec.distance_p),
        "alpha": float(spec.alpha),
        "observed": _observed_canonical(spec.observed),
        "population_size": int(spec.population_size),
        "minimum_epsilon": float(spec.minimum_epsilon),
        "max_generations": int(spec.max_generations),
        "min_acceptance_rate": float(spec.min_acceptance_rate),
        "seed": int(spec.seed),
        "fidelity": str(spec.fidelity),
        # the at-rest carry policy (ops/precision.py): bf16/int8 change
        # the sampled chain (bounded per-generation rounding), so a
        # compressed study must never alias an exact one
        "carry_precision": _carry_policy(),
    })


def problem_key(spec: StudySpec) -> str:
    """Warm-engine pool key: what the compiled program depends on.
    Seed and stop budgets are traced control operands, so studies
    differing only there share one warm engine — the zero-recompile
    contract the serve worker tests pin."""
    return _digest_of({
        "v": DIGEST_VERSION,
        "model": _callable_fingerprint(spec.model),
        "prior": _prior_config(spec.prior),
        "distance_p": float(spec.distance_p),
        "alpha": float(spec.alpha),
        "observed": _observed_canonical(spec.observed),
        "population_size": int(spec.population_size),
        "min_acceptance_rate": float(spec.min_acceptance_rate),
        "fidelity": str(spec.fidelity),
        # digest-bearing in the ENGINE key too: the codec is traced
        # into the program (decode/encode at every generation boundary)
        "carry_precision": _carry_policy(),
    })
