"""Builder of the ABC-SMC configurations: one inference as a user's
script makes it, through the port's public entry points.

A configuration file names a problem factory of
``pyabc_tpu_torch.models`` with its arguments, the generations, the
settings of ``ABCSMC`` and of ``VectorizedSampler`` that it pins, and the
priors and gates its checks read.  A traffic mix adds the population and
the engine's settings.
"""

from __future__ import annotations

import numpy as np

from timeline import rounds


def new_inference(cfg: dict, mix: dict, seed: int, device: str):
    """A fresh ``ABCSMC`` with a fresh ``VectorizedSampler``, after
    ``new("sqlite://", observed)``; ``run(max_nr_populations=G)`` is
    the caller's."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch import models as pt_models

    made = getattr(pt_models, cfg["factory"])(**cfg.get("factory_kwargs", {}))
    models, priors, distance, observed = made[:4]
    sampler = pt.VectorizedSampler(device=device, **cfg["sampler"],
                                   **mix.get("sampler", {}))
    abc = pt.ABCSMC(models, priors, distance,
                    population_size=int(mix["population_size"]),
                    eps=pt.MedianEpsilon(), sampler=sampler, seed=seed,
                    device=device, **cfg["abc"], **mix.get("abc", {}))
    abc.new(cfg["history_db"], observed)
    return abc


def summary(abc) -> dict:
    """What must repeat exactly between inferences of one seed."""
    rows = abc.timeline
    return {"generations": len(rows),
            "evaluations": int(sum(r["evaluations"] for r in rows)),
            "rounds": int(sum(rounds(r) for r in rows)),
            "paths": "".join(r["path"][0] for r in rows),
            "final_eps": float(rows[-1]["eps"]) if rows else None}


def outputs(abc) -> dict:
    """The inference's results as host arrays, for the checks: every
    generation's population from the History (models, parameters,
    weights, distances), its ε and model probabilities, and the path
    the timeline says the generation took."""
    h = abc.history
    pops = h.get_all_populations()
    eps = {int(t): float(e) for t, e in zip(pops["t"], pops["epsilon"])}
    probs = h.get_model_probabilities()
    paths = {int(r["t"]): r["path"] for r in abc.timeline}
    gens = []
    for t in range(int(h.max_t) + 1):
        p = h.get_population(t)
        gens.append({
            "t": t, "eps": eps[t], "path": paths.get(t),
            "m": np.asarray(p.m, np.int64),
            "theta": np.asarray(p.theta, np.float32),
            "weight": np.asarray(p.weight, np.float32),
            "distance": np.asarray(p.distance, np.float32),
            "p_model": {int(m): float(probs.loc[t, m])
                        for m in probs.columns}})
    return {"generations": gens, "n_models": len(abc.models)}
