"""Config #2's posterior against its closed form (``reference/mixture.py``)
at ``run_gate``'s tolerances, the configuration's own limits: model B's
probability and its posterior mean of mu, which is 1 at y = 1 by
symmetry.  Each limit is ``max(floor, scale / sqrt(pop))``
(``tools/verify_northstar_posterior.py:91-93`` of the JAX package)."""

from __future__ import annotations

import numpy as np

from reference import mixture


def compare(out: dict, cfg: dict, seed: int, device, control=None) -> dict:
    lim = cfg["checks"]["two_gaussians"]
    k = cfg["factory_kwargs"]
    last = out["generations"][-1]
    want = mixture.p_model_b(k["y_observed"], k["mu_a"], k["mu_b"],
                             k["prior_width"], k["sigma"])
    b = last["m"] == 1
    w = last["weight"][b].astype(np.float64)
    mu = float(np.sum(w * last["theta"][b, 0]) / np.sum(w)) if b.any() \
        else float("nan")
    gap_p = abs(last["p_model"].get(1, 0.0) - want)
    gap_mu = abs(mu - lim["mu_b"])
    pop = last["m"].shape[0]
    return {"p_b_gap": (gap_p if np.isfinite(gap_p) else float("inf"),
                        max(lim["p_b_floor"], lim["p_b_scale"] / pop ** 0.5)),
            "mu_b_gap": (gap_mu if np.isfinite(gap_mu) else float("inf"),
                         max(lim["mu_b_floor"],
                             lim["mu_b_scale"] / pop ** 0.5))}
