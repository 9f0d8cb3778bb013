"""The importance weights, whose proposal density is K1.

For every generation t >= 1 that the port ran sequentially (its
proposal fitted on the host from every particle of t - 1), a sample of
its particles drawn from the seed gets its weight worked out again by
the plain reference (``reference/weights.py``).  The number compared is
the widest gap, over the sample, between the port's log weight and the
reference's, after taking out their median difference (weights are
known up to a constant).

A generation of a device block drew its proposal's support from
generation t - 1 by a systematic resample on one uniform of the run's
generator; the reference cannot rebuild that support, and its nearest
stand-in (every particle as support, the bandwidth of the resampled
rows) differs from it by the resample's own noise, which is as large as
the control's gap.  Those generations are left to ``accept`` and to the
configuration's posterior check.

``control`` names a dtype: the reference's own weights computed in it
take the port's place (the control of the check).
"""

from __future__ import annotations

import numpy as np

from reference import weights as ref


def compare(out: dict, cfg: dict, seed: int, device, control=None) -> dict:
    lim = cfg["checks"]["weights"]
    priors = cfg["prior_boxes"]
    gens = out["generations"]
    rng = np.random.default_rng(seed)
    gaps = []
    for prev, cur in zip(gens, gens[1:]):
        if cur["path"] != "sequential":
            continue
        n = cur["m"].shape[0]
        idx = np.sort(rng.choice(n, size=min(int(lim["rows"]), n),
                                 replace=False))
        want = ref.log_weights(prev, cur, idx, priors, cfg["p_stay"],
                               device)
        if control is None:
            with np.errstate(divide="ignore"):
                got = np.log(cur["weight"][idx].astype(np.float64))
        else:
            got = ref.log_weights(prev, cur, idx, priors, cfg["p_stay"],
                                  device, dtype=control)
        diff = got - want
        finite = np.isfinite(diff)
        gaps.append(float(np.max(np.abs(diff - np.median(diff[finite]))))
                    if finite.all() else float("inf"))
    return {"weight_gap": (max(gaps), lim["weight_gap"])} if gaps else {}
