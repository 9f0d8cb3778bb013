"""The gate of configs #3 and #4, which have no closed form: after the
last generation each parameter's weighted mean lies within ``z_max``
posterior std of the generating value, and each posterior std is at most
``std_ratio`` of the prior's (the uniform's width over sqrt 12)."""

from __future__ import annotations

import math

import numpy as np


def compare(out: dict, cfg: dict, seed: int, device, control=None) -> dict:
    lim = cfg["checks"]["posterior_gate"]
    last = out["generations"][-1]
    box = cfg["prior_boxes"][0]
    x = last["theta"][:, :len(box)].astype(np.float64)
    w = last["weight"].astype(np.float64)
    w = w / w.sum()
    mean = w @ x
    std = np.sqrt(w @ (x - mean) ** 2)
    truth = np.log(np.asarray(cfg["truth"], np.float64))
    z = float(np.max(np.abs(mean - truth) / std))
    ratio = float(np.max(std / (np.array([b[1] for b in box])
                                / math.sqrt(12.0))))
    return {"z_max": (z if math.isfinite(z) else float("inf"),
                      lim["z_max"]),
            "std_ratio": (ratio if math.isfinite(ratio) else float("inf"),
                          lim["std_ratio"])}
