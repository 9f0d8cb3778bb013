"""The accept step: every particle of every generation lies within its
generation's ε, compared in float32, the precision the port accepts in.
An exact comparison: its limit is 0 particles."""

from __future__ import annotations

import numpy as np


def compare(out: dict, cfg: dict, seed: int, device, control=None) -> dict:
    over = 0
    for g in out["generations"]:
        d = g["distance"].astype(np.float32)
        over += int(np.count_nonzero(~(d <= np.float32(g["eps"]))))
    return {"accept_over": (over, cfg["checks"]["accept"]["limit"])}
