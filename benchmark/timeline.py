"""Arithmetic over ``ABCSMC.timeline`` rows that the builders and the
metric readers share."""

from __future__ import annotations


def rows(ctx: dict) -> list:
    return [r for tl in ctx["timelines"] for r in tl]


def rounds(row: dict) -> int:
    """Sampler rounds of a row: a device engine's rows count them (a
    list for a block's generations); a sequential row's follow from its
    evaluations at its pinned batch."""
    r = row.get("rounds")
    if r is None:
        return int(row["evaluations"]) // int(row["batch"])
    return int(sum(r)) if isinstance(r, (list, tuple)) else int(r)
