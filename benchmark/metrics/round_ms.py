"""``sampler`` layer: milliseconds a sampler round, the rows' sampling
seconds over their rounds, over the window's inferences."""

from timeline import rounds, rows


def read(ctx: dict):
    rs = rows(ctx)
    n = sum(rounds(r) for r in rs)
    if not n:
        return None
    return 1e3 * sum(r["sample_s"] for r in rs) / n
