"""``distance`` layer: milliseconds a generation of the adaptive
distance's refit (the span ``distance.refit``: the fit of the distance's
params from the previous generation's statistics and the population's
distances under them; the rows' ``distance_s``), over the window rows
that carry it.  Silent where no row does: a distance that does not
adapt has no refit."""

from timeline import rows


def read(ctx: dict):
    rs = [r for r in rows(ctx) if r.get("distance_s") is not None]
    if not rs:
        return None
    return 1e3 * sum(r["distance_s"] for r in rs) / len(rs)
