"""``smc`` layer: milliseconds a generation of ``ABCSMC.run``'s host loop
(epsilon, transition and distance refits, the engine drivers): each
timeline row's wall less its sampling and its History append, summed
over the window's inferences, over their generations."""

from timeline import rows


def read(ctx: dict):
    rs = rows(ctx)
    if not rs:
        return None
    host = sum(r["wall_s"] - r.get("sample_s", 0.0) - r.get("append_s", 0.0)
               for r in rs)
    return 1e3 * host / len(rs)
