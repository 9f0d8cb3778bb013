"""``storage`` layer: milliseconds a generation of the History append
(PTW1 pack and CRC) on the caller's path: the rows' ``append_s`` summed
over the window's inferences, over their generations.  Silent where no
row times an append."""

from timeline import rows


def read(ctx: dict):
    rs = [r for r in rows(ctx) if r.get("append_s") is not None]
    if not rs:
        return None
    return 1e3 * sum(r["append_s"] for r in rs) / len(rs)
