"""``storage`` layer: milliseconds a generation of the History's PTW1
pack and CRC of the generation's blobs (the rows' ``pack_s``, on
whichever thread they ran), over the window rows that carry it.  Silent
where no row does."""

from timeline import rows


def read(ctx: dict):
    rs = [r for r in rows(ctx) if r.get("pack_s") is not None]
    if not rs:
        return None
    return 1e3 * sum(r["pack_s"] for r in rs) / len(rs)
