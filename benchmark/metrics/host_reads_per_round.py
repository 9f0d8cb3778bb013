"""``sampler`` layer: the host reads of the round loop a round, over the
rows that count them (a device engine's).  Silent where no row does."""

from timeline import rounds, rows


def read(ctx: dict):
    rs = [r for r in rows(ctx) if r.get("host_reads") is not None]
    n = sum(rounds(r) for r in rs)
    if not n:
        return None
    return sum(r["host_reads"] for r in rs) / n
