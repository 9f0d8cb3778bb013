"""``sampler`` layer: milliseconds a round the host is blocked in the
read of the round's count (``RoundClock``'s ``count_wait_s``): summed
over the window rows that carry it, those of the profiled inference left
out, over their rounds.  Silent where no such row is left."""

from clocks import clock_ms_per_round


def read(ctx: dict):
    return clock_ms_per_round(ctx, "count_wait_s")
