"""``sampler`` layer: milliseconds a round from one count read's return
to the next read's start (``RoundClock``'s ``round_host_s``: the replay
launch and the loop's Python, while the card holds no queued round):
summed over the window rows that carry it, those of the profiled
inference left out, over their rounds.  Silent where no such row is
left."""

from clocks import clock_ms_per_round


def read(ctx: dict):
    return clock_ms_per_round(ctx, "round_host_s")
