"""The device: the share of the profiled inference in which no kernel,
copy or fill ran on the card, in %: 1 less the union of the device
intervals over the traced span."""


def read(ctx: dict):
    tr = ctx["trace"]
    if not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
