"""``models`` layer: milliseconds a round of the ``simulate`` phase
(every model's simulator on the round's batch): the card's wall time
between the phase's timing events, which the round marks while the
tracer is on, under the profiler (the gaps between a graph's kernels
included): the profiled inference's rows' ``phase_device_s["simulate"]``
over their ``phase_rounds``.  Silent where no row carries phase
readings."""

from clocks import phase_ms_per_round


def read(ctx: dict):
    return phase_ms_per_round(ctx, "simulate")
