"""``sampler`` layer: milliseconds a round of the ``propose`` phase (the
resampling CDF, the model jump, the transition draw and the prior): the
card's wall time between the phase's timing events, which the round
marks while the tracer is on, under the profiler (the gaps between a
graph's kernels included): the profiled inference's rows'
``phase_device_s["propose"]`` over their ``phase_rounds``.  Silent where
no row carries phase readings."""

from clocks import phase_ms_per_round


def read(ctx: dict):
    return phase_ms_per_round(ctx, "propose")
