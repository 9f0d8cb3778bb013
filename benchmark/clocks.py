"""Arithmetic over the timeline rows' round clocks
(``pyabc_tpu_torch.telemetry.phases.RoundClock``) that the readers of
``propose_ms_per_round``, ``simulate_ms_per_round``,
``count_wait_ms_per_round`` and ``round_host_ms_per_round`` share."""

from timeline import rounds, rows


def phase_ms_per_round(ctx: dict, phase: str):
    """Σ ``phase_device_s[phase]`` / Σ ``phase_rounds`` over the profiled
    inference's rows, in ms: the card's wall time between the phase's
    marks under the profiler (the gaps between a graph's kernels
    included); None where no row carries the phase."""
    rs = [r for r in (ctx.get("trace") or {}).get("profiled_rows") or ()
          if phase in (r.get("phase_device_s") or {})
          and r.get("phase_rounds")]
    n = sum(int(r["phase_rounds"]) for r in rs)
    if not n:
        return None
    return 1e3 * sum(r["phase_device_s"][phase] for r in rs) / n


def clock_ms_per_round(ctx: dict, key: str):
    """Σ ``key`` / Σ rounds over the window rows that carry ``key``,
    those of the profiled inference left out (the profiler slows each
    launch of a graph's nodes), in ms; None where no other row does."""
    profiled = {id(r) for r in
                (ctx.get("trace") or {}).get("profiled_rows") or ()}
    rs = [r for r in rows(ctx)
          if r.get(key) is not None and id(r) not in profiled]
    n = sum(rounds(r) for r in rs)
    if not n:
        return None
    return 1e3 * sum(r[key] for r in rs) / n
