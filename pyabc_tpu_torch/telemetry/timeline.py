"""Per-run generation timeline: where each generation's wall time went.

Port of ``pyabc_tpu/telemetry/timeline.py``.  The orchestrator calls
:meth:`GenerationTimeline.record` once per completed generation (any run
path) with the stage durations it measured.  The named stages are the
pipeline's physical phases — ``adapt`` (epsilon/transition refit),
``dispatch`` (the host loop that queues the device rounds), ``compute``
(the fetch's wait on its producer, from the wire ledger), ``fetch``
(d2h), ``decode`` (host decode), ``append`` (History write).  Whatever
the named stages don't cover lands in ``other`` so stage-sum == wall by
construction; in the overlapped paths stages run concurrently with the
caller's wall, so ``other`` is clamped at zero and the ``overlap_s``
column carries the attribution instead.

The port's timeline is also the list of the orchestrator's own rows
(``ABCSMC.timeline[i]``: ``t``, ``path``, ``eps``, ``rounds``,
``host_reads``, ``kde_launches`` ... — the keys ``smc.ABCSMC`` lists),
one per generation, beside the stage table that :meth:`to_rows`,
:meth:`summary` and :meth:`render_ascii` read.

Renders two ways: :meth:`render_ascii` for logs, :meth:`to_rows` for
bench JSON (plus :meth:`summary` medians for the compact line).
"""

from __future__ import annotations

import threading
from typing import Optional

STAGES = ("adapt", "dispatch", "compute", "fetch", "decode", "append")


def _median(vals: list) -> float:
    vals = sorted(vals)
    n = len(vals)
    mid = vals[n // 2] if n % 2 else (vals[n // 2 - 1] + vals[n // 2]) / 2
    return round(mid, 6)


class GenerationTimeline(list):
    """The orchestrator's per-generation rows (the list) and a bounded
    table of per-generation stage durations (:meth:`record`)."""

    def __init__(self, max_rows: int = 4096):
        super().__init__()
        self._rows: list = []
        self._max_rows = max_rows
        self._lock = threading.Lock()
        #: the run's History egress discipline ("lazy" | "eager")
        self.history_mode: Optional[str] = None
        #: why the run stopped (the orchestrator's stop string); None
        #: while running or when the run exhausted max_nr_populations
        self.stop_reason: Optional[str] = None
        #: the last capacity plan (capacity/model.py): engine, precision,
        #: batch, K, max_T, devices, predicted_bytes, budget_bytes, note
        #: (+ measured_bytes after a measured dispatch); None before the
        #: first device engine
        self.capacity: Optional[dict] = None

    def record(self, t: int, *, path: str, wall_s: float,
               stages: Optional[dict] = None, eps: Optional[float] = None,
               accepted: Optional[int] = None, total: Optional[int] = None,
               overlap_s: float = 0.0, compile_s: float = 0.0,
               n_compiles: int = 0, engine: Optional[str] = None,
               phases: Optional[dict] = None):
        """Add one generation's stage row.  ``stages`` maps a subset of
        :data:`STAGES` to seconds; unknown keys raise so a typo can't
        silently vanish from the table.  ``compile_s``/``n_compiles``
        are the program builds booked since the previous row (the
        registry's ``xla_compile_seconds_total`` / ``xla_compiles_total``
        delta: ``autotune.ladder.record_build`` counts each engine
        build and each CUDA-graph capture), attribution columns that
        are not folded into the stage sum.  ``phases``
        maps a subset of ``telemetry.lanes.PHASES`` to seconds from the
        device telemetry lanes — stored as ``ph_<name>_s`` attribution
        columns, never folded into the stage sum."""
        stages = dict(stages or {})
        unknown = set(stages) - set(STAGES)
        if unknown:
            raise KeyError(f"unknown timeline stages: {sorted(unknown)}")
        if phases:
            from .lanes import PHASES
            unknown = set(phases) - set(PHASES)
            if unknown:
                raise KeyError(
                    f"unknown timeline phases: {sorted(unknown)}")
        row = {"gen": int(t), "path": path, "wall_s": round(wall_s, 6)}
        named = 0.0
        for s in STAGES:
            v = float(stages.get(s, 0.0))
            row[s + "_s"] = round(v, 6)
            named += v
        row["other_s"] = round(max(0.0, wall_s - named), 6)
        row["overlap_s"] = round(overlap_s, 6)
        row["overlap_frac"] = (round(overlap_s / wall_s, 4)
                               if wall_s > 1e-9 else 0.0)
        row["compile_s"] = round(compile_s, 6)
        row["n_compiles"] = int(n_compiles)
        row["eps"] = None if eps is None else float(eps)
        row["accepted"] = None if accepted is None else int(accepted)
        row["total"] = None if total is None else int(total)
        row["engine"] = engine
        if phases:
            for name, v in phases.items():
                row["ph_" + name + "_s"] = round(float(v), 6)
        with self._lock:
            if len(self._rows) < self._max_rows:
                self._rows.append(row)

    def to_rows(self) -> list:
        with self._lock:
            return [dict(r) for r in self._rows]

    def clear(self):
        super().clear()
        with self._lock:
            self._rows = []

    def summary(self) -> dict:
        """Medians across generations — the compact-bench-line scalars."""
        rows = self.to_rows()
        if not rows:
            return {}
        engine = None
        for r in rows:
            if r.get("engine") is not None:
                engine = r["engine"]
        out = {
            "generations": len(rows),
            "wall_s_med": _median([r["wall_s"] for r in rows]),
            "compute_s_med": _median([r["compute_s"] for r in rows]),
            "fetch_s_med": _median([r["fetch_s"] for r in rows]),
            "decode_s_med": _median([r["decode_s"] for r in rows]),
            "overlap_frac_med": _median([r["overlap_frac"] for r in rows]),
            "compile_s_med": _median([r["compile_s"] for r in rows]),
            "n_compiles_total": int(sum(r["n_compiles"] for r in rows)),
            "engine_decision": engine,
            "history_mode": self.history_mode,
            "stop_reason": self.stop_reason,
        }
        if self.capacity is not None:
            cap = self.capacity
            out["capacity_precision"] = cap.get("precision")
            out["capacity_predicted_mb"] = round(
                cap.get("predicted_bytes", 0) / 2**20, 3)
            out["capacity_budget_mb"] = round(
                cap.get("budget_bytes", 0) / 2**20, 3)
            if cap.get("measured_bytes"):
                out["capacity_measured_mb"] = round(
                    cap["measured_bytes"] / 2**20, 3)
        # per-phase medians over the rows that carry lane attribution
        ph_keys = sorted({k for r in rows for k in r
                          if k.startswith("ph_") and k.endswith("_s")})
        for key in ph_keys:
            out[key + "_med"] = _median([r[key] for r in rows if key in r])
        return out

    def render_ascii(self) -> str:
        """Fixed-width table for logs; one line per generation."""
        rows = self.to_rows()
        if not rows:
            return "(timeline: no generations recorded)"
        cols = (["gen", "path", "wall_s"] + [s + "_s" for s in STAGES]
                + ["other_s", "overlap_s", "compile_s", "eps",
                   "acc/total"])
        table = []
        for r in rows:
            acc = ("-" if r["accepted"] is None
                   else f"{r['accepted']}/{r['total']}")
            eps = "-" if r["eps"] is None else f"{r['eps']:.4g}"
            table.append([str(r["gen"]), r["path"], f"{r['wall_s']:.3f}"]
                         + [f"{r[s + '_s']:.3f}" for s in STAGES]
                         + [f"{r['other_s']:.3f}", f"{r['overlap_s']:.3f}",
                            f"{r.get('compile_s', 0.0):.3f}", eps, acc])
        widths = [max(len(cols[i]), max(len(row[i]) for row in table))
                  for i in range(len(cols))]
        fmt = "  ".join("{:>%d}" % w for w in widths)
        lines = [fmt.format(*cols)]
        lines += [fmt.format(*row) for row in table]
        return "\n".join(lines)
