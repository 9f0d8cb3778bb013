"""Device telemetry lanes and the one-dispatch progress word.

Port of the device half of ``pyabc_tpu/telemetry/lanes.py``.  A
``run_mode="onedispatch"`` run is one call that writes many generations,
so the host-side stack (spans, the timeline) sees it as one opaque span.
This module is the in-dispatch half, in two parts:

**Telemetry lanes** (``tl_*`` wire lanes).  :func:`phase_wire_lanes` is
called by the fused per-generation body after its rejection loop: it
emits per-generation work counters — simulations, and a per-phase
work-unit vector over :data:`PHASES` — as extra wire lanes in the same
slot buffers as the population wire.  Every lane is tensor arithmetic
on the generation's device ``rounds`` counter and static constants, so
lanes-on and lanes-off engines produce bit-identical populations: no
random draws, no reductions over population data, no host read.  The
drain fetches them under ``wire.transfer.egress("telemetry")`` with the
generation's wire, and :func:`attribute_phases` normalizes the work-unit
vector onto the generation's measured wall to fill the timeline's
per-phase columns.

Honesty note: the per-phase *seconds* are a work model (dynamic round
counts x static per-phase cost factors derived from the program shape),
normalized onto measured wall seconds — not a hardware timer.  The
counters themselves (rounds, simulations) are exact.

**Progress word** (:data:`PROGRESS`).  The JAX package plants a host
callback inside its device while-loop.  The port's one-dispatch engine
is driven from the host and reads one packed control tensor per
generation anyway, so the word is advanced by a plain call after that
read (:func:`progress_update`): no extra host read.  The flight recorder
embeds the last word in its dump, so a post-mortem names the generation
that died.

**Fleet side.**  With a run directory (``telemetry/aggregate.py``), a
:class:`ProgressPoller` thread force-publishes the fleet snapshot every
``$PYABC_TPU_PROGRESS_POLL_S`` seconds (default 0.5) while the word
moves, so a reader sees the generations of a one-dispatch call advance
before the call returns; :func:`merge_progress` folds the hosts' words
into one.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional

#: phases of one fused generation, in program order.  ``simulate``,
#: ``distance`` and ``screen`` scale with the rejection rounds
#: (``screen`` is the multi-fidelity cascade's low-fidelity stage,
#: zero-cost when screening is off); ``eps_solve`` / ``refit`` /
#: ``resample`` are once-per-generation adaptation work.
PHASES = ("simulate", "distance", "screen", "eps_solve", "refit",
          "resample")

#: wire-lane prefix; the store and the drain exclude ``tl_*`` lanes from
#: population decode exactly like the ``sm_*`` summary lanes
LANE_PREFIX = "tl_"

#: master switch for the device lanes and the progress word (default
#: on); "0" runs the engines without them
LANES_ENV = "PYABC_TPU_TELEMETRY_LANES"


def lanes_enabled() -> bool:
    """Whether device telemetry lanes (and the progress word) run in the
    fused and one-dispatch engines."""
    return os.environ.get(LANES_ENV, "1") not in ("0", "false", "no")


#: seconds between the progress poller's looks at the word
POLL_ENV = "PYABC_TPU_PROGRESS_POLL_S"


def poll_interval_s() -> float:
    try:
        return max(float(os.environ.get(POLL_ENV, "0.5")), 0.05)
    except ValueError:
        return 0.5


# ------------------------------------------------------------- device side

def phase_cost_model(*, B: int, n_target: int, d: int, s: int, M: int,
                     eps_mode: str, support_rows: int,
                     adaptive: bool,
                     fidelity: bool = False) -> Dict[str, dict]:
    """Static per-phase cost factors for one generation, derived from
    the engine's shape (batch ``B``, population ``n_target``, parameter
    dim ``d``, summary-stat width ``s``, ``M`` models, the epsilon mode
    and the refit support size).  Units are arbitrary work units — only
    the RATIOS matter, because :func:`attribute_phases` normalizes onto
    the measured wall.  Factors marked ``per_round`` multiply the
    generation's round count."""
    sup = max(int(support_rows), 1)
    return {
        # one proposal + forward simulation per candidate per round
        "simulate": {"per_round": float(B) * max(s, 1), "fixed": 0.0},
        # distance kernel over the candidate stats per round
        "distance": {"per_round": float(B) * max(s, 1), "fixed": 0.0},
        # the fidelity cascade's low-fidelity stage per round; an
        # unscreened engine carries a zero-cost row so the lane layout is
        # mode-independent
        "screen": {"per_round": (float(B) * max(s, 1) if fidelity
                                 else 0.0),
                   "fixed": 0.0},
        # weighted quantile: O(n log n) sort; temperature: bisection over
        # the record ring; constant: free
        "eps_solve": {"per_round": 0.0,
                      "fixed": (0.0 if eps_mode == "constant"
                                else float(n_target)
                                * max(math.log2(max(n_target, 2)), 1.0))},
        # per-model KDE covariance + cholesky over the (possibly capped)
        # support; an adaptive distance refit rides here too
        "refit": {"per_round": 0.0,
                  "fixed": (float(M) * sup * d * d
                            + (float(B) * max(s, 1) if adaptive
                               else 0.0))},
        # deferred proposal-density correction: accepted rows x support
        "resample": {"per_round": 0.0,
                     "fixed": float(n_target) * sup * max(d, 1)},
    }


def phase_wire_lanes(rounds, B: int, cost_model: Dict[str, dict]) -> dict:
    """The ``tl_*`` lanes of one generation from its ``rounds`` tensor
    (0-d, on the device): ``tl_sims`` (int32 — candidate simulations,
    ``rounds * B``) and ``tl_phase`` (float32[len(PHASES)] — per-phase
    work units, ``per_round * rounds + fixed``).  Tensor arithmetic only:
    no host read, no random draw, no population data."""
    import torch

    r = rounds.to(torch.float32)
    # host scalars ride the kernels as arguments: a tensor built from a
    # host list would be a copy to the card every generation
    phase = torch.stack([r * cost_model[n]["per_round"]
                         + cost_model[n]["fixed"] for n in PHASES])
    return {"tl_sims": rounds.to(torch.int32) * B, "tl_phase": phase}


def attribute_phases(tl_phase, wall_s: float) -> Dict[str, float]:
    """Normalize one generation's work-unit vector onto its measured
    wall seconds: ``{phase: seconds}`` summing to ``wall_s`` (an
    all-zero vector attributes everything to ``simulate`` rather than
    dividing by zero)."""
    import numpy as np

    v = np.asarray(tl_phase, dtype=np.float64).reshape(-1)
    total = float(v.sum())
    out = {}
    for i, name in enumerate(PHASES):
        share = (float(v[i]) / total) if total > 0 else \
            (1.0 if name == "simulate" else 0.0)
        out[name] = share * float(wall_s)
    return out


# ----------------------------------------------------------- progress word

class RunProgress:
    """Per-run progress words, keyed by a run tag.

    ``begin()`` allocates a fresh integer *tag* for one one-dispatch
    call, and the engine hands it back to :meth:`update` after each
    generation's control read, so two runs in one process never advance
    each other's word.  ``read()`` with no tag gives the freshest ACTIVE
    word, falling back to the freshest finished one; ``read(tag)``
    isolates one run.  Finished words are kept for a short tail
    (:data:`RunProgress._KEEP_FINISHED`), then evicted oldest-first.
    """

    #: finished words retained for post-run reads before eviction
    _KEEP_FINISHED = 8

    def __init__(self):
        self._lock = threading.Lock()
        self._words: Dict[int, dict] = {}
        self._current: Optional[int] = None
        self._next_tag = 1

    def begin(self, *, t0: int, t_limit: int, run_id=None) -> int:
        """Arm a new word; returns its tag (a small positive int; 0 is
        reserved for "untagged", which routes to the most recently armed
        word)."""
        with self._lock:
            tag = self._next_tag
            self._next_tag += 1
            now = time.time()
            self._words[tag] = {
                "active": True,
                "tag": tag,
                "t0": int(t0),
                "t_limit": int(t_limit),
                "gen": int(t0),
                "gens_done": 0,
                "eps": None,
                "accepted": None,
                "rounds": 0,
                "run_id": None if run_id is None else str(run_id),
                "started_unix": now,
                "updated_unix": now,
            }
            self._current = tag
            self._evict_locked()
            return tag

    def _evict_locked(self):
        finished = sorted(
            (t for t, w in self._words.items() if not w["active"]),
            key=lambda t: self._words[t]["updated_unix"])
        for t in finished[:max(len(finished) - self._KEEP_FINISHED, 0)]:
            del self._words[t]

    def update(self, gens_done: int, eps: float, accepted: int,
               rounds: int, tag: Optional[int] = None):
        """Advance one word: ``gens_done`` counts completed generations;
        ``gen`` is the absolute index of the last completed one.  ``tag``
        0/None means the most recently armed run."""
        with self._lock:
            key = self._current if not tag else int(tag)
            st = None if key is None else self._words.get(key)
            if st is None:
                return
            gd = int(gens_done)
            if gd < st["gens_done"]:
                return  # the word stays monotone
            st["gens_done"] = gd
            st["gen"] = st["t0"] + gd - 1
            st["eps"] = float(eps)
            st["accepted"] = int(accepted)
            st["rounds"] = max(int(rounds), st["rounds"])
            st["updated_unix"] = time.time()

    def finish(self, tag: Optional[int] = None):
        with self._lock:
            key = self._current if not tag else int(tag)
            st = None if key is None else self._words.get(key)
            if st is not None:
                st["active"] = False
                st["updated_unix"] = time.time()

    def reset(self):
        """Test isolation: forget every run's word."""
        with self._lock:
            self._words = {}
            self._current = None
            self._next_tag = 1

    def read(self, tag: Optional[int] = None) -> Optional[dict]:
        """``read(tag)`` → that run's word (or None).  ``read()`` → the
        freshest active word, else the freshest finished one, else
        None."""
        with self._lock:
            if tag:
                st = self._words.get(int(tag))
                return None if st is None else dict(st)
            if not self._words:
                return None
            active = [w for w in self._words.values() if w["active"]]
            pick = max(active or list(self._words.values()),
                       key=lambda w: w["updated_unix"])
            return dict(pick)

    def read_all(self) -> List[dict]:
        """Every retained word, oldest tag first."""
        with self._lock:
            return [dict(self._words[t]) for t in sorted(self._words)]


#: the process-global progress registry (one word per one-dispatch call)
PROGRESS = RunProgress()


def progress_update(gens_done: int, eps: float, accepted: int,
                    rounds: int, run_tag: Optional[int] = None):
    """Advance the run's word after a generation's control read (host
    values already read).  Never raises: an observability hook that ends
    the run it observes is worse than none."""
    try:
        PROGRESS.update(int(gens_done), float(eps), int(accepted),
                        int(rounds), tag=run_tag)
    except Exception:
        pass


class ProgressPoller:
    """Daemon thread publishing the progress word while a one-dispatch
    call is in flight: every tick that sees a fresher word force-writes
    the fleet snapshot (the cadence here is the throttle), so the
    snapshot does not freeze at the pre-dispatch state until the call
    returns."""

    def __init__(self, publish: Callable[[], object],
                 interval_s: Optional[float] = None):
        self._publish = publish
        self._interval = (poll_interval_s() if interval_s is None
                          else max(float(interval_s), 0.05))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_seen = -1.0

    def start(self) -> "ProgressPoller":
        t = threading.Thread(target=self._run, daemon=True,
                             name="abc-progress-poller")
        self._thread = t
        t.start()
        return self

    def _run(self):
        while not self._stop.wait(self._interval):
            word = PROGRESS.read()
            if word is None or not word.get("active"):
                continue
            if word["updated_unix"] <= self._last_seen:
                continue  # nothing new since the last publish
            self._last_seen = word["updated_unix"]
            try:
                self._publish()
            except Exception:
                pass  # a publish hiccup must not kill the poller

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None


# -------------------------------------------------------------- fleet side

def merge_progress(words: List[Optional[dict]]) -> Optional[dict]:
    """One fleet view of per-host progress words: the most recently
    updated active word (else the freshest inactive one), with
    ``hosts_active`` (hosts still inside a dispatch) and
    ``hosts_reporting``."""
    live = [w for w in words if w]
    if not live:
        return None
    active = [w for w in live if w.get("active")]
    pick = max(active or live,
               key=lambda w: w.get("updated_unix", 0.0))
    merged = dict(pick)
    merged["hosts_active"] = len(active)
    merged["hosts_reporting"] = len(live)
    return merged
