"""The rejection loop with compaction into fixed buffers.

Port of ``build_stateful_loop`` from ``pyabc_tpu/sampler/device_loop.py``
as a Python loop over rounds.  Accepted candidates accumulate in
device-resident buffers of ``cap = n_target + B`` rows; each round's
accepted rows land at ``pos = count + cumsum(accepted) − 1`` and rows at
or past ``cap`` are dropped (written to one dump row past the end).  The
compaction keeps (round, lane) order, and the caller truncates to the
first ``n_target`` rows — the reference's DYN de-biasing protocol: keep
every result of every started round, in a deterministic order.

With ``record_cap > 0`` every *valid* candidate (accepted or not) is also
scattered, in the same (round, lane) order, into NaN-filled record
buffers ``rec_stats``, ``rec_distance``, ``rec_accepted``, ``rec_m``,
``rec_theta`` and ``rec_log_proposal`` of ``max(record_cap, 1)`` rows;
rows past the cap are dropped.

One round is one program (:class:`RoundProgram`): ``raw_round``, the
append of its accepted rows, the count update and the record scatter,
all written in place into buffers allocated once per (round kernel, B,
n_target, record_cap).  On the card the program is captured as a CUDA
graph (``autotune.ladder``: the JAX package's ahead-of-time surface):
the first round of a rung runs eagerly on the run's generator and
buffers, under the capture's pre-screen, and gives the capture its
shapes; every later round is one replay, one graph launch where the
eager round makes ~150 launches from Python.  The buffers are the
graph's own inputs, so they are never rebound.  The JAX package's
``while_loop`` over rounds is not ported: the host reads the count once
per round, as the eager loop does.  A round that cannot be captured (a
simulator that reads the card from the host) is counted in
``autotune_aot_errors_total``, logged with its models, and runs eagerly
(``RoundProgram.route`` ``"refused"``); on the CPU the program is called
directly (``"eager"``).

Returns ``(start, step, finalize, reset)`` (a :class:`StatefulLoop`,
which also carries the ``program``):

- ``start() -> state`` — the loop's state, its cursor at 0; the buffers
  are allocated at the first round, from that round's shapes;
- ``step(generator, params, state) -> state`` — up to ``max_rounds``
  rounds, stopping early once ``count >= n_target`` (one host read of the
  count per round);
- ``finalize(state, params) -> view`` — the first ``min(count,
  n_target)`` rows; with ``weight_correction`` the deferred proposal
  density is subtracted here, once, over the accepted rows.  On the card
  a finalize of ``n_target`` rows replays a captured graph (K1's
  launches inside it); one below the target — a checkpoint flush in the
  middle of a generation, or a generation cut short by ``max_eval`` —
  stays eager;
- ``reset(state) -> state`` — a cursor rewind for the next generation,
  the buffers refilled in place (captured with the round on the card, as
  the JAX package compiles its ``reset`` when it builds the loop).

:func:`harvest_rec` copies a call's records out of a state and refills
its record buffers in place.

Every host read of the count goes through the program's
:class:`~pyabc_tpu_torch.telemetry.phases.RoundClock` (``program.clock``;
a sampler starts one a generation with ``program.new_clock()``).  With
the span tracer on, on the card, the round's phase marks and the
finalize's ``finalize`` mark record timing events (into the captured
graphs, when the capture runs with the tracer on); the clock reads the
round's after each count read, and the finalize's once it has run.
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Optional, Tuple

import torch

from ..autotune.ladder import (CaptureRefused, TensorSpec, aot_compile,
                               jit_compile, screened_call)
from ..telemetry import phases as _phases
from ..telemetry.spans import TRACER
from .base import RECORD_KEYS

logger = logging.getLogger("ABC.Sampler")

_KEYS = ("m", "theta", "distance", "log_weight", "stats")
#: what an empty accept buffer holds, per lane
_FILL = {"m": 0, "theta": 0.0, "distance": math.nan,
         "log_weight": -math.inf, "stats": 0.0}
_TARGETS = ("bufs", "count", "rec", "rec_count", "npass")
#: params keys whose tensors the rounds alone read (a generation's
#: resampling CDFs, ``RoundKernel.prepare``): a captured round takes them
#: as its own inputs (donated), as it takes its buffers
OWN_KEYS = ("cdf", "model_cdf")


def append_accepted(pairs, acc: torch.Tensor, count: torch.Tensor,
                    cap: int) -> None:
    """Write each ``(buf, rows)`` pair's accepted rows to ``buf`` from
    row ``count`` on, in order, dropping rows at or past ``cap`` (``buf``
    holds ``cap + 1`` rows: the last one takes the dropped writes).  The
    round starts below its target, so ``count + len(acc) <= cap``.

    Under PyTorch's deterministic mode on the card (a multi-rank run:
    ``parallel.mesh.deterministic_kernels``) the scatter's index write
    sorts its indices and writes each index's rows one after another, and
    every rejected row shares the dump row: ~21 ms a key and round at
    ``pod1e5``'s 2^18 rows on an H100, 98 % of its device time
    (``chip_smoke.py --phases detprof``).  There each slot gathers its
    row instead (:func:`_gather_accepted`), so the write has one row per
    index; the rows kept are the same."""
    if acc.is_cuda and torch.are_deterministic_algorithms_enabled():
        return _gather_accepted(pairs, acc, count, cap)
    pos = count + torch.cumsum(acc.to(torch.int64), 0) - 1
    idx = torch.where(acc & (pos < cap), pos, torch.full_like(pos, cap))
    for buf, rows in pairs:
        buf[idx] = rows


def _gather_accepted(pairs, acc: torch.Tensor, count: torch.Tensor,
                     cap: int) -> None:
    """:func:`append_accepted` as a gather: slot ``count + k`` takes the
    k-th accepted row while ``k`` is below the round's acceptances and
    the slot below ``cap``, else keeps its value; the dump row is left
    alone."""
    pos = count + torch.cumsum(acc.to(torch.int64), 0) - 1
    k = torch.arange(acc.shape[0], device=acc.device)
    n_acc = pos[-1] + 1 - count
    src = torch.clamp(torch.searchsorted(pos - count, k), max=k.shape[0] - 1)
    dst = torch.clamp(count + k, max=cap)
    keep = (k < n_acc) & (dst < cap)
    for buf, rows in pairs:
        mask = keep.view((-1,) + (1,) * (rows.dim() - 1))
        buf[dst] = torch.where(mask, rows[src], buf[dst])


def _fill_records(rec: dict) -> dict:
    """Record buffers back to empty, in place: NaN floats, False,
    model 0."""
    for v in rec.values():
        v.fill_(float("nan") if v.is_floating_point() else 0)
    return rec


def _apply_round(targets: dict, out, cap: int, rc: int, record_cap: int,
                 staged: bool):
    """:meth:`RoundProgram.apply`'s work (``rc`` record rows and a dump
    row, ``cap`` accept rows and a dump row)."""
    rr, pairs = out if staged else (out, None)
    if pairs is not None:
        targets["npass"].add_(pairs[2].sum())
    acc = rr.accepted
    count = targets["count"]
    append_accepted([(targets["bufs"][k], getattr(rr, k)) for k in _KEYS],
                    acc, count, cap)
    count.copy_(torch.clamp(count + acc.sum(), max=cap))
    if record_cap:
        val = rr.valid
        rcount = targets["rec_count"]
        rpos = rcount + torch.cumsum(val.to(torch.int64), 0) - 1
        ridx = torch.where(val & (rpos < rc), rpos, rc)
        for k in RECORD_KEYS:
            targets["rec"][k][ridx] = getattr(rr, k)
        rcount.copy_(torch.clamp(rcount + val.sum(), max=rc))
    _phases.mark("compact")
    return out


def _round_program(raw_round: Callable, cap: int, rc: int, record_cap: int,
                   staged: bool, keep_outputs: bool) -> Callable:
    def program(generator, params, targets: dict):
        out = _apply_round(targets, raw_round(generator, params), cap, rc,
                           record_cap, staged)
        return out if keep_outputs else None
    return program


class RoundProgram:
    """One round of a rejection loop as one program over buffers it keeps:
    ``raw_round(generator, params)`` (``(RoundResult, pairs)`` with
    ``staged``: the fidelity cascade's round), the append of its accepted
    rows to the accept buffers, the count update, the staged round's
    survivor count (``npass``) and, with ``record_cap``, the record
    scatter, each written in place.

    ``graphs`` (the card): the first round runs eagerly and the program is then
    captured as a CUDA graph into ``pool`` and replayed on every later round;
    the state's buffers are the graph's own inputs.  Otherwise, or when the
    card refuses the capture, :meth:`run` calls it.  ``label`` names the round
    (its models and batch) in spans and in the log of a refusal; without
    ``keep_outputs`` the program returns None (the rejection loop reads only
    its buffers, and a captured output would hold pool memory for as long as
    the graph lives).  The state (``count``, ``bufs``, ``rec``, ``rec_count``,
    ``npass``, and the caller's ``rounds``) lives as long as the program.
    The params' :data:`OWN_KEYS` tensors, which the rounds alone read, are
    the graph's own inputs too (:meth:`own_params`)."""

    def __init__(self, raw_round: Callable, B: int, n_target: int,
                 record_cap: int = 0, staged: bool = False,
                 graphs: bool = False, pool=None, label: str = "round",
                 keep_outputs: bool = True):
        self.raw_round = raw_round
        self.keep_outputs = bool(keep_outputs)
        self.B, self.n_target = int(B), int(n_target)
        self.cap = self.n_target + self.B
        self.record_cap = int(record_cap)
        self.rc = max(self.record_cap, 1)
        self.staged = bool(staged)
        self._program = _round_program(raw_round, self.cap, self.rc,
                                       self.record_cap, self.staged,
                                       self.keep_outputs)
        self.pool = pool
        self.label = label
        self.state = {"count": None, "rounds": 0, "bufs": None, "rec": None,
                      "rec_count": None, "npass": None}
        #: "graph" (replays of a captured round), "eager" (the program
        #: called: the CPU, a sampler whose rounds cross ranks) or
        #: "refused" (the card refused the capture)
        self.route = "graph" if graphs else "eager"
        #: the refusal's message, when the route is "refused"
        self.refusal: Optional[str] = None
        #: seconds the captures took, their warm-up included
        self.capture_s = 0.0
        #: rounds served by a replay, and called eagerly
        self.replays = 0
        self.eager_rounds = 0
        self._round = None
        self._reset = None
        #: the args' specs were checked against the graph since the last
        #: reset (a generation's params are fixed for its rounds)
        self._checked = False
        #: the phase marks (recorded only while traced); the events of the
        #: captured round, and those of the last round run, not yet read
        self._marks = _phases.PhaseMarks()
        self._phase_graph = None
        self._phase_read = None
        #: the clock of the count reads (the sampler starts one a
        #: generation: :meth:`new_clock`)
        self.clock = _phases.RoundClock(self)

    # ---- tracing --------------------------------------------------------

    def new_clock(self) -> "_phases.RoundClock":
        """A fresh clock for the next loop's count reads."""
        self.clock = _phases.RoundClock(self)
        self._phase_read = None
        return self.clock

    def traced(self) -> bool:
        """Whether rounds run now record phase marks: the tracer is on
        and the round runs on the card."""
        if not TRACER.enabled:
            return False
        count = self.state["count"]
        return self.route != "eager" or (count is not None and count.is_cuda)

    def _recording(self):
        return _phases.recording(self._marks if self.traced() else None)

    def _ran(self, captured: bool = False) -> None:
        """After the round ran (or was captured) in Python under
        :meth:`_recording`: keep the events it marked."""
        events = self._marks.current if self.traced() else None
        if captured:
            self._phase_graph = events
        else:
            self._phase_read = events

    def take_phases(self) -> Optional[dict]:
        """``{phase: device seconds}`` of the last round run, once (None:
        not traced, or read already).  Call after a read that waited for
        the round."""
        events, self._phase_read = self._phase_read, None
        if not events or len(events) < 2:
            return None
        return _phases.elapsed(events)

    # ---- the program ----------------------------------------------------

    def targets(self) -> dict:
        """The state's tensors, the program's third argument."""
        return {k: self.state[k] for k in _TARGETS}

    def own_params(self) -> Optional[dict]:
        """The params the captured round holds as its inputs, in the
        params' nesting (None before the capture, or off the graph route).
        Its :data:`OWN_KEYS` tensors are the ones the capture was given
        (donated): a caller writes the next generation's values into them
        in place and passes them back, so nothing is copied in and no
        second copy is kept (``RoundKernel.prepare``)."""
        if self.route != "graph" or self._round is None:
            return None
        return self._round.inputs[1]

    def apply(self, targets: dict, out):
        """Fold a round's output into ``targets`` in place; returns
        ``out``."""
        return _apply_round(targets, out, self.cap, self.rc,
                            self.record_cap, self.staged)

    @property
    def program(self) -> Callable:
        """The whole round, ``(generator, params, targets)``:
        ``raw_round`` then :meth:`apply` (its output only with
        ``keep_outputs``).  A function holding no reference to this
        object, so a graph of it does not keep the program alive."""
        return self._program

    @staticmethod
    def refill(targets: dict) -> None:
        """The buffers back to empty and the counts to 0, in place."""
        for k, v in targets["bufs"].items():
            v.fill_(_FILL[k])
        targets["count"].zero_()
        if targets["rec"] is not None:
            _fill_records(targets["rec"])
            targets["rec_count"].zero_()
        if targets["npass"] is not None:
            targets["npass"].zero_()

    # ---- the buffers ----------------------------------------------------

    def _layout(self, rr) -> dict:
        """The state's tensors as :class:`TensorSpec` leaves, from a
        round's shapes (one dump row per buffer)."""
        dev = rr.m.device
        rows = self.cap + 1

        def spec(shape, dtype):
            return TensorSpec(tuple(shape), dtype, dev)

        scalar = spec((), torch.int64)
        bufs = {
            "m": spec((rows,), rr.m.dtype),
            "theta": spec((rows, rr.theta.shape[1]), torch.float32),
            "distance": spec((rows,), torch.float32),
            "log_weight": spec((rows,), torch.float32),
            "stats": spec((rows, rr.stats.shape[1]), torch.float32),
        }
        rec = None
        if self.record_cap:
            rec = {k: spec((self.rc + 1,) + tuple(getattr(rr, k).shape[1:]),
                           getattr(rr, k).dtype) for k in RECORD_KEYS}
        return {"bufs": bufs, "count": scalar, "rec": rec,
                "rec_count": scalar if self.record_cap else None,
                "npass": scalar if self.staged else None}

    def _adopt(self, targets: dict) -> None:
        self.state.update(targets)

    def _allocate(self, rr) -> None:
        def alloc(s):
            return torch.empty(s.shape, dtype=s.dtype, device=s.device)

        layout = self._layout(rr)
        self._adopt({
            k: ({n: alloc(s) for n, s in v.items()} if isinstance(v, dict)
                else None if v is None else alloc(v))
            for k, v in layout.items()})
        self.refill(self.targets())

    def _refuse(self, err: CaptureRefused) -> None:
        self.route = "refused"
        self.refusal = str(err)
        self._round = self._reset = None
        logger.warning("%s cannot be captured as a CUDA graph; it runs "
                       "eagerly: %s", self.label, err)

    def _capture(self, generator, params, targets) -> None:
        """Capture the round and the refill on the state's own buffers
        (donated: the graphs write them in place).  No warm-up: the round
        ran eagerly on these shapes under the capture's pre-screen (the
        first round of the rung), and the refill is fills."""
        try:
            self._round = aot_compile(
                jit_compile(self.program, donate_argnums=(2,),
                            donate_keys=OWN_KEYS, pool=self.pool,
                            label=self.label, warmup=False),
                generator, params, targets)
            self._reset = aot_compile(
                jit_compile(self.refill, donate_argnums=(0,),
                            pool=self.pool, label=self.label + ".reset",
                            warmup=False),
                targets)
        except CaptureRefused as err:
            self._refuse(err)
            return
        self.capture_s += (self._round.capture_seconds
                           + self._reset.capture_seconds)
        self._checked = True

    def _first_round(self, generator, params):
        """The first round of the rung on the graph route: run eagerly on
        the run's generator and buffers (a real round, drawn as a replay
        would draw it) under the capture's pre-screen, then the capture
        on the buffers it allocated."""
        with self._recording():
            out, refusal = screened_call(self.raw_round, generator, params,
                                         label=self.label)
            if self.state["bufs"] is None:
                self._allocate(out[0] if self.staged else out)
            self.eager_rounds += 1
            self.apply(self.targets(), out)
        self._ran()
        if refusal is not None:
            self._refuse(refusal)
        else:
            with self._recording():
                self._capture(generator, params, self.targets())
            self._ran(captured=True)
        return out

    def run(self, generator, params):
        """One round into the state; returns the round's output (a
        replay's output stays valid until the next replay of a graph of
        the same pool)."""
        if self.route == "graph" and self._round is None:
            return self._first_round(generator, params)
        if self.route == "graph":
            targets = self.targets()
            try:
                if not self._checked:
                    # new specs (a support that grew): capture again, on
                    # the same buffers
                    before = self._round.captures
                    with self._recording():
                        self._round.specialize(generator, params, targets)
                    if self._round.captures != before:
                        self._ran(captured=True)
                        self.capture_s += self._round.capture_seconds
                    self._checked = True
            except CaptureRefused as err:
                self._refuse(err)
            else:
                self.replays += 1
                self._phase_read = (self._phase_graph if self.traced()
                                    else None)
                return self._round(generator, params, targets)
        with self._recording():
            out = self.raw_round(generator, params)
            if self.state["bufs"] is None:
                self._allocate(out[0] if self.staged else out)
            self.eager_rounds += 1
            out = self.apply(self.targets(), out)
        self._ran()
        return out

    def reset(self) -> None:
        """Refill the buffers and zero the counts (no-op before the first
        round)."""
        self._checked = False
        if self.state["count"] is None:
            return
        if self._reset is not None:
            self._reset(self.targets())
        else:
            self.refill(self.targets())
        self.state["rounds"] = 0


class StatefulLoop(tuple):
    """``(start, step, finalize, reset)``, with the loop's
    :class:`RoundProgram` (``program``)."""

    def __new__(cls, fns, program: RoundProgram):
        self = super().__new__(cls, fns)
        self.program = program
        return self


def build_stateful_loop(raw_round: Callable, B: int, n_target: int,
                        max_rounds: int,
                        weight_correction: Optional[Callable] = None,
                        record_cap: int = 0, graphs: bool = False,
                        pool=None, label: str = "round") -> StatefulLoop:
    """``raw_round(generator, params) -> RoundResult`` of B candidates;
    ``weight_correction(m, theta, params) -> log_denom`` marks the rounds'
    log weights as partial (see ``RoundKernel.generation_round``);
    ``record_cap`` rows of records per call (0: none); ``graphs``: capture
    the round and the finalize as CUDA graphs into ``pool`` (the card)."""
    program = RoundProgram(raw_round, B, n_target, record_cap=record_cap,
                           graphs=graphs, pool=pool, label=label,
                           keep_outputs=False)
    state = program.state
    #: the captured finalize; "refused" once the card refused it; the
    #: timing events its capture marked
    final = {"guard": None, "refused": False, "events": None}
    final_marks = _phases.PhaseMarks()

    def start() -> dict:
        return reset(state)

    def step(generator, params, state: dict) -> dict:
        clock = program.clock
        for _ in range(max_rounds):
            if state["count"] is not None and \
                    clock.read(int, state["count"]) >= n_target:
                break
            program.run(generator, params)
            state["rounds"] += 1
        return state

    def corrected(targets: dict, params) -> torch.Tensor:
        """The finalize's work at ``n_target`` rows: the deferred density
        (K1, one launch per model) subtracted from the partial weights."""
        _phases.start()
        bufs = targets["bufs"]
        lw = bufs["log_weight"][:n_target]
        log_denom = weight_correction(bufs["m"][:n_target],
                                      bufs["theta"][:n_target], params)
        # -inf partial weights stay -inf (-inf - -inf would be NaN)
        out = torch.where(torch.isfinite(lw), lw - log_denom, lw)
        _phases.mark("finalize")
        return out

    def final_guard(params):
        """The captured finalize at ``n_target`` rows, or None (not the
        graph route, nothing deferred, or refused)."""
        if (program.route != "graph" or weight_correction is None
                or final["refused"]):
            return None
        targets = program.targets()
        traced = program.traced()
        before = (0 if final["guard"] is None
                  else final["guard"].captures)
        try:
            with _phases.recording(final_marks if traced else None):
                if final["guard"] is None:
                    final["guard"] = aot_compile(
                        jit_compile(corrected, donate_argnums=(0,),
                                    pool=program.pool,
                                    label=program.label + ".finalize"),
                        targets, params)
                    program.capture_s += final["guard"].capture_seconds
                else:
                    final["guard"].specialize(targets, params)
            if final["guard"].captures != before:
                # the new graph's marks; none when captured untraced
                final["events"] = final_marks.current if traced else None
        except CaptureRefused as err:
            logger.warning("the finalize of %s cannot be captured as a "
                           "CUDA graph; it runs eagerly: %s", label, err)
            final["guard"], final["refused"] = None, True
        return final["guard"]

    def finalize(state: dict, params) -> dict:
        take = min(int(state["count"]), n_target)
        view = {k: state["bufs"][k][:take] for k in _KEYS}
        if weight_correction is None or not take:
            return view
        guard = final_guard(params) if take == n_target else None
        if guard is not None:
            # copied out of the pool: the ladder's other graphs reuse it
            view["log_weight"] = guard(program.targets(), params).clone()
            if final["events"] and program.traced():
                program.clock.add_finalize(sum(_phases.elapsed(
                    final["events"], wait=True).values()))
            return view
        # eager: the CPU, a refused capture, or a finalize below the
        # target (a checkpoint flush mid-generation, a generation cut
        # short by max_eval)
        log_denom = weight_correction(view["m"], view["theta"], params)
        lw = view["log_weight"]
        view["log_weight"] = torch.where(torch.isfinite(lw),
                                         lw - log_denom, lw)
        return view

    def reset(state: dict) -> dict:
        program.reset()
        state["rounds"] = 0
        return state

    return StatefulLoop((start, step, finalize, reset), program)


def harvest_rec(state: dict) -> Tuple[dict, dict]:
    """``(rec, state)``: this call's records — ``rec_<key>`` copies of the
    ``max(record_cap, 1)`` record rows, NaN past ``rec_count`` — and the
    state with its record buffers refilled with NaN in place and the
    record count at 0.

    Records are taken out every call rather than carried: the device
    buffer bounds one call, and ``Sample.append_record_batch`` bounds the
    generation at ``max_records``, earliest first.  The copies leave the
    state, so a later round or ``reset`` never overwrites them."""
    old = state["rec"]
    if old is None:
        return {"rec_count": 0}, state
    rec = {"rec_" + k: v[:-1].clone() for k, v in old.items()}
    rec["rec_count"] = state["rec_count"].clone()
    _fill_records(old)
    state["rec_count"].zero_()
    return rec, state
