"""Single-device vectorized sampler.

Port of ``pyabc_tpu/sampler/vectorized.py``.  One generation repeats
fixed-size candidate rounds on the device until ``n`` are accepted
(:mod:`.device_loop`), then fetches the compacted accepted buffers to
the host once.  The candidate batch ``B`` comes from a power-of-two
ladder chosen by the :class:`~pyabc_tpu_torch.autotune.BatchAutotuner`
(acceptance-rate EWMA with variance, undershoot feedback, hysteresis).

The proposal density is always deferred out of the rounds when the round
function supports it: rounds produce partial weights and ``finalize``
subtracts the KDE density once over the accepted rows — one KDE kernel
launch per model per generation.  The f16 wire codec of the JAX package
is not ported: the host reads the float32 buffers.

With ``record_rejected`` set, each call's rounds also record their valid
candidates (``record_cap = min(max_records, B · max_rounds_per_call)``
rows per call); the records are harvested once per call and handed to
``Sample.append_record_batch`` on the device.  With
``record_proposal_density`` also set and the density deferred, the
harvest carries the proposal density, which the ``Sample`` evaluates
once over the kept rows of each call (one K1 launch per model).

With ``defer_wire_fetch=True`` and no records, the accepted rows are not
fetched: a device copy of them becomes the ``Sample``'s pending wire
(``pyabc_tpu/sampler/vectorized.py:305``), with the CUDA event of its
producer, and the caller hands it to a streaming-ingest worker or the
device store.  The copy matters: the loop's buffers are rewound and
refilled by the next generation while the wire may still be in flight.
Fetched eagerly, with a ``prepacker`` set (``Sampler.prepacker``), the
rows the finalize does not change come back at the last count read,
before the finalize, and go to the History's packer threads while the
card computes the weights; the fetch after the finalize takes the
weights alone.

On the card each round is one replay of a captured CUDA graph
(:mod:`.device_loop`, ``autotune.ladder``), and so is a finalize of the
whole population with its K1 launches.  The built loop — its buffers,
which are the graphs' own inputs, and its graphs — is kept in the
sampler's :class:`~pyabc_tpu_torch.autotune.CompiledLadder` under the JAX
package's key ``("sloop", fn_id, B, extra)``, and reused by every later
generation on that rung; the ladder keeps at most ``MAX_LOOPS`` of them,
as the JAX package keeps at most four loop states (each holds its
buffers and its graphs).  A rung is captured on demand: its first round
runs eagerly and the capture follows, on the calling thread.  The JAX
package's prewarm of the next rung (``pyabc_tpu/sampler/vectorized.py:
166-215``) is not ported: a capture needs a round run on the rung's
shapes, and a discarded probe round on the calling thread bought no
measurable time on the card.  ``round_graphs`` is False on a sampler
whose rounds cross ranks (:class:`~.sharded.ShardedSampler`); its rounds
stay eager.  Each ``Sample`` says whether its rounds replayed a graph
(``round_graph``).

Every loop call is a dispatch under the sampler's retry policy
(``Sampler._dispatch``, the ``device.dispatch`` site) with the
generator's state and the accept cursor put back before a retry, so a
call that failed after its rounds had drawn retries the same draws.  The
cursor is a copy of the counts, written back in place: the counts are
the graphs' own tensors, updated in place by every round.
Before each call the loop visits the ``preempt`` site; with a
``checkpointer`` (``GenCheckpointer``, set by the orchestrator for one
generation) it flushes the cumulative accepted rows at the configured
cadence — one d2h copy under ``egress("checkpoint")`` — and raises
``Preempted`` after a flush once a SIGTERM arrived.
:meth:`VectorizedSampler.degrade_rung` halves the batch ceiling after a
retry-exhausted dispatch (``pyabc_tpu/sampler/vectorized.py:250``).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from ..autotune import BatchAutotuner, CompiledLadder
from ..convert import to_torch
from ..device import resolve_device
from ..resilience import faults as _faults
from ..resilience import retry as _retry
from ..telemetry.phases import RoundClock
from ..wire import transfer
from .base import Sample, Sampler, SamplingError, fetch_to_host, mark_ready
from .device_loop import build_stateful_loop, harvest_rec

logger = logging.getLogger("ABC.Sampler")


#: engines the sampler's ladder keeps: the JAX package's 16.  A port
#: engine closure or rejection loop holds device buffers, where an XLA
#: executable holds none; ``chip_smoke.py --phases laddermem`` runs the
#: pop-1e6 phases at 4 and 16 entries
LADDER_CAPACITY = 16
#: rejection loops the ladder keeps at most (the JAX package's bound on
#: its loop states): each holds its accept and record buffers and its
#: round, refill and finalize graphs
MAX_LOOPS = 4


def _is_loop_key(key) -> bool:
    return isinstance(key, tuple) and key[:1] == ("sloop",)


def _pow2_at_least(x: float) -> int:
    return 1 << max(int(np.ceil(np.log2(max(x, 1)))), 0)


class VectorizedSampler(Sampler):
    """On-device rejection-loop sampler."""

    #: rounds run on one card and may be captured as CUDA graphs (False
    #: where a round crosses ranks: its collective goes through the host)
    round_graphs = True

    #: the JAX package's budget (query × support pairs) for prefetching
    #: a deferred-mode finalize inside its device loop; the port's loop
    #: finalizes once, after its last round, and prefetches nothing, so
    #: no port code reads it
    MAX_PREFETCH_PAIRS = 1 << 36

    def __init__(self,
                 min_batch_size: int = 256,
                 max_batch_size: int = 1 << 18,
                 safety_factor: float = 1.2,
                 max_rounds_per_call: int = 64,
                 device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.min_batch_size = int(min_batch_size)
        self.max_batch_size = int(max_batch_size)
        self.safety_factor = float(safety_factor)
        self.max_rounds_per_call = int(max_rounds_per_call)
        self._tuner = BatchAutotuner()
        #: the engines the orchestrator builds for this sampler (fused
        #: blocks, one-dispatch runs) and its rejection loops, whose
        #: buffers are reused across generations (a reset is a cursor
        #: rewind): one bounded LRU, as in the JAX package
        self._ladder = CompiledLadder(capacity=LADDER_CAPACITY)
        #: set by a batch rung drop: the rounds stay eager from then on
        self._graphs_off = False
        #: candidate batch of the last generation sampled
        self.last_batch: Optional[int] = None

    def choose_batch(self, n: int) -> int:
        return self._tuner.choose_batch(n, self.safety_factor,
                                        self._round_to_valid_batch)

    @property
    def rate_est(self) -> float:
        """The autotuner's acceptance-rate estimate (EWMA)."""
        return self._tuner.rate

    def safety(self) -> float:
        """The autotuner's oversampling margin for the next generation."""
        return self._tuner.safety(self.safety_factor)

    def observe_generation(self, accepted: int, total: int,
                           rounds: Optional[int] = None,
                           compute_s: float = 0.0, overlap_s: float = 0.0):
        """Fold a generation that ran outside :meth:`sample_until_n_accepted`
        (a fused block's) into the autotuner, with its share of the wire
        ledger's ``compute_s`` / ``overlap_s``."""
        self._tuner.observe(accepted, total, rounds=rounds,
                            compute_s=compute_s, overlap_s=overlap_s)

    def observe_timing(self, compute_s: float, overlap_s: float = 0.0):
        """Fold a sequential generation's wire-ledger seconds into the
        autotuner (its rate was observed per sampler call)."""
        self._tuner.observe_timing(compute_s, overlap_s)

    def round_at(self, round_fn, B: int, **round_kwargs):
        """``round_fn`` at batch ``B`` as ``(generator, params) ->
        RoundResult``, ``round_kwargs`` passed to every call: the building
        block a :class:`~.sharded.ShardedSampler` splits over its mesh
        (``pyabc_tpu/sampler/vectorized.py:104``)."""
        return lambda gen, p: round_fn(gen, p, B, **round_kwargs)

    def raw_round(self, round_fn, B: int, **round_kwargs):
        """The deferred round of ``round_fn`` at batch ``B``: ``(generator,
        params) -> RoundResult`` with partial weights (the proposal
        density is left to the caller, once per generation);
        ``round_kwargs`` go to every call (the staged round's
        ``full_fraction``)."""
        return self.round_at(round_fn, B, with_proposal=False,
                             **round_kwargs)

    def graphs_on(self) -> bool:
        """Whether this sampler's rounds are captured: rounds on one card
        (:attr:`round_graphs`), a CUDA device, and no batch rung dropped
        for memory (:meth:`degrade_rung`)."""
        return (bool(self.round_graphs) and self.device.type == "cuda"
                and not self._graphs_off)

    def _loop(self, round_fn, B: int, n: int, record_cap: int):
        """The built rejection loop of ``round_fn`` at batch ``B`` from
        the ladder: ``(loop, weight_fn)``, ``weight_fn`` the deferred
        proposal density or None."""
        defer = (getattr(round_fn, "supports_deferred_proposal", False)
                 and hasattr(round_fn, "__self__"))
        owner = getattr(round_fn, "__self__", round_fn)
        fn_id = (getattr(owner, "_uid", id(owner)),
                 getattr(round_fn, "__name__", ""))
        weight_fn = owner.proposal_log_density if defer else None
        key = ("sloop", fn_id, B, (n, defer, record_cap))

        def build():
            raw = (self.raw_round(round_fn, B) if defer
                   else self.round_at(round_fn, B))
            models = ", ".join(type(m).__name__
                               for m in getattr(owner, "models", ()))
            return build_stateful_loop(
                raw, B, n, self.max_rounds_per_call,
                weight_correction=weight_fn, record_cap=record_cap,
                graphs=self.graphs_on(),
                pool=self._ladder.pool_source(),
                label=f"{fn_id[1]}[{models}] at B={B}")
        return key, build, weight_fn

    def _record_cap(self, B: int) -> int:
        return (min(self.max_records_cap(), B * self.max_rounds_per_call)
                if self.record_rejected else 0)

    def _round_to_valid_batch(self, b: float) -> int:
        return int(np.clip(_pow2_at_least(b), self.min_batch_size,
                           self.max_batch_size))

    def degrade_rung(self) -> Optional[int]:
        """Graceful degradation after a retry-exhausted dispatch failure
        (resilience/retry.py): halve the batch ceiling one rung, so a
        memory-pressure failure gets a strictly smaller round on the
        restart.  Returns the new ceiling, or None when already at the
        floor (the caller re-raises).  The ladder is emptied and the
        rounds run eagerly from then on: a graph pool would keep the
        larger rounds' memory from the smaller one."""
        if self.max_batch_size <= self.min_batch_size:
            return None
        self.max_batch_size = max(self.max_batch_size // 2,
                                  self.min_batch_size)
        # a graph pool keeps the larger rounds' blocks, which the smaller
        # round needs: drop every built program and its graphs, and run
        # the rounds eagerly from here on
        self._graphs_off = True
        self._ladder.clear()
        self._ladder.drop_pool()
        _retry.record_degrade("batch_rung_drop")
        logger.warning(
            "degrading batch ceiling to %d after repeated dispatch "
            "failure", self.max_batch_size)
        return self.max_batch_size

    def sample_until_n_accepted(self, n, round_fn, generator, params,
                                max_eval=np.inf, all_accepted=False,
                                defer_wire_fetch: bool = False) -> Sample:
        sample = Sample(record_rejected=self.record_rejected,
                        max_records=self.max_records)
        # params arrive as host numpy (fits are control plane); pin them
        # on the device once per generation
        params = to_torch(params, self.device)
        if all_accepted:
            # calibration: exact-size rounds; failed simulations (NaN
            # distance) are dropped, so top up until n
            B = self.last_batch = self._round_to_valid_batch(n)
            calibrate = self.round_at(round_fn, B, all_accepted=True)
            zero_rounds = 0
            clock = RoundClock()
            while sample.n_accepted < n:
                before = sample.n_accepted
                # the round's fetch is its count read (the dispatch, an
                # argument, runs before the clock starts)
                clock.read(sample.append_round, self._dispatch(
                    lambda: calibrate(generator, params), rng=generator))
                zero_rounds = (zero_rounds + 1
                               if sample.n_accepted == before else 0)
                if zero_rounds >= 3:
                    raise SamplingError(
                        "calibration produced no valid simulations in 3 "
                        "consecutive full rounds")
                if sample.nr_evaluations >= max_eval \
                        and sample.n_accepted < n:
                    logger.warning("max_eval reached during calibration "
                                   "(%d/%d)", sample.n_accepted, n)
                    break
            self.nr_evaluations_ = sample.nr_evaluations
            return sample

        bar = None
        if self.show_progress:
            from ..utils.progress import ProgressBar
            bar = ProgressBar(n, desc="sampling")
        B = self.last_batch = self.choose_batch(n)
        record_cap = self._record_cap(B)
        key, build, weight_fn = self._loop(round_fn, B, n, record_cap)
        record_density_fn = None
        if weight_fn is not None and record_cap \
                and self.record_proposal_density:
            # the records get their generating density at ingest
            record_density_fn = (
                lambda m, th: weight_fn(m, th, params))  # noqa: E731
        loop = self._ladder.get(key, build)
        self._ladder.retain(_is_loop_key, MAX_LOOPS)
        start, step, finalize, reset = loop
        # deferred rounds read the generation's resampling CDFs, built
        # once here (into the captured round's own inputs); the finalize
        # and the records' density keep the log weights
        kernel = getattr(round_fn, "__self__", None)
        round_params = params
        if weight_fn is not None and hasattr(kernel, "prepare"):
            round_params = kernel.prepare(params,
                                          into=loop.program.own_params())
        clock = loop.program.new_clock()
        state = start()
        replays0 = loop.program.replays
        wire_keys = None
        while True:
            # the preemption probe: a `preempt@K:sigterm` fault plan
            # delivers a real SIGTERM here, deterministically
            # mid-generation (resilience/faults.py)
            _faults.fault_point(_faults.SITE_PREEMPT)
            # a failed attempt wrote only rows past the cursor: putting
            # the cursor and the generator back makes the retry the same
            # call (resilience/retry.py)
            cursor = _Cursor(state)
            state = self._dispatch(step, generator, round_params, state,
                                   rng=generator, restore=cursor.restore)
            if record_cap:
                rec, state = harvest_rec(state)
                rec["record_density_fn"] = record_density_fn
                sample.append_record_batch(rec)
            count, rounds = clock.read(int, state["count"]), state["rounds"]
            self._tuner.observe(count, max(rounds * B, 1), rounds=rounds)
            if bar is not None:
                bar.update(min(count, n))
            ck = self.checkpointer
            if ck is not None and count < n:
                if ck.should_flush(rounds):
                    if (ck.manifest_source is not None
                            and not ck.raw_required()):
                        # lazy-History steady state: a manifest-only
                        # heartbeat, no d2h
                        ck.flush_manifest(rounds=rounds,
                                          nr_evaluations=rounds * B)
                    else:
                        # the CUMULATIVE accepted rows: finalize reads the
                        # buffers without changing them, so the rounds
                        # that follow go on from the same state
                        view = self._dispatch(finalize, state, params)
                        wire_keys = [k for k in view
                                     if k != "stats" or self.fetch_stats]
                        with transfer.egress("checkpoint"):
                            out_ck = fetch_to_host(
                                {k: view[k] for k in wire_keys})
                        ck.flush(out_ck, rounds=rounds,
                                 nr_evaluations=rounds * B)
                # the ledger is durable: a preemption signal now exits
                # cleanly (Preempted) instead of racing the kill timeout
                ck.maybe_raise_preempted()
            if count >= n:
                break
            if rounds * B >= max_eval:
                logger.warning("max_eval=%s reached with %d/%d accepted",
                               max_eval, count, n)
                break
        eager = not (defer_wire_fetch and not record_cap)
        early = None
        if eager and self.prepacker is not None and count >= n:
            # the rows the finalize reads and does not change come back
            # now, and their blobs pack while the card computes the
            # weights; the fetch after it takes the weights alone
            early = fetch_to_host(
                {k: state["bufs"][k][:n]
                 for k in ("m", "theta", "distance", "stats")
                 if k != "stats" or self.fetch_stats})
            sample.prepacked = self.prepacker(early)
        view = self._dispatch(finalize, state, params)
        sample.round_clock = clock.row()
        wire_keys = [k for k in view if k != "stats" or self.fetch_stats]
        if not eager:
            view = {k: v.clone() for k, v in view.items()}
            wire = {k: view[k] for k in wire_keys}
            sample.append_pending_wire(wire, rounds * B, count, view,
                                       ready=mark_ready(wire))
        else:
            late = [k for k in wire_keys if early is None or k not in early]
            host = fetch_to_host({k: view[k] for k in late})
            sample.append_device_batch(
                {k: (host[k] if k in host else early[k]) for k in wire_keys},
                rounds * B, count, device_view=view)
        sample.round_graph = loop.program.route == "graph"
        sample.round_replays = loop.program.replays - replays0
        if bar is not None:
            bar.finish()
        self.nr_evaluations_ = sample.nr_evaluations
        return sample

    def max_records_cap(self) -> int:
        """Recorded candidates kept per generation at most."""
        return self.max_records


class _Cursor:
    """A copy of a loop state's cursor — the accepted and record counts
    (0-d tensors, updated in place by every round) and the rounds run —
    that :meth:`restore` writes back in place.  A cursor that held the
    count tensors themselves would "restore" the values a failed attempt
    had already advanced."""

    def __init__(self, state: dict):
        self.state = state
        self.rounds = state["rounds"]
        self.counts = {k: (None if state[k] is None else state[k].clone())
                       for k in ("count", "rec_count")}

    def restore(self):
        self.state["rounds"] = self.rounds
        for k, saved in self.counts.items():
            live = self.state[k]
            if live is None:
                continue
            if saved is None:
                # allocated by the failed attempt: back to empty
                live.zero_()
            else:
                live.copy_(saved)


# The reference's local sampler flavours, as aliases: on the card every
# one of them is the vectorized rejection-round design.
class SingleCoreSampler(VectorizedSampler):
    """Alias of :class:`VectorizedSampler` for pyABC's ``SingleCoreSampler``."""


class MulticoreEvalParallelSampler(VectorizedSampler):
    """Alias of :class:`VectorizedSampler` for pyABC's
    ``MulticoreEvalParallelSampler``."""


class MulticoreParticleParallelSampler(VectorizedSampler):
    """Alias of :class:`VectorizedSampler` for pyABC's
    ``MulticoreParticleParallelSampler``."""
