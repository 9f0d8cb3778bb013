#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``pyabc_tpu_torch``) on one card.

    python3 chip_smoke.py                 # every phase, one CUDA device
    python3 chip_smoke.py --phases card,build,kernels

Phases, each printed as one JSON line and each fatal on failure:

1. ``card``    — the card's name, power limit and maximum SM clock.
2. ``build``   — create the CUDA context and compile every CUDA kernel of
   the port from its source.
   ``graphs`` (run right after) — the compiled round: for config #2 at
   the pop-16384 rung and at the pop-1e6 rung (B = 2^19), configs #3/#4
   (``lv1e5``, ``sir1e5``) at 2^19 and ``fidelitysir5e4``'s staged round,
   each from two generations of its own run on the card (whose rows must
   say ``round_graph``), the round captured as a CUDA graph against the
   eager round from one generator state, 4 rounds bit for bit (the
   first eager on the graph route too, the capture after it, then 3
   replays; every output, the buffers without their dump row, the count,
   the generator's state), then host launches and device kernels per round
   each way (``torch.profiler``), ms per round each way (CUDA events,
   median of 20), capture seconds and the graph pool's bytes; the
   loop's captured finalize at row (b)'s shape against the same work
   eager, bit for bit, with K1 launched once per replay and within 4e-4
   of the plain KDE; an ``AotGuard`` called off its spec (one counted
   miss, the eager result).  Every phase's rows carry ``round_graph``,
   and the phases of the sequential, fused, one-dispatch and pipelined
   engines on configs #2–#4 fail where a round did not replay a graph.
3. ``kernels`` — each kernel against its plain PyTorch version on the card
   at the shapes the main path gives it (tolerance ``1e-4 + 1e-5·|ref|``),
   with the kernels' own time (``kernel_only_ms``: back-to-back launches
   of a prepared call), the whole wrapper call (``call_ms``), the plain
   time (the median of 3 calls; the comparison call alone where it takes
   over a second), a one-call library yardstick computed over query
   chunks of at most 8 GB (``library_ms``, ``library_chunks``), the
   least time the card could take (``bound_ms``), and the partial
   kernel's registers and spills as ``nvcc -Xptxas -v`` reports them.
4. ``pop16384`` / ``pop1e6`` — the main path: two-Gaussian model selection
   (BASELINE config #2) through ``ABCSMC.run`` with ``MedianEpsilon`` and
   ``VectorizedSampler``, held to the analytic model posterior and mean
   (the JAX package's ``tools/verify_northstar_posterior.py`` gate), with
   the kernel's launch count read around each run.
5. ``lv1e5`` / ``sir1e5`` — BASELINE configs #3 (Lotka-Volterra SDE) and
   #4 (SIR tau-leap) at full width, pop 1e5, 8 generations, with the
   adaptive p-norm refit over the record stream each generation
   (``AdaptivePNormDistance``, ``MedianEpsilon``, batch 2^19,
   ``stores_sum_stats=False``).  Each holds every generation's ε finite
   and positive, K1 launched in every generation t >= 1, a weight fit per
   generation from at least ``pop`` rows, the posterior mean within 4
   posterior standard deviations of the generating parameters, and each
   posterior standard deviation at most 0.75 of the prior's.
6. ``petab1e5`` / ``sbml1e5`` — BASELINE config #5: exact stochastic ABC
   (``StochasticAcceptor``, ``Temperature``, the llh kernel) over ODE
   models, pop 1e5, batch 2^18.  ``petab1e5`` is the JAX package's
   ``petab_ode_pop100k`` bench row through ``ODEPetabImporter`` (one rate,
   RK4 at dt = 0.1, ``Temperature(aggregate_fun=max)``, 6 generations);
   ``sbml1e5`` imports the SBML decay model with two experimental
   conditions through ``PetabProblem`` and ``SBMLPetabImporter`` (RK4 at
   200 steps, ``Temperature()``, up to 8 generations).  Each holds the
   last temperature at 1, the temperatures non-increasing, K1's launches
   in every generation t >= 1 at the count the code gives (the finalize,
   one per record batch, and the new proposal's density when a scheme
   read the records), and the last population against the exact
   posterior, by quadrature of the model's own llh on the CPU: |mean −
   μ_q| ≤ max(1e-3, 4·σ_q/√ESS), |std/σ_q − 1| ≤ 0.05 + 4/√(2·ESS).
   ``petab1e5`` runs all 6 generations; its quadrature must read 0.685 /
   0.0523.
7. ``fused16384`` / ``fused1e6`` / ``fusedlv1e5`` / ``fusedpetab1e5`` —
   the same workloads through the fused engine, ``fuse_generations=4``:
   generation 0 seeds the device carry sequentially, then blocks of 4
   generations run with no host adaptation between them, and a tail too
   short for a block runs sequentially.  ``fused16384`` and ``fused1e6``
   hold ``run_gate``'s tolerances, and their paths must follow the
   engine's rule (a block from generation 1; a block only where 4
   generations remain; after a block short of 4 — an undershoot — the
   sequential engine redoes the next generation); ``fused16384`` runs at
   least two blocks, ``fused1e6`` hands the engine
   probe the ``pop1e6`` phase's steady seconds per generation, reports
   the engine it chose and both engines' seconds per generation, and its
   first block must run fused.  ``fusedlv1e5`` holds ``lv1e5``'s posterior
   and ε gates and needs the in-block refit's weights for generation 1 +
   K on the host; ``fusedpetab1e5`` runs ``petab1e5``'s model with
   ``Temperature(schemes=[AcceptanceRateScheme()])`` and the pdf norm from
   the kernel's analytic maximum (the eligible form of the triple) and
   holds ``petab1e5``'s temperature and quadrature gates.  Every fused
   phase also requires K1 launched in each fused generation as often as
   the code gives (one per model, twice that with the temperature solve)
   and one History row per generation; its rows carry ``path``,
   ``engine``, ``host_reads`` and ``grids_resolved``, and its blocks their
   wall, rounds and host reads.

8. ``onedispatch1e6`` / ``onedispatchpetab1e5`` — the one-dispatch engine
   (``run_mode="onedispatch"``: after generation 0 the rest of the run is
   one dispatch, the stop chain evaluated on the card after each
   generation), each run beside its fused twin (``run_mode="auto"``, the
   same seed) in the same phase.  ``onedispatch1e6`` is the JAX package's
   ``bench_onedispatch`` row: config #2 at pop 1e6, ``ConstantEpsilon(0.2)``,
   K = 4, batch 2^19 pinned, 16 rounds per call, 9 generations; it holds
   the paths to sequential then 8 × onedispatch, one dispatch, n accepted
   in every generation, every population and weight bit-identical to the
   fused twin's (generations 1–4 and 5–8 in two blocks), K1 launched
   ``kde_launches_per_gen(2, False)`` times per generation and ``rounds +
   1`` host reads per generation (the round-loop reads and one control
   read), and reports both runs' wall, the host time per generation and
   ``control_roundtrip_s`` per generation.  ``onedispatchpetab1e5`` is
   ``fusedpetab1e5`` with ``run_mode="onedispatch"``: the device stop
   chain must end the run on "temperature reached 1" at the fused twin's
   generation, with identical temperatures and populations, and hold
   ``petab1e5``'s quadrature gate.  ``lanes1e6`` is the JAX package's
   ``bench_kernel`` row: config #2 at pop 1e6 with
   ``MedianEpsilon(device_sketch=True)``, batch up to 2^19, 16 rounds
   per call, K = 4, ``run_mode="onedispatch"``, seed 0, for ``run_gate``'s
   11 generations under ``PYABC_TPU_PRECISION_LANES=bf16`` (the frozen
   policy dropped before and after, the environment restored), then its
   float32 twin.  Each arm holds ``run_gate``'s tolerances, a final ε
   below 0.05 and the sketch's error on its last weighted distances
   within ``sketch_error_bound``; K1 launches per generation equal the
   twin's; the lane was on: every stored distance of the bf16 arm is a
   bf16 value (none of the twin's is), and fresh statistics at the last
   population's parameters move under the bf16 distance by at most 2^-8
   relative from the float32 formula (not at all in the twin).

9. ``pipelined1e6`` / ``pipelinedsir1e6`` — the pipelined engine with
   lazy History rows, as ``ABCSMC``'s defaults run a device-eligible
   configuration at pop >= 2^17 (``ingest_mode="auto"``,
   ``history_mode="lazy"``).  ``pipelined1e6`` is ``run_gate``'s
   configuration exactly (config #2, pop 1e6, ``MedianEpsilon``, batch up
   to 2^19, 16 rounds per call, ``stores_sum_stats=False``, seed 0, 11
   generations): ``run_gate``'s tolerances read through hydration, one
   History row per generation, the block rows still lazy when the run
   ends and none after ``done``, paths ``pipelined`` or ``sequential``
   (the first generation and each redo after an undershoot), K1 launched
   in every generation t >= 1, and the ledger's ``rewinds``, ``overlap_s``
   and egress reported.  In the same phase the JAX package's north-star
   bench row (``ConstantEpsilon(0.2)``, 9 generations) runs four times:
   at ``ingest_depth=2`` lazy, at depth 0 lazy, at depth 2 eager, and as
   bench.py's sequential-eager control; the first three must be
   bit-identical generation by generation, ``overlap_s`` > 0 at depth 2
   and = 0 at depth 0, and the summary egress per generation is reported
   against the eager run's population egress.  ``pipelinedsir1e6`` is
   BASELINE config #4 at its own size: ``sir1e5``'s configuration at pop
   1e6 with the defaults; ``sir1e5``'s posterior, ε and launch gates, an
   in-block weight pre-seed for each block that follows a block, and the
   peak memory of every generation.

10. ``library`` / ``stats1e5`` / ``adaptivepop`` / ``local1e4`` — the
   component library a user configures.  ``library`` evaluates every
   deterministic function of it on the card and on the CPU from one
   seeded numpy input — each family's ``log_pdf``/``cdf``,
   ``TruncatedRV``, ``LowerBoundDecorator``, ``TabulatedRV``, the eight
   library distances after one adaptive update from the same records,
   ``LocalTransition.log_pdf_from_params`` given installed params, the
   weighted statistics and ``residual_weighted_choice`` — held to
   ``LIB_TOL_ABS + LIB_TOL_REL·|cpu|`` elementwise and ``LIB_TOL_REDUCE``
   relative for reductions over 1e5 rows (integer results equal); then
   1e6 draws per family from a card generator against scipy, a KS test
   (continuous) or χ² (discrete) at p > 1e-3.  ``stats1e5`` runs the JAX
   package's analytic suite (tests/test_statistical.py: cookie jar,
   beta-binomial with Beta priors, continuous non-Gaussian,
   exponential–gamma with a Gamma prior, truncated-normal prior) at pop
   1e5 per problem through ``ABCSMC.run``'s defaults, each held to its
   JAX test's own tolerance, with K1 in every generation t >= 1 of every
   model that has parameters.  ``adaptivepop`` runs config #2 with
   ``AdaptivePopulationSize(16384, mean_cv=0.01,
   max_population_size=2**18)`` for 8 generations: each generation has
   the size the strategy set, K1 runs 2 + sizes × alive models × 5 times
   per generation t >= 1 (the finalize and the bootstrap refits), and
   run_gate's tolerances hold at the last size; it reports the size and
   the adaptation's host seconds per generation.  ``local1e4`` runs
   ``lv1e5``'s model, priors and data with ``LocalTransition()`` at pop
   1e4 for 8 generations, held to ``lv1e5``'s posterior and ε gates (its
   proposal density is not K1: none launched), and reports peak memory.

11. ``fidelitysir5e4`` / ``fidelitylv5e4`` / ``capacity1e7`` — the
   multi-fidelity screen and the memory-planned carry.  The fidelity
   phases are the JAX package's ``bench_fidelity`` rows: SIR / LV at full
   width with a plain ``PNormDistance(p=2)``, pop 5e4, batch 2^18, K = 4,
   ``QuantileEpsilon(alpha=0.15)``, 2 warm-up and 3 timed generations,
   ``FidelityConfig(full_fraction=0.15, cal_rows=4096)`` against
   ``fidelity="off"``.  Gates: both arms pass configs #3/#4's posterior
   gate; the screened mean within 4·√(σ²/ESS_off + σ²/ESS_screen) of the
   unscreened one; every generation after the first a device generation
   of the staged round, with ``sims_full`` = rounds × slots ≤
   ``sims_low`` = rounds × B; the first screened generation (a fresh
   carry's NaN rings: no acceptable pair) at threshold +inf; the paired
   audit (2048 final particles through both fidelities, the numpy
   calibrator at the final ε) with a false-reject rate ≤ q + 3·√(q(1 −
   q)/n_acceptable), q = 0.02.  They report accepted/s of both arms over
   the timed generations and over the timed generations whose threshold
   was finite, the speedup, full simulations per accepted particle, the
   screen rate, each stage's simulator launches per round, each screened
   generation's threshold with the acceptable pairs and the correlation
   it was calibrated from, and each block's rounds beside its round
   caps.  ``capacity1e7`` is the JAX package's ladder program on one
   card: config #4 at pop 1e7 (batch 2^22), one dispatch, lazy History,
   K = 4, ``MedianEpsilon``, 1 + 3 generations,
   ``PYABC_TPU_CARRY_PRECISION=auto`` under a budget halfway
   between the port's own f32 and bf16 minima.  Gates: f32 infeasible
   there, the run completes narrowed, the plan and the measured peak
   (``torch.cuda.max_memory_allocated`` over the dispatch) within the
   budget, the stop and the posterior gate as an f32 twin's with no
   budget set (whose plan fits unclamped), the means within 4·√2
   run-to-run spreads of the twin's (``CAPACITY_SPREAD``, measured by
   ``--phases capacityspread``; the 4·√(σ²/ESS) bound of one run's last
   generation is reported too), and the run's codec within half a
   quantum on its last population on the card; it reports the
   prediction's error in percent.

12. ``telemetry1e6`` / ``chaos1e6`` / ``recover1e6`` / ``cudafaults`` —
   the run infrastructure.  ``telemetry1e6`` runs ``onedispatch1e6``'s
   configuration with lanes off, with lanes on and a trace, the fused
   twin with lanes on, and lanes off again: populations bit-identical,
   host reads = rounds + 1, ``tl_sims`` = rounds · B on every device row,
   the phase attribution summing to the wall within 1e-9, the progress
   word naming the last generation with its ε and count, the trace's
   ``run``/``calibrate``/dispatch/ingest/append spans, the registry's
   d2h bytes equal to the ledger's, and the lanes and the generator's
   state save/restore free of host syncs.  ``chaos1e6`` runs the
   pipelined defaults at pop 1e6 (ε 0.2, 9 generations) clean and under
   (a) one dispatch fault (bit-identical, fired once), (b) a fetch and an
   append fault (retries, full rows), (c) three faults on the third block
   dispatch's attempts (found in a probe run): ``RetryExhausted``, the
   sequential engine finishes the run, a flight dump, the durable prefix
   bit-identical and p(B) within 2·max(2.5e-3, 2.5/√pop) of the clean
   run's; and (d) ``run.drain@2`` on the one-dispatch engine against its
   clean twin (the latch, the JAX package's paths, the same prefix and
   p(B) gates).  ``recover1e6`` kills (-9) a child running ``run_gate``'s
   configuration with lazy rows and a one-generation ring at its second
   materialize: the victim lives only in the journal, ``load`` replays it
   and compacts the journal, and the resumed run passes ``run_gate``;
   then a child on the sequential engine with a sub-checkpoint per call of
   one round is SIGTERM'd at the second call of generation 1: ``Preempted``,
   1 ≤ n < pop rows flushed, the resume splices them with their
   evaluations counted once.  ``cudafaults`` (a) caps the process with
   ``torch.cuda.set_per_process_memory_fraction`` on the sequential
   engine's default route (captured rounds), between what its run at
   batch 2^21 reserved before its second generation (and what an eager
   run at 2^20 reserved) and what that second generation holds at once:
   the OOM is retried, the batch halved, the graphs dropped, the
   generation restarted eagerly, the run completed, with ``round_graph``
   true on every row before the drop and false after it; (b) a child
   whose model gathers out of bounds inside a one-dispatch run: one
   attempt, sticky, no retry or latch, a non-zero exit naming the
   device-side assert.  Every other
   phase must leave the retry and degradation counters where they were.

13. ``quickstart1e4`` / ``envknobs1e6`` / ``refexport1e5`` /
   ``hostsamplers`` / ``aggregatedlv1e5`` — the reference-compatible
   surface.  ``quickstart1e4`` runs the port README's quick start
   (BASELINE config #1 at pop 1e4 through ``DefaultSampler()``,
   ``show_progress=True``, 8 generations, ``minimum_epsilon=0.01``)
   beside its twin without the bar: tests/test_e2e_slice.py's posterior
   gate, the populations bit-identical, the same host reads (every
   synchronizing call under ``torch.cuda.set_sync_debug_mode("warn")``,
   per sampler call and in all), bar lines on stderr.  ``envknobs1e6``
   runs ``onedispatch1e6``'s configuration for 17 generations with no
   engine arguments under ``PYABC_TPU_RUN_MODE=onedispatch`` and
   ``PYABC_TPU_ONEDISPATCH_MAX_T=8`` against the twin that passes them
   (bit-identical, ceil(16 / 8) dispatches), then with lazy rows under ``PYABC_TPU_LAZY_FINAL_ONLY=1``
   (of the one-dispatch generations only the last gets blobs; generation
   0, hydrated during the run, has them already).  ``refexport1e5`` runs config
   #2 at pop 1e5 for 4 generations with eager rows (no summary
   statistics, as ``run_gate`` stores them), exports it with
   ``to_reference_db`` (the layout of tests/test_reference_export.py, one
   particle, parameter and sample row per particle) and reads it back
   with ``History.from_reference_db``: θ, weights, distances, model
   probabilities and ε equal bit for bit; it reports the export's and
   import's seconds and rows.  ``hostsamplers`` runs config #2 through
   ``ConcurrentFutureSampler`` and ``DaskDistributedSampler`` (over a
   thread-pool client; 4 jobs, 1024 candidates a task) at pop 1000 for
   9 generations (``run_gate``'s 11 cut by two: the last two held ~2 850
   of a run's ~3 700 tasks), each against ``run_gate``'s tolerances at
   that pop and
   again with the seed for 6 generations (bit-identical to the first
   run's), and through
   ``MappingSampler(map_=map)`` at pop 100 for 3 generations (max_t >= 1,
   model probabilities summing to 1); in every run each generation t >= 1
   launches K1 M × its tasks (a task's round evaluates the proposal
   density in the round, once per model).  ``aggregatedlv1e5`` runs
   ``lv1e5`` with ``AggregatedTransition({(0, 2): MVN, (2, 4): MVN})``:
   ``lv1e5``'s gates, the sequential engine, and K1 launched twice per
   generation t >= 1 (once per block), each at d = 2.  The SGE mapper
   (``pyabc_tpu_torch.sge``) maps host functions in processes of their
   own and is tested on the CPU only.

14. ``analysis1e6`` — looking at a run.  ``onedispatch1e6``'s
   configuration with lazy rows in a database file, under a run
   directory (``PYABC_TPU_RUN_DIR``), ``PYABC_TPU_SUMMARY_GRID=1`` and a
   0.05 s progress poll, beside its twin without them (another file):
   the one-dispatch gates, the populations bit-identical; the run
   directory read back: one host, a trajectory naming every generation
   of the timeline, at least one snapshot written while the dispatch was
   in flight naming a generation past its first, ``fleet_rollup`` and
   ``render_prometheus`` parsed; every lazy row the sequential site
   wrote holds a grid of at most 2^14 cells whose masses sum to 1 within
   1e-5 and whose centroid mean is the population's weighted mean
   within 1e-4 (the one-dispatch rows hold none, as in the JAX package).
   Then ``sir1e5``'s configuration, and on the card against
   ``device="cpu"`` on the same History: ``kde_1d`` (fixed scaling) on
   each model's last population, ``compute_kde_max`` (the same point, or
   densities equal within the tolerance), ``kde_2d`` on the SIR
   population, each within ``TOL_ABS + TOL_REL·|cpu|`` and one K1
   launch; the CV default (a scaling from its grid, finite non-negative
   densities, grid × bootstraps + 1 launches).  Last the viewer, served
   from a thread (``run_app(port=0, blocking=False)``): ``/api/runs``,
   ``/api/run/1``, ``/api/kde``, ``/api/fleet``, ``/metrics``,
   ``/abc/1`` and a population page each 200 and parsed, ``/api/kde``
   against ``kde_1d``, ``/plot`` a PNG where matplotlib is installed
   (``"matplotlib"`` in the line says whether).  It reports each call's
   and route's milliseconds and launches and the snapshots seen.  The
   twin writes under ``PYABC_TPU_WIRE_CODEC=raw`` (``.npy`` blobs) and
   still reads back bit-identical; ``codec`` reports the History write
   seconds per generation and the database's bytes with the PTW1 codec
   and with ``raw``, the run's populations appended again to a fresh
   file under each.

15. ``serve1e4`` / ``servecb`` — the serving path (``serve/``).
   ``serve1e4`` is bench.py's ``bench_serve`` mix through one
   ``ServeWorker`` on the card: a pop-1e4 study warms the solo
   one-dispatch engine, a second runs on the renewed engine (zero
   program builds, at least one ladder hit), then four pop-100 and three
   pop-1000 studies (the study axis) and three duplicates are served
   from the queue.  Gates: every study served, the duplicates from the
   cache with no build and no K1 launch, every lane bit-identical to the
   same spec as a batch of one on the card, every posterior mean within
   0.15 of y, K1 once per lane and successful generation and once per
   one-dispatch generation of the solo engine.  It reports studies/s,
   p50/p99 study wall, the cache and ladder counters, K1 launches.
   ``servecb`` is ``bench_serve_cb``'s workload: 96 pop-100 studies of
   one batch key (three 2-generation to one 12-generation) submitted from
   a thread at seeded Poisson arrivals of 100 Hz to a worker thread, with
   ``PYABC_TPU_SERVE_CB`` 0 then 1 (multiplex 8, window 2), then the
   fixed-shape probe (three turnovers, no build).  Gates: no failed
   study, three sampled lanes bit-identical to fresh batches of one, the
   12-generation studies' means within 4 standard errors + 0.05 of the
   analytic posterior mean y/2, K1 once per lane and successful
   generation.  It reports tombstone-to-submit p50/p99 for both arms,
   turnovers, windows and occupancy.

Every phase of items 4–8 pins ``history_mode="eager"``, and every run at
pop 1e6 among them ``ingest_mode="sequential"``, so that each measures
the engine it did before the pipeline and the lazy rows became the
defaults; ``onedispatch1e6`` adds a third one-dispatch run with lazy rows
whose hydrated populations must equal the eager runs' bit for bit.

The ``kernels`` phase runs last: its row (g) takes config #5's record
shape [records × support] from the ``petab1e5`` run's timeline, rows (h),
(i) and (j) the capped shapes of ``fused1e6``, ``fusedlv1e5`` and
``pipelinedsir1e6``, row (k) the largest bootstrap density of
``adaptivepop``, row (l) the largest finalize of ``stats1e5``, rows (m),
(n) and (o) the finalize of ``fidelitysir5e4``, ``fidelitylv5e4`` and
``capacity1e7``, row (p) one ``hostsamplers`` task's proposal density
[1024 × support], row (q) an ``aggregatedlv1e5`` block's finalize at
d = 2, and rows (r)–(u) ``analysis1e6``'s densities: the viewer's
``/api/kde`` grid, ``compute_kde_max``, ``kde_2d`` and the CV default's
bootstrap, rows (v)–(x) a study-axis lane's importance weights at pop
100, 1000 and 4096 and row (y) ``serve1e4``'s solo finalize (stated
default shapes without those runs).

Opt-in phases (``--phases``, not in the default run): ``profile``
profiles the slowest generation of the pop-1e6 run with
``torch.profiler``: device time by kernel and the device's idle share.
``simprof`` does the same for the last generation of ``lv1e5`` and
``sir1e5``, then runs one more generation with the simulator timed
between device syncs (its share of ``sample_s``), and profiles one
simulator call at the batch size (device time, kernel launches, the
unprofiled call's wall); for ``petab1e5`` and ``sbml1e5`` it profiles
one simulator call at batch 2^18.
Timeline rows carry each generation's peak device memory
(``peak_mem_gb``); a phase reports the largest.  ``k1perm`` times K1 at
the pop-1e6 finalize shape on the sorted grid support and on the same
rows permuted: with no branch on the data the two take the same time.
``repeat`` counts, over 50 calls at four sizes, how often a 1-D float
``torch.cumsum`` and ``ops.choice.ordered_cumsum`` give another result
than their first call, then runs ``fused16384``'s configuration over
seeds 0-19 and reports each run's last ESS, p(B) − analytic and paths.
``capacity1e8`` plans ``capacity1e7``'s configuration at the JAX row's
nominal pop 1e8 (batch 2^24) under the card's own budget and runs 1 + 2
generations if the plan fits, else reports the ``CapacityError`` with its
ledger.  ``capacityspread`` runs ``capacity1e7``'s configuration with no
budget in float32 and bf16 at seeds 0-2 and reports the spread of the
posterior means, at each run's last ε and at the smallest of them.
``serveprof`` profiles one window of 8 study-axis lanes (device time by
kernel, idle share, launches per lane generation).  ``laddermem`` runs
``envknobs1e6`` and ``chaos1e6`` with the sampler's ladder at 4 and at
16 entries and reports each arm's ``max_memory_allocated`` and the most
engines a ladder held.
``hostprof`` times a ``ConcurrentFutureSampler`` task's round and whole
task with 1, 4 and again 1 job in flight (config #2, pop 1000, 8
generations).

The ``kernels`` summary line (K1, and K1 inside the captured finalize:
its launches by graph replays on the main path, its times from the
``graphs`` phase) and the ``nvidia-smi`` name/power-limit
line come just before the last line, which is ``{"ok": true, "device":
{...}}``.  The script imports nothing of JAX or of the JAX package, exits
non-zero without a result when no CUDA device is present, and builds the
kernels itself.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ALL_PHASES = ("card", "build", "graphs", "pop16384", "pop1e6", "lv1e5", "sir1e5",
              "petab1e5", "sbml1e5", "fused16384", "fused1e6", "fusedlv1e5",
              "fusedpetab1e5", "onedispatch1e6", "lanes1e6",
              "onedispatchpetab1e5",
              "pipelined1e6", "pipelinedsir1e6", "library", "stats1e5",
              "adaptivepop", "local1e4", "fidelitysir5e4", "fidelitylv5e4",
              "capacity1e7", "telemetry1e6", "chaos1e6", "recover1e6",
              "cudafaults", "quickstart1e4", "envknobs1e6", "refexport1e5",
              "hostsamplers", "aggregatedlv1e5", "analysis1e6", "serve1e4",
              "servecb", "sharded1e6", "pod1e5", "sched1e4", "kernels")
#: opt-in phases (``--phases``): not part of the default smoke
EXTRA_PHASES = ("profile", "simprof", "k1perm", "repeat", "capacity1e8",
                "capacityspread", "hostprof", "laddermem", "serveprof",
                "detprof")
TOL_ABS = 1e-4
TOL_REL = 1e-5
#: largest [M, N] float32 block the library yardstick may materialize
LIBRARY_MAX_BYTES = 8e9


def emit(obj: dict):
    print(json.dumps(obj), flush=True)


def smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()[0]


def time_cuda(torch, fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` calls, each timed with
    CUDA events after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------- phases


def phase_card(torch, state):
    name_limit = smi("name,power.limit")
    clock = smi("clocks.max.sm")
    state["smi"] = name_limit
    state["sm_clock_hz"] = float(clock.split()[0]) * 1e6
    emit({"phase": "card", "ok": True, "nvidia_smi": name_limit,
          "clocks_max_sm": clock, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})


def phase_build(torch, state):
    from pyabc_tpu_torch.ops import _build
    # the process's CUDA context is made here, not inside the first
    # main-path phase's timed run
    torch.ones(1, device="cuda").sum().item()
    t0 = time.perf_counter()
    built = _build.build_all()
    report = {name: _build.ptxas_report(info["ptxas"])
              for name, info in built.items()}
    state["ptxas"] = report.get("kde_logpdf")
    emit({"phase": "build", "ok": True,
          "seconds": time.perf_counter() - t0,
          "built": sorted(built), "ptxas": report})


def _partial_regs(state, d: int):
    """Registers and spill bytes of the partial kernel's template for d."""
    name = (f"kde_partial_kernel<{d},1>" if d <= 8
            else "kde_partial_kernel<32,0>")
    for row in state.get("ptxas") or []:
        if row["function"] == name:
            return {"function": name, "registers": row["registers"],
                    "stack": row["stack"],
                    "spill_stores": row["spill_stores"],
                    "spill_loads": row["spill_loads"]}
    return None


def time_loop(torch, fn, reps: int, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn()`` over ``reps`` back-to-back calls
    between two CUDA events: the device's time when the host keeps it
    fed, without the host's per-call work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def library_logsumexp_ms(torch, kde_plain, c, reps: int = 3) -> dict:
    """One-call yardstick: ``torch.logsumexp(z_x @ z_s.T + b_s, 1)`` on
    pre-whitened inputs, over query chunks whose ``[chunk, N]`` block
    stays within ``LIBRARY_MAX_BYTES``; the chunks' times are summed."""
    args = (c["x"], c["support"], c["log_w"], c["chol"])
    z_x, z_s = kde_plain.whiten(*args)
    b_s = c["log_w"] - 0.5 * (z_s * z_s).sum(1)
    a_x = 0.5 * (z_x * z_x).sum(1)
    rows = max(1, int(LIBRARY_MAX_BYTES // (4 * c["n"])))

    def run():
        for q0 in range(0, c["m"], rows):
            torch.logsumexp(z_x[q0:q0 + rows] @ z_s.T + b_s, 1) \
                - a_x[q0:q0 + rows] + c["log_norm"]

    ms = time_cuda(torch, run, reps=reps)
    return {"library_ms": ms, "library_chunks": -(-c["m"] // rows)}


def _kde_case(torch, gen, dev, label, m, n, d, pad_frac=0.0,
              grid=False, pad_last_tile=False, uniform=False):
    """Inputs of one K1 comparison, made on the card from ``gen``."""
    f32 = torch.float32
    if uniform:
        # the fused engine's capped support: n rows resampled from the
        # population, each at log weight -log n, Silverman bandwidth
        support = torch.randn(n, d, generator=gen, device=dev)
        x = torch.randn(m, d, generator=gen, device=dev)
        log_w = torch.full((n,), -math.log(n), device=dev)
        h = (4.0 / (n * (d + 2.0))) ** (1.0 / (d + 4.0))
        chol = torch.eye(d, device=dev, dtype=f32) * h
    elif grid:
        # grid-compressed 1-D support (transition _compress_support):
        # cell centroids over the posterior's range, Gaussian cell mass,
        # empty cells at -1e30; bandwidth = 64 cells
        centers = torch.linspace(-1.0, 3.0, n, device=dev, dtype=f32)
        support = centers[:, None].contiguous()
        mass = torch.exp(-0.5 * ((centers - 1.0) / 0.4) ** 2)
        mass = mass * (torch.rand(n, generator=gen, device=dev) > 0.1)
        log_w = torch.where(mass > 0, torch.log(mass / mass.sum()),
                            torch.full_like(mass, -1e30))
        h = 64 * 4.0 / n
        x = 1.0 + 0.4 * torch.randn(m, 1, generator=gen, device=dev)
        chol = torch.full((1, 1), h, device=dev, dtype=f32)
    else:
        support = torch.randn(n, d, generator=gen, device=dev)
        x = torch.randn(m, d, generator=gen, device=dev)
        log_w = torch.log_softmax(
            0.3 * torch.randn(n, generator=gen, device=dev), 0)
        # Silverman bandwidth of a unit-variance population of n points
        h = (4.0 / (n * (d + 2.0))) ** (1.0 / (d + 4.0))
        chol = torch.eye(d, device=dev, dtype=f32) * h
        n_pad = int(round(pad_frac * n))
        if n_pad:
            # pad_params: zero support rows carrying log_w = -1e30
            support[n - n_pad:] = 0.0
            log_w[n - n_pad:] = -1e30
        if pad_last_tile:
            log_w[(n // 256 - 1) * 256:] = -1e30
    log_norm = float(-0.5 * d * math.log(2 * math.pi)
                     - torch.log(torch.diagonal(chol)).sum().item())
    return {"label": label, "x": x, "support": support, "log_w": log_w,
            "chol": chol, "log_norm": log_norm, "m": m, "n": n, "d": d}


KDE_CASES = [
    ("a pop16384 finalize", 16384, 16384, 1, {"pad_frac": 0.2}),
    ("b pop1e6 grid 2^13", 1_000_000, 8192, 1, {"grid": True}),
    ("b pop1e6 grid 2^14", 1_000_000, 16384, 1, {"grid": True}),
    ("b pop1e6 grid 2^16", 1_000_000, 65536, 1, {"grid": True}),
    ("c 65536^2 d=2", 65536, 65536, 2, {}),
    ("c 65536^2 d=5", 65536, 65536, 5, {}),
    ("d ragged d=3", 1000, 1537, 3, {"pad_last_tile": True}),
    # the adaptive workloads' finalize: one model, so the support is the
    # whole previous population of 1e5 rows (ABCSMC._pad_bucket caps the
    # power-of-two bucket at the population: no pad rows)
    ("e lv1e5 finalize d=4", 100_000, 100_000, 4, {}),
    ("f sir1e5 finalize d=2", 100_000, 100_000, 2, {}),
]
#: row (g) without a petab1e5 run: two rounds of 2^18 candidates against
#: the smallest grid-compressed support
RECORD_SHAPE_DEFAULT = (1 << 19, 8192)


def record_case(state) -> tuple:
    """Row (g): config #5's record density, [records × support] at d = 1
    over the grid-compressed support, from the petab1e5 run's generation
    with the most records."""
    m, n = state.get("petab_record_shape", RECORD_SHAPE_DEFAULT)
    source = "petab1e5" if "petab_record_shape" in state else "default"
    return (f"g petab1e5 records ({source})", m, n, 1, {"grid": True})


def fused_cases(state) -> list:
    """Rows (h), (i) and (j): a device block's proposal density above the
    support cap — every query against 2^14 uniform-weight rows — at the
    fused1e6 (d = 1), fusedlv1e5 (d = 4) and pipelinedsir1e6 (d = 2)
    phases' shapes, or at these stated defaults without those runs."""
    out = []
    for label, key, default in (
            ("h fused1e6 capped", "fused_main_shape",
             (1_000_000, 1 << 14, 1)),
            ("i fusedlv1e5 capped", "fused_lv_shape", (100_000, 1 << 14, 4)),
            ("j pipelinedsir1e6 capped", "pipelined_sir_shape",
             (1_000_000, 1 << 14, 2))):
        m, n, d = state.get(key, default)
        source = "run" if key in state else "default"
        out.append((f"{label} ({source})", m, n, d, {"uniform": True}))
    return out


#: rows (k) and (l) without their runs: a bootstrap refit at pop 2^17
#: (model B's share of 2^18 rows, grid-compressed) and a finalize of the
#: analytic suite at pop 1e5 (one model, the 8192-cell grid)
BOOT_SHAPE_DEFAULT = (104_858, 8192, 1)
STATS_SHAPE_DEFAULT = (100_000, 8192, 1)


def library_cases(state) -> list:
    """Rows (k) and (l): the adaptivepop phase's largest bootstrap
    density (its particles as queries against a refit on nn·w_m rows,
    grid-compressed to a power of two of >= 8192 cells from 2^14 rows on)
    and the stats1e5 phase's largest finalize (the beta-binomial runs
    none: under its JAX test's schedule, MedianEpsilon(0.1) against
    minimum_epsilon 0.2, it stops after generation 0), from the runs or
    at the stated defaults."""
    out = []
    for label, key, default in (
            ("k adaptivepop bootstrap", "adaptivepop_boot_shape",
             BOOT_SHAPE_DEFAULT),
            ("l stats1e5 finalize", "stats_finalize_shape",
             STATS_SHAPE_DEFAULT)):
        m, n, d = state.get(key, default)
        source = "run" if key in state else "default"
        grid = d == 1 and n >= 8192 and n & (n - 1) == 0
        out.append((f"{label} ({source})", m, n, d,
                    {"grid": True} if grid else {"uniform": True}))
    return out


def fidelity_capacity_cases(state) -> list:
    """Rows (m), (n) and (o): the fidelitysir5e4, fidelitylv5e4 and
    capacity1e7 phases' finalize density, the population against the
    uniform-weight capped support (2^14 rows; 2^11 in capacity1e7), from
    the runs or at these stated defaults."""
    out = []
    for label, key, default in (
            ("m fidelitysir5e4 capped", "fidelitysir5e4_shape",
             (FID_POP, 1 << 14, 2)),
            ("n fidelitylv5e4 capped", "fidelitylv5e4_shape",
             (FID_POP, 1 << 14, 4)),
            ("o capacity1e7 capped", "capacity1e7_shape",
             (CAPACITY_POP, 1 << 11, 2))):
        m, n, d = state.get(key, default)
        source = "run" if key in state else "default"
        out.append((f"{label} ({source})", m, n, d, {"uniform": True}))
    return out


def host_aggregated_cases(state) -> list:
    """Rows (p) and (q): one host-sampler task's in-round proposal
    density (its candidates against a model's padded support, d = 1) and
    an ``AggregatedTransition`` block's finalize on LV (the population
    against the previous one on two of the four columns), from the
    hostsamplers and aggregatedlv1e5 runs or at these stated defaults."""
    out = []
    for label, key, default in (
            ("p hostsamplers task", "hostsampler_task_shape",
             (1024, 1024, 1)),
            ("q aggregatedlv1e5 block", "aggregated_block_shape",
             (100_000, 100_000, 2))):
        m, n, d = state.get(key, default)
        source = "run" if key in state else "default"
        out.append((f"{label} ({source})", m, n, d, {}))
    return out


def analysis_cases(state) -> list:
    """Rows (r)-(u): the analysis1e6 phase's densities — the viewer's
    /api/kde slider grid and the posterior mode against the
    grid-compressed 1-D support, ``kde_2d``'s 50 x 50 mesh against the
    SIR population, the CV default's bootstrap (the population against a
    refit's grid) — from the run or at these stated defaults."""
    out = []
    for label, key, default in (
            ("r analysis /api/kde", "analysis_api_kde_shape",
             (ANALYSIS_KDE_GRID, 8192, 1)),
            ("s analysis compute_kde_max", "analysis_kde_max_shape",
             (190_000, 8192, 1)),
            ("t analysis kde_2d", "analysis_kde_2d_shape",
             (2500, ADAPTIVE_POP, 2)),
            ("u analysis CV bootstrap", "analysis_cv_shape",
             (810_000, 8192, 1))):
        m, n, d = state.get(key, default)
        source = "run" if key in state else "default"
        grid = d == 1 and n >= 8192 and n & (n - 1) == 0
        out.append((f"{label} ({source})", m, n, d,
                    {"grid": True} if grid else {}))
    return out


def phase_kernels(torch, state):
    from pyabc_tpu_torch.ops import kde as kde_plain
    from pyabc_tpu_torch.ops import kde_cuda

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)
    rows = []
    ok_all = True
    for label, m, n, d, kw in (KDE_CASES + [record_case(state)]
                               + fused_cases(state) + library_cases(state)
                               + fidelity_capacity_cases(state)
                               + host_aggregated_cases(state)
                               + analysis_cases(state)
                               + serve_cases(state) + pod_cases(state)):
        kw = dict(kw)
        main_launches = kw.pop("main_launches", None)
        c = _kde_case(torch, gen, dev, label, m, n, d, **kw)
        args = (c["x"], c["support"], c["log_w"], c["chol"], c["log_norm"])
        got = kde_cuda.weighted_kde_logpdf_cuda(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ref = kde_plain.weighted_kde_logpdf(*args)
        end.record()
        torch.cuda.synchronize()
        ref_ms = start.elapsed_time(end)
        err = (got - ref).abs()
        finite = bool(torch.isfinite(got).all() and torch.isfinite(ref).all())
        ok = finite and bool((err <= TOL_ABS + TOL_REL * ref.abs()).all())
        call_ms = time_cuda(torch, lambda: kde_cuda.weighted_kde_logpdf_cuda(
            *args), reps=10, warmup=2)
        call = kde_cuda.KdeCall(*args)
        kernel_only_ms = time_loop(torch, call.run, reps=20)
        # where the plain version takes seconds (rows (j), (o)) its time
        # is the comparison call's; else the median of 3 after it
        plain_ms = (ref_ms if ref_ms > 1000.0 else time_cuda(
            torch, lambda: kde_plain.weighted_kde_logpdf(*args), reps=3,
            warmup=0))
        lib = library_logsumexp_ms(torch, kde_plain, c)
        bound_ms = 1e3 * kde_cuda.bound_seconds(m, n, d,
                                                state["sm_clock_hz"])
        chunk, splits = kde_cuda.split_plan(m, n, d)
        row = {"phase": "kernels", "kernel": "kde_logpdf", "shape": label,
               "M": m, "N": n, "d": d, "ok": ok,
               "max_abs_err": float(err.max()),
               "kernel_only_ms": kernel_only_ms, "call_ms": call_ms,
               "plain_ms": plain_ms, **lib,
               "bound_ms": bound_ms, "bound_by": "operations",
               "bound_share": bound_ms / kernel_only_ms,
               "pairs_per_s": m * n / (kernel_only_ms * 1e-3),
               "chunk": chunk, "splits": splits,
               "partial_kernel": _partial_regs(state, d),
               "launches": main_launches}
        emit(row)
        rows.append(row)
        ok_all = ok_all and ok
        del c, args, got, ref, err, call
        torch.cuda.empty_cache()
    state["kernel_rows"] = rows
    if not ok_all:
        raise RuntimeError("K1 disagrees with its plain version")


def phase_k1perm(torch, state):
    """K1 at the main path's pop-1e6 finalize shape, on the sorted grid
    support and on the same support rows (and log weights) permuted by one
    fixed random permutation.  The sum is the same up to order; the time
    difference is what the sorted rows' rising maxima cost."""
    from pyabc_tpu_torch.ops import kde as kde_plain
    from pyabc_tpu_torch.ops import kde_cuda

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)
    c = _kde_case(torch, gen, dev, "b pop1e6 grid 2^13", 1_000_000, 8192, 1,
                  grid=True)
    perm = torch.randperm(c["n"], generator=gen, device=dev)
    sorted_args = (c["x"], c["support"], c["log_w"], c["chol"],
                   c["log_norm"])
    perm_args = (c["x"], c["support"][perm].contiguous(),
                 c["log_w"][perm].contiguous(), c["chol"], c["log_norm"])
    ref = kde_plain.weighted_kde_logpdf(*sorted_args)
    errs = {}
    for key, args in (("sorted", sorted_args), ("permuted", perm_args)):
        got = kde_cuda.weighted_kde_logpdf_cuda(*args)
        errs[key] = float((got - ref).abs().max())
        ok = bool(torch.all((got - ref).abs()
                            <= TOL_ABS + TOL_REL * ref.abs()))
        if not ok:
            raise RuntimeError(f"K1 on the {key} support disagrees")
    times = {"sorted": [], "permuted": []}
    for key in ("sorted", "permuted", "permuted", "sorted"):
        args = sorted_args if key == "sorted" else perm_args
        times[key].append(time_cuda(
            torch, lambda: kde_cuda.weighted_kde_logpdf_cuda(*args),
            reps=10, warmup=2))
    sorted_ms = statistics.mean(times["sorted"])
    permuted_ms = statistics.mean(times["permuted"])
    emit({"phase": "k1perm", "ok": True, "shape": c["label"],
          "M": c["m"], "N": c["n"], "max_abs_err": errs,
          "sorted_ms": sorted_ms, "permuted_ms": permuted_ms,
          "sorted_ms_runs": times["sorted"],
          "permuted_ms_runs": times["permuted"],
          "sorted_over_permuted": sorted_ms / permuted_ms})


def run_main_path(torch, pop: int, gens: int, seed: int = 0, fuse: int = 1,
                  seq_probe_s=None, sampler=None, keep=None) -> dict:
    """Config #2 through the port's entry points on the card, held to the
    analytic posterior as the JAX package's ``run_gate`` holds it;
    ``fuse`` K > 1 runs fused blocks, ``seq_probe_s`` hands the engine
    probe a sequential baseline (seconds per generation).  The classic
    loop and eager rows are pinned (the pipelined1e6 phase runs the
    defaults).  ``sampler`` replaces the ``VectorizedSampler``; a
    ``keep`` dict receives the run's ``abc``."""
    import numpy as np

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import make_two_gaussians_problem
    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda

    models, priors, distance, observed, posterior_fn = \
        make_two_gaussians_problem()
    if sampler is None:
        sampler = pt.VectorizedSampler(max_batch_size=1 << 19,
                                       max_rounds_per_call=16, device="cuda")
    abc = pt.ABCSMC(
        models, priors, distance, population_size=pop,
        eps=pt.MedianEpsilon(), sampler=sampler,
        stores_sum_stats=False, fuse_generations=fuse, seed=seed,
        ingest_mode="sequential", history_mode="eager", device="cuda")
    abc.new("sqlite://", observed)
    if keep is not None:
        keep["abc"] = abc
    if seq_probe_s is not None:
        abc._note_sequential_gen_s(seq_probe_s)
    weighted_kde_logpdf_cuda.launches = 0
    t0 = time.perf_counter()
    abc.run(max_nr_populations=gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = weighted_kde_logpdf_cuda.launches
    t = abc.history.max_t
    p_b = float(abc.history.get_model_probabilities(t).get(1, 0.0))
    p_true = float(posterior_fn(1.0))
    df, w = abc.history.get_distribution(m=1, t=t)
    mu = float(np.sum(df["mu"].to_numpy() * w)) if len(df) else math.nan
    tol_p = max(2.5e-3, 2.5 / pop ** 0.5)
    tol_mu = max(3e-3, 3.0 / pop ** 0.5)
    rows = abc.timeline
    launches_ok = all(r["kde_launches"] >= 2 for r in rows if r["t"] >= 1)
    gate_ok = abs(p_b - p_true) < tol_p and abs(mu - 1.0) < tol_mu
    graph_ok = graphs_ok(rows) if sampler is None else True
    gens_run = t + 1
    return {
        "pop": pop, "gens_asked": gens, "gens_run": gens_run,
        "ok": bool(gate_ok and launches_ok and gens_run == gens
                   and graph_ok and math.isfinite(p_b)
                   and math.isfinite(mu)),
        "gate_ok": bool(gate_ok), "launches_ok": bool(launches_ok),
        "round_graph_ok": bool(graph_ok),
        "p_model_b": p_b, "p_analytic": p_true, "tol_p": tol_p,
        "mu_b": mu, "tol_mu": tol_mu, "kde_launches": launches,
        "wall_s": wall,
        "final_eps": float(abc.history.get_all_populations().epsilon.iloc[-1]),
        "peak_mem_gb": max(r["peak_mem_gb"] for r in rows),
        "generations": [
            {**generation_row(r), "accepted_per_s": r["n"] / r["wall_s"]}
            for r in rows],
        **(fused_report(abc, rows) if fuse > 1 else {}),
    }


def generation_row(r: dict) -> dict:
    """One timeline row for the smoke's output: a fused generation's wall
    is its block's wall over the block's generations, its sample_s the
    block's device loop (before the host copies); a sequential
    generation's host_s is its wall less its sampling."""
    keys = ("t", "path", "engine", "wall_s", "sample_s", "eps",
            "evaluations", "acceptance_rate", "ess", "batch",
            "kde_launches", "kde_support", "peak_mem_gb", "compute_s",
            "d2h_s", "overlap_s", "history_mode", "round_graph",
            "round_replays")
    out = {k: r[k] for k in keys}
    if r["path"] in ("fused", "onedispatch", "pipelined"):
        out.update({k: r[k] for k in ("rounds", "host_reads",
                                       "grids_resolved")})
    else:
        out["host_s"] = r["wall_s"] - r["sample_s"]
    return out


def graphs_ok(rows) -> bool:
    """Every generation's rounds replayed a captured CUDA graph (a
    refused capture runs its rounds eagerly and reads False)."""
    rows = list(rows)
    return bool(rows) and all(r.get("round_graph") is True for r in rows)


def wire_per_gen(abc) -> list:
    """Each generation's device-to-host copy from the run's wire ledger
    (``ABCSMC.generation_transfer``): bytes and seconds, the port's own
    numbers behind the f16 wire codec it does not port."""
    return [{"t": t, "d2h_bytes": tr.get("d2h_bytes"),
             "d2h_s": tr.get("d2h_s")}
            for t, tr in sorted(abc.generation_transfer.items())]


def fused_report(abc, rows) -> dict:
    """The fused blocks of a run (``ABCSMC.blocks``: every block run,
    those that wrote nothing included) and the gates every fused phase
    shares: K1 launched in each fused generation the number of times the
    code gives (one per model for the proposal density, one more per
    model for the temperature solve) — K times that per block, whose
    generations all run — one History row per generation, and paths that
    follow the engine's rule."""
    from pyabc_tpu_torch.sampler.fused import kde_launches_per_gen

    per_gen = kde_launches_per_gen(abc.M, abc._block_mode()["stoch"])
    K = abc.fuse_generations
    fused = [r for r in rows if r["path"] == "fused"]
    pops = abc.history.get_all_populations()
    ts = [r["t"] for r in rows]
    n = abc.population_strategy(0)
    paths = [r["path"] for r in rows]
    checks = {
        "fused_ran": bool(fused),
        "fused_launches": (all(r["kde_launches"] == per_gen for r in fused)
                           and all(b["kde_launches"] == K * per_gen
                                   for b in abc.blocks)),
        "history_rows": (ts == list(range(len(rows)))
                         and list(pops.t) == [-1] + ts
                         and all(len(abc.history.get_population(t)) == n
                                 for t in ts)),
        "paths": paths_follow_the_rule(paths, abc.blocks, K,
                                       abc._engine_choice,
                                       abc.max_nr_populations),
    }
    seq = [r["wall_s"] - r["sample_s"] for r in rows
           if r["path"] == "sequential" and r["t"] >= 1]
    return {"fuse_generations": K, "paths": paths,
            "kde_launches_per_fused_gen": per_gen, "fused_checks": checks,
            "blocks": [{**b, "s_per_gen": (b["wall_s"] / b["written"]
                                           if b["written"] else None)}
                       for b in abc.blocks],
            "engine": abc._engine_choice, "seq_probe_s": abc._seq_probe_s,
            "seq_host_s_per_gen": (statistics.median(seq) if seq else None)}


def paths_follow_the_rule(paths, blocks, K, engine, t_max) -> bool:
    """The engine's rule, read off the paths and the blocks: generation
    0 seeds the carry sequentially and a block starts at 1; a block
    starts only where K generations remain and keeps at most K; after a
    block short of K (an undershoot: it may keep none) the sequential
    engine redoes the next generation; any other sequential generation
    t >= 1 is one where no block fits before ``t_max`` (or the probe
    retired the fused engine)."""
    gens = len(paths)
    redo = {b["t"] + b["written"] for b in blocks
            if b["written"] < K and b["stop"] is None}
    ok = (paths[:2] == ["sequential", "fused"]
          and bool(blocks) and blocks[0]["t"] == 1)
    kept = set()
    for b in blocks:
        ok = ok and b["t"] + K <= t_max and b["written"] <= K
        kept.update(range(b["t"], b["t"] + b["written"]))
    ok = ok and kept == {t for t in range(gens) if paths[t] == "fused"}
    for t in range(1, gens):
        if paths[t] == "sequential" and t not in redo \
                and engine != "sequential":
            ok = ok and t + K > t_max
    return bool(ok)


def _phase_pop(torch, state, name: str, pop: int, gens: int):
    kept = {}
    row = run_main_path(torch, pop, gens, keep=kept)
    if pop >= 1 << 18:
        # every model keeps >= 2^14 particles at this size, so from t = 1
        # on each KDE must run against the grid-compressed support
        row["compressed_ok"] = all(
            s["compressed"] for g in row["generations"] if g["t"] >= 1
            for s in g["kde_support"])
        row["ok"] = row["ok"] and row["compressed_ok"]
    state.setdefault("launches", {})[name] = row["kde_launches"]
    # the engine probe's baseline for fused1e6: the steady seconds per
    # generation (median from t = 3, bench.py's warmup-3 protocol)
    state[f"{name}_seq_s"] = statistics.median(
        g["wall_s"] for g in row["generations"] if g["t"] >= 3)
    # the run and its History: sharded1e6's VectorizedSampler twin
    # (the same configuration, seed and sampler) at pop 1e6
    state[f"{name}_run"] = (row, kept["abc"].history)
    emit({"phase": name, **row})
    if not row["ok"]:
        raise RuntimeError(f"main path at pop {pop} failed its gate")


def phase_pop16384(torch, state):
    _phase_pop(torch, state, "pop16384", 16384, 11)


def phase_pop1e6(torch, state):
    _phase_pop(torch, state, "pop1e6", 1_000_000, 11)


#: generations per fused block in the fused phases (bench.py's
#: fused_northstar row)
FUSE_K = 4


def _record_fused_shape(state, key, row, pop, d):
    """K1's [queries × support] in the phase's first fused generation:
    the shape of the ``kernels`` row (h) or (i)."""
    g = next((g for g in row["generations"] if g["path"] == "fused"), None)
    if g is not None:
        state[key] = (pop, g["kde_support"][0]["rows"], d)


def _phase_fused_main(torch, state, name: str, pop: int):
    """Config #2 as the sequential phase runs it, with fused blocks of
    FUSE_K generations; at pop 1e6 the engine probe gets the pop1e6
    phase's steady seconds per generation as its baseline."""
    seq_s = state.get("pop1e6_seq_s") if pop > 1 << 17 else None
    row = run_main_path(torch, pop, 11, fuse=FUSE_K, seq_probe_s=seq_s)
    checks = dict(row["fused_checks"])
    if pop > 1 << 17:
        # the probe may retire fusion after the first block
        checks["first_block_fused"] = bool(
            row["blocks"] and row["blocks"][0]["t"] == 1
            and row["blocks"][0]["written"] >= 1)
        first = row["blocks"][0] if row["blocks"] else {}
        row["engine_probe"] = {
            "engine": row["engine"],
            "fused_s_per_gen": first.get("s_per_gen"),
            "sequential_s_per_gen": seq_s}
    else:
        checks["two_blocks"] = sum(b["written"] > 0
                                   for b in row["blocks"]) >= 2
    row["checks"] = checks
    row["ok"] = bool(row["ok"] and all(checks.values()))
    state.setdefault("launches", {})[name] = row["kde_launches"]
    _record_fused_shape(state, "fused_main_shape", row, pop, 1)
    emit({"phase": name, **row})
    if not row["ok"]:
        raise RuntimeError(f"{name} failed its checks: {checks}")


def phase_fused16384(torch, state):
    _phase_fused_main(torch, state, "fused16384", 16384)


def phase_fused1e6(torch, state):
    _phase_fused_main(torch, state, "fused1e6", 1_000_000)


def phase_fusedlv1e5(torch, state):
    row = run_adaptive(torch, "lv1e5", fuse=FUSE_K)
    state.setdefault("launches", {})["fusedlv1e5"] = row["kde_launches"]
    _record_fused_shape(state, "fused_lv_shape", row, ADAPTIVE_POP, 4)
    emit({"phase": "fusedlv1e5", **row})
    if not row["ok"]:
        raise RuntimeError(f"fusedlv1e5 failed its checks: {row['checks']}")


def phase_fusedpetab1e5(torch, state):
    row, _ = run_stochastic(torch, "petab1e5", fuse=FUSE_K)
    state.setdefault("launches", {})["fusedpetab1e5"] = row["kde_launches"]
    emit({"phase": "fusedpetab1e5", **row})
    if not row["ok"]:
        raise RuntimeError(
            f"fusedpetab1e5 failed its checks: {row['checks']}")


def onedispatch_report(abc, rows, wall: float, graphs: bool = True) -> dict:
    """The gates every one-dispatch phase shares: one dispatch, the paths
    sequential then one-dispatch to the end of the run, K1 launched in
    each one-dispatch generation as often as the code gives, the host
    reads of each generation (its rounds, one ``grids_resolved`` where a
    grid is, one control read), one History row of n per generation,
    with ``graphs`` every round a graph replay; and the host time per
    generation (wall − device loop, the loop ending in the control read)
    and ``control_roundtrip_s`` per generation."""
    from pyabc_tpu_torch.sampler.fused import kde_launches_per_gen

    per_gen = kde_launches_per_gen(abc.M, abc._block_mode()["stoch"])
    od = [r for r in rows if r["path"] == "onedispatch"]
    ts = [r["t"] for r in rows]
    n = abc.population_strategy(0)
    paths = [r["path"] for r in rows]
    checks = {
        "dispatches": abc.run_dispatches == 1,
        "od_paths": paths == ["sequential"] + ["onedispatch"] * (len(rows)
                                                                  - 1),
        "od_launches": bool(od) and all(r["kde_launches"] == per_gen
                                        for r in od),
        "host_reads": all(r["host_reads"] == r["rounds"] + 1
                          + (r["grids_resolved"] is not None) for r in od),
        "round_graph": not graphs or graphs_ok(rows),
        "history_rows": (ts == list(range(len(rows)))
                         and list(abc.history.get_all_populations().t)
                         == [-1] + ts
                         and all(len(abc.history.get_population(t)) == n
                                 for t in ts)),
    }
    return {"paths": paths, "run_dispatches": abc.run_dispatches,
            "kde_launches_per_od_gen": per_gen, "onedispatch_checks": checks,
            "run_wall_s": wall,
            "host_s_per_gen": (statistics.median(
                r["wall_s"] - r["sample_s"] for r in od) if od else None),
            "control_roundtrip_s": abc.control_roundtrip_s,
            "control_roundtrip_s_per_gen": (abc.control_roundtrip_s / len(od)
                                            if od else None)}


def population_difference(h_a, h_b, prefix: bool = False):
    """None when every generation's model index, parameters, distances
    and weights are equal bit for bit in the two histories (with
    ``prefix``, every generation of the shorter one), else where they
    first differ."""
    import numpy as np

    if h_a.max_t != h_b.max_t and not prefix:
        return f"generations {h_a.max_t + 1} vs {h_b.max_t + 1}"
    for t in range(min(h_a.max_t, h_b.max_t) + 1):
        a, b = h_a.get_population(t), h_b.get_population(t)
        for key in ("m", "theta", "distance", "weight"):
            x, y = np.asarray(getattr(a, key)), np.asarray(getattr(b, key))
            if not np.array_equal(x, y):
                return f"t={t} {key}: {int((x != y).sum())} values"
    return None


#: bench.py's bench_onedispatch row: config #2 at pop 1e6,
#: ConstantEpsilon(0.2), K = 4, batch 2^19 pinned, 9 generations
ONEDISPATCH_POP = 1_000_000
ONEDISPATCH_GENS = 9


def onedispatch_main_run(torch, run_mode, history_mode: str = "eager",
                         gens: int = ONEDISPATCH_GENS, db: str = "sqlite://",
                         **kwargs) -> tuple:
    """``(abc, wall_s, K1 launches)`` of the ``bench_onedispatch``
    configuration through ``ABCSMC.run`` on the card (the fused twin on
    the classic loop: pop 1e6 would pipeline it), its History in ``db``;
    ``kwargs`` go to the constructor."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import make_two_gaussians_problem
    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda

    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(
        models, priors, distance, population_size=ONEDISPATCH_POP,
        eps=pt.ConstantEpsilon(0.2),
        sampler=pt.VectorizedSampler(min_batch_size=1 << 19,
                                     max_batch_size=1 << 19,
                                     max_rounds_per_call=16, device="cuda"),
        stores_sum_stats=False, fuse_generations=FUSE_K, run_mode=run_mode,
        ingest_mode="sequential", history_mode=history_mode, seed=0,
        device="cuda", **kwargs)
    abc.new(db, observed)
    weighted_kde_logpdf_cuda.launches = 0
    t0 = time.perf_counter()
    abc.run(max_nr_populations=gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return abc, wall, weighted_kde_logpdf_cuda.launches


def phase_onedispatch1e6(torch, state):
    # fused, one-dispatch, one-dispatch, fused: the process's first run
    # of this shape pays one-off costs, and each engine runs twice; then
    # one-dispatch with lazy rows
    runs = [onedispatch_main_run(torch, mode)
            for mode in ("auto", "onedispatch", "onedispatch", "auto")]
    lazy_run = onedispatch_main_run(torch, "onedispatch", "lazy")
    (a_f, wall_f, launches_f), (a_o, wall_o, launches_o) = runs[:2]
    rows = a_o.timeline
    report = onedispatch_report(a_o, rows, wall_o)
    checks = dict(report["onedispatch_checks"])
    checks["gens"] = len(rows) == ONEDISPATCH_GENS
    checks["fused_twin_paths"] = all(
        [r["path"] for r in a.timeline] == ["sequential"] + ["fused"] * 8
        for a, _, _ in (runs[0], runs[3]))
    # every run's populations equal the first fused run's, bit for bit
    differences = [population_difference(a.history, a_f.history)
                   for a, _, _ in runs[1:]]
    checks["bit_identical"] = not any(differences)
    # the lazy run's rows hydrate to the eager runs' bits
    lazy_difference = population_difference(lazy_run[0].history,
                                            a_o.history)
    checks["lazy_bit_identical"] = lazy_difference is None
    checks["lazy_rows"] = (
        {r["history_mode"] for r in lazy_run[0].timeline} == {"lazy"}
        and all(lazy_run[0].history.get_population_summary(r["t"])
                for r in lazy_run[0].timeline if r["path"] == "onedispatch"))
    fused_rows = [r for r in a_f.timeline if r["path"] == "fused"]
    row = {"pop": ONEDISPATCH_POP, "gens": ONEDISPATCH_GENS,
           "ok": all(checks.values()), "checks": checks,
           "kde_launches": launches_o, "fused_kde_launches": launches_f,
           "differences_from_first_fused_run": differences,
           "lazy_difference_from_od_run": lazy_difference,
           "od_wall_s_runs": [runs[1][1], runs[2][1]],
           "od_lazy_wall_s": lazy_run[1],
           "od_lazy_kde_launches": lazy_run[2],
           "fused_wall_s_runs": [runs[0][1], runs[3][1]],
           "wall_s": wall_o, "fused_wall_s": wall_f,
           "fused_host_s_per_gen": (statistics.median(
               r["wall_s"] - r["sample_s"] for r in fused_rows)
               if fused_rows else None),
           "fused_blocks": [{k: b[k] for k in ("t", "written", "rounds",
                                               "host_reads", "wall_s")}
                            for b in a_f.blocks],
           "wire": wire_per_gen(a_o),
           "peak_mem_gb": max(r["peak_mem_gb"] for r in rows),
           "generations": [
               {**generation_row(r), "accepted_per_s": r["n"] / r["wall_s"]}
               for r in rows],
           **report}
    launches = state.setdefault("launches", {})
    launches["onedispatch1e6"] = launches_o
    launches["onedispatch1e6_fused"] = launches_f
    launches["onedispatch1e6_lazy"] = lazy_run[2]
    emit({"phase": "onedispatch1e6", **row})
    if not row["ok"]:
        raise RuntimeError(f"onedispatch1e6 failed its checks: {checks}")


LANES_POP = 1_000_000
LANES_GENS = 11


def lanes_run(torch, lanes: str) -> dict:
    """The JAX package's ``bench_kernel`` configuration (config #2 at pop
    1e6, ``MedianEpsilon(device_sketch=True)``, batch up to 2^19, 16
    rounds per call, ``stores_sum_stats=False``, K = 4, one-dispatch,
    seed 0) for ``run_gate``'s 11 generations under
    ``$PYABC_TPU_PRECISION_LANES=lanes``.  The frozen policy is dropped
    before and after the run and the environment restored, so every other
    phase runs at float32.  Returns the run's gate, walls, K1 launches,
    the last population's sketch error and, under the bf16 distance lane,
    the lane's effect on the last population's statistics on the card."""
    import numpy as np

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch import weighted_statistics as ws
    from pyabc_tpu_torch.models import make_two_gaussians_problem
    from pyabc_tpu_torch.ops import precision
    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda
    from pyabc_tpu_torch.ops.quantile_sketch import (
        sketch_error_bound, sketch_weighted_quantile)

    precision._reset_for_testing()
    try:
        with _Env(**{precision.PRECISION_ENV: lanes}):
            policy = {c: precision.lanes(c) for c in precision.COMPONENTS}
            models, priors, distance, observed, posterior_fn = \
                make_two_gaussians_problem()
            abc = pt.ABCSMC(
                models, priors, distance, population_size=LANES_POP,
                eps=pt.MedianEpsilon(device_sketch=True),
                sampler=pt.VectorizedSampler(max_batch_size=1 << 19,
                                             max_rounds_per_call=16,
                                             device="cuda"),
                stores_sum_stats=False, fuse_generations=FUSE_K,
                run_mode="onedispatch", seed=0, device="cuda")
            abc.new("sqlite://", observed)
            weighted_kde_logpdf_cuda.launches = 0
            t0 = time.perf_counter()
            abc.run(max_nr_populations=LANES_GENS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = weighted_kde_logpdf_cuda.launches
            h = abc.history
            t = h.max_t
            pop = h.get_population(t)
            # the lane on the last population's statistics: fresh
            # simulations at its parameters, on the card, through the
            # distance under the frozen policy and in float32
            gen = torch.Generator(device="cuda").manual_seed(1)
            obs = abc.spec.flatten_single(observed, device="cuda")
            params = {k: torch.as_tensor(v, device="cuda")
                      for k, v in abc.distance_function.get_params(t).items()}
            theta = torch.as_tensor(pop.theta, device="cuda")
            m = torch.as_tensor(pop.m, device="cuda")
            stats = torch.empty(len(pop), obs.shape[0], device="cuda")
            for k, model in enumerate(abc.models):
                rows = (m == k).nonzero().squeeze(1)
                stats[rows] = abc.spec.flatten(model.simulate(gen,
                                                              theta[rows]))
            d_lane = abc.distance_function.compute(stats, obs, params)
            # the float32 lane's arithmetic (PNormDistance.compute)
            diff = torch.abs(params["w"] * (stats - obs))
            d_f32 = (diff.max(-1).values if math.isinf(distance.p) else
                     torch.sum(diff ** distance.p, -1) ** (1.0 / distance.p))
            rel = ((d_lane - d_f32).abs() / d_f32.clamp_min(1e-30))
            d_hist = np.asarray(pop.distance, np.float32)
            as_bf16 = torch.from_numpy(d_hist).to(torch.bfloat16).float()
    finally:
        precision._reset_for_testing()
    p_b = float(h.get_model_probabilities(t).get(1, 0.0))
    df, w = h.get_distribution(m=1, t=t)
    mu = float(np.sum(df["mu"].to_numpy() * w)) if len(df) else math.nan
    pops = h.get_all_populations()
    # the sketch on the run's own final weighted distances
    wn = np.asarray(pop.weight, np.float64)
    exact = float(ws.weighted_quantile(d_hist, wn / wn.sum(), 0.5))
    sketch = float(sketch_weighted_quantile(
        torch.as_tensor(d_hist, device="cuda"),
        torch.as_tensor(wn / wn.sum(), dtype=torch.float32, device="cuda"),
        0.5))
    finite = d_hist[np.isfinite(d_hist)]
    bound = float(sketch_error_bound(float(finite.min()),
                                     float(finite.max())))
    return {"lanes": lanes, "policy": policy, "wall_s": wall,
            "gens_run": t + 1, "p_model_b": p_b,
            "p_analytic": float(posterior_fn(1.0)), "mu_b": mu,
            "final_eps": float(pops.epsilon.iloc[-1]),
            "kde_launches": launches,
            "kde_launches_per_gen": [r["kde_launches"]
                                     for r in abc.timeline],
            "paths": [r["path"] for r in abc.timeline],
            "run_dispatches": abc.run_dispatches,
            "sketch_err": abs(sketch - exact), "sketch_bound": bound,
            "lane_rel_max": float(rel.max()),
            "lane_rows_moved": int((d_lane != d_f32).sum()),
            "history_distances_bf16": bool(
                np.array_equal(as_bf16.numpy(), d_hist)),
            "generations": [generation_row(r) for r in abc.timeline]}


def phase_lanes1e6(torch, state):
    """The JAX package's tuned one-dispatch row on the card: the bf16
    compute lanes, then the float32 twin that differs only in the lane."""
    lane = lanes_run(torch, "bf16")
    twin = lanes_run(torch, "f32")
    tol_p = max(2.5e-3, 2.5 / LANES_POP ** 0.5)
    tol_mu = max(3e-3, 3.0 / LANES_POP ** 0.5)
    checks = {}
    for name, arm in (("bf16", lane), ("f32", twin)):
        checks[f"{name}_gens"] = arm["gens_run"] == LANES_GENS
        checks[f"{name}_gate"] = (
            abs(arm["p_model_b"] - arm["p_analytic"]) < tol_p
            and abs(arm["mu_b"] - 1.0) < tol_mu)
        checks[f"{name}_final_eps"] = arm["final_eps"] < 0.05
        checks[f"{name}_sketch"] = arm["sketch_err"] <= arm["sketch_bound"]
        checks[f"{name}_onedispatch"] = "onedispatch" in arm["paths"]
    checks["policy"] = (lane["policy"] == {"kde": "bf16", "distance": "bf16"}
                        and twin["policy"] == {"kde": "f32",
                                               "distance": "f32"})
    checks["launches_equal_twin"] = (lane["kde_launches_per_gen"]
                                     == twin["kde_launches_per_gen"])
    checks["lane_on"] = (lane["lane_rows_moved"] > 0
                         and 0 < lane["lane_rel_max"] <= 2.0 ** -8
                         and lane["history_distances_bf16"])
    checks["twin_f32"] = (twin["lane_rows_moved"] == 0
                          and not twin["history_distances_bf16"])
    launches = state.setdefault("launches", {})
    launches["lanes1e6"] = lane["kde_launches"]
    launches["lanes1e6_f32"] = twin["kde_launches"]
    row = {"phase": "lanes1e6", "ok": all(checks.values()),
           "checks": checks, "pop": LANES_POP, "gens": LANES_GENS,
           "tol_p": tol_p, "tol_mu": tol_mu,
           "wall_s": lane["wall_s"], "twin_wall_s": twin["wall_s"],
           "bf16": lane, "f32": twin}
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"lanes1e6 failed its checks: {checks}")


def phase_onedispatchpetab1e5(torch, state):
    row_o, a_o = run_stochastic(torch, "petab1e5", fuse=FUSE_K,
                                run_mode="onedispatch")
    launches = state.setdefault("launches", {})
    launches["onedispatchpetab1e5"] = row_o["kde_launches"]
    row_f, a_f = run_stochastic(torch, "petab1e5", fuse=FUSE_K)
    launches["onedispatchpetab1e5_fused"] = row_f["kde_launches"]
    checks = dict(row_o["checks"])
    checks["fused_twin_ok"] = row_f["ok"]
    checks["stop_at_fused_t"] = (
        row_o["stop_reason"] == row_f["stop_reason"] == STOP_TEMPERATURE
        and row_o["gens_run"] == row_f["gens_run"])
    checks["temperatures"] = ([g["temperature"] for g in row_o["generations"]]
                              == [g["temperature"]
                                  for g in row_f["generations"]])
    difference = population_difference(a_o.history, a_f.history)
    checks["bit_identical"] = difference is None
    row = {**row_o, "ok": all(checks.values()), "checks": checks,
           "difference_from_fused_run": difference,
           "fused_wall_s": row_f["wall_s"],
           "fused_kde_launches": row_f["kde_launches"],
           "fused_paths": row_f["paths"]}
    emit({"phase": "onedispatchpetab1e5", **row})
    if not row["ok"]:
        raise RuntimeError(
            f"onedispatchpetab1e5 failed its checks: {checks}")


#: the run_gate configuration and the north-star bench row of the JAX
#: package (``tools/verify_northstar_posterior.py:run_gate``,
#: ``bench.py:272-315``), both at pop 1e6 with ABCSMC's defaults
PIPELINED_POP = 1_000_000
NORTHSTAR_GENS = 9


def _config2_abc(eps, **kw):
    """Config #2 at pop 1e6 on the card as the JAX package's run_gate and
    north-star row build it; ``kw`` overrides constructor defaults."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import make_two_gaussians_problem

    models, priors, distance, observed, posterior_fn = \
        make_two_gaussians_problem()
    abc = pt.ABCSMC(
        models, priors, distance, population_size=PIPELINED_POP, eps=eps,
        sampler=pt.VectorizedSampler(max_batch_size=1 << 19,
                                     max_rounds_per_call=16, device="cuda"),
        stores_sum_stats=False, seed=0, device="cuda", **kw)
    abc.new("sqlite://", observed)
    return abc, posterior_fn


def _timed_run(torch, abc, gens: int) -> dict:
    """``abc.run`` between K1 launch counts set to 0 and read after, with
    the wire ledger's and the egress buckets' deltas, and the rows each
    generation had (lazy or durable) when ``done`` began."""
    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda
    from pyabc_tpu_torch.wire import transfer

    h = abc.history
    at_done = {}
    flush = h.flush_lazy

    def flush_recording(*args, **kwargs):
        # done() flushes first; the run's exit-path persist flushes again
        if not at_done:
            at_done.update(h._conn.execute(
                "SELECT t, lazy FROM populations WHERE abc_smc_id=? AND "
                "t>=0", (h.id,)).fetchall())
        flush(*args, **kwargs)

    h.flush_lazy = flush_recording
    tr0, eg0 = transfer.snapshot(), transfer.egress_breakdown()
    weighted_kde_logpdf_cuda.launches = 0
    t0 = time.perf_counter()
    abc.run(max_nr_populations=gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = weighted_kde_logpdf_cuda.launches
    del h.flush_lazy
    eg1 = transfer.egress_breakdown()
    return {"wall_s": wall, "kde_launches": launches,
            "ledger": transfer.delta(tr0),
            "egress_bytes": {k: eg1[k] - eg0[k] for k in eg1},
            "lazy_at_done": at_done}


def phase_pipelined1e6(torch, state):
    import numpy as np

    import pyabc_tpu_torch as pt

    # run_gate exactly: MedianEpsilon, 11 generations, the defaults
    abc, posterior_fn = _config2_abc(pt.MedianEpsilon())
    gate = _timed_run(torch, abc, 11)
    rows = abc.timeline
    n = PIPELINED_POP
    h = abc.history
    t = h.max_t
    p_b = float(h.get_model_probabilities(t).get(1, 0.0))
    df, w = h.get_distribution(m=1, t=t)
    mu = float(np.sum(df["mu"].to_numpy() * w)) if len(df) else math.nan
    tol_p = max(2.5e-3, 2.5 / n ** 0.5)
    tol_mu = max(3e-3, 3.0 / n ** 0.5)
    paths = [r["path"] for r in rows]
    ts = [r["t"] for r in rows]
    lazy_at_done = gate["lazy_at_done"]
    checks = {
        "p_model_b": abs(p_b - posterior_fn(1.0)) < tol_p,
        "mu_b": abs(mu - 1.0) < tol_mu,
        "gens": ts == list(range(11)),
        "history_rows": (list(h.get_all_populations().t) == [-1] + ts
                         and all(len(h.get_population(tt)) == n
                                 for tt in ts)),
        # block rows were summaries until done() hydrated them; nothing
        # stays lazy after it
        "lazy_until_hydrated": (
            any(lazy_at_done.values())
            and all(paths[tt] == "pipelined"
                    for tt, lazy in lazy_at_done.items() if lazy)
            and all(h.get_population_summary(r["t"]) is not None
                    for r in rows if r["path"] == "pipelined")
            and not any(lazy for (lazy,) in h._conn.execute(
                "SELECT lazy FROM populations WHERE abc_smc_id=?",
                (h.id,)).fetchall())),
        "paths": (paths[0] == "sequential" and "pipelined" in paths
                  and set(paths) <= {"sequential", "pipelined"}),
        "launches": all(r["kde_launches"] >= 2 for r in rows if r["t"] >= 1),
        "defaults": abc.ingest_mode == "auto" and abc.history_mode == "lazy",
        "round_graph": graphs_ok(rows),
    }
    state.setdefault("launches", {})["pipelined1e6"] = gate["kde_launches"]

    # the north-star row, four ways: depth 2 lazy, depth 0 lazy, depth 2
    # eager, and bench.py's sequential-eager control
    twins = {}
    for label, kw in (("depth2_lazy", {}), ("depth0_lazy",
                                            {"ingest_depth": 0}),
                      ("depth2_eager", {"history_mode": "eager"}),
                      ("sequential_eager", {"ingest_mode": "sequential",
                                            "history_mode": "eager"})):
        a, _ = _config2_abc(pt.ConstantEpsilon(0.2), **kw)
        twins[label] = (a, _timed_run(torch, a, NORTHSTAR_GENS))
        state["launches"][f"northstar_{label}"] = \
            twins[label][1]["kde_launches"]
    base = twins["depth2_lazy"][0].history
    differences = {label: population_difference(twins[label][0].history,
                                                 base)
                   for label in ("depth0_lazy", "depth2_eager")}
    checks["twins_bit_identical"] = not any(differences.values())
    overlap = {label: r["ledger"]["overlap_s"]
               for label, (_, r) in twins.items()}
    checks["overlap_depth2"] = overlap["depth2_lazy"] > 0
    checks["overlap_depth0"] = overlap["depth0_lazy"] == 0
    twin_paths = {label: [r["path"] for r in a.timeline]
                  for label, (a, _) in twins.items()}
    checks["twin_paths"] = all(
        p[0] == "sequential" and "pipelined" in p
        for label, p in twin_paths.items() if label != "sequential_eager")

    def per_gen_kb(label, bucket):
        return twins[label][1]["egress_bytes"][bucket] / NORTHSTAR_GENS / 1e3

    checks = {k: bool(v) for k, v in checks.items()}
    row = {
        "pop": n, "gens": 11, "ok": all(checks.values()), "checks": checks,
        "p_model_b": p_b, "p_analytic": float(posterior_fn(1.0)),
        "tol_p": tol_p, "mu_b": mu, "tol_mu": tol_mu, "paths": paths,
        "wall_s": gate["wall_s"], "kde_launches": gate["kde_launches"],
        "ledger": gate["ledger"], "egress_bytes": gate["egress_bytes"],
        "lazy_at_done": sorted(tt for tt, lazy in lazy_at_done.items()
                               if lazy),
        "store": abc._store.manifest(),
        "peak_mem_gb": max(r["peak_mem_gb"] for r in rows),
        "generations": [generation_row(r) for r in rows],
        "northstar": {
            label: {"wall_s": r["wall_s"], "kde_launches": r["kde_launches"],
                    "paths": twin_paths[label], "ledger": r["ledger"],
                    "egress_bytes": r["egress_bytes"],
                    "s_per_gen_t_ge_1": statistics.mean(
                        g["wall_s"] for g in a.timeline if g["t"] >= 1)}
            for label, (a, r) in twins.items()},
        "northstar_differences": differences,
        "summary_kb_per_gen_lazy": per_gen_kb("depth2_lazy", "summary"),
        "history_kb_per_gen_lazy": per_gen_kb("depth2_lazy", "history"),
        "population_kb_per_gen_eager": per_gen_kb("depth2_eager",
                                                  "population"),
    }
    emit({"phase": "pipelined1e6", **row})
    if not row["ok"]:
        raise RuntimeError(f"pipelined1e6 failed its checks: {checks}")


def phase_pipelinedsir1e6(torch, state):
    """BASELINE config #4 at its own size: sir1e5's configuration at pop
    1e6 through the constructor's defaults (the pipeline, lazy rows)."""
    row = run_adaptive(torch, "sir1e5", pop=PIPELINED_POP, defaults=True)
    state.setdefault("launches", {})["pipelinedsir1e6"] = row["kde_launches"]
    g = next((g for g in row["generations"] if g["path"] == "pipelined"),
             None)
    if g is not None:
        state["pipelined_sir_shape"] = (PIPELINED_POP,
                                        g["kde_support"][0]["rows"], 2)
    row["peak_mem_gb_by_gen"] = [g["peak_mem_gb"]
                                 for g in row["generations"]]
    emit({"phase": "pipelinedsir1e6", **row})
    if not row["ok"]:
        raise RuntimeError(
            f"pipelinedsir1e6 failed its checks: {row['checks']}")


#: BASELINE configs #3 and #4 as the JAX package's pop-1e5 bench rows run
#: them: (problem factory, generating parameters, generations)
ADAPTIVE = {"lv1e5": ("make_lotka_volterra_problem", "LV_TRUTH", 8),
            "sir1e5": ("make_sir_problem", "SIR_TRUTH", 8)}
ADAPTIVE_POP = 100_000


def adaptive_abc(name: str, fuse: int = 1, pop: int = ADAPTIVE_POP,
                 defaults: bool = False, transitions=None):
    """``(abc, distance, priors, truth)`` of one adaptive workload on the
    card: full-width model, ``AdaptivePNormDistance(p=2)`` with the
    median-absolute-deviation scale, ``MedianEpsilon``, batch 2^19;
    ``fuse`` K > 1 runs fused blocks.  Eager rows are pinned unless
    ``defaults`` (the pipelinedsir1e6 phase); ``transitions`` replaces
    the Gaussian KDE (the local1e4 phase)."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch import models as pt_models

    make, truth, _ = ADAPTIVE[name]
    models, priors, distance, observed = getattr(pt_models, make)()
    abc = pt.ABCSMC(
        models, priors, distance, population_size=pop,
        eps=pt.MedianEpsilon(),
        sampler=pt.VectorizedSampler(min_batch_size=1 << 19,
                                     max_batch_size=1 << 19, device="cuda"),
        stores_sum_stats=False, fuse_generations=fuse, seed=0,
        transitions=transitions, device="cuda",
        **({} if defaults else {"history_mode": "eager"}))
    abc.new("sqlite://", observed)
    return abc, distance, priors, getattr(pt_models, truth)


def run_adaptive(torch, name: str, fuse: int = 1, pop: int = ADAPTIVE_POP,
                 defaults: bool = False, transitions=None,
                 kde_per_gen=None) -> dict:
    """One adaptive workload through ``ABCSMC.run`` on the card, with its
    per-generation timeline and the gates of the module docstring;
    ``defaults`` runs the constructor's defaults (pipelined at pop 1e6).
    With ``transitions`` (a LocalTransition) the proposal density is not
    K1: its launch gate becomes none launched, or, with ``kde_per_gen``,
    exactly that many launches in every generation t >= 1."""
    import numpy as np

    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda

    gens = ADAPTIVE[name][2]
    abc, distance, priors, truth = adaptive_abc(name, fuse, pop, defaults,
                                                transitions)
    weighted_kde_logpdf_cuda.launches = 0
    t0 = time.perf_counter()
    abc.run(max_nr_populations=gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = weighted_kde_logpdf_cuda.launches
    rows = abc.timeline
    names = priors[0].get_parameter_names()
    df, w = abc.history.get_distribution(m=0, t=abc.history.max_t)
    x = df[names].to_numpy(np.float64)
    w = np.asarray(w, np.float64) / np.sum(w)
    mean = (w[:, None] * x).sum(0)
    std = np.sqrt((w[:, None] * (x - mean) ** 2).sum(0))
    log_truth = np.log(np.asarray(truth))
    prior_std = np.array([priors[0][k].scale for k in names]) / 12 ** 0.5
    # weights[t] (t >= 1) is fitted from generation t - 1's records,
    # weights[0] from the calibration sample of pop rows
    checks = {
        "gens": len(rows) == gens,
        # the Gaussian KDE's rounds are captured (a local or aggregated
        # proposal's may be refused: it runs eagerly and says so)
        "round_graph": transitions is not None or graphs_ok(rows),
        "eps": all(math.isfinite(r["eps"]) and r["eps"] > 0 for r in rows),
        "launches": (all(r["kde_launches"] >= 1 for r in rows
                         if r["t"] >= 1) if transitions is None
                     else launches == 0 if kde_per_gen is None
                     else all(r["kde_launches"] == kde_per_gen
                              for r in rows if r["t"] >= 1)),
        "history_rows": (list(abc.history.get_all_populations().t)
                         == [-1] + [r["t"] for r in rows]),
        "mean": bool(np.all(np.abs(mean - log_truth) <= 4 * std)),
        "std": bool(np.all(std <= 0.75 * prior_std)),
    }
    paths = [r["path"] for r in rows]
    if defaults:
        # each block that follows a block runs from the weights the one
        # before refit on the card, pre-seeded on the host at its exit
        follows = [r["t"] for r, prev in zip(rows[1:], rows)
                   if r["path"] == prev["path"] == "pipelined"]
        checks["paths"] = (paths[0] == "sequential" and "pipelined" in paths
                           and set(paths) <= {"sequential", "pipelined"})
        checks["weights"] = bool(follows) and all(
            t in distance.weights and np.all(np.isfinite(distance.weights[t]))
            for t in follows)
    elif fuse > 1:
        # a block's interior weights live on the card; its exit hands the
        # in-block refit for generation 1 + K to the host schedule
        w_exit = distance.weights.get(1 + fuse)
        checks["weights"] = bool(w_exit is not None
                                 and np.all(np.isfinite(w_exit)))
    else:
        checks["weights"] = (sorted(distance.weights) == list(range(gens))
                             and all(r["records"] >= pop
                                     for r in rows[:-1]))
    fused = fused_report(abc, rows) if fuse > 1 else {}
    if fused:
        checks.update(fused["fused_checks"])
    return {
        "pop": pop, "gens_asked": gens, "gens_run": len(rows),
        "ok": all(checks.values()), "checks": checks, "paths": paths,
        "kde_launches": launches, "wall_s": wall,
        "peak_mem_gb": max(r["peak_mem_gb"] for r in rows),
        "params": names, "posterior_mean": mean.tolist(),
        "posterior_std": std.tolist(), "truth": log_truth.tolist(),
        "prior_std": prior_std.tolist(),
        "generations": [
            {**generation_row(r), "records": r["records"],
             "refit_s": r["refit_s"],
             **({"weight_min": float(distance.weights[r["t"]].min()),
                 "weight_max": float(distance.weights[r["t"]].max()),
                 "zero_weights": int((distance.weights[r["t"]] == 0).sum())}
                if r["t"] in distance.weights else {})}
            for r in rows],
        **fused,
    }


def _phase_adaptive(torch, state, name: str):
    row = run_adaptive(torch, name)
    state.setdefault("launches", {})[name] = row["kde_launches"]
    state[f"{name}_gen_launches"] = {g["t"]: g["kde_launches"]
                                     for g in row["generations"]}
    emit({"phase": name, **row})
    if not row["ok"]:
        raise RuntimeError(f"{name} failed its checks: {row['checks']}")


def phase_lv1e5(torch, state):
    _phase_adaptive(torch, state, "lv1e5")


def phase_sir1e5(torch, state):
    _phase_adaptive(torch, state, "sir1e5")


#: BASELINE config #5, as the JAX package's petab_ode_pop100k row runs it
STOCHASTIC_POP = 100_000
STOCHASTIC_BATCH = 1 << 18
STOP_TEMPERATURE = "Stopping: temperature reached 1"

#: the SBML decay model of the JAX package's PEtab tests
SBML_DECAY = """\
<?xml version="1.0" encoding="UTF-8"?>
<sbml xmlns="http://www.sbml.org/sbml/level3/version2/core"
      level="3" version="2">
  <model id="decay">
    <listOfCompartments>
      <compartment id="cell" size="1" constant="true"/>
    </listOfCompartments>
    <listOfSpecies>
      <species id="A" compartment="cell" initialConcentration="1"
               boundaryCondition="false" constant="false"/>
    </listOfSpecies>
    <listOfParameters>
      <parameter id="k1" value="0.7" constant="true"/>
    </listOfParameters>
    <listOfReactions>
      <reaction id="degrade" reversible="false">
        <listOfReactants>
          <speciesReference species="A" stoichiometry="1"/>
        </listOfReactants>
        <kineticLaw>
          <math xmlns="http://www.w3.org/1998/Math/MathML">
            <apply><times/><ci>k1</ci><ci>A</ci></apply>
          </math>
        </kineticLaw>
      </reaction>
    </listOfReactions>
  </model>
</sbml>
"""


def petab_importer():
    """bench.py's petab_ode_pop100k problem: one rate ``k``, uniform on
    [0.01, 3] (lin scale), ``dy/dt = −k·y``, y0 = 1, t_max 2 in 20 RK4
    steps, observed after steps 4, 9, 14, 19 with σ = 0.05, data from
    ``default_rng(0)``."""
    import numpy as np
    import pandas as pd

    from pyabc_tpu_torch.petab import ODEPetabImporter

    par_df = pd.DataFrame({
        "parameterId": ["k"], "parameterScale": ["lin"],
        "lowerBound": [0.01], "upperBound": [3.0], "estimate": [1],
        "objectivePriorType": ["uniform"],
        "objectivePriorParameters": ["0.01;3.0"]}).set_index("parameterId")
    t_max, n_steps = 2.0, 20
    obs_idx = np.asarray([4, 9, 14, 19])
    times = (obs_idx + 1) * (t_max / n_steps)
    rng = np.random.default_rng(0)
    data = np.exp(-0.7 * times) + 0.05 * rng.normal(size=times.shape)
    return ODEPetabImporter(
        par_df, rhs=lambda y, theta: -theta[:, 0:1] * y, y0=[1.0],
        t_max=t_max, n_steps=n_steps, obs_idx=obs_idx,
        measurements={"y0": data}, sigma=0.05)


def sbml_importer():
    """The SBML decay model in two conditions (A(0) = 1 in ``c0``, 2 in
    ``c1`` through the condition table), measured at t = 0.5, 1, 1.5, 2
    in each (``c0``: exp(−0.7 t) + 0.05·N(0, 1) from ``default_rng(0)``;
    ``c1``: 2·exp(−0.7 t) + 0.05·N(0, 1) from ``default_rng(1)``); ``k1``
    uniform on [0.01, 3]; the problem built from in-memory tables (no
    YAML), the importer's default 200 RK4 steps."""
    import numpy as np
    import pandas as pd

    from pyabc_tpu_torch.petab import PetabProblem, SBMLPetabImporter

    times = np.asarray([0.5, 1.0, 1.5, 2.0])
    c0 = np.exp(-0.7 * times) + 0.05 * np.random.default_rng(0).normal(
        size=times.shape)
    c1 = 2.0 * np.exp(-0.7 * times) + 0.05 * np.random.default_rng(
        1).normal(size=times.shape)
    problem = PetabProblem(
        SBML_DECAY,
        parameter_df=pd.DataFrame({
            "parameterId": ["k1"], "parameterScale": ["lin"],
            "lowerBound": [0.01], "upperBound": [3.0], "estimate": [1],
            "objectivePriorType": ["uniform"],
            "objectivePriorParameters": ["0.01;3.0"]}),
        observable_df=pd.DataFrame({
            "observableId": ["obs_a"], "observableFormula": ["A"],
            "noiseFormula": [0.05]}),
        measurement_df=pd.DataFrame({
            "observableId": "obs_a",
            "simulationConditionId": ["c0"] * 4 + ["c1"] * 4,
            "time": list(times) * 2, "measurement": list(c0) + list(c1)}),
        condition_df=pd.DataFrame({"conditionId": ["c0", "c1"],
                                   "A": [1.0, 2.0]}))
    return SBMLPetabImporter(problem)


#: name -> (importer, generations, temperature aggregation, quadrature
#: points over the prior)
STOCHASTIC = {"petab1e5": (petab_importer, 6, max, 40001),
              "sbml1e5": (sbml_importer, 8, min, 20001)}


def quadrature(torch, model, points: int) -> tuple:
    """(mean, std) of the exact posterior of the one parameter: the
    model's own llh on the CPU over ``points`` equally spaced values of
    the uniform prior [0.01, 3], weighted by exp(llh)."""
    k = torch.linspace(0.01, 3.0, points, dtype=torch.float64)
    gen = torch.Generator()
    gen.manual_seed(0)
    llh = model.simulate(gen, k.to(torch.float32)[:, None])["llh"].double()
    p = torch.exp(llh - llh.max())
    p = p / p.sum()
    mean = float((p * k).sum())
    return mean, float((p * (k - mean) ** 2).sum().sqrt())


def scheme_solved(proposals: dict) -> bool:
    """Whether the temperature of a generation came from its schemes
    (which read the records, and with them the new proposal's density)
    rather than from the final, clamped, initial or installed value."""
    return not ({"final", "clamped", "initial_temperature", "installed"}
                & set(proposals))


def llh_max(importer) -> float:
    """The largest value the ODE importer's Gaussian llh can take (every
    residual 0): the kernel's analytic pdf maximum."""
    n_obs = sum(len(v) for v in importer.measurements.values())
    return -0.5 * n_obs * math.log(2 * math.pi * importer.sigma ** 2)


def run_stochastic(torch, name: str, fuse: int = 1,
                   run_mode: str = "auto") -> tuple:
    """``(row, abc)``: one config-#5 workload through ``ABCSMC.run`` on
    the card, with its per-generation timeline and the gates of the
    module docstring.  With ``fuse`` K > 1 the run takes the fused
    engine's eligible form of the triple: ``Temperature`` with the
    acceptance-rate scheme alone, and the acceptor's pdf norm from the
    kernel's analytic maximum; ``run_mode="onedispatch"`` then runs it as
    one dispatch."""
    import numpy as np

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda
    from pyabc_tpu_torch.sampler.fused import kde_launches_per_gen

    make, gens, aggregate, points = STOCHASTIC[name]
    importer = make()
    t_q = time.perf_counter()
    mu_q, sd_q = quadrature(torch, importer.create_model(), points)
    quadrature_s = time.perf_counter() - t_q
    kernel = importer.create_kernel()
    if fuse > 1:
        temperature = pt.Temperature(schemes=[pt.AcceptanceRateScheme()])
        acceptor = pt.StochasticAcceptor(
            pdf_norm_method=pt.pdf_norm_from_kernel)
        kernel.pdf_max = llh_max(importer)
    else:
        temperature = pt.Temperature(aggregate_fun=aggregate)
        acceptor = pt.StochasticAcceptor()
    abc = pt.ABCSMC(
        importer.create_model(), importer.create_prior(), kernel,
        population_size=STOCHASTIC_POP, eps=temperature, acceptor=acceptor,
        sampler=pt.VectorizedSampler(min_batch_size=STOCHASTIC_BATCH,
                                     max_batch_size=STOCHASTIC_BATCH,
                                     device="cuda"),
        fuse_generations=fuse, run_mode=run_mode, history_mode="eager",
        seed=0, device="cuda")
    abc.new("sqlite://", importer.get_observed())
    weighted_kde_logpdf_cuda.launches = 0
    t0 = time.perf_counter()
    abc.run(max_nr_populations=gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = weighted_kde_logpdf_cuda.launches
    rows = abc.timeline
    name_k = importer.create_prior().get_parameter_names()[0]
    df, w = abc.history.get_distribution(m=0, t=abc.history.max_t)
    k = df[name_k].to_numpy(np.float64)
    w = np.asarray(w, np.float64) / np.sum(w)
    mean = float(np.sum(w * k))
    std = float(np.sqrt(np.sum(w * (k - mean) ** 2)))
    ess = float(1.0 / np.sum(w ** 2))
    temps = [temperature(r["t"]) for r in rows]

    # K1 per generation t >= 1 (one model): the finalize's deferred
    # proposal density, one density per record batch at ingest, and the
    # new proposal's density at the previous generation's records when a
    # scheme read them (ABCSMC._prepare_next_iteration)
    def expected(r):
        if r["t"] == 0:
            return 0
        if r["path"] in ("fused", "onedispatch"):
            return kde_launches_per_gen(1, True)
        return (1 + r["record_batches"]
                + scheme_solved(temperature.temperature_proposals[r["t"]]))

    checks = {
        "final_temperature": temps[-1] == 1.0,
        "monotone": all(a >= b for a, b in zip(temps, temps[1:])),
        "stop": abc.stop_reason == STOP_TEMPERATURE,
        "launches": all(r["kde_launches"] == expected(r)
                        and (r["t"] == 0 or r["kde_launches"] >= 2)
                        for r in rows),
        "mean": abs(mean - mu_q) <= max(1e-3, 4 * sd_q / ess ** 0.5),
        "std": abs(std / sd_q - 1) <= 0.05 + 4 / (2 * ess) ** 0.5,
    }
    if name == "petab1e5":
        if fuse == 1:
            checks["gens"] = len(rows) == gens
        checks["quadrature"] = (f"{mu_q:.3g}", f"{sd_q:.3g}") == \
            ("0.685", "0.0523")
    if run_mode == "onedispatch":
        # config #5's models copy host constants to the card in every
        # call: their rounds are refused a capture and run eagerly
        fused = onedispatch_report(abc, rows, wall, graphs=False)
        checks.update(fused["onedispatch_checks"])
    else:
        fused = fused_report(abc, rows) if fuse > 1 else {}
        if fused:
            checks.update(fused["fused_checks"])
    return {
        "pop": STOCHASTIC_POP, "gens_asked": gens, "gens_run": len(rows),
        "ok": all(checks.values()), "checks": checks,
        "stop_reason": abc.stop_reason, "kde_launches": launches,
        "wall_s": wall, "peak_mem_gb": max(r["peak_mem_gb"] for r in rows),
        "param": name_k, "posterior_mean": mean, "posterior_std": std,
        "ess": ess, "quadrature_mean": mu_q, "quadrature_std": sd_q,
        "quadrature_points": points, "quadrature_s": quadrature_s,
        "tol_mean": max(1e-3, 4 * sd_q / ess ** 0.5),
        "tol_std_ratio": 0.05 + 4 / (2 * ess) ** 0.5,
        "pdf_norm_method": acceptor.get_config()["pdf_norm_method"],
        "generations": [
            {**generation_row(r), "temperature": r["eps"],
             "pdf_norm": acceptor.pdf_norms.get(r["t"]),
             "proposals": temperature.temperature_proposals.get(r["t"]),
             "kde_launches_expected": expected(r), "records": r["records"],
             "record_batches": r["record_batches"]} for r in rows],
        **fused,
    }, abc


def _phase_stochastic(torch, state, name: str):
    row, _ = run_stochastic(torch, name)
    state.setdefault("launches", {})[name] = row["kde_launches"]
    if name == "petab1e5":
        # K1 row (g): the generation with the most records
        g = max((r for r in row["generations"] if r["t"] >= 1),
                key=lambda r: r["records"], default=None)
        if g is not None:
            state["petab_record_shape"] = (g["records"],
                                           g["kde_support"][0]["rows"])
    emit({"phase": name, **row})
    if not row["ok"]:
        raise RuntimeError(f"{name} failed its checks: {row['checks']}")


def phase_petab1e5(torch, state):
    _phase_stochastic(torch, state, "petab1e5")


def phase_sbml1e5(torch, state):
    _phase_stochastic(torch, state, "sbml1e5")


def profile_last_generation(torch, abc, gens: int) -> dict:
    """Run ``gens - 1`` generations unprofiled, then the last one as a
    resumed ``run()`` under ``torch.profiler``: its device time by kernel
    and the device's idle share."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    abc.run(max_nr_populations=gens - 1)
    torch.cuda.synchronize()
    # device activity only: host-side op events would double the
    # attribution (an ATen op carries its kernel's time) and take minutes
    # to post-process at ~1e5 kernels
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        abc.run(max_nr_populations=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    gen = abc.timeline[-1]

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_s = sum(dev_us(e) for e in kernels) * 1e-6
    if busy_s <= 0:
        raise RuntimeError("the profiler saw no device time")
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    return {"t": gen["t"], "wall_s": wall, "sample_s": gen["sample_s"],
            "evaluations": gen["evaluations"],
            "rounds": int(np.ceil(gen["evaluations"] / gen["batch"])),
            "batch": gen["batch"], "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / wall,
            "device_launches": sum(e.count for e in kernels),
            "kde_launches": gen["kde_launches"],
            "top_device": [{"name": e.key[:80], "calls": e.count,
                            "device_s": dev_us(e) * 1e-6} for e in top]}


def phase_profile(torch, state):
    """The slowest generation of the pop-1e6 run (generation 10)."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import make_two_gaussians_problem

    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(
        models, priors, distance, population_size=1_000_000,
        eps=pt.MedianEpsilon(),
        sampler=pt.VectorizedSampler(max_batch_size=1 << 19,
                                     max_rounds_per_call=16, device="cuda"),
        stores_sum_stats=False, ingest_mode="sequential",
        history_mode="eager", seed=0, device="cuda")
    abc.new("sqlite://", observed)
    emit({"phase": "profile", "ok": True,
          **profile_last_generation(torch, abc, 11)})


def simulator_call(torch, model, theta) -> dict:
    """The device time and kernel launches of one simulator call at the
    batch size, as ``torch.profiler`` sees them, and the wall of one
    unprofiled call between two device syncs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=theta.device)
    gen.manual_seed(1)
    model.simulate(gen, theta)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.simulate(gen, theta)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.simulate(gen, theta)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in kernels) * 1e-6
    return {"batch": int(theta.shape[0]), "device_s": busy,
            "launches": sum(e.count for e in kernels), "wall_s": wall}


def timed_generation(torch, abc) -> dict:
    """One more generation, unprofiled, with the model's ``simulate``
    timed on the host clock between two device syncs: the simulator's
    seconds against the generation's ``sample_s``."""
    model = abc.models[0]
    spent = []

    def timed(generator, theta):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(generator, theta)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    real, model.simulate = model.simulate, timed
    try:
        abc.run(max_nr_populations=1)
    finally:
        del model.simulate
    gen = abc.timeline[-1]
    return {"t": gen["t"], "sample_s": gen["sample_s"],
            "simulator_calls": len(spent), "simulator_s": sum(spent),
            "simulator_share_of_sample_s": sum(spent) / gen["sample_s"]}


def phase_simprof(torch, state):
    """For each adaptive workload: its last generation profiled, one more
    with the simulator timed, and one simulator call at the batch size
    profiled on its own; for each config-#5 workload, one simulator call
    at its batch size."""
    for name, (make, *_) in STOCHASTIC.items():
        importer = make()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        theta = importer.create_prior().rvs_array(gen, STOCHASTIC_BATCH)
        emit({"phase": "simprof", "workload": name, "ok": True,
              "simulator_call": simulator_call(
                  torch, importer.create_model(), theta)})
    for name in ADAPTIVE:
        abc, _, priors, _ = adaptive_abc(name)
        row = profile_last_generation(torch, abc, ADAPTIVE[name][2])
        split = timed_generation(torch, abc)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        theta = priors[0].rvs_array(gen, row["batch"])
        emit({"phase": "simprof", "workload": name, "ok": True, **row,
              "timed_generation": split,
              "simulator_call": simulator_call(torch, abc.models[0],
                                               theta)})


def phase_repeat(torch, state):
    """Whether the card repeats: the scans behind resampling, then
    config #2 fused at pop 16384 over twenty seeds."""
    from pyabc_tpu_torch.ops.choice import ordered_cumsum

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    scans = {}
    for n in (16384, 100_000, 1_000_000, 1_500_000):
        x = torch.softmax(torch.randn(n, generator=gen, device="cuda"), 0)
        row = {}
        for name, fn in (("torch_cumsum", lambda v: torch.cumsum(v, 0)),
                         ("ordered_cumsum", ordered_cumsum)):
            ref = fn(x)
            row[name] = sum(not torch.equal(fn(x), ref) for _ in range(50))
        scans[n] = row
    emit({"phase": "repeat", "ok": True, "calls": 50,
          "differing_calls": scans})
    rows = []
    for seed in range(20):
        r = run_main_path(torch, 16384, 11, seed=seed, fuse=FUSE_K)
        rows.append({"seed": seed, "ok": r["ok"],
                     "ess": r["generations"][-1]["ess"],
                     "pb_err": r["p_model_b"] - r["p_analytic"],
                     "paths": "".join(p[0] for p in r["paths"]),
                     "wall_s": r["wall_s"]})
    emit({"phase": "repeat", "ok": True, "fused16384_seeds": rows,
          "collapsed": sum(r["ess"] < 0.01 * 16384 or not r["ok"]
                           for r in rows)})


# ------------------------------------------------- the component library

#: the library phase: draws per family for the goodness-of-fit tests, the
#: p-value every family must pass, and the card-vs-CPU tolerances —
#: elementwise functions ``LIB_TOL_ABS + LIB_TOL_REL·|cpu|``, reductions
#: over LIB_POINTS rows ``LIB_TOL_REDUCE`` relative (float32 sums in
#: another order)
LIBRARY_DRAWS = 1_000_000
LIBRARY_P_MIN = 1e-3
LIB_TOL_ABS = 1e-5
LIB_TOL_REL = 1e-5
LIB_TOL_REDUCE = 1e-4
LIB_POINTS = 100_000
#: name, args, kwargs (RV(...) and scipy.stats alike), grid of log_pdf/cdf
LIBRARY_FAMILIES = [
    ("norm", (0.5, 2.0), {}, (-6.0, 7.0)),
    ("uniform", (-1.0, 3.0), {}, (-2.0, 3.0)),
    ("lognorm", (), {"s": 0.7, "scale": 1.5}, (-1.0, 8.0)),
    ("expon", (0.2, 1.5), {}, (-1.0, 9.0)),
    ("laplace", (0.3, 0.8), {}, (-4.0, 4.0)),
    ("cauchy", (0.1, 0.5), {}, (-6.0, 6.0)),
    ("gamma", (2.5,), {"scale": 1.3}, (-1.0, 12.0)),
    ("beta", (2.0, 5.0), {}, (-0.2, 1.2)),
    ("randint", (2, 9), {}, (-1.0, 12.0)),
    ("poisson", (3.5,), {}, (0.0, 16.0)),
    ("t", (4.0, 0.2, 1.5), {}, (-9.0, 9.0)),
    ("chi2", (3.0,), {}, (-1.0, 14.0)),
    ("weibull_min", (1.7, 0.0, 2.0), {}, (-1.0, 7.0)),
    ("binom", (12, 0.3), {}, (-2.0, 15.0)),
    ("nbinom", (5, 0.4), {}, (-2.0, 30.0)),
]


def _compare(card, host, atol, rtol):
    """``(ok, max_abs_err)`` of a card result against the CPU's: equal
    infinities and NaNs agree, anything else within ``atol + rtol·|cpu|``;
    integer tensors must be equal."""
    import torch
    a, b = card.detach().cpu(), host.detach()
    if not a.is_floating_point():
        return bool(torch.equal(a, b)), float((a != b).sum())
    a, b = a.double(), b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    err = torch.where(same, torch.zeros_like(a), (a - b).abs())
    bad = torch.isnan(err) | (err > atol + rtol * b.abs().nan_to_num(0.0))
    return (not bool(bad.any())), float(err.nan_to_num(math.inf).max())


def _goodness_of_fit(draws, frozen, discrete) -> tuple:
    """``(test, p)``: KS for a continuous family, χ² over the support
    (expected counts >= 5, the rest lumped) for a discrete one."""
    import numpy as np
    import scipy.stats as ss
    if not discrete:
        return "ks", float(ss.kstest(draws, frozen.cdf).pvalue)
    ks, counts = np.unique(draws, return_counts=True)
    expected = frozen.pmf(ks) * draws.size
    keep = expected >= 5
    obs, exp = counts[keep], expected[keep]
    rest = draws.size - exp.sum()
    if rest > 1e-6 * draws.size:
        obs = np.append(obs, counts[~keep].sum())
        exp = np.append(exp, rest)
    return "chi2", float(ss.chisquare(obs, exp * obs.sum() / exp.sum()
                                      ).pvalue)


def phase_library(torch, state):
    """Every deterministic function of the component library on the card
    and on the CPU from one seeded numpy input, held to the stated
    tolerances; then 1e6 draws per family from a card generator against
    scipy."""
    import numpy as np
    import scipy.stats as ss

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch import weighted_statistics as ws
    from pyabc_tpu_torch.convert import install_local_transition, to_torch
    from pyabc_tpu_torch.ops.choice import residual_weighted_choice
    from pyabc_tpu_torch.ops.quantile_sketch import sketch_error_bound
    from pyabc_tpu_torch.sumstat import SumStatSpec

    t_phase = time.perf_counter()
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    rng = np.random.default_rng(20261017)
    checks = {}

    def agree(key, fn, atol=LIB_TOL_ABS, rtol=LIB_TOL_REL):
        card, host = fn(cuda), fn(cpu)
        ok, err = _compare(card, host, atol, rtol)
        checks[key] = {"ok": ok, "max_abs_err": err}

    def on(arr, dev):
        return torch.as_tensor(arr, device=dev)

    def rv_cases():
        for name, args, kwargs, (lo, hi) in LIBRARY_FAMILIES:
            yield name, pt.RV(name, *args, **kwargs), (lo, hi), \
                getattr(ss, name)(*args, **kwargs)
        yield ("truncated_norm", pt.TruncatedRV(pt.RV("norm", 0.0, 1.0),
                                                lower=0.0),
               (-1.0, 4.0), ss.truncnorm(0.0, np.inf))
        yield ("lower_bound_gamma",
               pt.LowerBoundDecorator(pt.RV("gamma", 2.0), 0.5),
               (0.0, 8.0), None)
        yield ("tabulated_gumbel_r", pt.TabulatedRV("gumbel_r", 0.5, 1.2),
               (-3.0, 9.0), ss.gumbel_r(0.5, 1.2))
        yield ("tabulated_hypergeom", pt.TabulatedRV("hypergeom", 20, 7, 12),
               (-1.0, 10.0), ss.hypergeom(20, 7, 12))

    draws_out = {}
    for i, (name, rv, (lo, hi), frozen) in enumerate(rv_cases()):
        grid = (np.arange(lo, hi + 0.5, 0.5) if rv.discrete
                else np.linspace(lo, hi, 4097)).astype(np.float32)
        agree(f"{name}.log_pdf", lambda d: rv.log_pdf(on(grid, d)))
        agree(f"{name}.cdf", lambda d: rv.cdf(on(grid, d)))
        gen = torch.Generator(device=cuda)
        gen.manual_seed(1000 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = rv.sample(gen, (LIBRARY_DRAWS,))
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t0
        row = {"sample_s": sample_s, "finite": bool(torch.isfinite(x).all())}
        if frozen is not None:
            test, pval = _goodness_of_fit(
                x.cpu().numpy().astype(np.float64), frozen, rv.discrete)
            row.update({"test": test, "p": pval,
                        "ok": row["finite"] and pval > LIBRARY_P_MIN})
        else:
            row["ok"] = row["finite"]
        draws_out[name] = row

    # the eight distances: calibrate, one adaptive update from the same
    # records, then a query batch under generation 1's params
    x0 = {"a": np.array([0.5, -1.0], np.float32), "b": np.float32(2.0)}
    calib = {"a": rng.normal(0, [1.0, 3.0], (4000, 2)).astype(np.float32),
             "b": rng.gamma(2.0, 1.0, 4000).astype(np.float32)}
    records = {"a": rng.normal(0.2, [0.5, 2.0], (20000, 2)).astype(
        np.float32), "b": rng.gamma(3.0, 0.5, 20000).astype(np.float32)}
    query = {"a": rng.normal(0, 1.5, (8192, 2)).astype(np.float32),
             "b": rng.gamma(2.0, 1.0, 8192).astype(np.float32)}
    distances = {
        "AggregatedDistance": lambda: pt.AggregatedDistance(
            [pt.PNormDistance(p=1), pt.ZScoreDistance()],
            weights=[1.0, 0.5], factors=[2.0, 1.0]),
        "AdaptiveAggregatedDistance": lambda: pt.AdaptiveAggregatedDistance(
            [pt.PNormDistance(p=2), pt.MinMaxDistance(p=1)]),
        "ZScoreDistance": pt.ZScoreDistance,
        "PCADistance": pt.PCADistance,
        "DistanceWithMeasureList": lambda: pt.DistanceWithMeasureList(
            measures_to_use=["a"], p=1.5),
        "RangeEstimatorDistance": lambda: pt.RangeEstimatorDistance(p=2),
        "MinMaxDistance": lambda: pt.MinMaxDistance(p=2),
        "PercentileDistance": lambda: pt.PercentileDistance(
            measures_to_use=["b"]),
    }

    def distance_on(make, dev):
        d = make()
        spec = SumStatSpec.from_example(x0)
        d.bind(spec, x0)
        d.initialize(0, lambda: {k: on(v, dev) for k, v in calib.items()},
                     x0, spec)
        d.update(1, lambda: {k: on(v, dev) for k, v in records.items()})
        stats = spec.flatten({k: on(v, dev) for k, v in query.items()})
        return d.compute(stats, spec.flatten_single(x0, device=dev),
                         to_torch(d.get_params(1), dev))

    for name, make in distances.items():
        agree(name, lambda dev: distance_on(make, dev))

    # LocalTransition's density given installed params (a CPU fit)
    support = rng.normal(0, 1, (4096, 4)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 4096).astype(np.float32)
    fit = pt.LocalTransition(device="cpu").fit(support, w)
    local = install_local_transition(pt.LocalTransition(device="cpu"),
                                     fit.theta, fit.w, fit._chols,
                                     fit._log_norms)
    queries = rng.normal(0, 1.5, (4096, 4)).astype(np.float32)
    agree("LocalTransition.log_pdf_from_params",
          lambda d: pt.LocalTransition.log_pdf_from_params(
              on(queries, d), to_torch(local.get_params(), d)))

    # weighted statistics and the residual choice over LIB_POINTS rows
    px = rng.normal(1.0, 2.0, LIB_POINTS).astype(np.float32)
    pw = rng.exponential(1.0, LIB_POINTS).astype(np.float32)
    for fn in ("weighted_mean", "weighted_std", "weighted_var"):
        agree(fn, lambda d: getattr(ws, fn)(on(px, d), on(pw, d))[None],
              atol=0.0, rtol=LIB_TOL_REDUCE)
    agree("weighted_mse", lambda d: ws.weighted_mse(
        on(px, d), on(pw, d), 0.7)[None], atol=0.0, rtol=LIB_TOL_REDUCE)
    agree("effective_sample_size",
          lambda d: ws.effective_sample_size(on(pw, d))[None],
          atol=0.0, rtol=LIB_TOL_REDUCE)
    for alpha in (0.1, 0.5, 0.9):
        agree(f"weighted_quantile({alpha})", lambda d: ws.weighted_quantile(
            on(px, d), on(pw, d), alpha)[None], atol=0.0,
            rtol=LIB_TOL_REDUCE)
    bound = sketch_error_bound(float(px.min()), float(px.max()))
    agree("weighted_quantile(0.5, sketch)", lambda d: ws.weighted_quantile(
        on(px, d), on(pw, d), 0.5, method="sketch")[None], atol=bound,
        rtol=0.0)
    log_w = np.log(pw).astype(np.float32)
    for n in (4096, LIB_POINTS):
        agree(f"residual_weighted_choice({n})",
              lambda d: residual_weighted_choice(on(log_w, d), n))
    agree("resample_indices_deterministic(sorted)",
          lambda d: ws.resample_indices_deterministic(
              on(pw / pw.sum(), d), 4096, rank_cap=None))

    ok = (all(c["ok"] for c in checks.values())
          and all(r["ok"] for r in draws_out.values()))
    emit({"phase": "library", "ok": ok,
          "seconds": time.perf_counter() - t_phase, "tol_abs": LIB_TOL_ABS,
          "tol_rel": LIB_TOL_REL, "tol_reduce_rel": LIB_TOL_REDUCE,
          "draws": LIBRARY_DRAWS, "p_min": LIBRARY_P_MIN,
          "card_vs_cpu": checks, "samples": draws_out})
    if not ok:
        raise RuntimeError("library: a card result or a family's draws "
                           "failed")


#: the analytic suite at pop 1e5 per problem
STATS_POP = 100_000


def stats_problems(torch):
    """The JAX package's tests/test_statistical.py problems on the card:
    name -> (ABCSMC kwargs, observed, run kwargs, verdict(history) ->
    (deviation, tolerance))."""
    import numpy as np
    from scipy.special import binom as sp_binom, gamma as sp_gamma

    import pyabc_tpu_torch as pt

    def jar(theta):
        def model(generator, th):
            p = torch.full((th.shape[0],), 1.0 - theta, device=th.device)
            return {"result": torch.bernoulli(p, generator=generator)}
        return pt.SimpleModel(model, name=f"jar{theta}")

    def cookie_verdict(h):
        mp = h.get_model_probabilities(h.max_t)
        dev = (abs(float(mp.get(0, 0.0)) - 0.25)
               + abs(float(mp.get(1, 0.0)) - 0.75))
        return dev, 0.05

    def bb_model(generator, th):
        p = th[:, 0:1].expand(th.shape[0], 5)
        return {"result": torch.bernoulli(p, generator=generator).sum(1)}

    def bb_verdict(h):
        def evidence(a, b):
            beta = lambda x, y: sp_gamma(x) * sp_gamma(y) / sp_gamma(x + y)
            return sp_binom(5, 2) * beta(a + 2, b + 3) / beta(a, b)
        e1, e2 = evidence(1.0, 1.0), evidence(10.0, 1.0)
        mp = h.get_model_probabilities(h.max_t)
        dev = (abs(float(mp.get(0, 0.0)) - e1 / (e1 + e2))
               + abs(float(mp.get(1, 0.0)) - e2 / (e1 + e2)))
        return dev, 0.08

    def su_model(generator, th):
        u = th[:, 0]
        return {"result": u * torch.rand(u.shape, generator=generator,
                                         device=u.device)}

    def su_verdict(h):
        df, w = h.get_distribution(m=0)
        x = df["u"].to_numpy()
        order = np.argsort(x)
        xs = np.hstack((-200.0, x[order], 200.0))
        cdf = np.hstack((0.0, np.cumsum(w[order]), 1.0))
        grid = np.linspace(0.1, 1.0, 50)
        f = np.where(grid > 0.5, (np.log(grid) - np.log(0.5))
                     / (-np.log(0.5)), 0.0)
        return float(np.abs(np.interp(grid, xs, cdf) - f).max()), 0.12

    y = np.random.default_rng(5).exponential(1.0 / 1.6, size=8).astype(
        np.float32)

    def eg_model(generator, theta):
        lam = torch.clamp(theta[:, :1], min=1e-6)
        u = 1e-7 + (1.0 - 1e-7) * torch.rand(
            theta.shape[0], 8, generator=generator, device=theta.device)
        return {"ybar": (-torch.log(u) / lam).mean(1)}

    def eg_verdict(h):
        df, w = h.get_distribution()
        lam = float(np.sum(df["lam"].to_numpy() * w))
        post = (2.0 + 8) / (1.0 + float(np.sum(y)))
        return abs(lam - post) / post, 0.2

    def tn_model(generator, theta):
        mu = theta[:, 0]
        return {"y": mu + 0.2 * torch.randn(mu.shape, generator=generator,
                                            device=mu.device)}

    def tn_verdict(h):
        df, w = h.get_distribution()
        draws = df["mu"].to_numpy()
        mean = float(np.sum(draws * w))
        # in bounds and 0 < mean < 0.45: the deviation from the band's
        # middle against its half-width
        inside = bool((draws >= 0.0).all())
        return (abs(mean - 0.225) if inside else math.inf), 0.225

    return {
        "cookie_jar": (dict(models=[jar(0.2), jar(0.6)],
                            parameter_priors=[pt.Distribution(),
                                              pt.Distribution()],
                            distance_function=pt.MinMaxDistance(),
                            eps=pt.MedianEpsilon(0.1), seed=8),
                       {"result": 0},
                       dict(minimum_epsilon=0.2, max_nr_populations=1),
                       cookie_verdict),
        "beta_binomial": (dict(models=[pt.SimpleModel(bb_model, name="m1"),
                                       pt.SimpleModel(bb_model, name="m2")],
                               parameter_priors=[
                                   pt.Distribution(theta=pt.RV("beta", 1, 1)),
                                   pt.Distribution(
                                       theta=pt.RV("beta", 10, 1))],
                               distance_function=pt.MinMaxDistance(),
                               eps=pt.MedianEpsilon(0.1), seed=10),
                          {"result": 2},
                          dict(minimum_epsilon=0.2, max_nr_populations=3),
                          bb_verdict),
        "continuous_non_gaussian": (
            dict(models=pt.SimpleModel(su_model, name="scaled_uniform"),
                 parameter_priors=pt.Distribution(
                     u=pt.RV("uniform", 0.0, 1.0)),
                 distance_function=pt.MinMaxDistance(),
                 eps=pt.MedianEpsilon(0.2), seed=12),
            {"result": 0.5}, dict(minimum_epsilon=-1, max_nr_populations=2),
            su_verdict),
        "exponential_gamma": (
            dict(models=pt.SimpleModel(eg_model),
                 parameter_priors=pt.Distribution(
                     lam=pt.RV("gamma", 2.0, scale=1.0)),
                 distance_function=pt.PNormDistance(p=1), seed=17),
            {"ybar": float(np.mean(y))},
            dict(max_nr_populations=7, minimum_epsilon=1e-3), eg_verdict),
        "truncated_prior": (
            dict(models=pt.SimpleModel(tn_model),
                 parameter_priors=pt.Distribution(
                     mu=pt.TruncatedRV(pt.RV("norm", 0.0, 1.0), lower=0.0)),
                 distance_function=pt.PNormDistance(p=2), seed=13),
            {"y": 0.15}, dict(max_nr_populations=4), tn_verdict),
    }


def phase_stats1e5(torch, state):
    """The analytic suite at pop 1e5 per problem through ``ABCSMC.run``'s
    defaults on the card, each held to its JAX test's own tolerance, with
    K1 in every generation t >= 1 of every model that has parameters."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda

    t_phase = time.perf_counter()
    rows, launches_total = {}, 0
    for name, (kw, observed, run_kw, verdict) in stats_problems(torch).items():
        abc = pt.ABCSMC(population_size=STATS_POP, device="cuda", **kw)
        abc.new("sqlite://", observed)
        weighted_kde_logpdf_cuda.launches = 0
        t0 = time.perf_counter()
        h = abc.run(**run_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = weighted_kde_logpdf_cuda.launches
        launches_total += launches
        dev, tol = verdict(h)
        with_params = sum(p.dim > 0 for p in abc.parameter_priors)
        per_gen = [r["kde_launches"] for r in abc.timeline if r["t"] >= 1]
        checks = {"deviation": bool(dev < tol),
                  "launches": all(k >= with_params for k in per_gen),
                  "gens": len(abc.timeline) >= 1}
        # each finalize: the generation's particles against each model's
        # support rows
        shapes = [(r["n"], sup["rows"], abc.parameter_priors[m].dim)
                  for r in abc.timeline if r["t"] >= 1
                  for m, sup in enumerate(r["kde_support"] or ()) if sup]
        if shapes and max(shapes) > state.get("stats_finalize_shape", (0,)):
            state["stats_finalize_shape"] = max(shapes)
            state["stats_finalize_problem"] = name
        rows[name] = {"ok": all(checks.values()), "checks": checks,
                      "deviation": dev, "tolerance": tol, "wall_s": wall,
                      "kde_launches": launches,
                      "kde_launches_by_gen": per_gen,
                      "gens_run": len(abc.timeline),
                      "peak_mem_gb": max((r["peak_mem_gb"]
                                          for r in abc.timeline), default=0)}
    state.setdefault("launches", {})["stats1e5"] = launches_total
    ok = all(r["ok"] for r in rows.values())
    emit({"phase": "stats1e5", "ok": ok,
          "seconds": time.perf_counter() - t_phase, "pop": STATS_POP,
          "largest_finalize": {
              "problem": state.get("stats_finalize_problem"),
              "shape": state.get("stats_finalize_shape")},
          "problems": rows})
    if not ok:
        raise RuntimeError("stats1e5: a problem missed its JAX tolerance "
                           "or K1 did not run")


#: config #2 under AdaptivePopulationSize: start, bound, generations and
#: the target CV (at pop 16384 config #2's bootstrap CV reads ~0.02, so
#: 0.01 asks for a larger population)
ADAPTIVEPOP_START = 16384
ADAPTIVEPOP_MAX = 1 << 18
ADAPTIVEPOP_GENS = 8
ADAPTIVEPOP_CV = 0.01


def phase_adaptivepop(torch, state):
    """Config #2 with ``AdaptivePopulationSize``: each generation has the
    size the strategy set, K1 runs as often as the code gives (the
    finalize's 2 plus sizes × alive models × n_bootstrap refits) and
    run_gate's tolerances hold at the last generation's size."""
    import numpy as np

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import make_two_gaussians_problem
    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda

    t_phase = time.perf_counter()
    models, priors, distance, observed, posterior_fn = \
        make_two_gaussians_problem()
    strategy = pt.AdaptivePopulationSize(
        ADAPTIVEPOP_START, mean_cv=ADAPTIVEPOP_CV,
        max_population_size=ADAPTIVEPOP_MAX)
    abc = pt.ABCSMC(
        models, priors, distance, population_size=strategy,
        eps=pt.MedianEpsilon(),
        sampler=pt.VectorizedSampler(max_batch_size=1 << 19,
                                     max_rounds_per_call=16, device="cuda"),
        stores_sum_stats=False, history_mode="eager", seed=0,
        device="cuda")
    abc.new("sqlite://", observed)
    weighted_kde_logpdf_cuda.launches = 0
    t0 = time.perf_counter()
    abc.run(max_nr_populations=ADAPTIVEPOP_GENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = weighted_kde_logpdf_cuda.launches
    updates = strategy.updates
    rows = abc.timeline
    by_t = {u["t"]: u for u in updates}
    expected = {r["t"]: 2 + len(by_t[r["t"]]["sizes"])
                * by_t[r["t"]]["alive"] * strategy.n_bootstrap
                for r in rows if r["t"] >= 1}
    t_last = abc.history.max_t
    pop = rows[-1]["n"]
    p_b = float(abc.history.get_model_probabilities(t_last).get(1, 0.0))
    p_true = float(posterior_fn(1.0))
    df, w = abc.history.get_distribution(m=1, t=t_last)
    mu = float(np.sum(df["mu"].to_numpy() * w)) if len(df) else math.nan
    tol_p = max(2.5e-3, 2.5 / pop ** 0.5)
    tol_mu = max(3e-3, 3.0 / pop ** 0.5)
    checks = {
        "gens": len(rows) == ADAPTIVEPOP_GENS,
        "sizes": (rows[0]["n"] == ADAPTIVEPOP_START
                  and all(r["n"] == by_t[r["t"]]["after"]
                          for r in rows if r["t"] >= 1)),
        "size_changed": any(r["n"] != ADAPTIVEPOP_START for r in rows),
        "launches": all(r["kde_launches"] == expected[r["t"]]
                        for r in rows if r["t"] >= 1),
        "gate": abs(p_b - p_true) < tol_p and abs(mu - 1.0) < tol_mu,
    }
    boot_shapes = [sh for u in updates for sh in u["density_shapes"]]
    if boot_shapes:
        state["adaptivepop_boot_shape"] = max(boot_shapes)
    state.setdefault("launches", {})["adaptivepop"] = launches
    ok = all(checks.values())
    emit({"phase": "adaptivepop", "ok": ok,
          "seconds": time.perf_counter() - t_phase, "checks": checks,
          "mean_cv": ADAPTIVEPOP_CV, "start": ADAPTIVEPOP_START,
          "max_population_size": ADAPTIVEPOP_MAX, "wall_s": wall,
          "kde_launches": launches, "p_model_b": p_b, "p_analytic": p_true,
          "tol_p": tol_p, "mu_b": mu, "tol_mu": tol_mu,
          "bootstrap_shape_max": state.get("adaptivepop_boot_shape"),
          "peak_mem_gb": max(r["peak_mem_gb"] for r in rows),
          "generations": [{**generation_row(r), "n": r["n"],
                           "adapt_s": r["adapt_s"],
                           "kde_launches_expected": expected.get(r["t"])}
                          for r in rows],
          "updates": updates})
    if not ok:
        raise RuntimeError(f"adaptivepop failed its checks: {checks}")


#: config #3 with the local transition
LOCAL_POP = 10_000


def phase_local1e4(torch, state):
    """lv1e5's model, priors and data with ``LocalTransition()`` at pop
    1e4: lv1e5's posterior and ε gates, its peak memory reported."""
    import pyabc_tpu_torch as pt
    t_phase = time.perf_counter()
    row = run_adaptive(torch, "lv1e5", pop=LOCAL_POP,
                       transitions=[pt.LocalTransition()])
    row["seconds"] = time.perf_counter() - t_phase
    state.setdefault("launches", {})["local1e4"] = row["kde_launches"]
    row["peak_mem_gb_by_gen"] = [g["peak_mem_gb"]
                                 for g in row["generations"]]
    emit({"phase": "local1e4", **row})
    if not row["ok"]:
        raise RuntimeError(f"local1e4 failed its checks: {row['checks']}")


# ---------------------------------------------------- fidelity and capacity

#: the JAX package's bench_fidelity rows (bench.py:1878-2022)
FID_POP = 50_000
FID_BATCH = 1 << 18
FID_WARMUP, FID_TIMED = 2, 3
FID_AUDIT_ROWS = 2048
FID_PROBLEMS = {"fidelitysir5e4": "sir", "fidelitylv5e4": "lv"}


def fid_problem(which: str):
    """``_fid_problem``'s screen-eligible SIR / LV problems in the port:
    the full-width models, their priors and truths, a plain
    ``PNormDistance(p=2)``, observed data from a CPU generator seeded 11
    (SIR) or 7 (LV)."""
    import torch

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models.lotka_volterra import LotkaVolterraSDE
    from pyabc_tpu_torch.models.sir import SIRTauLeap
    from pyabc_tpu_torch.random_variables import RV, Distribution

    if which == "sir":
        model = SIRTauLeap()
        prior = Distribution(log_beta=RV("uniform", -2.0, 3.0),
                             log_gamma=RV("uniform", -3.0, 3.0))
        truth, seed = [0.8, 0.2], 11
    else:
        model = LotkaVolterraSDE()
        prior = Distribution(log_a=RV("uniform", -1.0, 2.0),
                             log_b=RV("uniform", -3.0, 2.0),
                             log_c=RV("uniform", -2.0, 2.0),
                             log_d=RV("uniform", -1.0, 2.0))
        truth, seed = [1.1, 0.4, 1.0, 0.4], 7
    gen = torch.Generator()
    gen.manual_seed(seed)
    obs = model.simulate(gen, torch.log(torch.tensor([truth])))
    observed = {k: v[0].numpy() for k, v in obs.items()}
    return [model], [prior], pt.PNormDistance(p=2), observed, truth


def posterior_moments(abc, priors, truth) -> dict:
    """The last generation's weighted mean, std and ESS per parameter,
    and configs #3/#4's gate: the mean within 4 posterior std of the
    generating value, each std at most 0.75 of the prior's."""
    import numpy as np

    names = priors[0].get_parameter_names()
    df, w = abc.history.get_distribution(m=0, t=abc.history.max_t)
    x = df[names].to_numpy(np.float64)
    w = np.asarray(w, np.float64) / np.sum(w)
    mean = (w[:, None] * x).sum(0)
    std = np.sqrt((w[:, None] * (x - mean) ** 2).sum(0))
    log_truth = np.log(np.asarray(truth))
    prior_std = np.array([priors[0][k].scale for k in names]) / 12 ** 0.5
    return {"mean": mean, "std": std, "ess": float(1.0 / np.sum(w * w)),
            "gate": bool(np.all(np.abs(mean - log_truth) <= 4 * std)
                         and np.all(std <= 0.75 * prior_std)),
            "truth": log_truth, "prior_std": prior_std}


def run_fidelity_arm(torch, which: str, screen: bool) -> dict:
    """One arm of the A/B: ``fidelity="off"`` or the bench's
    ``FidelityConfig(full_fraction=0.15, cal_rows=4096)``, pop 5e4, batch
    pinned at 2^18, K = 4, ``QuantileEpsilon(alpha=0.15)``, 2 warm-up and
    3 timed generations.  A screened device generation's row carries its
    threshold ``screen_tau`` and the calibration facts behind it."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.fidelity import FidelityConfig
    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda

    cfg = FidelityConfig(full_fraction=0.15, cal_rows=4096)
    models, priors, distance, observed, truth = fid_problem(which)
    abc = pt.ABCSMC(
        models, priors, distance, population_size=FID_POP,
        sampler=pt.VectorizedSampler(min_batch_size=FID_BATCH,
                                     max_batch_size=FID_BATCH,
                                     device="cuda"),
        fuse_generations=4, stores_sum_stats=False,
        eps=pt.QuantileEpsilon(alpha=0.15), seed=0,
        fidelity=cfg if screen else "off", device="cuda")
    abc.new("sqlite://", observed)
    weighted_kde_logpdf_cuda.launches = 0
    t0 = time.perf_counter()
    abc.run(max_nr_populations=FID_WARMUP + FID_TIMED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = weighted_kde_logpdf_cuda.launches
    rows = list(abc.timeline)
    timed = [r for r in rows if r["t"] >= FID_WARMUP]
    # the timed generations whose round screened (a finite threshold)
    screened = [r for r in timed if math.isfinite(r.get("screen_tau",
                                                        math.inf))]
    full_sims = sum(r.get("sims_full", r["evaluations"]) for r in rows)
    return {"abc": abc, "cfg": cfg, "models": models, "priors": priors,
            "observed": observed, "truth": truth, "rows": rows,
            "wall_s": wall, "kde_launches": launches,
            "accepted_per_s": FID_POP / statistics.median(
                r["wall_s"] for r in timed),
            "accepted_per_s_screened": (FID_POP / statistics.median(
                r["wall_s"] for r in screened) if screened else None),
            "timed_screened": [r["t"] for r in screened],
            "gen_times_s": [r["wall_s"] for r in timed],
            "sims_per_accepted": full_sims / (FID_POP * len(rows)),
            "blocks": [{k: b.get(k) for k in ("t", "K", "written",
                                              "rounds", "round_caps",
                                              "max_rounds")}
                       for b in abc.blocks],
            "moments": posterior_moments(abc, priors, truth)}


def fidelity_audit(torch, arm: dict) -> dict:
    """``bench_fidelity``'s paired audit: the final population's first
    2048 particles through both fidelities (one seed for both), the
    numpy mirror of the calibrator at the final epsilon, and the realized
    screen-pass and false-reject rates."""
    import numpy as np

    from pyabc_tpu_torch.fidelity import screen_threshold_np

    abc, cfg = arm["abc"], arm["cfg"]
    eps_final = float(abc.history.get_all_populations().epsilon.iloc[-1])
    df, _ = abc.history.get_distribution(m=0, t=abc.history.max_t)
    names = arm["priors"][0].get_parameter_names()
    thetas = torch.as_tensor(df[names].to_numpy(np.float32)[
        :FID_AUDIT_ROWS], device="cuda")
    model = arm["models"][0]
    obs = arm["observed"]

    def dist(m):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1234)
        stats = m.simulate(gen, thetas)
        arr = np.concatenate(
            [stats[k].reshape(thetas.shape[0], -1).cpu().numpy()
             for k in sorted(stats)], axis=1).astype(np.float64)
        flat = np.concatenate([np.ravel(obs[k]) for k in sorted(obs)])
        return np.sqrt(((arr - flat[None, :]) ** 2).sum(1))

    d_full, d_lo = dist(model), dist(model.low_fidelity())
    tau = screen_threshold_np(d_lo, d_full, eps_final,
                              q=cfg.false_reject_q, margin=cfg.margin,
                              min_corr=cfg.min_corr,
                              min_pairs=cfg.min_pairs)
    acceptable = d_full <= eps_final
    n_acc = int(acceptable.sum())
    if np.isfinite(tau) and n_acc:
        screen_rate = float(np.mean(d_lo <= tau))
        false_reject = float(np.mean(d_lo[acceptable] > tau))
    else:
        screen_rate, false_reject = 1.0, 0.0   # no screen: no debt
    q = cfg.false_reject_q
    limit = q + 3.0 * math.sqrt(q * (1.0 - q) / max(n_acc, 1))
    return {"eps_final": eps_final, "tau": tau, "n_acceptable": n_acc,
            "screen_rate": screen_rate, "false_reject": false_reject,
            "false_reject_limit": limit, "ok": false_reject <= limit}


def stage_launches(torch, arm: dict) -> dict:
    """Simulator kernel launches per round of each stage: one
    low-fidelity call on the batch and one full-fidelity call on the
    slots, profiled (``simulator_call``), at prior draws."""
    model = arm["models"][0]
    prior = arm["priors"][0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    n_full = arm["cfg"].n_full(FID_BATCH)
    theta = prior.rvs_array(gen, FID_BATCH)
    return {"low": simulator_call(torch, model.low_fidelity(), theta),
            "full": simulator_call(torch, model, theta[:n_full]),
            "n_full": n_full}


def _phase_fidelity(torch, state, name: str):
    which = FID_PROBLEMS[name]
    off = run_fidelity_arm(torch, which, screen=False)
    scr = run_fidelity_arm(torch, which, screen=True)
    audit = fidelity_audit(torch, scr)
    stages = stage_launches(torch, scr)
    mo, ms = off["moments"], scr["moments"]
    noise = 4.0 * (mo["std"] ** 2 / mo["ess"]
                   + ms["std"] ** 2 / ms["ess"]) ** 0.5
    screened = [r for r in scr["rows"] if "sims_full" in r]
    n_full = scr["cfg"].n_full(FID_BATCH)
    cfg = scr["cfg"]
    checks = {
        "round_graph": graphs_ok(off["rows"]) and graphs_ok(scr["rows"]),
        "posterior_off": mo["gate"], "posterior_screen": ms["gate"],
        "screen_vs_off": bool((abs(ms["mean"] - mo["mean"])
                               <= noise).all()),
        # every generation after the first ran staged on the device: no
        # screened block fell short and handed a generation back
        "screened_rows": [r["t"] for r in screened]
        == list(range(1, FID_WARMUP + FID_TIMED)),
        "sims": all(r["sims_full"] <= r["sims_low"]
                    and r["sims_full"] == r["rounds"] * n_full
                    and r["sims_low"] == r["rounds"] * FID_BATCH
                    for r in screened),
        # the first block's carry comes from a sequential generation: NaN
        # rings, no screen in its first generation
        "first_unscreened": bool(screened)
        and screened[0]["screen_tau"] == math.inf
        and screened[0]["cal_pairs"] == 0,
        "audit": audit["ok"],
        "launches": all(r["kde_launches"] >= 1 for arm in (off, scr)
                        for r in arm["rows"] if r["t"] >= 1),
    }
    g = screened[0] if screened else None
    if g is not None:
        state[f"{name}_shape"] = (FID_POP, g["kde_support"][0]["rows"],
                                  len(mo["mean"]))
    state.setdefault("launches", {})[name] = (off["kde_launches"]
                                              + scr["kde_launches"])
    row = {
        "phase": name, "ok": all(checks.values()), "checks": checks,
        "pop": FID_POP, "batch": FID_BATCH, "n_full": n_full,
        "paths": [r["path"] for r in scr["rows"]],
        "paths_off": [r["path"] for r in off["rows"]],
        "accepted_per_s": scr["accepted_per_s"],
        "accepted_per_s_off": off["accepted_per_s"],
        "speedup": scr["accepted_per_s"] / off["accepted_per_s"],
        # the timed window's generations with a finite threshold alone
        "accepted_per_s_screened": scr["accepted_per_s_screened"],
        "timed_screened": scr["timed_screened"],
        "sims_per_accepted": scr["sims_per_accepted"],
        "sims_per_accepted_off": off["sims_per_accepted"],
        "screen_rate": audit["screen_rate"],
        "false_reject_rate": audit["false_reject"],
        "false_reject_limit": audit["false_reject_limit"],
        "audit": audit,
        "taus": [r["screen_tau"] for r in screened],
        # what the self-disable rule read: acceptable pairs against
        # min_pairs, the correlation against min_corr
        "calibration": [{"t": r["t"], "tau": r["screen_tau"],
                         "cal_pairs": r["cal_pairs"],
                         "cal_corr": r["cal_corr"]} for r in screened],
        "min_pairs": cfg.min_pairs, "min_corr": cfg.min_corr,
        "blocks": scr["blocks"], "blocks_off": off["blocks"],
        "simulator_per_round": stages,
        "gen_times_s": scr["gen_times_s"],
        "gen_times_s_off": off["gen_times_s"],
        "wall_s": scr["wall_s"], "wall_s_off": off["wall_s"],
        "kde_launches": scr["kde_launches"],
        "kde_launches_off": off["kde_launches"],
        "posterior_mean": ms["mean"].tolist(),
        "posterior_mean_off": mo["mean"].tolist(),
        "posterior_std": ms["std"].tolist(), "ess": ms["ess"],
        "ess_off": mo["ess"], "mc_bound": noise.tolist(),
        "truth": ms["truth"].tolist(),
        "generations": [{**generation_row(r),
                         **{k: r[k] for k in ("sims_low", "sims_full",
                                              "screen_pass", "screen_tau",
                                              "cal_pairs", "cal_corr",
                                              "round_cap", "max_rounds")
                            if k in r}}
                        for r in scr["rows"]],
        "generations_off": [generation_row(r) for r in off["rows"]],
    }
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"{name} failed its checks: {checks}")


def phase_fidelitysir5e4(torch, state):
    _phase_fidelity(torch, state, "fidelitysir5e4")


def phase_fidelitylv5e4(torch, state):
    _phase_fidelity(torch, state, "fidelitylv5e4")


#: PODSTAR_LADDER_PROGRAM (bench.py:1422-1478) on one card: config #4 at
#: pop 1e7, batch pinned at 2^22 (a one-dispatch generation must fill the
#: population within its round cap: ceil(4 · 1e7 / B) <= max_T)
CAPACITY_POP = 10_000_000
CAPACITY_BATCH = 1 << 22
CAPACITY_GENS = 1 + 3
#: the opt-in nominal row: pop 1e8, batch 2^24 (ceil(4e8 / 2^24) = 24)
CAPACITY1E8_POP = 100_000_000
CAPACITY1E8_BATCH = 1 << 24
CAPACITY1E8_GENS = 1 + 2


def capacity_abc(pop: int, batch: int, seed: int = 0):
    """``(abc, priors, truth)``: config #4's ``make_sir_problem`` as the
    ladder program runs it: ``MedianEpsilon``, one dispatch, lazy
    History, K = 4, ``stores_sum_stats=False``, seed 0 (unless given),
    the batch pinned.  One setting differs: the device chain admits at
    most 2^35 (queries × support rows) per proposal density (the JAX
    package's pair budget, ``_device_chain_eligible``), so the refit's
    support cap is the largest power of two inside it (2^11 at pop 1e7,
    2^8 at pop 1e8) where the default 2^14 would send the run to the
    sequential engine."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import SIR_TRUTH, make_sir_problem

    models, priors, distance, observed = make_sir_problem()
    abc = pt.ABCSMC(
        models, priors, distance, population_size=pop,
        eps=pt.MedianEpsilon(),
        sampler=pt.VectorizedSampler(min_batch_size=batch,
                                     max_batch_size=batch, device="cuda"),
        run_mode="onedispatch", history_mode="lazy", fuse_generations=4,
        fused_support_cap=1 << int(math.log2((1 << 35) / pop)),
        stores_sum_stats=False, seed=seed, device="cuda")
    abc.new("sqlite://", observed)
    return abc, priors, SIR_TRUTH


def capacity_request(abc, pop: int, gens: int) -> dict:
    """The one-dispatch consult's request for this run of ``gens``
    generations before it runs: the pinned batch, K, ``max_T``, the
    ledger's lanes (the sampler fetches no statistics in this
    configuration: the records cover the adaptive refit, and the run
    stores none; generation 0 is written eagerly, as an adaptive refit
    reads it on the host, so no generation is resident in the store; the
    dispatch from t = 1 writes the other ``gens - 1`` into its slots)."""
    abc.sampler.fetch_stats = False
    B = abc.sampler.choose_batch(pop)
    kw = abc._capacity_kwargs("onedispatch", pop, B)
    return dict(batch=B, K=abc.fuse_generations,
                max_T=abc.onedispatch_max_t, wire_slots=gens - 1,
                round_to_batch=abc.sampler._round_to_valid_batch, **kw)


def run_capacity(torch, abc, gens: int) -> dict:
    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda

    weighted_kde_logpdf_cuda.launches = 0
    t0 = time.perf_counter()
    abc.run(max_nr_populations=gens)
    torch.cuda.synchronize()
    return {"wall_s": time.perf_counter() - t0,
            "kde_launches": weighted_kde_logpdf_cuda.launches}


def _env(**values):
    """Set (a str) or unset (None) environment variables; returns the
    previous values, which ``_env(**saved)`` restores."""
    import os

    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return saved



def capacity_run(torch, prec: str, seed: int = 0, budget=None) -> dict:
    """One ``capacity1e7`` run at carry precision ``prec`` (and an
    explicit budget), its peak measured over the dispatch; the run's
    device memory is freed before it returns."""
    import gc

    saved = _env(PYABC_TPU_CARRY_PRECISION=prec,
                 PYABC_TPU_HBM_BUDGET=(None if budget is None
                                       else str(budget)),
                 PYABC_TPU_CAPACITY_MEASURE="1")
    # the measured peak is this run's: what earlier phases left for the
    # collector goes first
    gc.collect()
    torch.cuda.empty_cache()
    try:
        abc, priors, truth = capacity_abc(CAPACITY_POP, CAPACITY_BATCH,
                                          seed=seed)
        abc.sampler.fetch_stats = False
        run = run_capacity(torch, abc, CAPACITY_GENS)
        pop = abc.history.get_population(abc.history.max_t)
        out = {**run, "plan": dict(abc.timeline.capacity),
               "moments": posterior_moments(abc, priors, truth),
               "rows": list(abc.timeline), "stop": abc.stop_reason,
               "max_t": abc.history.max_t, "precision": abc._carry_mode,
               "wire": wire_per_gen(abc),
               "theta": pop.theta, "distance": pop.distance,
               "weight": pop.weight}
    finally:
        _env(**saved)
    del abc
    gc.collect()
    torch.cuda.empty_cache()
    return out


def codec_roundtrip(torch, run: dict) -> dict:
    """The run's own at-rest codec on its last population, on the card:
    each decoded value within half a quantum of the float32 one (bf16:
    2^-8 of its magnitude; int8: half its column's scale)."""
    from pyabc_tpu_torch.ops.precision import decode_carry, encode_carry

    mode = run["precision"]
    lanes = {k: torch.as_tensor(run[k], dtype=torch.float32,
                                device="cuda").reshape(len(run[k]), -1)
             for k in ("theta", "distance")}
    enc = encode_carry(dict(lanes), mode)
    dec = decode_carry(dict(enc), mode)
    worst = 0.0
    for k, x in lanes.items():
        err = (dec[k] - x).abs()
        if mode == "bf16":
            bound = x.abs() * 2.0 ** -8
        else:
            bound = enc[k + "_qs"].reshape(1, -1) * (0.5 + 1e-3)
        worst = max(worst, float((err / torch.clamp(bound, min=1e-30))
                                 .max()))
    return {"mode": mode, "worst_error_over_bound": worst,
            "ok": mode in ("bf16", "int8") and worst <= 1.0}


#: the run-to-run spread (sd over seeds 0-2) of ``capacity1e7``'s float32
#: posterior means, per parameter (``--phases capacityspread``, on an
#: H100): about 30 and 90 times one run's σ/√ESS, and not removed by
#: restricting the runs to a common ε
CAPACITY_SPREAD = (0.00216, 0.00887)


def phase_capacity1e7(torch, state):
    """The discriminating budget, halfway between the port's own f32 and
    bf16 minima, under ``PYABC_TPU_CARRY_PRECISION=auto``; then an f32
    twin with no budget set.  The posterior means are held within
    4·√2 run-to-run spreads of the twin's (:data:`CAPACITY_SPREAD`), and
    the codec to half a quantum on the run's last population."""
    import numpy as np

    from pyabc_tpu_torch.capacity import CapacityError
    from pyabc_tpu_torch.capacity import model as cap

    saved = _env(PYABC_TPU_CARRY_PRECISION="auto")
    try:
        abc, _, _ = capacity_abc(CAPACITY_POP, CAPACITY_BATCH)
        req = capacity_request(abc, CAPACITY_POP, CAPACITY_GENS)
        del abc
    finally:
        _env(**saved)
    mins = {}
    for prec in ("f32", "bf16"):
        try:
            cap.plan(carry_precision=prec, budget=1, **req)
            mins[prec] = 0   # a 1-byte budget fits: broken arithmetic
        except CapacityError as err:
            mins[prec] = int(err.predicted)
    budget = (mins["f32"] + mins["bf16"]) // 2
    f32_infeasible = False
    try:
        cap.plan(carry_precision="f32", budget=budget, **req)
    except CapacityError:
        f32_infeasible = True
    run = capacity_run(torch, "auto", budget=budget)
    codec = codec_roundtrip(torch, run)
    twin = capacity_run(torch, "f32")
    plan, twin_plan = run["plan"], twin["plan"]
    measured = int(plan.get("measured_bytes", 0))
    moments, twin_moments = run["moments"], twin["moments"]
    limit = 4.0 * math.sqrt(2.0) * np.asarray(CAPACITY_SPREAD)
    gap = np.abs(moments["mean"] - twin_moments["mean"])
    ess_bound = 4.0 * (moments["std"] ** 2 / moments["ess"]
                       + twin_moments["std"] ** 2
                       / twin_moments["ess"]) ** 0.5
    rows = run["rows"]
    od = [r for r in rows if r["path"] == "onedispatch"]
    checks = {
        "minima": 0 < mins["bf16"] < mins["f32"],
        "f32_infeasible": f32_infeasible,
        "completed": [r["t"] for r in rows] == list(range(CAPACITY_GENS)),
        "onedispatch": len(od) == CAPACITY_GENS - 1,
        "round_graph": graphs_ok(rows) and graphs_ok(twin["rows"]),
        "precision": plan["precision"] != "f32",
        "planned_within_budget": plan["predicted_bytes"] <= budget,
        "measured_within_budget": 0 < measured <= budget,
        "stop_as_twin": (run["stop"] == twin["stop"]
                         and run["max_t"] == twin["max_t"]),
        "twin_f32": twin_plan["precision"] == "f32",
        "twin_fits_unclamped": twin_plan["note"] == "fits as requested",
        "posterior": moments["gate"] and twin_moments["gate"],
        "posterior_vs_twin": bool((gap <= limit).all()),
        "codec_roundtrip": codec["ok"],
        "launches": all(r["kde_launches"] >= 1 for r in rows
                        if r["t"] >= 1),
    }
    if od:
        state["capacity1e7_shape"] = (CAPACITY_POP,
                                      od[0]["kde_support"][0]["rows"], 2)
    state.setdefault("launches", {})["capacity1e7"] = (
        run["kde_launches"] + twin["kde_launches"])
    twin_measured = twin_plan.get("measured_bytes")
    row = {
        "phase": "capacity1e7", "ok": all(checks.values()),
        "checks": checks, "pop": CAPACITY_POP, "batch": CAPACITY_BATCH,
        "minima_bytes": mins, "budget_bytes": budget, "plan": plan,
        "measured_bytes": measured,
        "prediction_error_pct": (100.0 * (plan["predicted_bytes"]
                                          - measured) / measured
                                 if measured else None),
        "twin_plan": twin_plan, "twin_measured_bytes": twin_measured,
        "twin_prediction_error_pct": (
            100.0 * (twin_plan["predicted_bytes"] - twin_measured)
            / twin_measured if twin_measured else None),
        "wall_s": run["wall_s"], "twin_wall_s": twin["wall_s"],
        "kde_launches": run["kde_launches"],
        "twin_kde_launches": twin["kde_launches"],
        "stop": run["stop"], "twin_stop": twin["stop"],
        "posterior_mean": moments["mean"].tolist(),
        "twin_posterior_mean": twin_moments["mean"].tolist(),
        "posterior_std": moments["std"].tolist(), "ess": moments["ess"],
        "twin_ess": twin_moments["ess"], "mean_gap": gap.tolist(),
        "gap_limit": limit.tolist(), "ess_bound": ess_bound.tolist(),
        "codec": codec,
        "eps": [r["eps"] for r in rows],
        "twin_eps": [r["eps"] for r in twin["rows"]],
        "truth": np.asarray(moments["truth"]).tolist(),
        "generations": [generation_row(r) for r in rows],
        "twin_generations": [generation_row(r) for r in twin["rows"]],
        "wire": run["wire"], "twin_wire": twin["wire"],
    }
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"capacity1e7 failed its checks: {checks}")


def phase_capacityspread(torch, state):
    """The run-to-run spread behind :data:`CAPACITY_SPREAD`:
    ``capacity1e7``'s run with no budget, float32 and bf16, at seeds 0-2;
    each run's posterior means at its own last ε and at the smallest
    last ε of the six (its particles with a larger distance dropped:
    the population a run at that ε would have accepted from the same
    proposals)."""
    import numpy as np

    runs = [(prec, seed, capacity_run(torch, prec, seed=seed))
            for prec in ("f32", "bf16") for seed in range(3)]
    eps_common = min(float(r["rows"][-1]["eps"]) for _, _, r in runs)
    out = []
    for prec, seed, r in runs:
        keep = np.asarray(r["distance"]) <= eps_common
        w = np.where(keep, np.asarray(r["weight"], np.float64), 0.0)
        w = w / w.sum()
        theta = np.asarray(r["theta"], np.float64)
        mean_c = (w[:, None] * theta).sum(0)
        out.append({"precision": prec, "seed": seed,
                    "eps": [x["eps"] for x in r["rows"]],
                    "mean": r["moments"]["mean"].tolist(),
                    "std": r["moments"]["std"].tolist(),
                    "ess": r["moments"]["ess"],
                    "mean_at_common_eps": mean_c.tolist(),
                    "ess_at_common_eps": float(1.0 / np.sum(w * w)),
                    "measured_bytes": r["plan"].get("measured_bytes"),
                    "predicted_bytes": r["plan"]["predicted_bytes"]})

    def spread(key, prec):
        return np.std([o[key] for o in out if o["precision"] == prec],
                      axis=0, ddof=1).tolist()

    emit({"phase": "capacityspread", "ok": True, "runs": out,
          "eps_common": eps_common,
          "spread": {p: spread("mean", p) for p in ("f32", "bf16")},
          "spread_at_common_eps": {p: spread("mean_at_common_eps", p)
                                   for p in ("f32", "bf16")},
          "spread_in_use": list(CAPACITY_SPREAD)})


def phase_capacity1e8(torch, state):
    """The JAX ladder row's nominal pop 1e8 under the card's own budget
    (its memory less the default headroom): the plan first, then the run
    of 1 + 2 generations if it fits; a ``CapacityError`` is reported
    with its ledger."""
    from pyabc_tpu_torch.capacity import CapacityError
    from pyabc_tpu_torch.capacity import model as cap

    saved = _env(PYABC_TPU_CARRY_PRECISION="auto",
                 PYABC_TPU_CAPACITY_MEASURE="1")
    try:
        abc, priors, truth = capacity_abc(CAPACITY1E8_POP,
                                          CAPACITY1E8_BATCH)
        req = capacity_request(abc, CAPACITY1E8_POP, CAPACITY1E8_GENS)
        budget = cap.resolved_budget_bytes("cuda")
        try:
            plan = cap.plan(carry_precision="auto", budget=budget, **req)
        except CapacityError as err:
            emit({"phase": "capacity1e8", "ok": True, "fits": False,
                  "pop": CAPACITY1E8_POP, "budget_bytes": err.budget,
                  "predicted_bytes": err.predicted, "hint": err.hint,
                  "ledger": dict(err.ledger),
                  "error": str(err).splitlines()[0]})
            return
        emit({"phase": "capacity1e8", "plan": {
            "precision": plan.carry_precision, "batch": plan.batch,
            "K": plan.K, "max_T": plan.max_T, "note": plan.note,
            "predicted_bytes": plan.predicted_bytes,
            "budget_bytes": plan.budget_bytes,
            "ledger": dict(plan.ledger)}})
        run = run_capacity(torch, abc, CAPACITY1E8_GENS)
        moments = posterior_moments(abc, priors, truth)
    finally:
        _env(**saved)
    cap_row = dict(abc.timeline.capacity)
    emit({"phase": "capacity1e8", "ok": True, "fits": True,
          "pop": CAPACITY1E8_POP, "plan": cap_row, **run,
          "measured_bytes": cap_row.get("measured_bytes"),
          "gens_run": abc.history.max_t + 1,
          "posterior_gate": moments["gate"],
          "posterior_mean": moments["mean"].tolist(),
          "generations": [generation_row(r) for r in abc.timeline]})


# ---------------------------------------------------------------- run
# infrastructure: telemetry, chaos, recovery, real CUDA faults


#: the resilience counters a phase with no fault plan must leave at 0
CLEAN_COUNTERS = ("resilience_retries_total", "resilience_degrade_total")
#: phases that install faults or provoke them on the card
FAULT_PHASES = ("chaos1e6", "recover1e6", "cudafaults", "laddermem")


def resilience_counts() -> dict:
    from pyabc_tpu_torch.telemetry import REGISTRY
    d = REGISTRY.to_dict()
    return {k: d.get(k, 0) for k in CLEAN_COUNTERS}


def latches(abc) -> dict:
    return {"fused_off": abc._fault_fused_off,
            "onedispatch_off": abc._fault_onedispatch_off,
            "sequential_only": abc._fault_sequential_only}


def telemetry_od_run(torch, run_mode: str, lanes: bool,
                     trace_path=None) -> tuple:
    """``onedispatch1e6``'s configuration with the lanes switched on or
    off (and a trace sink): ``(abc, wall_s, K1 launches)``."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import make_two_gaussians_problem
    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda
    from pyabc_tpu_torch.telemetry import spans

    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(
        models, priors, distance, population_size=ONEDISPATCH_POP,
        eps=pt.ConstantEpsilon(0.2),
        sampler=pt.VectorizedSampler(min_batch_size=1 << 19,
                                     max_batch_size=1 << 19,
                                     max_rounds_per_call=16, device="cuda"),
        stores_sum_stats=False, fuse_generations=FUSE_K, run_mode=run_mode,
        ingest_mode="sequential", history_mode="eager", seed=0,
        trace_path=trace_path, device="cuda")
    abc.telemetry_lanes = lanes
    abc.new("sqlite://", observed)
    weighted_kde_logpdf_cuda.launches = 0
    t0 = time.perf_counter()
    try:
        abc.run(max_nr_populations=ONEDISPATCH_GENS)
    finally:
        spans.TRACER.reset()
    torch.cuda.synchronize()
    return abc, time.perf_counter() - t0, weighted_kde_logpdf_cuda.launches


def phase_telemetry1e6(torch, state):
    import tempfile

    from pyabc_tpu_torch.telemetry import REGISTRY, lanes
    from pyabc_tpu_torch.wire import transfer

    B = 1 << 19
    # the lanes and the generator's state read nothing back to the host
    r = torch.tensor(7, dtype=torch.int64, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tl = lanes.phase_wire_lanes(r, B, lanes.phase_cost_model(
            B=B, n_target=ONEDISPATCH_POP, d=1, s=1, M=2,
            eps_mode="constant", support_rows=1 << 14, adaptive=False))
        gen.set_state(gen.get_state())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    no_sync_ok = int(tl["tl_sims"]) == 7 * B
    with tempfile.TemporaryDirectory() as tmp:
        trace = str(Path(tmp) / "trace.jsonl")
        a_off, wall_off, launches_off = telemetry_od_run(
            torch, "onedispatch", False)
        a_on, wall_on, launches_on = telemetry_od_run(
            torch, "onedispatch", True, trace_path=trace)
        word = lanes.PROGRESS.read()
        a_f, wall_f, launches_f = telemetry_od_run(torch, "auto", True)
        # a second lanes-off run, after the lanes-on ones: the first run
        # of a process pays its one-off costs
        a_off2, wall_off2, _ = telemetry_od_run(torch, "onedispatch", False)
        with open(trace) as f:
            events = [json.loads(line) for line in f]
    od = [r for r in a_on.timeline if r["path"] == "onedispatch"]
    fused = [r for r in a_f.timeline if r["path"] == "fused"]
    stage_last = a_on.timeline.to_rows()[-1]

    def phases_sum_ok(rows):
        return all(abs(sum(r["ph_" + p + "_s"] for p in lanes.PHASES)
                       - r["wall_s"]) <= 1e-9 * r["wall_s"] for r in rows)

    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], set()).add(e["args"].get("gen"))
    gens = set(range(ONEDISPATCH_GENS))
    checks = {
        "round_graph": all(graphs_ok(a.timeline)
                           for a in (a_off, a_on, a_f, a_off2)),
        "no_host_sync_in_lanes": no_sync_ok,
        "bit_identical": all(population_difference(a.history,
                                                   a_on.history) is None
                             for a in (a_off, a_f, a_off2)),
        "paths": ([r["path"] for r in a_on.timeline]
                  == ["sequential"] + ["onedispatch"] * 8
                  and [r["path"] for r in a_f.timeline]
                  == ["sequential"] + ["fused"] * 8),
        "host_reads": all(r["host_reads"] == r["rounds"] + 1
                          + (r["grids_resolved"] is not None) for r in od),
        "tl_sims": all(r["tl_sims"] == r["rounds"] * B for r in od + fused),
        "phases_sum_to_wall": phases_sum_ok(od) and phases_sum_ok(fused),
        "lanes_off_rows": all("tl_sims" not in r for r in a_off.timeline),
        "progress_word": (word is not None and not word["active"]
                          and word["gen"] == od[-1]["t"]
                          and word["gens_done"] == len(od)
                          and float(word["eps"]) == float(
                              torch.tensor(od[-1]["eps"]).item())
                          and word["accepted"] == stage_last["accepted"]),
        "trace_spans": (
            {"run", "calibrate"} <= set(by_name)
            and by_name.get("onedispatch.dispatch") == {1}
            and by_name.get("onedispatch.ingest") == gens - {0}
            and by_name.get("gen.append") == gens),
        "registry_d2h": (REGISTRY.to_dict()["wire_d2h_bytes_total"]
                         == transfer.snapshot()["d2h_bytes"]),
        "latches_clear": not any(latches(a_on).values())
        and not any(latches(a_f).values()),
    }
    row = {"pop": ONEDISPATCH_POP, "gens": ONEDISPATCH_GENS,
           "ok": all(checks.values()), "checks": checks,
           "wall_s_lanes_off": [wall_off, wall_off2],
           "wall_s_lanes_on": wall_on, "wall_s_fused_lanes_on": wall_f,
           "lanes_cost_s_per_gen": (wall_on - wall_off2) / len(od),
           "trace_events": len(events), "progress_word": word,
           "phases_med": {k: v for k, v in a_on.timeline.summary().items()
                          if k.startswith("ph_")},
           "generations": [{**generation_row(r), "tl_sims": r.get("tl_sims"),
                            **{k: r[k] for k in r if k.startswith("ph_")}}
                           for r in a_on.timeline]}
    launches = state.setdefault("launches", {})
    launches["telemetry1e6_lanes_on"] = launches_on
    launches["telemetry1e6_lanes_off"] = launches_off
    launches["telemetry1e6_fused"] = launches_f
    emit({"phase": "telemetry1e6", **row})
    if not row["ok"]:
        raise RuntimeError(f"telemetry1e6 failed its checks: {checks}")


def _pipelined_abc(torch):
    import pyabc_tpu_torch as pt

    abc, posterior_fn = _config2_abc(pt.ConstantEpsilon(0.2))
    return abc


def _chaos_run(torch, make, plan_text=None, probe=None) -> dict:
    """One run of ``make()`` under a fault plan (None: clean), with the
    plan's firings, the resilience counters' deltas, the K1 launches and
    the wall."""
    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda
    from pyabc_tpu_torch.resilience import faults

    abc = make(torch)
    plan = faults.install(faults.FaultPlan.parse(plan_text)) \
        if plan_text else None
    if probe is not None:
        probe(abc)
    before = resilience_counts()
    weighted_kde_logpdf_cuda.launches = 0
    t0 = time.perf_counter()
    try:
        abc.run(max_nr_populations=NORTHSTAR_GENS)
    finally:
        faults.uninstall()
    torch.cuda.synchronize()
    after = resilience_counts()
    return {"abc": abc, "wall_s": time.perf_counter() - t0,
            "kde_launches": weighted_kde_logpdf_cuda.launches,
            "fired": ({f"{k[0]}:{k[1]}": v for k, v in plan.fired.items()}
                      if plan else {}),
            "counters": {k: after[k] - before[k] for k in after},
            "latches": latches(abc),
            "paths": [r["path"] for r in abc.timeline]}


def _full_rows(abc, n) -> bool:
    import numpy as np

    h = abc.history
    return all(len(h.get_population(t)) == n
               and abs(float(np.sum(h.get_population(t).weight)) - 1.0)
               < 1e-4 for t in range(h.max_t + 1)) and \
        h.max_t + 1 == NORTHSTAR_GENS


def _p_b(abc) -> float:
    h = abc.history
    return float(h.get_model_probabilities(h.max_t).get(1, 0.0))


def _durable_prefix_equal(abc, clean, upto: int):
    """None when generations 0..upto-1 equal the clean twin's bit for
    bit, else the first difference."""
    import numpy as np

    for t in range(upto):
        a, b = abc.history.get_population(t), clean.history.get_population(t)
        for key in ("m", "theta", "distance", "weight"):
            if not np.array_equal(np.asarray(getattr(a, key)),
                                  np.asarray(getattr(b, key))):
                return f"t={t} {key}"
    return None


def phase_chaos1e6(torch, state):
    import os
    import tempfile

    from pyabc_tpu_torch.resilience import faults

    n = PIPELINED_POP
    tol_p = 2 * max(2.5e-3, 2.5 / n ** 0.5)
    runs, checks = {}, {}
    runs["clean"] = _chaos_run(torch, _pipelined_abc)
    clean = runs["clean"]
    checks["clean_counters_zero"] = (
        not any(clean["counters"].values())
        and not any(clean["latches"].values()))
    checks["clean_paths"] = (clean["paths"][0] == "sequential"
                             and "pipelined" in clean["paths"])

    # (a) one transient dispatch fault: absorbed bit for bit
    runs["a"] = _chaos_run(torch, _pipelined_abc,
                           "device.dispatch@3:raise=ConnectionResetError")
    a = runs["a"]
    checks["a_fired_once"] = a["fired"] == {"device.dispatch:raise": 1}
    checks["a_bit_identical"] = population_difference(
        a["abc"].history, clean["abc"].history) is None
    checks["a_retried_once"] = a["counters"] == {
        "resilience_retries_total": 1, "resilience_degrade_total": 0}

    # (b) a fetch fault and a History write fault
    runs["b"] = _chaos_run(torch, _pipelined_abc,
                           "wire.fetch@2:raise=ConnectionResetError;"
                           "history.append@1:raise=ConnectionResetError")
    b = runs["b"]
    checks["b_fired"] = b["fired"] == {"wire.fetch:raise": 1,
                                       "history.append:raise": 1}
    checks["b_retries"] = b["counters"]["resilience_retries_total"] >= 2
    checks["b_full_rows"] = _full_rows(b["abc"], n)

    # (c) RetryExhausted in the pipelined engine: the three attempts of
    # the third block dispatch fail; the visits are counted in a probe
    block_visits = []

    def count_block_visits(abc):
        plan = faults.active_plan()
        call = abc._retry.call

        def recording(fn, site, *args, **kw):
            block_visits.append(plan.visits(site) + 1)
            return call(fn, site, *args, **kw)

        abc._retry.call = recording

    runs["probe"] = _chaos_run(torch, _pipelined_abc,
                               "device.dispatch@1000000000:delay=0",
                               probe=count_block_visits)
    v = block_visits[2]
    flight_dir = tempfile.mkdtemp()
    saved = {k: os.environ.get(k) for k in ("PYABC_TPU_FLIGHT_DIR",
                                            "PYABC_TPU_RETRIES")}
    os.environ["PYABC_TPU_FLIGHT_DIR"] = flight_dir
    os.environ["PYABC_TPU_RETRIES"] = "3"
    try:
        runs["c"] = _chaos_run(
            torch, _pipelined_abc,
            ";".join(f"device.dispatch@{v + i}:raise=ConnectionResetError"
                     for i in range(3)))
    finally:
        _env(**saved)
    c = runs["c"]
    dumps = sorted(Path(flight_dir).glob("flight_*.json"))
    reasons = [json.loads(p.read_text())["reason"] for p in dumps]
    checks["c_fired"] = c["fired"] == {"device.dispatch:raise": 3}
    checks["c_sequential_only"] = c["latches"]["sequential_only"]
    checks["c_sequential_after"] = (
        c["paths"][:2] == clean["paths"][:2]
        and all(p == "sequential" for p in c["paths"][2:]))
    checks["c_flight_dump"] = "RetryExhausted:device.dispatch" in reasons
    checks["c_durable_prefix"] = _durable_prefix_equal(
        c["abc"], clean["abc"], 2) is None
    checks["c_full_rows"] = _full_rows(c["abc"], n)
    checks["c_p_b"] = abs(_p_b(c["abc"]) - _p_b(clean["abc"])) < tol_p

    # (d) a drain fault in the one-dispatch engine, against its clean twin
    def od_abc(torch):
        import pyabc_tpu_torch as pt
        from pyabc_tpu_torch.models import make_two_gaussians_problem

        models, priors, distance, observed, _ = make_two_gaussians_problem()
        abc = pt.ABCSMC(
            models, priors, distance, population_size=n,
            eps=pt.ConstantEpsilon(0.2),
            sampler=pt.VectorizedSampler(min_batch_size=1 << 19,
                                         max_batch_size=1 << 19,
                                         max_rounds_per_call=16,
                                         device="cuda"),
            stores_sum_stats=False, fuse_generations=FUSE_K,
            run_mode="onedispatch", seed=0, device="cuda")
        abc.new("sqlite://", observed)
        return abc

    runs["od_clean"] = _chaos_run(torch, od_abc)
    runs["d"] = _chaos_run(torch, od_abc,
                           "run.drain@2:raise=ConnectionResetError")
    od_clean, d = runs["od_clean"], runs["d"]
    checks["od_clean_counters_zero"] = (
        not any(od_clean["counters"].values())
        and not any(od_clean["latches"].values()))
    checks["d_fired"] = d["fired"] == {"run.drain:raise": 1}
    checks["d_latch"] = (d["latches"]["onedispatch_off"]
                         and not d["abc"]._onedispatch_eligible())
    checks["d_paths"] = (d["paths"][:2] == ["sequential", "onedispatch"]
                         and "onedispatch" not in d["paths"][2:])
    checks["d_durable_prefix"] = _durable_prefix_equal(
        d["abc"], od_clean["abc"], 2) is None
    checks["d_full_rows"] = _full_rows(d["abc"], n)
    checks["d_p_b"] = abs(_p_b(d["abc"]) - _p_b(od_clean["abc"])) < tol_p
    checks = {k: bool(v) for k, v in checks.items()}
    row = {"pop": n, "gens": NORTHSTAR_GENS, "ok": all(checks.values()),
           "checks": checks, "tol_p": tol_p,
           "block_dispatch_visits": block_visits, "c_first_visit": v,
           "flight_reasons": reasons, "retries_env": 3,
           "p_b": {k: _p_b(r["abc"]) for k, r in runs.items()},
           "runs": {k: {kk: r[kk] for kk in ("wall_s", "kde_launches",
                                             "fired", "counters",
                                             "latches", "paths")}
                    for k, r in runs.items()}}
    launches = state.setdefault("launches", {})
    for k, r in runs.items():
        launches[f"chaos1e6_{k}"] = r["kde_launches"]
    emit({"phase": "chaos1e6", **row})
    if not row["ok"]:
        raise RuntimeError(f"chaos1e6 failed its checks: {checks}")


#: the child processes of ``recover1e6``: they import the port and
#: nothing of JAX or of the JAX package
_NO_JAX = """
import sys
for name in ("jax", "jaxlib", "pyabc_tpu"):
    sys.modules[name] = None
sys.path.insert(0, ROOT)
import pyabc_tpu_torch as pt
from pyabc_tpu_torch.models import make_two_gaussians_problem
models, priors, distance, observed, posterior_fn = \\
    make_two_gaussians_problem()
"""

#: (a) run_gate's configuration through the defaults (the pipeline, lazy
#: rows) with a one-generation store ring: each generation's bytes are
#: journaled when the next deposit evicts it, and the kill lands at the
#: second materialize, while the victim's bytes are only a journal
#: payload
_KILL_CHILD = """
from pyabc_tpu_torch.resilience import faults
faults.install(faults.FaultPlan.parse("history.materialize@2:sigkill"))
abc = pt.ABCSMC(models, priors, distance, population_size=POP,
                eps=pt.MedianEpsilon(),
                sampler=pt.VectorizedSampler(max_batch_size=1 << 19,
                                             max_rounds_per_call=16,
                                             device="cuda"),
                stores_sum_stats=False, seed=0, history_mode="lazy",
                device="cuda")
abc.new(DB, observed)
abc.run(max_nr_populations=11)
sys.exit(3)
"""

#: (b) the sequential engine with a sub-checkpoint after every call of
#: one round of 2^19: the SIGTERM lands at the second call of generation
#: 1, counted in a probe run of generation 0
_TERM_CHILD = """
from pyabc_tpu_torch.resilience import faults
from pyabc_tpu_torch.resilience.checkpoint import Preempted


def make_abc(path):
    abc = pt.ABCSMC(models, priors, distance, population_size=POP,
                    eps=pt.MedianEpsilon(),
                    sampler=pt.VectorizedSampler(max_batch_size=1 << 19,
                                                 max_rounds_per_call=1,
                                                 device="cuda"),
                    stores_sum_stats=False, seed=0,
                    ingest_mode="sequential", history_mode="eager",
                    checkpoint_every_rounds=1, device="cuda")
    abc.new(path, observed)
    return abc


probe = faults.install(faults.FaultPlan.parse("preempt@999999999:sigterm"))
make_abc(DB + ".probe").run(max_nr_populations=1)
v0 = probe.visits(faults.SITE_PREEMPT)
faults.install(faults.FaultPlan.parse("preempt@%d:sigterm" % (v0 + 2)))
try:
    make_abc(DB).run(max_nr_populations=11)
except Preempted:
    sys.exit(17)
sys.exit(3)
"""


def _child(root, body: str, db: str, env=None):
    import os
    import subprocess as sp

    code = (f"ROOT = {str(root)!r}\nDB = {db!r}\n"
            f"POP = {PIPELINED_POP}\n" + _NO_JAX + body)
    full = dict(os.environ)
    for k in ("PYABC_TPU_FAULTS", "PYABC_TPU_STORE_GENS"):
        full.pop(k, None)
    full.update(env or {})
    t0 = time.perf_counter()
    proc = sp.run([sys.executable, "-c", code], env=full,
                  capture_output=True, text=True, timeout=600)
    return proc, time.perf_counter() - t0


def _gate_run_gate(abc, posterior_fn, n) -> dict:
    import numpy as np

    h = abc.history
    t = h.max_t
    p_b = float(h.get_model_probabilities(t).get(1, 0.0))
    df, w = h.get_distribution(m=1, t=t)
    mu = float(np.sum(df["mu"].to_numpy() * w))
    tol_p = max(2.5e-3, 2.5 / n ** 0.5)
    tol_mu = max(3e-3, 3.0 / n ** 0.5)
    return {"p_model_b": p_b, "p_analytic": float(posterior_fn(1.0)),
            "mu_b": mu, "tol_p": tol_p, "tol_mu": tol_mu,
            "ok": abs(p_b - posterior_fn(1.0)) < tol_p
            and abs(mu - 1.0) < tol_mu}


def phase_recover1e6(torch, state):
    import sqlite3
    import tempfile

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import make_two_gaussians_problem
    from pyabc_tpu_torch.resilience import checkpoint as ckpt
    from pyabc_tpu_torch.resilience.journal import SpillJournal
    from pyabc_tpu_torch.telemetry import REGISTRY

    root = Path(__file__).resolve().parent
    n = PIPELINED_POP
    checks = {}
    row = {"pop": n}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) kill -9 with a generation's bytes only in the journal
        db = str(Path(tmp) / "kill.db")
        proc, secs = _child(root, _KILL_CHILD, db,
                            env={"PYABC_TPU_STORE_GENS": "1"})
        row["a_child_rc"] = proc.returncode
        row["a_child_s"] = secs
        checks["a_killed"] = proc.returncode == -9
        if proc.returncode != -9:
            row["a_child_stderr"] = proc.stderr[-3000:]
        j = SpillJournal(db + ".journal")
        pending = sorted(j.pending())
        j.close()
        with sqlite3.connect(db) as conn:
            flags = dict(conn.execute(
                "SELECT t, lazy FROM populations WHERE t >= 0"))
        lazy_ts = sorted(t for t, lz in flags.items() if lz)
        victim = lazy_ts[0] if len(lazy_ts) == 1 else None
        row.update({"a_rows_at_kill": flags, "a_pending": pending,
                    "a_victim": victim})
        checks["a_only_journal_copy"] = (
            victim is not None and victim >= 1 and victim in pending
            and all(not flags[t] for t in range(victim)))
        models, priors, distance, observed, posterior_fn = \
            make_two_gaussians_problem()
        abc = pt.ABCSMC(models, priors, distance, population_size=n,
                        eps=pt.MedianEpsilon(),
                        sampler=pt.VectorizedSampler(
                            max_batch_size=1 << 19, max_rounds_per_call=16,
                            device="cuda"),
                        stores_sum_stats=False, seed=1,
                        history_mode="lazy", device="cuda")
        before = REGISTRY.to_dict().get(
            "resilience_journal_replayed_total", 0)
        abc.load(db)
        replayed = REGISTRY.to_dict().get(
            "resilience_journal_replayed_total", 0) - before
        j = SpillJournal(db + ".journal")
        checks["a_replayed"] = (replayed == 1
                                and abc.history.max_t == victim
                                and j.pending() == {})
        j.close()
        with sqlite3.connect(db) as conn:
            checks["a_no_lazy_left"] = conn.execute(
                "SELECT COUNT(*) FROM populations WHERE lazy = 1"
            ).fetchone()[0] == 0
        t0 = time.perf_counter()
        abc.run(max_nr_populations=10 - (victim or 0))
        torch.cuda.synchronize()
        row["a_resume_s"] = time.perf_counter() - t0
        h = abc.history
        checks["a_full_rows"] = (h.max_t == 10 and all(
            len(h.get_population(t)) == n for t in range(11)))
        gate = _gate_run_gate(abc, posterior_fn, n)
        row["a_gate"] = gate
        checks["a_run_gate"] = gate["ok"]
        checks["a_resume_clean"] = not any(latches(abc).values())

        # (b) SIGTERM mid-generation in the sequential engine
        db = str(Path(tmp) / "term.db")
        proc, secs = _child(root, _TERM_CHILD, db)
        row["b_child_rc"] = proc.returncode
        row["b_child_s"] = secs
        checks["b_preempted"] = proc.returncode == 17
        if proc.returncode != 17:
            row["b_child_stderr"] = proc.stderr[-3000:]
        hist = pt.History(db, abc_id=1)
        ck = hist.load_sub_checkpoint(1)
        checks["b_ledger"] = (hist.max_t == 0 and ck is not None
                              and 1 <= ck["n_accepted"] < n)
        row["b_ledger"] = (None if ck is None else
                           {k: ck[k] for k in ("rounds", "n_accepted",
                                               "nr_evaluations")})
        hist.close()
        ckpt.clear_preempt()
        abc = pt.ABCSMC(models, priors, distance, population_size=n,
                        eps=pt.MedianEpsilon(),
                        sampler=pt.VectorizedSampler(
                            max_batch_size=1 << 19, max_rounds_per_call=16,
                            device="cuda"),
                        stores_sum_stats=False, seed=1,
                        ingest_mode="sequential", history_mode="eager",
                        checkpoint_every_rounds=1, device="cuda")
        abc.load(db)
        # this process's own evaluations of generation 1 (its first
        # sampler call), before the splice adds the flushed ones
        own = []
        sample_fn = abc.sampler.sample_until_n_accepted

        def recording(*args, **kw):
            out = sample_fn(*args, **kw)
            own.append(out.nr_evaluations)
            return out

        abc.sampler.sample_until_n_accepted = recording
        t0 = time.perf_counter()
        abc.run(max_nr_populations=3)
        torch.cuda.synchronize()
        row["b_resume_s"] = time.perf_counter() - t0
        h = abc.history
        pops = h.get_all_populations()
        samples_1 = int(pops[pops.t == 1].samples.iloc[0])
        row.update({"b_samples_t1": samples_1, "b_own_evals_t1": own[0]})
        checks["b_spliced"] = (
            h.load_sub_checkpoint(1) is None and ck is not None
            and samples_1 == ck["nr_evaluations"] + own[0])
        checks["b_full_rows"] = (h.max_t == 3 and all(
            len(h.get_population(t)) == n for t in range(4)))
    checks = {k: bool(v) for k, v in checks.items()}
    row.update({"ok": all(checks.values()), "checks": checks})
    emit({"phase": "recover1e6", **row})
    if not row["ok"]:
        raise RuntimeError(f"recover1e6 failed its checks: {checks}")


#: cudafaults (a): config #2 at pop 1e6 on the sequential engine, batch
#: between these rungs (the top one and the next)
OOM_POP = 1_000_000
OOM_TOP = 1 << 21
OOM_GENS = 4

#: cudafaults (b): a model whose eighth call (in the one-dispatch run,
#: after calibration and generation 0) gathers out of bounds on the card
_ASSERT_CHILD = """
import json
import torch
from pyabc_tpu_torch.resilience import retry
from pyabc_tpu_torch.telemetry import REGISTRY

fn = models[1]._fn
calls = {"n": 0, "captures": 0}


def bad(generator, theta):
    calls["n"] += 1
    out = fn(generator, theta)
    # an eager round's 8th call, or the second captured round (the first
    # is generation 0's, the second the one-dispatch engine's): on the
    # card a round is called in Python only to run it eagerly and to
    # capture it, and every later round replays what the capture recorded
    capturing = torch.cuda.is_current_stream_capturing()
    calls["captures"] += capturing
    if calls["n"] == 8 or (capturing and calls["captures"] == 2):
        idx = torch.arange(theta.shape[0], device=theta.device) \
            + theta.shape[0]
        out = {k: v[idx] for k, v in out.items()}
    return out


models[1]._fn = bad
abc = pt.ABCSMC(models, priors, distance, population_size=100000,
                eps=pt.ConstantEpsilon(0.2),
                sampler=pt.VectorizedSampler(min_batch_size=1 << 18,
                                             max_batch_size=1 << 18,
                                             device="cuda"),
                fuse_generations=4, run_mode="onedispatch",
                history_mode="eager", ingest_mode="sequential", seed=0,
                device="cuda")
abc.new("sqlite://", observed)
try:
    abc.run(max_nr_populations=6)
except Exception as err:
    d = REGISTRY.to_dict()
    print(json.dumps({
        "error": f"{type(err).__name__}: {err}"[:300],
        "transient": retry.is_transient(err),
        "sticky": retry.is_sticky_cuda_error(err),
        "attempts": abc._retry.last_attempts,
        "sampler_attempts": abc.sampler._retry.last_attempts,
        "retries": d.get("resilience_retries_total", 0),
        "degrades": d.get("resilience_degrade_total", 0),
        "latches": [abc._fault_fused_off, abc._fault_onedispatch_off,
                    abc._fault_sequential_only],
        "gens_durable": abc.history.max_t + 1}), flush=True)
    raise
sys.exit(3)
"""


def oom_abc(batch_min: int, batch_max: int, graphs: bool = True):
    """Config #2 at pop 1e6 on the sequential engine with the batch
    between ``batch_min`` and ``batch_max``; ``graphs``: the sampler's
    default route (captured rounds), else eager rounds (the route a rung
    drop leaves)."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import make_two_gaussians_problem

    models, priors, distance, observed, _ = make_two_gaussians_problem()
    sampler = pt.VectorizedSampler(
        min_batch_size=batch_min, max_batch_size=batch_max,
        max_rounds_per_call=16, device="cuda")
    sampler.round_graphs = graphs
    abc = pt.ABCSMC(models, priors, distance, population_size=OOM_POP,
                    sampler=sampler, stores_sum_stats=False, seed=0,
                    ingest_mode="sequential", history_mode="eager",
                    device="cuda")
    abc.new("sqlite://", observed)
    return abc


def _memory_windows(torch, batch_min: int, batch_max: int,
                    graphs: bool) -> list:
    """``OOM_GENS`` generations of :func:`oom_abc` from an empty cache,
    with no limit: one row per window of the run — each sampler call
    (calibration, then a generation) and the host work before it — with
    its reserved and allocated peaks (bytes over the run's start) and,
    after a call, the graph pool's reserved and allocated bytes."""
    import gc

    abc = oom_abc(batch_min, batch_max, graphs=graphs)
    sampler = abc.sampler
    call = sampler.sample_until_n_accepted
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    windows = []

    def close(kind, **extra):
        torch.cuda.synchronize()
        windows.append({
            "window": kind,
            "reserved_peak": torch.cuda.max_memory_reserved() - base,
            "allocated_peak": torch.cuda.max_memory_allocated() - base,
            **extra})
        torch.cuda.reset_peak_memory_stats()

    def measured(*args, **kwargs):
        close("host")
        sample = call(*args, **kwargs)
        pool = sampler._ladder.pool_bytes()
        close("calibration" if kwargs.get("all_accepted") else "generation",
              batch=sampler.last_batch, round_graph=sample.round_graph,
              pool_reserved=pool["reserved"],
              pool_allocated=pool["allocated"])
        return sample

    sampler.sample_until_n_accepted = measured
    torch.cuda.reset_peak_memory_stats()
    abc.run(max_nr_populations=OOM_GENS)
    close("host")
    del abc, sampler, call, measured
    gc.collect()
    torch.cuda.empty_cache()
    return windows


def oom_limit(windows: list, eager_windows: list) -> dict:
    """The limit for cudafaults (a): above what every window before the
    second generation at the top rung reserved (those run whole) and what
    the eager run at the next rung reserved (the route and rung a drop
    restarts on), below what the second generation at the top rung holds
    at once — its allocated peak, a lower bound of its need, so it runs
    out of memory.  Where those do not separate, the upper end is the
    allocated peak plus the graph pool's unallocated bytes (the pool's
    blocks serve captures only), and the source says so."""
    second = [i for i, w in enumerate(windows)
              if w["window"] == "generation"][1]
    fits = max([w["reserved_peak"] for w in windows[:second]]
               + [w["reserved_peak"] for w in eager_windows])
    needs = windows[second]["allocated_peak"]
    source = "allocated"
    if needs <= fits:
        w = windows[second]
        needs += w["pool_reserved"] - w["pool_allocated"]
        source = "allocated + pool"
    return {"fits_bytes": fits, "needs_bytes": needs, "source": source,
            "separated": fits < needs, "limit": (fits + needs) // 2}


def phase_cudafaults(torch, state):
    import gc

    from pyabc_tpu_torch.capacity import model as capacity
    from pyabc_tpu_torch.resilience import retry

    checks, row = {}, {}
    # (a) a real out-of-memory at the top batch rung, on the default
    # (captured) route; the drop restarts at the next rung, eagerly
    half = OOM_TOP // 2
    led = {B: sum(capacity.ledger(
        population=OOM_POP, param_dim=1, stat_dim=1, engine="sequential",
        batch=B, wire_stats=False, models=2,
        support_cap=1 << 14).values()) for B in (OOM_TOP, half)}
    windows = _memory_windows(torch, half, OOM_TOP, graphs=True)
    eager = _memory_windows(torch, half, half, graphs=False)
    choice = oom_limit(windows, eager)
    limit = choice["limit"]
    total = torch.cuda.get_device_properties(0).total_memory
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    fraction = (base + limit) / total
    row.update({"ledger_bytes": led, "graph_windows": windows,
                "eager_half_windows": eager, "limit": choice,
                "limit_bytes": limit, "fraction": fraction,
                "base_reserved": base})
    checks["a_limit_separates"] = choice["separated"]
    abc = oom_abc(half, OOM_TOP)
    checks["a_graphs_on_before"] = abc.sampler.graphs_on()
    before = resilience_counts()
    torch.cuda.set_per_process_memory_fraction(fraction)
    try:
        t0 = time.perf_counter()
        abc.run(max_nr_populations=OOM_GENS)
        torch.cuda.synchronize()
        row["a_wall_s"] = time.perf_counter() - t0
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    after = resilience_counts()
    d = {k: after[k] - before[k] for k in after}
    h = abc.history
    rows = abc.timeline
    row.update({"a_counters": d, "a_batches": [r["batch"] for r in rows],
                "a_round_graph": [r["round_graph"] for r in rows],
                "a_max_batch_after": abc.sampler.max_batch_size})
    checks["a_oom_is_transient"] = retry.is_transient(
        torch.cuda.OutOfMemoryError("CUDA out of memory."))
    checks["a_retries_used_up"] = d["resilience_retries_total"] >= 3
    checks["a_degraded"] = (d["resilience_degrade_total"] >= 1
                            and abc.sampler.max_batch_size == half
                            and not abc.sampler.graphs_on())
    checks["a_completed"] = (h.max_t + 1 == OOM_GENS and all(
        len(h.get_population(t)) == OOM_POP for t in range(OOM_GENS)))
    # generations before the failing one ran at the top rung on captured
    # rounds; the failing one restarted, and every one after it ran, at
    # the next rung, eagerly
    batches = row["a_batches"]
    k = batches.index(half) if half in batches else len(batches)
    checks["a_restarted_at_next_rung"] = (
        0 < k < len(batches)
        and batches == [OOM_TOP] * k + [half] * (len(batches) - k))
    checks["a_graphs_before_the_drop"] = bool(rows[:k]) and all(
        r["round_graph"] for r in rows[:k])
    checks["a_eager_after_the_drop"] = bool(rows[k:]) and not any(
        r["round_graph"] for r in rows[k:])
    del abc, h, rows
    gc.collect()
    torch.cuda.empty_cache()

    # (b) a device-side assert in a child: fatal, one attempt, no fallback
    import tempfile
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        proc, secs = _child(root, _ASSERT_CHILD, str(Path(tmp) / "x.db"))
    report = None
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            report = json.loads(line)
    row.update({"b_child_rc": proc.returncode, "b_child_s": secs,
                "b_report": report})
    checks["b_exit_nonzero"] = proc.returncode not in (0, 3)
    checks["b_named"] = "device-side assert" in proc.stderr
    checks["b_fatal_one_attempt"] = (
        report is not None and report["sticky"]
        and not report["transient"] and report["retries"] == 0
        and report["attempts"] == 1 and report["degrades"] == 0
        and not any(report["latches"]))
    checks = {k: bool(v) for k, v in checks.items()}
    row.update({"ok": all(checks.values()), "checks": checks})
    emit({"phase": "cudafaults", **row})
    if not row["ok"]:
        raise RuntimeError(f"cudafaults failed its checks: {checks}")


# ------------------------------------------- the reference-compat surface

#: the port README's quick start: BASELINE config #1 (y ~ N(mu, 1),
#: mu ~ N(0, 1), y = 1 observed: posterior N(0.5, 0.5)) at pop 1e4
QUICKSTART_POP = 10_000
QUICKSTART_GENS = 8
QUICKSTART_MIN_EPS = 0.01


def quickstart_run(torch, show_progress: bool) -> dict:
    """The quick start through ``DefaultSampler()`` on the card, with the
    host reads of the run counted: every synchronizing CUDA call under
    ``torch.cuda.set_sync_debug_mode("warn")`` (one warning each), per
    sampler call and in all; the bar's stderr is captured."""
    import contextlib
    import io
    import warnings

    import numpy as np

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda

    def model(generator, theta):
        mu = theta[:, :1]
        return {"y": mu + torch.randn(mu.shape, generator=generator,
                                      device=mu.device)}

    abc = pt.ABCSMC(pt.SimpleModel(model, name="gauss"),
                    pt.Distribution(mu=pt.RV("norm", 0.0, 1.0)),
                    pt.PNormDistance(p=2), population_size=QUICKSTART_POP,
                    sampler=pt.DefaultSampler(),
                    show_progress=show_progress, seed=1)
    abc.new("sqlite://", {"y": 1.0})
    per_call = []
    sample = abc.sampler.sample_until_n_accepted
    err = io.StringIO()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def counted(*args, **kwargs):
            before = len(caught)
            out = sample(*args, **kwargs)
            per_call.append(len(caught) - before)
            return out

        abc.sampler.sample_until_n_accepted = counted
        weighted_kde_logpdf_cuda.launches = 0
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stderr(err):
                h = abc.run(max_nr_populations=QUICKSTART_GENS,
                            minimum_epsilon=QUICKSTART_MIN_EPS)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    df, w = h.get_distribution(m=0)
    mu = float(np.sum(df["mu"].to_numpy() * w))
    var = float(np.sum(w * (df["mu"].to_numpy() - mu) ** 2))
    return {"abc": abc, "wall_s": wall, "mean": mu, "var": var,
            "max_t": h.max_t, "syncs": syncs, "syncs_per_call": per_call,
            "kde_launches": weighted_kde_logpdf_cuda.launches,
            "stderr": err.getvalue()}


def phase_quickstart1e4(torch, state):
    """The quick start with ``show_progress=True`` beside its twin
    without the bar: tests/test_e2e_slice.py's posterior gate, the same
    populations bit for bit, the same host reads, bar lines on stderr.
    A first run without the bar takes the process's one-off set-up of
    this shape (one more synchronizing call than a warm run), so the
    twins compare warm."""
    warm = quickstart_run(torch, False)
    quiet = quickstart_run(torch, False)
    shown = quickstart_run(torch, True)
    a = shown["abc"]
    difference = population_difference(a.history, quiet["abc"].history)
    bar_lines = [line for line in shown["stderr"].splitlines()
                 if line.startswith("sampling |")]
    checks = {
        "mean": abs(shown["mean"] - 0.5) < 0.15,
        "var": 0.3 < shown["var"] < 0.9,
        "max_t": shown["max_t"] >= 2,
        "sampler": type(a.sampler).__name__ == "VectorizedSampler"
        and a.sampler.device.type == "cuda",
        "bit_identical": difference is None,
        "host_reads": (shown["syncs"] == quiet["syncs"]
                       and shown["syncs_per_call"]
                       == quiet["syncs_per_call"]),
        "bar_lines": (f"{QUICKSTART_POP}/{QUICKSTART_POP}"
                      in shown["stderr"] and bool(bar_lines)
                      and "sampling |" not in quiet["stderr"]),
        "launches": all(r["kde_launches"] >= 1 for r in a.timeline
                        if r["t"] >= 1),
    }
    state.setdefault("launches", {})["quickstart1e4"] = shown["kde_launches"]
    row = {"pop": QUICKSTART_POP, "ok": all(checks.values()),
           "checks": checks, "posterior_mean": shown["mean"],
           "posterior_var": shown["var"], "gens_run": shown["max_t"] + 1,
           "minimum_epsilon": QUICKSTART_MIN_EPS,
           "final_eps": float(a.history.get_all_populations()
                              .epsilon.iloc[-1]),
           "stop_reason": a.stop_reason, "difference": difference,
           "host_syncs": shown["syncs"], "host_syncs_quiet": quiet["syncs"],
           "host_syncs_first_run": warm["syncs"],
           "host_syncs_per_sampler_call": shown["syncs_per_call"],
           "host_syncs_per_sampler_call_quiet": quiet["syncs_per_call"],
           "host_syncs_per_sampler_call_first": warm["syncs_per_call"],
           "bar_lines": len(bar_lines), "bar_last": (bar_lines or [""])[-1],
           "kde_launches": shown["kde_launches"],
           "wall_s": shown["wall_s"], "wall_s_quiet": quiet["wall_s"],
           "generations": [generation_row(r) for r in a.timeline]}
    emit({"phase": "quickstart1e4", **row})
    if not row["ok"]:
        raise RuntimeError(f"quickstart1e4 failed its checks: {checks}")


#: the one-dispatch window set through the environment, and a run long
#: enough to need two dispatches of it.  A 4-generation window at batch
#: 2^19 is refused on the card by the capacity plan's completability
#: check (ceil(4 · 1e6 / 2^19) = 8 rounds > max_T = 4), as the JAX
#: package's plan refuses it
ENVKNOBS_MAX_T = 8
ENVKNOBS_GENS = 17


def _blob_rows(history) -> list:
    """The generations t >= 0 whose model rows hold blobs."""
    return sorted({t for (t,) in history._conn.execute(
        "SELECT t FROM model_populations WHERE abc_smc_id=? AND t>=0 AND "
        "theta IS NOT NULL", (history.id,))})


def phase_envknobs1e6(torch, state):
    """``onedispatch1e6``'s configuration for 17 generations with no
    engine arguments under ``PYABC_TPU_RUN_MODE=onedispatch`` and
    ``PYABC_TPU_ONEDISPATCH_MAX_T=8`` against the twin that passes them:
    bit-identical, ceil(16 / 8) dispatches; then lazy rows under ``PYABC_TPU_LAZY_FINAL_ONLY=1``: of
    the generations the store held at ``done``, only the last gets its
    blobs (generation 0, hydrated during the run, has them already)."""
    saved = _env(PYABC_TPU_RUN_MODE="onedispatch",
                 PYABC_TPU_ONEDISPATCH_MAX_T=str(ENVKNOBS_MAX_T))
    try:
        a_env, wall_env, launches_env = onedispatch_main_run(
            torch, None, gens=ENVKNOBS_GENS)
    finally:
        _env(**saved)
    a_arg, wall_arg, _ = onedispatch_main_run(
        torch, "onedispatch", gens=ENVKNOBS_GENS,
        onedispatch_max_t=ENVKNOBS_MAX_T)
    saved = _env(PYABC_TPU_LAZY_FINAL_ONLY="1")
    try:
        a_lazy, wall_lazy, launches_lazy = onedispatch_main_run(
            torch, "onedispatch", "lazy")
    finally:
        _env(**saved)
    after_t0 = ENVKNOBS_GENS - 1
    expected = -(-after_t0 // ENVKNOBS_MAX_T)
    difference = population_difference(a_env.history, a_arg.history)
    paths = [r["path"] for r in a_env.timeline]
    blob_rows = _blob_rows(a_lazy.history)
    last_lazy = ONEDISPATCH_GENS - 1
    checks = {
        "mode": (a_env.run_mode, a_env.onedispatch_max_t)
        == ("onedispatch", ENVKNOBS_MAX_T),
        "dispatches": a_env.run_dispatches == a_arg.run_dispatches
        == expected,
        "paths": paths == ["sequential"] + ["onedispatch"] * after_t0
        and paths == [r["path"] for r in a_arg.timeline],
        "bit_identical": difference is None,
        # generation 0 is written while the run goes (the sequential
        # engine hydrates it for the host adaptation, as the JAX package
        # does); of the generations left in the store only the last
        "final_only": blob_rows == [0, last_lazy]
        and a_lazy.history.max_t == last_lazy,
        "lazy_summary_rows": all(
            a_lazy.history.get_population_summary(t)
            for t in range(a_lazy.history.max_t)),
    }
    launches = state.setdefault("launches", {})
    launches["envknobs1e6"] = launches_env
    launches["envknobs1e6_final_only"] = launches_lazy
    row = {"pop": ONEDISPATCH_POP, "gens": ENVKNOBS_GENS,
           "max_t": ENVKNOBS_MAX_T, "ok": all(checks.values()),
           "checks": checks, "run_dispatches": a_env.run_dispatches,
           "expected_dispatches": expected, "paths": paths,
           "difference": difference, "blob_rows": blob_rows,
           "wall_s": wall_env, "wall_s_args": wall_arg,
           "wall_s_final_only": wall_lazy, "kde_launches": launches_env}
    emit({"phase": "envknobs1e6", **row})
    if not row["ok"]:
        raise RuntimeError(f"envknobs1e6 failed its checks: {checks}")


REFEXPORT_POP = 100_000
REFEXPORT_GENS = 4
#: the layout tests/test_reference_export.py checks
REFERENCE_TABLES = {
    "abc_smc": {"id", "start_time", "end_time", "json_parameters",
                "distance_function", "epsilon_function",
                "population_strategy", "git_hash"},
    "populations": {"id", "abc_smc_id", "t", "population_end_time",
                    "nr_samples", "epsilon"},
    "models": {"id", "population_id", "m", "name", "p_model"},
    "particles": {"id", "model_id", "w"},
    "parameters": {"id", "particle_id", "name", "value"},
    "samples": {"id", "particle_id", "distance"},
    "summary_statistics": {"id", "sample_id", "name", "value"},
}


def phase_refexport1e5(torch, state):
    """Config #2 at pop 1e5, 4 generations, eager rows without summary
    statistics (``run_gate``'s ``stores_sum_stats=False``), exported with
    ``to_reference_db`` and read back with ``History.from_reference_db``:
    the reference layout, and every generation's θ, weights, distances,
    model probabilities and ε equal bit for bit."""
    import sqlite3
    import tempfile

    import numpy as np

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import make_two_gaussians_problem
    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda

    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance,
                    population_size=REFEXPORT_POP, eps=pt.MedianEpsilon(),
                    sampler=pt.VectorizedSampler(max_batch_size=1 << 19,
                                                 device="cuda"),
                    stores_sum_stats=False, history_mode="eager", seed=0,
                    device="cuda")
    abc.new("sqlite://", observed)
    weighted_kde_logpdf_cuda.launches = 0
    t0 = time.perf_counter()
    h = abc.run(max_nr_populations=REFEXPORT_GENS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    state.setdefault("launches", {})["refexport1e5"] = \
        weighted_kde_logpdf_cuda.launches
    checks = {}
    with tempfile.TemporaryDirectory() as tmp:
        ref_db = str(Path(tmp) / "reference.db")
        t0 = time.perf_counter()
        abc_id = h.to_reference_db(ref_db)
        export_s = time.perf_counter() - t0
        conn = sqlite3.connect(ref_db)
        try:
            layout = {}
            rows = {}
            for table, cols in REFERENCE_TABLES.items():
                layout[table] = {r[1] for r in conn.execute(
                    f"PRAGMA table_info({table})")} == cols
                rows[table] = conn.execute(
                    f"SELECT COUNT(*) FROM {table}").fetchone()[0]
        finally:
            conn.close()
        checks["layout"] = all(layout.values())
        n_rows = REFEXPORT_POP * REFEXPORT_GENS
        checks["rows"] = (rows["particles"] == n_rows + 1
                          and rows["samples"] == n_rows + 1
                          and rows["parameters"] == n_rows)
        t0 = time.perf_counter()
        back = pt.History.from_reference_db(
            ref_db, db=str(Path(tmp) / "back.db"), abc_id=abc_id)
        import_s = time.perf_counter() - t0
        gens = h.get_all_populations()
        gens = gens[gens.t >= 0]
        got = back.get_all_populations()
        checks["eps"] = (list(got.t) == list(gens.t) and np.array_equal(
            got.epsilon.to_numpy(), gens.epsilon.to_numpy())
            and list(got.samples) == list(gens.samples))
        same = True
        for t in range(h.max_t + 1):
            same = same and np.array_equal(
                back.get_model_probabilities(t).to_numpy(),
                h.get_model_probabilities(t).to_numpy())
            a, b = h.get_population(t), back.get_population(t)
            # both group rows by model; the native rows are in round
            # order within each model, and so are the imported ones
            order = np.argsort(a.m, kind="stable")
            for key in ("m", "theta", "weight", "distance"):
                same = same and np.array_equal(
                    np.asarray(getattr(a, key))[order],
                    np.asarray(getattr(b, key)))
        checks["round_trip"] = bool(same)
        back.close()
    row = {"pop": REFEXPORT_POP, "gens": REFEXPORT_GENS,
           "ok": all(checks.values()), "checks": checks,
           "export_s": export_s, "import_s": import_s, "run_s": run_s,
           "rows": rows, "kde_launches":
               state["launches"]["refexport1e5"]}
    emit({"phase": "refexport1e5", **row})
    if not row["ok"]:
        raise RuntimeError(f"refexport1e5 failed its checks: {checks}")


HOST_POP = 1000
#: run_gate's 11 generations cut by two, the smoke's first depth to cut
#: (the last two generations held ~2 850 of a run's ~3 700 tasks)
HOST_GENS = 9
HOST_BATCH = 1024
#: the same-seed repeat runs the first generations again (t = 5 already
#: has ~50 tasks in flight four at a time; t = 10 alone ~1 900)
HOST_REPEAT_GENS = 6
MAPPING_POP = 100
MAPPING_GENS = 3


class ThreadPoolClient:
    """A ``distributed.Client`` stand-in over a thread pool (the
    submit/ncores/close surface ``DaskDistributedSampler`` uses)."""

    def __init__(self, n_workers: int = 4):
        from concurrent.futures import ThreadPoolExecutor
        self._pool = ThreadPoolExecutor(max_workers=n_workers)
        self._n = n_workers

    def submit(self, fn, *args, pure=None):
        return self._pool.submit(fn, *args)

    def ncores(self):
        return {f"w{i}": 1 for i in range(self._n)}

    def close(self):
        self._pool.shutdown(wait=True)


def host_run(torch, sampler, pop: int, gens: int) -> dict:
    """Config #2 through a host sampler on the card (``run_gate``'s
    ε schedule and seed), with the K1 launches the code predicts: a
    task's round evaluates the proposal density in the round, one K1
    launch per model, so generation t >= 1 launches M × its tasks
    (``sampler.task_counts``: the calibration call, then t = 0, 1, ...)."""
    import numpy as np

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import make_two_gaussians_problem
    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda

    models, priors, distance, observed, posterior_fn = \
        make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=pop,
                    eps=pt.MedianEpsilon(), sampler=sampler,
                    stores_sum_stats=False, seed=0)
    abc.new("sqlite://", observed)
    weighted_kde_logpdf_cuda.launches = 0
    t0 = time.perf_counter()
    h = abc.run(max_nr_populations=gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tasks = sampler.task_counts[1:]
    rows = abc.timeline
    predicted = [abc.M * tasks[r["t"]] if r["t"] >= 1 else 0 for r in rows]
    t = h.max_t
    p_b = float(h.get_model_probabilities(t).get(1, 0.0))
    df, w = h.get_distribution(m=1, t=t)
    mu = float(np.sum(df["mu"].to_numpy() * w)) if len(df) else math.nan
    return {"abc": abc, "wall_s": wall, "p_model_b": p_b,
            "p_analytic": float(posterior_fn(1.0)), "mu_b": mu,
            "prob_sum": float(h.get_model_probabilities(t).sum()),
            "gens_run": t + 1, "tasks_per_gen": tasks,
            "kde_launches": weighted_kde_logpdf_cuda.launches,
            "kde_launches_per_gen": [r["kde_launches"] for r in rows],
            "kde_predicted_per_gen": predicted,
            "launches_ok": [r["kde_launches"] for r in rows] == predicted,
            "s_per_task": wall / max(sum(sampler.task_counts), 1),
            "kde_support": max((s["rows"] for r in rows if r["t"] >= 1
                                for s in r["kde_support"]), default=0)}


def _host_gate(run: dict, pop: int) -> dict:
    tol_p = max(2.5e-3, 2.5 / pop ** 0.5)
    tol_mu = max(3e-3, 3.0 / pop ** 0.5)
    return {"p_b": abs(run["p_model_b"] - run["p_analytic"]) < tol_p,
            "mu_b": abs(run["mu_b"] - 1.0) < tol_mu,
            "gens": run["gens_run"] == HOST_GENS,
            "launches": run["launches_ok"]}


def _host_report(runs, checks: dict, launches: dict, name: str) -> dict:
    """A DYN sampler's full run and its same-seed repeat of the first
    generations: ``run_gate`` on the first, the repeat bit-identical to
    its prefix, K1 as predicted in both."""
    first, second = runs
    difference = population_difference(first["abc"].history,
                                       second["abc"].history, prefix=True)
    gate = _host_gate(first, HOST_POP)
    gate["repeat_bit_identical"] = (
        difference is None
        and second["gens_run"] == HOST_REPEAT_GENS)
    gate["repeat_launches"] = second["launches_ok"]
    checks.update({f"{name}_{k}": v for k, v in gate.items()})
    launches[f"hostsamplers_{name}"] = first["kde_launches"]
    launches[f"hostsamplers_{name}_repeat"] = second["kde_launches"]
    report = {k: v for k, v in first.items() if k != "abc"}
    report.update({"wall_s_repeat": second["wall_s"],
                   "repeat_gens": second["gens_run"],
                   "difference": difference})
    return report


def phase_hostsamplers(torch, state):
    """Config #2 through ``ConcurrentFutureSampler`` (4 jobs, 1024
    candidates a task) and ``DaskDistributedSampler`` (over a thread-pool
    client) at pop 1000 for ``HOST_GENS`` generations, each held to
    ``run_gate``'s tolerances at that pop, and again with the same seed
    for 6 generations (bit-identical to the first run's); and
    ``MappingSampler(map_=map)`` at pop 100 for 3 generations (the JAX
    test's gate); K1 launched M × tasks in every generation t >= 1."""
    import pyabc_tpu_torch as pt

    makers = {
        "cfuture": lambda: pt.ConcurrentFutureSampler(
            client_max_jobs=4, batch_size=HOST_BATCH, device="cuda"),
        "dask": lambda: pt.DaskDistributedSampler(
            dask_client=ThreadPoolClient(4), client_max_jobs=4,
            batch_size=HOST_BATCH, device="cuda"),
    }
    report, checks = {}, {}
    launches = state.setdefault("launches", {})
    for name, make in makers.items():
        runs = []
        for gens in (HOST_GENS, HOST_REPEAT_GENS):
            sampler = make()
            runs.append(host_run(torch, sampler, HOST_POP, gens))
            sampler.stop()
        report[name] = _host_report(runs, checks, launches, name)
    sampler = pt.MappingSampler(map_=map, device="cuda")
    mapping = host_run(torch, sampler, MAPPING_POP, MAPPING_GENS)
    checks["mapping_max_t"] = mapping["gens_run"] - 1 >= 1
    checks["mapping_prob_sum"] = abs(mapping["prob_sum"] - 1.0) < 1e-5
    checks["mapping_launches"] = mapping["launches_ok"]
    launches["hostsamplers_mapping"] = mapping["kde_launches"]
    report["mapping"] = {k: v for k, v in mapping.items() if k != "abc"}
    # row (p) of the kernels phase: one task's proposal density
    state["hostsampler_task_shape"] = (HOST_BATCH,
                                       report["cfuture"]["kde_support"], 1)
    row = {"ok": all(checks.values()), "checks": checks,
           "pop": HOST_POP, "batch": HOST_BATCH,
           "tolerance_p": max(2.5e-3, 2.5 / HOST_POP ** 0.5), **report}
    emit({"phase": "hostsamplers", **row})
    if not row["ok"]:
        raise RuntimeError(f"hostsamplers failed its checks: {checks}")


#: opt-in ``hostprof``: the DYN sampler's jobs in flight to compare
HOSTPROF_JOBS = (1, 4, 1)
HOSTPROF_GENS = 8


def phase_hostprof(torch, state):
    """Where a DYN host-sampler task's time goes: config #2 at pop 1000
    through ``ConcurrentFutureSampler`` (1024 candidates a task) for 8
    generations with 1, 4 and again 1 job in flight, each task's round
    (``round_fn`` up to its return, launches only) and fetch timed on the
    host; medians per run (a process's first run carries one-off set-up
    in its mean)."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.sampler import eps_mixin

    runner = eps_mixin.task_runner
    times = {}

    def timed(round_fn, generator, params, B, all_accepted=False):
        def timed_round(gen, p, b, **kwargs):
            t0 = time.perf_counter()
            out = round_fn(gen, p, b, **kwargs)
            times.setdefault("round_ms", []).append(
                1e3 * (time.perf_counter() - t0))
            return out

        run = runner(timed_round, generator, params, B, all_accepted)

        def run_timed(task_id):
            t0 = time.perf_counter()
            out = run(task_id)
            times.setdefault("task_ms", []).append(
                1e3 * (time.perf_counter() - t0))
            return out

        run_timed.started = run.started
        return run_timed

    eps_mixin.task_runner = timed
    runs = []
    try:
        for jobs in HOSTPROF_JOBS:
            times.clear()
            sampler = pt.ConcurrentFutureSampler(
                client_max_jobs=jobs, batch_size=HOST_BATCH, device="cuda")
            r = host_run(torch, sampler, HOST_POP, HOSTPROF_GENS)
            sampler.stop()
            runs.append({"jobs": jobs, "wall_s": r["wall_s"],
                         "tasks": sum(r["tasks_per_gen"]),
                         "ms_per_task": 1e3 * r["s_per_task"],
                         "round_ms_median": statistics.median(
                             times["round_ms"]),
                         "task_ms_median": statistics.median(
                             times["task_ms"]),
                         "round_ms_mean": statistics.fmean(times["round_ms"]),
                         "launches_ok": r["launches_ok"]})
    finally:
        eps_mixin.task_runner = runner
    row = {"ok": all(r["launches_ok"] for r in runs), "runs": runs}
    emit({"phase": "hostprof", **row})
    if not row["ok"]:
        raise RuntimeError("hostprof: K1 launches off the prediction")


def phase_aggregatedlv1e5(torch, state):
    """``lv1e5``'s configuration with ``AggregatedTransition({(0, 2): MVN,
    (2, 4): MVN})``: lv1e5's gates, the sequential engine (no device
    refit for an aggregated transition, as in the JAX package), and K1
    launched twice per generation t >= 1 — once per block, at d = 2."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.ops import kde_cuda

    agg = pt.AggregatedTransition(
        {(0, 2): pt.MultivariateNormalTransition(),
         (2, 4): pt.MultivariateNormalTransition()})
    shapes = []
    run = kde_cuda.KdeCall.run

    def recorded(call):
        shapes.append((call.m, call.n, call.d))
        return run(call)

    kde_cuda.KdeCall.run = recorded
    try:
        row = run_adaptive(torch, "lv1e5", transitions=agg, kde_per_gen=2)
    finally:
        kde_cuda.KdeCall.run = run
    lv = state.get("lv1e5_gen_launches")
    row["checks"]["sequential"] = set(row["paths"]) == {"sequential"}
    row["checks"]["block_d"] = bool(shapes) and all(d == 2
                                                    for _, _, d in shapes)
    if lv is not None:
        row["checks"]["twice_lv1e5"] = all(
            g["kde_launches"] == 2 * lv.get(g["t"], -1)
            for g in row["generations"] if g["t"] >= 1)
    row["ok"] = all(row["checks"].values())
    row["kde_shapes"] = sorted(set(shapes))
    row["lv1e5_gen_launches"] = lv
    state.setdefault("launches", {})["aggregatedlv1e5"] = row["kde_launches"]
    if shapes:
        state["aggregated_block_shape"] = max(shapes)
    emit({"phase": "aggregatedlv1e5", **row})
    if not row["ok"]:
        raise RuntimeError(
            f"aggregatedlv1e5 failed its checks: {row['checks']}")


#: the analysis phase's SIR run (config #4 at sir1e5's configuration)
#: and its viewer's slider grid (visserver's /api/kde)
ANALYSIS_SIR = "sir1e5"
ANALYSIS_KDE_GRID = 120
#: the progress poller's period in the analysis phase (seconds): a pop-1e6
#: generation takes ~0.1 s on the card, the default 0.5 s poll would see
#: a one-dispatch call of 8 generations only a few times
ANALYSIS_POLL_S = "0.05"


class _Env:
    """Set environment variables for a ``with`` block, then restore
    them (the analysis phase's run directory and grid switch must not
    reach any other phase)."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        import os
        self.saved = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return self

    def __exit__(self, *exc):
        import os
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


class _SnapshotWatcher:
    """A thread reading the run directory's telemetry snapshots every
    ``interval`` seconds while a run goes on: every distinct snapshot
    (by its write time) with its progress word."""

    def __init__(self, run_dir: str, interval: float = 0.01):
        import threading
        self.run_dir = run_dir
        self.interval = interval
        self.seen = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="smoke-snapshot-watcher")

    def _run(self):
        from pyabc_tpu_torch.telemetry import aggregate
        while not self._stop.wait(self.interval):
            for snap in aggregate.read_snapshots(self.run_dir):
                self.seen.setdefault(snap["written_unix"],
                                     snap.get("run_progress"))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        return False


def _support_rows(tr) -> int:
    """The support rows of a fitted transition's density: the grid's
    cells where the fit compressed a large 1-D support."""
    params = tr.get_params()
    return int(params.get("c_support", params["support"]).shape[0])


def _counted(torch, fn):
    """``(result, K1 launches, ms)`` of ``fn()`` on the card."""
    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda
    torch.cuda.synchronize()
    before = weighted_kde_logpdf_cuda.launches
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return out, weighted_kde_logpdf_cuda.launches - before, ms


def _within(got, ref) -> tuple:
    """``(ok, max_abs_err)`` of densities against the CPU's at the
    kernel tolerance."""
    import numpy as np
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    return (bool(np.all(np.isfinite(got))
                 and np.all(err <= TOL_ABS + TOL_REL * np.abs(ref))),
            float(err.max()))


def _prometheus_parses(text: str) -> bool:
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        if not name:
            return False
        float(value)
    return True


def analysis_visualization(torch, state, h_main, h_sir) -> dict:
    """The visualization calls on the card beside the same calls with
    ``device="cpu"`` on the same History, with each call's K1 launches
    against what the code gives and its milliseconds."""
    import numpy as np

    from pyabc_tpu_torch import visualization as viz
    from pyabc_tpu_torch.transition import MultivariateNormalTransition
    from pyabc_tpu_torch.visualization.kde import _default_kde

    t = h_main.max_t
    calls, checks = [], {}
    for m in (0, 1):
        df, w = h_main.get_distribution(m=m, t=t)
        tr = MultivariateNormalTransition()
        (grid, dens), n_k1, ms = _counted(torch, lambda: viz.kde_1d(
            df, w, "mu", kde=tr, device="cuda"))
        (grid_c, dens_c), _, ms_c = _counted(torch, lambda: viz.kde_1d(
            df, w, "mu", kde=MultivariateNormalTransition(), device="cpu"))
        ok, err = _within(dens, dens_c)
        checks[f"kde_1d_m{m}"] = ok and np.array_equal(grid, grid_c)
        checks[f"kde_1d_m{m}_launches"] = n_k1 == 1
        calls.append({"call": f"kde_1d m={m}", "ms": ms, "cpu_ms": ms_c,
                      "launches": n_k1, "max_abs_err": err,
                      "shape": [len(grid), _support_rows(tr), 1]})
    # the mode of the smaller model's posterior ([N x grid] on the CPU too)
    m_small = int(np.argmin([len(h_main.get_distribution(m=m, t=t)[0])
                             for m in (0, 1)]))
    df, w = h_main.get_distribution(m=m_small, t=t)
    tr = MultivariateNormalTransition()
    mode, n_k1, ms = _counted(torch, lambda: viz.compute_kde_max(
        tr, df, w, device="cuda"))
    mode_c, _, ms_c = _counted(torch, lambda: viz.compute_kde_max(
        MultivariateNormalTransition(), df, w, device="cpu"))
    same = bool(np.array_equal(mode, mode_c))
    if not same:
        # a tie within float32: the densities at both points agree
        at = torch.tensor(np.stack([mode, mode_c]), dtype=torch.float32,
                          device="cuda")
        d_pair = tr.pdf(at).cpu().numpy()
        same = _within(d_pair[:1], d_pair[1:])[0]
    checks["kde_max"] = same
    checks["kde_max_launches"] = n_k1 == 1
    calls.append({"call": f"compute_kde_max m={m_small}", "ms": ms,
                  "cpu_ms": ms_c, "launches": n_k1,
                  "same_point": bool(np.array_equal(mode, mode_c)),
                  "shape": [len(df), _support_rows(tr), 1]})
    state["analysis_kde_max_shape"] = (len(df), _support_rows(tr), 1)
    # kde_2d on the SIR population (d = 2, no compression)
    sdf, sw = h_sir.get_distribution(m=0, t=h_sir.max_t)
    x, y = list(sdf.columns[:2])
    tr = MultivariateNormalTransition()
    (mx, my, dens), n_k1, ms = _counted(torch, lambda: viz.kde_2d(
        sdf, sw, x, y, kde=tr, device="cuda"))
    (_, _, dens_c), _, ms_c = _counted(torch, lambda: viz.kde_2d(
        sdf, sw, x, y, kde=MultivariateNormalTransition(), device="cpu"))
    ok, err = _within(dens, dens_c)
    checks["kde_2d"] = ok and dens.shape == (50, 50)
    checks["kde_2d_launches"] = n_k1 == 1
    calls.append({"call": f"kde_2d {x},{y}", "ms": ms, "cpu_ms": ms_c,
                  "launches": n_k1, "max_abs_err": err,
                  "shape": [dens.size, _support_rows(tr), 2]})
    state["analysis_kde_2d_shape"] = (dens.size, _support_rows(tr), 2)
    # the CV default (kde=None): a GridSearchCV whose bootstrap runs here
    m_big = 1 - m_small
    df, w = h_main.get_distribution(m=m_big, t=t)
    probe = _default_kde("cuda")
    (grid, dens), n_k1, ms = _counted(torch, lambda: viz.kde_1d(
        df, w, "mu", kde=probe, device="cuda"))
    n_grid = len(probe.param_grid["scaling"])
    checks["cv_default"] = (
        probe.best_params_ is not None
        and probe.best_params_["scaling"] in probe.param_grid["scaling"]
        and bool(np.all(np.isfinite(dens)) and np.all(dens >= 0)))
    checks["cv_launches"] = n_k1 == n_grid * probe.n_bootstrap + 1
    boot = probe.best_estimator_.cv_density_shape
    calls.append({"call": f"kde_1d CV default m={m_big}", "ms": ms,
                  "launches": n_k1, "scaling": probe.best_params_,
                  "bootstrap_shape": list(boot)})
    state["analysis_cv_shape"] = tuple(boot)
    return {"calls": calls, "checks": checks}


def analysis_viewer(torch, state, db: str, run_dir: str, h_main,
                    matplotlib: bool) -> dict:
    """The viewer served from a thread over the run's database and run
    directory, every route fetched with ``urllib`` and parsed, with its
    milliseconds; ``/api/kde`` held to ``kde_1d`` on the card."""
    import threading
    import urllib.request

    import numpy as np

    from pyabc_tpu_torch import visualization as viz
    from pyabc_tpu_torch.transition import MultivariateNormalTransition
    from pyabc_tpu_torch.visserver.server import run_app

    t = h_main.max_t
    httpd = run_app(db, port=0, blocking=False, run_dir=run_dir,
                    device="cuda")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    routes, checks, bodies = [], {}, {}
    try:
        paths = ["/api/runs", "/api/run/1", "/api/fleet", "/metrics",
                 "/abc/1", f"/abc/1/model/0/t/{t}"]
        paths += [f"/api/kde/1/{m}/{t}?x=mu" for m in (0, 1)]
        if matplotlib:
            paths.append(f"/plot/1/0/{t}")
        for path in paths:
            def fetch():
                with urllib.request.urlopen(base + path, timeout=120) as r:
                    return r.status, r.headers.get("Content-Type"), r.read()
            (status, ctype, body), n_k1, ms = _counted(torch, fetch)
            bodies[path] = body
            if ctype == "application/json":
                parsed = json.loads(body)
            elif ctype == "text/plain":
                parsed = _prometheus_parses(body.decode())
            elif ctype == "image/png":
                parsed = body[:8] == b"\x89PNG\r\n\x1a\n"
            else:
                parsed = b"<html>" in body and b"error" not in body
            checks[path] = status == 200 and bool(parsed)
            routes.append({"route": path, "status": status, "ms": ms,
                           "launches": n_k1, "bytes": len(body)})
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    checks["server_stopped"] = not thread.is_alive()
    for m in (0, 1):
        path = f"/api/kde/1/{m}/{t}?x=mu"
        got = json.loads(bodies[path])
        df, w = h_main.get_distribution(m=m, t=t)
        grid, dens = viz.kde_1d(df, w, "mu", numx=ANALYSIS_KDE_GRID,
                                kde=MultivariateNormalTransition(),
                                device="cuda")
        ok, err = _within(got["density"], dens)
        checks[f"api_kde_m{m}"] = ok and np.allclose(got["grid"], grid)
        checks[f"api_kde_m{m}_launches"] = next(
            r["launches"] for r in routes if r["route"] == path) == 1
    tr = MultivariateNormalTransition()
    df, w = h_main.get_distribution(m=1, t=t)
    tr.fit(df.to_numpy(np.float32), np.asarray(w, np.float32))
    state["analysis_api_kde_shape"] = (ANALYSIS_KDE_GRID,
                                       _support_rows(tr), 1)
    fleet = json.loads(bodies["/api/fleet"])
    checks["api_fleet"] = (fleet["enabled"] and len(fleet["hosts"]) == 1
                           and len(fleet["trajectory"]) == t + 1)
    return {"routes": routes, "checks": checks}


def codec_writes(history, root: str) -> dict:
    """History write seconds per generation and the database's bytes
    under each blob codec: the run's populations appended again,
    generation by generation, to a fresh file database with PTW1 (the
    default) and with ``$PYABC_TPU_WIRE_CODEC=raw``."""
    import os
    import sqlite3

    from pyabc_tpu_torch.storage import History
    from pyabc_tpu_torch.wire import transfer

    names = history.model_names()
    pops = history.get_all_populations()
    gens = [(int(r.t), float(r.epsilon), int(r.samples),
             history.get_population(int(r.t)))
            for r in pops.itertuples() if r.t >= 0]
    out = {}
    for label, value in (("ptw1", None), ("raw", "raw")):
        path = os.path.join(root, f"codec_{label}.db")
        with _Env(**{transfer.WIRE_CODEC_ENV: value}):
            h = History("sqlite:///" + path)
            h.store_initial_data(None, {}, {"y": 1.0}, None, names)
            seconds = []
            for t, eps, evals, pop in gens:
                t0 = time.perf_counter()
                h.append_population(t, eps, pop, evals, names,
                                    [["mu"]] * len(names))
                seconds.append(time.perf_counter() - t0)
            h.close()
        with sqlite3.connect(path) as conn:
            blob = conn.execute("SELECT theta FROM model_populations "
                                "LIMIT 1").fetchone()[0]
        out[label] = {"write_s_per_gen": seconds,
                      "write_s_median": statistics.median(seconds),
                      "db_bytes": os.path.getsize(path),
                      "rows_per_gen": len(gens[0][3]),
                      "ptw1_blobs": transfer.is_ptw1(blob)}
    return out


def phase_analysis1e6(torch, state):
    """Looking at a run on the card: config #2 at pop 1e6 in
    ``onedispatch1e6``'s configuration with lazy rows, a run directory
    and the summary grid, beside its twin without them; config #4 at
    ``sir1e5``'s configuration; the visualization calls on the card
    against the CPU; the viewer over HTTP."""
    import importlib.util
    import os
    import sqlite3
    import tempfile

    import numpy as np

    from pyabc_tpu_torch.parallel import health
    from pyabc_tpu_torch.storage.history import _unpack
    from pyabc_tpu_torch.telemetry import aggregate, lanes, spans
    from pyabc_tpu_torch.wire import store, transfer

    matplotlib = importlib.util.find_spec("matplotlib") is not None
    if matplotlib:
        import matplotlib as mpl
        mpl.use("Agg")
    tmp = tempfile.mkdtemp(prefix="analysis1e6_")
    run_dir = os.path.join(tmp, "run")
    db = os.path.join(tmp, "od.db")
    checks = {}
    tracer = (spans.TRACER.enabled, spans.TRACER._path)
    try:
        with _Env(**{health.RUN_DIR_ENV: run_dir,
                     store.SUMMARY_GRID_ENV: "1",
                     lanes.POLL_ENV: ANALYSIS_POLL_S}):
            with _SnapshotWatcher(run_dir) as watcher:
                a_run, wall, launches = onedispatch_main_run(
                    torch, "onedispatch", "lazy", db=db)
        # the publisher armed the span tracer into the run directory
        spans.TRACER.reset()
        if tracer[1]:
            spans.TRACER.configure(trace_path=tracer[1])
        # the twin also writes plain .npy blobs: the codec changes bytes,
        # never what reads back
        with _Env(**{health.RUN_DIR_ENV: None,
                     store.SUMMARY_GRID_ENV: None,
                     transfer.WIRE_CODEC_ENV: "raw"}):
            a_twin, wall_twin, launches_twin = onedispatch_main_run(
                torch, "onedispatch", "lazy",
                db=os.path.join(tmp, "twin.db"))
        report = onedispatch_report(a_run, a_run.timeline, wall)
        checks.update(report["onedispatch_checks"])
        difference = population_difference(a_run.history, a_twin.history)
        checks["bit_identical_to_twin"] = difference is None
        codec = codec_writes(a_run.history, tmp)
        checks["codec_blobs"] = codec["ptw1"]["ptw1_blobs"] and \
            not codec["raw"]["ptw1_blobs"]
        checks["twin_has_no_fleet"] = a_twin._fleet is None
        # the fleet view
        snaps = aggregate.read_snapshots(run_dir)
        checks["one_host"] = len(snaps) == 1
        ts = [r["t"] for r in a_run.timeline]
        traj = [r["gen"] for r in (snaps[0].get("trajectory") or [])] \
            if snaps else []
        checks["trajectory"] = traj == ts
        in_flight = [w for w in watcher.seen.values()
                     if w and w.get("active") and w["gen"] > w["t0"]]
        checks["in_flight_snapshot"] = bool(in_flight)
        roll = aggregate.fleet_rollup(run_dir)
        prom = aggregate.render_prometheus(run_dir)
        checks["rollup"] = (roll["n_hosts"] == 1
                            and json.loads(json.dumps(roll)) == roll)
        checks["prometheus"] = (_prometheus_parses(prom)
                                and "pyabc_tpu_fleet_hosts 1" in prom)
        # the summary grid: the sequential site's lazy rows carry one
        con = sqlite3.connect(db)
        grid_rows = dict(con.execute(
            "SELECT t, summary_grid FROM populations WHERE t >= 0"
        ).fetchall())
        con.close()
        seq_lazy = [r["t"] for r in a_run.timeline
                    if r["path"] == "sequential"
                    and r["history_mode"] == "lazy"]
        grids = []
        for t in seq_lazy:
            blob = grid_rows.get(t)
            if blob is None:
                grids.append({"t": t, "grid": None})
                continue
            g = _unpack(blob).astype(np.float64)
            mass = np.exp(g[1])
            pop = a_run.history.get_population(t)
            w = pop.weight / pop.weight.sum()
            mean = float(np.sum(w * pop.theta[:, 0]))
            grids.append({"t": t, "cells": int(g.shape[1]),
                          "mass_sum_err": abs(float(mass.sum()) - 1.0),
                          "mean_err": abs(float(np.sum(mass * g[0]))
                                          - mean)})
        checks["summary_grid"] = bool(grids) and all(
            g.get("cells") and g["cells"] <= (1 << 14)
            and g["mass_sum_err"] <= 1e-5 and g["mean_err"] <= 1e-4
            for g in grids)
        # the JAX package's one-dispatch append keeps no grid either
        checks["od_rows_without_grid"] = all(
            grid_rows.get(r["t"]) is None for r in a_run.timeline
            if r["path"] == "onedispatch")
        # config #4 for the 2-D density
        from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda
        a_sir = adaptive_abc(ANALYSIS_SIR)[0]
        weighted_kde_logpdf_cuda.launches = 0
        a_sir.run(max_nr_populations=ADAPTIVE[ANALYSIS_SIR][2])
        launches_sir = weighted_kde_logpdf_cuda.launches
        checks["sir_gens"] = a_sir.history.max_t + 1 == \
            ADAPTIVE[ANALYSIS_SIR][2]
        h_main = a_run.history
        weighted_kde_logpdf_cuda.launches = 0
        viz = analysis_visualization(torch, state, h_main, a_sir.history)
        viewer = analysis_viewer(torch, state, db, run_dir, h_main,
                                 matplotlib)
        launches_analysis = weighted_kde_logpdf_cuda.launches
        checks.update(viz["checks"])
        checks.update({f"viewer {k}": v
                       for k, v in viewer["checks"].items()})
    finally:
        spans.TRACER.reset()
        if tracer[1]:
            spans.TRACER.configure(trace_path=tracer[1])
    launch_state = state.setdefault("launches", {})
    launch_state["analysis1e6"] = launches
    launch_state["analysis1e6_twin"] = launches_twin
    launch_state["analysis1e6_sir"] = launches_sir
    launch_state["analysis1e6_calls"] = launches_analysis
    row = {"phase": "analysis1e6", "ok": all(checks.values()),
           "checks": checks, "matplotlib": matplotlib,
           "pop": ONEDISPATCH_POP, "gens": ONEDISPATCH_GENS,
           "wall_s": wall, "twin_wall_s": wall_twin,
           "kde_launches": launches, "twin_kde_launches": launches_twin,
           "sir_kde_launches": launches_sir,
           "analysis_kde_launches": launches_analysis,
           "twin_difference": difference,
           "snapshots_seen": len(watcher.seen),
           "in_flight_snapshots": len(in_flight),
           "in_flight_gens": sorted({w["gen"] for w in in_flight}),
           "poll_s": float(ANALYSIS_POLL_S),
           "engine_builds": roll["metrics"].get(
               "xla_compiles_total", {}).get("sum"),
           "codec": codec,
           "summary_grids": grids, "calls": viz["calls"],
           "routes": viewer["routes"],
           "paths": report["paths"]}
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"analysis1e6 failed its checks: {checks}")


# ------------------------------------------------------------ serving
#: bench.py's bench_serve mix (SERVE_GENS, :719): one warm-up and one
#: renewed pop-1e4 study, four pop-100 studies, three pop-1000 studies,
#: three duplicates
SERVE_GENS = 3
SERVE_LARGE = 10_000
#: bench.py's bench_serve_cb workload: 96 studies at pop 100, three
#: short (2 generations) to one long (12), Poisson arrivals at 100 Hz
SERVECB_STUDIES = 96
SERVECB_RATE_HZ = 100.0
SERVECB_ENV = {"PYABC_TPU_SERVE_MULTIPLEX": "8",
               "PYABC_TPU_SERVE_CB_WINDOW": "2"}
#: the study axis's posterior gate (tests/test_serve.py:407-410)
SERVE_MEAN_TOL = 0.15
#: servecb's gate on its 12-generation studies (y ~ N(mu, 1), mu ~ N(0,
#: 1), distance |y - y_obs|): a lane's last population is an importance
#: sample of the ABC posterior at its last eps (``_abc_gauss_posterior``).
#: Each lane's weighted mean and std become z-scores on its ESS
#: (sigma / sqrt(ESS), sigma / sqrt(2 ESS)); per arm, each z-score summed
#: over the lanes over sqrt(lanes) must lie within SERVECB_Z.  The prior
#: (std 1 against ~0.71) fails it, as do uniform weights or a doubled
#: kernel scale in the weights (PERF.md, PR 13)
SERVECB_Z = 4.0


def _abc_gauss_posterior(torch, y_obs: float, eps: float):
    """Mean and std of p(mu | |y - y_obs| <= eps) for y ~ N(mu, 1) under
    mu ~ N(0, 1): N(mu; 0, 1) [Phi(y_obs + eps - mu) - Phi(y_obs - eps -
    mu)], by quadrature on the CPU in float64."""
    mu = torch.linspace(-8.0, 8.0, 40001, dtype=torch.float64)
    dens = torch.exp(-0.5 * mu * mu) * (
        torch.special.ndtr(y_obs + eps - mu)
        - torch.special.ndtr(y_obs - eps - mu))
    dens = dens / dens.sum()
    mean = float((dens * mu).sum())
    return mean, float(torch.sqrt((dens * (mu - mean) ** 2).sum()))


def _servecb_posterior(torch, lanes: dict) -> dict:
    """The servecb posterior gate over one arm's 12-generation lanes:
    pooled z-scores of the weighted mean and (reliability-corrected)
    std against ``_abc_gauss_posterior`` at each lane's last eps."""
    import numpy as np
    z_mean, z_std, gens = [], [], []
    for spec, res in lanes.values():
        if spec.max_generations != 12:
            continue
        eps = float(res["eps"])
        if not math.isfinite(eps) or int(res["gens"]) < 2:
            return {"ok": False, "lanes": len(z_mean), "eps": eps}
        theta = np.asarray(res["theta"], dtype=np.float64)[:, 0]
        w = np.asarray(res["w"], dtype=np.float64)
        w = w / w.sum()
        w2 = float(np.sum(w * w))
        mean = float(np.sum(w * theta))
        std = math.sqrt(float(np.sum(w * (theta - mean) ** 2)) / (1 - w2))
        ref_mean, ref_std = _abc_gauss_posterior(
            torch, float(np.float32(spec.observed["y"])), eps)
        z_mean.append((mean - ref_mean) * math.sqrt(1 / w2) / ref_std)
        z_std.append((std - ref_std) * math.sqrt(2 / w2) / ref_std)
        gens.append(int(res["gens"]))
    k = len(z_mean)
    pooled = (sum(z_mean) / math.sqrt(max(k, 1)),
              sum(z_std) / math.sqrt(max(k, 1)))
    return {"ok": k > 0 and all(abs(z) <= SERVECB_Z for z in pooled),
            "lanes": k, "z_mean": pooled[0], "z_std": pooled[1],
            "max_lane_abs_z_mean": max(map(abs, z_mean), default=None),
            "max_lane_abs_z_std": max(map(abs, z_std), default=None),
            "gens": sorted(gens)}


def _serve_model(generator, theta):
    """bench.py's ``_serve_model`` (:722-728) for torch: y = mu + 0.1·N(0,
    1).  Module-level, as a tenant's importable model (specs pickle)."""
    import torch
    noise = 0.1 * torch.randn(theta.shape[0], 1, generator=generator,
                              device=theta.device)
    return {"y": theta[:, :1] + noise}


def _serve_spec(pop, seed, tenant, y=0.4, gens=SERVE_GENS):
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.serve import StudySpec
    return StudySpec(model=_serve_model,
                     prior=pt.Distribution(mu=pt.RV("uniform", -1.0, 2.0)),
                     observed={"y": float(y)}, population_size=pop,
                     seed=seed, tenant=tenant, max_generations=gens)


def _capture_lanes(worker, store: dict):
    """Record every study-axis lane result the worker summarizes (keyed
    by digest), leaving the summary as it was."""
    inner = worker._batch_summary

    def capture(spec, res, digest):
        store[digest] = (spec, {k: v.copy() for k, v in res.items()})
        return inner(spec, res, digest)
    worker._batch_summary = capture


def _same_bits(a: dict, b: dict) -> bool:
    import numpy as np
    return set(a) == set(b) and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
        and np.asarray(a[k]).dtype == np.asarray(b[k]).dtype for k in a)


def _lane_twin(torch, spec, window: int) -> dict:
    """The same spec as a fresh batch of one on the card."""
    from pyabc_tpu_torch.serve import StudyBatch
    return StudyBatch([spec], program_cache={}, window=window,
                      device="cuda").run()[0]


def _walls(ms):
    ms = sorted(ms)
    if not ms:
        return None, None
    return (ms[len(ms) // 2],
            ms[min(len(ms) - 1, int(round(0.99 * (len(ms) - 1))))])


def phase_serve1e4(torch, state):
    """bench_serve's mix through one ServeWorker on the card: the solo
    one-dispatch engine (warm-up, then a renewed study), the study axis
    (pop 100 and 1000 lanes), the cache (three duplicates)."""
    import os
    import tempfile

    import numpy as np

    from pyabc_tpu_torch.autotune import compile_counters
    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda
    from pyabc_tpu_torch.sampler import fused
    from pyabc_tpu_torch.serve import ServeWorker, StudyQueue
    from pyabc_tpu_torch.serve.spec import study_digest
    from pyabc_tpu_torch.telemetry.metrics import REGISTRY

    root = tempfile.mkdtemp(prefix="serve1e4_")
    worker = ServeWorker(root=root)
    lanes: dict = {}
    _capture_lanes(worker, lanes)
    warm = worker.serve_spec(_serve_spec(SERVE_LARGE, 0, "t_large"))
    (abc,) = worker._engines.values()
    ladder0 = abc.sampler._ladder.summary()
    builds0 = compile_counters()["n_compiles"]
    engine_builds0 = REGISTRY.counter("serve_engine_builds_total").value

    # the main path: the counts start at 0 here
    weighted_kde_logpdf_cuda.launches = 0
    t0 = time.perf_counter()
    served0 = worker.served
    renewed = worker.serve_spec(_serve_spec(SERVE_LARGE, 1, "t_large"))
    torch.cuda.synchronize()
    solo_launches = weighted_kde_logpdf_cuda.launches
    solo_rows = [dict(r) for r in abc.timeline]
    ladder1 = abc.sampler._ladder.summary()
    builds1 = compile_counters()["n_compiles"]
    queue = StudyQueue(root=root)
    mix = ([_serve_spec(100, s, "t_small", y=y)
            for s, y in enumerate((0.2, 0.3, 0.4, 0.5))]
           + [_serve_spec(1_000, s, "t_mid") for s in range(3)])
    dups = [_serve_spec(100, 1, "t_small", y=0.3),
            _serve_spec(1_000, 1, "t_mid"), _serve_spec(1_000, 2, "t_mid")]
    tickets = [queue.submit(s) for s in mix + dups]
    worker.run_forever(queue, once=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = weighted_kde_logpdf_cuda.launches
    lane_launches = launches - solo_launches
    n_served = worker.served - served0
    p50, p99 = _walls(worker.walls_ms[-n_served:])
    stats = queue.stats()
    engines = {}
    for t in tickets:
        with open(os.path.join(queue.root, "done", f"{t.id}.json"),
                  encoding="utf-8") as f:
            engines[t.id] = json.load(f)["engine"]
    dup_ids = {t.id for t in tickets[len(mix):]}

    # duplicates again, alone: the cache with no build and no launch
    weighted_kde_logpdf_cuda.launches = 0
    b0 = compile_counters()["n_compiles"]
    e0 = REGISTRY.counter("serve_engine_builds_total").value
    again = [worker.serve_spec(s) for s in dups]
    dup_launches = weighted_kde_logpdf_cuda.launches
    dup_builds = compile_counters()["n_compiles"] - b0
    dup_engine_builds = REGISTRY.counter(
        "serve_engine_builds_total").value - e0

    # every multiplexed lane against the same spec as a batch of one
    twins = {d: _same_bits(res, _lane_twin(torch, spec, 8))
             for d, (spec, res) in lanes.items()}
    means = {}
    for spec in mix:
        summary = worker.cache.get(
            f"{study_digest(spec)}."
            f"{'multiplex' if spec.population_size <= 4096 else 'solo'}")
        means[f"{spec.population_size}/{spec.seed}"] = (
            summary["posterior_mean"]["mu"], spec.observed["y"])
    for label, s in (("warm", warm), ("renewed", renewed)):
        means[f"{SERVE_LARGE}/{label}"] = (s["posterior_mean"]["mu"], 0.4)
    lane_gens = {d: int(res["gens"]) for d, (_s, res) in lanes.items()}
    od_rows = [r for r in solo_rows if r["path"] == "onedispatch"]
    per_gen = fused.kde_launches_per_gen(1, False)
    checks = {
        "served": (n_served == len(mix) + len(dups) + 1
                   and (stats["done"], stats["failed"], stats["pending"])
                   == (len(tickets), 0, 0)),
        "engines": (renewed["served_from"] == "solo"
                    and warm["served_from"] == "solo"
                    and sorted(engines[i] for i in dup_ids)
                    == ["cache"] * 3
                    and sorted(v for i, v in engines.items()
                               if i not in dup_ids)
                    == ["multiplex"] * len(mix)),
        "duplicates_from_cache": (
            all(s["served_from"] == "cache" for s in again)
            and dup_launches == 0 and dup_builds == 0
            and dup_engine_builds == 0),
        "renew_no_build": (builds1 == builds0
                           and ladder1["misses"] == ladder0["misses"]
                           and ladder1["hits"] >= ladder0["hits"] + 1
                           and REGISTRY.counter(
                               "serve_engine_builds_total").value
                           == engine_builds0),
        "lanes_bit_identical": bool(twins) and all(twins.values())
        and len(twins) == len(mix),
        "posterior": all(abs(m - y) < SERVE_MEAN_TOL
                         for m, y in means.values()),
        # K1: once per lane and successful generation; the solo engine's
        # finalize once per one-dispatch generation
        "k1_lanes": lane_launches == sum(g - 1 for g in lane_gens.values()),
        "k1_solo": (solo_launches == sum(r["kde_launches"]
                                         for r in solo_rows)
                    and bool(od_rows)
                    and all(r["kde_launches"] == per_gen for r in od_rows)),
        "launched": launches > 0,
    }
    lane_shapes = sorted({int(s.population_size) for s in mix})
    state.setdefault("launches", {})["serve1e4"] = launches
    state["serve_lane_launches"] = {
        p: sum(lane_gens[study_digest(s)] - 1 for s in mix
               if s.population_size == p) for p in lane_shapes}
    sup = [r.get("kde_support") for r in od_rows]
    state["serve_solo_shape"] = (SERVE_LARGE, (sup[-1] or [{}])[0].get(
        "rows", SERVE_LARGE) if sup else SERVE_LARGE, 1,
        bool(sup and (sup[-1] or [{}])[0].get("compressed")),
        sum(r["kde_launches"] for r in od_rows))
    ladder = {k: 0 for k in ("hits", "misses", "evictions")}
    for eng in worker._engines.values():
        for k in ladder:
            ladder[k] += int(eng.sampler._ladder.summary()[k])
    cache = worker.cache.stats()
    row = {"phase": "serve1e4", "ok": all(checks.values()),
           "checks": checks, "studies": n_served, "wall_s": wall,
           "studies_per_s": n_served / wall, "p50_ms": p50, "p99_ms": p99,
           "cache": {k: cache[k] for k in ("hits", "misses", "t1_hits",
                                           "t2_hits", "hit_ratio")},
           "ladder": ladder, "ladder_renew": {"before": ladder0,
                                              "after": ladder1},
           "kde_launches": launches, "solo_kde_launches": solo_launches,
           "lane_kde_launches": lane_launches,
           "lane_gens": sorted(lane_gens.values()),
           "posterior_means": means,
           "solo_generations": [generation_row(r) for r in solo_rows]}
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"serve1e4 failed its checks: {checks}")


def _servecb_spec(seed, gens, tag):
    """bench.py's cb_spec: one batch_key, duration and seed per lane."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import gaussian_model
    from pyabc_tpu_torch.serve import StudySpec
    return StudySpec(model=gaussian_model,
                     prior=pt.Distribution(mu=pt.RV("norm", 0.0, 1.0)),
                     observed={"y": 0.1 * (seed % 5)}, population_size=100,
                     seed=seed, tenant=f"cb_{tag}", max_generations=gens)


def _servecb_arm(torch, root: str, cb_on: bool, tag: str) -> dict:
    """One arm: the pool submitted from a thread at seeded Poisson
    arrivals to a worker thread in this process; latency = tombstone
    ``completed_unix`` − ``submitted_unix``."""
    import os
    import threading

    import numpy as np

    from pyabc_tpu_torch.serve import ServeWorker, StudyQueue

    pool = [_servecb_spec(4 * i + j, 12 if j == 3 else 2, tag)
            for i in range(SERVECB_STUDIES // 4) for j in range(4)]
    with _Env(PYABC_TPU_SERVE_CB="1" if cb_on else "0", **SERVECB_ENV):
        queue = StudyQueue(root=os.path.join(root, tag), max_depth=4096,
                           tenant_quota=4096)
        worker = ServeWorker(root=queue.root, worker_id=f"w_{tag}")
        lanes: dict = {}
        _capture_lanes(worker, lanes)
        joined = []
        admit = worker._cb_admit_lane

        def admit_and_note(batch, lanes_, tk, spec, digest):
            joined.append(digest)
            return admit(batch, lanes_, tk, spec, digest)
        worker._cb_admit_lane = admit_and_note
        failure = []

        def serve():
            try:
                worker.run_forever(queue, poll_s=0.005)
            except BaseException as exc:  # reported, then fatal
                failure.append(repr(exc))

        th = threading.Thread(target=serve, daemon=True)
        gaps = np.random.default_rng(5).exponential(
            1.0 / SERVECB_RATE_HZ, len(pool))
        t0 = time.perf_counter()
        th.start()
        tickets = []

        def submit():
            for spec, gap in zip(pool, gaps):
                time.sleep(gap)
                tickets.append(queue.submit(spec))

        sub = threading.Thread(target=submit, daemon=True)
        sub.start()
        sub.join(timeout=120.0)
        deadline = time.perf_counter() + 120.0
        while time.perf_counter() < deadline and not failure:
            st = queue.stats()
            if st["done"] + st["failed"] >= len(pool):
                break
            time.sleep(0.01)
        worker.drain()
        th.join(timeout=60.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = queue.stats()
    lat = []
    for t in tickets:
        path = os.path.join(queue.root, "done", f"{t.id}.json")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                tomb = json.load(f)
            lat.append(1e3 * (tomb["completed_unix"]
                              - tomb["submitted_unix"]))
    p50, p99 = _walls(lat)
    return {"pool": pool, "lanes": lanes, "joined": joined,
            "stats": stats, "failure": failure, "wall_s": wall,
            "p50_ms": p50, "p99_ms": p99, "completed": len(lat),
            "alive": th.is_alive()}


def phase_servecb(torch, state):
    """bench_serve_cb's workload with continuous batching off and on,
    then the fixed-shape turnover probe."""
    import tempfile

    from pyabc_tpu_torch.autotune import (compile_counters,
                                          install_compile_listener)
    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda
    from pyabc_tpu_torch.serve import StudyBatch
    from pyabc_tpu_torch.serve.multiplex import STOP_NAMES
    from pyabc_tpu_torch.telemetry.metrics import REGISTRY

    root = tempfile.mkdtemp(prefix="servecb_")
    weighted_kde_logpdf_cuda.launches = 0
    static = _servecb_arm(torch, root, False, "static")
    static_launches = weighted_kde_logpdf_cuda.launches
    turn0 = REGISTRY.counter("serve_cb_lane_turnovers_total").value
    win0 = REGISTRY.counter("serve_cb_windows_total").value
    weighted_kde_logpdf_cuda.launches = 0
    cb = _servecb_arm(torch, root, True, "cb")
    cb_launches = weighted_kde_logpdf_cuda.launches
    turnovers = REGISTRY.counter(
        "serve_cb_lane_turnovers_total").value - turn0
    windows = REGISTRY.counter("serve_cb_windows_total").value - win0
    occupancy = REGISTRY.gauge("serve_cb_occupancy").value

    # the fixed-shape probe: >= 3 admit/retire turnovers, no build
    install_compile_listener()
    probe = StudyBatch([_servecb_spec(9000, 2, "probe"),
                        _servecb_spec(9001, 2, "probe")],
                       program_cache={}, window=1, device="cuda")
    probe.step_window()
    n0 = compile_counters()["n_compiles"]
    waiting = [_servecb_spec(9000 + s, 2, "probe") for s in (2, 3, 4)]
    for _ in range(64):
        for slot in probe.step_window():
            probe.retire(slot)
            if waiting:
                probe.admit(waiting.pop(0), slot=slot)
        if not waiting and not probe.unfinished():
            break
    probe_builds = compile_counters()["n_compiles"] - n0

    # three sampled lanes of the CB arm against fresh batches of one: a
    # long and a short lane admitted mid-session, one seated at window 0
    joined = [d for d in cb["joined"] if d in cb["lanes"]]
    picks = [next((d for d in joined
                   if cb["lanes"][d][0].max_generations == g), None)
             for g in (12, 2)]
    picks.append(next((d for d in cb["lanes"] if d not in joined), None))
    picks = [d for d in picks if d is not None]
    picks += [d for d in joined if d not in picks][:3 - len(picks)]
    sampled = {}
    for d in picks:
        spec, res = cb["lanes"][d]
        sampled[f"seed {spec.seed} gens {spec.max_generations}"] = \
            _same_bits(res, _lane_twin(torch, spec, 2))
    posterior = {tag: _servecb_posterior(torch, arm["lanes"])
                 for tag, arm in (("static", static), ("cb", cb))}
    lane_gens = sum(int(res["gens"]) - 1
                    for arm in (static, cb) for _s, res in arm["lanes"].values())
    checks = {
        "no_failed": all(a["stats"]["failed"] == 0 and not a["failure"]
                         and a["completed"] == SERVECB_STUDIES
                         and not a["alive"] for a in (static, cb)),
        "turnover_no_build": probe_builds == 0 and probe.turnovers >= 3
        and probe.admitted == 5,
        "session_turnovers": turnovers >= 3,
        "sampled_bit_identical": len(sampled) == 3 and all(
            sampled.values()),
        "posterior": all(g["ok"] and g["lanes"] == SERVECB_STUDIES // 4
                         for g in posterior.values()),
        "k1_lanes": static_launches + cb_launches == lane_gens,
        "launched": cb_launches > 0 and static_launches > 0,
    }
    state.setdefault("launches", {})["servecb"] = cb_launches
    state["launches"]["servecb_static"] = static_launches
    state["servecb_lane_launches"] = cb_launches + static_launches
    row = {"phase": "servecb", "ok": all(checks.values()),
           "checks": checks, "studies": SERVECB_STUDIES,
           "rate_hz": SERVECB_RATE_HZ, **SERVECB_ENV,
           "cb_p50_ms": cb["p50_ms"], "cb_p99_ms": cb["p99_ms"],
           "static_p50_ms": static["p50_ms"],
           "static_p99_ms": static["p99_ms"],
           "cb_wall_s": cb["wall_s"], "static_wall_s": static["wall_s"],
           "lane_turnovers": int(turnovers), "windows": int(windows),
           "occupancy": occupancy, "probe_builds": probe_builds,
           "probe_turnovers": probe.turnovers,
           "refilled_lanes": len(cb["joined"]),
           "sampled": sampled, "posterior": posterior,
           "stop_reasons": {
               tag: {name: sum(1 for _s, r in arm["lanes"].values()
                               if STOP_NAMES[int(r["stop_code"])] == name)
                     for name in STOP_NAMES}
               for tag, arm in (("static", static), ("cb", cb))},
           "kde_launches": cb_launches,
           "static_kde_launches": static_launches,
           "failures": static["failure"] + cb["failure"]}
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"servecb failed its checks: {checks}")


def phase_serveprof(torch, state):
    """One study-axis window under ``torch.profiler``: 8 lanes of
    ``servecb``'s spec (pop 100, 12-generation budget) seated at once,
    one warm window, then the next window profiled: device time by
    kernel, the device's idle share, launches per lane generation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda
    from pyabc_tpu_torch.serve import StudyBatch

    batch = StudyBatch([_servecb_spec(7000 + i, 12, "prof")
                        for i in range(8)], program_cache={}, window=2,
                       device="cuda")
    batch.step_window()
    gens0 = [int(g) for g in batch._carry[4]]
    torch.cuda.synchronize()
    k0 = weighted_kde_logpdf_cuda.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batch.step_window()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    lane_gens = sum(int(g) - g0 for g, g0 in zip(batch._carry[4], gens0))

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_s = sum(dev_us(e) for e in kernels) * 1e-6
    if busy_s <= 0:
        raise RuntimeError("the profiler saw no device time")
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    emit({"phase": "serveprof", "ok": True, "lanes": 8, "window": 2,
          "lane_generations": lane_gens, "wall_s": wall,
          "wall_per_lane_generation_ms": 1e3 * wall / max(lane_gens, 1),
          "device_busy_s": busy_s, "device_idle_share": 1 - busy_s / wall,
          "device_launches": launches,
          "launches_per_lane_generation": launches / max(lane_gens, 1),
          "kde_launches": weighted_kde_logpdf_cuda.launches - k0,
          "top_device": [{"name": e.key[:80], "calls": e.count,
                          "device_s": dev_us(e) * 1e-6} for e in top]})


def serve_cases(state) -> list:
    """Rows (v)-(y): K1 at the study axis's lane shapes (a lane's
    importance weights: pop queries against the pop-row previous
    population, d = 1) at pop 100, 1000 and 4096 (the study axis's
    largest, ``PYABC_TPU_SERVE_MULTIPLEX_MAX_POP``), and the solo engine's
    pop-1e4 finalize from ``serve1e4``'s run (or its stated default)."""
    # a count is printed only when serve1e4 ran in this invocation (a
    # lane shape its mix has no study at then counts 0); else null
    launches = state.get("serve_lane_launches")
    out = [(f"{tag} serve lane pop{p}", p, p, 1,
            {"main_launches": None if launches is None
             else launches.get(p, 0)})
           for tag, p in (("v", 100), ("w", 1000), ("x", 4096))]
    m, n, d, grid, n_launch = state.get(
        "serve_solo_shape", (SERVE_LARGE, SERVE_LARGE, 1, False, None))
    source = "run" if "serve_solo_shape" in state else "default"
    out.append((f"y serve1e4 solo finalize ({source})", m, n, d,
                {"grid": grid, "main_launches": n_launch}))
    return out


#: the bound of the engine cache the ladder replaced, then the ladder's
#: (``sampler.vectorized.LADDER_CAPACITY``, the JAX package's 16)
LADDERMEM_CAPACITIES = (4, 16)


def phase_laddermem(torch, state):
    """The ladder's memory: ``envknobs1e6`` and ``chaos1e6`` with the
    sampler's ladder at each of ``LADDERMEM_CAPACITIES`` entries: each
    arm's ``max_memory_allocated`` and the most engines a ladder held."""
    from pyabc_tpu_torch.autotune.ladder import CompiledLadder
    from pyabc_tpu_torch.sampler import vectorized

    out, held, pools = {}, {}, {}
    port_capacity = vectorized.LADDER_CAPACITY
    insert = CompiledLadder._insert
    graph_pool = CompiledLadder.graph_pool
    sizes, ladders = [], []

    def counting_insert(self, key, value):
        insert(self, key, value)
        sizes.append(len(self))

    def noting_pool(self):
        if all(lad is not self for lad in ladders):
            ladders.append(self)
        return graph_pool(self)

    CompiledLadder._insert = counting_insert
    CompiledLadder.graph_pool = noting_pool
    try:
        for cap in LADDERMEM_CAPACITIES:
            vectorized.LADDER_CAPACITY = cap
            for name in ("envknobs1e6", "chaos1e6"):
                sizes.clear()
                ladders.clear()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                PHASES[name](torch, state)
                torch.cuda.synchronize()
                out[f"{name} cap {cap}"] = torch.cuda.max_memory_allocated()
                held[f"{name} cap {cap}"] = max(sizes, default=0)
                # the graph pools of the phase's samplers' ladders
                pools[f"{name} cap {cap}"] = sum(
                    lad.pool_bytes()["reserved"] for lad in ladders)
    finally:
        vectorized.LADDER_CAPACITY = port_capacity
        CompiledLadder._insert = insert
        CompiledLadder.graph_pool = graph_pool
        ladders.clear()
    emit({"phase": "laddermem", "ok": True,
          "order": list(LADDERMEM_CAPACITIES),
          "max_memory_allocated": out, "most_engines_held": held,
          "graph_pool_bytes": pools,
          "growth_bytes": {name: out[f"{name} cap 16"]
                           - out[f"{name} cap 4"]
                           for name in ("envknobs1e6", "chaos1e6")}})


# ---- the compiled round ------------------------------------------------------

#: rounds compared bit for bit per configuration (the first of a rung
#: runs eagerly; the capture follows it, so every later one is a
#: replay), and rounds timed
GRAPH_ROUNDS = 4
GRAPH_TIMED = 20
_ROUND_FIELDS = ("m", "theta", "distance", "accepted", "log_weight", "stats",
                 "valid", "log_proposal")


def _bits_equal(torch, a, b) -> bool:
    """Bit-for-bit equality (NaN payloads included)."""
    if a is None or b is None:
        return a is None and b is None
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a = a.contiguous().view(ints[a.element_size()])
        b = b.contiguous().view(ints[b.element_size()])
    return bool(torch.equal(a, b))


def _round_tensors(out, staged: bool) -> dict:
    rr, pairs = out if staged else (out, ())
    tensors = {k: getattr(rr, k) for k in _ROUND_FIELDS}
    tensors.update({f"pair{i}": p for i, p in enumerate(pairs)})
    return tensors


def _state_tensors(state: dict) -> dict:
    """The loop's buffers without their dump row (every dropped write
    lands there, in no set order) and its counts."""
    out = {f"bufs.{k}": v[:-1] for k, v in state["bufs"].items()}
    out.update({k: state[k] for k in ("count", "npass")
                if state[k] is not None})
    return out


def launches_per_call(torch, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the host's launch API
    calls (kernels, memsets, copies; ``cudaGraphLaunch`` counted apart)
    and the kernels the device ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    launch_api = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                  "cuLaunchKernelEx", "cudaMemsetAsync", "cudaMemcpyAsync")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    api = graph = kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels += 1
        elif e.name in launch_api:
            api += 1
        elif e.name.startswith("cudaGraphLaunch"):
            graph += 1
    return {"host_launches": api + graph, "graph_launches": graph,
            "device_kernels": kernels}


def recorded_round(abc, gens: int) -> dict:
    """Run ``abc`` for ``gens`` generations and keep its last generation
    round's ``(round_fn, params, n, B)`` as the sampler was handed them."""
    samp = abc.sampler
    sample = samp.sample_until_n_accepted
    rec = {}

    def recording(n, round_fn, generator, params, *args, **kw):
        out = sample(n, round_fn, generator, params, *args, **kw)
        if getattr(round_fn, "__name__", "") == "generation_round":
            rec.update(round_fn=round_fn, params=params, n=n,
                       B=samp.last_batch, kernel=round_fn.__self__,
                       rows=list(abc.timeline))
        return out

    samp.sample_until_n_accepted = recording
    try:
        abc.run(max_nr_populations=gens)
    finally:
        del samp.sample_until_n_accepted
    return rec


def graph_against_eager(torch, name: str, raw, B: int, n: int, params,
                        staged: bool, ladder) -> dict:
    """``raw``'s round as a captured program and as the eager one, from
    one generator state: ``GRAPH_ROUNDS`` rounds compared bit for bit
    (each round's outputs, the buffers and the count, the generator's
    state after it), then launches and ms per round each way."""
    from pyabc_tpu_torch.sampler.device_loop import RoundProgram

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20261018)
    gen_e = torch.Generator(device="cuda")
    gen_e.set_state(gen.get_state())
    pool0 = ladder.pool_bytes()["reserved"]
    graph = RoundProgram(raw, B, n, staged=staged, graphs=True,
                         pool=ladder.graph_pool, label=name)
    eager = RoundProgram(raw, B, n, staged=staged, graphs=False, label=name)
    rounds = []
    for _ in range(GRAPH_ROUNDS):
        out_g = _round_tensors(graph.run(gen, params), staged)
        out_e = _round_tensors(eager.run(gen_e, params), staged)
        st_g, st_e = (_state_tensors(graph.state),
                      _state_tensors(eager.state))
        rounds.append({
            "outputs": all(_bits_equal(torch, out_g[k], out_e[k])
                           for k in out_e),
            "buffers": all(_bits_equal(torch, st_g[k], st_e[k])
                           for k in st_e),
            "generator": bool(torch.equal(gen.get_state(),
                                          gen_e.get_state())),
            "count": int(graph.state["count"])})
    checks = {"captured": graph.route == "graph",
              "replayed": graph.replays == GRAPH_ROUNDS - 1,
              "same_bits": all(r["outputs"] and r["buffers"]
                               and r["generator"] for r in rounds)}
    launches = {}
    for arm, prog, g in (("eager", eager, gen_e), ("graph", graph, gen)):
        try:
            launches[arm] = launches_per_call(
                torch, lambda: prog.run(g, params))
        except Exception as exc:  # a measurement: reported, not gated
            launches[arm] = {"not_measured": f"{type(exc).__name__}: {exc}"}
    eager_ms = time_cuda(torch, lambda: eager.run(gen_e, params),
                         reps=GRAPH_TIMED)
    replay_ms = time_cuda(torch, lambda: graph.run(gen, params),
                          reps=GRAPH_TIMED)
    return {"config": name, "B": B, "n_target": n, "staged": staged,
            "ok": all(checks.values()), "checks": checks, "rounds": rounds,
            "launches_per_round": launches, "eager_ms_per_round": eager_ms,
            "replay_ms_per_round": replay_ms,
            "capture_s": graph.capture_s,
            "graph_pool_bytes": ladder.pool_bytes()["reserved"],
            "graph_pool_growth_bytes": ladder.pool_bytes()["reserved"]
            - pool0}


def graph_configs(torch) -> list:
    """``(name, raw round, B, n, params, staged)`` of each configuration
    the graphs phase compares, each from two generations of its own run
    on the card (the run's own rounds replay graphs)."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.convert import to_torch
    from pyabc_tpu_torch.fidelity import FidelityConfig
    from pyabc_tpu_torch.models import make_two_gaussians_problem

    out = []
    for name, pop, pinned in (("config2 pop16384", 16384, None),
                              ("config2 pop1e6", 1_000_000, 1 << 19)):
        models, priors, distance, observed, _ = make_two_gaussians_problem()
        batch = ({} if pinned is None
                 else {"min_batch_size": pinned, "max_batch_size": pinned})
        abc = pt.ABCSMC(
            models, priors, distance, population_size=pop,
            eps=pt.MedianEpsilon(),
            sampler=pt.VectorizedSampler(max_rounds_per_call=16,
                                         device="cuda",
                                         **{"max_batch_size": 1 << 19,
                                            **batch}),
            stores_sum_stats=False, seed=0, ingest_mode="sequential",
            history_mode="eager", device="cuda")
        abc.new("sqlite://", observed)
        out.append((name, abc, False))
    for name in ("lv1e5", "sir1e5"):
        abc, _, _, _ = adaptive_abc(name)
        out.append((f"config4 {name}", abc, False))
    models, priors, distance, observed, _ = fid_problem("sir")
    abc = pt.ABCSMC(
        models, priors, distance, population_size=FID_POP,
        sampler=pt.VectorizedSampler(min_batch_size=FID_BATCH,
                                     max_batch_size=FID_BATCH,
                                     device="cuda"),
        stores_sum_stats=False, eps=pt.QuantileEpsilon(alpha=0.15), seed=0,
        history_mode="eager", device="cuda")
    abc.new("sqlite://", observed)
    out.append(("fidelitysir5e4 staged", abc, True))
    configs = []
    for name, abc, staged in out:
        rec = recorded_round(abc, 2)
        B, n = rec["B"], rec["n"]
        params = to_torch(rec["params"], "cuda")
        if staged:
            cfg = FidelityConfig(full_fraction=0.15, cal_rows=4096)
            # the screen at the generation's ε: some candidates pass it,
            # some do not
            params["fidelity"] = {"tau": params["acceptor"]["eps"].clone()}
            raw = abc.sampler.raw_round(rec["kernel"].staged_generation_round,
                                        B, full_fraction=cfg.full_fraction)
        else:
            raw = abc.sampler.raw_round(rec["round_fn"], B)
        configs.append({"name": name, "raw": raw, "B": B, "n": n,
                        "params": params, "staged": staged,
                        "run_round_graph": graphs_ok(rec["rows"])})
    return configs


def finalize_against_eager(torch, state, ladder) -> dict:
    """The loop's finalize at row (b)'s shape (1e6 queries against the
    8192-cell grid support, d = 1): the captured finalize (K1's launches
    inside the graph) against the same work eager, bit for bit; then K1
    in it against the plain KDE; replay and eager ms, launches, and the
    kernel row of the captured call."""
    from pyabc_tpu_torch.ops import kde as kde_plain
    from pyabc_tpu_torch.ops import kde_cuda
    from pyabc_tpu_torch.sampler.base import RoundResult
    from pyabc_tpu_torch.sampler.device_loop import build_stateful_loop

    dev = torch.device("cuda", 0)
    label, m, n, d, kw = KDE_CASES[1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)
    c = _kde_case(torch, gen, dev, label, m, n, d, **kw)
    params = {"support": c["support"], "log_w": c["log_w"],
              "chol": c["chol"], "log_norm": c["log_norm"]}

    def density(_m, theta, p):
        return kde_cuda.weighted_kde_logpdf_cuda(
            theta, p["support"], p["log_w"], p["chol"], p["log_norm"])

    B = 1 << 19

    def no_round(generator, p):
        z = torch.zeros(B, device=dev)
        return RoundResult(m=torch.zeros(B, dtype=torch.int64, device=dev),
                           theta=z[:, None], distance=z,
                           accepted=torch.zeros(B, dtype=torch.bool,
                                                device=dev),
                           log_weight=z, stats=z[:, None])

    loop = build_stateful_loop(no_round, B, m, 1, weight_correction=density,
                               graphs=True, pool=ladder.graph_pool,
                               label="finalize at row (b)")
    _, _, finalize, _ = loop
    # one round (nothing accepted) allocates the buffers and captures it
    loop.program.run(gen, params)
    st = loop.program.state
    lw = torch.randn(m, generator=gen, device=dev)
    lw[::7] = -math.inf
    st["bufs"]["theta"][:m].copy_(c["x"])
    st["bufs"]["log_weight"][:m].copy_(lw)
    st["count"].fill_(m)
    g0 = kde_cuda.weighted_kde_logpdf_cuda.graph_launches
    got = finalize(st, params)["log_weight"]
    replay_k1 = kde_cuda.weighted_kde_logpdf_cuda.graph_launches - g0

    def eager_finalize():
        return torch.where(torch.isfinite(lw), lw - density(None, c["x"],
                                                            params), lw)

    ref = eager_finalize()
    plain_density = kde_plain.weighted_kde_logpdf(
        c["x"], c["support"], c["log_w"], c["chol"], c["log_norm"])
    plain = torch.where(torch.isfinite(lw), lw - plain_density, lw)
    fin = torch.isfinite(plain)
    err = float((got[fin] - plain[fin]).abs().max())
    launches = {}
    for arm, fn in (("eager", eager_finalize),
                    ("graph", lambda: finalize(st, params))):
        try:
            launches[arm] = launches_per_call(torch, fn)
        except Exception as exc:  # a measurement: reported, not gated
            launches[arm] = {"not_measured": f"{type(exc).__name__}: {exc}"}
    replay_ms = time_cuda(torch, lambda: finalize(st, params),
                          reps=GRAPH_TIMED)
    eager_ms = time_cuda(torch, eager_finalize, reps=GRAPH_TIMED)
    plain_ms = time_cuda(torch, lambda: torch.where(
        torch.isfinite(lw), lw - kde_plain.weighted_kde_logpdf(
            c["x"], c["support"], c["log_w"], c["chol"], c["log_norm"]),
        lw), reps=3, warmup=0)
    lib = library_logsumexp_ms(torch, kde_plain, c)
    checks = {"captured": loop.program.route == "graph",
              "k1_in_graph": replay_k1 == 1,
              "same_bits": _bits_equal(torch, got, ref),
              "infinite_rows_kept": bool(torch.equal(torch.isinf(got),
                                                     torch.isinf(plain))),
              "k1_vs_plain": err <= GRAPH_K1_TOL}
    return {"shape": label, "M": m, "N": n, "d": d,
            "ok": all(checks.values()), "checks": checks,
            "max_abs_err": err, "tolerance": GRAPH_K1_TOL,
            "k1_launches_per_replay": replay_k1,
            "launches": launches, "replay_ms": replay_ms,
            "eager_ms": eager_ms, "plain_ms": plain_ms,
            "library_ms": lib.get("library_ms"),
            "bound_ms": 1e3 * kde_cuda.bound_seconds(m, n, d,
                                                     state["sm_clock_hz"]),
            "capture_s": loop.program.capture_s}


#: K1 inside the captured finalize against the plain KDE (log density)
GRAPH_K1_TOL = 4e-4


def guard_against_eager(torch) -> dict:
    """An ``AotGuard`` captured at one spec and called at another: one
    counted miss, and the eager function's result."""
    from pyabc_tpu_torch.autotune import aot_compile, aval_of, jit_compile
    from pyabc_tpu_torch.telemetry.metrics import REGISTRY

    def fn(x, y):
        return torch.cumsum(x * 2.0 + y, 0)

    x = torch.randn(4096, device="cuda")
    x2 = torch.randn(6144, device="cuda")
    guard = aot_compile(jit_compile(fn), aval_of(x), 1.0)
    misses = REGISTRY.counter("autotune_aot_signature_misses_total")
    before = misses.value
    same = _bits_equal(torch, guard(x, 1.0), fn(x, 1.0))
    drifted = _bits_equal(torch, guard(x2, 1.0).clone(), fn(x2, 1.0))
    checks = {"captured": guard.captured, "replay_equal": same,
              "drift_equal": drifted,
              "one_miss": misses.value - before == 1}
    return {"ok": all(checks.values()), "checks": checks}


def phase_graphs(torch, state):
    """The compiled round: each configuration's round captured and eager
    from one generator state, bit for bit, with launches and ms per round
    each way, capture seconds and the graph pool's bytes; the captured
    finalize with K1 at row (b); the guard on spec drift."""
    from pyabc_tpu_torch.autotune import CompiledLadder

    ladder = CompiledLadder()
    t0 = time.perf_counter()
    rows = []
    for cfg in graph_configs(torch):
        row = graph_against_eager(torch, cfg["name"], cfg["raw"], cfg["B"],
                                  cfg["n"], cfg["params"], cfg["staged"],
                                  ladder)
        row["checks"]["run_round_graph"] = cfg["run_round_graph"]
        row["ok"] = all(row["checks"].values())
        rows.append(row)
        emit({"phase": "graphs", **row})
        del cfg
        torch.cuda.empty_cache()
    final = finalize_against_eager(torch, state, ladder)
    emit({"phase": "graphs", "finalize": final})
    guard = guard_against_eager(torch)
    state["graph_finalize"] = final
    row = {"phase": "graphs",
           "ok": all(r["ok"] for r in rows) and final["ok"] and guard["ok"],
           "configs": {r["config"]: r["ok"] for r in rows},
           "finalize_ok": final["ok"], "guard": guard,
           "graph_pool_bytes": ladder.pool_bytes(),
           "seconds": time.perf_counter() - t0}
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"graphs failed its checks: {row}")


# ---- scale-out and the fleet scheduler --------------------------------------

#: sharded1e6: run_gate's configuration (config #2, pop 1e6, 11
#: generations) through ShardedSampler
SHARDED_POP = 1_000_000
SHARDED_GENS = 11


def phase_sharded1e6(torch, state):
    """Config #2 at pop 1e6 through ``ShardedSampler``: (a) over
    ``make_mesh()``, one rank and one shard, bit-identical to its
    ``VectorizedSampler`` twin of the same seed (the pop1e6 phase's run
    where it ran in this invocation, else run here), and (b) over two
    shards on the one card; all held to ``run_gate``, (b)'s K1 launches
    per generation equal to (a)'s."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.parallel.mesh import make_mesh

    def sharded(mesh):
        return pt.ShardedSampler(mesh=mesh, max_batch_size=1 << 19,
                                 max_rounds_per_call=16)

    runs, hist = {}, {}
    arms = [("one_shard", lambda: sharded(make_mesh())),
            ("two_shards", lambda: sharded(make_mesh(
                [torch.device("cuda")] * 2)))]
    twin = state.pop("pop1e6_run", None)
    if twin is not None and (SHARDED_POP, SHARDED_GENS) == (1_000_000, 11):
        runs["vectorized"], hist["vectorized"] = twin
    else:
        twin = None
        arms.insert(0, ("vectorized", lambda: None))
    n_sharded = {}
    for arm, make in arms:
        kept = {}
        runs[arm] = run_main_path(torch, SHARDED_POP, SHARDED_GENS,
                                  sampler=make(), keep=kept)
        hist[arm] = kept["abc"].history
        n_sharded[arm] = getattr(kept["abc"].sampler, "n_devices", 1)
    per_gen = {arm: [g["kde_launches"] for g in r["generations"]]
               for arm, r in runs.items()}
    diff = population_difference(hist["vectorized"], hist["one_shard"])
    checks = {
        "one_shard_run_gate": runs["one_shard"]["ok"],
        "two_shards_run_gate": runs["two_shards"]["ok"],
        "vectorized_run_gate": runs["vectorized"]["ok"],
        "one_shard_bit_identical": diff is None,
        "k1_per_gen_equal": per_gen["two_shards"] == per_gen["one_shard"],
        "shards": n_sharded == {**({} if twin else {"vectorized": 1}),
                                "one_shard": 1, "two_shards": 2},
    }
    state.setdefault("launches", {})["sharded1e6"] = sum(
        runs[arm]["kde_launches"] for arm, _ in arms)
    row = {"phase": "sharded1e6", "ok": all(checks.values()),
           "checks": checks, "first_difference": diff,
           "vectorized_twin": "pop1e6" if twin else "run here",
           "kde_launches_per_gen": per_gen,
           **{arm: {k: r[k] for k in ("p_model_b", "p_analytic", "tol_p",
                                      "mu_b", "tol_mu", "wall_s",
                                      "gens_run", "kde_launches",
                                      "peak_mem_gb")}
              for arm, r in runs.items()},
           "generations": {arm: r["generations"]
                           for arm, r in runs.items()}}
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"sharded1e6 failed its checks: {checks}")


#: pod1e5: config #2 at pop 1e5 and a constant ε of 0.1, two ranks
#: sharing the one card over gloo, held to run_gate's tolerances.  The
#: one-dispatch engine's round ceiling (64 rounds a generation, the JAX
#: package's) cannot follow MedianEpsilon's halving acceptance through
#: 11 generations in one dispatch (it undershoots and redispatches); at
#: ε = 0.1 the ABC posterior is within 4.2e-4 of the analytic p(B) and
#: 1.1e-5 of its mean (a CPU run of the port at pop 1e5, seed 0)
POD_POP = 100_000
POD_GENS = 11
POD_EPS = 0.1
#: one child's seconds at most (its import, the collective set-up and
#: both arms)
POD_TIMEOUT_S = 300

#: the pod child: run through the worker CLI, one shard per rank; the
#: one-dispatch arm (lazy History), the sequential arm, and the
#: one-dispatch arm again in the warm process (its time without the
#: process's first-run set-up, its populations those of the first)
_POD_CHILD = """
import json, os, sys, time
for name in ("jax", "jaxlib", "pyabc_tpu"):
    sys.modules[name] = None
import numpy as np
import torch
import pyabc_tpu_torch as pt
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda
from pyabc_tpu_torch.parallel.mesh import world
from pyabc_tpu_torch.wire import transfer

out_dir = os.environ["POD_OUT"]
rank, size = world()
report = {"rank": rank, "world": size, "backend":
          torch.distributed.get_backend(), "arms": {}}
for arm in ("onedispatch", "sequential", "onedispatch_warm"):
    models, priors, distance, observed, posterior_fn = \\
        make_two_gaussians_problem()
    engine = ({"run_mode": "onedispatch", "fuse_generations": 4,
               "history_mode": "lazy"} if arm != "sequential" else
              {"ingest_mode": "sequential", "history_mode": "eager"})
    abc = pt.ABCSMC(models, priors, distance,
                    population_size=int(os.environ["POD_POP"]),
                    eps=pt.ConstantEpsilon(float(os.environ["POD_EPS"])),
                    sampler=pt.ShardedSampler(max_batch_size=1 << 19,
                                              max_rounds_per_call=16),
                    stores_sum_stats=False, seed=0, device="cuda",
                    **engine)
    abc.new("sqlite:///" + os.path.join(out_dir,
            f"{arm}_h{rank}.db"), observed)
    c0 = transfer.snapshot()["collective_s"]
    weighted_kde_logpdf_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = abc.run(max_nr_populations=int(os.environ["POD_GENS"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    arrays = {}
    for t in range(h.max_t + 1):
        pop = h.get_population(t)
        for key in ("m", "theta", "distance", "weight"):
            arrays[f"{t}_{key}"] = np.asarray(getattr(pop, key))
    np.savez(os.path.join(out_dir, f"{arm}_h{rank}.npz"), **arrays)
    t = h.max_t
    df, w = h.get_distribution(m=1, t=t)
    report["arms"][arm] = {
        "wall_s": wall,
        "collective_s": transfer.snapshot()["collective_s"] - c0,
        "kde_launches": weighted_kde_logpdf_cuda.launches,
        "dispatches": int(abc.run_dispatches), "max_t": int(t),
        "paths": [r["path"] for r in abc.timeline],
        "gen_wall_s": [r["wall_s"] for r in abc.timeline],
        "kde_support": [r.get("kde_support") for r in abc.timeline],
        "p_model_b": float(h.get_model_probabilities(t).get(1, 0.0)),
        "p_analytic": float(posterior_fn(1.0)),
        "mu_b": float(np.sum(df["mu"].to_numpy() * w)),
        "shards": abc.sampler.n_devices}
with open(os.path.join(out_dir, f"report_h{rank}.json"), "w") as f:
    json.dump(report, f)
"""

#: what NCCL does with two ranks on one card: one all_gather, then stop
_NCCL_PROBE = """
import os, sys
import torch, torch.distributed as dist
rank = int(sys.argv[1])
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method="tcp://" + sys.argv[2],
                        world_size=2, rank=rank)
x = torch.full((4,), float(rank), device="cuda")
out = [torch.empty_like(x) for _ in range(2)]
dist.all_gather(out, x)
torch.cuda.synchronize()
print("gathered", [float(o[0]) for o in out], flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _nccl_two_ranks_one_card(root) -> dict:
    """Two NCCL ranks on the one card: the outcome, recorded (the pod
    runs on gloo; NCCL's duplicate-GPU check is expected to refuse)."""
    import subprocess as sp
    port = _free_port()
    procs = [sp.Popen([sys.executable, "-c", _NCCL_PROBE, str(i),
                       f"127.0.0.1:{port}"], cwd=root, stdout=sp.PIPE,
                      stderr=sp.PIPE, text=True) for i in range(2)]
    out = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=90)
        except sp.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
        # NCCL names the cause on the line after "Last error:"
        lines = [ln.strip() for ln in se.splitlines() if ln.strip()]
        said = [ln for ln in lines if "Duplicate GPU" in ln
                or "ncclInvalidUsage" in ln or "Error:" in ln]
        out.append({"rc": p.returncode, "stdout": so.strip()[-200:],
                    "error": [ln[-300:] for ln in said[-3:]]
                    or lines[-3:]})
    return {"ranks": out,
            "refused": any(o["rc"] != 0 for o in out)}


def _load_pops(path) -> dict:
    import numpy as np
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _history_arrays(h) -> dict:
    import numpy as np
    out = {}
    for t in range(h.max_t + 1):
        pop = h.get_population(t)
        for key in ("m", "theta", "distance", "weight"):
            out[f"{t}_{key}"] = np.asarray(getattr(pop, key))
    return out


def _same_arrays(a: dict, b: dict) -> bool:
    import numpy as np
    return set(a) == set(b) and all(
        np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)


def _pod_twin(torch, arm: str, det: bool, db: str, gens: int = POD_GENS,
              prof=None) -> tuple:
    """``(abc, posterior_fn, wall_s)`` of ``pod1e5``'s one-process twin:
    the arm's engine over two shards on the card, its History in the
    file ``db``, inside ``deterministic_kernels`` when ``det`` and under
    the profiler context ``prof`` when given."""
    import contextlib

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import make_two_gaussians_problem
    from pyabc_tpu_torch.parallel.mesh import (deterministic_kernels,
                                               make_mesh)

    models, priors, distance, observed, posterior_fn = \
        make_two_gaussians_problem()
    engine = ({"run_mode": "onedispatch", "fuse_generations": 4,
               "history_mode": "lazy"} if arm == "onedispatch" else
              {"ingest_mode": "sequential", "history_mode": "eager"})
    abc = pt.ABCSMC(
        models, priors, distance, population_size=POD_POP,
        eps=pt.ConstantEpsilon(POD_EPS),
        sampler=pt.ShardedSampler(
            mesh=make_mesh([torch.device("cuda")] * 2),
            max_batch_size=1 << 19, max_rounds_per_call=16),
        stores_sum_stats=False, seed=0, device="cuda", **engine)
    abc.new("sqlite:///" + db, observed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if det:
            stack.enter_context(deterministic_kernels())
        if prof is not None:
            stack.enter_context(prof)
        abc.run(max_nr_populations=gens)
        torch.cuda.synchronize()
    return abc, posterior_fn, time.perf_counter() - t0


#: detprof: generations of the profiled pod1e5 twin
DETPROF_GENS = 4


def phase_detprof(torch, state):
    """Where the deterministic kernels' time goes: ``pod1e5``'s
    one-dispatch twin for ``DETPROF_GENS`` generations under
    ``torch.profiler``, with and without ``deterministic_kernels`` (each
    after an unprofiled warm run): wall, device busy time, and the top
    operators by host time and kernels by device time."""
    import os
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    work = tempfile.mkdtemp(prefix="detprof_")

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))

    out = {}
    for det in (True, False):
        key = "deterministic" if det else "default"
        _pod_twin(torch, "onedispatch", det,
                  os.path.join(work, f"{key}_warm.db"), DETPROF_GENS)
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        _, _, wall = _pod_twin(torch, "onedispatch", det,
                               os.path.join(work, f"{key}.db"),
                               DETPROF_GENS, prof=prof)
        events = prof.key_averages()
        kernels = [e for e in events
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
        ops = [e for e in events if e.device_type == DeviceType.CPU]
        out[key] = {
            "wall_s": wall,
            "device_busy_s": sum(dev_us(e) for e in kernels) * 1e-6,
            "device_launches": sum(e.count for e in kernels),
            "top_device": [{"name": e.key[:80], "calls": e.count,
                            "device_s": dev_us(e) * 1e-6} for e in sorted(
                                kernels, key=dev_us, reverse=True)[:10]],
            "top_host": [{"name": e.key[:80], "calls": e.count,
                          "self_host_s": e.self_cpu_time_total * 1e-6,
                          "host_s": e.cpu_time_total * 1e-6}
                         for e in sorted(ops, key=lambda e:
                                         e.self_cpu_time_total,
                                         reverse=True)[:12]]}
    emit({"phase": "detprof", "ok": True, "gens": DETPROF_GENS, **out})


def phase_pod1e5(torch, state):
    """Two ranks on the one card through ``python -m
    pyabc_tpu_torch.parallel.cli`` (gloo, one shard each): config #2 at
    pop 1e5 (``POD_EPS``) in the pod posture (one dispatch, lazy History)
    and as a sequential arm, against a one-process two-shard twin of
    each arm (with the deterministic kernels, and timed again without
    them)."""
    import os
    import subprocess as sp
    import tempfile

    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda
    from pyabc_tpu_torch.parallel import cli, health

    root = Path(__file__).resolve().parent
    work = tempfile.mkdtemp(prefix="pod1e5_")
    run_dir = os.path.join(work, "run")
    script = os.path.join(work, "pod_child.py")
    with open(script, "w") as f:
        f.write(_POD_CHILD)
    nccl = _nccl_two_ranks_one_card(root)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(root), POD_OUT=work,
               POD_POP=str(POD_POP), POD_GENS=str(POD_GENS),
               POD_EPS=str(POD_EPS))
    for k in ("PYABC_TPU_FAULTS", "PYABC_TPU_STORE_GENS",
              health.RUN_DIR_ENV):
        env.pop(k, None)
    t0 = time.perf_counter()
    procs = [sp.Popen([sys.executable, "-m", "pyabc_tpu_torch.parallel.cli",
                       "--coordinator", f"127.0.0.1:{port}",
                       "--num-processes", "2", "--process-id", str(i),
                       "--run-dir", run_dir, script],
                      cwd=str(root), env=env, stdout=sp.PIPE,
                      stderr=sp.PIPE, text=True) for i in range(2)]
    # while both run: both heartbeats in the run dir, and `info` on them
    live, info_text = 0, ""
    while any(p.poll() is None for p in procs):
        if time.perf_counter() - t0 > POD_TIMEOUT_S:
            break
        status = health.worker_status(run_dir)
        if len(status) >= 2 and all(e["alive"] for e in status) and not live:
            live = len(status)
            info_text = cli.info(run_dir)
        time.sleep(0.2)
    errs = []
    for p in procs:
        try:
            _, se = p.communicate(timeout=max(
                POD_TIMEOUT_S - (time.perf_counter() - t0), 1))
        except sp.TimeoutExpired:
            p.kill()
            _, se = p.communicate()
        errs.append(se[-3000:])
    rcs = [p.returncode for p in procs]
    if any(rcs):
        raise RuntimeError(f"pod1e5 ranks exited {rcs}: {errs}")
    reports = []
    for i in range(2):
        with open(os.path.join(work, f"report_h{i}.json")) as f:
            reports.append(json.load(f))

    # the one-process twins: two shards on the card, the same engines,
    # with the kernels a multi-rank run takes ("deterministic", held to
    # the ranks' bits), then timed again with the default kernels: what
    # the deterministic forms cost
    twins = {}
    twin_launches = 0

    def twin(arm, det):
        return _pod_twin(torch, arm, det, os.path.join(
            work, f"{arm}_twin_{'det' if det else 'default'}.db"))

    for arm in ("onedispatch", "sequential"):
        weighted_kde_logpdf_cuda.launches = 0
        abc, posterior_fn, det_s = twin(arm, True)
        twin_launches += weighted_kde_logpdf_cuda.launches
        twins[arm] = {"arrays": _history_arrays(abc.history),
                      "max_t": int(abc.history.max_t),
                      "stop": abc.timeline.stop_reason,
                      "gate": _gate_run_gate(abc, posterior_fn, POD_POP),
                      "wall_s": {"deterministic": det_s}}
        del abc
        weighted_kde_logpdf_cuda.launches = 0
        twins[arm]["wall_s"]["default"] = twin(arm, False)[2]
        twin_launches += weighted_kde_logpdf_cuda.launches
    checks = {"heartbeats_live": live == 2,
              "info_lists_both": info_text.startswith(
                  "Workers=2 Alive=2"),
              "heartbeats_removed": health.worker_status(run_dir) == [],
              "gloo": all(r["backend"] == "gloo" for r in reports)}
    arms = {}
    for arm in ("onedispatch", "sequential"):
        per = [r["arms"][arm] for r in reports]
        pops = [_load_pops(os.path.join(work, f"{arm}_h{i}.npz"))
                for i in range(2)]
        tol_p = max(2.5e-3, 2.5 / POD_POP ** 0.5)
        tol_mu = max(3e-3, 3.0 / POD_POP ** 0.5)
        gate = [abs(a["p_model_b"] - a["p_analytic"]) < tol_p
                and abs(a["mu_b"] - 1.0) < tol_mu for a in per]
        checks[f"{arm}_ranks_bit_identical"] = (
            _same_arrays(pops[0], pops[1])
            and per[0]["p_model_b"] == per[1]["p_model_b"])
        checks[f"{arm}_twin_bit_identical"] = _same_arrays(
            pops[0], twins[arm]["arrays"])
        checks[f"{arm}_run_gate"] = all(gate) and twins[arm]["gate"]["ok"]
        checks[f"{arm}_depth"] = (per[0]["max_t"] == per[1]["max_t"]
                                  == twins[arm]["max_t"] == POD_GENS - 1)
        if arm == "onedispatch":
            checks["one_dispatch_per_rank"] = all(
                a["dispatches"] == 1 and a["paths"][1:]
                == ["onedispatch"] * a["max_t"] for a in per)
            warm = [r["arms"]["onedispatch_warm"] for r in reports]
            checks["onedispatch_warm_bit_identical"] = all(
                _same_arrays(pops[0], _load_pops(os.path.join(
                    work, f"onedispatch_warm_h{i}.npz"))) for i in range(2))
        arms[arm] = {
            "wall_s": [a["wall_s"] for a in per],
            "gen_wall_s": [a["gen_wall_s"] for a in per],
            "twin_wall_s": twins[arm]["wall_s"],
            **({"warm_wall_s": [a["wall_s"] for a in warm],
                "warm_gen_wall_s": [a["gen_wall_s"] for a in warm]}
               if arm == "onedispatch" else {}),
            "collective_s": [a["collective_s"] for a in per],
            "kde_launches": [a["kde_launches"] for a in per],
            "p_model_b": per[0]["p_model_b"], "mu_b": per[0]["mu_b"],
            "p_analytic": per[0]["p_analytic"], "tol_p": tol_p,
            "tol_mu": tol_mu, "paths": per[0]["paths"],
            "dispatches": [a["dispatches"] for a in per],
            "twin_gate": twins[arm]["gate"]}
    od = reports[0]["arms"]["onedispatch"]
    sup = [s for s in od["kde_support"] if s]
    if sup:
        state["pod_finalize_shape"] = (POD_POP, max(
            x["rows"] for x in sup[-1]), any(x["compressed"]
                                             for x in sup[-1]))
    launches = sum(a["kde_launches"] for r in reports
                   for a in r["arms"].values()) + twin_launches
    state.setdefault("launches", {})["pod1e5"] = launches
    state["pod_launches"] = launches
    row = {"phase": "pod1e5", "ok": all(checks.values()), "checks": checks,
           "pop": POD_POP, "gens": POD_GENS, "arms": arms,
           "info": info_text.splitlines(), "nccl_two_ranks_one_card": nccl,
           "kde_launches": launches,
           "wall_s": time.perf_counter() - t0}
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"pod1e5 failed its checks: {checks}")


def pod_cases(state) -> list:
    """Row (z): a pod1e5 finalize, the pop-1e5 population against its
    grid-compressed support (d = 1), from the run or its stated default
    (the 2^14-cell grid)."""
    m, n, grid = state.get("pod_finalize_shape", (POD_POP, 1 << 14, True))
    source = "run" if "pod_finalize_shape" in state else "default"
    return [(f"z pod1e5 finalize ({source})", m, n, 1,
             {"grid": grid, "main_launches": state.get("pod_launches")})]


#: sched1e4: the fleet scheduler over platform-managed serve workers
SCHED_STUDIES = 48
SCHED_CLIENTS = 4
SCHED_DURABLE_POP = 10_000
SCHED_DURABLE_GENS = 10
SCHED_MAX_BOUNCES = 3
#: a dead worker's heartbeat is stale after this (it beats every 5 s)
SCHED_STALE_S = 8.0
SCHED_TICK_S = 0.25
SCHED_TIMEOUT_S = 420

#: the durable and the poison study's models, importable by the workers
_SCHED_MODELS = '''
import os
import signal
import time

import torch


def slow_model(generator, theta):
    """The serve family's model, y = mu + 0.1 N(0, 1), at 0.2 s a call:
    a durable study that is still running when its worker is killed."""
    time.sleep(0.2)
    noise = 0.1 * torch.randn(theta.shape[0], 1, generator=generator,
                              device=theta.device)
    return {"y": theta[:, :1] + noise}


def poison_model(generator, theta):
    """A model that takes its worker down (a Python exception would be
    failed by the worker itself and never reach the scheduler)."""
    os.kill(os.getpid(), signal.SIGKILL)
'''


#: the phase's serve worker: the port's ``ServeWorker`` with classic
#: solo engines, which append (and journal) a durable study block by
#: block, so the kill below lands between its blocks (the default
#: one-dispatch engine drains its generations when the dispatch returns)
_SCHED_WORKER = """
import argparse
from pyabc_tpu_torch.serve import ServeWorker, StudyQueue
ap = argparse.ArgumentParser()
ap.add_argument("--serve-dir")
ap.add_argument("--poll-s", type=float)
args = ap.parse_args()
worker = ServeWorker(root=args.serve_dir, run_mode="classic")
worker.install_signal_handlers()
worker.run_forever(StudyQueue(root=worker.root), poll_s=args.poll_s)
"""


def phase_sched1e4(torch, state):
    """The fleet scheduler with a subprocess platform over serve workers
    on the card (autoscaler 1 to 2), the port's load generator driving
    48 pop-100 studies of serve1e4's family from 4 clients, one durable
    pop-1e4 study whose worker is killed (-9) after its second journaled
    generation, and one poison study."""
    import os
    import signal
    import sqlite3
    import subprocess as sp
    import tempfile
    import threading

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.sched import Autoscaler, Scheduler
    from pyabc_tpu_torch.sched.platform import SubprocessPlatform, _Managed
    from pyabc_tpu_torch.serve import StudyQueue, StudySpec, study_digest
    from pyabc_tpu_torch.serve.cache import SharedResultStore
    from pyabc_tpu_torch.telemetry import aggregate
    from pyabc_tpu_torch.telemetry.metrics import REGISTRY
    from pyabc_tpu_torch.tools import loadgen

    root = Path(__file__).resolve().parent
    work = tempfile.mkdtemp(prefix="sched1e4_")
    serve, run_dir = os.path.join(work, "serve"), os.path.join(work, "run")
    os.makedirs(run_dir)
    with open(os.path.join(work, "sched_models.py"), "w") as f:
        f.write(_SCHED_MODELS)
    worker_py = os.path.join(work, "sched_worker.py")
    with open(worker_py, "w") as f:
        f.write(_SCHED_WORKER)
    sys.path.insert(0, work)
    import sched_models

    logs = []

    class Platform(SubprocessPlatform):
        """The subprocess platform, each worker's output in a file (the
        smoke's own output stays its lines)."""

        def _spawn(self):
            log = open(os.path.join(work, f"worker{len(logs)}.log"), "w")
            m = _Managed(sp.Popen(self.argv, env=self.env, stdout=log,
                                  stderr=sp.STDOUT))
            logs.append((m.proc, log))
            self._procs.append(m)
            REGISTRY.counter("sched_platform_starts_total",
                             "worker processes started by the "
                             "platform").inc()
            return m

    env = {"PYTHONPATH": os.pathsep.join([str(root), work]),
           "PYABC_TPU_RUN_DIR": run_dir, "PYABC_TPU_SERVE_DIR": serve,
           "PYABC_TPU_SERVE_DURABLE": "1", "PYABC_TPU_STORE_GENS": "1",
           "PYABC_TPU_SERVE_CB": "0", "PYABC_TPU_SERVE_TRACE": "1"}
    platform = Platform(serve_dir=serve, env=env, backoff_s=0.5,
                        argv=[sys.executable, worker_py, "--serve-dir",
                              serve, "--poll-s", "0.05"])
    for k in ("PYABC_TPU_FAULTS", "PYABC_TPU_SERVE_MULTIPLEX"):
        platform.env.pop(k, None)
    queue = StudyQueue(root=serve)
    sched = Scheduler(run_dir=run_dir, queue=queue,
                      max_bounces=SCHED_MAX_BOUNCES,
                      stale_after_s=SCHED_STALE_S,
                      autoscaler=Autoscaler(min_replicas=1, max_replicas=2,
                                            studies_per_worker=2),
                      platform=platform)
    reports, stop = [], threading.Event()

    def ticking():
        while not stop.is_set():
            rep = sched.tick()
            rep["unix"] = time.time()
            reports.append(rep)
            stop.wait(SCHED_TICK_S)

    def spec(pop, seed, model, gens, y=0.4, tenant="t_small"):
        return StudySpec(model=model, prior=pt.Distribution(
            mu=pt.RV("uniform", -1.0, 2.0)), observed={"y": float(y)},
            population_size=pop, seed=seed, tenant=tenant,
            max_generations=gens)

    studies = [spec(100, s, loadgen._model, SERVE_GENS,
                    y=(0.2, 0.3, 0.4, 0.5)[s % 4]) for s in range(
                        SCHED_STUDIES)]
    durable = spec(SCHED_DURABLE_POP, 7, sched_models.slow_model,
                   SCHED_DURABLE_GENS, tenant="t_large")
    poison = spec(100, 99, sched_models.poison_model, SERVE_GENS,
                  tenant="t_poison")
    t0 = time.perf_counter()
    ticker = threading.Thread(target=ticking, daemon=True)
    ticker.start()
    result = {}
    kill = {}
    try:
        d_ticket = queue.submit(durable)
        gen = loadgen.ClosedLoopLoadGen(queue, studies,
                                        n_studies=SCHED_STUDIES,
                                        clients=SCHED_CLIENTS, seed=0,
                                        poll_s=0.02, study_timeout_s=300.0,
                                        unique=True)
        lg = threading.Thread(target=lambda: result.update(gen.run()),
                              daemon=True)
        lg.start()
        # kill -9 the worker serving the durable study once its database
        # holds three generations: generation 1 is then in the journal
        db = os.path.join(serve, "studies",
                          f"{study_digest(durable)}.solo.db")
        deadline = time.perf_counter() + SCHED_TIMEOUT_S
        claimed = os.path.join(queue.root, "claimed")
        d_done = os.path.join(queue.root, "done", f"{d_ticket.id}.json")
        while (not kill and time.perf_counter() < deadline
               and not os.path.exists(d_done)):
            rows = 0
            if os.path.exists(db):
                try:
                    with sqlite3.connect(db, timeout=1.0) as conn:
                        rows = conn.execute(
                            "SELECT COUNT(*) FROM populations "
                            "WHERE t >= 0").fetchone()[0]
                except sqlite3.Error:
                    rows = 0
            holder = [w for w in os.listdir(claimed) if os.path.exists(
                os.path.join(claimed, w, f"{d_ticket.id}.json"))]
            if rows >= 3 and holder:
                pid = int(holder[0].rsplit("_", 1)[1])
                os.kill(pid, signal.SIGKILL)
                kill = {"unix": time.time(), "pid": pid, "rows": rows,
                        "worker": holder[0]}
            time.sleep(0.05)
        lg.join(timeout=max(deadline - time.perf_counter(), 1))
        while time.perf_counter() < deadline and not os.path.exists(d_done):
            time.sleep(0.2)
        load_wall = time.perf_counter() - t0
        # the poison study last, alone in the queue
        p_ticket = queue.submit(poison)
        while (time.perf_counter() < deadline
               and not os.path.exists(os.path.join(
                   queue.root, "failed", f"{p_ticket.id}.json"))):
            time.sleep(0.2)
        # the idle fleet scales back to one worker
        while (time.perf_counter() < deadline
               and not (reports and reports[-1].get("platform", {}).get(
                   "running") == 1 and platform.replicas() == 1)):
            time.sleep(0.2)
    finally:
        stop.set()
        ticker.join(timeout=30)
        platform.shutdown(timeout_s=60.0)
        for _p, log in logs:
            log.close()
        sys.path.remove(work)
    wall = time.perf_counter() - t0

    # what the queue, the shared cache and the workers' snapshots say
    store = SharedResultStore(os.path.join(serve, "cache", "shared"))

    def tomb(state_dir, ticket):
        path = os.path.join(queue.root, state_dir, f"{ticket.id}.json")
        if not os.path.exists(path):
            return None
        with open(path, encoding="utf-8") as f:
            return json.load(f)

    stats = queue.stats()
    means = {}
    for s in studies:
        summary = store.get(f"{study_digest(s)}.multiplex")
        means[s.seed] = (None if summary is None
                         else summary["posterior_mean"]["mu"])
    d_tomb = tomb("done", d_ticket)
    d_summary = store.get(f"{study_digest(durable)}.solo") or {}
    p_tomb = tomb("failed", p_ticket) or {}
    # every worker's last snapshot, the killed ones' included: a worker
    # bumps both lane counters at the end of a batch and publishes from
    # the same thread, so any snapshot it wrote holds a matching pair
    pids = {p.pid for p, _ in logs}
    snaps = [s for s in aggregate.read_snapshots(run_dir)
             if s.get("pid") in pids]
    lane_k1 = sum(int((s.get("metrics") or {}).get(
        "serve_lane_kde_launches_total", 0)) for s in snaps)
    lane_gens = sum(int((s.get("metrics") or {}).get(
        "serve_lane_generations_total", 0)) for s in snaps)
    requeue_unix = next((r["unix"] for r in reports
                         if d_ticket.id in r["requeued"]), None)
    running = [r["platform"]["running"] for r in reports
               if r.get("platform")]
    crashes = sum(r["platform"]["crashed"] for r in reports
                  if r.get("platform"))
    checks = {
        "no_study_lost": (stats["done"] == SCHED_STUDIES + 1
                          and stats["failed"] == 1
                          and stats["pending"] == stats["claimed"] == 0
                          and result.get("completed") == SCHED_STUDIES),
        "killed_mid_study": bool(kill),
        "durable_resumed": (d_summary.get("resumed_from_gen", 0) >= 1
                            and d_summary.get("gens", 0)
                            >= SCHED_DURABLE_GENS),
        "durable_breadcrumbs": bool(
            d_tomb and d_tomb.get("last_worker") == kill.get("worker")
            and d_tomb.get("bounce_history")),
        "poison_quarantined": bool(
            p_tomb.get("quarantined") and p_tomb.get("flight_path")
            and os.path.exists(p_tomb["flight_path"])
            and len(p_tomb.get("bounce_history", []))
            < SCHED_MAX_BOUNCES),
        "scaled_up_and_down": (max(running, default=0) == 2
                               and running[-1:] == [1]),
        "posterior": all(m is not None and abs(m - s.observed["y"])
                         < SERVE_MEAN_TOL for s, m in zip(
                             studies, means.values())),
        "k1_once_per_lane_generation": lane_k1 == lane_gens > 0,
    }
    state.setdefault("launches", {})["sched1e4"] = lane_k1
    row = {"phase": "sched1e4", "ok": all(checks.values()),
           "checks": checks, "studies_per_s": result.get("studies_per_s"),
           "p50_ms": result.get("p50_ms"), "p99_ms": result.get("p99_ms"),
           "loadgen": result, "load_wall_s": load_wall, "wall_s": wall,
           "reschedule_s": (None if requeue_unix is None
                            else requeue_unix - kill.get("unix", 0.0)),
           "kill": kill, "durable": {k: d_summary.get(k) for k in (
               "resumed_from_gen", "gens", "posterior_mean")},
           "poison_bounces": len(p_tomb.get("bounce_history", [])),
           "platform_crashes": crashes, "replicas_max": max(
               running, default=0), "ticks": len(reports),
           "lane_kde_launches": lane_k1, "lane_generations": lane_gens,
           "workers": [{"pid": p.pid, "rc": p.returncode} for p, _ in logs],
           "queue": stats}
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"sched1e4 failed its checks: {checks}")


def graph_replay_launches() -> int:
    """K1 launches made by replays of captured graphs in this process
    (0 before the package is imported)."""
    mod = sys.modules.get("pyabc_tpu_torch.ops.kde_cuda")
    return 0 if mod is None else mod.weighted_kde_logpdf_cuda.graph_launches


def kernels_line(state) -> dict:
    """The per-kernel summary: times at the pop-16384 finalize shape
    (``ms`` is the whole wrapper call, ``kernel_only_ms`` the launches
    alone), the same numbers at every compared shape, the largest error
    over all of them, launches on the main path."""
    rows = state.get("kernel_rows", [])
    main = rows[0] if rows else {}
    launches = state.get("launches", {})
    keys = ("kernel_only_ms", "call_ms", "plain_ms", "library_ms",
            "library_chunks", "bound_ms", "bound_share", "max_abs_err",
            "partial_kernel", "launches")
    final = state.get("graph_finalize", {})
    replays = state.get("graph_launches", {})
    captured = {
        "name": "kde_logpdf (captured finalize)", "route": "cuda",
        "source": "pyabc_tpu_torch/csrc/kde_logpdf.cu",
        "replaces": "pyabc_tpu/ops/kde_pallas.py:77",
        # K1 launched by replays of captured finalizes on the main path
        "launches": sum(replays.values()),
        "launches_by_phase": replays,
        "max_abs_err": final.get("max_abs_err"),
        "ms": final.get("replay_ms"), "eager_ms": final.get("eager_ms"),
        "plain_ms": final.get("plain_ms"),
        "bound_ms": final.get("bound_ms"), "bound_by": "operations",
        "library_ms": final.get("library_ms"), "shape": final.get("shape")}
    return {"kernels": [{
        "name": "kde_logpdf", "route": "cuda",
        "source": "pyabc_tpu_torch/csrc/kde_logpdf.cu",
        "replaces": "pyabc_tpu/ops/kde_pallas.py:77",
        "launches": sum(launches.values()),
        "launches_by_phase": launches,
        "max_abs_err": max((r["max_abs_err"] for r in rows), default=None),
        "ms": main.get("call_ms"),
        "kernel_only_ms": main.get("kernel_only_ms"),
        "plain_ms": main.get("plain_ms"),
        "bound_ms": main.get("bound_ms"), "bound_by": "operations",
        "library_ms": main.get("library_ms"),
        "shape": main.get("shape"),
        "by_shape": [{"shape": r["shape"], **{k: r.get(k) for k in keys}}
                     for r in rows]}, captured]}


PHASES = {"card": phase_card, "build": phase_build, "graphs": phase_graphs,
          "kernels": phase_kernels, "pop16384": phase_pop16384,
          "pop1e6": phase_pop1e6, "lv1e5": phase_lv1e5,
          "sir1e5": phase_sir1e5, "petab1e5": phase_petab1e5,
          "sbml1e5": phase_sbml1e5, "fused16384": phase_fused16384,
          "fused1e6": phase_fused1e6, "fusedlv1e5": phase_fusedlv1e5,
          "fusedpetab1e5": phase_fusedpetab1e5,
          "onedispatch1e6": phase_onedispatch1e6,
          "lanes1e6": phase_lanes1e6,
          "onedispatchpetab1e5": phase_onedispatchpetab1e5,
          "pipelined1e6": phase_pipelined1e6,
          "pipelinedsir1e6": phase_pipelinedsir1e6,
          "library": phase_library, "stats1e5": phase_stats1e5,
          "adaptivepop": phase_adaptivepop, "local1e4": phase_local1e4,
          "fidelitysir5e4": phase_fidelitysir5e4,
          "fidelitylv5e4": phase_fidelitylv5e4,
          "capacity1e7": phase_capacity1e7, "capacity1e8": phase_capacity1e8,
          "capacityspread": phase_capacityspread,
          "telemetry1e6": phase_telemetry1e6, "chaos1e6": phase_chaos1e6,
          "recover1e6": phase_recover1e6, "cudafaults": phase_cudafaults,
          "quickstart1e4": phase_quickstart1e4,
          "envknobs1e6": phase_envknobs1e6,
          "refexport1e5": phase_refexport1e5,
          "hostsamplers": phase_hostsamplers,
          "aggregatedlv1e5": phase_aggregatedlv1e5,
          "analysis1e6": phase_analysis1e6,
          "serve1e4": phase_serve1e4, "servecb": phase_servecb,
          "sharded1e6": phase_sharded1e6, "pod1e5": phase_pod1e5,
          "sched1e4": phase_sched1e4,
          "laddermem": phase_laddermem, "serveprof": phase_serveprof,
          "detprof": phase_detprof,
          "hostprof": phase_hostprof,
          "profile": phase_profile, "repeat": phase_repeat,
          "simprof": phase_simprof, "k1perm": phase_k1perm}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of "
                    + ",".join(ALL_PHASES + EXTRA_PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = [p for p in phases if p not in PHASES]
    if unknown:
        print(f"unknown phases {unknown}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "pyabc_tpu_torch").is_dir():
        print("chip_smoke: pyabc_tpu_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    state = {}
    if "card" not in phases:
        phases.insert(0, "card")
    for name in phases:
        t0 = time.perf_counter()
        counts = resilience_counts()
        replays0 = graph_replay_launches()
        try:
            PHASES[name](torch, state)
            if name not in ("card", "build", "graphs", "kernels"):
                state.setdefault("graph_launches", {})[name] = (
                    graph_replay_launches() - replays0)
            if name not in FAULT_PHASES:
                # no fault plan: no retry, no degradation, no fallback
                # latch (every latch counts a degradation) carried it
                moved = {k: v - counts[k]
                         for k, v in resilience_counts().items()
                         if v != counts[k]}
                if moved:
                    raise RuntimeError(
                        f"phase {name} retried or degraded: {moved}")
        except Exception as exc:  # report the phase, then fail the run
            emit({"phase": name, "ok": False,
                  "error": f"{type(exc).__name__}: {exc}",
                  "seconds": time.perf_counter() - t0})
            raise
    if "kernels" in phases:
        line = kernels_line(state)
        if state.get("graph_launches") and not line["kernels"][1]["launches"]:
            raise RuntimeError("no captured finalize launched K1 on the "
                               "main path")
        emit(line)
    print(state["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
