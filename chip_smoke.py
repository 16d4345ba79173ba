"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Drives the port's fit paths through the entry points a user calls
(``get_model``, ``make_test_pulsar``, ``GLSFitter.fit_toas``, and the
default ``auto_fitter(toas, model).fit_toas()``) on two pulsars at 1e5
TOAs:

- bench.py's pulsar (spindown, equatorial astrometry, solar-system
  Shapiro, DM, EFAC/EQUAD, 30-harmonic power-law red noise; 6 design
  columns);
- the binary MSP of ``pint_tpu_torch.simulation.msp_par`` (ecliptic
  astrometry with PM and PX, F0/F1, 150 DMX ranges, FD1/FD2, a JUMP, an
  ELL1 orbit with Shapiro, EFAC/EQUAD on two receivers, 30-harmonic red
  noise; 168 design columns with the offset, so the joint Gram is
  q = 60 + 169 = 229 columns wide).

On each, GLSFitter's default (``fused='auto'``) takes the mixed step, whose
joint Gram is the hand-written CUDA kernel ``csrc/fused_gram_joint.cu``
(its wide path ``csrc/fused_gram_wide.cu`` for q > 80, the MSP's), and
the streaming-basis fit (``fused=True``) the fourier step, whose basis
Grams are ``csrc/fourier_gram.cu``.  ``csrc/fourier_apply.cu`` is on no
fit path (as in the reference); it is built, held to its plain version
and timed.

Phases, each of which raises on failure (exit code != 0):

1. build every CUDA library from the sources (one nvcc each, started
   together) and print each ptxas report;
2. bench.py's pulsar: each fit path with every launch count at 0 just
   before it and read just after: a 4-iteration fit must be finite, be
   served by its native rung of the fallback ladder, and launch its
   kernel once per step and the other path's kernel never;
3. correctness: the mixed and the fourier step against the f64 step from
   the same x at 1e5 TOAs, at the reference's step gates (dx 2e-3 of the
   largest component, chi2 1e-3 relative, normalized covariance 5e-3;
   the fourier step's uncertainty gap and worst dx gap in sigma are
   printed, not gated); on a 2048-TOA pulsar the card's residuals, f64
   step and fourier step against the port on the CPU;
4. each kernel against its plain PyTorch version on the card, at the
   paths' shapes, at an odd shape and at k = 64 with p = 16 (and m = 16):
   3e-6 of scale, bitwise on rerun; ``fused_gram_joint`` also with T in
   f32, at k = 1 with one and two chunks, and at a ragged n whose last
   spans are not whole 16-byte units (T in f64 and f32); and the
   generated basis bit for bit: ``fourier_apply`` with z each block of at
   most 16 identity columns equals ``basis32``'s columns, at the bench
   shape and the odd shapes (the basis generator ``csrc/fourier_basis.cuh``
   is shared, so this holds ``fourier_gram``'s basis too);
5. timings: CUDA events (median of 20 windows of 20 back-to-back calls,
   after warm-up) and torch.profiler device time of each kernel, of its
   plain version and of its one-call library yardstick (for
   ``fourier_apply`` and its yardstick also CUDA events over 20 calls
   replayed from a CUDA graph); each kernel's bound from this run's
   inputs; the two Gram kernels' passes; host-clock times of one mixed,
   one f64 and one fourier step, and one mixed and one fourier step under
   torch.profiler (kernel count, busy share, top operators);
6. the binary MSP (simulated with the orbit inside its phases, so its
   fits start at the truth): both fits as in 2, printing each fit's rung,
   launches (the mixed fit's all on the wide path), host time and
   ``torch.cuda.max_memory_allocated``; the mixed and the fourier step
   from the par values at the step gates of the f64 step; the card
   against the CPU on a 2048-TOA copy with 12 DMX ranges, simulated as
   bench.py's pulsar is (1e-11 s, 1e-8), and on a copy simulated as the
   1e5-TOA MSP is (orbit inside the phases), where the f64 steps' gap in
   units of each parameter's sigma is gated against the CPU's own spread
   measured in the same run (``sigma_gap``: past the residuals within 10x
   the spread under reordered TOAs, the whole gap within the spread under
   one-ulp shifts of the residuals); every kernel against its plain
   version at the wide shapes (``fused_gram_joint`` at q = 229 and 228
   with T in f64 and f32, at the reference's widest k = 128 with
   p1 = 512, and at a ragged n with q = 231, T in f64 and f32;
   ``fourier_gram`` at k = 30 and 100 with p = 169, and each of three
   slices of 16 or 9 columns of X alone, bitwise equal to the same columns
   of the one launch; ``fourier_apply`` at k = 100 with m = 40 and the
   basis bit for bit at k = 100); the wide shapes timed as in 5, and
   ``fused_gram_joint`` at the reference's widest q = 640 beside the f64
   GEMM of the same Y; one mixed, f64 and fourier step on the host clock,
   and one mixed step under torch.profiler;
7. the default entry point, ``auto_fitter(toas, model)``, at 1e5 TOAs:
   a ``DownhillGLSFitter`` on bench.py's pulsar and on the binary MSP,
   each on the native rung with ``fused_gram_joint`` launched inside its
   proposals (the MSP's on the wide path), the MSP's converged and within
   1e-3 sigma of phase 6's GLSFitter fit, each matched by its host loop
   (``PINT_TPU_TORCH_DOWNHILL_FUSED=0``: the same iterations, chi2 within
   1e-8); the white MSP (no red noise) by ``DownhillWLSFitter`` (QR on
   the card) and by ``WLSFitter`` (``downhill=False``), within 1e-3 sigma
   of each other, and ``_wls_step(method='qr')`` on a 2048-TOA white copy
   within 1e-8 of the CPU's.  Each fit prints its iterations,
   ``converged``, chi2 from start to end, the last noise floor, its host
   time and peak allocation, and one iteration's proposal and chi2 ladder
   by the host clock and by device time;
8. the full-width pulsar, ``simulation.msp_full_par`` (the binary MSP
   plus NE_SW free, a '@' TZR anchor, PHOFF, and 30-harmonic power-law
   DM and chromatic noise: 169 design columns with the offset and a
   180-column basis, so the joint Gram is q = 350), simulated at 1e5
   TOAs with the orbit, the Sun and the TZR row in place: GLSFitter and
   ``auto_fitter`` (downhill GLS) on the native rung, each launching
   ``fused_gram_joint``'s wide path once a step or proposal and
   ``fourier_gram`` never, and ``GLSFitter(fused=True)`` refused; the
   mixed step from the par values at the step gates of the f64 step;
   the card against the CPU on a 2048-TOA copy with 12 DMX ranges
   (residuals 1e-11 s, f64 step 1e-8); ``fused_gram_joint`` at q = 350
   against its plain version with T in f64 and f32, timed beside the
   f64 GEMM of the same Y and its bound; then the card against the CPU
   (residuals 1e-11 s, design columns 1e-9 of their max) on 2048-TOA
   pulsars simulated by the port for the components the full-width
   pulsar does not carry: glitch, WAVE and IFUNC (BT), ChromaticCM and
   WaveX / DMWaveX / CMWaveX, SWX and piecewise spindown (FD, FDJUMP),
   and bench.py's pulsar with the troposphere, its geometry columns
   drawn from the seed, each one's GLS step on the card also captured
   as a step program and bitwise equal to its eager step.

9. wideband: the wideband MSP (``simulation.msp_wideband_par``: the
   binary MSP plus a free DMJUMP, DMEFAC and DMEQUAD; 169 design columns
   with the offset) at 1e5 TOAs with DM measurements (-pp_dme 2e-4),
   so the stacked system has 2e5 rows and the joint Gram q = 230:
   ``auto_fitter`` gives a ``WidebandDownhillFitter`` on its native rung
   and ``WidebandTOAFitter`` fits on ``cuda-mixed``, each launching the
   wide path at n = 2e5 (printed with their host times and peak
   allocations); the mixed step from the par values at the step gates
   of the f64 step; ``fused_gram_joint`` at (2e5, 60, 170), half its T
   rows zero, against its plain version, bitwise on rerun, and timed;
   the card against the CPU on a 2048-TOA copy (residuals 1e-11 s, DM
   residuals 1e-12 pc cm^-3, the f64 step 1e-8);
10. the PTA batch: 45 pulsars of ``simulation.pta_pars`` (msp_par's
   composition at 100 DMX ranges, each with its own F0, F1, sky
   position, DM, DMX values, PEPOCH and orbit; q = 179) with 4000-10000
   TOAs padded to 1e4: ``PTABatch.fit(maxiter=3)`` in 'mixed' mode
   launches the Gram kernel exactly once a batched step for all 45
   (printed with the steps, host time, a batched step's device time and
   the peak allocation); one batched mixed step at the step gates of the
   batched f64 step, pulsar by pulsar; on three pulsars each one's
   batched f64 step within 1e-8 of its own GLSFitter step; the batched
   kernel at the composition's shape and at the bench shape (q = 67)
   against its plain version, bitwise on rerun, each pulsar within 3e-6
   of scale of its own single launch, and timed beside its bound and
   one batched f64 GEMM (``torch.bmm``) of the same Y.

11. the dense-covariance step (``full_cov=True``): on bench.py's pulsar
   at 16384 and 32768 TOAs one step by each method (mixed: the f32
   equilibrated covariance and its factor refined in f64; f64) at the
   step gates of the Woodbury f64 step from the same inputs and mixed at
   them of f64, each timed (CUDA events, host clock, added peak), graphed
   bitwise against eager, and a GLSFitter(full_cov=True) fit on each
   route on its native rung; the factorizations of the equilibrated
   covariance at 8192, 16384 and 32768 (the native ``cholesky_ex`` in
   f32 and f64, ``fast_cholesky32``, ``blocked_cholesky`` in f64) timed
   beside their bound n^3/3 flop at 67 TFLOP/s, the blocked factors held
   to the native ones and ``solve_policy.ir_cholesky``'s route to the
   faster f32 factor of this run; the 2048-TOA copy card vs CPU (the f64
   dense step within 1e-8, the card's mixed one at the step gates); the
   MSP's DownhillGLSFitter(full_cov=True) fit at 16384 TOAs and the
   wideband MSP's WidebandTOAFitter and WidebandDownhillFitter with
   full_cov at 8192 TOAs (16384 stacked rows), each on its native rung;
   no kernel launches on this path;
12. the O(append) streaming solver on bench.py's pulsar and the binary
   MSP at 1e5 TOAs: ``stream_state_init`` on the first 1e5 - 640 rows,
   ten ``stream_state_append``s of 64 rows (their basis rows from
   ``fourier_basis_rows``), a ``stream_state_solve`` after each, none
   poisoned by the drift check; the final blocks within 1e-10 of a fresh
   init on all rows and the solve at the step gates of the f64 Woodbury
   step on all rows; an append and a solve timed eager and graphed
   (bitwise) beside the graphed full mixed step of phases 5 and 6.
13. inference, no kernel launched on any of its paths: bench.py's pulsar
   at 1e5 TOAs simulated with its orbit in phase (five free timing
   parameters, 30-harmonic red noise marginalized), fitted by GLSFitter
   (f64) for the gates; ``BayesianTiming.lnposterior`` over 64 walkers
   as one step program (CUDA-event and host time, the capture's peak,
   the eager call beside it), held to single evaluations and, on a
   2048-TOA copy, to the CPU (rel 1e-10, abs 1e-6); one stretch step
   card vs CPU from the same walkers and draws; ``MCMCFitter.fit_toas``
   (64 walkers) with every step a replay of one program (acceptance,
   autocorrelation time, ESS, split-R-hat, time a step, host time,
   peak), each posterior mean within 5 sigma of the GLS fit and each
   std within 60% of its GLS sigma; ``sample_nested`` with uniform
   priors at +-10 GLS sigma (logz, ncall, iterations, time), each mean
   within 3 sigma; on the binary MSP at 1e5 TOAs ``grid_chisq`` over
   M2 x SINI (8 x 8 about the truth, 2 refits of the other 165 free
   parameters, chunks sized by ``grid_chunk``), its minimum in the
   truth's cell or next to it, and a 3 x 3 grid on a 2048-TOA copy card
   vs CPU within 1e-8; 1e6 photon phases drawn from a two-Gaussian
   ``LCTemplate`` and fitted by ``LCFitter`` within 5 errors of the
   truth, the log-likelihood card vs CPU within 1e-10 and H and Z^2_4
   within 1e-9.
14. the port's own host ingest (no module of JAX or of the JAX package
   is imported anywhere in the script, which it asserts at the end): the
   23 golden sets read by ``get_model_and_toas`` in the committed data
   environment (``tests/datafile/ingest``: clock files, EOP table,
   ``testsat``'s orbit; ``tests/datafile/mini_vsop87.bsp``), golden21's
   satellite and golden22's topocentric TZR row included, each one's
   residuals on the card within 1 ns of its oracle; bench.py's pulsar
   with ``EPHEM mini_vsop87`` and ``CLOCK TT(BIPM2021)`` simulated at 1e5
   TOAs at gbt, effelsberg, jodrell and parkes over MJD 54500-55900 (the
   inversion on the card, the ingest between passes on the host), written
   by ``write_tim_file`` and read back: parse and ingest timed apart,
   ``get_TOAs(usepickle=False)`` cold, ``usepickle=True`` twice (the cache
   written, then a full hit), then 64 rows appended and read again (only
   they ingested), every column bitwise equal across the reads, the
   native MJD parser required; ``auto_fitter(toas, model).fit_toas()``
   on the cold read (downhill GLS on its native rung, ``fused_gram_joint``
   launched), every fitted value within 3 sigma of the par value (the
   simulation's truth); a 2048-TOA topocentric copy card vs CPU
   (residuals 1e-11 s, f64 step 1e-8).
15. the command-line tools, each through its ``main(argv)`` with
   ``--device cuda``, in the committed data environment: ``zima`` writes
   1e5 TOAs at gbt from phase 14's par and ``pintempo`` fits them
   (``auto_fitter`` on its native rung, ``fused_gram_joint`` counted from
   0 and launched, fit.par read back by ``get_model`` where ``compare``
   may flag only fitted values whose par-file digits lose their last bits,
   each within 1e-6 sigma of the fit, every value within 3 sigma of the
   truth); ``photonphase`` on 1e6 barycentred events over golden22's span
   with its TZR-anchored model (PULSE_PHASE equal to the card's absolute
   phase mod 1 bit for bit, a 2048-event subset on the CPU within F0 x
   1e-11 cycles); polycos of the binary MSP over one day at '@' and at
   gbt (60-minute segments, 12 coefficients: 1e4 off-node epochs within
   1e-6 cycles of the card's phase, a write/read roundtrip within 1e-6);
   ``event_optimize`` on 1e5 weighted photons of a two-Gaussian template
   over 1000 s with F0 started 1e-4 Hz off (16 walkers x 400 steps,
   every step a replay of one step program, F0 within 3e-5);
   ``compare_parfiles``,
   ``tcb2tdb``, ``t2binary2pint``, ``pintbary`` and ``pintpublish`` once
   each on small inputs.  Each tool's host seconds are printed.
16. the runtime and observability base: under the flight recorder
   (``obs.trace.tracing()``), phase 14's pulsar's 1e5 topocentric TOAs
   read from a tim file (``get_TOAs``) and fitted by ``GLSFitter`` twice,
   the second fit after the first's ``commit``: the trace holds fit,
   rung, compile, dispatch, fence and ingest spans, no program is built
   or captured on the refit (``compile.recompiles`` 0), ``fused_gram_joint``
   launched, and the Chrome trace written and loaded back holds the same
   spans; the ingest's stages apart (parse, plan, chunks, apply) and both
   fits' host seconds printed.  A step program of bench.py's pulsar at
   1e5 TOAs captured before a commit and replayed after it, bitwise
   equal to a fresh model's fresh capture.  The fault ladder on the card:
   ``transient:2@cm.program`` retried on the native rung with the clean
   fit's values; ``hang:1`` against a 0.5 s watchdog on a refit's replay
   raising GuardTimeout at the deadline and retried, the abandoned
   attempt launching nothing (launches counted); a kernel spinning past
   a 0.3 s watchdog seen at the host read as GuardTimeout;
   ``nan:inf@rung:cuda-mixed`` served by ``cuda-f64`` with the clean f64
   fit's values.  ``Fitter.release()`` after the traced refit hands its
   program's pool back, and ``memory_reserved`` after every phase stays
   under 24 GiB.  Checkpoints:
   ``save_fit``/``load_fit`` of the traced fit, and a 64-walker MCMC run
   on bench.py's pulsar at 1e4 TOAs planned as 1000 steps, cut at 500,
   saved and resumed (``resume_mcmc``), bitwise the uninterrupted run.
   The cost of the recorder and the guard: the guarded step program's
   call on the bench step (CUDA events and host clock, medians of 20)
   with the guard armed and off (``PINT_TPU_GUARD=off``), tracing off
   and on, beside the bare program.
17. the serving engine, ``TimingEngine()`` on the card (``max_batch=8``,
   ``inflight=2``): ``make_population`` gives 9 distinct pars of bench.py's
   composition over one simulated 1e5-TOA table (the orbit inside the
   phases; the variants' double-double values 1e-17 relative apart,
   about a sigma) and 2 of the binary MSP's.  One residuals batch of the
   8 pars (bucket 131072), each within 1e-9 relative of the direct
   ``time_residuals``; one fit batch of the 8 (``maxiter=3``, capacity
   8) and one of the 2 MSPs, each served fit held to a direct
   ``GLSFitter(...).fit_toas(maxiter=3)`` on the card at
   tests/test_serve.py's gates (chi2 1e-6 relative, deltas within 1e-3
   sigma, uncertainties 1e-5); a ``PredictRequest`` twice (the second
   from the polyco cache).  Launches, counted from 0 around each fit
   batch, must be what the code predicts: ``maxiter`` replays of the
   batched step program, each ONE batched ``fused_gram_joint`` launch,
   plus one for the warm-up of each capture the batch made — 3 + 1 = 4
   for each first batch of a (key, capacity), all batched, the MSP's on
   the wide path.  After capacities 1, 2, 4 and 8 are warmed, a wave of
   7 TOA subsets of 90,000-100,000 rows and a brand-new par (residuals
   and fits) builds and captures nothing.  An expired deadline and a
   quota breach shed typed; a ``hang`` injected at the residuals site
   against a 0.3 s watchdog wedges its launch on the card (a spinning
   kernel on the replica's stream) and fails GuardTimeout at the fence
   within 0.1 s of its deadline, and within the watchdog plus 0.1 s of
   its submit beyond the host path to its launch (submit to dispatch on
   the engine's stage clock, the median of three identical requests
   served just before), and the next batch is served.  Printed:
   requests/s, TOAs/s and p50/p99 latency of the steady wave, each
   batch's CUDA-event ms, each program's capture s and
   ``memory_reserved``.
18. the one-card fleet (``fleet_phase``; its launch predictions in its
   docstring): a stream (``engine.open_stream``) on bench.py's pulsar at
   1e5 TOAs opened on all but 832 interior rows, ten 64-row appends each
   on the incremental rung (the append program captured once, at the
   first), then within 1e-4 sigma, 1e-4 and 1e-6 of a direct f64
   ``GLSFitter`` fit of every absorbed row; a corrupted state failing
   typed in the program and, through the stream, on the warm rung; a
   refresh (``PINT_TPU_STREAM_REFRESH=1``) on the warm rung; an ECORR
   stream at 512 TOAs on the warm rung only.  The cross-key fuse: three
   compositions at 2048-3000 TOAs, two pars each, their fit batches
   queued behind a stalled dispatch and run as one fused program,
   bitwise the same batches with fusion off, a steady round building and
   capturing nothing, a member with a NaN uncertainty failing alone.
   Jobs at 1e5 TOAs: a 64-walker MCMC of 256 steps in quanta of 16,
   preempted by an expired interactive deadline, bitwise
   ``run_ensemble`` of the job's posterior on the card; a 4 x 4 grid
   within 1e-10 of ``grid_chisq``; repeats capturing nothing.  A kill
   and restart: engine A (a warm ledger in a temporary directory) serves
   residuals, fits and a grid job and closes mid-MCMC; engine B, in a
   process of its own (``restart_child``), replays the ledger before its
   collector, then the same traffic captures and builds nothing and runs
   no nvcc, and the killed job resumes bitwise.  Printed: an append's
   CUDA-event and host ms beside phase 12's eager append, the fused
   batch's ms, the jobs' s, the replay's s and captures.
19. the multi-GPU layer (``parallel_phase``; ``pint_tpu_torch/parallel/``)
   on the one card: the parent simulates bench.py's pulsar and the binary
   MSP at 1e5 TOAs and bench.py's composition at 32768, takes their
   unsharded steps and hands the operands to two groups of spawned ranks
   (``parallel_child``), each of which loads the parent's CUDA libraries
   (no nvcc) and imports nothing of JAX.  Group A, NCCL at world size 1
   (a 1 x 1 mesh): ``place_gls_operands`` then
   ``sharded_gls_step_mixed`` / ``sharded_gls_step`` on both pulsars,
   eager and as a step program whose collectives are split points, each
   bitwise the unsharded step of its process, one ``fused_gram_joint``
   launch a mixed step (the MSP's wide); the one-rank dense step; the
   46-pulsar PTA batch (phase 10's 45 and a copy of pulsar 0) unsharded
   and its halves.  Group B, two gloo ranks sharing the card: both
   pulsars 2-way on ``toa`` (5e4 rows a rank) at the reference's sharded
   gates against the parent's unsharded steps (mixed as the reference's;
   f64 scaled by sigma, ``_f64_gates``), one launch a mixed step a rank
   and none on the f64 route; ``dryrun_multichip``'s stages 2-4 (n =
   2^20, p 4, k 10; the dense step at 176 rows under one block of 256;
   the padded wideband stack); the sharded dense step at 32768 TOAs, each
   method with the lookahead on and off, within the step gates of the
   Woodbury step, each rank's peak at most 0.65 of the one-rank peak; the
   PTA batch 2-way on ``pulsar``, each rank bitwise the unsharded batch of
   its own pulsars (f64 and mixed), in mixed mode at the reference's
   sharded mixed gates of the 46-pulsar batch, in f64 within 1e-6 of it in
   xs (scaled by each component or its sigma) and 1e-8 in chi2, 6
   batched launches a rank (4 replays, the warm-up, and the capture's
   replay of the segment that holds the Gram).  In every rank of both groups the
   ``fused_gram_joint`` wrapper is held against its plain version on the
   rank's own operands (phase 1's tolerance): bench and MSP rows, stage
   2's and stage 4's rows, the PTA batch's pulsars (one batched launch).
   Printed, per rank and labelled "2 ranks on one card
   through gloo (host staging): not a multi-card figure": each step's
   CUDA-event ms, its host ms with the collectives' share, the dense
   steps' s and peaks, ``memory_reserved``.  A rank that fails fails the
   phase.
20. the fleet's multi-card half (``gang_phase``;
   ``pint_tpu_torch/serve/fabric/{gang,gang_rank,elastic}.py``) on the one
   card: ``TimingEngine(replicas=4, gangs=1, gang_size=2,
   gang_threshold=65536)``, a gang of two rank processes sharing the card
   through gloo (started first and timed; neither imports JAX) beside two
   singles.  bench.py's pulsar and the binary MSP at 1e5 TOAs (bucket
   131072, 65536 rows a rank) served by the gang through ``submit`` as
   residuals and a fit of 3 iterations, tagged ``g0``, held to the same
   engine's single replica r0 on the same batches (residuals 1e-9 of
   their largest, chi2 1e-9; deltas 1e-4 sigma, uncertainties 1e-6, chi2
   1e-8); no launch in the parent, at least 3 a rank (the MSP's on the
   wide path), no nvcc in a rank; each rank's ``fused_gram_joint``
   wrapper against its plain version on the rank's own operands
   (``gang_rank_gram`` through ``RankGroup.call``, phase 1's tolerance);
   a steady repeat bitwise, 3 launches a rank, no build or capture in a
   rank or the parent.  A NaN pinned at ``@g0``: the gang quarantines,
   its work re-routes, the canary keeps failing while armed and
   re-admits it after.  Rank 1 stopped with a batch in flight, then
   killed: the batch fails with GuardTimeout naming the rank well within
   the watchdog and re-routes; the group starts anew and serves bitwise
   its earlier answer.  A second engine with a warm ledger (2048- and
   8192-TOA keys, the gang sharding the 8192): a manual repartition
   gang -> singles -> gang under a small-key pump with every future
   completed; the chaos tool's ``nan`` leg at every executor of the new
   partition (``chaos.run_leg``: typed futures, quarantine and
   readmission, no steady build); the Repartitioner dissolving the idle
   gang under a small flood, the rounds after the flip with no build,
   capture or nvcc.  Then ``traceview`` and ``fleetview`` on the
   phase's trace.  Printed: each rank's peak memory, the group's start
   s, the serving, fault and reshape times, each labelled "2 ranks on
   one card through gloo: not a multi-card figure".
21. the reference's NANOGrav configurations, BASELINE.json configs 2
   and 3 (``nanograv_phase``), each built by ``ModelBuilder`` and
   simulated on the card in observing sessions (TOAs 1 s apart
   alternating between four L-wide and four S-wide sub-bands, the orbit
   inside the phases): config 2, ``j1713_par(100)`` (DD binary with
   eight free orbital parameters, FD1-FD3, a JUMP, EFAC/EQUAD/ECORR on
   both receivers, 30-harmonic red noise) at 10,000 TOAs in 125
   sessions, joint Gram (1e4, 310, 121); config 3, ``b1855_par(100)``
   (the binary MSP with ECORR on both receivers) at 8192 TOAs in 128
   sessions, (8192, 316, 119): both on the wide path.  On each
   configuration's own operands the wide kernel against its plain
   version (T in f64 and f32; 3e-6 of scale, bitwise on rerun) and timed
   beside its bound and the f64 GEMM; the mixed step at the step gates
   of the f64 step, or for config 2 NaN-poisoned by the refinement check
   (as the reference's is).  Config 2 through ``auto_fitter``: a
   ``DownhillGLSFitter`` launching the wide kernel, served by its native
   rung or, after the numerics guard refused that rung alone, by the
   f64 rung.  Config 3 by ``GLSFitter``: the Woodbury step on its native
   rung (the wide kernel launched) and on the f64 rung, the dense step
   (``full_cov=True``) on both (no launch), the f64 Woodbury fit within
   1e-6 sigma, chi2 1e-8 and uncertainties 1e-6 of the f64 dense fit.
   Each fit prints its rung, steps, host s, one step's CUDA-event ms,
   launches and peak allocation.  The 2048-TOA copies (24 DMX ranges, 32
   sessions of 64) card vs CPU: config 3's residuals within 1e-11 s and
   f64 step within 1e-8; config 2's residuals within 1e-11 s and its
   f64 step, in sigma, within 10 times the CPU's own spread under
   reordered TOAs (``sigma_gap``: DD's OM and T0 at e = 7.5e-5 leave
   that system too ill-conditioned for any two summation orders to meet
   1e-8).

Every fit above runs its steps as replays of step programs
(``runtime/graphs.py``: CUDA graphs captured once, after one eager
warm-up call), and each check says so: a GLSFitter, WLSFitter or
WidebandTOAFitter fit replayed its step program once a step, a fused
downhill fit its iteration program once an iteration and its proposal
program once, the PTA fit its batched step ``maxiter + 1`` times, each
program captured once and left cached after the fit's commit for a
refit (which captures nothing, phase 16), and each kernel launched once
a replay plus once in each capture's warm-up.  Every step program is
called through the device-execution guard (``runtime/guard.py``: on the
card a watchdog that queues an event a call under its deadline, kept at
the fit's host read).  The
graph checks (PR 11) hold each captured function bitwise equal to the
same function run eagerly from the same inputs, twice, and time it:
bench.py's pulsar's mixed, f64 and fourier steps (phase 5), the binary
MSP's mixed and f64 steps (6), one downhill GLS iteration on bench.py's
pulsar and one downhill WLS (QR) iteration on the white MSP (7), the
full-width pulsar's mixed step (8), the wideband MSP's mixed step (9) and
the PTA batch's mixed step (10).  Each prints the graphed call's
CUDA-event time (median of 20) and host time, the eager call's host time
and its busy share (the profiler's device time over the host time) from
the same run, the capture time, the graphs' count (an f64 step splits at
``torch.linalg.eigh``, which checks its result on the host) and the
bytes the capture reserved; ``torch.cuda.memory_reserved`` is printed
after each phase from 2 on.

The last three lines are the kernels JSON (each kernel at the binary
MSP's shapes, with its launches in the MSP's fits, and under ``bench``
the same numbers at bench.py's pulsar; ``fused_gram_joint`` also with
the launches of the downhill fits of phase 7, under ``full_width``
its q = 350 entry with the launches of phase 8's fits, under
``wideband`` and ``pta`` those of phases 9 and 10, and under ``dense``,
``stream`` and ``inference`` phases 11, 12 and 13's results with their
zero launches, under ``ingest`` phase 14's results and the launches of
its fit, under ``tools`` phase 15's results and under ``tools_launches``
those of pintempo's fit, under ``runtime`` phase 16's results and under
``runtime_launches`` those of its traced fits, under ``serve`` phase
17's results and under ``serve_launches`` its fit batches' launches,
under ``fleet`` phase 18's results and under ``stream_launches``,
``fused_launches`` and ``restart_launches`` its counted launches, under
``parallel`` phase 19's results and under ``parallel_launches`` its
ranks' counted launches, under ``gang`` phase 20's results and under
``gang_launches`` each gang rank's counted launches, under ``nanograv``
phase 21's results and under ``nanograv_launches`` each of its fits'
wide launches),
nvidia-smi's name and
power limit, and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script exits non-zero before printing any result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pint_tpu_torch.fitting import (  # noqa: E402
    DownhillGLSFitter,
    DownhillWLSFitter,
    WidebandDownhillFitter,
    WidebandTOAFitter,
    WLSFitter,
    auto_fitter,
)
from pint_tpu_torch.fitting.gls import (  # noqa: E402
    GLSFitter,
    _column_norms,
    default_accel_mode,
    gauss_newton_step,
    gls_step_full_cov,
    gls_step_woodbury,
    gls_step_woodbury_fourier,
    gls_step_woodbury_mixed,
    stream_state_append,
    stream_state_gaps,
    stream_state_init,
    stream_state_solve,
)
from pint_tpu_torch.fitting.downhill import _ladder_lams  # noqa: E402
from pint_tpu_torch.fitting.spread import (  # noqa: E402
    f64_step,
    ordering_gaps,
    rounding_gaps,
    step_inputs,
)
from pint_tpu_torch.fitting.wls import _qr_gate, _wls_step  # noqa: E402
from pint_tpu_torch.bayesian import BayesianTiming  # noqa: E402
from pint_tpu_torch.eventstats import hm, z2m  # noqa: E402
from pint_tpu_torch.fitting.base import design_with_offset, noffset  # noqa: E402
from pint_tpu_torch.gridutils import grid_chisq, grid_chunk  # noqa: E402
from pint_tpu_torch.models.priors import UniformBoundedRV  # noqa: E402
from pint_tpu_torch.sampler import MCMCFitter, make_stretch_step  # noqa: E402
from pint_tpu_torch.templates import (  # noqa: E402
    LCFitter,
    LCGaussian,
    LCTemplate,
)
from pint_tpu_torch.exceptions import PintTpuError  # noqa: E402
from pint_tpu_torch import native  # noqa: E402
from pint_tpu_torch.io.tim import get_TOAs_from_tim, write_tim_file  # noqa: E402
from pint_tpu_torch.models.builder import get_model  # noqa: E402
from pint_tpu_torch.toas.cache import get_TOAs  # noqa: E402
from pint_tpu_torch.toas.ingest import ingest_for_model  # noqa: E402
from pint_tpu_torch.toas.ingest_topo import ingest_workers  # noqa: E402
from pint_tpu_torch.models.noise import (  # noqa: E402
    fourier_basis_rows,
    fourier_freqs,
)
from pint_tpu_torch.ops import fourier, fused_gram, solve_policy  # noqa: E402
from pint_tpu_torch.ops._cuda_build import build_libraries  # noqa: E402
from pint_tpu_torch.ops.dd import DD  # noqa: E402
from pint_tpu_torch.ops.ffgram import nan_cholesky  # noqa: E402
from pint_tpu_torch.ops.solve_policy import stream_drift_rtol  # noqa: E402
from pint_tpu_torch.parallel.dense import (  # noqa: E402
    blocked_cholesky,
    fast_cholesky32,
)
from pint_tpu_torch.parallel.pta import PTABatch  # noqa: E402
from pint_tpu_torch.runtime import graphs  # noqa: E402
from pint_tpu_torch.models.builder import ModelBuilder  # noqa: E402
from pint_tpu_torch.simulation import (  # noqa: E402
    J1713_SPAN,
    MSP_FREQS,
    MSP_SPAN,
    NANOGRAV_FREQS,
    b1855_par,
    epoch_mjds,
    j1713_par,
    make_test_pulsar,
    msp_full_par,
    msp_par,
    msp_wideband_par,
    pta_ntoas,
    pta_pars,
)
from pint_tpu_torch.timebase.hostdd import HostDD  # noqa: E402
from torch_ingest_env import (  # noqa: E402
    golden_env,
    port_golden,
    port_ingest_env,
)

BENCH_PAR = """
PSR              J1744-1134
F0               245.4261196898081  1
F1               -5.38e-16          1
PEPOCH           55000
DM               3.1380             1
RAJ              17:44:29.403209    1
DECJ             -11:34:54.68067    1
EFAC             -f L-wide 1.1
EQUAD            -f L-wide 0.5
TNREDAMP         -13.5
TNREDGAM         3.7
TNREDC           30
"""
NTOA = 100_000
SIM = dict(start_mjd=53000.0, end_mjd=57500.0, seed=0, iterations=1,
           orbit=True)
#: the binary MSP: DMX ranges at full size and on the small copy held
#: against the CPU; simulated with SIM's settings but with the synthetic
#: orbit inside the simulated phases, so the fit starts at the truth and
#: converges (outside them, the unmodelled ~500 s Roemer delay wraps every
#: phase and the binary parameters walk off)
MSP_NDMX = 150
MSP_SMALL = dict(ntoa=2048, ndmx=12)
MSP_SIM = dict(SIM, freqs=MSP_FREQS, orbit_in_phase=True)

#: H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bandwidth and
#: f64 on the tensor cores, the card's peak rate for f64 work
HBM_BYTES_PER_S = 3.35e12
F64_TC_FLOPS = 67e12

#: every kernel: name -> (wrapper, source, TPU kernel, fit path or None)
KERNELS = {
    "fused_gram_joint": (
        fused_gram.fused_gram_joint_cuda,
        "pint_tpu_torch/csrc/fused_gram_joint.cu",
        "pint_tpu/ops/pallas_fit.py:159",
        "mixed",
    ),
    "fourier_gram": (
        fourier.fourier_gram_cuda,
        "pint_tpu_torch/csrc/fourier_gram.cu",
        "pint_tpu/ops/pallas_kernels.py:114",
        "fourier",
    ),
    "fourier_apply": (
        fourier.fourier_apply_cuda,
        "pint_tpu_torch/csrc/fourier_apply.cu",
        "pint_tpu/ops/pallas_kernels.py:210",
        None,
    ),
}
#: the libraries to build: every kernel's, and fused_gram_joint's wide
#: path (csrc/fused_gram_wide.cu, launched by the same wrapper)
LIBRARIES = [*KERNELS, "fused_gram_wide"]
#: the graph checks' results by path, and memory_reserved after each phase
GRAPHS: dict = {}
MEMORY: dict = {}
#: the most memory_reserved may hold after a phase (its garbage collected,
#: the cache emptied): a fitter's step programs and their pools live as
#: long as the fitter, and must not pile up across phases past what the
#: largest phase holds (phase 11's dense factors at 32768 TOAs, 19.3 GB)
MEMORY_LIMIT = 24 * 2**30
T_START = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def rel(a, b):
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


def cuda_ms(fn, reps=20, warm=3, batch=20):
    """Median over ``reps`` of CUDA-event time per call, each measured over
    ``batch`` back-to-back calls (so the card's queue stays full)."""
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(batch):
            fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / batch)
    return statistics.median(ts)


def device_ms(fn, calls=20, tries=3, warm=True):
    """Device time per call from torch.profiler: the summed durations of
    the kernels ``fn`` launches, without host gaps.  Also per kernel.  On
    the card the profiler drops events of a window: a count of 19 where
    20 calls launched 20, and for calls of a millisecond or more a fixed
    share of them (17 of 20 batched Gram launches, 14 of 20 batched f64
    GEMMs, in every try).  So each kernel's time per call is its mean
    recorded duration times its launches per call, its count over the
    calls rounded up (the profiler drops events, it adds none); a profile
    that recorded no kernel, or fewer than half the events of whole
    launches a call, is taken again, and after ``tries`` such profiles
    the time is None.  ``warm`` calls ``fn`` once first (False where it
    has just run)."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total, count = {}, {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                total[ev.name] = total.get(ev.name, 0.0) + ev.device_time
                count[ev.name] = count.get(ev.name, 0) + 1
        each = {k: max(1, -(-c // calls)) for k, c in count.items()}
        if total and all(2 * c >= each[k] * calls for k, c in count.items()):
            per = {k: total[k] / count[k] * each[k] / 1e3 for k in total}
            return sum(per.values()), per
        log(f"  device_ms: profile taken again, kernel counts "
            f"{ {k[:40]: c for k, c in count.items()} } for {calls} calls")
    return None, {}


def graph_ms(fn, calls=20):
    """CUDA-event time per call of ``calls`` back-to-back calls captured in
    one CUDA graph and replayed: the calls' device time without the
    host's launch cost, which bounds a loop of short calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, batch=1) / calls


def host_ms(fn, reps=30, warm=3):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def fourier_inputs(cm, x):
    """The fourier step's inputs: (r, M, Ndiag, t_sec, freqs, phi)."""
    r, M, Nd, _, _ = step_inputs(cm, x)
    return (r, M, Nd, *cm.noise_fourier_spec(x))


def gram_inputs(cm, x):
    """The fused Gram's operands exactly as the mixed step forms them."""
    r, M, Ndiag, T, _ = step_inputs(cm, x)
    X = torch.cat([M / _column_norms(M)[None, :], r[:, None]], dim=1)
    return T.contiguous(), X.contiguous(), (1.0 / Ndiag).contiguous()


def fourier_gram_inputs(cm, x):
    """fourier_gram's operands exactly as the fourier step forms them."""
    r, M, Ndiag, t_sec, freqs, _ = fourier_inputs(cm, x)
    X = torch.cat([M / _column_norms(M)[None, :], r[:, None]], dim=1)
    return t_sec, freqs, 1.0 / Ndiag, X


def kernel_vs_plain(name, kernel, plain, *args):
    """Kernel against its plain version on the same card tensors: 3e-6
    of scale and bitwise equal to itself on a rerun.  -> (abs, rel)."""
    got = kernel(*args)
    again = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    if isinstance(want, torch.Tensor):
        got, again, want = (got,), (again,), (want,)
    worst_abs, worst_rel = 0.0, 0.0
    for g, g2, ww in zip(got, again, want):
        check(torch.equal(g, g2), f"{name} is not bitwise reproducible")
        err = float(torch.max(torch.abs(g.double() - ww.double())))
        scale = float(torch.max(torch.abs(ww)))
        check(err <= 3e-6 * scale, f"{name} vs plain: {err} > 3e-6 * {scale}")
        worst_abs = max(worst_abs, err)
        # (an output that is exactly 0, as a shard's Gram of zero basis
        # rows, passed the check above only with err 0)
        worst_rel = max(worst_rel, err / scale if scale else 0.0)
    return worst_abs, worst_rel


def basis_check(t, f):
    """fourier_apply_cuda with z each block of at most M_MAX columns of the
    2k x 2k identity must equal basis32's columns bit for bit: each output
    is one product by 1.0 plus exact zeros, i.e. the generated value."""
    T = fourier.basis32(t, f)
    k2 = T.shape[1]
    eye = torch.eye(k2, dtype=torch.float64, device=t.device)
    for c in range(0, k2, fourier.M_MAX):
        Z = eye[:, c:c + fourier.M_MAX].contiguous()
        got = fourier.fourier_apply_cuda(t, f, Z)
        check(torch.equal(got, T[:, c:c + Z.shape[1]]),
              f"generated basis differs from basis32 (n={t.shape[0]}, "
              f"k={f.shape[0]}, columns {c}..): "
              f"{int(torch.sum(got != T[:, c:c + Z.shape[1]]))} values")
    return t.shape[0], f.shape[0]


def graph_equal(label, fn, args):
    """``fn`` as a step program against ``fn`` run eagerly from the same
    inputs: both replays bitwise equal to the eager result.  -> the
    program."""
    eager = graphs.flatten(fn(*args))[0]
    prog = graphs.StepProgram(fn, args[0].device)
    first = graphs.flatten(prog(*args))[0]
    again = graphs.flatten(prog(*args))[0]
    torch.cuda.synchronize()
    check(len(eager) == len(first) and all(
        torch.equal(e, g) and torch.equal(g, g2)
        for e, g, g2 in zip(eager, first, again)),
        f"{label}: the graphed step differs from the eager step")
    return prog


def graph_check(label, fn, args, eager_ms):
    """``graph_equal``, then the graphed call timed (CUDA events, median
    of 20, and the host clock, median of 3) beside the eager call's host
    time ``eager_ms`` (measured by the caller in this run) and busy share
    (profiler device time over host time); records the capture time, the
    graphs' count and the bytes the capture reserved."""
    prog = graph_equal(label, fn, args)
    out = dict(bitwise=True, graphs=len(prog.segments),
               capture_s=prog.capture_s, pool_reserved=prog.pool_reserved,
               eager_host_ms=eager_ms)
    out["eager_device_ms"], _ = device_ms(lambda: fn(*args), calls=1,
                                          warm=False)
    out["graph_ms"] = cuda_ms(lambda: prog(*args), reps=20, warm=1, batch=1)
    out["graph_host_ms"] = host_ms(lambda: prog(*args), reps=3, warm=0)
    if out["eager_device_ms"] is not None:
        out["busy_share"] = out["eager_device_ms"] / out["eager_host_ms"]
        out["graph_busy_share"] = (out["eager_device_ms"]
                                   / out["graph_host_ms"])
    log(f"graph {label}: {out}")
    GRAPHS[label] = out
    return out


def phase_memory(phase):
    """torch.cuda.memory_reserved after a phase, its garbage collected
    and the allocator's cache emptied (the pools of finished programs
    must not pile up: at most MEMORY_LIMIT), and the script's seconds so
    far."""
    gc.collect()
    torch.cuda.empty_cache()
    MEMORY[phase] = dict(reserved=torch.cuda.memory_reserved(),
                         allocated=torch.cuda.memory_allocated(),
                         elapsed_s=time.perf_counter() - T_START)
    log(f"memory after phase {phase}: {MEMORY[phase]}")
    check(MEMORY[phase]["reserved"] <= MEMORY_LIMIT,
          f"memory_reserved after phase {phase}: "
          f"{MEMORY[phase]['reserved']} bytes, over {MEMORY_LIMIT}")


def programs_ran(label, cache, replays, captures):
    """A fit's step programs: ``replays`` replays, ``captures`` captures,
    each captured program left cached after the commit (a refit replays
    it)."""
    got = dict(replays=cache.replays, captures=cache.captures,
               cached=len(cache), capture_s=cache.capture_s)
    check(got["replays"] == replays and got["captures"] == captures
          and got["cached"] == captures,
          f"{label}: step programs {got}, expected {replays} replays and "
          f"{captures} captures")
    return got


def profile_step(cm, x, mode):
    """One step under torch.profiler: kernels launched, device time summed
    over them, wall time, and the operators that take the device time."""
    from torch.profiler import ProfilerActivity, profile

    gauss_newton_step(cm, x, mode)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gauss_newton_step(cm, x, mode)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.device_time for e in kernels)
    log(f"profile {mode} step: {len(kernels)} device kernels, device time "
        f"{dev_us:.1f} us of {wall_us:.1f} us wall (busy share "
        f"{dev_us / wall_us:.4f})")
    log(prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=8))


def zero_counts():
    for wrapper, _, _, _ in KERNELS.values():
        wrapper.launches = 0
    fused_gram.fused_gram_joint_cuda.wide_launches = 0
    fused_gram.fused_gram_joint_cuda.batched_launches = 0


def read_counts():
    launches = {n: k[0].launches for n, k in KERNELS.items()}
    launches["fused_gram_joint wide"] = (
        fused_gram.fused_gram_joint_cuda.wide_launches)
    launches["fused_gram_joint batched"] = (
        fused_gram.fused_gram_joint_cuda.batched_launches)
    return launches


def drive(path, make_fitter, label="bench"):
    """Drive one fit path with every launch count at 0 just before it and
    read just after; check the fit and its launches.  Also prints the
    fit's peak of allocated device memory."""
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fitter = make_fitter()
    chi2 = fitter.fit_toas(maxiter=4)
    torch.cuda.synchronize()
    launches = read_counts()
    rep = fitter.guard_report
    progs = programs_ran(f"{label} {path} fit", fitter.cm.programs,
                         fitter.steps_taken, 1)
    log(f"{label} {path} fit: mode={fitter.mode} rung={rep.rung} "
        f"fell_back={rep.fell_back} steps={fitter.steps_taken} "
        f"chi2={chi2!r} converged={fitter.converged} launches={launches} "
        f"programs={progs} wall={time.perf_counter() - t0:.2f} s "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()} B")
    check(fitter.mode == path, f"the {path} fit ran in mode {fitter.mode}")
    check(rep.rung == f"cuda-{path}" and not rep.fell_back,
          f"the {path} fit was served by rung {rep.rung}: {rep.history}")
    check(math.isfinite(chi2), "non-finite chi2")
    for i, n in enumerate(fitter.cm.free_names):
        p = fitter.model.params[n]
        v = p.value
        v = float(v[0] + float(v[1]) / 86400.0 if isinstance(v, tuple)
                  else v)
        if i < 12 or not n.startswith("DMX_"):
            log(f"  {n:6s} {v!r:>26} +- {p.uncertainty!r}")
        check(math.isfinite(v) and math.isfinite(p.uncertainty)
              and p.uncertainty > 0, f"{n}: non-finite value/uncertainty")
    for n, (_, _, _, kpath) in KERNELS.items():
        if kpath == path:
            # as often in each replay as in the capture's warm-up call
            steps = fitter.steps_taken + 1
            check(launches[n] >= steps > 1 and launches[n] % steps == 0,
                  f"{n} launched {launches[n]} times in "
                  f"{fitter.steps_taken} steps")
        else:
            check(launches[n] == 0, f"{n} launched on the {path} path")
    return fitter, launches


def step_gates(name, got, want, ntoa=NTOA, gate=True):
    """A step against the f64 step from the same x, at the reference's
    step gates; uncertainties and the worst dx gap in sigma printed.
    ``gate=False`` measures and prints without the gates."""
    (dx_m, (cov_m, _), chi_m, _), (dx_f, (cov_f, norm), chi_f, _) = got, want
    sig_m = torch.sqrt(torch.diagonal(cov_m))
    sig_f = torch.sqrt(torch.diagonal(cov_f))
    gates = dict(dx_rel=rel(dx_m, dx_f),
                 chi2_rel=abs(float(chi_m) - float(chi_f)) / abs(float(chi_f)),
                 cov_rel=rel(cov_m, cov_f),
                 unc_rel=float(torch.max(torch.abs(sig_m - sig_f) / sig_f)),
                 dx_gap_sigma=float(torch.max(
                     torch.abs(dx_m - dx_f) / (sig_f / norm))))
    log(f"{name} vs f64 step at {ntoa} TOAs: {gates}")
    check(not gate or gates["dx_rel"] <= 2e-3 and gates["chi2_rel"] <= 1e-3
          and gates["cov_rel"] <= 5e-3, f"{name} step outside gates {gates}")
    return gates


def bound(nbytes, flops, peak):
    """(bound ms, 'bytes' or 'operations') from this run's counts."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_kernel(kernel, plain, library):
    """CUDA-event and profiler times of a kernel, its plain version and
    its library yardstick on the same inputs."""
    out = dict(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
               library_ms=cuda_ms(library))
    out["device_ms"], parts = device_ms(kernel)
    out["plain_device_ms"], _ = device_ms(plain)
    out["library_device_ms"], _ = device_ms(library)
    out["device_parts"] = {k[:40]: v for k, v in parts.items()}
    return out


def pass_times(entry, prefix):
    """A Gram kernel's pass 1 and pass 2 device times from its profiled
    parts (None where the profile recorded no such kernel)."""
    parts = entry["device_parts"]
    for key in ("pass1", "pass2"):
        got = [v for nm, v in parts.items() if f"{prefix}{key}" in nm]
        entry[f"{key}_device_ms"] = sum(got) if got else None


def gram_bound(T, A, w):
    """fused_gram_joint's bound from its inputs: each read once, the
    three Grams written once (each pulsar's, for a batch); n q (q + 1)
    f64 flop of the upper triangle a pulsar at the f64 tensor-core
    peak."""
    *lead, n, k = T.shape
    npsr = math.prod(lead)
    p1 = A.shape[-1]
    q = k + p1
    nbytes = (T.numel() * T.element_size() + A.numel() * A.element_size()
              + w.numel() * w.element_size()
              + 8 * npsr * (k * k + k * p1 + p1 * p1))
    return bound(nbytes, npsr * n * q * (q + 1), F64_TC_FLOPS)


def fourier_gram_bound(n, nh, p):
    """fourier_gram's bound: t, w and X read once, Sigma and TWX written
    once; the upper triangle of Sigma and all of TWX in f64 FMAs."""
    k2 = 2 * nh
    fma = n * (k2 * (k2 + 1) // 2 + k2 * p)
    return bound(8 * (n * (p + 2) + nh + k2 * k2 + k2 * p), 2 * fma,
                 F64_TC_FLOPS), fma


def fourier_apply_bound(n, nh, m):
    """fourier_apply's bound: t, f and z read once, y (f32) written
    once; 2 n 2k m f64 flop."""
    return bound(8 * (n + nh + 2 * nh * m) + 4 * n * m, 2 * n * 2 * nh * m,
                 F64_TC_FLOPS)


def msp_phases(dev, rng):
    """The binary MSP (``msp_par``: ecliptic astrometry, F0/F1, 150 DMX
    ranges, FD1/FD2, a JUMP, ELL1 with Shapiro, EFAC/EQUAD on two
    receivers, 30-harmonic red noise) at 1e5 TOAs: both fit paths with
    their launches, the step gates, the card against the CPU at 2048
    TOAs, every kernel against its plain version at the wide shapes, and
    the wide shapes' timings.  Returns what the kernels line reports."""
    par = msp_par(MSP_NDMX, seed=0)
    t0 = time.perf_counter()
    model, toas = make_test_pulsar(par, ntoa=NTOA, device=dev, **MSP_SIM)
    log(f"msp: simulated {NTOA} TOAs in {time.perf_counter() - t0:.2f} s")
    mixed, mixed_l = drive("mixed", lambda: GLSFitter(toas, model,
                                                      device=dev), "msp")
    check(mixed_l["fused_gram_joint wide"] == mixed_l["fused_gram_joint"],
          f"the msp's joint Gram left the wide path: {mixed_l}")
    four, four_l = drive(
        "fourier",
        lambda: GLSFitter(toas, get_model(par), device=dev, fused=True),
        "msp")
    launches = dict(fused_gram_joint=mixed_l["fused_gram_joint"],
                    fourier_gram=four_l["fourier_gram"],
                    fourier_apply=(mixed_l["fourier_apply"]
                                   + four_l["fourier_apply"]))

    # gates at 1e5 on the fits' first step (from the par values: a fit
    # that has converged takes steps of ~1e-3 sigma, which no relative
    # gate reads), and the card against the CPU on a 2048-TOA copy
    cm = get_model(par).compile(toas, device=dev)
    x = cm.x0()
    args = step_inputs(cm, x)
    log(f"msp shapes: n={args[1].shape[0]} design columns "
        f"{args[1].shape[1]} basis {args[3].shape[1]}")
    gates = {"mixed": step_gates(
        "msp mixed", gls_step_woodbury_mixed(*args, normalized_cov=True),
        gls_step_woodbury(*args, normalized_cov=True))}
    fcm, fx = cm, x
    gates["fourier"] = step_gates(
        "msp fourier",
        gls_step_woodbury_fourier(*fourier_inputs(fcm, fx),
                                  normalized_cov=True),
        gls_step_woodbury(*step_inputs(fcm, fx), normalized_cov=True))
    # the small copy as the CPU parity test builds it (tests/
    # test_torch_binary.py: SIM's orbit added after the simulation), so
    # the step held to 1e-8 is a large one, as bench.py's pulsar's
    card_vs_cpu("msp", msp_par(MSP_SMALL["ndmx"], seed=0),
                MSP_SMALL["ntoa"], {"freqs": MSP_FREQS})
    # and a copy simulated as the 1e5-TOA MSP is (orbit inside the
    # phases, so the step from the par values is noise-sized): the card's
    # f64 step against the CPU's in units of each parameter's sigma
    r4 = sigma_gap("msp in-phase copy", msp_par(MSP_SMALL["ndmx"], seed=0),
                   MSP_SMALL["ntoa"], MSP_SIM)

    def odd(*shape):
        return torch.as_tensor(rng.standard_normal(shape), device=dev)

    def weights(n):
        return torch.as_tensor(rng.uniform(0.0, 2.0, n), device=dev)

    # each kernel vs its plain version at the wide shapes
    T, A, w = gram_inputs(cm, x)
    n, k = T.shape
    p1 = A.shape[1]
    fj = (fused_gram.fused_gram_joint_cuda, fused_gram.fused_gram_joint_plain)
    errs = {"fused_gram_joint": [kernel_vs_plain("fused_gram_joint", *fj,
                                                 T, A, w),
                                 kernel_vs_plain("fused_gram_joint", *fj,
                                                 T.float(), A, w)]}
    A228 = A[:, :p1 - 1].contiguous()
    for args_ in ((T, A228, w), (T.float(), A228, w),
                  (odd(n, 128), odd(n, 512), weights(n)),
                  (odd(100_001, 61), odd(100_001, 170), weights(100_001)),
                  (odd(100_001, 61).float(), odd(100_001, 170),
                   weights(100_001))):
        errs["fused_gram_joint"].append(
            kernel_vs_plain("fused_gram_joint", *fj, *args_))
    log(f"msp fused_gram_joint vs plain at q = {k + p1} (T f64, f32), "
        f"{k + p1 - 1} (T f64, f32), 640, ragged 231 (T f64, f32): "
        f"{errs['fused_gram_joint']}")
    ft, ff, fw, fX = fourier_gram_inputs(fcm, fx)
    nh, pf = ff.shape[0], fX.shape[1]
    span = float(ft.max() - ft.min())
    f100 = torch.arange(1, 101, dtype=torch.float64, device=dev) / span
    fg = (fourier.fourier_gram_cuda, fourier.fourier_gram_plain)
    errs["fourier_gram"] = [kernel_vs_plain("fourier_gram", *fg, ft, ff, fw,
                                            fX),
                            kernel_vs_plain("fourier_gram", *fg, ft, f100,
                                            fw, fX)]
    for freqs in (ff, f100):
        sig, twx = fourier.fourier_gram_cuda(ft, freqs, fw, fX)
        for a, b in ((0, 16), (96, 112), (160, pf)):
            s_, tw = fourier.fourier_gram_cuda(ft, freqs, fw,
                                               fX[:, a:b].contiguous())
            check(torch.equal(s_, sig) and torch.equal(tw, twx[:, a:b]),
                  f"fourier_gram on columns {a}..{b} of X differs from the "
                  f"same columns of one launch (k={freqs.shape[0]}, "
                  f"p={pf})")
    z40 = odd(200, 40)
    errs["fourier_apply"] = [kernel_vs_plain(
        "fourier_apply", fourier.fourier_apply_cuda,
        fourier.fourier_apply_plain, ft, f100, z40)]
    basis = basis_check(ft, f100)
    log(f"msp fourier kernels vs plain (k={nh}, p={pf}; k=100, p={pf}; "
        f"apply k=100, m=40): {errs['fourier_gram']} "
        f"{errs['fourier_apply']}; column slices bitwise equal to one "
        f"launch's columns; basis bitwise equal to basis32 at (n, k) = "
        f"{basis}")

    # timings at the wide shapes, as the bench shapes are timed
    times, bounds = {}, {}
    Ys = (torch.cat([T.float(), A.float()], dim=1)
          * torch.sqrt(w).float()[:, None]).contiguous()
    Yd = Ys.double()
    times["fused_gram_joint"] = time_kernel(
        lambda: fused_gram.fused_gram_joint_cuda(T, A, w),
        lambda: fused_gram.fused_gram_joint_plain(T, A, w),
        lambda: torch.matmul(Yd.T, Yd))
    times["fused_gram_joint"]["library_f32_ms"] = cuda_ms(
        lambda: torch.matmul(Ys.T, Ys))
    pass_times(times["fused_gram_joint"], "wide_")
    bounds["fused_gram_joint"] = gram_bound(T, A, w)
    # the reference's widest shape, q = 640
    T6, A6, w6 = odd(n, 128), odd(n, 512), weights(n)
    q640 = dict(ms=cuda_ms(lambda: fused_gram.fused_gram_joint_cuda(T6, A6,
                                                                   w6)))
    q640["device_ms"], parts = device_ms(
        lambda: fused_gram.fused_gram_joint_cuda(T6, A6, w6))
    q640["device_parts"] = {k_[:40]: v for k_, v in parts.items()}
    pass_times(q640, "wide_")
    del q640["device_parts"]
    q640["bound_ms"] = gram_bound(T6, A6, w6)[0]
    # its library yardstick, timed as at the other shapes: the f64 GEMM of
    # the same weighted f32 Y
    Y6 = (torch.cat([T6.float(), A6.float()], dim=1)
          * torch.sqrt(w6).float()[:, None]).double().contiguous()
    q640["library_ms"] = cuda_ms(lambda: torch.matmul(Y6.T, Y6))
    q640["library_device_ms"], _ = device_ms(lambda: torch.matmul(Y6.T, Y6))
    del Y6
    times["fused_gram_joint"]["q640"] = q640
    Tf = fourier.basis32(ft, ff)
    Yf = (torch.cat([Tf, fX.float()], dim=1)
          * torch.sqrt(fw).float()[:, None]).double().contiguous()
    times["fourier_gram"] = time_kernel(
        lambda: fourier.fourier_gram_cuda(ft, ff, fw, fX),
        lambda: fourier.fourier_gram_plain(ft, ff, fw, fX),
        lambda: torch.matmul(Yf.T, Yf))
    times["fourier_gram"]["basis_build_ms"] = cuda_ms(
        lambda: fourier.basis32(ft, ff))
    pass_times(times["fourier_gram"], "gram_")
    bounds["fourier_gram"], _ = fourier_gram_bound(ft.shape[0], nh, pf)
    T100 = fourier.basis32(ft, f100)
    z40f = z40.float()
    times["fourier_apply"] = time_kernel(
        lambda: fourier.fourier_apply_cuda(ft, f100, z40),
        lambda: fourier.fourier_apply_plain(ft, f100, z40),
        lambda: torch.matmul(T100, z40f))
    times["fourier_apply"]["graph_ms"] = graph_ms(
        lambda: fourier.fourier_apply_cuda(ft, f100, z40))
    times["fourier_apply"]["library_graph_ms"] = graph_ms(
        lambda: torch.matmul(T100, z40f))
    bounds["fourier_apply"] = fourier_apply_bound(ft.shape[0], 100, 40)
    shapes = {"fused_gram_joint": [n, k, p1], "fourier_gram": [n, nh, pf],
              "fourier_apply": [n, 100, 40]}
    for name in KERNELS:
        log(f"msp {name} at (n, k, p) = {shapes[name]} (ms, median): "
            f"{times[name]}, bound {bounds[name]}")
    steps = {mode: host_ms(lambda m=mode: gauss_newton_step(cm, x, m),
                           reps=5, warm=1)
             for mode in ("mixed", "f64", "fourier")}
    log(f"msp step (ms, median, host clock to sync): {steps}; TOAs/s "
        f"{ {m: NTOA / (v / 1e3) for m, v in steps.items()} }")
    profile_step(cm, x, "mixed")
    for mode in ("mixed", "f64"):
        graph_check(f"msp {mode} step",
                    lambda x_, m=mode: gauss_newton_step(cm, x_, m), (x,),
                    steps[mode])
    return dict(launches=launches, errs=errs, times=times, bounds=bounds,
                shapes=shapes, gates=gates, steps=steps, r4=r4, par=par,
                toas=toas, gls=mixed)


def card_vs_cpu(label, par, ntoa, sim, fourier=True):
    """The card against the port on the CPU on a small copy of a pulsar,
    the CPU under the card's solve policy so both run the same
    algorithms: residuals within 1e-11 s, the f64 step and (``fourier``)
    the fourier step within 1e-8 (the same f32 basis values on both,
    correctly rounded sin/cos, and f64 sums on both: only the summation
    order differs).  -> the residuals' and the f64 step's gaps."""
    small = {}
    os.environ["PINT_TPU_TORCH_SOLVE_IR"] = "force"
    try:
        for d in ("cpu", "cuda"):
            m, t = make_test_pulsar(par, ntoa=ntoa, device="cpu",
                                    **{**SIM, **sim})
            c = m.compile(t, device=d)
            xs = c.x0()
            small[d] = (c.time_residuals(xs),
                        gls_step_woodbury(*step_inputs(c, xs))[0],
                        gls_step_woodbury_fourier(*fourier_inputs(c, xs))
                        if fourier else None)
    finally:
        del os.environ["PINT_TPU_TORCH_SOLVE_IR"]
    dres = float(torch.max(torch.abs(small["cuda"][0].cpu() - small["cpu"][0])))
    dstep = rel(small["cuda"][1], small["cpu"][1])
    if not fourier:
        log(f"{label}: card vs cpu at {ntoa} TOAs: residuals {dres!r} s, "
            f"f64 step {dstep!r}")
        check(dres <= 1e-11, f"card residuals differ from the CPU by {dres} s")
        check(dstep <= 1e-8, f"card f64 step differs from the CPU by {dstep}")
        return dict(resid_s=dres, f64_step_rel=dstep)
    (fdx_c, fcov_c, fchi_c, _), (fdx_h, fcov_h, fchi_h, _) = (
        small["cuda"][2], small["cpu"][2])
    fdx = rel(fdx_c, fdx_h)
    fchi = abs(float(fchi_c) - float(fchi_h)) / abs(float(fchi_h))
    log(f"{label}: card vs cpu at {ntoa} TOAs: residuals {dres!r} s, f64 "
        f"step {dstep!r}; fourier step dx {fdx!r}, chi2 {fchi!r}, cov "
        f"{rel(fcov_c, fcov_h)!r}")
    check(dres <= 1e-11, f"card residuals differ from the CPU by {dres} s")
    check(dstep <= 1e-8, f"card f64 step differs from the CPU by {dstep}")
    check(fdx <= 1e-8 and fchi <= 1e-8,
          f"card fourier step differs from the CPU by dx {fdx}, chi2 {fchi}")
    return dict(resid_s=dres, f64_step_rel=dstep, fourier_dx_rel=fdx)


def sigma_gap(label, par, ntoa, sim, ordering_bound=False):
    """The card's f64 step against the CPU's on a small copy of a pulsar,
    in units of each parameter's sigma (the CPU step's), printed for every
    parameter, with the CPU's yardsticks from the same run
    (``fitting/spread.py``): the largest gaps under eight permutations of
    the TOAs (summation order) and under three one-ulp shifts of every
    residual (rounding of the delays).  Gated (ROADMAP C R4): the card's
    step from the CPU's residuals within 10 times the largest ordering
    gap — past the residuals, the card differs by summation order only —
    and the card's whole step within the smallest rounding gap, or with
    ``ordering_bound`` (a system so ill-conditioned that summation order
    moves the CPU's own step past its rounding gap) within 10 times the
    largest ordering gap too.  -> the largest gap, its parameter, the gap
    relative to the step's largest component, the residuals' largest
    difference and the yardsticks."""
    m, t = make_test_pulsar(par, ntoa=ntoa, device="cpu", **{**SIM, **sim})
    host, card = m.compile(t, device="cpu"), m.compile(t, device="cuda")
    dx_c, sig, names = f64_step(host)
    dx_g, _, _ = f64_step(card)
    r_c = host.time_residuals(host.x0(), subtract_mean=False)
    r_g = card.time_residuals(card.x0(), subtract_mean=False)
    # r_g + (r_c - r_g) is r_c exactly: the card's step from the CPU's
    # residuals, everything after them on the card
    dx_gr, _, _ = f64_step(card, r_shift=r_c.cuda() - r_g)
    gap = torch.abs(dx_g - dx_c) / sig
    past_r = float(torch.max(torch.abs(dx_gr - dx_c) / sig))
    order = ordering_gaps(m, t, "cpu")
    rounding = rounding_gaps(m, t, "cpu")
    ranked = torch.argsort(gap, descending=True).tolist()
    log(f"{label}: card vs cpu f64 step at {ntoa} TOAs in sigma units, "
        f"every parameter (largest first): "
        f"{ {names[i]: float(gap[i]) for i in ranked} }")
    out = dict(max_gap_sigma=float(gap[ranked[0]]), worst=names[ranked[0]],
               rel=rel(dx_g, dx_c),
               resid_diff_s=float(torch.max(torch.abs(r_g.cpu() - r_c))),
               past_residuals_sigma=past_r, cpu_ordering_sigma=order,
               cpu_rounding_sigma=rounding,
               step_sigma=float(torch.max(torch.abs(dx_c) / sig)))
    log(f"{label}: {out}")
    check(past_r <= 10 * max(order),
          f"{label}: past the residuals the card's step is {past_r} sigma "
          f"off the CPU's, over 10x the ordering gap {max(order)}")
    limit = 10 * max(order) if ordering_bound else min(rounding)
    check(out["max_gap_sigma"] <= limit,
          f"{label}: the card's step is {out['max_gap_sigma']} sigma off the "
          f"CPU's, over {limit} (ordering_bound={ordering_bound})")
    return out


def value_gaps(model, other, names, sig):
    """|value - other's value| / sigma of each free parameter, from the
    internal values (epochs as day and double-double seconds)."""
    out = {}
    for n, s_ in zip(names, sig):
        a, b = model.params[n].internal(), other.params[n].internal()
        if isinstance(a, tuple):
            d = (a[0] - b[0]) * 86400.0 + (a[1] - b[1]).to_float()
        elif isinstance(a, HostDD):
            d = (a - b).to_float()
        else:
            d = a - b
        out[n] = abs(d) / float(s_)
    return out


def downhill_fit(label, make, cls, wide=None, graph=False):
    """One downhill fit through the default entry point, its launch counts
    at 0 just before it and read just after: it must be a ``cls``, be
    served by the native rung and end finite; ``wide`` True (False) says
    its proposals must launch ``fused_gram_joint`` on the wide (narrow)
    path, None that they launch no kernel.  Prints the iterations,
    ``converged``, chi2 from start to end, the last noise floor, the host
    time and the peak allocation; then times one proposal and one chi2
    ladder at the fitted state (host clock and device time) and the
    ladder's peak allocation; ``graph`` adds the graph check of one
    iteration at the fitted state.  -> (fitter, summary)."""
    f = make()
    check(type(f) is cls, f"{label}: auto_fitter gave {type(f).__name__}")
    chi2_0 = float(f._make_chi2()(f.cm.x0()))
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    chi2 = f.fit_toas()
    torch.cuda.synchronize()
    info = dict(niter=f.niter, converged=f.converged, chi2_start=chi2_0,
                chi2=chi2, noise_floor=f.last_noise_floor,
                wall_s=time.perf_counter() - t0, launches=read_counts(),
                max_memory_allocated=torch.cuda.max_memory_allocated())
    rep = f.guard_report
    # an iteration program replayed once an iteration, a proposal program
    # once for the final covariance
    info["programs"] = programs_ran(label, f.cm.programs, f.niter + 1, 2)
    log(f"{label} {type(f).__name__}: rung={rep.rung} {info}")
    check(rep.rung == "native" and not rep.fell_back,
          f"{label}: served by rung {rep.rung}: {rep.history}")
    check(math.isfinite(chi2), f"{label}: non-finite chi2")
    n_gram = info["launches"]["fused_gram_joint"]
    n_wide = info["launches"]["fused_gram_joint wide"]
    if wide is None:
        check(n_gram == 0, f"{label}: fused_gram_joint launched {n_gram}")
    else:
        check(n_gram >= f.niter > 0 and n_wide == (n_gram if wide else 0),
              f"{label}: fused_gram_joint launched {n_gram} times ({n_wide} "
              f"wide) in {f.niter} iterations")
    # one iteration's parts at the fitted state
    x = f.cm.x0()
    proposal = f._make_proposal()
    ladder, lams = f._make_ladder(f._make_chi2(), _ladder_lams(1e-3)[2])
    dx = proposal(x)[0]
    parts = dict(lambdas=len(lams),
                 proposal_ms=host_ms(lambda: proposal(x), reps=3, warm=1),
                 ladder_ms=host_ms(lambda: ladder(x, dx), reps=3, warm=1))
    parts["proposal_device_ms"], _ = device_ms(lambda: proposal(x), calls=1,
                                               warm=False)
    parts["ladder_device_ms"], _ = device_ms(lambda: ladder(x, dx), calls=1,
                                             warm=False)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ladder(x, dx)
    torch.cuda.synchronize()
    parts["ladder_peak_extra_bytes"] = torch.cuda.max_memory_allocated() - base
    info["iteration"] = parts
    log(f"{label}: one iteration at the fitted state (ms, median; device "
        f"ms from the profiler): {parts}")
    if graph:
        it, _, chi2_fn = f._make_iteration(False, 1e-2, 1e-2, 1e-3)
        false = torch.zeros((), dtype=torch.bool, device=x.device)
        args = (x, chi2_fn(x), false, false)
        graph_check(f"{label} {type(f).__name__} iteration", it, args,
                    host_ms(lambda: it(*args), reps=3, warm=1))
    return f, info


def host_loop_parity(label, make, fused):
    """The same fit by the host loop (PINT_TPU_TORCH_DOWNHILL_FUSED=0): the
    same iterations, chi2 within 1e-8 relative of the fused loop's."""
    os.environ["PINT_TPU_TORCH_DOWNHILL_FUSED"] = "0"
    try:
        f = make()
        chi2 = f.fit_toas()
    finally:
        del os.environ["PINT_TPU_TORCH_DOWNHILL_FUSED"]
    d = abs(chi2 - fused["chi2"]) / abs(fused["chi2"])
    log(f"{label}: host loop niter={f.niter} chi2={chi2!r} (fused "
        f"{fused['niter']}, {fused['chi2']!r}; rel {d!r})")
    check(f.niter == fused["niter"] and d <= 1e-8,
          f"{label}: host loop took {f.niter} iterations to chi2 {chi2}, the "
          f"fused loop {fused['niter']} to {fused['chi2']}")
    return dict(niter=f.niter, chi2=chi2, chi2_rel=d)


def white_par(ndmx):
    """The binary MSP's par text without its red noise."""
    return "".join(ln + "\n" for ln in msp_par(ndmx, seed=0).splitlines()
                   if not ln.startswith("TNRED"))


def white_msp(dev):
    """The binary MSP without red noise at 1e5 TOAs: auto_fitter gives the
    downhill WLS fitter (QR on the card) and, with downhill=False, the WLS
    fitter; their values within 1e-3 sigma.  The QR gate at the par values
    is printed.  On a 2048-TOA copy, _wls_step(method='qr') on the card
    within 1e-8 of the CPU's."""
    par = white_par(MSP_NDMX)
    model, toas = make_test_pulsar(par, ntoa=NTOA, device=dev, **MSP_SIM)
    cm = model.compile(toas, device=dev)
    r, M, Nd, _, _ = step_inputs(cm, cm.x0())
    sw = torch.sqrt(1.0 / Nd)  # as _wls_step weights the design
    A = (M / _column_norms(M * sw[:, None])[None, :]) * sw[:, None]
    ok, ratio, cond = _qr_gate(torch.linalg.qr(A)[1])
    gate = dict(rank_ok=bool(ok), diag_ratio=float(ratio),
                cond_est=float(cond))
    log(f"white msp: design {tuple(M.shape)}, QR gate at the par values "
        f"{gate} ({'qr' if gate['rank_ok'] else 'routed to gram'})")
    del cm, r, M, Nd, A
    f, info = downhill_fit("white msp", lambda: auto_fitter(toas, model),
                           DownhillWLSFitter, graph=True)
    check(f.converged, "white msp: the downhill WLS fit did not converge")
    w = auto_fitter(toas, get_model(par), downhill=False)
    check(type(w) is WLSFitter, f"white msp: got {type(w).__name__}")
    t0 = time.perf_counter()
    w_chi2 = w.fit_toas()
    torch.cuda.synchronize()
    info["wls"] = dict(chi2=w_chi2, converged=w.converged,
                       wall_s=time.perf_counter() - t0,
                       rung=w.guard_report.rung, qr_gate=w.qr_gate,
                       programs=programs_ran("white msp WLSFitter",
                                             w.cm.programs, w.steps_taken, 1))
    check(w.guard_report.rung == "cuda-qr", f"WLS rung {w.guard_report.rung}")
    sig = np.sqrt(np.diag(w.parameter_covariance_matrix))
    gaps = value_gaps(f.model, w.model, f.cm.free_names, sig)
    worst = max(gaps, key=gaps.get)
    info["vs_wls_sigma"] = {"max": gaps[worst], "worst": worst}
    log(f"white msp: WLSFitter {info['wls']}; downhill vs WLS "
        f"{info['vs_wls_sigma']}")
    check(gaps[worst] <= 1e-3, f"white msp: downhill and WLS differ by "
          f"{gaps[worst]} sigma on {worst}")
    info["qr_gate"] = gate
    # the QR step, card against CPU, on a small copy
    m2, t2 = make_test_pulsar(white_par(MSP_SMALL["ndmx"]),
                              ntoa=MSP_SMALL["ntoa"], device="cpu", **MSP_SIM)
    res = {}
    for d in ("cpu", "cuda"):
        c = m2.compile(t2, device=d)
        r2, M2, Nd2, _, _ = step_inputs(c, c.x0())
        res[d] = _wls_step(r2, M2, 1.0 / Nd2, method="qr")
    small = dict(dx_rel=rel(res["cuda"][0], res["cpu"][0]),
                 cov_rel=rel(res["cuda"][1], res["cpu"][1]),
                 nbad=(int(res["cuda"][2]), int(res["cpu"][2])))
    log(f"white msp copy at {MSP_SMALL['ntoa']} TOAs: qr step card vs cpu "
        f"{small}")
    check(small["dx_rel"] <= 1e-8 and small["cov_rel"] <= 1e-8
          and small["nbad"] == (0, 0), f"qr step card vs cpu {small}")
    info["qr_card_vs_cpu"] = small
    return info


def entry_point_phase(bench_toas, msp):
    """The default entry point, ``auto_fitter(toas, model)``, at 1e5 TOAs:
    downhill GLS on bench.py's pulsar (its proposals through
    ``fused_gram_joint``) and on the binary MSP (through the wide path;
    it starts at the truth, must converge and land within 1e-3 sigma of
    the GLSFitter fit of phase 6), each against its host loop; then the
    white MSP by downhill WLS and WLS.  -> what the kernels line reports."""
    out = {}

    def bench():
        return auto_fitter(bench_toas, get_model(BENCH_PAR))

    def binary():
        return auto_fitter(msp["toas"], get_model(msp["par"]))

    _, out["bench"] = downhill_fit("bench", bench, DownhillGLSFitter,
                                   wide=False, graph=True)
    out["bench"]["host_loop"] = host_loop_parity("bench", bench, out["bench"])
    f, out["msp"] = downhill_fit("msp", binary, DownhillGLSFitter, wide=True)
    check(f.converged, "msp: the downhill GLS fit did not converge")
    gls = msp["gls"]
    gaps = value_gaps(f.model, gls.model, f.cm.free_names,
                      np.sqrt(np.diag(gls.parameter_covariance_matrix)))
    worst = max(gaps, key=gaps.get)
    out["msp"]["vs_gls_sigma"] = {"max": gaps[worst], "worst": worst}
    log(f"msp: downhill vs GLSFitter {out['msp']['vs_gls_sigma']}")
    check(gaps[worst] <= 1e-3, f"msp: downhill and GLSFitter differ by "
          f"{gaps[worst]} sigma on {worst}")
    out["msp"]["host_loop"] = host_loop_parity("msp", binary, out["msp"])
    out["white_msp"] = white_msp(torch.device("cuda"))
    return out


#: the components the full-width pulsar does not carry, each in the par
#: file of the golden set that holds it
GOLDEN_DIR = Path(__file__).resolve().parent / "tests" / "datafile"
COMPONENT_PARS = {
    "glitch, wave, ifunc (BT)": "golden7",
    "chromatic CM, WaveX, DMWaveX, CMWaveX": "golden19",
    "SWX, piecewise spindown, FD, FDJUMP": "golden20",
}


def component_pars():
    """label -> par text of the components phase 8 holds card vs CPU:
    COMPONENT_PARS's golden files, and bench.py's pulsar with the
    troposphere."""
    out = {label: (GOLDEN_DIR / f"{stem}.par").read_text()
           for label, stem in COMPONENT_PARS.items()}
    out["troposphere (bench.py's pulsar)"] = (BENCH_PAR
                                              + "CORRECT_TROPOSPHERE Y\n")
    return out


def troposphere_masks(n, rng):
    """The troposphere's per-TOA geometry columns, drawn from the seed:
    source elevations 10-90 degrees, observatory latitudes within +-60
    degrees (both hemispheres, the seasonal phase's two branches), and
    altitudes up to 2.5 km, days of year over a whole year."""
    return {"TROPO:sin_elev": np.sin(np.radians(rng.uniform(10.0, 90.0, n))),
            "TROPO:lat": np.radians(rng.uniform(-60.0, 60.0, n)),
            "TROPO:alt": rng.uniform(0.0, 2500.0, n),
            "TROPO:doy": rng.uniform(0.0, 365.25, n)}


def components_card_vs_cpu(rng, ntoa=2048):
    """Each of ``component_pars()`` on a pulsar simulated by the port (the orbit
    inside its phases, the Sun at the barycentre for SWX), the card
    against the CPU: residuals within 1e-11 s, every design column within
    1e-9 of its own max; and on the card its GLS step (the card's mode)
    captured as a step program, bitwise equal to the eager step.
    -> label -> (residual gap s, worst column)."""
    out = {}
    for label, par in component_pars().items():
        m, t = make_test_pulsar(par, ntoa=ntoa, device="cpu", **MSP_SIM)
        if "troposphere" in label:
            t["masks"] = troposphere_masks(ntoa, rng)
        res = {}
        for d in ("cpu", "cuda"):
            c = m.compile(t, device=d)
            xs = c.x0()
            res[d] = (c.time_residuals(xs).cpu(), c.design_matrix(xs).cpu())
            if d == "cuda":
                mode = default_accel_mode(c)
                graph_equal(f"{label} {mode} step",
                            lambda x_, c=c, m=mode: gauss_newton_step(c, x_,
                                                                      m),
                            (xs,))
        dres = float(torch.max(torch.abs(res["cuda"][0] - res["cpu"][0])))
        scale = torch.clamp_min(torch.max(torch.abs(res["cpu"][1]), dim=0)
                                .values, 1e-300)
        dcol = float(torch.max(torch.max(torch.abs(res["cuda"][1]
                                                   - res["cpu"][1]), dim=0)
                               .values / scale))
        if "troposphere" in label:
            tropo = m.components["TroposphereDelay"].delay_term(
                None, m.compile(t, device="cpu").bundle, None)
            check(float(torch.min(tropo)) > 0.0,
                  "the troposphere delay is zero at some TOA")
        log(f"{label}: card vs cpu at {ntoa} TOAs: residuals {dres!r} s, "
            f"worst design column {dcol!r} of its max "
            f"({res['cpu'][1].shape[1]} columns); the graphed step bitwise "
            "equal to eager")
        check(dres <= 1e-11, f"{label}: card residuals off by {dres} s")
        check(dcol <= 1e-9, f"{label}: card design column off by {dcol}")
        out[label] = dict(resid_s=dres, design_col_rel=dcol)
    return out


def full_width_phase(dev, rng):
    """The full-width pulsar (``msp_full_par``: q = 350) at 1e5 TOAs, and
    the card against the CPU on the components it does not carry.
    -> what the kernels line reports."""
    par = msp_full_par(MSP_NDMX, seed=0)
    t0 = time.perf_counter()
    model, toas = make_test_pulsar(par, ntoa=NTOA, device=dev, **MSP_SIM)
    log(f"full: simulated {NTOA} TOAs in {time.perf_counter() - t0:.2f} s")
    gls, gls_l = drive("mixed", lambda: GLSFitter(toas, model, device=dev),
                       "full")
    check(gls_l["fused_gram_joint wide"] == gls_l["fused_gram_joint"],
          f"the full-width joint Gram left the wide path: {gls_l}")
    try:
        GLSFitter(toas, get_model(par), device=dev,
                  fused=True).fit_toas(maxiter=1)
    except PintTpuError as e:
        refused = str(e)
    else:
        raise AssertionError("GLSFitter(fused=True) was not refused on the "
                             "full-width pulsar")
    log(f"full: GLSFitter(fused=True) refused: {refused}")
    _, downhill = downhill_fit(
        "full", lambda: auto_fitter(toas, get_model(par)), DownhillGLSFitter,
        wide=True)

    cm = get_model(par).compile(toas, device=dev)
    x = cm.x0()
    args = step_inputs(cm, x)
    log(f"full shapes: n={args[1].shape[0]} design columns "
        f"{args[1].shape[1]} basis {args[3].shape[1]}")
    check(args[1].shape[1] == 169 and args[3].shape[1] == 180,
          f"full-width shapes {tuple(args[1].shape)} {tuple(args[3].shape)}")
    gates = step_gates("full mixed",
                       gls_step_woodbury_mixed(*args, normalized_cov=True),
                       gls_step_woodbury(*args, normalized_cov=True))
    small = card_vs_cpu("full", msp_full_par(MSP_SMALL["ndmx"], seed=0),
                        MSP_SMALL["ntoa"], {"freqs": MSP_FREQS},
                        fourier=False)

    T, A, w = gram_inputs(cm, x)
    n, k = T.shape
    p1 = A.shape[1]
    check(k + p1 == 350, f"full-width joint Gram q = {k + p1}")
    fj = (fused_gram.fused_gram_joint_cuda, fused_gram.fused_gram_joint_plain)
    errs = [kernel_vs_plain("fused_gram_joint", *fj, T, A, w),
            kernel_vs_plain("fused_gram_joint", *fj, T.float(), A, w)]
    log(f"full fused_gram_joint vs plain at q = 350 (T f64, f32): {errs}")
    Ys = (torch.cat([T.float(), A.float()], dim=1)
          * torch.sqrt(w).float()[:, None]).contiguous()
    Yd = Ys.double()
    times = time_kernel(lambda: fused_gram.fused_gram_joint_cuda(T, A, w),
                        lambda: fused_gram.fused_gram_joint_plain(T, A, w),
                        lambda: torch.matmul(Yd.T, Yd))
    times["library_f32_ms"] = cuda_ms(lambda: torch.matmul(Ys.T, Ys))
    pass_times(times, "wide_")
    del times["device_parts"], Ys, Yd
    bnd = gram_bound(T, A, w)
    log(f"full fused_gram_joint at (n, k, p1) = {[n, k, p1]} (ms, median): "
        f"{times}, bound {bnd}")
    steps = {mode: host_ms(lambda m=mode: gauss_newton_step(cm, x, m),
                           reps=5, warm=1)
             for mode in ("mixed", "f64")}
    log(f"full step (ms, median, host clock to sync): {steps}")
    graph_check("full mixed step",
                lambda x_: gauss_newton_step(cm, x_, "mixed"), (x,),
                steps["mixed"])
    comps = components_card_vs_cpu(rng)
    entry = dict(
        shape=[n, k, p1],
        launches=gls_l["fused_gram_joint"] + downhill["launches"][
            "fused_gram_joint"],
        launches_by_fit={"gls": gls_l["fused_gram_joint"],
                         "downhill_gls": downhill["launches"][
                             "fused_gram_joint"]},
        max_abs_err=max(e[0] for e in errs),
        max_err_vs_plain=max(e[1] for e in errs),
        bound_ms=bnd[0], bound_by=bnd[1], **times,
        gls_fit=dict(steps=gls.steps_taken, chi2=gls.chi2,
                     rung=gls.guard_report.rung),
        downhill_fit={key: downhill[key] for key in (
            "niter", "converged", "chi2_start", "chi2", "wall_s",
            "max_memory_allocated")},
        vs_f64=gates, step_ms=steps, card_vs_cpu=small,
        components_card_vs_cpu=comps, fused_refused=refused)
    return entry


#: the wideband MSP (``msp_wideband_par``) and its DM measurements' error
#: (golden4's and golden17's -pp_dme, pc cm^-3)
WB_DM_ERROR = 2e-4
#: the PTA batch: 45 pulsars of msp_par's composition at 100 DMX ranges,
#: 4000-10000 TOAs each (BASELINE.json config 5, the NANOGrav 12.5-yr
#: batch), and the three pulsars held to their own GLSFitter steps
PTA_NPSR, PTA_NDMX, PTA_NMIN, PTA_NMAX = 45, 100, 4000, 10_000
PTA_OWN = 3


def gram_time(label, T, A, w, batched=False):
    """A Gram kernel call timed as the kernels line reports it: CUDA
    events and profiler device time of the kernel, its plain version and
    its library yardstick (one f64 GEMM, a torch.bmm for a batch, of the
    same weighted f32 Y), beside its bound from these inputs."""
    Ys = (torch.cat([T.float(), A.float()], dim=-1)
          * torch.sqrt(w).float()[..., None]).contiguous()
    Yd = Ys.double()
    lib = ((lambda: torch.bmm(Yd.transpose(1, 2), Yd)) if batched
           else (lambda: torch.matmul(Yd.T, Yd)))
    times = time_kernel(lambda: fused_gram.fused_gram_joint_cuda(T, A, w),
                        lambda: fused_gram.fused_gram_joint_plain(T, A, w),
                        lib)
    pass_times(times, "wide_" if T.shape[-1] + A.shape[-1] > 80
               else "fused_gram_")
    del times["device_parts"], Ys, Yd
    times["bound_ms"], times["bound_by"] = gram_bound(T, A, w)
    shape = [*T.shape[:-1], T.shape[-1], A.shape[-1]]
    log(f"{label} fused_gram_joint at {shape} (ms, median): {times}")
    return times


def wideband_phase(dev):
    """Phase 9: the wideband MSP (``msp_wideband_par``: the binary MSP
    plus a free DMJUMP, DMEFAC and DMEQUAD) at 1e5 TOAs with DM
    measurements, 2e5 stacked rows.  -> what the kernels line reports."""
    par = msp_wideband_par(MSP_NDMX, seed=0)
    t0 = time.perf_counter()
    model, toas = make_test_pulsar(par, ntoa=NTOA, device=dev,
                                   dm_error=WB_DM_ERROR, **MSP_SIM)
    log(f"wideband: simulated {NTOA} TOAs in {time.perf_counter() - t0:.2f} s")
    down, downhill = downhill_fit(
        "wideband", lambda: auto_fitter(toas, model), WidebandDownhillFitter,
        wide=True)
    shape = fused_gram.fused_gram_joint_cuda.last_shape
    check(shape == (1, 2 * NTOA, 60, 170),
          f"wideband downhill: the last Gram launch had shape {shape}")
    toa_fit, toa_l = drive(
        "mixed", lambda: WidebandTOAFitter(toas, get_model(par), device=dev),
        "wideband")
    check(toa_l["fused_gram_joint wide"] == toa_l["fused_gram_joint"]
          and fused_gram.fused_gram_joint_cuda.last_shape == shape,
          f"the wideband joint Gram left the wide path at n = 2e5: {toa_l}")

    f = WidebandTOAFitter(toas, get_model(par), device=dev)
    x = f.cm.x0()
    r, M, Nd = f._step_inputs(x)
    T, phi = f._step_noise(x)
    log(f"wideband shapes: rows {M.shape[0]} design columns {M.shape[1]} "
        f"basis {T.shape[1]}")
    gates = step_gates("wideband mixed",
                       gls_step_woodbury_mixed(r, M, Nd, T, phi,
                                               normalized_cov=True),
                       gls_step_woodbury(r, M, Nd, T, phi,
                                         normalized_cov=True), ntoa=NTOA)
    X = torch.cat([M / _column_norms(M)[None, :], r[:, None]], dim=1)
    Tc, Xc, wc = T.contiguous(), X.contiguous(), (1.0 / Nd).contiguous()
    check(torch.all(Tc[NTOA:] == 0), "the DM block's basis rows are not zero")
    err = kernel_vs_plain("fused_gram_joint", fused_gram.fused_gram_joint_cuda,
                          fused_gram.fused_gram_joint_plain, Tc, Xc, wc)
    log(f"wideband fused_gram_joint vs plain at (n, k, p1) = "
        f"{[Tc.shape[0], Tc.shape[1], Xc.shape[1]]}: {err}")
    times = gram_time("wideband", Tc, Xc, wc)
    del f, r, M, Nd, T, X, Tc, Xc, wc
    steps = {mode: host_ms(lambda m=mode: toa_fit._gn_step(
        toa_fit.cm.x0(), m), reps=5, warm=1) for mode in ("mixed", "f64")}
    log(f"wideband step (ms, median, host clock to sync): {steps}")
    graph_check("wideband mixed step",
                lambda x_: toa_fit._gn_step(x_, "mixed"),
                (toa_fit.cm.x0(),), steps["mixed"])

    # a 2048-TOA copy: the card against the CPU
    m2, t2 = make_test_pulsar(msp_wideband_par(MSP_SMALL["ndmx"], seed=0),
                              ntoa=MSP_SMALL["ntoa"], device="cpu",
                              dm_error=WB_DM_ERROR, **MSP_SIM)
    res = {}
    for d in ("cpu", "cuda"):
        fw = WidebandTOAFitter(t2, m2, device=d, fused=False)
        xs = fw.cm.x0()
        inputs = fw._step_inputs(xs)
        res[d] = (fw.cm.time_residuals(xs).cpu(),
                  fw.cm.dm_residuals(xs).cpu(),
                  gls_step_woodbury(*inputs, *fw._step_noise(xs))[0])
    small = dict(
        resid_s=float(torch.max(torch.abs(res["cuda"][0] - res["cpu"][0]))),
        dm_resid=float(torch.max(torch.abs(res["cuda"][1] - res["cpu"][1]))),
        f64_step_rel=rel(res["cuda"][2], res["cpu"][2]))
    log(f"wideband: card vs cpu at {MSP_SMALL['ntoa']} TOAs: {small}")
    check(small["resid_s"] <= 1e-11 and small["dm_resid"] <= 1e-12
          and small["f64_step_rel"] <= 1e-8,
          f"wideband card vs cpu outside 1e-11 s, 1e-12, 1e-8: {small}")
    launches = downhill["launches"]["fused_gram_joint"] + toa_l[
        "fused_gram_joint"]
    return dict(
        shape=[2 * NTOA, 60, 170], launches=launches,
        launches_by_fit={"downhill": downhill["launches"]["fused_gram_joint"],
                         "toa_fitter": toa_l["fused_gram_joint"]},
        max_abs_err=err[0], max_err_vs_plain=err[1], **times,
        downhill_fit={key: downhill[key] for key in (
            "niter", "converged", "chi2_start", "chi2", "wall_s",
            "max_memory_allocated")},
        toa_fit=dict(steps=toa_fit.steps_taken, chi2=toa_fit.chi2,
                     rung=toa_fit.guard_report.rung),
        vs_f64=gates, step_ms=steps, card_vs_cpu=small)


def pta_phase(dev, rng):
    """Phase 10: the PTA batch, 45 pulsars of ``pta_pars`` (each its own
    F0, F1, sky position, DM, DMX values, PEPOCH and orbit) with
    ``pta_ntoas`` TOAs each, padded to 1e4.  -> what the kernels line
    reports."""
    t0 = time.perf_counter()
    ntoas = pta_ntoas(PTA_NPSR, seed=0, nmin=PTA_NMIN, nmax=PTA_NMAX)
    pulsars = [make_test_pulsar(par, ntoa=int(n), device=dev,
                                **{**MSP_SIM, "seed": i})
               for i, (par, n) in enumerate(zip(
                   pta_pars(PTA_NPSR, PTA_NDMX, seed=0), ntoas))]
    cms = [m.compile(t, device=dev) for m, t in pulsars]
    log(f"pta: simulated {PTA_NPSR} pulsars, {int(ntoas.sum())} TOAs "
        f"({int(ntoas.min())}-{int(ntoas.max())} each) in "
        f"{time.perf_counter() - t0:.2f} s")
    batch = PTABatch(cms)
    check(batch.ntoa == PTA_NMAX and len(batch.free_names) == 117,
          f"pta batch: {batch.ntoa} TOAs, {len(batch.free_names)} free")

    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    xs, chi2 = batch.fit(maxiter=3, mode="mixed")
    torch.cuda.synchronize()
    fit = dict(steps=batch.steps_taken, wall_s=time.perf_counter() - t0,
               launches=read_counts(),
               last_shape=fused_gram.fused_gram_joint_cuda.last_shape,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               chi2_min=float(chi2.min()), chi2_max=float(chi2.max()),
               programs=dict(replays=batch.programs.replays,
                             captures=batch.programs.captures,
                             capture_s=batch.programs.capture_s,
                             pool_reserved=batch.programs.pool_reserved))
    log(f"pta mixed fit(maxiter=3): {fit}")
    n_gram = fit["launches"]["fused_gram_joint"]
    # the 4 batched steps are replays of one program, captured once after
    # a warm-up call: one launch each, and one in the warm-up
    check(fit["programs"]["replays"] == fit["steps"] == 4
          and fit["programs"]["captures"] == 1,
          f"pta: step programs {fit['programs']} in {fit['steps']} steps")
    check(n_gram == fit["launches"]["fused_gram_joint batched"]
          == fit["steps"] + 1
          and fit["launches"]["fused_gram_joint wide"] == n_gram
          and fit["launches"]["fourier_gram"] == 0,
          f"pta: {fit['launches']} launches in {fit['steps']} batched steps")
    batch.programs.clear()
    check(fit["last_shape"] == (PTA_NPSR, PTA_NMAX, 60, 119),
          f"pta: the batched launch had shape {fit['last_shape']}")
    check(bool(torch.all(torch.isfinite(chi2))) and bool(
        torch.all(torch.isfinite(xs))), "pta: non-finite fit")
    check(np.all(np.isfinite(batch.cov)) and np.all(
        np.diagonal(batch.cov, axis1=1, axis2=2) > 0),
        "pta: non-finite or non-positive covariance")

    # one batched step, mixed against f64, pulsar by pulsar
    x0 = batch.x0()
    step_ms = {mode: host_ms(lambda m=mode: batch.fit_step(x0, mode=m),
                             reps=3, warm=1) for mode in ("mixed", "f64")}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        batch.fit_step(x0, mode="mixed")
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    # a lower bound: the profiler drops some events of a window
    step_dev_ms = sum(e.device_time for e in kernels) / 1e3
    log(f"pta batched step (ms, median, host clock to sync): {step_ms}; "
        f"mixed step device time >= {step_dev_ms!r} ms over "
        f"{len(kernels)} recorded kernels")
    graph_check(f"pta mixed step ({PTA_NPSR} pulsars)",
                batch._step_fn("mixed"), (x0,), step_ms["mixed"])
    xm, cm_, (cvm, nm) = batch.fit_step(x0, mode="mixed")
    xf, cf_, (cvf, nf) = batch.fit_step(x0, mode="f64")
    worst = {}
    for i in range(PTA_NPSR):
        g = step_gates(f"pta pulsar {i} mixed",
                       (xm[i], (cvm[i], nm[i]), cm_[i], None),
                       (xf[i], (cvf[i], nf[i]), cf_[i], None),
                       ntoa=int(ntoas[i]))
        for key, v in g.items():
            worst[key] = max(worst.get(key, 0.0), v)
    log(f"pta mixed vs f64 step, worst over the pulsars: {worst}")

    # three pulsars: each one's batched f64 step against its own
    # GLSFitter step on the card
    three = PTABatch(cms[:PTA_OWN])
    x3, c3, _ = three.fit_step(three.x0(), mode="f64")
    own = []
    for i, (m, t) in enumerate(pulsars[:PTA_OWN]):
        g = GLSFitter(t, m, device=dev, fused=False)
        xn, _, c, _ = g._gn_step(g.cm.x0(), "f64")
        own.append(dict(dx_rel=rel(x3[i], xn),
                        chi2_rel=abs(float(c3[i]) - float(c)) / abs(float(c))))
    log(f"pta: batched f64 step vs each pulsar's own GLSFitter step: {own}")
    check(all(o["dx_rel"] <= 1e-8 and o["chi2_rel"] <= 1e-8 for o in own),
          f"pta batched step off the pulsars' own steps: {own}")
    del three, x3, c3

    # the batched kernel at the composition's shape (the step's own
    # operands) and at the bench shape (q = 67, the narrow path)
    def operands(cm, x):
        r, M, Nd, T, _ = step_inputs(cm, x)
        X = torch.cat([M / _column_norms(M)[None, :], r[:, None]], dim=1)
        return T, X, 1.0 / Nd

    T, A, w = (v.contiguous() for v in batch._vmapped(operands)(x0))
    Tb = torch.as_tensor(rng.standard_normal((PTA_NPSR, PTA_NMAX, 60)),
                         device=dev)
    Ab = torch.as_tensor(rng.standard_normal((PTA_NPSR, PTA_NMAX, 7)),
                         device=dev)
    wb = torch.as_tensor(rng.uniform(0.0, 2.0, (PTA_NPSR, PTA_NMAX)),
                         device=dev)
    kernel = {}
    for label, (T_, A_, w_) in (("composition", (T, A, w)),
                                ("bench", (Tb, Ab, wb))):
        err = kernel_vs_plain("fused_gram_joint batched",
                              fused_gram.fused_gram_joint_cuda,
                              fused_gram.fused_gram_joint_plain, T_, A_, w_)
        got = fused_gram.fused_gram_joint_cuda(T_, A_, w_)
        single = 0.0
        for i in range(PTA_NPSR):
            one = fused_gram.fused_gram_joint_cuda(T_[i], A_[i], w_[i])
            for o, g in zip(one, got):
                d = float(torch.max(torch.abs(o - g[i])))
                scale = float(torch.max(torch.abs(o)))
                check(d <= 3e-6 * scale, f"pta {label}: pulsar {i}'s batched "
                      f"Gram off its single launch by {d} of {scale}")
                single = max(single, d / scale)
        times = gram_time(f"pta {label}", T_, A_, w_, batched=True)
        kernel[label] = dict(shape=[PTA_NPSR, PTA_NMAX, T_.shape[-1],
                                    A_.shape[-1]],
                             max_abs_err=err[0], max_err_vs_plain=err[1],
                             max_err_vs_single=single, **times)
        log(f"pta {label}: batched vs plain {err}, vs single launches "
            f"{single!r}")
    return dict(launches=n_gram,
                npulsars=PTA_NPSR, ntoas=[int(v) for v in ntoas], fit=fit,
                step_ms=step_ms, step_device_ms=step_dev_ms,
                mixed_vs_f64_worst=worst, own_steps=own,
                **kernel["composition"], bench_shape=kernel["bench"])


#: phase 11: the dense steps' sizes, the Cholesky timings' sizes, and the
#: MSP and wideband MSP sizes of the dense fits (the wideband's stacked
#: system has twice its TOAs as rows)
DENSE_NS = (16384, 32768)
CHOL_NS = (8192, 16384, 32768)
DENSE_MSP_NTOA = 16384
DENSE_WB_NTOA = 8192
#: phase 12: TOAs appended after the stream's init, in appends of
STREAM_TAIL = 640
STREAM_CHUNK = 64


def event_ms(fn, reps=3):
    """One call's CUDA-event time and host time (medians of ``reps``
    single calls after a warm-up) and the peak allocation a call adds
    above what was allocated before it."""
    fn()
    torch.cuda.synchronize()
    ts, hs = [], []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        fn()
        e.record()
        e.synchronize()
        hs.append((time.perf_counter() - t0) * 1e3)
        ts.append(s.elapsed_time(e))
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return dict(ms=statistics.median(ts), host_ms=statistics.median(hs),
                peak_extra_bytes=torch.cuda.max_memory_allocated() - base)


def equilibrated_cov(T, phi, Nd, dtype):
    """The bench pulsar's equilibrated covariance D^-1/2 C D^-1/2 = W W^T
    with a unit diagonal, as ``woodbury_chol_solve_ir`` forms it."""
    dinv = 1.0 / torch.sqrt(Nd + torch.sum(T * T * phi[None, :], dim=1))
    W = (T * torch.sqrt(phi)[None, :] * dinv[:, None]).to(dtype)
    C = W @ W.T
    C.diagonal().fill_(1.0)
    return C


def cholesky_times(T, phi, Nd):
    """The factorizations of the dense step at n = 8192, 16384 and 32768
    (the bench pulsar's first n rows' equilibrated covariance): the
    native ``cholesky_ex`` in f32 and f64, ``fast_cholesky32`` and
    ``blocked_cholesky`` in f64, each beside its bound n^3/3 flop at the
    67 TFLOP/s f64 tensor-core peak; the blocked factors against the
    native ones; and ``solve_policy.ir_cholesky``'s route against the
    faster f32 factor of this run.  -> {n: times}."""
    out = {}
    for n in CHOL_NS:
        C32 = equilibrated_cov(T[:n], phi, Nd[:n], torch.float32)
        row = {"native_f32": event_ms(lambda: nan_cholesky(C32)),
               "fast_cholesky32": event_ms(lambda: fast_cholesky32(C32))}
        L32, Lb32 = nan_cholesky(C32), fast_cholesky32(C32)
        row["fast_vs_native_f32"] = rel(Lb32, L32)
        del L32, Lb32
        C64 = C32.double()
        del C32
        row["native_f64"] = event_ms(lambda: nan_cholesky(C64))
        row["blocked_f64"] = event_ms(lambda: blocked_cholesky(C64))
        L64, Lb64 = nan_cholesky(C64), blocked_cholesky(C64)
        row["blocked_vs_native_f64"] = rel(Lb64, L64)
        del C64, L64, Lb64
        row["bound_ms"] = n ** 3 / 3 / F64_TC_FLOPS * 1e3
        fast = row["fast_cholesky32"]["ms"] < row["native_f32"]["ms"]
        routed = solve_policy.ir_cholesky(n, T.device) is fast_cholesky32
        row["ir_cholesky"] = "fast_cholesky32" if routed else "native"
        log(f"cholesky n={n} (ms; bound {row['bound_ms']:.2f}): {row}")
        check(math.isfinite(row["fast_vs_native_f32"])
              and math.isfinite(row["blocked_vs_native_f64"]),
              f"a factor at n = {n} is not finite")
        check(row["blocked_vs_native_f64"] <= 1e-10,
              f"blocked_cholesky differs from the native f64 factor by "
              f"{row['blocked_vs_native_f64']} at n = {n}")
        check(routed == fast,
              f"ir_cholesky({n}) routes to {row['ir_cholesky']}, but this "
              f"run measured fast_cholesky32 "
              f"{'faster' if fast else 'slower'} than the native factor")
        out[n] = row
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dense_steps(label, f, x):
    """One dense step from x in both methods beside the f64 Woodbury step
    on the same inputs: each within the step gates of the Woodbury step,
    mixed within them of f64; each step's CUDA-event and host time and
    its peak extra allocation.  -> (gates, times)."""
    args = (*f._step_inputs(x), *f._step_noise(x))
    n = args[0].shape[0]
    steps = {m: gls_step_full_cov(*args, method=m, normalized_cov=True)
             for m in ("mixed", "f64")}
    wood = gls_step_woodbury(*args, normalized_cov=True)
    gates = {m: step_gates(f"{label} dense {m}", s, wood, ntoa=n)
             for m, s in steps.items()}
    gates["mixed_vs_f64"] = step_gates(f"{label} dense mixed vs f64",
                                       steps["mixed"], steps["f64"], ntoa=n)
    del steps
    times = {m: event_ms(lambda m=m: gls_step_full_cov(
        *args, method=m, normalized_cov=True)) for m in ("mixed", "f64")}
    times["woodbury_f64"] = event_ms(
        lambda: gls_step_woodbury(*args, normalized_cov=True))
    log(f"{label} steps at {n} rows (ms, median of 3): {times}")
    return gates, times


def dense_phase(dev):
    """Phase 11: the dense-covariance GLS step (``full_cov=True``) on
    bench.py's pulsar at 16384 and 32768 TOAs (both methods against the
    Woodbury f64 step, graphed against eager, and a GLSFitter fit on
    each route), the factorizations timed, the 2048-TOA copy card vs
    CPU, the MSP's downhill fit at 16384 TOAs and the wideband MSP's two
    fitters at 8192 TOAs (16384 stacked rows).  Every fit launches none
    of the three kernels (its counts read 0).  -> what the kernels line
    reports."""
    out = {"steps": {}, "fits": {}}
    for n in DENSE_NS:
        model, toas = make_test_pulsar(BENCH_PAR, ntoa=n, device=dev, **SIM)
        fm = GLSFitter(toas, model, full_cov=True, device=dev)
        ff = GLSFitter(toas, get_model(BENCH_PAR), full_cov=True,
                       fused=False, device=dev)
        x = fm.cm.x0()
        gates, times = dense_steps(f"bench {n}", fm, x)
        for f, m in ((fm, "mixed"), (ff, "f64")):
            graph_check(f"bench dense {m} step n={n}",
                        lambda x_, f=f: f._gn_step(x_, "full_cov"), (x,),
                        times[m]["host_ms"])
        if n == CHOL_NS[-1]:
            T, phi = fm._step_noise(x)
            Nd = fm._step_inputs(x)[2]
        del fm, ff
        fits = {}
        for m, fused in (("mixed", "auto"), ("f64", False)):
            f, launches = drive("full_cov", lambda fused=fused: GLSFitter(
                toas, get_model(BENCH_PAR), full_cov=True, fused=fused,
                device=dev), f"bench dense {m} n={n}")
            fits[m] = dict(steps=f.steps_taken, chi2=f.chi2,
                           rung=f.guard_report.rung, launches=launches)
        out["steps"][n] = dict(gates=gates, times=times, fits=fits)
        del model, toas
        phase_memory(f"11 n={n}")
    out["cholesky"] = cholesky_times(T, phi, Nd)
    del T, phi, Nd

    # the 2048-TOA copy: the f64 dense step card vs CPU, the card's
    # mixed dense step at the step gates of the CPU's f64
    small = {}
    m2, t2 = make_test_pulsar(BENCH_PAR, ntoa=2048, device="cpu", **SIM)
    for key, d in (("cpu", "cpu"), ("card", dev)):
        f = GLSFitter(t2, m2, full_cov=True, device=d)
        xs = f.cm.x0()
        args = (*f._step_inputs(xs), *f._step_noise(xs))
        for m in ("f64", "mixed"):
            leaves, build = graphs.flatten(gls_step_full_cov(
                *args, method=m, normalized_cov=True))
            small[key, m] = build([v.cpu() for v in leaves])
    (cdx, (ccov, _), cchi, _), (hdx, (hcov, _), hchi, _) = (
        small["card", "f64"], small["cpu", "f64"])
    out["card_vs_cpu"] = dict(
        f64_dx_rel=rel(cdx, hdx), f64_cov_rel=rel(ccov, hcov),
        f64_chi2_rel=abs(float(cchi) - float(hchi)) / abs(float(hchi)))
    log(f"dense: card vs cpu at 2048 TOAs: {out['card_vs_cpu']}")
    check(max(out["card_vs_cpu"].values()) <= 1e-8,
          f"dense f64 step card vs cpu outside 1e-8: {out['card_vs_cpu']}")
    out["card_vs_cpu"]["mixed_vs_cpu_f64"] = step_gates(
        "dense card mixed vs cpu f64", small["card", "mixed"],
        small["cpu", "f64"], ntoa=2048)

    # the MSP's downhill fit with the dense proposal at 16384 TOAs
    par = msp_par(MSP_NDMX, seed=0)
    model, toas = make_test_pulsar(par, ntoa=DENSE_MSP_NTOA, device=dev,
                                   **MSP_SIM)
    _, out["fits"]["msp_downhill"] = downhill_fit(
        f"msp dense {DENSE_MSP_NTOA}",
        lambda: DownhillGLSFitter(toas, model, True, device=dev),
        DownhillGLSFitter, wide=None, graph=True)
    del model, toas
    phase_memory("11 msp")

    # the wideband MSP at 8192 TOAs: 16384 stacked rows
    par = msp_wideband_par(MSP_NDMX, seed=0)
    model, toas = make_test_pulsar(par, ntoa=DENSE_WB_NTOA, device=dev,
                                   dm_error=WB_DM_ERROR, **MSP_SIM)
    f, launches = drive("full_cov", lambda: WidebandTOAFitter(
        toas, model, full_cov=True, device=dev), "wideband dense")
    out["fits"]["wideband_toa"] = dict(steps=f.steps_taken, chi2=f.chi2,
                                       rung=f.guard_report.rung,
                                       launches=launches)
    _, out["fits"]["wideband_downhill"] = downhill_fit(
        "wideband dense", lambda: WidebandDownhillFitter(
            toas, get_model(par), True, device=dev),
        WidebandDownhillFitter, wide=None)
    return out


def _tail(bundle, lo, hi):
    """The TDB times of rows lo:hi, all ``fourier_basis_rows`` reads."""
    return SimpleNamespace(tdb_day=bundle.tdb_day[lo:hi],
                           tdb_sec=DD(bundle.tdb_sec.hi[lo:hi],
                                      bundle.tdb_sec.lo[lo:hi]))


def stream_run(label, cm, graph_step):
    """Phase 12 on one pulsar at 1e5 TOAs: r, M, Ndiag and T evaluated
    once at the par values; ``stream_state_init`` on the first 1e5 - 640
    rows, then ten appends of 64 rows (their basis rows from
    ``fourier_basis_rows`` at the base span's frozen harmonics), each
    followed by a ``stream_state_solve``, which must pass the drift
    check (the appends go on from the appended state: the solves read
    it).  Gates: the final G, twx and stt within 1e-10 of their largest
    entry of a fresh init on all rows (at the frozen norms); the last
    solve's dx within the step gates of the f64 Woodbury step on all
    rows.  Times: an append and a solve, eager and graphed (bitwise
    equal), beside ``graph_step``, the graphed full mixed step of this
    run.  -> the summary."""
    x = cm.x0()
    r, M, Nd, T, phi = step_inputs(cm, x)
    no = 0 if "PHOFF" in cm.free_names else 1
    Ninv = 1.0 / Nd
    n = r.shape[0]
    n0 = n - STREAM_TAIL
    red = cm.model.components["PLRedNoise"]
    _, freqs, _ = fourier_freqs(cm.bundle, red._nharm())
    day0 = cm.bundle.tdb_day[0]
    check(T.shape[1] == 2 * freqs.shape[0],
          f"{label}: the basis is not the red noise's alone ({T.shape})")
    rtol = stream_drift_rtol()
    t0 = time.perf_counter()
    st = stream_state_init(r[:n0], M[:n0], Ninv[:n0], T[:n0], phi, x)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    basis_gap = 0.0
    for lo in range(n0, n, STREAM_CHUNK):
        hi = lo + STREAM_CHUNK
        Tj = fourier_basis_rows(_tail(cm.bundle, lo, hi), freqs, day0)
        basis_gap = max(basis_gap, float(torch.max(torch.abs(Tj - T[lo:hi]))))
        st = stream_state_append(st, r[lo:hi], M[lo:hi], Ninv[lo:hi], Tj)
        _, dx, cov, chi2 = stream_state_solve(st, no, check_rtol=rtol)
        check(bool(torch.all(torch.isfinite(dx))) and math.isfinite(
            float(chi2)), f"{label}: the drift check poisoned the solve "
            f"after rows {lo}:{hi}")
    check(st["sig_L"].dtype == torch.float32,
          f"{label}: the card's maintained factor is {st['sig_L'].dtype}")
    gaps = stream_state_gaps(
        st, stream_state_init(r, M, Ninv, T, phi, x))
    log(f"{label} stream: {n0} rows + {STREAM_TAIL // STREAM_CHUNK} appends "
        f"of {STREAM_CHUNK}; blocks vs a fresh init {gaps}; the appended "
        f"basis rows vs the host basis {basis_gap!r}; init {init_s:.3f} s")
    check(max(gaps.values()) <= 1e-10,
          f"{label}: the streamed blocks differ from a fresh init: {gaps}")
    covn, norm = cov
    wood = gls_step_woodbury(r, M, Nd, T, phi, normalized_cov=True)
    wnorm = wood[1][1]
    scale = torch.outer(wnorm / norm, wnorm / norm)
    gates = step_gates(f"{label} stream solve",
                       (dx, (covn * scale, wnorm), chi2, 0), wood, ntoa=n)

    # an append and a solve, eager and graphed
    leaves, rebuild = graphs.flatten(st)
    lo = n - STREAM_CHUNK
    tail = (r[lo:], M[lo:], Ninv[lo:], T[lo:].contiguous())

    def append(*a):
        return stream_state_append(rebuild(list(a[:-4])), *a[-4:])

    def solve(*a):
        return stream_state_solve(rebuild(list(a)), no, check_rtol=rtol)

    times = {}
    for name, fn, args in (("append", append, (*leaves, *tail)),
                           ("solve", solve, tuple(leaves))):
        eager = event_ms(lambda: fn(*args))
        g = graph_check(f"{label} stream {name}", fn, args, eager["host_ms"])
        times[name] = dict(eager_ms=eager["ms"],
                           eager_host_ms=eager["host_ms"],
                           graph_ms=g["graph_ms"],
                           graph_host_ms=g["graph_host_ms"])
    times["graphed_full_mixed_step_ms"] = graph_step
    log(f"{label} stream times (ms): {times}")
    return dict(rows=n, init_rows=n0, appends=STREAM_TAIL // STREAM_CHUNK,
                k=T.shape[1], p=M.shape[1], init_s=init_s, gaps=gaps,
                basis_rows_gap=basis_gap, vs_f64=gates, times=times)


def stream_phase(dev, bench_toas, msp_toas):
    """Phase 12: the O(append) streaming solver on bench.py's pulsar and
    on the binary MSP (k = 60, p = 169) at 1e5 TOAs."""
    out = {"bench": stream_run(
        "bench", get_model(BENCH_PAR).compile(bench_toas, device=dev),
        GRAPHS["bench mixed step"]["graph_ms"])}
    out["msp"] = stream_run(
        "msp", get_model(msp_par(MSP_NDMX, seed=0)).compile(msp_toas,
                                                            device=dev),
        GRAPHS["msp mixed step"]["graph_ms"])
    return out


#: phase 13: walkers, steps and the nested sampler's settings on bench.py's
#: pulsar, the grid's side on the binary MSP, photons in the template fit
INF_WALKERS = 64
INF_STEPS = 1000
INF_NESTED = dict(nlive=150, dlogz=0.2, seed=5)
INF_GRID = 8
INF_PHOTONS = 1_000_000
#: bench.py's pulsar simulated with the orbit inside its phases, so its
#: posterior sits at the par values (SIM's adds it after the simulation)
SIM_IN_PHASE = dict(SIM, orbit_in_phase=True)


def x_gaps(fitted, start, names):
    """x-space deltas of ``fitted``'s values from ``start``'s (internal
    units; a double-double value differenced in double-double)."""
    out = []
    for n in names:
        a, b = fitted.params[n].internal(), start.params[n].internal()
        d = a - b
        out.append(float(d.to_float()) if hasattr(d, "to_float")
                   else float(d))
    return np.asarray(out)


def close(a, b, rtol, atol=0.0):
    """Largest |a - b| - (atol + rtol |b|) over the entries (<= 0 holds)."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) - (atol + rtol * np.abs(b))))


def inference_launches(label):
    got = read_counts()
    check(not any(got.values()),
          f"{label}: a kernel launched on an inference path: {got}")
    return got


def stretch_card_vs_cpu(par, ntoa, nwalkers, sig):
    """One stretch step of the vmapped log-posterior on a small copy, the
    card against the CPU from the same walkers and the same draws."""
    model, toas = make_test_pulsar(par, ntoa=ntoa, **SIM_IN_PHASE)
    rng = np.random.default_rng(13)
    d = len(sig)
    walkers = rng.standard_normal((nwalkers, d)) * sig
    half = nwalkers // 2
    draws = [rng.uniform(size=half), rng.integers(0, half, half),
             rng.uniform(size=half), rng.uniform(size=half),
             rng.integers(0, half, half), rng.uniform(size=half)]
    out = {}
    for dev in ("cuda", "cpu"):
        bt = BayesianTiming(model, toas, device=dev)
        lnpost_v = torch.func.vmap(bt.lnposterior)
        step = make_stretch_step(lnpost_v, d, nwalkers)
        w = torch.as_tensor(walkers, device=dev)
        out[dev] = [t.cpu().numpy() for t in step(
            w, lnpost_v(w), *(torch.as_tensor(v, device=dev)
                              for v in draws))]
    gaps = dict(walkers=close(out["cuda"][0], out["cpu"][0], 1e-12),
                lp=close(out["cuda"][1], out["cpu"][1], 1e-10, 1e-6),
                accepted=[int(out["cuda"][2]), int(out["cpu"][2])])
    check(gaps["walkers"] <= 0 and gaps["lp"] <= 0
          and gaps["accepted"][0] == gaps["accepted"][1],
          f"stretch step card vs CPU: {gaps}")
    return gaps


def bench_inference(dev):
    """bench.py's pulsar at 1e5 TOAs: the batched log-posterior, the MCMC
    fit, nested sampling, each held to a GLSFitter fit of the same TOAs."""
    out = {}
    model, toas = make_test_pulsar(BENCH_PAR, ntoa=NTOA, device=dev,
                                   **SIM_IN_PHASE)
    t0 = time.perf_counter()
    g = GLSFitter(toas, model, device=dev, fused=False)
    g.fit_toas()
    out["gls_fit_s"] = time.perf_counter() - t0
    names = list(g.cm.free_names)
    sig = np.sqrt(np.diag(g.parameter_covariance_matrix))
    gls_x = x_gaps(model, get_model(BENCH_PAR), names)
    log(f"inference: GLSFitter (f64) on bench's pulsar in phase, x "
        f"{gls_x.tolist()}, sigma {sig.tolist()}")

    # the batched log-posterior: 64 walkers, one program
    zero_counts()
    bt = BayesianTiming(get_model(BENCH_PAR), toas, device=dev)
    rng = np.random.default_rng(11)
    X = torch.as_tensor(gls_x + rng.standard_normal((INF_WALKERS, len(sig)))
                        * sig, device=dev)
    prog = bt.lnposterior_batch(INF_WALKERS)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lp = prog(X)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    check(bool(torch.isfinite(lp).all()), "lnposterior batch: not finite")
    loop = torch.stack([bt.lnposterior(x) for x in X[:4]])
    check(close(lp[:4].cpu(), loop.cpu(), 1e-12, 1e-9) <= 0,
          "lnposterior batch differs from single evaluations")
    ev = event_ms(lambda: prog(X), reps=5)
    eager = event_ms(lambda: torch.func.vmap(bt.lnposterior)(X), reps=3)
    out["lnposterior_batch"] = dict(
        walkers=INF_WALKERS, ms=ev["ms"], host_ms=ev["host_ms"],
        capture_peak_bytes=peak, pool_bytes=prog.pool_reserved,
        graphs=len(prog.segments), eager_ms=eager["ms"],
        eager_host_ms=eager["host_ms"],
        eager_peak_extra_bytes=eager["peak_extra_bytes"])
    log(f"inference: lnposterior over {INF_WALKERS} walkers at {NTOA} "
        f"TOAs, one program: {out['lnposterior_batch']}")
    out["lnposterior_launches"] = inference_launches("lnposterior batch")

    # card vs CPU on the 2048-TOA copy, at the reference test's gate
    sm, stoas = make_test_pulsar(BENCH_PAR, ntoa=2048, **SIM_IN_PHASE)
    Xs = gls_x + rng.standard_normal((16, len(sig))) * sig
    vals = {}
    for d in ("cuda", "cpu"):
        b = BayesianTiming(sm, stoas, device=d)
        vals[d] = torch.func.vmap(b.lnposterior)(
            torch.as_tensor(Xs, device=d)).cpu().numpy()
    out["lnposterior_card_vs_cpu"] = close(vals["cuda"], vals["cpu"], 1e-10,
                                           1e-6)
    check(out["lnposterior_card_vs_cpu"] <= 0,
          f"lnposterior card vs CPU: {vals}")
    out["stretch_card_vs_cpu"] = stretch_card_vs_cpu(BENCH_PAR, 2048, 16,
                                                     sig * 10.0)

    # the MCMC fit: every step a replay of one program
    zero_counts()
    mm = get_model(BENCH_PAR)
    mf = MCMCFitter(toas, mm, device=dev)
    cache = mf.bt.cm.programs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mf.fit_toas(nsteps=INF_STEPS, nwalkers=INF_WALKERS, seed=0)
    host_s = time.perf_counter() - t0
    diag = mf.convergence_diagnostics()
    post = mf.chain[int(0.25 * INF_STEPS):].reshape(-1, len(sig))
    mean, std = post.mean(axis=0), post.std(axis=0)
    out["mcmc"] = dict(
        nsteps=INF_STEPS, nwalkers=INF_WALKERS, host_s=host_s,
        step_ms=host_s / INF_STEPS * 1e3,
        peak_bytes=torch.cuda.max_memory_allocated(),
        programs=programs_ran("MCMCFitter", cache, INF_STEPS, 1),
        acceptance=mf.acceptance, tau=diag["tau"].tolist(),
        ess=diag["ess"].tolist(), rhat=diag["rhat"].tolist(),
        mean_gap_sigma=((mean - gls_x) / sig).tolist(),
        std_over_sigma=(std / sig).tolist())
    log(f"inference: MCMCFitter {INF_STEPS} steps x {INF_WALKERS} walkers: "
        f"{out['mcmc']}")
    out["mcmc_launches"] = inference_launches("MCMCFitter")
    check(0.05 < mf.acceptance < 0.95, f"MCMC acceptance {mf.acceptance}")
    check(np.all(np.abs(mean - gls_x) < 5.0 * sig),
          f"MCMC means off the GLS fit: {out['mcmc']['mean_gap_sigma']}")
    check(np.all(np.abs(std - sig) <= 0.6 * sig),
          f"MCMC stds off the GLS sigmas: {out['mcmc']['std_over_sigma']}")

    # nested sampling with UniformBoundedRV priors at +-10 GLS sigma
    zero_counts()
    priors = {n: UniformBoundedRV(-10.0 * s, 10.0 * s)
              for n, s in zip(names, sig)}
    bn = BayesianTiming(get_model(BENCH_PAR), toas, priors=priors,
                        device=dev)
    cache = bn.cm.programs
    t0 = time.perf_counter()
    res = bn.sample_nested(**INF_NESTED)
    host_s = time.perf_counter() - t0
    mean = res["samples"].mean(axis=0)
    out["nested"] = dict(
        **INF_NESTED, logz=res["logz"], logzerr=res["logzerr"],
        niter=res["niter"], ncall=res["ncall"], host_s=host_s,
        replays=cache.replays, captures=cache.captures,
        mean_gap_sigma=((mean - gls_x) / sig).tolist(),
        std_over_sigma=(res["samples"].std(axis=0) / sig).tolist())
    log(f"inference: nested sampling: {out['nested']}")
    out["nested_launches"] = inference_launches("sample_nested")
    check(np.isfinite(res["logz"]), "nested logz not finite")
    check(np.all(np.abs(mean - gls_x) < 3.0 * sig),
          f"nested means off the GLS fit: {out['nested']['mean_gap_sigma']}")
    return out


def grid_inference(dev, msp_toas):
    """The binary MSP at 1e5 TOAs: chi2 over M2 x SINI around the truth
    with 2 refits of the other free parameters, chunked; and a 2048-TOA
    copy card vs CPU."""
    par = msp_par(MSP_NDMX, seed=0)
    m = get_model(par)
    cm = m.compile(msp_toas, device=dev)
    x = cm.x0()
    _, (covn, norm), _ = _wls_step(
        torch.zeros(cm.bundle.ntoa, dtype=torch.float64, device=dev),
        design_with_offset(cm, x), 1.0 / torch.square(cm.scaled_sigma(x)),
        normalized_cov=True)
    cov = (covn / torch.outer(norm, norm)).cpu().numpy()
    no = noffset(cm)
    sig = {n: float(np.sqrt(cov[no + cm._index[n], no + cm._index[n]]))
           for n in ("M2", "SINI")}
    m2, sini = float(m.params["M2"].value), float(m.params["SINI"].value)
    offs = np.arange(INF_GRID) - (INF_GRID - 1) / 2.0  # truth between 3, 4
    ds = min(sig["SINI"], 0.9 * (1.0 - sini) / offs[-1])
    grid = {"M2": m2 + offs * sig["M2"], "SINI": sini + offs * ds}
    chunk = grid_chunk(cm, INF_GRID ** 2)
    del cm, covn, norm
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    chi2 = grid_chisq(msp_toas, m, grid, device=dev, chunk=chunk)
    host_s = time.perf_counter() - t0
    i, j = np.unravel_index(np.argmin(chi2), chi2.shape)
    lo, hi = INF_GRID // 2 - 2, INF_GRID // 2 + 1
    out = dict(points=INF_GRID ** 2, chunk=chunk, host_s=host_s,
               point_ms=host_s / INF_GRID ** 2 * 1e3,
               peak_bytes=torch.cuda.max_memory_allocated(),
               sigma=sig, sini_step=ds, argmin=[int(i), int(j)],
               chi2_min=float(chi2.min()),
               chi2_span=float(chi2.max() - chi2.min()))
    log(f"inference: grid_chisq M2 x SINI {INF_GRID}x{INF_GRID} on the "
        f"binary MSP at {NTOA} TOAs, 2 refits: {out}")
    out["launches"] = inference_launches("grid_chisq")
    check(np.all(np.isfinite(chi2)), "grid chi2 not finite")
    check(lo <= i <= hi and lo <= j <= hi,
          f"grid minimum at {(i, j)}, not at the truth's cell")

    # the 2048-TOA copy: card vs CPU, 3 x 3 around the truth
    sm, stoas = make_test_pulsar(msp_par(MSP_SMALL["ndmx"], seed=0),
                                 ntoa=MSP_SMALL["ntoa"], **MSP_SIM)
    small = {"M2": m2 + np.array([-1.0, 0.0, 1.0]) * 20 * sig["M2"],
             "SINI": sini + np.array([-1.0, 0.0, 0.5]) * 20 * ds}
    vals = {d: grid_chisq(stoas, sm, small, device=d)
            for d in ("cuda", "cpu")}
    out["card_vs_cpu"] = float(np.max(np.abs(vals["cuda"] - vals["cpu"])
                                      / np.abs(vals["cpu"])))
    log(f"inference: grid card vs CPU at 2048 TOAs: {out['card_vs_cpu']}")
    check(out["card_vs_cpu"] <= 1e-8, f"grid card vs CPU: {vals}")
    return out


def photon_inference(dev):
    """1e6 photon phases drawn from a two-Gaussian template and fitted
    with LCFitter on the card; the log-likelihood, H and Z^2_m card vs
    CPU."""
    truth = LCTemplate([LCGaussian(width=0.03, loc=0.3),
                        LCGaussian(width=0.08, loc=0.7)], weights=[0.35, 0.25])
    t0 = time.perf_counter()
    phases = truth.random(INF_PHOTONS, rng=np.random.default_rng(5),
                          device=dev)
    draw_s = time.perf_counter() - t0
    start = LCTemplate([LCGaussian(width=0.05, loc=0.28),
                        LCGaussian(width=0.05, loc=0.72)], weights=[0.3, 0.3])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    f = LCFitter(start, phases, device=dev)
    ll = f.fit()
    errs = f.errors()
    fit_s = time.perf_counter() - t0
    got, want = start.get_parameters(), truth.get_parameters()
    out = dict(photons=INF_PHOTONS, draw_s=draw_s, fit_s=fit_s,
               nfev=int(f.result.nfev), loglike=ll,
               peak_bytes=torch.cuda.max_memory_allocated(),
               gap_over_err=((got - want) / errs).tolist())
    check(np.all(np.abs(got - want) < 5.0 * errs),
          f"template fit off the truth: {out['gap_over_err']}")
    p = torch.as_tensor(got)
    lls = {d: float(LCFitter(start, phases, device=d).loglikelihood(p))
           for d in ("cuda", "cpu")}
    out["loglike_card_vs_cpu"] = abs(lls["cuda"] - lls["cpu"]) / abs(
        lls["cpu"])
    check(out["loglike_card_vs_cpu"] <= 1e-10,
          f"template log-likelihood card vs CPU: {lls}")
    stats = {d: (hm(phases, device=d), z2m(phases, m=4, device=d))
             for d in ("cuda", "cpu")}
    out["hm"] = stats["cuda"][0]
    out["hm_card_vs_cpu"] = abs(stats["cuda"][0] - stats["cpu"][0]) / abs(
        stats["cpu"][0])
    out["z2m_card_vs_cpu"] = float(np.max(np.abs(stats["cuda"][1]
                                                 - stats["cpu"][1])
                                          / np.abs(stats["cpu"][1])))
    check(out["hm_card_vs_cpu"] <= 1e-9 and out["z2m_card_vs_cpu"] <= 1e-9,
          f"H / Z^2_m card vs CPU: {stats}")
    out["eventstats_ms"] = event_ms(lambda: hm(phases, device=dev))["ms"]
    log(f"inference: LCFitter on {INF_PHOTONS} photons: {out}")
    return out


def inference_phase(dev, msp_toas):
    """Phase 13: the timing posterior (lnposterior batch, MCMC, nested)
    on bench.py's pulsar, the chi2 grid on the binary MSP, the photon
    template fit; every launch count 0 on these paths."""
    t0 = time.perf_counter()
    out = {"bench": bench_inference(dev)}
    out["grid"] = grid_inference(dev, msp_toas)
    zero_counts()
    out["photons"] = photon_inference(dev)
    out["photon_launches"] = inference_launches("LCFitter")
    out["phase_s"] = time.perf_counter() - t0
    log(f"inference: phase 13 took {out['phase_s']:.1f} s")
    return out


#: phase 14: the topocentric dataset: bench.py's pulsar with the committed
#: ephemeris and the BIPM realization, at four sites over MJD 54500-55900
#: (the clock files run to 55990, the ephemeris from 54466 to 55927).  The
#: data environment of the committed golden sets (the ``$PINT_TPU_*``
#: variables the reference reads too) and the sets read in it are
#: tests/torch_ingest_env.py's
TOPO_PAR = BENCH_PAR + "EPHEM mini_vsop87\nCLOCK TT(BIPM2021)\n"
TOPO_SITES = ("gbt", "effelsberg", "jodrell", "parkes")
TOPO_SIM = dict(start_mjd=54500.0, end_mjd=55900.0, seed=0, iterations=3,
                obs=TOPO_SITES)
#: the rows appended to the tim file, after its last TOA
TOPO_TAIL = 64


def host_cpu():
    """The host's CPU (lscpu's model name, else /proc/cpuinfo's, and the
    architecture) and its usable cores: host seconds name them."""
    import platform

    name = ""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30).stdout
        name = next((line.split(":", 1)[1].strip()
                     for line in out.splitlines()
                     if line.startswith("Model name")), "")
    except (OSError, subprocess.SubprocessError):
        pass
    if not name:
        try:
            name = next((line.split(":", 1)[1].strip() for line in
                         Path("/proc/cpuinfo").read_text().splitlines()
                         if line.startswith("model name")), "")
        except OSError:
            pass
    return (f"{name or 'unknown CPU'} ({platform.machine()}), "
            f"{len(os.sched_getaffinity(0))} usable cores")


def golden_ingest(dev):
    """Every golden set ingested by the port alone, in the environment the
    reference's regression reads it in; its residuals on the card within
    1 ns of the oracle.  -> stem -> worst gap (s)."""
    gaps = {}
    t0 = time.perf_counter()
    for i in range(1, 24):
        stem = f"golden{i}"
        model, toas = port_golden(stem)
        with golden_env(stem):
            cm = model.compile(toas, device=dev)
            r = cm.time_residuals(cm.x0()).cpu().numpy()
        want = np.load(GOLDEN_DIR / f"{stem}_oracle.npz")["resid"]
        gaps[stem] = float(np.max(np.abs(r - want)))
        check(gaps[stem] <= 1e-9, f"{stem}: the card's residuals of the "
              f"port's ingest are {gaps[stem]} s off the oracle")
    log(f"ingest: 23 goldens read by the port, residuals on the card vs "
        f"oracle (worst, s): {gaps} in {time.perf_counter() - t0:.1f} s")
    return gaps


def columns_equal(label, a, b):
    """Every ingested column of two TOAs bitwise equal."""
    cols = ["freq", "error_us", "clock_corr_s", "ssb_obs_pos", "ssb_obs_vel",
            "obs_sun_pos", "obs_lat_rad", "obs_alt_m", "obs_elevation_rad"]
    pairs = [(c, getattr(a, c), getattr(b, c)) for c in cols]
    pairs += [(f"t.{k}", *(getattr(x.t, "mjd_int") if k == "day"
                           else getattr(x.t.sec, k) for x in (a, b)))
              for k in ("day", "hi", "lo")]
    pairs += [(f"t_tdb.{k}", *(getattr(x.t_tdb, "mjd_int") if k == "day"
                               else getattr(x.t_tdb.sec, k) for x in (a, b)))
              for k in ("day", "hi", "lo")]
    bad = [c for c, u, v in pairs
           if (u is None) != (v is None)
           or (u is not None and not np.array_equal(u, v))]
    bad += [c for c in ("obs", "flags") if getattr(a, c) != getattr(b, c)]
    check(not bad, f"{label}: columns differ: {bad}")


def topo_dataset(dev, tmp):
    """The 1e5-TOA topocentric dataset simulated on the card, written
    with ``write_tim_file``, read back cold (``get_TOAs(usepickle=False)``:
    its parse and its ingest timed apart too), through the cache twice
    (write, then a full hit), and again after 64 rows were appended
    (only the tail ingested).  -> (model, TOAs of the cold read, the
    timings)."""
    from pint_tpu_torch.toas import ingest as ingest_mod

    out = {"host": host_cpu(), "workers": ingest_workers(),
           "native_parser": native.available()}
    check(out["native_parser"], "the native MJD parser is not active")
    t0 = time.perf_counter()
    model, sim = make_test_pulsar(TOPO_PAR, ntoa=NTOA, device=dev,
                                  **TOPO_SIM)
    out["simulate_s"] = time.perf_counter() - t0
    tim = tmp / "topo.tim"
    t0 = time.perf_counter()
    write_tim_file(str(tim), sim)
    out["write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw = get_TOAs_from_tim(str(tim))
    out["parse_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ingest_for_model(raw, model)
    out["ingest_s"] = time.perf_counter() - t0
    out["ingest_toas_per_s"] = NTOA / out["ingest_s"]
    t0 = time.perf_counter()
    cold = get_TOAs(str(tim), model=model, usepickle=False)
    out["cold_s"] = time.perf_counter() - t0
    out["cold_toas_per_s"] = NTOA / out["cold_s"]
    columns_equal("parse + ingest vs get_TOAs", raw, cold)
    # the cache: ingested rows counted by a spy on the chain's entry
    ingested = []
    real = ingest_mod.ingest_for_model

    def spy(t, m, **kw):
        ingested.append(len(t))
        return real(t, m, **kw)

    ingest_mod.ingest_for_model = spy
    try:
        t0 = time.perf_counter()
        first = get_TOAs(str(tim), model=model, usepickle=True)
        out["cache_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        hit = get_TOAs(str(tim), model=model, usepickle=True)
        out["cache_hit_s"] = time.perf_counter() - t0
        check(ingested == [NTOA], f"cache write then hit ingested {ingested}")
        columns_equal("cache write", cold, first)
        columns_equal("cache hit", cold, hit)
        # 64 more TOAs after the last, appended to the file
        _, more = make_test_pulsar(TOPO_PAR, ntoa=TOPO_TAIL, device=dev,
                                   **{**TOPO_SIM, "start_mjd": 55901.0,
                                      "end_mjd": 55920.0, "seed": 1})
        write_tim_file(str(tmp / "tail.tim"), more)
        lines = (tmp / "tail.tim").read_text().splitlines(keepends=True)
        with open(tim, "a") as f:
            f.writelines(lines[1:])  # without its FORMAT line
        del ingested[:]
        t0 = time.perf_counter()
        grown = get_TOAs(str(tim), model=model, usepickle=True)
        out["tail_append_s"] = time.perf_counter() - t0
        check(ingested == [TOPO_TAIL],
              f"the appended read ingested {ingested}, not the tail alone")
    finally:
        ingest_mod.ingest_for_model = real
    fresh = get_TOAs(str(tim), model=model, usepickle=False)
    columns_equal("tail append vs a full ingest", fresh, grown)
    log(f"ingest: {NTOA} topocentric TOAs at {TOPO_SITES} on {out['host']}: "
        f"{out}")
    return model, cold, out


def ingest_phase(dev):
    """Phase 14: the port's own host ingest.  The 23 goldens; the 1e5-TOA
    topocentric dataset from disk (cold, cache write, cache hit, tail
    append); ``auto_fitter(toas, model).fit_toas()`` on it, served on its
    native rung through ``fused_gram_joint``, every fitted value within 3
    sigma of the simulation's truth; a 2048-TOA copy card vs CPU."""
    import tempfile

    t_phase = time.perf_counter()
    out = {"goldens": golden_ingest(dev)}
    with warnings.catch_warnings(), port_ingest_env(), \
            tempfile.TemporaryDirectory() as tmp:
        warnings.simplefilter("ignore")
        os.environ["PINT_TPU_CACHE_DIR"] = tmp
        try:
            model, toas, out["dataset"] = topo_dataset(dev, Path(tmp))
        finally:
            del os.environ["PINT_TPU_CACHE_DIR"]
        f, out["fit"] = downhill_fit(
            "topo", lambda: auto_fitter(toas, model), DownhillGLSFitter,
            wide=False)
        sig = np.sqrt(np.diag(f.parameter_covariance_matrix))
        gaps = value_gaps(f.model, get_model(TOPO_PAR), f.cm.free_names, sig)
        worst = max(gaps, key=gaps.get)
        out["fit"]["vs_truth_sigma"] = gaps
        log(f"topo: fitted values vs the simulation's truth (sigma): {gaps}")
        check(gaps[worst] <= 3.0, f"topo: {worst} is {gaps[worst]} sigma "
              "off the simulation's truth")
        del f, toas
        out["card_vs_cpu"] = card_vs_cpu(
            "topo", TOPO_PAR, 2048, {**TOPO_SIM, "orbit": False,
                                     "iterations": 1}, fourier=False)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"ingest: phase 14 took {out['phase_s']:.1f} s")
    return out


#: phase 15, the command-line tools: photons of golden22's model for
#: photonphase, the CPU's subset of them, the polyco epochs, and
#: event_optimize's photons, walkers and steps (the reference test's)
TOOLS_PHOTONS = 1_000_000
TOOLS_CPU_SUBSET = 2048
POLY_START, POLY_EPOCHS = 55000.0, 10_000
OPT_PHOTONS, OPT_WALKERS, OPT_STEPS = 100_000, 16, 400
#: event_optimize's photons span 1000 s: at 1e5 photons over the test's
#: 3000 s the log-likelihood in F0 has side modes 1.9e-4 Hz from the truth,
#: and a walk started 1e-4 Hz off can settle in one; over 1000 s none lies
#: within 5e-4 Hz (profiling/torch_event_optimize_modes.py)
OPT_SPAN_S = 1000.0
OPT_F0 = 245.4261196898081
OPT_PAR = ("PSR J1744-1134\nF0 245.4261196898081 1\nF1 -5.38e-16 1\n"
           "PEPOCH 55000\nDM 3.1380 1\n")
OPT_START_PAR = ("PSR J1744-1134\nF0 245.42621968980 1\nPEPOCH 55000\n"
                 "DM 3.138\n")
T2_PAR = OPT_PAR + ("BINARY T2\nPB 1.5\nA1 3.2\nTASC 55000.1\n"
                    "EPS1 1.2e-5\nEPS2 -0.7e-5\n")


def run_tool(main_fn, argv):
    """A tool's ``main(argv)`` with its standard output captured: it must
    return 0.  -> (its output, host seconds)."""
    import contextlib
    import io

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    secs = time.perf_counter() - t0
    check(rc == 0, f"{main_fn.__module__} exited {rc}")
    return buf.getvalue(), secs


def spy_on(module, name, record):
    """Replace ``module.name`` by a wrapper that appends (args, kwargs,
    result, host seconds) to ``record``; -> the original."""
    real = getattr(module, name)

    def spy(*a, **kw):
        t0 = time.perf_counter()
        res = real(*a, **kw)
        record.append((a, kw, res, time.perf_counter() - t0))
        return res

    setattr(module, name, spy)
    return real


def zima_pintempo(dev, tmp, argdev):
    """zima writes 1e5 TOAs at gbt from phase 14's topocentric par;
    pintempo fits them on the card (auto_fitter, native rung,
    ``fused_gram_joint`` launched), writes fit.par, which reads back to
    the fitter's model with no parameter flagged by ``compare``, every
    fitted value within 3 sigma of the truth."""
    import pint_tpu_torch.fitting as fitting_mod
    from pint_tpu_torch.scripts import pintempo, zima

    par, tim, fitpar = tmp / "topo.par", tmp / "topo_gbt.tim", tmp / "fit.par"
    par.write_text(TOPO_PAR)
    out = {}
    _, out["zima_s"] = run_tool(zima.main, [
        str(par), str(tim), "--ntoa", str(NTOA), "--startMJD", "54500",
        "--duration", "1400", "--obs", "gbt", "--freq", "1400", "800",
        "--addnoise", "--seed", "0", *argdev])
    fits = []
    real = spy_on(fitting_mod, "auto_fitter", fits)
    zero_counts()
    try:
        _, out["pintempo_s"] = run_tool(pintempo.main, [
            str(par), str(tim), "--outfile", str(fitpar), *argdev])
        torch.cuda.synchronize()
    finally:
        fitting_mod.auto_fitter = real
    out["launches"] = read_counts()
    f = fits[0][2]
    rep = f.guard_report
    out.update(fitter=type(f).__name__, rung=rep.rung, niter=f.niter,
               converged=f.converged, chi2=f.chi2)
    log(f"tools: zima {NTOA} TOAs at gbt {out['zima_s']:.2f} s; pintempo "
        f"{out['pintempo_s']:.2f} s: {out}")
    check(rep.rung == "native" and not rep.fell_back,
          f"pintempo's fit was served by rung {rep.rung}: {rep.history}")
    n_gram = out["launches"]["fused_gram_joint"]
    check(n_gram > 0, f"pintempo's fit launched fused_gram_joint {n_gram}")
    # fit.par read back: compare flags a fitted value whose par-file
    # digits (the reference's format: F0 to 25 significant digits, the
    # angles to fixed arcsecond decimals) do not give back its last bits;
    # each such value must be the fitted one within 1e-6 sigma, and no
    # other parameter may be flagged
    sig = np.sqrt(np.diag(f.parameter_covariance_matrix))
    back = get_model(str(fitpar))
    out["compare_flagged"] = [line.split()[0] for line in back.compare(
        f.model).splitlines() if line.endswith("*")]
    out["par_roundtrip_sigma"] = value_gaps(back, f.model, f.cm.free_names,
                                            sig)
    check(set(out["compare_flagged"]) <= set(f.cm.free_names)
          and max(out["par_roundtrip_sigma"].values()) <= 1e-6,
          f"fit.par read back differs from the fit: "
          f"{out['compare_flagged']}, {out['par_roundtrip_sigma']}")
    gaps = value_gaps(f.model, get_model(TOPO_PAR), f.cm.free_names, sig)
    out["vs_truth_sigma"] = gaps
    worst = max(gaps, key=gaps.get)
    log(f"tools: pintempo's values vs the truth (sigma): {gaps}")
    check(gaps[worst] <= 3.0, f"pintempo: {worst} is {gaps[worst]} sigma "
          "off the truth")
    return out, par, fitpar


def photon_tools(dev, tmp, argdev):
    """photonphase on 1e6 barycentred events over golden22's span with its
    TZR-anchored model: PULSE_PHASE equal to the card's absolute phase
    mod 1 bit for bit; a 2048-event subset on the CPU within F0 x 1e-11
    cycles of the card."""
    from pint_tpu_torch import event_toas
    from pint_tpu_torch.io.fits import get_bintable, write_event_fits
    from pint_tpu_torch.scripts import photonphase

    g22 = GOLDEN_DIR / "golden22.par"
    rng = np.random.default_rng(22)
    met = np.sort(rng.uniform(0.0, (55890.0 - 54600.0) * 86400.0,
                              TOOLS_PHOTONS))
    ev, phased = tmp / "g22_events.fits", tmp / "g22_phase.fits"
    write_event_fits(str(ev), {"TIME": met}, header_extra={
        "MJDREFI": 54600, "MJDREFF": 0.0, "TIMEZERO": 0.0, "TIMESYS": "TDB",
        "TELESCOP": "SIM"})
    loads = []
    real = spy_on(event_toas, "load_event_TOAs", loads)
    try:
        text, secs = run_tool(photonphase.main, [
            str(ev), str(g22), "--outfile", str(phased), *argdev])
    finally:
        event_toas.load_event_TOAs = real
    toas = loads[0][2]
    out = dict(photons=TOOLS_PHOTONS, photonphase_s=secs,
               load_s=loads[0][3],
               htest=float(text.split("Htest :")[1].split()[0]))
    # the load's one flags dict a photon (event_toas.py, as the
    # reference builds them), timed alone
    t0 = time.perf_counter()
    [{"photon": "1", "mission": "generic"} for _ in range(TOOLS_PHOTONS)]
    out["flags_dicts_s"] = time.perf_counter() - t0
    col = np.asarray(get_bintable(str(phased)).column("PULSE_PHASE"))
    model = get_model(str(g22))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cm = model.compile(toas, device=dev, subtract_mean=False)
    frac = cm.absolute_phase(cm.x0()).frac.cpu().numpy()
    out["phase_s"] = time.perf_counter() - t0
    out["bitwise"] = bool(np.array_equal(col, np.mod(frac, 1.0)))
    sub = toas[:TOOLS_CPU_SUBSET]
    cmc = model.compile(sub, device="cpu", subtract_mean=False)
    d = np.abs(frac[:TOOLS_CPU_SUBSET]
               - cmc.absolute_phase(cmc.x0()).frac.numpy())
    out["card_vs_cpu_cycles"] = float(np.max(np.minimum(d, 1.0 - d)))
    f0 = float(model.params["F0"].value.to_float())
    log(f"tools: photonphase {out}")
    check(out["bitwise"], "PULSE_PHASE differs from the card's phase")
    check(out["card_vs_cpu_cycles"] <= f0 * 1e-11,
          f"photon phases card vs CPU: {out['card_vs_cpu_cycles']} cycles")
    return out


def polyco_tools(dev, tmp):
    """Polycos of the binary MSP over one day (60-minute segments, 12
    coefficients) at '@' and at gbt: 1e4 off-node epochs within 1e-6
    cycles of the model's absolute phase on the card, and a write/read
    roundtrip within 1e-6 cycles."""
    from pint_tpu_torch.polycos import Polycos
    from pint_tpu_torch.timebase.times import TimeArray
    from pint_tpu_torch.toas.toas import TOAs

    model = get_model(msp_par(MSP_NDMX))
    rng = np.random.default_rng(15)
    out = {}
    for obs in ("@", "gbt"):
        t0 = time.perf_counter()
        pcs = Polycos.generate(model, POLY_START, POLY_START + 1.0, obs=obs,
                               segment_minutes=60.0, ncoeff=12, device=dev)
        gen_s = time.perf_counter() - t0
        mjds = POLY_START + np.sort(rng.uniform(0.0, 1.0, POLY_EPOCHS))
        toas = TOAs(TimeArray.from_mjd_float(mjds, scale="utc"),
                    np.full(POLY_EPOCHS, 1400.0), np.ones(POLY_EPOCHS),
                    [obs] * POLY_EPOCHS, [dict() for _ in range(POLY_EPOCHS)])
        ingest_for_model(toas, model)
        cm = model.compile(toas, device=dev, subtract_mean=False)
        ph = cm.absolute_phase(cm.x0())
        t0 = time.perf_counter()
        ints, fracs = pcs.eval_abs_phase(mjds)
        eval_s = time.perf_counter() - t0
        gap = float(np.max(np.abs((ints - ph.int_.cpu().numpy())
                                  + (fracs - ph.frac.cpu().numpy()))))
        path = tmp / f"polyco_{'bary' if obs == '@' else obs}.dat"
        pcs.write(path)
        i2, f2 = Polycos.read(path).eval_abs_phase(mjds)
        rt = float(np.max(np.abs((ints - i2) + (fracs - f2))))
        out[obs] = dict(segments=len(pcs.entries), generate_s=gen_s,
                        eval_s=eval_s, gap_cycles=gap, roundtrip_cycles=rt)
        check(gap < 1e-6, f"polycos at {obs}: {gap} cycles off the model")
        check(rt < 1e-6, f"polycos at {obs}: write/read moved {rt} cycles")
    log(f"tools: polycos of the MSP over one day: {out}")
    return out


def optimize_tool(dev, tmp, argdev):
    """event_optimize on 1e5 weighted photons over ``OPT_SPAN_S`` drawn
    from a two-Gaussian template (each pulsed with its weight as
    probability), F0 started 1e-4 Hz off: 16 walkers x 400 steps, every
    step a replay of one step program, F0 within 3e-5 of the truth."""
    from pint_tpu_torch import sampler
    from pint_tpu_torch.event_toas import load_event_TOAs
    from pint_tpu_torch.io.fits import write_event_fits
    from pint_tpu_torch.scripts import event_optimize
    from pint_tpu_torch.toas.ingest import ingest_barycentric

    truth = LCTemplate([LCGaussian(width=0.03, loc=0.3),
                        LCGaussian(width=0.08, loc=0.7)], weights=[0.35, 0.25])
    rng = np.random.default_rng(16)
    met = rng.uniform(0.0, OPT_SPAN_S, OPT_PHOTONS)
    w = rng.uniform(0.0, 1.0, OPT_PHOTONS)
    hdr = {"MJDREFI": 55000, "MJDREFF": 0.0, "TIMEZERO": 0.0,
           "TIMESYS": "TDB"}
    ev = tmp / "opt_events.fits"
    write_event_fits(str(ev), {"TIME": met}, header_extra=hdr)
    toas = load_event_TOAs(str(ev))
    ingest_barycentric(toas)
    order = np.argsort(met, kind="stable")
    met, w = met[order], w[order]
    cm = get_model(OPT_PAR).compile(toas, device=dev, subtract_mean=False)
    model_ph = cm.phase(cm.x0()).frac.cpu().numpy()
    pulsed = rng.uniform(size=OPT_PHOTONS) < w
    want = rng.uniform(size=OPT_PHOTONS)
    want[pulsed] = truth.random(int(pulsed.sum()), rng=rng, device=dev)
    # move each photon by less than a period onto its drawn phase
    shift = np.mod(want - model_ph + 0.5, 1.0) - 0.5
    met = met + shift / OPT_F0
    order = np.argsort(met, kind="stable")
    write_event_fits(str(ev), {"TIME": met[order], "WEIGHT": w[order]},
                     header_extra=hdr)
    par, gauss, post = tmp / "opt.par", tmp / "opt.gauss", tmp / "post.par"
    par.write_text(OPT_START_PAR)
    fwhm = 2.0 * math.sqrt(2.0 * math.log(2.0))
    gauss.write_text(
        f"const = 0.4\nphas1 = 0.3\nfwhm1 = {0.03 * fwhm!r}\nampl1 = 0.35\n"
        f"phas2 = 0.7\nfwhm2 = {0.08 * fwhm!r}\nampl2 = 0.25\n")
    runs = []
    real = spy_on(sampler, "run_ensemble", runs)
    try:
        _, secs = run_tool(event_optimize.main, [
            str(ev), str(par), str(gauss), "--weightcol", "WEIGHT",
            "--nwalkers", str(OPT_WALKERS), "--nsteps", str(OPT_STEPS),
            "--seed", "1", "--outfile", str(post), *argdev])
    finally:
        sampler.run_ensemble = real
    progs = runs[0][1]["programs"]
    f0 = float(get_model(str(post)).params["F0"].value.to_float())
    out = dict(photons=OPT_PHOTONS, walkers=OPT_WALKERS, steps=OPT_STEPS,
               acceptance=runs[0][2][2], event_optimize_s=secs,
               sample_s=runs[0][3],
               step_ms=runs[0][3] / OPT_STEPS * 1e3,
               replays=progs.replays, captures=progs.captures,
               capture_s=progs.capture_s, f0_gap=abs(f0 - OPT_F0))
    log(f"tools: event_optimize {out}")
    check(progs.replays == OPT_STEPS and progs.captures == 1,
          f"event_optimize: {progs.replays} replays and {progs.captures} "
          f"captures for {OPT_STEPS} steps")
    check(out["f0_gap"] < 3e-5, f"event_optimize: F0 {out['f0_gap']} off")
    return out


def small_tools(tmp, argdev, topo_par, fitpar):
    """compare_parfiles, tcb2tdb, t2binary2pint, pintbary and pintpublish
    once each on small inputs: each exits 0."""
    from pint_tpu_torch.scripts import (
        compare_parfiles,
        pintbary,
        pintpublish,
        t2binary2pint,
        tcb2tdb,
        zima,
    )

    t2, small_tim = tmp / "t2.par", tmp / "small.tim"
    t2.write_text(T2_PAR)
    run_tool(zima.main, [str(topo_par), str(small_tim), "--ntoa", "2048",
                         "--startMJD", "54500", "--duration", "1400",
                         "--obs", "gbt", "--freq", "1400", "800",
                         "--addnoise", "--seed", "1", *argdev])
    runs = {
        "compare_parfiles": (compare_parfiles.main,
                             [str(topo_par), str(fitpar)]),
        "tcb2tdb": (tcb2tdb.main, [str(GOLDEN_DIR / "golden23.par"),
                                   str(tmp / "g23_tdb.par")]),
        "t2binary2pint": (t2binary2pint.main, [str(t2), str(tmp / "t2o.par")]),
        "pintbary": (pintbary.main, ["55000.0", "55100.5", "--ra",
                                     "06:13:43.97", "--dec=-02:00:47.2",
                                     "--obs", "gbt"]),
        "pintpublish": (pintpublish.main, [str(topo_par), str(small_tim)]),
    }
    out = {name: run_tool(fn, argv + argdev)[1]
           for name, (fn, argv) in runs.items()}
    log(f"tools: the small tools exited 0 (host s): {out}")
    return out


def tools_phase(dev):
    """Phase 15: the command-line tools through their ``main(argv)`` on
    the card, in the committed data environment."""
    import tempfile

    t_phase = time.perf_counter()
    argdev = ["--device", str(dev), "--log-level", "WARNING"]
    out = {}
    with warnings.catch_warnings(), port_ingest_env(), \
            tempfile.TemporaryDirectory() as tmp:
        warnings.simplefilter("ignore")
        tmp = Path(tmp)
        out["pintempo"], topo_par, fitpar = zima_pintempo(dev, tmp, argdev)
        out["photonphase"] = photon_tools(dev, tmp, argdev)
        out["polycos"] = polyco_tools(dev, tmp)
        out["event_optimize"] = optimize_tool(dev, tmp, argdev)
        out["small_tools"] = small_tools(tmp, argdev, topo_par, fitpar)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"tools: phase 15 took {out['phase_s']:.1f} s")
    return out


#: phase 16: the MCMC resume's pulsar size, walkers, plan and cut; the
#: injected hang against its watchdog; a kernel that spins about 1.5 s
#: (torch.cuda._sleep's clock cycles) against a 0.3 s watchdog; the
#: calls of each cost measurement
RT_MCMC_NTOA = 10_000
RT_MCMC_STEPS = 1000
RT_HANG = dict(watchdog_s=0.5, hang_s=0.8)
RT_WEDGE = dict(watchdog_s=0.3, cycles=3_000_000_000)
RT_CALLS = 20
FAST_RETRY = dict(backoff_base=0.01, backoff_max=0.02, jitter=0.0)


def free_values(model, names):
    """The free parameters' internal values as (hi, lo) pairs: equal
    arrays mean bitwise equal values."""
    out = []
    for n in names:
        v = model.params[n].internal()
        if isinstance(v, tuple):
            out.append([float(v[0]), v[1].hi, v[1].lo])
        elif isinstance(v, HostDD):
            out.append([v.hi, v.lo, 0.0])
        else:
            out.append([float(v), 0.0, 0.0])
    return np.array(out, dtype=np.float64)


def traced_fit(dev, tmp):
    """Phase 14's pulsar's 1e5 TOAs read from a tim file and fitted by
    GLSFitter twice, the second after the first's commit, all under the
    flight recorder.  -> (fitter, summary)."""
    from pint_tpu_torch.obs import export as obs_export
    from pint_tpu_torch.obs import metrics as obs_metrics
    from pint_tpu_torch.obs import trace as obs_trace

    model, sim = make_test_pulsar(TOPO_PAR, ntoa=NTOA, device=dev,
                                  **TOPO_SIM)
    tim = tmp / "topo.tim"
    write_tim_file(str(tim), sim)
    del sim
    obs_metrics.reset()
    zero_counts()
    out = {}
    with obs_trace.tracing(clear=True) as tracer:
        t0 = time.perf_counter()
        toas = get_TOAs(str(tim), model=model)
        out["read_s"] = time.perf_counter() - t0
        f = GLSFitter(toas, model, device=dev)
        t0 = time.perf_counter()
        chi2_1 = f.fit_toas()
        torch.cuda.synchronize()
        out["fit_s"] = time.perf_counter() - t0
        progs = f.cm.programs
        first = dict(steps=f.steps_taken, rung=f.guard_report.rung,
                     chi2=chi2_1, launches=read_counts(),
                     traces=obs_metrics.counter("compile.traces").value,
                     captures=progs.captures, replays=progs.replays,
                     capture_s=progs.capture_s)
        zero_counts()
        t0 = time.perf_counter()
        chi2_2 = f.fit_toas()
        torch.cuda.synchronize()
        out["refit_s"] = time.perf_counter() - t0
        spans, events = tracer.spans(), tracer.events()
    snap = obs_metrics.snapshot()
    refit = dict(steps=f.steps_taken, rung=f.guard_report.rung, chi2=chi2_2,
                 launches=read_counts(),
                 builds=snap["compile.traces"] - first["traces"],
                 captures=progs.captures - first["captures"],
                 replays=progs.replays - first["replays"])
    out.update(first=first, refit=refit,
               recompiles=snap["compile.recompiles"],
               dispatches=snap["dispatch.count"],
               guarded=snap["dispatch.guarded"],
               bytes_to_device=snap["transfer.bytes_to_device"])
    cats = {sp.cat for sp in spans}
    out["categories"] = sorted(cats)
    out["spans"] = len(spans)
    stages = {}
    for name in ("ingest", "ingest:parse", "ingest:plan", "ingest:chunks",
                 "ingest:apply"):
        sec = sum(sp.dur_s for sp in spans if sp.name == name)
        stages[name] = dict(s=sec, toas_per_s=NTOA / sec if sec else None)
    out["ingest_stages"] = stages
    path = obs_export.write_chrome_trace(str(tmp / "fit.json"),
                                         spans=spans, events=events)
    back, _ = obs_export.load_chrome_trace(path)
    key = lambda sp: (sp.name, sp.cat, sp.span_id, sp.parent_id)  # noqa
    out["trace_roundtrip"] = (len(back) == len(spans) and
                              {key(sp) for sp in back}
                              == {key(sp) for sp in spans})
    log(f"runtime: traced fit of {NTOA} topocentric TOAs: {out}")
    log(f.flight_report())
    check({"fit", "rung", "compile", "dispatch", "fence", "ingest"} <= cats,
          f"traced fit: span categories {sorted(cats)}")
    check(first["rung"] == refit["rung"] == "cuda-mixed",
          f"traced fits served by {first['rung']}, {refit['rung']}")
    check(out["recompiles"] == 0 and refit["builds"] == 0
          and refit["captures"] == 0,
          f"the refit after commit built or captured a program: {refit}, "
          f"{out['recompiles']} recompiles")
    check(first["captures"] == 1
          and first["launches"]["fused_gram_joint"] == first["steps"] + 1,
          f"first fit: {first}")
    check(refit["replays"] == refit["steps"]
          and refit["launches"]["fused_gram_joint"] == refit["steps"] > 0,
          f"refit: {refit} (one launch a replay, no warm-up)")
    check(out["trace_roundtrip"], "the exported trace loads back with "
          "another span set")
    # the refit's program outlives the commit; release() hands its pool
    # back without the garbage collector: at least 90% of what the
    # capture reserved (which also holds a 2 MiB small-block segment
    # reserved outside the pool)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rel = dict(programs=len(progs), pool=progs.pool_reserved,
               reserved_before=torch.cuda.memory_reserved())
    f.release()
    torch.cuda.empty_cache()
    rel.update(programs_after=len(progs),
               reserved_after=torch.cuda.memory_reserved())
    out["release"] = rel
    log(f"runtime: release() after the refit: {rel}")
    check(rel["programs"] == 1 and rel["programs_after"] == 0
          and rel["pool"] > 0
          and (rel["reserved_before"] - rel["reserved_after"]
               >= 0.9 * rel["pool"]),
          f"release() did not hand the program's pool back: {rel}")
    return f, out


def part_a_bitwise(dev, toas):
    """A step program of bench.py's pulsar captured before a commit and
    replayed after it, against a fresh model's fresh capture at the same
    values: bitwise."""
    model = get_model(BENCH_PAR)
    cm = model.compile(toas, device=dev)
    prog = cm.program(lambda x: gauss_newton_step(cm, x, "mixed"),
                      ("part-a",))
    xn = prog(cm.x0())[0]
    cm.commit(xn.cpu().numpy())
    after, _ = graphs.flatten(prog(cm.x0()))
    fresh_cm = model.compile(toas, device=dev)
    fresh = graphs.StepProgram(
        lambda x: gauss_newton_step(fresh_cm, x, "mixed"), dev)
    want, _ = graphs.flatten(fresh(fresh_cm.x0()))
    out = dict(captures=cm.programs.captures, replays=prog.replays,
               bitwise=all(torch.equal(a, b) for a, b in zip(after, want))
               and len(after) == len(want),
               max_abs=max(float(torch.max(torch.abs(a.double()
                                                     - b.double())))
                           for a, b in zip(after, want)))
    log(f"runtime: step program replayed after commit vs a fresh capture: "
        f"{out}")
    check(out["bitwise"] and out["captures"] == 1,
          f"replay after commit differs from a fresh capture: {out}")
    return out


def fault_ladder(dev, toas):
    """The fault ladder on the card, on bench.py's pulsar at 1e5 TOAs."""
    import warnings as _w

    from pint_tpu_torch.exceptions import GuardTimeout, GuardTripWarning
    from pint_tpu_torch.runtime import faults, guard

    out = {}
    names = None

    def fit(fused="auto", **kw):
        f = GLSFitter(toas, get_model(BENCH_PAR), fused=fused, device=dev)
        chi2 = f.fit_toas(**kw)
        return f, chi2

    # transient: retried on the native rung, the clean fit's values
    clean, chi2_c = fit()
    names = list(clean.cm.free_names)
    guard.STATS.reset()
    with guard.configured(max_retries=2, **FAST_RETRY), \
            faults.inject("transient:2@cm.program"):
        f, chi2 = fit()
    out["transient"] = dict(
        rung=f.guard_report.rung, retries=guard.STATS.retries,
        chi2_equal=chi2 == chi2_c,
        values_equal=bool(np.array_equal(free_values(f.model, names),
                                         free_values(clean.model, names))))
    check(out["transient"]["rung"] == "cuda-mixed"
          and out["transient"]["retries"] == 2
          and out["transient"]["chi2_equal"]
          and out["transient"]["values_equal"],
          f"transient:2: {out['transient']}")

    # hang: a refit's replay hangs past a 0.5 s watchdog, raises at the
    # deadline before it launches, and is retried
    f, _ = fit()
    caps, reps = f.cm.programs.captures, f.cm.programs.replays
    zero_counts()
    guard.STATS.reset()
    t0 = time.perf_counter()
    with guard.configured(compile_timeout=60.0,
                          dispatch_timeout=RT_HANG["watchdog_s"],
                          max_retries=1, **FAST_RETRY), \
            faults.inject("hang:1@cm.program",
                          hang_seconds=RT_HANG["hang_s"]):
        f.fit_toas()
    refit_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read_counts()["fused_gram_joint"]
    out["hang"] = dict(**RT_HANG, timeouts=guard.STATS.timeouts,
                       retries=guard.STATS.retries, refit_s=refit_s,
                       steps=f.steps_taken,
                       replays=f.cm.programs.replays - reps,
                       captures=f.cm.programs.captures - caps,
                       launches=launches, rung=f.guard_report.rung)
    check(out["hang"]["timeouts"] == 1 and out["hang"]["retries"] == 1
          and out["hang"]["captures"] == 0
          and launches == out["hang"]["replays"] == f.steps_taken
          and out["hang"]["rung"] == "cuda-mixed",
          f"hang:1: {out['hang']} (the abandoned attempt must launch "
          "nothing: one launch a replay)")

    # a real wedge on the device: a guarded call whose kernel spins past
    # its deadline is seen at the host read, which raises GuardTimeout
    # instead of waiting, and its program is marked unusable
    wedged = []
    spin = guard.dispatch_guard(
        lambda: torch.cuda._sleep(RT_WEDGE["cycles"]), "wedge",
        device_type="cuda", on_wedged=lambda: wedged.append(1))
    guard.STATS.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with guard.configured(compile_timeout=RT_WEDGE["watchdog_s"],
                          dispatch_timeout=RT_WEDGE["watchdog_s"],
                          max_retries=0):
        spin()
        try:
            guard.check_deadlines(wait=True)
            raised = None
        except GuardTimeout as e:
            raised = type(e).__name__
    seen_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    out["device_wedge"] = dict(**RT_WEDGE, raised=raised, seen_s=seen_s,
                               spun_s=time.perf_counter() - t0,
                               timeouts=guard.STATS.timeouts,
                               marked=len(wedged))
    check(raised == "GuardTimeout" and out["device_wedge"]["marked"] == 1
          and out["device_wedge"]["timeouts"] == 1
          and RT_WEDGE["watchdog_s"] <= seen_s
          < out["device_wedge"]["spun_s"],
          f"device wedge: {out['device_wedge']}")

    # nan on the native rung: served by cuda-f64, the clean f64 fit's
    # values (the same tolerance on both, so the same iterations)
    clean64, chi2_64 = fit(fused=False, tol_chi2=1e-10)
    with _w.catch_warnings(), faults.inject("nan:inf@rung:cuda-mixed"):
        _w.simplefilter("ignore", GuardTripWarning)
        f, chi2 = fit(tol_chi2=1e-10)
    rep = f.guard_report
    out["nan"] = dict(rung=rep.rung, rung_index=rep.rung_index,
                      history=[h[0] for h in rep.history],
                      clean_rung=clean64.guard_report.rung,
                      chi2_equal=chi2 == chi2_64,
                      values_equal=bool(np.array_equal(
                          free_values(f.model, names),
                          free_values(clean64.model, names))))
    check(rep.rung == "cuda-f64" and rep.rung_index == 1
          and out["nan"]["history"] == ["cuda-mixed"]
          and out["nan"]["chi2_equal"] and out["nan"]["values_equal"],
          f"nan:inf@rung:cuda-mixed: {out['nan']}")
    log(f"runtime: fault ladder on the card: {out}")
    return out


def checkpoints(dev, fitter, tmp):
    """save_fit/load_fit of the traced fit; an MCMC run planned as 1000
    steps, cut at 500 and resumed from its checkpoint, against the
    uninterrupted run: bitwise."""
    from pint_tpu_torch.checkpoint import (
        load_fit,
        resume_mcmc,
        save_fit,
        save_mcmc,
    )

    out = {}
    save_fit(tmp / "fit.npz", fitter)
    b = load_fit(tmp / "fit.npz")
    names = list(fitter.cm.free_names)
    vals = free_values(b["model"], names)
    want = free_values(fitter.model, names)
    out["fit"] = dict(
        cov_equal=bool(np.array_equal(b["cov"],
                                      fitter.parameter_covariance_matrix)),
        chi2_equal=b["chi2"] == fitter.chi2,
        names_equal=b["free_names"] == names,
        value_rel=float(np.max(np.abs((vals[:, 0] + vals[:, 1])
                                      - (want[:, 0] + want[:, 1]))
                               / np.abs(want[:, 0]))))
    check(out["fit"]["cov_equal"] and out["fit"]["chi2_equal"]
          and out["fit"]["names_equal"] and out["fit"]["value_rel"] < 1e-15,
          f"save_fit/load_fit: {out['fit']}")

    _, toas = make_test_pulsar(BENCH_PAR, ntoa=RT_MCMC_NTOA, device=dev,
                               **SIM_IN_PHASE)
    half = RT_MCMC_STEPS // 2
    t0 = time.perf_counter()
    whole = MCMCFitter(toas, get_model(BENCH_PAR), device=dev)
    whole.fit_toas(nsteps=RT_MCMC_STEPS, nwalkers=INF_WALKERS, seed=0)
    whole_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    first = MCMCFitter(toas, get_model(BENCH_PAR), device=dev)
    first.fit_toas(nsteps=half, nwalkers=INF_WALKERS, seed=0,
                   nsteps_total=RT_MCMC_STEPS)
    save_mcmc(tmp / "mcmc.npz", first, keep_last=10)
    second = resume_mcmc(tmp / "mcmc.npz", toas, nsteps=half, device=dev)
    resumed_s = time.perf_counter() - t0
    out["mcmc"] = dict(
        ntoa=RT_MCMC_NTOA, walkers=INF_WALKERS, steps=RT_MCMC_STEPS,
        whole_s=whole_s, segments_s=resumed_s,
        run_meta=second.run_meta,
        chain_bitwise=bool(np.array_equal(
            np.concatenate([first.chain, second.chain]), whole.chain)),
        lnp_bitwise=bool(np.array_equal(
            np.concatenate([first.lnp, second.lnp]), whole.lnp)))
    log(f"runtime: checkpoints: {out}")
    check(out["mcmc"]["chain_bitwise"] and out["mcmc"]["lnp_bitwise"],
          f"MCMC resumed from its checkpoint differs from the "
          f"uninterrupted run: {out['mcmc']}")
    return out


def call_ms(fn, calls=RT_CALLS, warm=3):
    """One call's CUDA-event and host time, medians of ``calls`` single
    calls after ``warm`` warm-up calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts, hs = [], []
    for _ in range(calls):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        fn()
        e.record()
        e.synchronize()
        hs.append((time.perf_counter() - t0) * 1e3)
        ts.append(s.elapsed_time(e))
    return dict(ms=statistics.median(ts), host_ms=statistics.median(hs))


def guard_cost(dev, toas):
    """The graphed bench mixed step called through its guarded program:
    the guard armed (the card's default: an event recorded and queued
    under the watchdog's deadline a call) and off (``PINT_TPU_GUARD=off``),
    tracing off and on, beside the bare program, in turns."""
    from pint_tpu_torch.obs import trace as obs_trace

    cm = get_model(BENCH_PAR).compile(toas, device=dev)
    prog = cm.program(lambda x: gauss_newton_step(cm, x, "mixed"),
                      ("cost",))
    x = cm.x0()
    prog(x)
    bare = prog.program

    def guarded(guard_on, trace_on):
        def run():
            env = os.environ.pop("PINT_TPU_GUARD", None)
            if not guard_on:
                os.environ["PINT_TPU_GUARD"] = "off"
            try:
                if trace_on:
                    with obs_trace.tracing(clear=True):
                        return call_ms(lambda: prog(x))
                return call_ms(lambda: prog(x))
            finally:
                os.environ.pop("PINT_TPU_GUARD", None)
                if env is not None:
                    os.environ["PINT_TPU_GUARD"] = env
        return run

    order = [("bare", lambda: call_ms(lambda: bare(x))),
             ("guard armed, tracing off", guarded(True, False)),
             ("guard armed, tracing on", guarded(True, True)),
             ("guard off, tracing off", guarded(False, False)),
             ("guard off, tracing on", guarded(False, True))]
    out = {}
    for label, run in order + order[::-1]:
        out.setdefault(label, []).append(run())
    log(f"runtime: the graphed bench mixed step's call (ms, medians of "
        f"{RT_CALLS}): {out}")
    return out


def runtime_phase(dev, bench_toas):
    """Phase 16: the traced, guarded fit whose step programs survive
    commit; Part A's bitwise gate; the fault ladder on the card;
    checkpoints; the recorder's and the guard's cost."""
    import tempfile

    t_phase = time.perf_counter()
    out = {}
    with warnings.catch_warnings(), port_ingest_env(), \
            tempfile.TemporaryDirectory() as tmp:
        warnings.simplefilter("ignore")
        tmp = Path(tmp)
        fitter, out["traced_fit"] = traced_fit(dev, tmp)
        out["commit_replay"] = part_a_bitwise(dev, bench_toas)
        out["faults"] = fault_ladder(dev, bench_toas)
        out["checkpoints"] = checkpoints(dev, fitter, tmp)
        del fitter
        out["cost"] = guard_cost(dev, bench_toas)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"runtime: phase 16 took {out['phase_s']:.1f} s")
    return out


# -- phase 17: the serving engine on the card --------------------------------
SERVE_NPAR = 8
SERVE_MSP = 2
SERVE_MAXITER = 3
#: relative spread of the population's par variants: their double-double
#: values (F0) move by ~1e-17 relative, about one sigma at 1e5 TOAs, so
#: each is a distinct par that fits the shared TOAs from near the truth,
#: as the reference's serving tests' pulsars do
SERVE_SPREAD = 1e-17
SERVE_HANG = dict(watchdog_s=0.3, hang_s=1.0)
SERVE_STEADY = dict(nsub=7, lo=90_000, hi=100_000)


def serve_captures(eng):
    return sum(r.programs.captures for r in eng.pool.replicas)


def serve_wave(eng, reqs, timeout=600):
    futs = eng.submit_many(reqs)
    return [f.result(timeout=timeout) for f in futs]


def internal_delta(a, b) -> float:
    """a - b of two internal parameter values (float, HostDD, or an
    epoch's (day, HostDD seconds)), in internal units, without losing
    the double-double's low part."""
    if isinstance(a, tuple):
        return ((a[0] - b[0]) * 86400.0 + float(a[1].hi - b[1].hi)
                + float(a[1].lo - b[1].lo))
    if isinstance(a, HostDD):
        return float(a.hi - b.hi) + float(a.lo - b.lo)
    return float(a) - float(b)


def served_fit_gaps(label, resp, toas, par, dev, maxiter=SERVE_MAXITER):
    """A served fit against a direct GLSFitter fit of the same par and
    TOAs on the card, at tests/test_serve.py's gates: chi2 1e-6 relative,
    each fitted delta within 1e-3 sigma, uncertainties 1e-5 relative."""
    start = get_model(par)
    f = GLSFitter(toas, get_model(par), device=dev)
    f.fit_toas(maxiter=maxiter)
    direct_sig = np.sqrt(np.diag(f.parameter_covariance_matrix))
    # the direct fit's deltas from the par values, against the served
    # deltas, in units of the direct fit's uncertainties
    gaps = [abs(dx - internal_delta(f.model.params[n].internal(),
                                    start.params[n].internal())) / sig
            for n, dx, sig in zip(resp.names, resp.deltas, direct_sig)]
    check(get_model(resp.fitted_par).free_params == list(resp.names),
          f"{label}: the fitted par's free parameters")
    out = dict(chi2_rel=abs(resp.chi2 - f.chi2) / abs(f.chi2),
               value_gap_sigma=max(gaps),
               unc_rel=float(np.max(np.abs(resp.uncertainties / direct_sig
                                           - 1.0))),
               converged=(resp.converged, f.converged))
    f.release()
    check(out["chi2_rel"] <= 1e-6 and out["value_gap_sigma"] <= 1e-3
          and out["unc_rel"] <= 1e-5 and resp.converged == f.converged,
          f"{label}: served fit vs direct fit {out}")
    return out


def serve_launches(label, run):
    """``run()`` (one fit batch served to its end) with every launch
    count at 0 just before and read just after."""
    zero_counts()
    out = run()
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"serve: {label} launches {counts}")
    return out, counts


def serve_phase(dev):
    """Phase 17: the serving engine (``TimingEngine()``, the card's
    default) answering batched residuals, fit and predict requests, each
    served result held to the direct computation, the steady state held
    to no build and no capture, the launches counted, shedding and the
    watchdog at the fence."""
    from pint_tpu_torch.exceptions import GuardTimeout, RequestRejected
    from pint_tpu_torch.obs import metrics as obs_metrics
    from pint_tpu_torch.runtime import faults, guard
    from pint_tpu_torch.serve import (
        FitRequest,
        PredictRequest,
        ResidualsRequest,
        TimingEngine,
    )
    from pint_tpu_torch.simulation import make_population
    from pint_tpu_torch.toas.bundle import take_rows

    t_phase = time.perf_counter()
    out = {}
    t0 = time.perf_counter()
    pars, toas = make_population(
        BENCH_PAR, SERVE_NPAR + 1, ntoa=NTOA, spread=SERVE_SPREAD,
        obs=None, device=dev, **SIM_IN_PHASE)
    fresh_par, pars = pars[-1], pars[:SERVE_NPAR]
    msp_pars, msp_toas = make_population(
        msp_par(MSP_NDMX), SERVE_MSP, ntoa=NTOA, spread=SERVE_SPREAD,
        obs=None, device=dev, **MSP_SIM)
    out["population_s"] = time.perf_counter() - t0
    log(f"serve: populations of {SERVE_NPAR + 1} bench and {SERVE_MSP} MSP "
        f"pars at {NTOA} TOAs in {out['population_s']:.2f} s")

    eng = TimingEngine(max_batch=SERVE_NPAR, inflight=2, probe_ms=60_000)
    try:
        check(eng.pool.size == torch.cuda.device_count()
              and eng.pool.replicas[0].device.type == "cuda",
              f"the engine's pool on the card: {eng.pool.stats()}")
        rep = eng.pool.replicas[0]

        # residuals: one batch of the 8 pars, each against the direct
        # residuals on the card
        t0 = time.perf_counter()
        res = serve_wave(eng, [ResidualsRequest(par=p, toas=toas)
                               for p in pars])
        out["residuals_s"] = time.perf_counter() - t0
        gaps = []
        for p, r in zip(pars, res):
            cm = get_model(p).compile(toas, device=dev)
            direct = cm.time_residuals(cm.x0()).cpu().numpy()
            if p is pars[0]:
                direct0 = direct
            gaps.append(float(np.max(np.abs(r.residuals_s - direct)
                                     / np.maximum(np.abs(direct), 1e-15))))
            check(r.batch_size == SERVE_NPAR and r.bucket == 131072
                  and r.ntoa == NTOA,
                  f"residuals batch {r.batch_size} bucket {r.bucket}")
        out["residuals_rel"] = max(gaps)
        check(out["residuals_rel"] <= 1e-9,
              f"served residuals vs direct: {out['residuals_rel']}")

        # fits: one batch of 8 (capacity 8, maxiter 3); launches counted
        t0 = time.perf_counter()
        caps0 = serve_captures(eng)
        fits, counts = serve_launches("bench fit batch", lambda: serve_wave(
            eng, [FitRequest(par=p, toas=toas, maxiter=SERVE_MAXITER)
                  for p in pars]))
        out["fit_s"] = time.perf_counter() - t0
        captured = serve_captures(eng) - caps0
        want = SERVE_MAXITER + captured
        out["fit_launches"] = dict(counts=counts, captures=captured,
                                   predicted=want)
        check(all(f.batch_size == SERVE_NPAR for f in fits)
              and captured == 1
              and counts["fused_gram_joint"] == want
              and counts["fused_gram_joint batched"] == want
              and counts["fused_gram_joint wide"] == 0,
              f"bench fit batch: {out['fit_launches']} (predicted "
              f"{SERVE_MAXITER} batched steps + 1 capture's warm-up)")
        out["fit_gates"] = [served_fit_gaps(f"bench fit {i}", r, toas, p,
                                            dev)
                            for i, (p, r) in enumerate(zip(pars, fits))]

        # stacking on the card: par 0's rows in a batch of 8 copies of
        # itself against its rows in the batch of 8 distinct pars (one
        # capacity, as tests/test_serve_population.py compares them)
        solo_res = serve_wave(eng, [ResidualsRequest(par=pars[0], toas=toas)
                                    for _ in pars])[0]
        solo_fit = serve_wave(eng, [FitRequest(par=pars[0], toas=toas,
                                               maxiter=SERVE_MAXITER)
                                    for _ in pars])[0]
        out["stacking"] = dict(
            residuals_bitwise=bool(np.array_equal(solo_res.residuals_s,
                                                  res[0].residuals_s)),
            residuals_rel=float(np.max(
                np.abs(solo_res.residuals_s - res[0].residuals_s)
                / np.maximum(np.abs(res[0].residuals_s), 1e-15))),
            fit_bitwise=bool(np.array_equal(solo_fit.deltas,
                                            fits[0].deltas)),
            fit_gap_sigma=float(np.max(np.abs(solo_fit.deltas
                                              - fits[0].deltas)
                                       / fits[0].uncertainties)),
            chi2_rel=abs(solo_fit.chi2 - fits[0].chi2) / fits[0].chi2)
        log(f"serve: stacking neutrality on the card {out['stacking']}")
        # one 1e5-TOA request's admission on the host (a known par and
        # composition): its mask columns, then the whole admission
        rec = eng.sessions.record_for(pars[1])
        t0 = time.perf_counter()
        rec.model._build_masks(toas)
        masks_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng._session_for_request(FitRequest(par=pars[1], toas=toas))
        out["admit"] = dict(masks_s=masks_s,
                            admit_s=time.perf_counter() - t0)
        log(f"serve: one request's admission on the host {out['admit']}")

        # the MSP: one batch of 2 on the wide path
        t0 = time.perf_counter()
        caps0 = serve_captures(eng)
        mfits, mcounts = serve_launches("msp fit batch", lambda: serve_wave(
            eng, [FitRequest(par=p, toas=msp_toas, maxiter=SERVE_MAXITER)
                  for p in msp_pars]))
        out["msp_fit_s"] = time.perf_counter() - t0
        mcaptured = serve_captures(eng) - caps0
        mwant = SERVE_MAXITER + mcaptured
        out["msp_launches"] = dict(counts=mcounts, captures=mcaptured,
                                   predicted=mwant)
        check(all(f.batch_size == SERVE_MSP for f in mfits)
              and mcaptured == 1
              and mcounts["fused_gram_joint"] == mwant
              and mcounts["fused_gram_joint wide"] == mwant
              and mcounts["fused_gram_joint batched"] == mwant,
              f"msp fit batch: {out['msp_launches']} (predicted on the "
              "wide path)")
        out["msp_fit_gates"] = [
            served_fit_gaps(f"msp fit {i}", r, msp_toas, p, dev)
            for i, (p, r) in enumerate(zip(msp_pars, mfits))]

        # predict: polycos on the host over the first hour of the span
        mjds = np.linspace(55000.001, 55000.028, 7)
        pr = eng.submit(PredictRequest(par=pars[0], mjds=mjds)).result(
            timeout=300)
        pr2 = eng.submit(PredictRequest(par=pars[0], mjds=mjds + 1e-4)
                         ).result(timeout=300)
        check(not pr.cached and pr2.cached
              and np.all(np.isfinite(pr.phase_frac))
              and np.all(np.isfinite(pr.spin_freq_hz)),
              f"predict: cached {pr.cached}, {pr2.cached}")

        # steady state: capacities 1, 2, 4 (8 above) warmed for both ops,
        # then a wave of mixed sizes in the bucket with a brand-new par
        for n in (1, 2, 4):
            serve_wave(eng, [ResidualsRequest(par=p, toas=toas)
                             for p in pars[:n]])
            serve_wave(eng, [FitRequest(par=p, toas=toas,
                                        maxiter=SERVE_MAXITER)
                             for p in pars[:n]])
        rng = np.random.default_rng(17)
        subsets = []
        for _ in range(SERVE_STEADY["nsub"]):
            n = int(rng.integers(SERVE_STEADY["lo"], SERVE_STEADY["hi"] + 1))
            subsets.append(take_rows(toas, np.sort(
                rng.choice(NTOA, size=n, replace=False))))
        wave = list(zip(pars[:SERVE_STEADY["nsub"]], subsets))
        wave.append((fresh_par, toas))
        traces0 = obs_metrics.counter("compile.traces").value
        caps0 = serve_captures(eng)
        eng.reset_stats()
        t0 = time.perf_counter()
        steady = serve_wave(
            eng, [ResidualsRequest(par=p, toas=t) for p, t in wave]
            + [FitRequest(par=p, toas=t, maxiter=SERVE_MAXITER)
               for p, t in wave])
        wall = time.perf_counter() - t0
        st = eng.stats()
        ntoas = sum(r.ntoa for r in steady)
        out["steady"] = dict(
            requests=len(steady), wall_s=wall,
            requests_per_s=len(steady) / wall, toas_per_s=ntoas / wall,
            p50_ms=st["p50_ms"], p99_ms=st["p99_ms"],
            batches=st["batches"], stages=st["latency"]["stages"],
            builds=obs_metrics.counter("compile.traces").value - traces0,
            captures=serve_captures(eng) - caps0,
            sizes=sorted(r.ntoa for r in steady[:len(wave)]))
        log(f"serve: steady wave {out['steady']}")
        check(out["steady"]["builds"] == 0
              and out["steady"]["captures"] == 0,
              f"the steady wave built or captured: {out['steady']}")
        check(all(np.isfinite(r.chi2) for r in steady),
              "steady wave: non-finite chi2")

        # shedding: an expired deadline and a quota breach, typed
        shed = {}
        try:
            eng.submit(ResidualsRequest(par=pars[0], toas=toas,
                                        deadline_s=0.0)).result(timeout=60)
        except RequestRejected as e:
            shed["deadline"] = e.reason
        eng.quota = 1
        try:
            futs = eng.submit_many([ResidualsRequest(par=p, toas=toas)
                                    for p in pars[:4]])
            reasons = []
            for f in futs:
                try:
                    f.result(timeout=300)
                    reasons.append("served")
                except RequestRejected as e:
                    reasons.append(e.reason)
            shed["quota"] = reasons
        finally:
            eng.quota = 0
        out["shed"] = shed
        check(shed.get("deadline") == "deadline"
              and "quota" in shed.get("quota", ())
              and "served" in shed.get("quota", ()),
              f"typed shedding: {shed}")

        # the host path of the wedge's request, from its submit to its
        # launch: three identical requests served just before it, read
        # from the engine's stage clock
        twins = [eng.submit(ResidualsRequest(par=pars[0], toas=toas)
                            ).result(timeout=300) for _ in range(3)]
        pre_launch = [r.stages["dispatch"] - r.stages["submit"]
                      for r in twins]
        # the watchdog at the fence: a hang injected at the residuals
        # site wedges its launch on the card past a 0.3 s watchdog
        torch.cuda.synchronize()
        with guard.configured(dispatch_timeout=SERVE_HANG["watchdog_s"],
                              max_retries=0):
            with faults.inject("hang:1@serve:residuals",
                               hang_seconds=SERVE_HANG["hang_s"]):
                t0 = time.perf_counter()
                try:
                    eng.submit(ResidualsRequest(par=pars[0], toas=toas)
                               ).result(timeout=120)
                    raised = None
                except GuardTimeout as e:
                    raised = e
                seen_s = time.perf_counter() - t0
        after = eng.submit(ResidualsRequest(par=pars[0], toas=toas)
                           ).result(timeout=300)
        out["wedge"] = dict(
            **SERVE_HANG, raised=type(raised).__name__,
            submit_to_raise_s=seen_s,
            at_fence=bool(getattr(raised, "launched", False)),
            overdue_s=getattr(raised, "overdue_s", None),
            next_rel=float(np.max(np.abs(after.residuals_s - direct0)
                                  / np.maximum(np.abs(direct0), 1e-15))),
            state=rep.state)
        log(f"serve: wedge {out['wedge']}")
        # seen at the fence within 0.1 s of its deadline (the watchdog's
        # 0.3 s after the launch), and within the watchdog plus 0.1 s of
        # its submit beyond the host path to the launch (the median of
        # the three above); the next batch served at the gate of the
        # residuals above
        out["wedge"]["pre_launch_s"] = pre_launch
        out["wedge"]["raise_bound_s"] = (float(np.median(pre_launch))
                                         + SERVE_HANG["watchdog_s"] + 0.1)
        check(out["wedge"]["raised"] == "GuardTimeout"
              and out["wedge"]["at_fence"]
              and 0.0 <= out["wedge"]["overdue_s"] < 0.1
              and out["wedge"]["submit_to_raise_s"]
              <= out["wedge"]["raise_bound_s"]
              and out["wedge"]["next_rel"] <= 1e-9,
              f"the wedge at the fence: {out['wedge']}")

        # figures: each batch's device ms, capture s per program, memory
        out["batch_device_ms"] = list(rep.device_ms)
        out["capture_s"] = {
            f"{k[0][0]}:b{k[0][2]}x{k[1]}": prog.capture_s
            for k, prog in rep.programs._programs.items()}
        out["memory_reserved"] = torch.cuda.memory_reserved()
        out["stats"] = {k: v for k, v in eng.stats().items()
                        if k in ("requests", "completed", "shed",
                                 "rejected", "batches", "fabric", "slo")}
    finally:
        eng.close(timeout=120)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"serve: phase 17 {out}")
    check(out["memory_reserved"] <= MEMORY_LIMIT,
          f"memory_reserved in phase 17: {out['memory_reserved']}")
    return out


# -- phase 18: the one-card fleet on the card ---------------------------------
#: the stream: interior rows held out of the open (span-preserving, so the
#: frozen Fourier anchor is the direct fit's own basis), appended 64 at a
#: time; 10 appends held to the direct fit, one more under a drift fault
FLEET_HELD_AT = 50_000
FLEET_APPEND = 64
FLEET_NAPPEND = 10
FLEET_MAXITER = 4  # ObserveSession's default maxiter
#: the ECORR stream (every append on the warm rung): its TOAs and appends
FLEET_ECORR = dict(ntoa=512, appends=2, rows=16)
#: the cross-key fuse: three compositions at 2048-4096 TOAs, two pars
#: each, fit batches of maxiter SERVE_MAXITER
FLEET_XKEY_NTOA = (2048, 3000, 2500)
FLEET_STALL = dict(hang_s=1.5, settle_s=0.3)
#: the jobs at full width: an MCMC job cut into quanta of 16 steps,
#: preempted once, and a 4 x 4 grid of F0 and F1
FLEET_MCMC = dict(nsteps=256, nwalkers=64, seed=11)
FLEET_QUANTUM = "16"
FLEET_GRID = 4


def _bench_variant(drop=(), extra=""):
    lines = [ln for ln in BENCH_PAR.strip("\n").splitlines()
             if not any(ln.startswith(d) for d in drop)]
    return "\n" + "\n".join(lines) + "\n" + extra


def fleet_captures(eng):
    """Captures of every program the engine built: the replicas' (serve,
    fused, job programs) and its stream-init programs."""
    return (sum(r.programs.captures for r in eng.pool.replicas)
            + eng._stream_programs.captures)


def fleet_launches(label, run):
    """``run()`` with every launch count at 0 just before, read just
    after (the device synchronized)."""
    zero_counts()
    out = run()
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"fleet: {label} launches {counts}")
    return out, counts


def stream_vs_direct(s, toas, model_par, dev):
    """The stream's solution against a direct f64 GLSFitter fit of all its
    rows, at tests/test_serve_stream.py's Fourier gates (deltas 1e-4
    sigma, uncertainties 1e-4 relative, chi2 1e-6 relative)."""
    start = get_model(model_par)
    f = GLSFitter(toas, get_model(model_par), device=dev, fused=False)
    f.fit_toas(maxiter=FLEET_MAXITER)
    sig = np.sqrt(np.diag(f.parameter_covariance_matrix))
    gaps = [abs(dx - internal_delta(f.model.params[n].internal(),
                                    start.params[n].internal())) / sg
            for n, dx, sg in zip(s.names, s.deltas, sig)]
    out = dict(value_gap_sigma=max(gaps),
               unc_rel=float(np.max(np.abs(s.uncertainties / sig - 1.0))),
               chi2_rel=abs(s.chi2 - f.chi2) / abs(f.chi2))
    f.release()
    return out


def fleet_stream(eng, dev, out, model, toas, eager=None):
    """Step 1: the stream at full width, the fallback rungs, ECORR.
    ``eager``: phase 12's eager append and solve of 64 rows on bench.py's
    pulsar at 1e5 TOAs in this run (CUDA-event and host ms), printed
    beside the served append; None when phase 18 runs alone."""
    from pint_tpu_torch.exceptions import PintTpuNumericsError
    from pint_tpu_torch.obs import metrics as obs_metrics
    from pint_tpu_torch.serve import AppendRequest
    from pint_tpu_torch.toas.bundle import take_rows

    par = model.as_parfile()
    nheld = (FLEET_NAPPEND + 3) * FLEET_APPEND
    held = np.arange(FLEET_HELD_AT, FLEET_HELD_AT + nheld)
    base = np.setdiff1d(np.arange(NTOA), held)
    chunks = [take_rows(toas, held[i:i + FLEET_APPEND])
              for i in range(0, nheld, FLEET_APPEND)]
    rep = eng.pool.replicas[0]

    t0 = time.perf_counter()
    s, counts = fleet_launches("stream open", lambda: eng.open_stream(
        par, take_rows(toas, base), maxiter=FLEET_MAXITER))
    out["open_s"] = time.perf_counter() - t0
    out["open_launches"] = counts
    check(s._state is not None and s._state["sig_L"].shape[0] == 60,
          "the stream's state (k = 60)")

    caps0 = rep.programs.captures
    rungs, caps, host_ms = [], [], []
    zero_counts()
    for c in chunks[:FLEET_NAPPEND]:
        t0 = time.perf_counter()
        r = s.append(c).result(timeout=600)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        rungs.append(r.refit)
        caps.append(rep.programs.captures - caps0)
    torch.cuda.synchronize()
    out["append_launches"] = read_counts()
    dev_ms = [ms for op, _cap, ms in rep.device_ms if op == "append"]
    out["appends"] = dict(
        rungs=rungs, captures_after_each=caps, host_ms=host_ms,
        device_ms=dev_ms,
        device_ms_median=(statistics.median(dev_ms[1:])
                          if len(dev_ms) > 1 else None),
        host_ms_median=statistics.median(host_ms[1:]),
        phase12_eager=eager, bucket=r.bucket, ntoa=s.ntoa)
    log(f"fleet: appends {out['appends']}")
    check(rungs == ["incremental"] * FLEET_NAPPEND,
          f"every append on the incremental rung: {rungs}")
    check(caps[0] == 1 and caps[-1] == 1,
          f"the append program captured once, at the first append: {caps}")
    check(not out["append_launches"]["fused_gram_joint"],
          f"appends launch no Gram kernel: {out['append_launches']}")
    seen = np.concatenate([base, held[:FLEET_NAPPEND * FLEET_APPEND]])
    out["vs_direct"] = stream_vs_direct(
        s, take_rows(toas, np.sort(seen)), par, dev)
    log(f"fleet: stream vs direct f64 fit {out['vs_direct']}")
    v = out["vs_direct"]
    check(v["value_gap_sigma"] <= 1e-4 and v["unc_rel"] <= 1e-4
          and v["chi2_rel"] <= 1e-6,
          f"the stream against the direct fit: {v}")

    # the drift guard: a corrupted state fails typed in the program, and
    # through the stream the append falls back to the warm rung
    bad = dict(s._state, G=-np.asarray(s._state["G"]))
    try:
        eng.submit(AppendRequest(par=par, toas=chunks[FLEET_NAPPEND],
                                 state=bad, freqs=s._freqs, day0=s._day0,
                                 ntoa_prev=s.ntoa)
                   ).result(timeout=600)
        typed = None
    except PintTpuNumericsError as e:
        typed = type(e).__name__
    fb0 = obs_metrics.counter("serve.stream.drift_fallback").value
    s._state = bad
    r = s.append(chunks[FLEET_NAPPEND]).result(timeout=600)
    out["drift"] = dict(
        direct_error=typed, rung=r.refit,
        fallbacks=obs_metrics.counter("serve.stream.drift_fallback").value
        - fb0)
    log(f"fleet: drift fault {out['drift']}")
    check(typed == "PintTpuNumericsError" and r.refit == "warm"
          and out["drift"]["fallbacks"] == 1,
          f"the drift guard's fallback: {out['drift']}")
    s.close()

    # the refresh: PINT_TPU_STREAM_REFRESH=1, so the second append of a
    # new stream is the warm rung; its refit launches counted
    os.environ["PINT_TPU_STREAM_REFRESH"] = "1"
    try:
        s2 = eng.open_stream(par, take_rows(toas, base),
                             maxiter=FLEET_MAXITER)
    finally:
        del os.environ["PINT_TPU_STREAM_REFRESH"]
    r1 = s2.append(chunks[FLEET_NAPPEND + 1]).result(timeout=600)
    r2, counts = fleet_launches("warm refit", lambda: s2.append(
        chunks[FLEET_NAPPEND + 2]).result(timeout=600))
    out["refresh"] = dict(rungs=[r1.refit, r2.refit], launches=counts)
    check([r1.refit, r2.refit] == ["incremental", "warm"],
          f"the refresh on the warm rung: {out['refresh']}")
    s2.close()

    # ECORR: no incremental path, every append a warm refit
    em, et = make_test_pulsar(
        BENCH_PAR + "ECORR            -f L-wide 0.5\n",
        ntoa=FLEET_ECORR["ntoa"], device=dev, **SIM_IN_PHASE)
    n0 = FLEET_ECORR["ntoa"] - FLEET_ECORR["appends"] * FLEET_ECORR["rows"]
    se = eng.open_stream(em.as_parfile(), take_rows(et, np.arange(n0)))
    erungs = []
    for i in range(FLEET_ECORR["appends"]):
        lo = n0 + i * FLEET_ECORR["rows"]
        erungs.append(se.append(take_rows(
            et, np.arange(lo, lo + FLEET_ECORR["rows"]))).result(
                timeout=600).refit)
    out["ecorr"] = dict(state=se._state is not None, rungs=erungs)
    check(se._state is None and erungs == ["warm"] * len(erungs),
          f"the ECORR stream: {out['ecorr']}")
    se.close()


def fleet_fuse(eng, dev, out):
    """Step 2: three compositions' fit batches fused in one dispatch."""
    from pint_tpu_torch.exceptions import PintTpuNumericsError
    from pint_tpu_torch.obs import metrics as obs_metrics
    from pint_tpu_torch.runtime import faults
    from pint_tpu_torch.serve import FitRequest, ResidualsRequest
    from pint_tpu_torch.simulation import make_population

    comps = [BENCH_PAR, _bench_variant(drop=("TNRED",)),
             _bench_variant(drop=("TNREDC",), extra="TNREDC           20\n")]
    groups = []
    for par, n in zip(comps, FLEET_XKEY_NTOA):
        pars, t = make_population(par, 2, ntoa=n, spread=SERVE_SPREAD,
                                  obs=None, device=dev, **SIM_IN_PHASE)
        groups.append((pars, t))
    rep = eng.pool.replicas[0]

    def fits(i, toas=None):
        pars, t = groups[i]
        return [FitRequest(par=p, toas=t if toas is None else toas,
                           maxiter=SERVE_MAXITER) for p in pars]

    stall_par, stall_toas = groups[0][0][0], groups[0][1]

    def round_(members):
        """A stalled residuals batch holds the replica's dispatcher: the
        injected hang fires twice at its site, once as a kernel spinning
        on the replica's stream and once on the dispatcher's host thread
        (the guard's), so the three fit batches queue behind it and the
        dispatcher finds them together.  -> (results, timing): the
        round's fit dispatches' CUDA-event ms (each from its first launch
        to its last; three solo, or one fused) and the host ms from the
        first member's placement to the last member's resolution (stage
        stamps), the stall excluded."""
        rep.device_ms.clear()
        with faults.inject("hang:2@serve:residuals",
                           hang_seconds=FLEET_STALL["hang_s"]):
            stall = eng.submit(ResidualsRequest(par=stall_par,
                                                toas=stall_toas))
            time.sleep(FLEET_STALL["settle_s"])
            futs = [eng.submit_many(m) for m in members]
            stall.result(timeout=600)
        out_ = []
        for fs in futs:
            res = []
            for f in fs:
                try:
                    res.append(f.result(timeout=600))
                except PintTpuNumericsError as e:
                    res.append(e)
            out_.append(res)
        stages = [r.stages for res in out_ for r in res
                  if not isinstance(r, Exception)]
        dev_ms = [ms for op, _n, ms in rep.device_ms if op != "residuals"]
        timing = dict(
            device_ms=dev_ms, device_ms_sum=sum(dev_ms),
            host_ms=(max(st["finish"] for st in stages)
                     - min(st["place"] for st in stages)) * 1e3)
        return out_, timing

    # every solo program built first: the stall's residuals, each
    # composition's fit batch (capacity 2)
    serve_wave(eng, [ResidualsRequest(par=stall_par, toas=stall_toas)])
    for i in range(3):
        serve_wave(eng, fits(i))
    members = [fits(i) for i in range(3)]
    rep._xkey_on = False
    x0 = obs_metrics.counter("serve.fabric.xkey_fused").value
    solo, solo_t = round_(members)
    rep._xkey_on = True
    check(obs_metrics.counter("serve.fabric.xkey_fused").value == x0,
          "the fusion-off round fused")
    caps0 = fleet_captures(eng)
    first, first_t = round_(members)
    out["first_round_captures"] = fleet_captures(eng) - caps0
    x1 = obs_metrics.counter("serve.fabric.xkey_fused").value
    caps0 = fleet_captures(eng)
    traces0 = obs_metrics.counter("compile.traces").value
    (steady, steady_t), counts = fleet_launches(
        "fused batch", lambda: round_(members))
    out["rounds"] = dict(solo=solo_t, fused_first=first_t,
                         fused_steady=steady_t)
    out["steady"] = dict(
        captures=fleet_captures(eng) - caps0,
        builds=obs_metrics.counter("compile.traces").value - traces0,
        fused=obs_metrics.counter("serve.fabric.xkey_fused").value - x1,
        launches=counts)
    out["first_fused"] = x1 - x0

    def same(a, b):
        return all(np.array_equal(p.deltas, q.deltas)
                   and np.array_equal(p.uncertainties, q.uncertainties)
                   and p.chi2 == q.chi2 and p.fitted_par == q.fitted_par
                   for ra, rb in zip(a, b) for p, q in zip(ra, rb))

    out["bitwise"] = dict(first=same(first, solo), steady=same(steady, solo))
    log(f"fleet: fuse {out}")
    check(out["first_fused"] == 2 and out["steady"]["fused"] == 2,
          f"the three fit batches fused in one dispatch: {out}")
    check(out["bitwise"]["first"] and out["bitwise"]["steady"],
          f"fused results bitwise the unfused ones: {out['bitwise']}")
    check(out["steady"]["captures"] == 0 and out["steady"]["builds"] == 0,
          f"the steady fused round built or captured: {out['steady']}")

    # one non-finite member: its TOAs carry a NaN uncertainty
    bad = dict(groups[2][1])
    bad["error_us"] = np.array(bad["error_us"])
    bad["error_us"][0] = np.nan
    caps0 = fleet_captures(eng)
    nan_round, _ = round_([members[0], members[1], fits(2, toas=bad)])
    out["nan_member"] = dict(
        failed=[type(r).__name__ for r in nan_round[2]],
        others_bitwise=same(nan_round[:2], solo[:2]),
        captures=fleet_captures(eng) - caps0)
    log(f"fleet: non-finite member {out['nan_member']}")
    check(out["nan_member"]["failed"] == ["PintTpuNumericsError"] * 2
          and out["nan_member"]["others_bitwise"],
          f"only the non-finite member failed: {out['nan_member']}")


def fleet_jobs(eng, dev, out, model, toas):
    """Step 3: an MCMC job preempted once and resumed, a grid job, and a
    repeat of each, at 1e5 TOAs."""
    from pint_tpu_torch.bayesian import default_priors_for
    from pint_tpu_torch.exceptions import RequestRejected
    from pint_tpu_torch.obs import metrics as obs_metrics
    from pint_tpu_torch.sampler import run_ensemble
    from pint_tpu_torch.serve import ResidualsRequest
    from pint_tpu_torch.serve.api import JobRequest
    from pint_tpu_torch.serve.jobs.kernels import job_lnposterior

    par = model.as_parfile()
    serve_wave(eng, [ResidualsRequest(par=par, toas=toas)])
    mc = obs_metrics.counter
    q0, p0 = mc("serve.jobs.quanta").value, mc("serve.jobs.preempted").value
    t0 = time.perf_counter()
    fut = eng.submit(JobRequest(par=par, toas=toas, kind="mcmc",
                                **FLEET_MCMC))
    deadline = time.monotonic() + 300
    while (mc("serve.jobs.quanta").value < q0 + 3
           and time.monotonic() < deadline and not fut.done()):
        time.sleep(0.01)
    try:
        eng.submit(ResidualsRequest(par=par, toas=toas, deadline_s=1e-4)
                   ).result(timeout=300)
        shed = None
    except RequestRejected as e:
        shed = e.reason
    job = fut.result(timeout=900)
    job_s = time.perf_counter() - t0
    rec, sess, padded, _ = eng._session_for_request(
        JobRequest(par=par, toas=toas, kind="mcmc"))
    lnpost = job_lnposterior(sess, padded, rec.refnum, default_priors_for(
        rec.model, list(sess.cm.free_names)))
    t0 = time.perf_counter()
    chain, lnp, acc = run_ensemble(
        lnpost, np.zeros(sess.cm.nfree), nwalkers=FLEET_MCMC["nwalkers"],
        nsteps=FLEET_MCMC["nsteps"], seed=FLEET_MCMC["seed"], device=dev)
    direct_s = time.perf_counter() - t0
    # the job's posterior against BayesianTiming's on the unpadded TOAs:
    # the padded rows add one constant to every log-posterior
    bt = BayesianTiming(model, toas, device=dev)
    last = torch.as_tensor(job.result["chain"][-1], device=dev)
    bt_lnp = torch.func.vmap(bt.lnposterior)(last).cpu().numpy()
    offset = job.result["lnp"][-1] - bt_lnp
    out["mcmc"] = dict(
        shed=shed, preemptions=job.preemptions,
        preempted=mc("serve.jobs.preempted").value - p0,
        quanta=job.quanta, job_s=job_s, run_ensemble_s=direct_s,
        bitwise=bool(np.array_equal(job.result["chain"], chain)
                     and np.array_equal(job.result["lnp"], lnp)),
        acceptance=(job.result["acceptance"], acc),
        padding_offset_spread=float(np.ptp(offset)))
    log(f"fleet: mcmc job {out['mcmc']}")
    check(shed == "deadline" and job.preemptions >= 1
          and out["mcmc"]["bitwise"]
          and out["mcmc"]["padding_offset_spread"] <= 1e-3,
          f"the preempted MCMC job: {out['mcmc']}")

    f0 = float(model.params["F0"].value)
    f1 = float(model.params["F1"].value)
    grid = {"F0": list(f0 + 2e-11 * np.linspace(-1, 1, FLEET_GRID)),
            "F1": list(f1 + 2e-19 * np.linspace(-1, 1, FLEET_GRID))}
    t0 = time.perf_counter()
    g = eng.submit(JobRequest(par=par, toas=toas, kind="grid_chisq",
                              grid=grid)).result(timeout=900)
    grid_s = time.perf_counter() - t0
    direct = np.asarray(grid_chisq(toas, get_model(par), grid, device=dev))
    out["grid"] = dict(shape=list(g.result["chi2"].shape),
                       rel=float(np.max(np.abs(g.result["chi2"] / direct
                                               - 1.0))),
                       quanta=g.quanta, job_s=grid_s)
    check(out["grid"]["rel"] <= 1e-10,
          f"the grid job against grid_chisq: {out['grid']}")
    caps0 = fleet_captures(eng)
    g2 = eng.submit(JobRequest(par=par, toas=toas, kind="grid_chisq",
                               grid=grid)).result(timeout=900)
    m2 = eng.submit(JobRequest(par=par, toas=toas, kind="mcmc",
                               nsteps=32, nwalkers=FLEET_MCMC["nwalkers"],
                               seed=3)).result(timeout=900)
    out["repeat_captures"] = fleet_captures(eng) - caps0
    log(f"fleet: grid job {out['grid']}; repeats captured "
        f"{out['repeat_captures']}")
    check(out["repeat_captures"] == 0
          and np.array_equal(g2.result["chi2"], g.result["chi2"])
          and m2.result["chain"].shape[0] == 32,
          f"the job repeats: captures {out['repeat_captures']}")
    out["jobs_stats"] = eng.stats()["jobs"]


#: the restart's traffic, as the same requests in both engines
def restart_traffic(pars, toas):
    from pint_tpu_torch.serve import FitRequest, ResidualsRequest
    from pint_tpu_torch.serve.api import JobRequest

    f0 = float(get_model(pars[0]).params["F0"].value)
    return dict(
        residuals=[ResidualsRequest(par=p, toas=toas) for p in pars],
        fits=[FitRequest(par=p, toas=toas, maxiter=SERVE_MAXITER)
              for p in pars],
        grid=JobRequest(par=pars[0], toas=toas, kind="grid_chisq",
                        grid={"F0": [f0 - 1e-11, f0, f0 + 1e-11]}))


def restart_mcmc(par, toas, path):
    from pint_tpu_torch.serve.api import JobRequest

    return JobRequest(par=par, toas=toas, kind="mcmc",
                      checkpoint_path=path, **FLEET_MCMC)


def restart_child(spec_path):
    """Engine B of phase 18, in a process of its own: boots on the ledger
    engine A left, replays it (the captures before the collector opens),
    serves A's traffic and resumes A's interrupted MCMC job.  Prints one
    JSON line of what it measured."""
    import pickle

    from pint_tpu_torch.obs import metrics as obs_metrics
    from pint_tpu_torch.ops import _cuda_build
    from pint_tpu_torch.serve import TimingEngine

    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    nvcc = []
    real_nvcc = _cuda_build._nvcc
    _cuda_build._nvcc = lambda: nvcc.append(1) or real_nvcc()
    pars, toas = spec["pars"], spec["toas"]
    os.environ["PINT_TPU_SERVE_JOBS_QUANTUM"] = FLEET_QUANTUM
    t0 = time.perf_counter()
    eng = TimingEngine(warm_ledger=spec["ledger"], max_batch=SERVE_NPAR,
                       inflight=1, probe_ms=60_000)
    out = dict(boot_s=time.perf_counter() - t0, replay_s=eng.replay_s,
               replay_captures=fleet_captures(eng),
               replayed=eng.stats()["warm"]["replayed"])
    try:
        traffic = restart_traffic(pars, toas)
        caps0 = fleet_captures(eng)
        traces0 = obs_metrics.counter("compile.traces").value
        serve_wave(eng, traffic["residuals"])
        _, counts = fleet_launches("restart fit", lambda: serve_wave(
            eng, traffic["fits"]))
        out["fit_launches"] = counts
        eng.submit(traffic["grid"]).result(timeout=900)
        resumed = eng.submit(restart_mcmc(pars[0], toas, spec["ckpt"])
                             ).result(timeout=900)
        whole = eng.submit(restart_mcmc(pars[0], toas, None)).result(
            timeout=900)
        out.update(
            traffic_captures=fleet_captures(eng) - caps0,
            traffic_builds=obs_metrics.counter("compile.traces").value
            - traces0,
            nvcc=len(nvcc), resumed=resumed.resumed,
            bitwise=bool(np.array_equal(resumed.result["chain"],
                                        whole.result["chain"])
                         and np.array_equal(resumed.result["lnp"],
                                            whole.result["lnp"])))
    finally:
        eng.close(timeout=120)
    print(json.dumps(out), flush=True)
    return 0


def fleet_restart(dev, out):
    """Step 4: kill and restart against a warm ledger."""
    import pickle
    import tempfile

    from pint_tpu_torch.exceptions import RequestRejected
    from pint_tpu_torch.obs import metrics as obs_metrics
    from pint_tpu_torch.serve import TimingEngine
    from pint_tpu_torch.simulation import make_population

    pars, toas = make_population(BENCH_PAR, 2, ntoa=NTOA,
                                 spread=SERVE_SPREAD, obs=None, device=dev,
                                 **SIM_IN_PHASE)
    with tempfile.TemporaryDirectory() as tmp:
        ledger = os.path.join(tmp, "ledger.json")
        ckpt = os.path.join(tmp, "mcmc.npz")
        os.environ["PINT_TPU_SERVE_JOBS_QUANTUM"] = FLEET_QUANTUM
        try:
            eng = TimingEngine(warm_ledger=ledger, max_batch=SERVE_NPAR,
                               inflight=1, probe_ms=60_000)
        finally:
            del os.environ["PINT_TPU_SERVE_JOBS_QUANTUM"]
        try:
            traffic = restart_traffic(pars, toas)
            serve_wave(eng, traffic["residuals"])
            serve_wave(eng, traffic["fits"])
            eng.submit(traffic["grid"]).result(timeout=900)
            mc = obs_metrics.counter
            q0 = mc("serve.jobs.quanta").value
            job = eng.submit(restart_mcmc(pars[0], toas, ckpt))
            deadline = time.monotonic() + 300
            while (mc("serve.jobs.quanta").value < q0 + 4
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        finally:
            eng.close(timeout=120)
        try:
            job.result(timeout=60)
            closed = "finished"
        except RequestRejected as e:
            closed = e.reason
        with open(ledger) as f:
            entries = json.load(f)["entries"]
        out["ledger"] = sorted(
            f"{e['op']}:{e['params'].get('kind', '')}:{e['caps']}"
            for e in entries.values())
        out["killed_job"] = closed
        check(closed == "shutdown", f"engine A closed mid-job: {closed}")
        gc.collect()
        torch.cuda.empty_cache()
        spec = os.path.join(tmp, "spec.pkl")
        with open(spec, "wb") as f:
            pickle.dump(dict(pars=pars, toas=toas, ledger=ledger,
                             ckpt=ckpt), f)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c",
             "import sys, chip_smoke; "
             "sys.exit(chip_smoke.restart_child(sys.argv[1]))", spec],
            capture_output=True, text=True, timeout=600,
            cwd=str(Path(__file__).resolve().parent))
        out["child_s"] = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if "launches" in line:
            log(line)
    check(proc.returncode == 0,
          f"engine B failed: {proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    out["restart"] = child
    log(f"fleet: restart {child}")
    check(child["replay_captures"] > 0 and child["traffic_captures"] == 0
          and child["traffic_builds"] == 0 and child["nvcc"] == 0
          and child["resumed"] and child["bitwise"],
          f"the restart: {child}")


def fleet_phase(dev, eager=None):
    """Phase 18: the one-card fleet — a stream's appends on the card, the
    cross-key fuse, preemptible jobs at full width, and a kill and restart
    against a warm ledger, every gate raising.

    ``fused_gram_joint`` launches, counted from 0 around each, as the code
    predicts them (a fit batch is ``maxiter`` replays of its batched step
    program, ONE launch a replay whatever the capacity, plus one for the
    warm-up of each capture the batch makes; the white composition's f64
    step and every streaming, job and residuals path launch none):

    - the stream's open: its cold fit (``maxiter`` 4) is the engine's
      first fit of that (key, capacity 1), so 4 replays + 1 capture's
      warm-up = 5; the state init launches nothing;
    - one warm refit (the refresh rung): the same fit program, captured
      at the open, 4 replays = 4;
    - the steady fused batch: the red-noise members (two of the three,
      capacity 2 each) replay ``SERVE_MAXITER`` = 3 steps each inside the
      one fused graph, the white member none: 2 x 3 = 6, all batched;
    - the restart's first fit wave (capacity 2, captured by engine B's
      boot replay): 3 replays = 3.
    """
    from pint_tpu_torch.serve import TimingEngine

    t_phase = time.perf_counter()
    out = {"stream": {}, "fuse": {}, "jobs": {}}
    os.environ["PINT_TPU_SERVE_JOBS_QUANTUM"] = FLEET_QUANTUM
    try:
        eng = TimingEngine(max_batch=SERVE_NPAR, inflight=4,
                           max_wait_ms=40.0, probe_ms=60_000,
                           quarantine_n=100)
    finally:
        del os.environ["PINT_TPU_SERVE_JOBS_QUANTUM"]
    try:
        t0 = time.perf_counter()
        model, toas = make_test_pulsar(BENCH_PAR, ntoa=NTOA, device=dev,
                                       **SIM_IN_PHASE)
        out["simulate_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fleet_stream(eng, dev, out["stream"], model, toas, eager)
        out["stream"]["step_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fleet_fuse(eng, dev, out["fuse"])
        out["fuse"]["step_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fleet_jobs(eng, dev, out["jobs"], model, toas)
        out["jobs"]["step_s"] = time.perf_counter() - t0
        out["memory_reserved"] = torch.cuda.memory_reserved()
        out["stream_stats"] = eng.stats()["stream"]
    finally:
        eng.close(timeout=120)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fleet_restart(dev, out)
    out["restart_step_s"] = time.perf_counter() - t0
    st, fu = out["stream"], out["fuse"]
    out["launches"] = dict(
        stream_open=st["open_launches"]["fused_gram_joint"],
        warm_refit=st["refresh"]["launches"]["fused_gram_joint"],
        fused=fu["steady"]["launches"]["fused_gram_joint"],
        fused_batched=fu["steady"]["launches"]["fused_gram_joint batched"],
        restart_fit=out["restart"]["fit_launches"]["fused_gram_joint"])
    predicted = dict(stream_open=FLEET_MAXITER + 1, warm_refit=FLEET_MAXITER,
                     fused=2 * SERVE_MAXITER,
                     fused_batched=2 * SERVE_MAXITER,
                     restart_fit=SERVE_MAXITER)
    out["launches_predicted"] = predicted
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"fleet: phase 18 {out}")
    check(out["launches"] == predicted,
          f"phase 18 launches {out['launches']}, predicted {predicted}")
    check(out["memory_reserved"] <= MEMORY_LIMIT,
          f"memory_reserved in phase 18: {out['memory_reserved']}")
    return out


# -- phase 19: the multi-GPU layer on one card --------------------------------
PAR_DENSE_NTOA = 32768
PAR_BLOCK = 512
PAR_TIMEOUT_S = 120.0  # each phase-19 group's collective timeout
PAR_LABEL = ("2 ranks on one card through gloo (host staging): not a "
             "multi-card figure")
PAR_MODES = ("mixed", "f64")


def _sharded_steps():
    from pint_tpu_torch.parallel.gls import (
        sharded_gls_step,
        sharded_gls_step_mixed,
    )

    return {"mixed": sharded_gls_step_mixed, "f64": sharded_gls_step}


def _tree_equal(a, b):
    from pint_tpu_torch.runtime.graphs import flatten

    la, lb = flatten(a)[0], flatten(b)[0]
    return len(la) == len(lb) and all(
        torch.equal(x, y) for x, y in zip(la, lb))


def _host_step(out):
    """A step's (dx, cov, chi2, nbad) as numpy."""
    dx, cov, chi2, nbad = out
    return dict(dx=dx.cpu().numpy(), cov=cov.cpu().numpy(),
                chi2=float(chi2), nbad=int(nbad))


def _collective_wait(fn):
    """One call of ``fn`` with every psum and pmax of the port timed on the
    host clock, the card synchronized before and after each: -> (the
    call's ms, the collectives' ms)."""
    from pint_tpu_torch.parallel import mesh as pm

    waits = []
    real = pm.psum, pm.pmax

    def timed(f):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*a, **k)
            torch.cuda.synchronize()
            waits.append(time.perf_counter() - t0)
            return out
        return run

    pm.psum, pm.pmax = timed(real[0]), timed(real[1])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        pm.psum, pm.pmax = real
    return total * 1e3, sum(waits) * 1e3, len(waits)


def _one_call_ms(fn, reps=5):
    """Median CUDA-event ms of single calls (the ranks call in lockstep)."""
    fn()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def _gram_vs_plain(mesh, r, M, Ndiag, T):
    """``fused_gram_joint``'s wrapper against its plain version on this
    rank's operands, formed as ``sharded_gls_step_mixed`` forms them (the
    column norms reduced over ``toa``), at the tolerance of phase 1
    (``kernel_vs_plain``: 3e-6 of scale, bitwise on a rerun)."""
    from pint_tpu_torch.parallel.gls import sharded_column_norms

    X = torch.cat([M / sharded_column_norms(M, mesh)[None, :], r[:, None]],
                  dim=1).contiguous()
    n, p1 = X.shape
    k = T.shape[-1]
    check(fused_gram.fused_block_table(n, k, p1) is not None,
          f"phase 19: ({n}, {k}, {p1}) is outside the kernel's table")
    err = kernel_vs_plain(f"fused_gram_joint ({n}, {k}, {p1})",
                          fused_gram.fused_gram_joint_cuda,
                          fused_gram.fused_gram_joint_plain, T.contiguous(),
                          X, (1.0 / Ndiag).contiguous())
    return dict(shape=[n, k, p1],
                route="wide" if k + p1 > fused_gram.Q_MAX else "narrow",
                max_abs_err=err[0], max_err_vs_plain=err[1])


def _pta_gram_vs_plain(batch):
    """The batched launch against its plain version on the pulsars this
    rank holds, their operands formed as the batch's (sharded) mixed step
    forms them."""
    from pint_tpu_torch.fitting.gls import narrowband_inputs
    from pint_tpu_torch.parallel.gls import sharded_column_norms

    def operands(cm, x):
        r, M, Nd = narrowband_inputs(cm, x)
        T, _ = cm.noise_basis_or_empty(x)
        norm = (_column_norms(M) if batch.mesh is None
                else sharded_column_norms(M, batch.mesh))
        return T, torch.cat([M / norm[None, :], r[:, None]], dim=1), 1.0 / Nd

    T, A, w = (v.contiguous() for v in batch._vmapped(operands)(batch.x0()))
    err = kernel_vs_plain(f"fused_gram_joint batched {tuple(T.shape)}",
                          fused_gram.fused_gram_joint_cuda,
                          fused_gram.fused_gram_joint_plain, T, A, w)
    q = T.shape[-1] + A.shape[-1]
    return dict(shape=[*T.shape, A.shape[-1]],
                route="wide" if q > fused_gram.Q_MAX else "narrow",
                max_abs_err=err[0], max_err_vs_plain=err[1])


def _woodbury_part(spec, mesh, graphed):
    """The bench and MSP sharded steps of each mode on this rank's rows:
    launches counted from 0, results, times; with ``graphed`` also as a
    step program (its collectives split points), twice.  -> (the steps,
    the Gram kernel against its plain version on each pulsar's rows)."""
    from pint_tpu_torch.parallel import mesh as pm
    from pint_tpu_torch.parallel.gls import place_gls_operands
    from pint_tpu_torch.runtime.graphs import ProgramCache

    out, grams = {}, {}
    cache = ProgramCache(pm.mesh_device(mesh))
    for label in ("bench", "msp"):
        ops = spec[label]
        placed = place_gls_operands(mesh, *ops)
        for mode, step in _sharded_steps().items():
            zero_counts()
            got = step(mesh, *placed)
            torch.cuda.synchronize()
            row = dict(launches=read_counts(), rows=placed[0].shape[0],
                       step=_host_step(got))
            if graphed:
                prog = cache.program(
                    lambda *a, f=step: f(mesh, *a),
                    ("sharded", label, mode, pm.mesh_key(mesh)))
                g1, g2 = prog(*placed), prog(*placed)
                row["graphs"] = len(prog.program.segments)
                row["graph_ms"] = _one_call_ms(lambda: prog(*placed))
                plain = (gls_step_woodbury_mixed if mode == "mixed"
                         else gls_step_woodbury)(*ops)
                row["bitwise_eager"] = _tree_equal(got, plain)
                row["bitwise_graph"] = (_tree_equal(g1, plain)
                                        and _tree_equal(g2, plain))
            row["ms"] = _one_call_ms(lambda: step(mesh, *placed))
            row["call_ms"], row["collective_ms"], row["collectives"] = (
                _collective_wait(lambda: step(mesh, *placed)))
            out[f"{label} {mode}"] = row
        grams[label] = _gram_vs_plain(mesh, *placed[:4])
    cache.clear()
    return out, grams


def _dense_part(spec, mesh):
    """The sharded dense step at PAR_DENSE_NTOA TOAs on bench.py's
    composition, each method with the lookahead on and off: the step, its
    host ms and the peak allocation it adds on this rank."""
    from pint_tpu_torch.parallel.dense import sharded_gls_step_full_cov
    from pint_tpu_torch.parallel.gls import place_gls_operands

    placed = place_gls_operands(mesh, *spec["dense"])
    out = {}
    for method in PAR_MODES:
        for lookahead in (True, False):
            gc.collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            got = sharded_gls_step_full_cov(
                mesh, *placed, method=method, block=PAR_BLOCK,
                lookahead=lookahead)
            torch.cuda.synchronize()
            out[f"{method} lookahead={lookahead}"] = dict(
                s=time.perf_counter() - t0, step=_host_step(got),
                peak_extra_bytes=torch.cuda.max_memory_allocated() - base)
            del got
    return out


def _pta_cms(dev):
    """Phase 10's 45 pulsars and a copy of pulsar 0 (an even count)."""
    ntoas = pta_ntoas(PTA_NPSR, seed=0, nmin=PTA_NMIN, nmax=PTA_NMAX)
    pars = pta_pars(PTA_NPSR, PTA_NDMX, seed=0)
    specs = [(par, int(n), i) for i, (par, n) in enumerate(zip(pars, ntoas))]
    specs.append(specs[0])
    cms = []
    for par, n, seed in specs:
        m, t = make_test_pulsar(par, ntoa=n, device=dev,
                                **{**MSP_SIM, "seed": seed})
        cms.append(m.compile(t, device=dev))
    return cms


def _pta_part(dev, mesh):
    """The 46-pulsar batch fitted (maxiter 3) in f64 and in mixed mode:
    unsharded without ``mesh``, else sharded on it; launches counted from
    0 around each fit; then the batched Gram against its plain version on
    this rank's pulsars."""
    t0 = time.perf_counter()
    batch = PTABatch(_pta_cms(dev))
    out = dict(sim_s=time.perf_counter() - t0)
    if mesh is not None:
        batch.shard(mesh)
    for mode in PAR_MODES:
        zero_counts()
        captures = batch.programs.captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xs, chi2 = batch.fit(maxiter=3, mode=mode)
        torch.cuda.synchronize()
        out[mode] = dict(fit_s=time.perf_counter() - t0,
                         launches=read_counts(), steps=batch.steps_taken,
                         captures=batch.programs.captures - captures,
                         xs=xs.cpu().numpy(), chi2=chi2.cpu().numpy(),
                         sigma=np.sqrt(np.abs(np.diagonal(
                             batch.cov, axis1=1, axis2=2))))
    out["nlocal"] = batch.nlocal
    out["gram"] = _pta_gram_vs_plain(batch)
    return out


def _pta_halves(dev):
    """The unsharded batches of each half of the 46 pulsars, padded to the
    whole batch's TOA count (a rank's share on the 2 x 1 mesh), fitted as
    ``_pta_part`` fits: -> the fits' xs and chi2 by mode, halves in
    order."""
    cms = _pta_cms(dev)
    ntoa = max(cm.bundle.ntoa for cm in cms)
    half = len(cms) // 2
    out = {}
    for mode in PAR_MODES:
        fits = [PTABatch(part, ntoa=ntoa).fit(maxiter=3, mode=mode)
                for part in (cms[:half], cms[half:])]
        out[mode] = [dict(xs=xs.cpu().numpy(), chi2=chi2.cpu().numpy())
                     for xs, chi2 in fits]
    return out


def _group_a(spec, mesh, dev):
    """Group A, NCCL at world size 1 (a 1 x 1 mesh): the sharded steps
    eager and graphed against the unsharded steps of this process, the
    one-rank dense peak, the unsharded PTA batch of 46 pulsars and the
    unsharded batches of its halves."""
    woodbury, grams = _woodbury_part(spec, mesh, graphed=True)
    return dict(woodbury=woodbury, grams=grams, dense=_dense_part(spec, mesh),
                pta=_pta_part(dev, None), pta_halves=_pta_halves(dev))


def _dryrun_stages(mesh, dev):
    """``__graft_entry__.py::dryrun_multichip``'s stages 2-4 at this world
    size: the Woodbury steps at n = 2^20 (p 4, k 10), the dense step at an
    n that is not a block multiple (block 256) against the Woodbury chi2,
    and the padded wideband stack; chi2 of each mode, and the f64 step of
    stage 2 unsharded on the whole operands."""
    from pint_tpu_torch.parallel import mesh as pm
    from pint_tpu_torch.parallel.dense import sharded_gls_step_full_cov
    from pint_tpu_torch.parallel.gls import place_gls_operands
    from pint_tpu_torch.parallel.wideband import (
        place_wideband_operands,
        sharded_wideband_step,
        stack_wideband_operands,
    )

    nd = pm.axis_size(mesh, "toa")
    out = {}
    n_big = ((1 << 20) // nd) * nd
    p, k = 4, 10
    rng = np.random.default_rng(12345)
    M = rng.standard_normal((n_big, p))
    M[:, 0] = 1.0
    T = rng.standard_normal((n_big, k))
    r = 1e-6 * rng.standard_normal(n_big)
    Ndiag = 1e-12 * rng.uniform(0.5, 1.5, n_big)
    phi = 1e-12 * rng.uniform(0.1, 1.0, k)
    ops = place_gls_operands(mesh, r, M, Ndiag, T, phi)
    steps = _sharded_steps()
    out["stage2"] = {m: _host_step(steps[m](mesh, *ops)) for m in PAR_MODES}
    out["grams"] = {"stage2": _gram_vs_plain(mesh, *ops[:4])}
    whole = [torch.as_tensor(x, device=dev) for x in (r, M, Ndiag, T, phi)]
    out["stage2"]["unsharded f64"] = _host_step(gls_step_woodbury(*whole))
    del ops, whole
    n_d = 88 * nd
    while n_d % 256 == 0:
        n_d += nd
    sl = slice(0, n_d)
    ops = place_gls_operands(mesh, r[sl], M[sl], Ndiag[sl], T[sl], phi)
    out["stage3"] = dict(
        n=n_d, woodbury=_host_step(steps["f64"](mesh, *ops)),
        **{m: _host_step(sharded_gls_step_full_cov(
            mesh, *ops, method=m, block=256)) for m in PAR_MODES})
    n_wb = 44 * nd + 1
    r_t = 1e-6 * rng.standard_normal(n_wb)
    r_dm = 2e-4 * rng.standard_normal(n_wb)
    M_t = rng.standard_normal((n_wb, p))
    M_t[:, 0] = 1.0
    M_dm = rng.standard_normal((n_wb, p))
    M_dm[:, 0] = 0.0
    Nd_t = 1e-12 * rng.uniform(0.5, 1.5, n_wb)
    Nd_dm = 4e-8 * rng.uniform(0.5, 1.5, n_wb)
    T_wb = rng.standard_normal((n_wb, k))
    stacked = stack_wideband_operands(
        *(torch.as_tensor(x, device=dev) for x in
          (r_t, r_dm, M_t, M_dm, Nd_t, Nd_dm, T_wb, phi)), multiple=nd)
    args = place_wideband_operands(mesh, *stacked)
    out["stage4"] = dict(rows=stacked[0].shape[0], **{
        m: _host_step(sharded_wideband_step(mesh, *args, method=m))
        for m in PAR_MODES})
    out["grams"]["stage4"] = _gram_vs_plain(mesh, *args[:4])
    return out


def _group_b(spec, mesh, dev):
    """Group B, gloo with two ranks on the card: the bench and MSP steps
    2-way on ``toa``, the dryrun's stages 2-4, the dense step, and the
    PTA batch 2-way on ``pulsar``."""
    from pint_tpu_torch.parallel import mesh as pm

    woodbury, grams = _woodbury_part(spec, mesh, graphed=False)
    stages = _dryrun_stages(mesh, dev)
    grams.update(stages.pop("grams"))
    out = dict(woodbury=woodbury, grams=grams, stages=stages,
               dense=_dense_part(spec, mesh))
    pta_mesh = pm.make_mesh(n_toa_shards=1, n_pulsar_shards=2,
                            device="cuda")
    out["pta"] = _pta_part(dev, pta_mesh)
    return out


def parallel_child(group, rank, world, store, spec_path, results):
    """A rank of phase 19 in a process of its own: joins its group
    (``group`` 'A': NCCL, or 'B': gloo) through the ``file://`` store,
    runs its part on the card and puts (rank, 'ok', what it measured) on
    ``results``, or (rank, 'error', the traceback) and exits non-zero.
    It checks that it imported nothing of JAX or the JAX package and that
    it built nothing: the parent built the CUDA libraries, which this
    process loads by their sources' hash."""
    import traceback

    import torch.distributed as dist

    from pint_tpu_torch.ops import _cuda_build
    from pint_tpu_torch.parallel import mesh as pm

    nvcc = []
    real_nvcc = _cuda_build._nvcc
    _cuda_build._nvcc = lambda: nvcc.append(1) or real_nvcc()
    try:
        pm.initialize_distributed(
            f"file://{store}", world, rank,
            backend="nccl" if group == "A" else "gloo", device="cuda",
            timeout=PAR_TIMEOUT_S)
        dev = pm._joined["device"]
        spec = {k: tuple(t.to(dev) for t in v)
                for k, v in torch.load(spec_path).items()}
        mesh = pm.make_mesh(device="cuda")
        out = (_group_a if group == "A" else _group_b)(spec, mesh, dev)
        out.update(
            rank=rank, backend=dist.get_backend(), nvcc=len(nvcc),
            memory_reserved=torch.cuda.memory_reserved(),
            barred=sorted(m for m in sys.modules
                          if m.split(".")[0] in ("jax", "pint_tpu")))
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_group(group, world, spec_path, tmp, timeout=900.0):
    """Spawn ``world`` ranks of ``group`` and collect them: every rank's
    result, rank order; a rank that fails, exits non-zero or says
    nothing fails the phase (the others are then stopped)."""
    import queue

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = str(Path(tmp) / f"store-{group}")
    procs = [ctx.Process(target=parallel_child,
                         args=(group, r, world, store, spec_path, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        deadline = time.perf_counter() + timeout
        while len(got) + len(errors) < world:
            try:
                rank, status, value = results.get(
                    timeout=max(1.0, deadline - time.perf_counter()))
            except queue.Empty:
                errors.append(f"group {group}: no answer in {timeout} s")
                break
            if status == "ok":
                got[rank] = value
            else:
                errors.append(f"group {group} rank {rank}:\n{value}")
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    check(not errors and codes == [0] * world,
          f"phase 19 group {group}: exit codes {codes}; "
          + "\n".join(errors))
    return [got[r] for r in range(world)]


def _f64_gates(label, got, want, gate):
    """The sharded f64 step against the unsharded one: chi2 rtol 1e-10
    and the same degenerate count, as the reference's sharded gates
    (tests/test_sharded_gls.py); dx rtol 1e-10 of each component or of its
    sigma, whichever is larger, and cov 1e-8 of sigma_i sigma_j.  The
    reference's gates are element-wise (dx rtol 1e-10 and cov rtol 1e-8
    of the element itself): they hold on its 64-TOA pulsar (and the CPU
    twins), but at 1e5 TOAs a near-zero element (the MSP's offset step,
    an off-diagonal covariance) moves more than that under any reordering
    of the sums.  Printed: both forms, and the gap in sigma beside the
    unsharded step's own spread under reordered TOAs."""
    sig = np.sqrt(np.abs(np.diag(want["cov"])))
    gap = np.abs(got["dx"] - want["dx"])
    rel_dx = gap / np.maximum(np.abs(want["dx"]), 1e-300)
    cgap = np.abs(got["cov"] - want["cov"])
    err = dict(
        dx=float(np.max(rel_dx)), worst=int(np.argmax(rel_dx)),
        dx_scaled=float(np.max(gap / np.maximum(np.abs(want["dx"]), sig))),
        dx_gap_sigma=float(np.max(gap / sig)),
        cov=float(np.max(cgap / np.maximum(np.abs(want["cov"]), 1e-300))),
        cov_scaled=float(np.max(cgap / np.outer(sig, sig))),
        chi2=abs(got["chi2"] - want["chi2"]) / abs(want["chi2"]))
    gate(err["dx_scaled"] <= 1e-10 and err["cov_scaled"] <= 1e-8
         and err["chi2"] <= 1e-10 and got["nbad"] == want["nbad"],
         f"{label}: sharded f64 step off the unsharded one: {err}")
    return err


def _mixed_gates(label, got, want, gate):
    """The reference's sharded mixed gates: dx rtol 2e-3 with atol 2e-6
    of its largest component, chi2 1e-6."""
    scale = np.max(np.abs(want["dx"]))
    err = dict(dx=float(np.max(np.abs(got["dx"] - want["dx"])) / scale),
               chi2=abs(got["chi2"] - want["chi2"]) / abs(want["chi2"]))
    gate(np.allclose(got["dx"], want["dx"], rtol=2e-3, atol=2e-6 * scale)
         and err["chi2"] <= 1e-6,
          f"{label}: sharded mixed step off the unsharded one: {err}")
    return err


def parallel_phase(dev):
    """Phase 19: the multi-GPU layer on one card.  The parent simulates
    the operands (bench.py's pulsar and the binary MSP at 1e5 TOAs,
    bench.py's composition at 32768 for the dense step), takes their
    unsharded steps and saves them for two groups of spawned ranks:
    A, NCCL at world size 1, and B, gloo with two ranks on the card.
    Gates: group A bitwise the unsharded steps, eager and graphed; group B
    within the reference's sharded gates of the parent's unsharded steps
    (mixed as the reference's; f64 with dx and cov scaled by sigma, see
    ``_f64_gates``), one ``fused_gram_joint`` launch a mixed step a rank
    (the MSP's on the wide path) and none on the f64 route; the dryrun's
    stage gates; each dense step within the step gates of the Woodbury
    step, each rank's dense peak at most 0.65 of the one-rank peak; the
    PTA batch (46 pulsars) 2-way on ``pulsar``, each rank bitwise the
    unsharded batch of its own pulsars in f64 and mixed mode, in mixed
    mode within the reference's sharded mixed gates of the unsharded
    batch of all 46 and in f64 within 1e-6 of it in xs (scaled as
    ``_f64_gates`` scales dx) and 1e-8 in chi2, one batched launch a
    replay and a warm-up a rank; every rank's Gram kernel against its
    plain version on its own operands (in the ranks: ``_gram_vs_plain``).
    -> what the kernels line reports."""
    import tempfile

    t_phase = time.perf_counter()
    failures = []

    def gate(cond, what):
        """A check of the phase, all of them reported together."""
        if not cond:
            failures.append(what)

    spec, want = {}, {}
    for label, par, n, sim in (
            ("bench", BENCH_PAR, NTOA, SIM),
            ("msp", msp_par(MSP_NDMX, seed=0), NTOA, MSP_SIM),
            ("dense", BENCH_PAR, PAR_DENSE_NTOA, SIM)):
        model, toas = make_test_pulsar(par, ntoa=n, device=dev, **sim)
        cm = model.compile(toas, device=dev)
        ops = step_inputs(cm, cm.x0())
        spec[label] = tuple(t.cpu() for t in ops)
        want[label] = {"f64": _host_step(gls_step_woodbury(*ops))}
        if label != "dense":
            want[label]["mixed"] = _host_step(gls_step_woodbury_mixed(*ops))
        if label == "msp":
            # the f64 step's own spread under reordered TOAs, in sigma:
            # what a reordered sum alone moves it by (R4's yardstick)
            reorder_gaps = ordering_gaps(model, toas, dev, seeds=range(2))
        del model, toas, cm, ops
    out = dict(label=PAR_LABEL, build_s=time.perf_counter() - t_phase,
               msp_f64_reorder_gap_sigma=reorder_gaps)
    with tempfile.TemporaryDirectory() as tmp:
        spec_path = str(Path(tmp) / "operands.pt")
        torch.save(spec, spec_path)
        del spec
        t0 = time.perf_counter()
        (a,) = run_group("A", 1, spec_path, tmp)
        out["group_a_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        b = run_group("B", 2, spec_path, tmp)
        out["group_b_s"] = time.perf_counter() - t0
    for r in [a, *b]:
        gate(not r["barred"] and r["nvcc"] == 0,
             f"phase 19 rank {r['rank']} ({r['backend']}): imported "
             f"{r['barred']}, ran nvcc {r['nvcc']} times")
    gate(a["backend"] == "nccl" and [r["backend"] for r in b]
         == ["gloo", "gloo"], "phase 19: the groups' backends")

    # group A: bitwise, eager and graphed, one launch a mixed step
    for key, row in a["woodbury"].items():
        label, mode = key.split()
        gate(row["bitwise_eager"] and row["bitwise_graph"],
             f"phase 19 group A {key}: not bitwise the unsharded step")
        n_mixed = 1 if mode == "mixed" else 0
        gate(row["launches"]["fused_gram_joint"] == n_mixed
             and row["launches"]["fused_gram_joint wide"]
             == (n_mixed if label == "msp" else 0),
             f"phase 19 group A {key}: launches {row['launches']}")
    # group B: the reference's sharded gates, launches per rank
    gates = {}
    for key in b[0]["woodbury"]:
        label, mode = key.split()
        rows = [r["woodbury"][key] for r in b]
        gate(all(np.array_equal(rows[0]["step"]["dx"], x["step"]["dx"])
                 for x in rows), f"phase 19 {key}: ranks disagree")
        gates[key] = (_mixed_gates if mode == "mixed" else _f64_gates)(
            f"phase 19 group B {key}", rows[0]["step"], want[label][mode],
            gate)
        n_mixed = 1 if mode == "mixed" else 0
        for x in rows:
            gate(x["rows"] == NTOA // 2
                 and x["launches"]["fused_gram_joint"] == n_mixed
                 and x["launches"]["fused_gram_joint wide"]
                 == (n_mixed if label == "msp" else 0),
                 f"phase 19 group B {key}: {x['rows']} rows, launches "
                 f"{x['launches']}")
    # the dryrun's stages
    st = b[0]["stages"]
    gate(abs(st["stage2"]["mixed"]["chi2"] - st["stage2"]["f64"]["chi2"])
         <= 3e-3 * abs(st["stage2"]["f64"]["chi2"]),
         f"phase 19 stage 2 chi2: {st['stage2']}")
    gates["stage2 f64"] = _f64_gates("phase 19 stage 2", st["stage2"]["f64"],
                                     st["stage2"]["unsharded f64"], gate)
    chi2_ref = st["stage3"]["woodbury"]["chi2"]
    for m, rtol in (("f64", 1e-8), ("mixed", 3e-3)):
        gate(abs(st["stage3"][m]["chi2"] - chi2_ref) <= rtol * chi2_ref,
             f"phase 19 stage 3 {m}: {st['stage3'][m]['chi2']} vs "
             f"{chi2_ref}")
    gate(abs(st["stage4"]["mixed"]["chi2"] - st["stage4"]["f64"]["chi2"])
         <= 3e-3 * abs(st["stage4"]["f64"]["chi2"]),
         f"phase 19 stage 4: {st['stage4']}")
    # the dense step against the Woodbury step; memory per rank
    dense = {}
    for key in a["dense"]:
        method = key.split()[0]
        one = a["dense"][key]
        two = [r["dense"][key] for r in b]
        w = want["dense"]["f64"]
        scale = np.max(np.abs(w["dx"]))
        gaps = {}
        for who, got in (("A", one), ("B", two[0])):
            # phase 11's step gates against the Woodbury f64 step
            gaps[who] = dict(
                dx_rel=float(np.max(np.abs(got["step"]["dx"] - w["dx"]))
                             / scale),
                chi2_rel=abs(got["step"]["chi2"] - w["chi2"])
                / abs(w["chi2"]))
            gate(gaps[who]["dx_rel"] <= 2e-3
                 and gaps[who]["chi2_rel"] <= 1e-3,
                 f"phase 19 dense {key} group {who}: {gaps[who]}")
        ratio = max(x["peak_extra_bytes"] for x in two) / one[
            "peak_extra_bytes"]
        gate(ratio <= 0.65, f"phase 19 dense {key}: a rank's peak "
             f"{[x['peak_extra_bytes'] for x in two]} against one rank's "
             f"{one['peak_extra_bytes']}")
        dense[key] = dict(vs_woodbury=gaps, one_rank_s=one["s"],
                          two_rank_s=[x["s"] for x in two],
                          one_rank_peak=one["peak_extra_bytes"],
                          two_rank_peak=[x["peak_extra_bytes"] for x in two],
                          peak_ratio=ratio)
    # the PTA batch 2-way on pulsar: each rank's pulsars bitwise the
    # unsharded batch of the same pulsars (its half, at the same TOA
    # count), in f64 and in mixed mode; in mixed mode every pulsar also
    # within the reference's sharded mixed gates of the unsharded batch of
    # all 46
    pa, pb = a["pta"], [r["pta"] for r in b]
    half = (PTA_NPSR + 1) // 2
    for mode in PAR_MODES:
        for r, x in enumerate(pb):
            want_h = a["pta_halves"][mode][r]
            sl = slice(r * half, (r + 1) * half)
            gate(np.array_equal(x[mode]["xs"][sl], want_h["xs"])
                 and np.array_equal(x[mode]["chi2"][sl], want_h["chi2"]),
                 f"phase 19 PTA {mode}: rank {r}'s pulsars not bitwise the "
                 "unsharded batch of the same pulsars")

    def f64_gap(xs, chi2, whole):
        """An f64 fit's xs and chi2 against the unsharded 46-pulsar
        batch's: xs element-wise, in sigma, and scaled as ``_f64_gates``
        scales dx (by each component or its sigma, whichever is larger)."""
        gap = np.abs(xs - whole["xs"])
        sig = np.maximum(whole["sigma"], 1e-300)
        return dict(
            xs=float(np.max(gap / np.maximum(np.abs(whole["xs"]), 1e-300))),
            xs_sigma=float(np.max(gap / sig)),
            xs_scaled=float(np.max(gap / np.maximum(np.abs(whole["xs"]),
                                                    sig))),
            chi2=float(np.max(np.abs(chi2 - whole["chi2"])
                              / np.abs(whole["chi2"]))))

    # the unsharded batches of the halves against the unsharded batch of
    # all 46, on the same card: what the batch size alone moves an f64 fit
    halves = a["pta_halves"]["f64"]
    pta_batch_size_gap = f64_gap(
        np.concatenate([h["xs"] for h in halves]),
        np.concatenate([h["chi2"] for h in halves]), pa["f64"])
    pta_gaps = []
    for x in pb:
        f, m, ma = x["f64"], x["mixed"], pa["mixed"]
        rel = {f"f64_{k}": v for k, v in f64_gap(
            f["xs"], f["chi2"], pa["f64"]).items()}
        rel.update(
            mixed_xs=float(max(np.max(np.abs(u - v)) / np.max(np.abs(v))
                               for u, v in zip(m["xs"], ma["xs"]))),
            mixed_chi2=float(np.max(np.abs(m["chi2"] - ma["chi2"])
                                    / np.abs(ma["chi2"]))))
        pta_gaps.append(rel)
        # f64: xs within 1e-6 of each component or its sigma and chi2
        # within 1e-8 of the unsharded 46-batch, about 15 times what the
        # batch size alone moves the unsharded f64 fit on the card
        # (pta_batch_size_gap: 7.5e-8 and 6.3e-10 on the H100).  The
        # reference's rtol 1e-8 and 1e-10 sit below that: on the card a
        # sum over the TOA axis rounds differently in a batch of 23 than
        # in one of 46 (profiling/torch_batch_size.py), the normal
        # equations amplify it and three iterations carry it; on the CPU
        # the batches are bitwise alike (the CPU twins keep the
        # reference's gates)
        gate(rel["f64_xs_scaled"] <= 1e-6 and rel["f64_chi2"] <= 1e-8,
             f"phase 19 PTA f64: sharded off the unsharded batch: {rel}")
        gate(all(np.allclose(u, v, rtol=2e-3, atol=2e-6 * np.max(np.abs(v)))
                 for u, v in zip(m["xs"], ma["xs"]))
             and rel["mixed_chi2"] <= 1e-6,
             f"phase 19 PTA mixed: sharded off the unsharded batch: {rel}")
        # 4 replays + 1 capture's warm-up, and one more: the capture
        # replays the segment that holds the Gram when it splits at the
        # Gram's all-reduce
        gate(x["nlocal"] == (PTA_NPSR + 1) // 2
             and m["launches"]["fused_gram_joint batched"]
             == m["launches"]["fused_gram_joint wide"]
             == m["steps"] + 2 == 6 and m["captures"] == 1
             and f["launches"]["fused_gram_joint"] == 0,
             f"phase 19 PTA: {x['nlocal']} pulsars a rank, launches "
             f"{m['launches']} in {m['steps']} steps, f64 {f['launches']}")
    gate(pa["mixed"]["launches"]["fused_gram_joint batched"] == 5
         and pa["f64"]["launches"]["fused_gram_joint"] == 0,
         f"phase 19 PTA unsharded launches {pa['mixed']['launches']}")

    out.update(
        gates=gates, dense=dense,
        group_a={k: {f: v[f] for f in ("ms", "graph_ms", "call_ms",
                                       "collective_ms", "graphs",
                                       "launches")}
                 for k, v in a["woodbury"].items()},
        group_b={k: [{f: r["woodbury"][k][f] for f in
                      ("ms", "call_ms", "collective_ms", "collectives",
                       "launches")} for r in b] for k in b[0]["woodbury"]},
        stages=dict(stage2_chi2={m: st["stage2"][m]["chi2"]
                                 for m in PAR_MODES},
                    stage3=dict(n=st["stage3"]["n"], chi2={
                        m: st["stage3"][m]["chi2"] for m in PAR_MODES},
                        woodbury_chi2=chi2_ref),
                    stage4=dict(rows=st["stage4"]["rows"], chi2={
                        m: st["stage4"][m]["chi2"] for m in PAR_MODES})),
        pta=dict(unsharded_fit_s={m: pa[m]["fit_s"] for m in PAR_MODES},
                 sharded_fit_s=[{m: x[m]["fit_s"] for m in PAR_MODES}
                                for x in pb],
                 sim_s=[pa["sim_s"]] + [x["sim_s"] for x in pb],
                 gaps=pta_gaps, batch_size_gap_f64=pta_batch_size_gap,
                 launches=[x["mixed"]["launches"] for x in pb],
                 unsharded_launches=pa["mixed"]["launches"]),
        kernel_vs_plain=dict(A=a["grams"], A_pta=pa["gram"],
                             B=[r["grams"] for r in b],
                             B_pta=[x["gram"] for x in pb]),
        memory_reserved=dict(A=a["memory_reserved"],
                             B=[r["memory_reserved"] for r in b]),
        phase_s=time.perf_counter() - t_phase)
    out["failures"] = failures
    log(f"parallel: phase 19 ({PAR_LABEL}) {out}")
    check(not failures, "phase 19: " + "; ".join(failures))
    return out



# -- phase 20: the fleet's multi-card half on one card -------------------------
#: the gang engine: 4 executors on the card, one gang of 2 rank processes
#: (gloo: they share the card) and 2 singles; bench.py's pulsar and the
#: binary MSP at 1e5 TOAs (bucket 131072) are above the threshold
GANG_ENGINE = dict(replicas=4, gangs=1, gang_size=2, gang_threshold=65536,
                   max_batch=1, inflight=1, quarantine_n=2, probe_ms=200)
GANG_MAXITER = 3
#: the reshape engine: a small key pumped while the partition flips, a big
#: one (8192 TOAs, at the threshold) that the gang shards
GANG_RESHAPE = dict(small=2048, big=8192, threshold=8192, pump_s=0.2)


def _gang_targeted(eng, rep, req):
    """``req`` admitted and stacked as the engine's collector does it, then
    submitted to executor ``rep`` itself: -> (its future, the batch)."""
    from concurrent.futures import Future

    from pint_tpu_torch.serve.engine import _Pending

    req.validate()
    p = _Pending(req, Future(), time.monotonic())
    rec, sess, padded, ntoa = eng._session_for_request(req)
    p.record, p.session, p.bundle, p.ntoa = rec, sess, padded, ntoa
    if req.op == "fit":
        tol = req.tol_chi2 if req.tol_chi2 is not None else (
            1e-10 if sess.mode == "f64" else 3e-6)
        key = ("fit", sess.composition, sess.bucket, sess.mode,
               int(req.maxiter), float(tol))
    else:
        key = ("residuals", sess.composition, sess.bucket,
               bool(req.subtract_mean))
    work = eng._assemble(key, [p])
    check(rep.submit(work, block=True, force=True),
          f"phase 20: {rep.tag} refused a targeted batch")
    return p.future, work


def gang_rank_gram(ctx, skey, ops_by_rank):
    """On a gang rank (``RankGroup.call``): the ``fused_gram_joint`` wrapper
    against its plain version on this rank's operands of a batch's row 0,
    formed as the rank's sharded mixed step forms them at x = 0 (its rows
    of the residuals, design, sigma and basis, the column norms reduced
    over ``toa``), at phase 1's tolerance, bitwise on a rerun."""
    import copy

    from pint_tpu_torch.fitting.gls import narrowband_inputs
    from pint_tpu_torch.serve.batcher import tree_map

    sess = ctx.sessions[skey]
    rows = tree_map(lambda a: torch.as_tensor(np.asarray(a)[0]).to(
        ctx.device), ops_by_rank[ctx.rank][0])
    cm = copy.copy(sess.cm)
    cm.bundle = rows._replace(tzr=sess.cm.bundle.tzr)
    x = cm.x0()
    r, M, Nd = narrowband_inputs(cm, x)
    T, _ = cm.noise_basis_or_empty(x)
    out = _gram_vs_plain(ctx.mesh, r, M, Nd, T)
    out["rank"] = ctx.rank
    return out


def _fit_vs(label, got, want):
    """A gang's fit against the same engine's single-replica fit of the
    same batch: deltas in units of the single's sigma, uncertainties and
    chi2 relative (gates in ``gang_phase``)."""
    sig = want.uncertainties
    return dict(
        label=label,
        dx_sigma=float(np.max(np.abs(got.deltas - want.deltas) / sig)),
        unc_rel=float(np.max(np.abs(got.uncertainties / sig - 1.0))),
        chi2_rel=abs(got.chi2 - want.chi2) / abs(want.chi2),
        converged=(got.converged, want.converged))


def _res_vs(got, want):
    scale = float(np.max(np.abs(want.residuals_s)))
    return dict(rel=float(np.max(np.abs(got.residuals_s - want.residuals_s))
                          / scale),
                chi2_rel=abs(got.chi2 - want.chi2) / abs(want.chi2))


def _rank_counts(gang):
    return [dict(c) for c in gang.group.counts]


def _rank_delta(before, after, key):
    return [a.get(key, 0) - b.get(key, 0) for b, a in zip(before, after)]


def _gang_serve(eng, dev, label, par, toas, out):
    """One pulsar served by the gang (residuals, then a fit of
    GANG_MAXITER), held to the same engine's single replica r0 on the same
    batches, each rank's Gram held to its plain version, launches counted
    per rank (from 0 in the parent, from each rank's running count in the
    ranks), a steady repeat bitwise that builds and captures nothing."""
    from pint_tpu_torch.serve import FitRequest, ResidualsRequest
    from pint_tpu_torch.serve.fabric.gang import rank_operands

    gang, r0 = eng.pool.gangs[0], eng.pool.singles[0]
    res = {}
    c0 = _rank_counts(gang)
    zero_counts()
    t0 = time.perf_counter()
    rg = eng.submit(ResidualsRequest(par=par, toas=toas)).result(timeout=900)
    res["residuals_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fg = eng.submit(FitRequest(par=par, toas=toas, maxiter=GANG_MAXITER)
                    ).result(timeout=900)
    res["fit_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    parent = read_counts()
    c1 = _rank_counts(gang)
    res["launches"] = dict(
        parent=parent,
        ranks=_rank_delta(c0, c1, "fused_gram_joint"),
        rank_builds=_rank_delta(c0, c1, "builds"),
        rank_captures=_rank_delta(c0, c1, "captures"),
        rank_nvcc=[c.get("nvcc", 0) for c in c1])
    check(rg.replica == "g0" and fg.replica == "g0"
          and rg.bucket == 131072 and fg.bucket == 131072,
          f"phase 20 {label}: served by {rg.replica}, {fg.replica} at "
          f"bucket {rg.bucket}")
    check(not any(parent.values())
          and all(n >= GANG_MAXITER for n in res["launches"]["ranks"])
          and res["launches"]["rank_nvcc"] == [0, 0],
          f"phase 20 {label}: launches {res['launches']} (none in the "
          f"parent, >= {GANG_MAXITER} a rank, no nvcc in a rank)")
    # the same batches on the single replica r0 of the same engine
    f1, _ = _gang_targeted(eng, r0, ResidualsRequest(par=par, toas=toas))
    r1 = f1.result(timeout=900)
    f1, _ = _gang_targeted(eng, r0, FitRequest(par=par, toas=toas,
                                               maxiter=GANG_MAXITER))
    s1 = f1.result(timeout=900)
    check(r1.replica == "r0" and s1.replica == "r0",
          f"phase 20 {label}: targeted single served by {r1.replica}")
    res["residuals_vs_single"] = _res_vs(rg, r1)
    res["fit_vs_single"] = _fit_vs(label, fg, s1)
    check(res["residuals_vs_single"]["rel"] <= 1e-9
          and res["residuals_vs_single"]["chi2_rel"] <= 1e-9
          and res["fit_vs_single"]["dx_sigma"] <= 1e-4
          and res["fit_vs_single"]["unc_rel"] <= 1e-6
          and res["fit_vs_single"]["chi2_rel"] <= 1e-8
          and fg.converged == s1.converged,
          f"phase 20 {label}: the gang vs the single replica "
          f"{res['residuals_vs_single']}, {res['fit_vs_single']}")
    # each rank's Gram kernel against its plain version, on its operands
    _, work = _gang_targeted(eng, r0, ResidualsRequest(par=par, toas=toas))
    skey = (work.session.cid, work.session.bucket)
    res["kernel_vs_plain"] = gang.group.call(
        gang_rank_gram, skey,
        rank_operands(work.ops, int(work.key[2]), gang.width))
    # a steady repeat: bitwise, no build and no capture anywhere
    caps = sum(r.programs.captures for r in eng.pool.replicas)
    c2 = _rank_counts(gang)
    t0 = time.perf_counter()
    rg2 = eng.submit(ResidualsRequest(par=par, toas=toas)).result(timeout=900)
    fg2 = eng.submit(FitRequest(par=par, toas=toas, maxiter=GANG_MAXITER)
                     ).result(timeout=900)
    res["steady_s"] = time.perf_counter() - t0
    c3 = _rank_counts(gang)
    res["steady"] = dict(
        bitwise=bool(np.array_equal(rg2.residuals_s, rg.residuals_s)
                     and np.array_equal(fg2.deltas, fg.deltas)
                     and fg2.chi2 == fg.chi2),
        rank_builds=_rank_delta(c2, c3, "builds"),
        rank_captures=_rank_delta(c2, c3, "captures"),
        rank_launches=_rank_delta(c2, c3, "fused_gram_joint"),
        parent_captures=sum(r.programs.captures for r in eng.pool.replicas)
        - caps)
    check(res["steady"]["bitwise"]
          and res["steady"]["rank_builds"] == [0, 0]
          and res["steady"]["rank_captures"] == [0, 0]
          and res["steady"]["rank_launches"] == [GANG_MAXITER] * 2
          and res["steady"]["parent_captures"] == 0,
          f"phase 20 {label}: steady repeat {res['steady']}")
    res["rank_peak_bytes"] = [c.get("peak_bytes", 0) for c in c3]
    log(f"gang: {label} {res}")
    out[label] = res
    return rg


def _gang_faults(eng, par, toas, base, out):
    """A NaN pinned at @g0: the gang quarantines as one unit, its big work
    re-routes to a single, the group-wide canary keeps failing while the
    fault is armed and re-admits the gang once it clears.  Then one rank
    killed (stopped first, so the batch is in flight when it dies): the
    batch fails with a typed GuardTimeout naming the rank, re-routes, and
    the group starts anew and serves bitwise its earlier answer."""
    import signal

    from pint_tpu_torch.obs import metrics as obs_metrics
    from pint_tpu_torch.runtime import faults
    from pint_tpu_torch.serve import ResidualsRequest
    from pint_tpu_torch.serve.fabric import LIVE, QUARANTINED

    gang = eng.pool.gangs[0]
    mc = obs_metrics.counter
    gq0 = mc("serve.fabric.gang_quarantines").value
    with faults.inject("nan:inf@g0"):
        served = [eng.submit(ResidualsRequest(par=par, toas=toas)
                             ).result(timeout=900).replica
                  for _ in range(3)]
        quarantined = gang.state == QUARANTINED
        p0 = mc("serve.fabric.probes").value
        deadline = time.monotonic() + 30
        while (mc("serve.fabric.probes").value <= p0
               and time.monotonic() < deadline):
            time.sleep(0.05)
        still = gang.state == QUARANTINED
    t0 = time.monotonic()
    while gang.state != LIVE and time.monotonic() - t0 < 60:
        time.sleep(0.05)
    nan = dict(served=served, quarantined=quarantined,
               quarantined_while_armed=still,
               gang_quarantines=mc("serve.fabric.gang_quarantines").value
               - gq0,
               readmitted=gang.state == LIVE,
               readmit_s=time.monotonic() - t0)
    log(f"gang: nan at @g0 {nan}")
    check(quarantined and still and nan["readmitted"]
          and nan["gang_quarantines"] >= 1
          and all(s.startswith("r") for s in served[1:]),
          f"phase 20: a NaN pinned at @g0 {nan}")
    out["nan_fault"] = nan

    group = gang.group
    deaths = mc("serve.gang.rank_deaths").value
    os.kill(group.pids[1], signal.SIGSTOP)
    fut, work = _gang_targeted(eng, gang,
                               ResidualsRequest(par=par, toas=toas))
    time.sleep(0.5)  # the batch at its collectives, rank 1 stopped
    t0 = time.monotonic()
    group._procs[1].kill()
    resp = fut.result(timeout=900)
    failed_s = time.monotonic() - t0
    err = work.last_error
    kill = dict(error=type(err).__name__, message=str(err)[:200],
                served_by=resp.replica, kill_to_served_s=failed_s,
                deaths=mc("serve.gang.rank_deaths").value - deaths,
                state=gang.state,
                watchdog_s=group.timeout_s)
    t0 = time.perf_counter()
    gang.start()
    kill["restart_s"] = time.perf_counter() - t0
    fut, _ = _gang_targeted(eng, gang, ResidualsRequest(par=par, toas=toas))
    again = fut.result(timeout=900)
    kill["after_restart"] = dict(
        replica=again.replica,
        bitwise=bool(np.array_equal(again.residuals_s, base.residuals_s)),
        starts=group.starts)
    log(f"gang: a rank killed {kill}")
    check(kill["error"] == "GuardTimeout"
          and "rank 1 of gang g0 exited" in kill["message"]
          and kill["served_by"].startswith("r") and kill["deaths"] == 1
          and failed_s < group.timeout_s
          and kill["after_restart"]["replica"] == "g0"
          and kill["after_restart"]["bitwise"],
          f"phase 20: a killed rank {kill}")
    out["kill"] = kill


def _gang_reshape(dev, tmp, out):
    """The elastic fabric on the card: an engine with a warm ledger, both
    traffic classes warmed on every executor (``chaos.warm_executors``);
    a manual repartition gang -> singles -> gang while a small key is
    pumped (every future completed, none lost); the chaos tool's ``nan``
    leg at every executor of the new partition (``chaos.run_leg``: typed
    futures, quarantine and readmission, no steady build); then the
    Repartitioner's flip: a small flood dissolves the idle gang, and the
    rounds after it build, capture and compile nothing (the new
    executors were prewarmed from the ledger before the swap)."""
    import threading

    from pint_tpu_torch.serve import ResidualsRequest, TimingEngine
    from pint_tpu_torch.serve.fabric.elastic import Repartitioner
    from pint_tpu_torch.tools import chaos

    cfg = GANG_RESHAPE
    # two pulsars of the small key (the chaos warm-up warms capacities 1
    # and 2 with them), one of the big key
    small = []
    for seed in (0, 1):
        m, t_small = make_test_pulsar(BENCH_PAR, ntoa=cfg["small"],
                                      device=dev, **dict(SIM, seed=seed))
        small.append((m.as_parfile(), t_small))
    m, t_big = make_test_pulsar(BENCH_PAR, ntoa=cfg["big"], device=dev,
                                **SIM)
    big = (m.as_parfile(), t_big)
    res = {}
    eng = TimingEngine(
        replicas=4, gangs=1, gang_size=2, gang_threshold=cfg["threshold"],
        max_batch=2, max_wait_ms=2.0, inflight=1, max_queue=256,
        quarantine_n=2, probe_ms=200,
        warm_ledger=str(Path(tmp) / "gang-ledger.json"),
        elastic=dict(window_ms=3_600_000))
    try:
        t0 = time.perf_counter()
        chaos.warm_executors(eng, small, big, timeout=900.0)
        res["warm_s"] = time.perf_counter() - t0
        pumped, stop = [], threading.Event()

        def pump():
            while not stop.is_set():
                f = eng.submit(ResidualsRequest(par=small[0][0],
                                                toas=small[0][1]))
                pumped.append(f)
                f.result(timeout=300)

        th = threading.Thread(target=pump)
        th.start()
        try:
            time.sleep(cfg["pump_s"])
            res["to_singles_s"] = eng.pool.repartition(gangs=0)
            res["to_gang_s"] = eng.pool.repartition(gangs=1, gang_size=2)
        finally:
            stop.set()
            th.join(300)
        pump_out = chaos.classify(pumped, 300.0)
        res["pump"] = {k: pump_out[k] for k in
                       ("offered", "completed", "rejected", "failed",
                        "typed")}
        res["partition"] = [r.tag for r in eng.pool.replicas]
        check(not th.is_alive() and pump_out["typed"]
              and pump_out["completed"] == pump_out["offered"] > 0
              and eng.pool.reshapes == 2 and eng.router.epoch == 2
              and res["partition"][0] == "g1",
              f"phase 20: manual repartition under a pump {res}")
        # the chaos tool's legs at every executor of the new partition
        t0 = time.perf_counter()
        chaos.warm_executors(eng, small, big, timeout=900.0)
        legs = []
        for site in chaos.executor_sites(eng):
            leg = chaos.run_leg(eng, site["tag"], "nan", small=small,
                                big=big, timeout=300.0)
            legs.append({k: leg[k] for k in
                         ("tag", "kind", "ok", "fired", "quarantined",
                          "readmitted", "steady_traces")})
        res["chaos"] = dict(s=time.perf_counter() - t0, legs=legs)
        check(all(leg["ok"] for leg in legs),
              f"phase 20: the chaos legs {res['chaos']}")
        rp = Repartitioner(eng.pool, eng.router, window_ms=40,
                           hysteresis=1, min_singles=1, gang_size=2)
        try:
            t0 = time.perf_counter()
            deadline = time.monotonic() + 120
            while eng.pool.gangs and time.monotonic() < deadline:
                got = chaos.classify(
                    [eng.submit(ResidualsRequest(par=p, toas=t))
                     for p, t in small], 300.0)
                check(got["completed"] == got["offered"],
                      f"phase 20: a small round {got}")
        finally:
            rp.stop()
        with eng.pool._reshape_lock:  # the flip's swap has ended
            res["dissolve_s"] = time.perf_counter() - t0
        check(not eng.pool.gangs, "phase 20: the gang never dissolved")
        b0, c0 = chaos._builds(), chaos._fresh_compiles(eng)
        steady = chaos.classify(
            [eng.submit(ResidualsRequest(par=p, toas=t))
             for p, t in small + [big] + small], 300.0)
        res["after_flip"] = dict(
            completed=steady["completed"], offered=steady["offered"],
            builds=chaos._builds() - b0,
            compiles=chaos._fresh_compiles(eng) - c0)
        res["elastic"] = eng.stats()["elastic"]
        check(res["after_flip"]["builds"] == 0
              and res["after_flip"]["compiles"] == 0
              and steady["completed"] == steady["offered"]
              and res["elastic"]["dissolved"] >= 1,
              f"phase 20: the Repartitioner's flip {res}")
    finally:
        eng.close(timeout=300)
    log(f"gang: reshapes {res}")
    out["reshape"] = res


def gang_phase(dev):
    """Phase 20: the fleet's multi-card half on the one card — a gang of
    two rank processes sharing the card through gloo beside two singles,
    serving bench.py's pulsar and the binary MSP at 1e5 TOAs, the unit
    health of the gang, a killed rank, the elastic fabric's reshapes, a
    bounded chaos sweep and the operator tools on the phase's trace.
    Every figure of the gang is "2 ranks on one card through gloo: not a
    multi-card figure"."""
    import contextlib
    import io
    import tempfile

    from pint_tpu_torch.obs import export as obs_export
    from pint_tpu_torch.obs import trace as obs_trace
    from pint_tpu_torch.serve import TimingEngine
    from pint_tpu_torch.simulation import make_population
    from pint_tpu_torch.tools import fleetview, traceview

    t_phase = time.perf_counter()
    out = {}
    tmp = tempfile.mkdtemp(prefix="pint-tpu-gang-phase-")
    t0 = time.perf_counter()
    bpars, btoas = make_population(
        BENCH_PAR, 1, ntoa=NTOA, spread=SERVE_SPREAD, obs=None, device=dev,
        **SIM_IN_PHASE)
    mpars, mtoas = make_population(
        msp_par(MSP_NDMX), 1, ntoa=NTOA, spread=SERVE_SPREAD, obs=None,
        device=dev, **MSP_SIM)
    out["population_s"] = time.perf_counter() - t0
    with obs_trace.tracing(clear=True):
        eng = TimingEngine(**GANG_ENGINE)
        try:
            gang = eng.pool.gangs[0]
            check([r.tag for r in eng.pool.replicas] == ["g0", "r0", "r1"]
                  and gang.width == 2 and gang.group.backend == "gloo",
                  f"phase 20: the pool {eng.pool.stats()}")
            t0 = time.perf_counter()
            gang.start()
            out["start_s"] = time.perf_counter() - t0
            out["group"] = gang.group.stats()
            check(out["group"]["barred"] == [[], []],
                  f"phase 20: a rank imported JAX: {out['group']}")
            base = _gang_serve(eng, dev, "bench", bpars[0], btoas, out)
            _gang_serve(eng, dev, "msp", mpars[0], mtoas, out)
            _gang_faults(eng, bpars[0], btoas, base, out)
            out["gangs"] = eng.stats()["gangs"]
            out["memory_reserved"] = torch.cuda.memory_reserved()
        finally:
            eng.close(timeout=300)
        del btoas, mtoas
        _gang_reshape(dev, tmp, out)
        trace = str(Path(tmp) / "phase20-trace.json")
        obs_export.write_chrome_trace(trace)
    tools = {}
    for name, mod, argv in (
            ("traceview", traceview, [trace, "--top", "8"]),
            ("fleetview", fleetview,
             [trace, "--top", "4", "--perfetto",
              str(Path(tmp) / "phase20-fleet.json")])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(argv)
        text = buf.getvalue()
        tools[name] = dict(rc=rc, lines=len(text.splitlines()))
        log(f"gang: {name}\n" + "\n".join(text.splitlines()[:40]))
        tools[name]["text"] = text
    check(tools["traceview"]["rc"] == 0 and tools["fleetview"]["rc"] == 0
          and "[g0]" in tools["fleetview"]["text"]
          and "QUARANTINED" in tools["fleetview"]["text"],
          "phase 20: traceview and fleetview on the phase's trace")
    out["tools"] = {k: {"rc": v["rc"], "lines": v["lines"]}
                    for k, v in tools.items()}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"gang: phase 20 {out}")
    check(out["memory_reserved"] <= MEMORY_LIMIT,
          f"memory_reserved in phase 20: {out['memory_reserved']}")
    return out


#: BASELINE.json configs 2 and 3, the reference's NANOGrav
#: configurations: par text, span (MJD), observing epochs and TOAs an epoch
#: (two ECORR columns an epoch and 60 red-noise columns)
NANOGRAV = {
    "j1713": dict(par=j1713_par, span=J1713_SPAN, nepoch=125, per_epoch=80),
    "b1855": dict(par=b1855_par, span=MSP_SPAN, nepoch=128, per_epoch=64),
}
NANOGRAV_NDMX = 100
#: the 2048-TOA copies held against the CPU: 24 DMX ranges, so that every
#: range holds one of the 32 epochs
NANOGRAV_SMALL = dict(ndmx=24, nepoch=32, per_epoch=64)


def nanograv_inputs(name, ndmx, nepoch, per_epoch):
    """(par text, make_test_pulsar keywords) of a NANOGrav configuration:
    TOAs 1 s apart in each epoch alternating between the receivers'
    sub-bands, the synthetic orbit inside the simulated phases."""
    cfg = NANOGRAV[name]
    span = cfg["span"]
    return cfg["par"](ndmx), dict(
        mjds=epoch_mjds(nepoch, per_epoch, *span), start_mjd=span[0],
        end_mjd=span[1], seed=0, iterations=1, orbit=True,
        orbit_in_phase=True, freqs=NANOGRAV_FREQS)


def nanograv_fit(label, path, make):
    """``drive`` (counts zeroed just before the fit and read just after,
    its rung, launches and step programs checked), then the fit's host
    seconds, its peak allocation and one eager step's CUDA-event ms at
    the fitted state.  -> (fitter, summary)."""
    t0 = time.perf_counter()
    f, launches = drive(path, make, label)
    out = dict(rung=f.guard_report.rung, steps=f.steps_taken, chi2=f.chi2,
               host_s=time.perf_counter() - t0, launches=launches,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    x = f.cm.x0()
    out["step_cuda_ms"] = cuda_ms(lambda: f._gn_step(x, f.mode), reps=5,
                                  warm=1, batch=1)
    log(f"{label} {path} fit: {out}")
    return f, out


def nanograv_downhill(label, make):
    """Config 2's fit through the default entry point: a
    ``DownhillGLSFitter``, its launch counts at 0 just before the fit and
    read just after, ``fused_gram_joint`` launched on the wide path.  It
    is served by the native rung, or by the f64 rung after the native
    rung's result was refused by the numerics guard alone (the mixed
    step's refinement check NaN-poisons an ill-conditioned noise
    system, as the reference's does with its check armed).  Prints the
    iterations, chi2, the rung and its history, the host seconds, the
    peak allocation and one proposal's CUDA-event ms at the fitted state
    (the serving rung's proposal).  -> (fitter, summary)."""
    f = make()
    check(type(f) is DownhillGLSFitter,
          f"{label}: auto_fitter gave {type(f).__name__}")
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    chi2 = f.fit_toas()
    torch.cuda.synchronize()
    rep = f.guard_report
    out = dict(niter=f.niter, converged=f.converged, chi2=chi2,
               rung=rep.rung, history=[list(h) for h in rep.history],
               host_s=time.perf_counter() - t0, launches=read_counts(),
               max_memory_allocated=torch.cuda.max_memory_allocated())
    x = f.cm.x0()
    # the serving rung's proposal
    proposal = f._make_proposal(force_f64=rep.fell_back)
    out["proposal_cuda_ms"] = cuda_ms(lambda: proposal(x), reps=5, warm=1,
                                      batch=1)
    log(f"{label} DownhillGLSFitter: {out}")
    check(math.isfinite(chi2), f"{label}: non-finite chi2")
    check((rep.rung == "native" and not rep.fell_back)
          or (rep.rung == "f64-fallback" and len(rep.history) == 1
              and rep.history[0][0] == "native"
              and rep.history[0][1].startswith("PintTpuNumericsError")),
          f"{label}: served by rung {rep.rung}: {rep.history}")
    n_gram = out["launches"]["fused_gram_joint"]
    check(n_gram > 0 and out["launches"]["fused_gram_joint wide"] == n_gram,
          f"{label}: fused_gram_joint launched {out['launches']}")
    return f, out


def nanograv_config(dev, name):
    """One NANOGrav configuration at full size on the card: its widths
    (the joint Gram on the wide path of fused_block_table), the wide
    kernel against its plain version on the configuration's own operands
    and timed beside its bound, the mixed step at the step gates of the
    f64 step, and its fits.  -> (summary, the fitters by route)."""
    cfg = NANOGRAV[name]
    par, sim = nanograv_inputs(name, NANOGRAV_NDMX, cfg["nepoch"],
                               cfg["per_epoch"])
    ntoa = cfg["nepoch"] * cfg["per_epoch"]
    t0 = time.perf_counter()
    _, toas = make_test_pulsar(par, device=dev, **sim)
    out = dict(ntoa=ntoa, simulate_s=time.perf_counter() - t0)
    cm = ModelBuilder()(par).compile(toas, device=dev)
    x = cm.x0()
    T, A, w = gram_inputs(cm, x)
    n, k = T.shape
    p1 = A.shape[1]
    out["shape"] = [n, k, p1]
    check(n == ntoa and k == 2 * cfg["nepoch"] + 60
          and fused_gram.fused_block_table(n, k, p1) is not None
          and k + p1 > fused_gram.Q_MAX,
          f"{name}: joint Gram (n, k, p1) = {(n, k, p1)} is not on the wide "
          "path of the kernel's table")
    fj = (fused_gram.fused_gram_joint_cuda, fused_gram.fused_gram_joint_plain)
    errs = [kernel_vs_plain("fused_gram_joint", *fj, T, A, w),
            kernel_vs_plain("fused_gram_joint", *fj, T.float(), A, w)]
    out["max_abs_err"] = max(e[0] for e in errs)
    out["max_err_vs_plain"] = max(e[1] for e in errs)
    Yd = (torch.cat([T.float(), A.float()], dim=1)
          * torch.sqrt(w).float()[:, None]).double().contiguous()
    times = time_kernel(lambda: fused_gram.fused_gram_joint_cuda(T, A, w),
                        lambda: fused_gram.fused_gram_joint_plain(T, A, w),
                        lambda: torch.matmul(Yd.T, Yd))
    del times["device_parts"], Yd
    out["kernel"] = dict(times, bound=gram_bound(T, A, w))
    # the mixed step at the step gates of the f64 step; config 2's may
    # instead be NaN-poisoned by the refinement check (the reference's
    # is, with its check armed): then the fit's native rung is refused
    # the same way and the f64 rung serves (nanograv_downhill)
    args = step_inputs(cm, x)
    mixed = gls_step_woodbury_mixed(*args, normalized_cov=True)
    poisoned = name == "j1713" and not math.isfinite(float(mixed[2]))
    gates = step_gates(
        f"{name} mixed", mixed, gls_step_woodbury(*args, normalized_cov=True),
        ntoa=ntoa, gate=not poisoned)
    # (NaN is no JSON value: the kernels line records the poisoning)
    out["mixed_vs_f64"] = "NaN-poisoned" if poisoned else gates
    del cm, args, T, A, w, mixed, gates
    log(f"{name}: {ntoa} TOAs, joint Gram (n, k, p1) = {out['shape']}, "
        f"wide kernel vs plain (T f64, f32) {errs}, timed {out['kernel']}")
    fits = {}
    if name == "j1713":
        f, fits["downhill"] = nanograv_downhill(
            f"{name} auto_fitter", lambda: auto_fitter(
                toas, ModelBuilder()(par), device=dev))
        fitters = {"downhill": f}
    else:
        fitters = {}
        for key, path, full, fused in (
                ("woodbury native", "mixed", False, "auto"),
                ("woodbury f64", "f64", False, False),
                ("dense native", "full_cov", True, "auto"),
                ("dense f64", "full_cov", True, False)):
            fitters[key], fits[key] = nanograv_fit(
                f"{name} {key}", path,
                lambda full=full, fused=fused: GLSFitter(
                    toas, ModelBuilder()(par), full_cov=full, fused=fused,
                    device=dev))
        check(fits["woodbury native"]["launches"]["fused_gram_joint wide"]
              == fits["woodbury native"]["launches"]["fused_gram_joint"] > 0,
              f"{name}: the Woodbury fit's joint Gram left the wide path")
        # the native (mixed) fit beside the f64 fit, in sigma: measured
        fn, ff = fitters["woodbury native"], fitters["woodbury f64"]
        names = list(ff.cm.free_names)
        gaps = value_gaps(fn.model, ff.model, names, [
            ff.model.params[n].internal_uncertainty() for n in names])
        worst = max(gaps, key=gaps.get)
        out["native_vs_f64_fit"] = dict(
            max_gap_sigma=gaps[worst], worst=worst,
            chi2_rel=abs(fn.chi2 / ff.chi2 - 1))
        log(f"{name}: native (mixed) Woodbury fit vs f64 Woodbury fit: "
            f"{out['native_vs_f64_fit']}")
    out["fits"] = fits
    small_par, small_sim = nanograv_inputs(name, **NANOGRAV_SMALL)
    if name == "b1855":
        out["card_vs_cpu"] = card_vs_cpu(
            f"{name} copy", small_par, 2048, small_sim, fourier=False)
    else:
        # DD's OM and T0 at e = 7.5e-5 make config 2's normal equations so
        # ill-conditioned that reordering the TOAs moves the CPU's own
        # f64 step by ~1e-2 sigma on the copy (PERF.md): no two
        # summation orders meet 1e-8 of the step, so the card is held to
        # the CPU's own ordering spread, in sigma (phase 6's R4 gates)
        out["card_vs_cpu"] = sigma_gap(f"{name} copy", small_par, 2048,
                                       small_sim, ordering_bound=True)
        check(out["card_vs_cpu"]["resid_diff_s"] <= 1e-11,
              f"{name} copy: card residuals differ from the CPU by "
              f"{out['card_vs_cpu']['resid_diff_s']} s")
    return out, fitters


def nanograv_phase(dev):
    """Phase 21: the reference's NANOGrav configurations (BASELINE.json
    configs 2 and 3) at their size on the card.  Config 2
    (``j1713_par``: DD binary, ECORR, red noise) at 10,000 TOAs in 125
    epochs of 80 through the default entry point (``auto_fitter``:
    downhill GLS, the joint Gram on the wide kernel at q = 430); config 3
    (``b1855_par``: the binary MSP with ECORR) at 8192 TOAs in 128 epochs
    of 64 by ``GLSFitter`` with the Woodbury step (the wide kernel at
    q = 434) and with the dense covariance, each on its native rung and
    on the f64 rung, the f64 Woodbury fit held to the f64 dense fit
    (values within 1e-6 of sigma, chi2 1e-8, uncertainties 1e-6).  Each
    configuration's wide kernel against its plain version on its own
    operands, its mixed step at the step gates, and its 2048-TOA copy
    card vs CPU.  -> what the kernels line reports."""
    t_phase = time.perf_counter()
    out = {}
    for name in NANOGRAV:
        out[name], fitters = nanograv_config(dev, name)
        if name == "b1855":
            fw, fd = fitters["woodbury f64"], fitters["dense f64"]
            names = list(fw.cm.free_names)
            sig = [fd.model.params[n].internal_uncertainty() for n in names]
            gaps = value_gaps(fw.model, fd.model, names, sig)
            unc = max(abs(fw.model.params[n].uncertainty
                          / fd.model.params[n].uncertainty - 1)
                      for n in names)
            chi2 = abs(fw.chi2 / fd.chi2 - 1)
            worst = max(gaps, key=gaps.get)
            out[name]["woodbury_vs_dense_f64"] = dict(
                max_gap_sigma=gaps[worst], worst=worst, unc_rel=unc,
                chi2_rel=chi2)
            log(f"{name}: f64 Woodbury fit vs f64 dense fit: "
                f"{out[name]['woodbury_vs_dense_f64']}")
            check(gaps[worst] <= 1e-6 and chi2 <= 1e-8 and unc <= 1e-6,
                  f"{name}: Woodbury vs dense fit outside the gates "
                  f"{out[name]['woodbury_vs_dense_f64']}")
        del fitters
        gc.collect()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"nanograv: phase 21 {out['phase_s']:.1f} s")
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the f32 Grams need full f32 products")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, torch {torch.__version__}, cuda {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    paths = build_libraries(LIBRARIES)
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if any(w in line for w in ("Function properties", "registers",
                                       "smem", "spill")):
                log(f"  {name}: {line.strip()}")

    # 2. the fit paths, counts zeroed just before each and read just after
    model, toas = make_test_pulsar(BENCH_PAR, ntoa=NTOA, device=dev, **SIM)
    mixed, mixed_launches = drive(
        "mixed", lambda: GLSFitter(toas, model, device=dev))
    four, four_launches = drive(
        "fourier",
        lambda: GLSFitter(toas, get_model(BENCH_PAR), device=dev, fused=True))
    launches = dict(fused_gram_joint=mixed_launches["fused_gram_joint"],
                    fourier_gram=four_launches["fourier_gram"],
                    fourier_apply=(mixed_launches["fourier_apply"]
                                   + four_launches["fourier_apply"]))

    phase_memory(2)

    # 3. correctness: each accelerated step vs the f64 step from the same x
    cm, x = mixed.cm, mixed.cm.x0()
    args = step_inputs(cm, x)
    step_gates("mixed", gls_step_woodbury_mixed(*args, normalized_cov=True),
               gls_step_woodbury(*args, normalized_cov=True))
    fcm, fx = four.cm, four.cm.x0()
    fourier_gates = step_gates(
        "fourier",
        gls_step_woodbury_fourier(*fourier_inputs(fcm, fx),
                                  normalized_cov=True),
        gls_step_woodbury(*step_inputs(fcm, fx), normalized_cov=True))

    # ... and on a small pulsar, the card against the port on the CPU
    card_vs_cpu("bench", BENCH_PAR, 2048, {})
    phase_memory(3)

    # 4. each kernel vs its plain version at the paths' shapes and odd ones
    rng = np.random.default_rng(1)

    def odd(*shape):
        return torch.as_tensor(rng.standard_normal(shape), device=dev)

    T, A, w = gram_inputs(cm, x)
    n, k = T.shape
    p1 = A.shape[1]
    errs = {"fused_gram_joint": kernel_vs_plain(
        "fused_gram_joint", fused_gram.fused_gram_joint_cuda,
        fused_gram.fused_gram_joint_plain, T, A, w)}
    errs["fused_gram_joint T f32"] = kernel_vs_plain(
        "fused_gram_joint", fused_gram.fused_gram_joint_cuda,
        fused_gram.fused_gram_joint_plain, T.float(), A, w)
    # the shapes the copy ring can get wrong: k = 1 (golden13's empty
    # basis), one chunk, the widest q = 80, and a ragged n whose last T, A
    # and w spans are not multiples of 16 bytes (T in f64 and in f32)
    for gn, gk, gp, t32 in ((1000, 1, 3, False), (92, 1, 9, False),
                            (n, 64, 16, False), (100_001, 61, 7, False),
                            (100_001, 61, 7, True)):
        gT = odd(gn, gk)
        errs[f"fused_gram_joint {gn}x({gk}+{gp}){' T f32' if t32 else ''}"] = (
            kernel_vs_plain(
                "fused_gram_joint", fused_gram.fused_gram_joint_cuda,
                fused_gram.fused_gram_joint_plain,
                gT.float() if t32 else gT, odd(gn, gp),
                torch.as_tensor(rng.uniform(0.0, 2.0, gn), device=dev)))
    ft, ff, fw, fX = fourier_gram_inputs(fcm, fx)
    nh, pf = ff.shape[0], fX.shape[1]
    errs["fourier_gram"] = kernel_vs_plain(
        "fourier_gram", fourier.fourier_gram_cuda, fourier.fourier_gram_plain,
        ft, ff, fw, fX)
    t_odd = torch.sort(torch.as_tensor(rng.uniform(0, 3.89e8, 1000),
                                       device=dev)).values
    f_odd = torch.arange(1, 6, dtype=torch.float64, device=dev) / 3.89e8
    kernel_vs_plain("fourier_gram", fourier.fourier_gram_cuda,
                    fourier.fourier_gram_plain, t_odd, f_odd,
                    torch.as_tensor(rng.uniform(0.0, 2.0, 1000), device=dev),
                    odd(1000, 3))
    z1, z8 = odd(2 * nh, 1), odd(2 * nh, 8)
    kernel_vs_plain("fourier_apply", fourier.fourier_apply_cuda,
                    fourier.fourier_apply_plain, ft, ff, z1)
    errs["fourier_apply"] = kernel_vs_plain(
        "fourier_apply", fourier.fourier_apply_cuda,
        fourier.fourier_apply_plain, ft, ff, z8)
    t_odd7 = t_odd[:999].contiguous()
    f_odd7 = torch.cat([f_odd, f_odd[:2] * 1.5])
    kernel_vs_plain("fourier_apply", fourier.fourier_apply_cuda,
                    fourier.fourier_apply_plain, t_odd7, f_odd7, odd(14, 3))
    # the widest shapes of the tables, at the bench's n and span
    f64h = torch.arange(1, 65, dtype=torch.float64, device=dev) / float(
        ft.max() - ft.min())
    wide = {"fourier_gram k=64 p=16": kernel_vs_plain(
        "fourier_gram", fourier.fourier_gram_cuda, fourier.fourier_gram_plain,
        ft, f64h, fw, odd(ft.shape[0], 16))}
    wide["fourier_apply k=64 m=16"] = kernel_vs_plain(
        "fourier_apply", fourier.fourier_apply_cuda,
        fourier.fourier_apply_plain, ft, f64h, odd(128, 16))
    basis_shapes = [basis_check(ft, ff), basis_check(t_odd, f_odd),
                    basis_check(t_odd7, f_odd7), basis_check(ft, f64h)]
    log(f"kernels vs plain (max abs, rel): {errs}; widest shapes: {wide}; "
        f"bench shapes: fused_gram_joint n={n} k={k} p1={p1}; fourier "
        f"n={ft.shape[0]} k={nh} p={pf}, apply m=8; basis bitwise equal to "
        f"basis32 at (n, k) = {basis_shapes}")

    phase_memory(4)

    # 5. timings and bounds
    times = {}
    Ys = (torch.cat([T.float(), A.float()], dim=1)
          * torch.sqrt(w).float()[:, None]).contiguous()
    Yd = Ys.double()
    times["fused_gram_joint"] = time_kernel(
        lambda: fused_gram.fused_gram_joint_cuda(T, A, w),
        lambda: fused_gram.fused_gram_joint_plain(T, A, w),
        lambda: torch.matmul(Yd.T, Yd))
    times["fused_gram_joint"]["library_f32_ms"] = cuda_ms(
        lambda: torch.matmul(Ys.T, Ys))
    bounds = {"fused_gram_joint": gram_bound(T, A, w)}

    # fourier_gram: its yardstick is one f64 GEMM of the materialized,
    # weighted f32 [T | X]; building T by torch.sin/cos is timed beside it
    basis_ms = cuda_ms(lambda: fourier.basis32(ft, ff))
    Tf = fourier.basis32(ft, ff)
    Yf = (torch.cat([Tf, fX.float()], dim=1)
          * torch.sqrt(fw).float()[:, None]).double().contiguous()
    times["fourier_gram"] = time_kernel(
        lambda: fourier.fourier_gram_cuda(ft, ff, fw, fX),
        lambda: fourier.fourier_gram_plain(ft, ff, fw, fX),
        lambda: torch.matmul(Yf.T, Yf))
    times["fourier_gram"]["basis_build_ms"] = basis_ms
    # each Gram kernel's passes' device time
    pass_times(times["fused_gram_joint"], "fused_gram_")
    pass_times(times["fourier_gram"], "gram_")
    nf = ft.shape[0]
    bounds["fourier_gram"], fg_fma = fourier_gram_bound(nf, nh, pf)

    # fourier_apply at m = 8: its yardstick is torch.matmul of the
    # materialized f32 T with z
    z8f = z8.float()
    times["fourier_apply"] = time_kernel(
        lambda: fourier.fourier_apply_cuda(ft, ff, z8),
        lambda: fourier.fourier_apply_plain(ft, ff, z8),
        lambda: torch.matmul(Tf, z8f))
    # both are short enough that a loop of calls waits on the host: the
    # same loops replayed from CUDA graphs show the device's side
    times["fourier_apply"]["graph_ms"] = graph_ms(
        lambda: fourier.fourier_apply_cuda(ft, ff, z8))
    times["fourier_apply"]["library_graph_ms"] = graph_ms(
        lambda: torch.matmul(Tf, z8f))
    bounds["fourier_apply"] = fourier_apply_bound(nf, nh, 8)

    for name in KERNELS:
        log(f"{name} (ms, median): {times[name]}, bound {bounds[name]}")
    log(f"fourier_gram work: {fg_fma} f64 FMA, {nf * nh} sincos")
    mixed_ms = host_ms(lambda: gauss_newton_step(cm, x, "mixed"), reps=10)
    f64_ms = host_ms(lambda: gauss_newton_step(cm, x, "f64"), reps=10)
    four_ms = host_ms(lambda: gauss_newton_step(fcm, fx, "fourier"), reps=10)
    log(f"step (ms, median, host clock to sync): mixed {mixed_ms!r}, "
        f"f64 {f64_ms!r}, fourier {four_ms!r}; TOAs/s mixed "
        f"{NTOA / (mixed_ms / 1e3)!r}, f64 {NTOA / (f64_ms / 1e3)!r}, "
        f"fourier {NTOA / (four_ms / 1e3)!r}")
    profile_step(cm, x, "mixed")
    profile_step(fcm, fx, "fourier")
    for c_, mode, ms in ((cm, "mixed", mixed_ms), (cm, "f64", f64_ms),
                         (fcm, "fourier", four_ms)):
        graph_check(f"bench {mode} step",
                    lambda x_, c=c_, m=mode: gauss_newton_step(c, x_, m),
                    (c_.x0(),), ms)
    phase_memory(5)

    # 6. the binary MSP at 1e5 TOAs: this slice's path and wide shapes
    msp = msp_phases(dev, rng)
    phase_memory(6)

    # 7. the default entry point: auto_fitter -> the downhill fitters
    entry = entry_point_phase(toas, msp)
    msp_toas = msp.pop("toas")
    del msp["gls"]
    phase_memory(7)

    # 8. the full-width pulsar (q = 350) and the remaining components
    full = full_width_phase(dev, rng)
    phase_memory(8)

    # 9. wideband: the stacked [TOA; DM] fits at 2e5 rows
    wideband = wideband_phase(dev)
    phase_memory(9)

    # 10. the PTA batch: 45 pulsars, one Gram launch a batched step
    pta = pta_phase(dev, rng)
    phase_memory(10)

    # 11. the dense-covariance step, fits and factorizations
    zero_counts()
    dense = dense_phase(dev)
    dense["launches"] = read_counts()
    check(not any(dense["launches"].values()),
          f"a kernel launched on the dense path: {dense['launches']}")
    phase_memory(11)

    # 12. the O(append) streaming solver
    zero_counts()
    stream = stream_phase(dev, toas, msp_toas)
    stream["launches"] = read_counts()
    check(not any(stream["launches"].values()),
          f"a kernel launched on the streaming path: {stream['launches']}")
    phase_memory(12)

    # 13. inference: the timing posterior, the chi2 grid, photon templates
    inference = inference_phase(dev, msp_toas)
    del msp_toas
    phase_memory(13)

    # 14. the port's own ingest: goldens, a 1e5-TOA topocentric tim file
    ingest = ingest_phase(dev)
    phase_memory(14)

    # 15. the command-line tools: zima and pintempo, photonphase, polycos,
    # event_optimize and the small tools
    tools = tools_phase(dev)
    phase_memory(15)

    # 16. the runtime and observability base: the traced, guarded fit and
    # its refit after commit, the fault ladder, checkpoints, the cost
    runtime = runtime_phase(dev, toas)
    phase_memory(16)

    # 17. the serving engine: batched residuals, fit and predict requests
    # through TimingEngine() on the card
    serve = serve_phase(dev)
    phase_memory(17)

    # 18. the one-card fleet: a stream's appends, the cross-key fuse,
    # preemptible jobs, and a kill and restart against a warm ledger
    fleet = fleet_phase(dev, eager={
        k: stream["bench"]["times"][k] for k in ("append", "solve")})
    phase_memory(18)

    # 19. the multi-GPU layer on one card: NCCL at world size 1 and two
    # gloo ranks sharing the card
    parallel = parallel_phase(dev)
    phase_memory(19)

    # 20. the fleet's multi-card half on one card: a gang of two gloo
    # ranks beside two singles, its health, a killed rank, reshapes, a
    # bounded chaos sweep and the operator tools
    gang = gang_phase(dev)
    phase_memory(20)

    # 21. the reference's NANOGrav configurations (BASELINE configs 2 and
    # 3): DD + ECORR through auto_fitter at 1e4 TOAs, and red noise +
    # ECORR by the Woodbury and the dense step at 8192 TOAs
    nanograv = nanograv_phase(dev)
    phase_memory(21)

    # the kernels line: each kernel at the binary MSP's shapes (launches
    # from its fits), and under "bench" the same numbers at bench.py's
    # pulsar (launches from its fits)
    rows = []
    bench = {"fused_gram_joint": dict(
                 shape=[n, k, p1], library_f32_ms=times[
                     "fused_gram_joint"]["library_f32_ms"],
                 mixed_step_ms=mixed_ms, f64_step_ms=f64_ms),
             "fourier_gram": dict(
                 shape=[ft.shape[0], nh, pf], basis_build_ms=times[
                     "fourier_gram"]["basis_build_ms"],
                 fourier_step_ms=four_ms, fourier_vs_f64=fourier_gates),
             "fourier_apply": dict(
                 shape=[ft.shape[0], nh, 8],
                 graph_ms=times["fourier_apply"]["graph_ms"],
                 library_graph_ms=times["fourier_apply"]["library_graph_ms"])}
    for name, (_, source, replaces, path) in KERNELS.items():
        tm, mt = times[name], msp["times"][name]
        keys = ("ms", "device_ms", "plain_ms", "plain_device_ms",
                "library_ms", "library_device_ms")
        worst = max([errs[name][0]] + [e[0] for e in msp["errs"][name]])
        worst_rel = max([errs[name][1]] + [e[1] for e in msp["errs"][name]])
        bench[name].update({key: tm[key] for key in keys})
        bench[name].update(launches=launches[name],
                           bound_ms=bounds[name][0],
                           bound_by=bounds[name][1])
        for key in ("pass1_device_ms", "pass2_device_ms"):
            if key in tm:
                bench[name][key] = tm[key]
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "path": path,
            "launches": msp["launches"][name], "max_abs_err": worst,
            "max_err_vs_plain": worst_rel,
            "shape": msp["shapes"][name],
            "bound_ms": msp["bounds"][name][0],
            "bound_by": msp["bounds"][name][1],
        }
        row.update({key: mt[key] for key in keys})
        row.update({key: v for key, v in mt.items()
                    if key not in keys and key != "device_parts"})
        row["bench"] = bench[name]
        rows.append(row)
    rows[0]["wide_source"] = "pint_tpu_torch/csrc/fused_gram_wide.cu"
    rows[0]["msp_step_ms"] = msp["steps"]
    rows[0]["msp_vs_f64"] = msp["gates"]
    rows[0]["msp_in_phase_card_vs_cpu"] = msp["r4"]
    # the downhill GLS fits of the default entry point, on both pulsars
    rows[0]["downhill_launches"] = {
        k: entry[k]["launches"]["fused_gram_joint"] for k in ("bench", "msp")}
    rows[0]["default_entry_point"] = entry
    rows[0]["full_width"] = full
    rows[0]["wideband"] = wideband
    rows[0]["pta"] = pta
    rows[0]["dense"] = dense
    rows[0]["stream"] = stream
    rows[0]["inference"] = inference
    rows[0]["ingest"] = ingest
    rows[0]["ingest_launches"] = ingest["fit"]["launches"]["fused_gram_joint"]
    rows[0]["tools"] = tools
    rows[0]["tools_launches"] = tools["pintempo"]["launches"][
        "fused_gram_joint"]
    rows[0]["runtime"] = runtime
    rows[0]["runtime_launches"] = {
        k: runtime["traced_fit"][k]["launches"]["fused_gram_joint"]
        for k in ("first", "refit")}
    rows[0]["serve"] = serve
    rows[0]["serve_launches"] = {
        "bench": serve["fit_launches"]["counts"]["fused_gram_joint"],
        "msp": serve["msp_launches"]["counts"]["fused_gram_joint"],
        "msp_wide": serve["msp_launches"]["counts"]["fused_gram_joint wide"]}
    rows[0]["fleet"] = fleet
    rows[0]["stream_launches"] = {
        "open": fleet["launches"]["stream_open"],
        "warm_refit": fleet["launches"]["warm_refit"]}
    rows[0]["fused_launches"] = fleet["launches"]["fused"]
    rows[0]["restart_launches"] = fleet["launches"]["restart_fit"]
    rows[0]["parallel"] = parallel
    rows[0]["parallel_launches"] = {
        "group_a": {k: v["launches"]["fused_gram_joint"]
                    for k, v in parallel["group_a"].items()},
        "group_b": {k: [x["launches"]["fused_gram_joint"] for x in v]
                    for k, v in parallel["group_b"].items()},
        "pta_batched": [x["fused_gram_joint batched"]
                        for x in parallel["pta"]["launches"]]}
    rows[0]["gang"] = gang
    rows[0]["gang_launches"] = {
        k: {"first": gang[k]["launches"]["ranks"],
            "steady": gang[k]["steady"]["rank_launches"]}
        for k in ("bench", "msp")}
    rows[0]["nanograv"] = nanograv
    rows[0]["nanograv_launches"] = {
        "j1713 downhill": nanograv["j1713"]["fits"]["downhill"]["launches"][
            "fused_gram_joint wide"],
        **{f"b1855 {k}": v["launches"]["fused_gram_joint wide"]
           for k, v in nanograv["b1855"]["fits"].items()}}
    rows[0]["graphs"] = GRAPHS
    rows[0]["memory_after_phase"] = MEMORY
    barred = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "pint_tpu"))
    check(not barred, f"modules of JAX or the JAX package imported: {barred}")
    print(json.dumps({"kernels": rows}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
