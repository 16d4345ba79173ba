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

Every fit above runs its steps as replays of step programs
(``runtime/graphs.py``: CUDA graphs captured once, after one eager
warm-up call), and each check says so: a GLSFitter, WLSFitter or
WidebandTOAFitter fit replayed its step program once a step, a fused
downhill fit its iteration program once an iteration and its proposal
program once, the PTA fit its batched step ``maxiter + 1`` times, each
program captured once, nothing left cached after the fit, and each
kernel launched once a replay plus once in each capture's warm-up.  The
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
its fit),
nvidia-smi's
name and power limit, and ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the package beside it, the script exits non-zero
before printing any result.
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
from pint_tpu_torch.simulation import (  # noqa: E402
    MSP_FREQS,
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
        worst_rel = max(worst_rel, err / scale)
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
    must not pile up), and the script's seconds so far."""
    gc.collect()
    torch.cuda.empty_cache()
    MEMORY[phase] = dict(reserved=torch.cuda.memory_reserved(),
                         allocated=torch.cuda.memory_allocated(),
                         elapsed_s=time.perf_counter() - T_START)
    log(f"memory after phase {phase}: {MEMORY[phase]}")


def programs_ran(label, cache, replays, captures):
    """A fit's step programs: ``replays`` replays, ``captures`` captures,
    nothing left cached."""
    got = dict(replays=cache.replays, captures=cache.captures,
               cached=len(cache), capture_s=cache.capture_s)
    check(got["replays"] == replays and got["captures"] == captures
          and got["cached"] == 0,
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


def step_gates(name, got, want, ntoa=NTOA):
    """A step against the f64 step from the same x, at the reference's
    step gates; uncertainties and the worst dx gap in sigma printed."""
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
    check(gates["dx_rel"] <= 2e-3 and gates["chi2_rel"] <= 1e-3
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


def sigma_gap(label, par, ntoa, sim):
    """The card's f64 step against the CPU's on a small copy of a pulsar,
    in units of each parameter's sigma (the CPU step's), printed for every
    parameter, with the CPU's yardsticks from the same run
    (``fitting/spread.py``): the largest gaps under eight permutations of
    the TOAs (summation order) and under three one-ulp shifts of every
    residual (rounding of the delays).  Gated (ROADMAP C R4): the card's
    step from the CPU's residuals within 10 times the largest ordering
    gap — past the residuals, the card differs by summation order only —
    and the card's whole step within the smallest rounding gap.  -> the
    largest gap, its parameter, the gap relative to the step's largest
    component, the residuals' largest difference and the yardsticks."""
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
    check(out["max_gap_sigma"] <= min(rounding),
          f"{label}: the card's step is {out['max_gap_sigma']} sigma off the "
          f"CPU's, over the one-ulp rounding gap {min(rounding)}")
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
