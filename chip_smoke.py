"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Drives the port's fit paths through the entry points a user calls
(``get_model``, ``make_test_pulsar``, ``GLSFitter.fit_toas``) on two
pulsars at 1e5 TOAs:

- bench.py's pulsar (spindown, equatorial astrometry, solar-system
  Shapiro, DM, EFAC/EQUAD, 30-harmonic power-law red noise; 6 design
  columns);
- the binary MSP of ``pint_tpu_torch.simulation.msp_par`` (ecliptic
  astrometry with PM and PX, F0/F1, 150 DMX ranges, FD1/FD2, a JUMP, an
  ELL1 orbit with Shapiro, EFAC/EQUAD on two receivers, 30-harmonic red
  noise; 168 design columns with the offset, so the joint Gram is
  q = 60 + 169 = 229 columns wide).

On each, the default fit (``fused='auto'``) takes the mixed step, whose
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
5. timings: CUDA events (median of 30 windows of 20 back-to-back calls,
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
   bench.py's pulsar is (1e-11 s, 1e-8); every kernel against its plain version at the wide shapes
   (``fused_gram_joint`` at q = 229 and 228 with T in f64 and f32, at
   the reference's widest k = 128 with p1 = 512, and at a ragged n with
   q = 231, T in f64 and f32; ``fourier_gram`` at k = 30 and 100 with
   p = 169, and each of three slices of 16 or 9 columns of X alone, bitwise
   equal to the same columns of the one launch;
   ``fourier_apply`` at k = 100 with m = 40 and the basis bit for bit at
   k = 100); the wide shapes timed as in 5; one mixed, f64 and fourier
   step on the host clock, and one mixed step under torch.profiler.

The last three lines are the kernels JSON (each kernel at the binary
MSP's shapes, with its launches in the MSP's fits, and under ``bench``
the same numbers at bench.py's pulsar), nvidia-smi's name and power
limit, and ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the package beside it, the script exits non-zero before printing
any result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pint_tpu_torch.fitting.base import design_with_offset  # noqa: E402
from pint_tpu_torch.fitting.gls import (  # noqa: E402
    GLSFitter,
    _column_norms,
    gauss_newton_step,
    gls_step_woodbury,
    gls_step_woodbury_fourier,
    gls_step_woodbury_mixed,
)
from pint_tpu_torch.models.builder import get_model  # noqa: E402
from pint_tpu_torch.ops import fourier, fused_gram  # noqa: E402
from pint_tpu_torch.ops._cuda_build import build_libraries  # noqa: E402
from pint_tpu_torch.simulation import (  # noqa: E402
    MSP_FREQS,
    make_test_pulsar,
    msp_par,
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


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def rel(a, b):
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


def cuda_ms(fn, reps=30, warm=3, batch=20):
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


def device_ms(fn, calls=20, tries=3):
    """Device time per call from torch.profiler: the summed durations of
    the kernels ``fn`` launches, without host gaps.  Also per kernel.  On
    the card the profiler drops one event of a window now and then (a
    count of 19 where 20 calls launched 20), so each kernel's time per
    call is its mean recorded duration times its launches per call, the
    nearest whole number of launches a call; a profile that recorded no
    kernel, or a count more than one event away from whole launches a
    call, is taken again, and after ``tries`` such profiles the time is
    None."""
    from torch.profiler import ProfilerActivity, profile

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
        each = {k: max(1, round(c / calls)) for k, c in count.items()}
        if total and all(abs(c - each[k] * calls) <= 1
                         for k, c in count.items()):
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


def step_inputs(cm, x):
    T, phi = cm.noise_basis_or_empty(x)
    return (cm.time_residuals(x, subtract_mean=False),
            design_with_offset(cm, x), torch.square(cm.scaled_sigma(x)),
            T, phi)


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


def drive(path, make_fitter, label="bench"):
    """Drive one fit path with every launch count at 0 just before it and
    read just after; check the fit and its launches.  Also prints the
    fit's peak of allocated device memory."""
    for wrapper, _, _, _ in KERNELS.values():
        wrapper.launches = 0
    fused_gram.fused_gram_joint_cuda.wide_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fitter = make_fitter()
    chi2 = fitter.fit_toas(maxiter=4)
    torch.cuda.synchronize()
    launches = {n: k[0].launches for n, k in KERNELS.items()}
    launches["fused_gram_joint wide"] = (
        fused_gram.fused_gram_joint_cuda.wide_launches)
    rep = fitter.guard_report
    log(f"{label} {path} fit: mode={fitter.mode} rung={rep.rung} "
        f"fell_back={rep.fell_back} steps={fitter.steps_taken} "
        f"chi2={chi2!r} converged={fitter.converged} launches={launches} "
        f"wall={time.perf_counter() - t0:.2f} s "
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
            check(launches[n] >= fitter.steps_taken > 0,
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
    three Grams written once; n q (q + 1) f64 flop of the upper
    triangle at the f64 tensor-core peak."""
    n, k = T.shape
    p1 = A.shape[1]
    q = k + p1
    nbytes = (T.numel() * T.element_size() + A.numel() * A.element_size()
              + w.numel() * w.element_size() + 8 * (k * k + k * p1 + p1 * p1))
    return bound(nbytes, n * q * (q + 1), F64_TC_FLOPS)


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
                           reps=10)
             for mode in ("mixed", "f64", "fourier")}
    log(f"msp step (ms, median, host clock to sync): {steps}; TOAs/s "
        f"{ {m: NTOA / (v / 1e3) for m, v in steps.items()} }")
    profile_step(cm, x, "mixed")
    return dict(launches=launches, errs=errs, times=times, bounds=bounds,
                shapes=shapes, gates=gates, steps=steps)


def card_vs_cpu(label, par, ntoa, sim):
    """The card against the port on the CPU on a small copy of a pulsar,
    the CPU under the card's solve policy so both run the same
    algorithms: residuals within 1e-11 s, the f64 step and the fourier
    step within 1e-8 (the same f32 basis values on both, correctly
    rounded sin/cos, and f64 sums on both: only the summation order
    differs)."""
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
                        gls_step_woodbury_fourier(*fourier_inputs(c, xs)))
    finally:
        del os.environ["PINT_TPU_TORCH_SOLVE_IR"]
    dres = float(torch.max(torch.abs(small["cuda"][0].cpu() - small["cpu"][0])))
    dstep = rel(small["cuda"][1], small["cpu"][1])
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
    mixed_ms = host_ms(lambda: gauss_newton_step(cm, x, "mixed"), reps=20)
    f64_ms = host_ms(lambda: gauss_newton_step(cm, x, "f64"), reps=20)
    four_ms = host_ms(lambda: gauss_newton_step(fcm, fx, "fourier"), reps=20)
    log(f"step (ms, median, host clock to sync): mixed {mixed_ms!r}, "
        f"f64 {f64_ms!r}, fourier {four_ms!r}; TOAs/s mixed "
        f"{NTOA / (mixed_ms / 1e3)!r}, f64 {NTOA / (f64_ms / 1e3)!r}, "
        f"fourier {NTOA / (four_ms / 1e3)!r}")
    profile_step(cm, x, "mixed")
    profile_step(fcm, fx, "fourier")

    # 6. the binary MSP at 1e5 TOAs: this slice's path and wide shapes
    msp = msp_phases(dev, rng)

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
