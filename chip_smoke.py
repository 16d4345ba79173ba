"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Drives the port's main path — the north-star GLS fit of bench.py's pulsar
(1e5 TOAs; spindown, equatorial astrometry, solar-system Shapiro, DM,
EFAC/EQUAD, 30-harmonic power-law red noise) — through the entry points a
user calls: ``get_model``, ``make_test_pulsar``, ``GLSFitter.fit_toas``.
On the card the fitter takes the mixed step, whose joint Gram is the
hand-written CUDA kernel ``pint_tpu_torch/csrc/fused_gram_joint.cu``.

Phases, each of which raises on failure (exit code != 0):

1. build every CUDA kernel of the path from the sources (one nvcc each,
   started together) and print the ptxas report;
2. the main path with every launch count at 0 before and read after: a
   4-iteration fit must be finite and launch the kernel once per step;
3. correctness: one mixed step against the f64 step from the same x at
   bench.py's fused_interior gates; on a small pulsar the card's f64
   residuals and step against the port on the CPU;
4. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and at an odd shape: 3e-6 of scale, bitwise on rerun;
5. CUDA-event timings (median of 30 windows of 20 back-to-back calls,
   after warm-up) of the kernel, its plain version and the one-call
   library yardstick (an f64 GEMM of the
   same f32 values; the f32 GEMM is printed beside it), host-clock
   timings of one mixed and one f64 step, and the kernel's roofline
   bound from this run's inputs; the kernel's and the plain version's
   device time per call from torch.profiler (kernel durations without
   the host's launch gaps).

One mixed and one f64 step also run under ``torch.profiler``: the
kernel count, the summed device time against the step's wall time (the
device's busy share), and the top operators.

The last three lines are the kernels JSON, nvidia-smi's name and power
limit, and ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the package beside it, the script exits non-zero before printing
any result.
"""

from __future__ import annotations

import json
import math
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
    gauss_newton_step,
    gls_step_woodbury,
    gls_step_woodbury_mixed,
    _column_norms,
)
from pint_tpu_torch.ops import fused_gram  # noqa: E402
from pint_tpu_torch.ops._cuda_build import build_libraries  # noqa: E402
from pint_tpu_torch.simulation import make_test_pulsar  # noqa: E402

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

#: H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bandwidth,
#: and f64 FMA outside the tensor cores (the kernel's f64 sums)
HBM_BYTES_PER_S = 3.35e12
F64_FLOPS = 34e12

#: every kernel of the main path: name -> (wrapper, source, TPU kernel)
KERNELS = {
    "fused_gram_joint": (
        fused_gram.fused_gram_joint_cuda,
        "pint_tpu_torch/csrc/fused_gram_joint.cu",
        "pint_tpu/ops/pallas_fit.py:159",
    ),
}


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


def device_ms(fn, calls=20):
    """Device time per call from torch.profiler: the summed durations of
    the kernels ``fn`` launches, without host gaps.  Also per kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per[ev.name] = per.get(ev.name, 0.0) + ev.device_time / 1e3 / calls
    return sum(per.values()), per


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


def gram_inputs(cm, x):
    """The fused Gram's operands exactly as the mixed step forms them."""
    r, M, Ndiag, T, _ = step_inputs(cm, x)
    X = torch.cat([M / _column_norms(M)[None, :], r[:, None]], dim=1)
    return T.contiguous(), X.contiguous(), (1.0 / Ndiag).contiguous()


def kernel_vs_plain(T, A, w):
    got = fused_gram.fused_gram_joint_cuda(T, A, w)
    again = fused_gram.fused_gram_joint_cuda(T, A, w)
    want = fused_gram.fused_gram_joint_plain(T, A, w)
    torch.cuda.synchronize()
    worst_abs, worst_rel = 0.0, 0.0
    for g, g2, ww in zip(got, again, want):
        check(torch.equal(g, g2), "fused_gram_joint is not bitwise "
              "reproducible")
        err = float(torch.max(torch.abs(g - ww)))
        scale = float(torch.max(torch.abs(ww)))
        check(err <= 3e-6 * scale, f"fused_gram_joint vs plain: {err} > "
              f"3e-6 * {scale}")
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / scale)
    return worst_abs, worst_rel


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
    paths = build_libraries(list(KERNELS))
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 2. the main path, counts zeroed just before and read just after
    t0 = time.perf_counter()
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0
    model, toas = make_test_pulsar(BENCH_PAR, ntoa=NTOA, device=dev, **SIM)
    fitter = GLSFitter(model, toas, device=dev)
    chi2 = fitter.fit_toas(maxiter=4)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, (w, _, _) in KERNELS.items()}
    fit_s = time.perf_counter() - t0
    log(f"fit: mode={fitter.mode} steps={fitter.steps_taken} chi2={chi2!r} "
        f"converged={fitter.converged} launches={launches} "
        f"wall={fit_s:.2f} s")
    check(fitter.mode == "mixed", "auto mode on the card must be mixed")
    check(math.isfinite(chi2), "non-finite chi2")
    for n in fitter.cm.free_names:
        p = model.params[n]
        v = float(p.value)
        log(f"  {n:6s} {v!r:>26} +- {p.uncertainty!r}")
        check(math.isfinite(v) and math.isfinite(p.uncertainty)
              and p.uncertainty > 0, f"{n}: non-finite value/uncertainty")
    for n, count in launches.items():
        check(count >= fitter.steps_taken > 0,
              f"{n} launched {count} times in {fitter.steps_taken} steps")

    # 3. correctness: mixed vs f64 step from the same x at 1e5 TOAs
    cm = fitter.cm
    x = cm.x0()
    args = step_inputs(cm, x)
    dx_m, (cov_m, _), chi_m, _ = gls_step_woodbury_mixed(
        *args, normalized_cov=True)
    dx_f, (cov_f, _), chi_f, _ = gls_step_woodbury(*args, normalized_cov=True)
    sig_m = torch.sqrt(torch.diagonal(cov_m))
    sig_f = torch.sqrt(torch.diagonal(cov_f))
    gates = dict(dx_rel=rel(dx_m, dx_f),
                 chi2_rel=abs(float(chi_m) - float(chi_f)) / abs(float(chi_f)),
                 cov_rel=rel(cov_m, cov_f),
                 unc_rel=float(torch.max(torch.abs(sig_m - sig_f) / sig_f)))
    log(f"mixed vs f64 step at {NTOA} TOAs: {gates}")
    check(gates["dx_rel"] <= 2e-3 and gates["chi2_rel"] <= 1e-3
          and gates["cov_rel"] <= 5e-3, f"mixed step outside gates {gates}")

    # ... and on a small pulsar, the card against the port on the CPU
    small = {}
    for d in ("cpu", "cuda"):
        m, t = make_test_pulsar(BENCH_PAR, ntoa=2048, device="cpu", **SIM)
        c = m.compile(t, device=d)
        xs = c.x0()
        small[d] = (c.time_residuals(xs),
                    gls_step_woodbury(*step_inputs(c, xs))[0])
    dres = float(torch.max(torch.abs(small["cuda"][0].cpu() - small["cpu"][0])))
    dstep = rel(small["cuda"][1], small["cpu"][1])
    log(f"card vs cpu at 2048 TOAs: residuals {dres!r} s, f64 step {dstep!r}")
    check(dres <= 1e-11, f"card residuals differ from the CPU by {dres} s")
    check(dstep <= 1e-8, f"card f64 step differs from the CPU by {dstep}")

    # 4. kernel vs plain at the main path's shapes and an odd shape
    T, A, w = gram_inputs(cm, x)
    n, k = T.shape
    p1 = A.shape[1]
    err_abs, err_rel = kernel_vs_plain(T, A, w)
    rng = np.random.default_rng(1)
    odd = [torch.as_tensor(v, device=dev) for v in (
        rng.standard_normal((1000, 1)), rng.standard_normal((1000, 3)),
        rng.uniform(0.0, 2.0, 1000))]
    odd_abs, odd_rel = kernel_vs_plain(*odd)
    log(f"kernel vs plain: bench shape n={n} k={k} p1={p1} max_abs "
        f"{err_abs!r} (rel {err_rel!r}); odd shape max_abs {odd_abs!r} "
        f"(rel {odd_rel!r})")

    # 5. timings
    kernel_ms = cuda_ms(lambda: fused_gram.fused_gram_joint_cuda(T, A, w))
    plain_ms = cuda_ms(lambda: fused_gram.fused_gram_joint_plain(T, A, w))
    kernel_dev_ms, kernel_parts = device_ms(
        lambda: fused_gram.fused_gram_joint_cuda(T, A, w))
    plain_dev_ms, _ = device_ms(
        lambda: fused_gram.fused_gram_joint_plain(T, A, w))
    # the same function as one library call: an f64 GEMM of the f32 values
    Ys = (torch.cat([T.float(), A.float()], dim=1)
          * torch.sqrt(w).float()[:, None]).contiguous()
    Yd = Ys.double()
    library_ms = cuda_ms(lambda: torch.matmul(Yd.T, Yd))
    library_f32_ms = cuda_ms(lambda: torch.matmul(Ys.T, Ys))
    mixed_ms = host_ms(lambda: gauss_newton_step(cm, x, "mixed"), reps=20)
    f64_ms = host_ms(lambda: gauss_newton_step(cm, x, "f64"), reps=20)
    q = k + p1
    nbytes = (T.numel() * T.element_size() + A.numel() * A.element_size()
              + w.numel() * w.element_size() + 8 * (k * k + k * p1 + p1 * p1))
    flops = n * q * (q + 1)  # upper triangle, one FMA = 2 flops
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F64_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"device time per call (ms, profiler): kernel {kernel_dev_ms!r} "
        f"{ {k[:40]: v for k, v in kernel_parts.items()} }, plain "
        f"{plain_dev_ms!r}")
    log(f"timings (ms, median): kernel {kernel_ms!r}, plain {plain_ms!r}, "
        f"library f64 GEMM {library_ms!r} (f32 GEMM {library_f32_ms!r}), "
        f"bound {bound_ms!r} "
        f"({nbytes} B, {flops} flop)")
    log(f"step (ms, median, host clock to sync): mixed {mixed_ms!r}, "
        f"f64 {f64_ms!r}; mixed step {NTOA / (mixed_ms / 1e3)!r} TOAs/s, "
        f"f64 step {NTOA / (f64_ms / 1e3)!r} TOAs/s")

    profile_step(cm, x, "mixed")
    profile_step(cm, x, "f64")

    name = "fused_gram_joint"
    _, source, replaces = KERNELS[name]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": err_abs, "max_err_vs_plain": err_rel,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "device_ms": kernel_dev_ms, "plain_device_ms": plain_dev_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "library_f32_ms": library_f32_ms,
        "mixed_step_ms": mixed_ms, "f64_step_ms": f64_ms,
    }]}), flush=True)
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
