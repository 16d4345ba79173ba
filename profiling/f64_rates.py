"""f64 rates of the card behind the Fourier kernels: each f64
tensor-core MMA shape of sm_90 (fragment layout checked on small-integer
operands, exactly; throughput in TFLOP/s; the latency of one dependent
MMA), libdevice's f64 sincos of an
f32 argument and the port's ``fourier_pair`` (pairs per second), and
f32 <-> f64 conversions (per second).

    python3 profiling/f64_rates.py

Builds ``profiling/f64_rates.cu`` with nvcc (the port's flags) into
``pint_tpu_torch/_build/`` and prints one line per rate and one JSON
line.  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from pint_tpu_torch.ops._cuda_build import BUILD, NVCC_FLAGS, _nvcc  # noqa: E402

#: shape code -> (name, M, K); every shape has N = 8
SHAPES = {0: ("m8n8k4", 8, 4), 1: ("m16n8k4", 16, 4), 2: ("m16n8k8", 16, 8),
          3: ("m16n8k16", 16, 16)}
ACC = 4  # accumulators per warp in the rate kernel


def build():
    BUILD.mkdir(parents=True, exist_ok=True)
    lib = BUILD / "libf64_rates.so"
    src = ROOT / "profiling" / "f64_rates.cu"
    out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(out.stdout + out.stderr)
    fn = ctypes.CDLL(str(lib)).f64_rates_run
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i, vp, vp, vp, i, i, i]
    fn.restype = ctypes.c_int
    return fn


def main():
    if not torch.cuda.is_available():
        print("f64_rates: no CUDA device", file=sys.stderr)
        return 2
    run = build()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    blocks, threads, iters = 132 * 8, 256, 2048
    result = {"device": torch.cuda.get_device_name(0)}
    for code, (name, m, k) in SHAPES.items():
        A = torch.randint(-8, 8, (m, k), generator=gen).double().to(dev)
        B = torch.randint(-8, 8, (k, 8), generator=gen).double().to(dev)
        D = torch.zeros((m, 8), dtype=torch.float64, device=dev)
        err = run(code, 0, A.data_ptr(), B.data_ptr(), D.data_ptr(), 1, 32, 0)
        torch.cuda.synchronize()
        layout_ok = err == 0 and torch.equal(D, A @ B)
        out = torch.empty(blocks * threads, dtype=torch.float64, device=dev)
        for _ in range(2):  # warm-up, then the timed call
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            err = run(code, 1, 0, 0, out.data_ptr(), blocks, threads, iters)
            e.record()
            e.synchronize()
        if err:
            raise RuntimeError(f"{name}: cudaError {err}")
        ms = s.elapsed_time(e)
        flop = 2.0 * m * 8 * k * ACC * iters * blocks * threads / 32
        tflops = flop / (ms * 1e-3) / 1e12
        # one warp per scheduler, one accumulator: the MMA's latency
        lat_iters = 4096
        for _ in range(2):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            err = run(code, 4, 0, 0, out.data_ptr(), 132, 128, lat_iters)
            e.record()
            e.synchronize()
        latency_ns = s.elapsed_time(e) * 1e6 / lat_iters
        result[name] = {"layout_ok": layout_ok, "ms": ms, "tflops": tflops,
                        "latency_ns": latency_ns}
        print(f"{name}: layout {'ok' if layout_ok else 'WRONG'}, "
              f"{tflops:.2f} TFLOP/s ({ms:.3f} ms), one dependent MMA "
              f"{latency_ns:.2f} ns", flush=True)
    # sincos: 4 chains x iters per thread; conversions: 2 per step, 8 chains
    for mode, key, per_thread in ((2, "sincos_per_s", 4),
                                  (5, "fourier_pair_per_s", 4),
                                  (3, "cvt_per_s", 16)):
        out = torch.empty(blocks * threads, dtype=torch.float64, device=dev)
        for _ in range(2):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            err = run(0, mode, 0, 0, out.data_ptr(), blocks, threads, 256)
            e.record()
            e.synchronize()
        if err:
            raise RuntimeError(f"{key}: cudaError {err}")
        ms = s.elapsed_time(e)
        rate = per_thread * 256 * blocks * threads / (ms * 1e-3)
        result[key] = rate
        print(f"{key}: {rate:.4g} ({ms:.3f} ms)", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
