"""Where ``fourier_gram``'s device time goes on the card: its two passes,
and its pass 1 with only the basis staging (the sincos) or only the MMA.

    python3 profiling/torch_fourier_split.py [n] [k] [p]

Builds ``profiling/fourier_gram_split.cu`` (the kernel's own pass-1 block
run in halves) with the port's nvcc flags into ``pint_tpu_torch/_build/``,
then times on the same inputs (default n = 1e5, k = 30, p = 7 over
bench.py's span) by torch.profiler's device time per call (20 calls):
``fourier_gram`` (checked against its plain version at 3e-6 of scale)
with each pass, and each half of pass 1 alone.  The sum of the halves
less pass 1 is what the ring overlaps.  Prints one JSON line, then the
card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pint_tpu_torch.ops import fourier  # noqa: E402
from pint_tpu_torch.ops._cuda_build import BUILD, NVCC_FLAGS, _nvcc  # noqa: E402

#: bench.py's MJD 53000-57500 span, seconds
TSPAN = 1.4256e8


def build():
    """fourier_gram_half of profiling/fourier_gram_split.cu, and the
    ptxas lines of its build."""
    BUILD.mkdir(parents=True, exist_ok=True)
    lib = BUILD / "libfourier_gram_split.so"
    out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib),
                          str(ROOT / "profiling" / "fourier_gram_split.cu")],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(out.stdout + out.stderr)
    fn = ctypes.CDLL(str(lib)).fourier_gram_half
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 4 + [i] * 8 + [vp, i, vp]
    fn.restype = ctypes.c_int
    ptxas = [ln.strip() for ln in (out.stdout + out.stderr).splitlines()
             if "registers" in ln or "spill stores" in ln]
    return fn, ptxas


def device_ms(fn, calls=20, tries=3):
    """Device time per call (torch.profiler), and per kernel name; a
    profile that recorded no kernel, or a count of some kernel that is
    not a multiple of ``calls`` (lost events), is taken again (None
    after ``tries``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        per, count = {}, {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                name = ev.name.split("(")[0]
                per[name] = per.get(name, 0.0) + ev.device_time / 1e3 / calls
                count[name] = count.get(name, 0) + 1
        if per and all(c % calls == 0 for c in count.values()):
            return sum(per.values()), per
    return None, {}


def main(argv):
    if not torch.cuda.is_available():
        print("torch_fourier_split: no CUDA device", file=sys.stderr)
        return 2
    n, k, p = (int(a) for a in (argv + ["100000", "30", "7"][len(argv):]))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    t = torch.as_tensor(np.sort(rng.uniform(0, TSPAN, n)), device=dev)
    f = torch.as_tensor(np.arange(1, k + 1) / TSPAN, device=dev)
    w = torch.as_tensor(rng.uniform(0.5, 2.0, n), device=dev)
    X = torch.as_tensor(rng.standard_normal((n, p)), device=dev)

    got = fourier.fourier_gram_cuda(t, f, w, X)
    want = fourier.fourier_gram_plain(t, f, w, X)
    err = max(float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))
              for a, b in zip(got, want))
    if not err <= 3e-6:
        raise AssertionError(f"fourier_gram off its plain version: {err}")
    total, parts = device_ms(lambda: fourier.fourier_gram_cuda(t, f, w, X))

    half, ptxas = build()
    nb, ny, kb, q_pad, ntiles, threads = fourier.fourier_gram_table(n, k, p)
    partial = torch.empty(nb * ntiles * fourier.TILE_ROWS * fourier.TILE,
                          dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run(stage_only):
        if half(t.data_ptr(), f.data_ptr(), w.data_ptr(), X.data_ptr(), n,
                k, p, kb, q_pad, nb, ny, threads, partial.data_ptr(),
                stage_only, stream):
            raise RuntimeError("fourier_gram_half: launch failed")

    staging = device_ms(lambda: run(1))[0]
    mma = device_ms(lambda: run(0))[0]
    pass1 = parts.get("gram_pass1")
    result = {
        "device": torch.cuda.get_device_name(0), "n": n, "k": k, "p": p,
        "err_vs_plain": err, "device_ms": total,
        "pass1_ms": pass1, "pass2_ms": parts.get("gram_pass2"),
        "pass1_staging_only_ms": staging, "pass1_mma_only_ms": mma,
        "overlap_ms": (None if None in (pass1, staging, mma)
                       else staging + mma - pass1),
        "split_ptxas": ptxas,
    }
    print(json.dumps(result), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
