"""Where ``fused_gram_joint``'s device time goes on the card: its two
passes, and its pass 1 in parts: only the bulk copies, only the
conversion and MMA, only the converter warps, only the MMA warps.

    python3 profiling/torch_fused_gram_split.py [n] [k] [p1] [--f32]

Builds ``profiling/fused_gram_split.cu`` (q = k + p1 <= 80) or
``profiling/fused_gram_wide_split.cu`` (wider: the wide kernel's pass-1
block run in parts) with the port's nvcc flags into
``pint_tpu_torch/_build/``, then times on the same inputs (default
n = 1e5, k = 60, p1 = 7, the bench shape; the binary MSP's is 1e5 60 169;
T in f64, or f32 with ``--f32``) by torch.profiler's device time
per call (20 calls): ``fused_gram_joint`` (checked against its plain
version at 3e-6 of scale) with each pass, and by CUDA events each part of
pass 1 alone.
The copies' and the conversion-and-MMA half's sum less pass 1 is what
the ring overlaps; the two roles alone say which holds the second half.  Prints one
JSON line, then the card's name and power limit.  Needs a CUDA card.
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

from pint_tpu_torch.ops import fused_gram  # noqa: E402
from pint_tpu_torch.ops._cuda_build import BUILD, NVCC_FLAGS, _nvcc  # noqa: E402

sys.path.insert(0, str(ROOT / "profiling"))
from torch_fourier_split import device_ms  # noqa: E402

#: H100 SXM HBM bandwidth (NVIDIA data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12


def event_ms(fn, calls=20, reps=5):
    """Median over ``reps`` of CUDA-event time per call of ``calls``
    back-to-back calls."""
    fn()
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / calls)
    return sorted(ts)[reps // 2]


def build(wide):
    """The split library's entry (fused_gram_part, or fused_gram_wide_part
    for the wide kernel), and the ptxas lines of its build."""
    BUILD.mkdir(parents=True, exist_ok=True)
    name = "fused_gram_wide_split" if wide else "fused_gram_split"
    lib = BUILD / f"lib{name}.so"
    out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib),
                          str(ROOT / "profiling" / f"{name}.cu")],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(out.stdout + out.stderr)
    vp, i = ctypes.c_void_p, ctypes.c_int
    if wide:
        fn = ctypes.CDLL(str(lib)).fused_gram_wide_part
        fn.argtypes = [vp, i, vp, vp] + [i] * 8 + [vp, vp, i, vp]
    else:
        fn = ctypes.CDLL(str(lib)).fused_gram_part
        fn.argtypes = [vp, i, vp, vp] + [i] * 6 + [vp, i, vp]
    fn.restype = ctypes.c_int
    ptxas = [ln.strip() for ln in (out.stdout + out.stderr).splitlines()
             if "registers" in ln or "spill stores" in ln]
    return fn, ptxas


def main(argv):
    if not torch.cuda.is_available():
        print("torch_fused_gram_split: no CUDA device", file=sys.stderr)
        return 2
    f32 = "--f32" in argv
    argv = [a for a in argv if a != "--f32"]
    n, k, p1 = (int(a) for a in (argv + ["100000", "60", "7"][len(argv):]))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    T = torch.as_tensor(rng.standard_normal((n, k)), device=dev)
    if f32:
        T = T.float()
    A = torch.as_tensor(rng.standard_normal((n, p1)), device=dev)
    w = torch.as_tensor(rng.uniform(0.5, 2.0, n), device=dev)

    got = fused_gram.fused_gram_joint_cuda(T, A, w)
    want = fused_gram.fused_gram_joint_plain(T, A, w)
    err = max(float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))
              for a, b in zip(got, want))
    if not err <= 3e-6:
        raise AssertionError(f"fused_gram_joint off its plain version: {err}")
    total, parts = device_ms(lambda: fused_gram.fused_gram_joint_cuda(T, A, w))

    q = k + p1
    wide = q > fused_gram.Q_MAX
    part_fn, ptxas = build(wide)
    nb, q_pad, threads = fused_gram.fused_block_table(n, k, p1)
    partial = torch.empty(nb * fused_gram.fused_tile_count(q) * 128,
                          dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    if wide:
        geo = fused_gram.wide_geometry(q)
        table = torch.tensor(geo["table"].tolist(), dtype=torch.int32,
                             device=dev)
        head = (geo["rows"], geo["ytiles"], geo["ngroups"], geo["nbg"], nb,
                table.data_ptr())
    else:
        head = (q_pad, nb, threads)

    def run(mode):
        if part_fn(T.data_ptr(), int(not f32), A.data_ptr(), w.data_ptr(), n,
                   k, p1, *head, partial.data_ptr(), mode, stream):
            raise RuntimeError("fused_gram split: launch failed")

    # each part is one launch: CUDA events over back-to-back launches (the
    # profiler loses events of long launches)
    copies, compute, converters, mma = (
        event_ms(lambda: run(mode)) for mode in range(4))

    def part(name):  # pass 1 is a template: "void fused_gram_pass1<double>"
        got = [v for nm, v in parts.items() if name in nm]
        return sum(got) if got else None

    prefix = "wide_" if wide else "fused_gram_"
    pass1 = part(prefix + "pass1")
    nbytes = T.numel() * T.element_size() + 8 * (A.numel() + n)
    result = {
        "device": torch.cuda.get_device_name(0), "n": n, "k": k, "p1": p1,
        "T": str(T.dtype), "err_vs_plain": err, "device_ms": total,
        "pass1_ms": pass1, "pass2_ms": part(prefix + "pass2"),
        "pass1_copies_only_ms": copies,
        "pass1_convert_mma_only_ms": compute,
        "pass1_converters_only_ms": converters,
        "pass1_mma_warps_only_ms": mma,
        "overlap_ms": (None if None in (pass1, copies, compute)
                       else copies + compute - pass1),
        "input_bytes": nbytes,
        "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
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
