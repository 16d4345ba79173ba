"""The mixed GLS step's fused joint Gram: a hand-written CUDA kernel.

Counterpart of ``pint_tpu/ops/pallas_fit.py``.  ``fused_gram_joint(T, A,
w)`` returns (G_TT (k, k), G_TA (k, p1), G_AA (p1, p1)) in f64 for
G = Y^T Y, Y = [f32(T) | f32(A)] * f32(sqrt(w)): T the noise basis, A the
column-normalized design matrix with the residual as last column, w the
inverse white variances.  Y holds the reference's f32 values (its
``'highest'`` rung: exact products of f32 operands); their products are
summed in f64, where the TPU kernel summed 128-row sub-chunks in f32.  The
f32 sums put the mixed step's covariance 1.4e-2 off the f64 step at 1e5
TOAs on an H100, past the 5e-3 gate, and the card's native f64 makes the
f64 sums free at this kernel's bytes bound (PERF.md).

- :func:`fused_gram_joint_plain` is the same function in plain torch
  (pad to 128-row chunks, f64 ``bmm`` of the f32 values, f64 sum over
  chunks).
- :func:`fused_gram_joint_cuda` launches ``csrc/fused_gram_joint.cu``
  (bulk copies into a ring of shared stages, f64 MMA, two passes,
  fixed-order f64 reduction, bitwise reproducible) for q = k + p1 <= 80,
  and ``csrc/fused_gram_wide.cu`` (128-column panel pairs, plain loads,
  the same contract) for wider Y; it counts its launches in
  ``fused_gram_joint_cuda.launches``, those of the wide path also in
  ``fused_gram_joint_cuda.wide_launches``.
- :func:`fused_gram_joint` dispatches on where the tensors lie: the
  plain version for CPU tensors, the kernel for CUDA tensors, and no
  fallback between them.
- :func:`fused_block_table` says, from the shapes alone, which path
  takes them: it admits exactly the shapes the reference's table admits
  (pad128(k) + pad128(p1) <= 640), and ``fitting/gls.py::_joint_gram``
  routes only the others to ``gram32_joint``, as the reference does.
"""

from __future__ import annotations

import ctypes

import torch

from pint_tpu_torch.ops._cuda_build import c_entry, check_precision

F32 = torch.float32
F64 = torch.float64

#: rows per f32 sub-chunk of the plain version (the reference's _SUB)
SUB = 128
#: rows per chunk of the kernel's copy ring
ROWS = 64
#: side lengths of the kernel's output tiles (the f64 MMA's m and n)
TILE_ROWS, TILE_COLS = 16, 8
#: most pass-1 blocks: one per SM of an H100; a constant, so the
#: reduction order (and so every bit of the result) depends on n alone
NB_MAX = 132
#: threads per pass-1 block: 8 MMA warps and 8 converter warps
THREADS = 512
#: most columns k + p1 of the narrow path: two raw stages and two f64 Y
#: tiles of 64 rows fit in shared memory, and its 30 output tiles fit 8
#: warps of at most 6 tiles each
Q_MAX = 80
#: the bulk copies need 16-byte aligned spans
ALIGN = 16
#: the wide path (q > Q_MAX): columns per panel, rows per chunk, threads
#: per pass-1 block, and the most pass-1 blocks (two waves of one block
#: per SM), which the panel pairs share out as row blocks
PANEL = 128
WIDE_ROWS = 32
WIDE_THREADS = 512
WIDE_BLOCKS = 264
#: the reference's block table (pint_tpu/ops/pallas_fit.py:96): k and p1
#: each padded to 128 lanes, the two together at most 640 (its budget of
#: 3 q^2 f32 accumulators in half of a 10 MiB VMEM)
REF_LANES = 128
REF_Q_MAX = 640


def fused_tile_count(q: int) -> int:
    """Output tiles of the kernel: 16-column bands I of Y, 8-column tiles
    2 I <= J < ceil(q / 8)."""
    nt, nbt = -(-q // TILE_COLS), -(-q // TILE_ROWS)
    return nbt * nt - nbt * (nbt - 1)


def _pad(x: int, m: int) -> int:
    return -(-x // m) * m


def fused_block_table(n: int, k: int, p1: int):
    """Launch geometry for T (n, k), A (n, p1), or None when the
    reference's table refuses the shape (pad128(k) + pad128(p1) > 640).
    A pure function of the shapes.  Returns (nb, q_pad, threads): for
    q = k + p1 <= Q_MAX the narrow path's (pass-1 blocks, Y's width in
    16-column bands, 512); wider, the wide path's (row blocks, Y's width
    in 128-column panels, 512)."""
    if not (1 <= n < 2**31 and k >= 1 and p1 >= 1):
        return None
    if _pad(k, REF_LANES) + _pad(p1, REF_LANES) > REF_Q_MAX:
        return None
    q = k + p1
    if q <= Q_MAX:
        return min(-(-n // ROWS), NB_MAX), _pad(q, TILE_ROWS), THREADS
    npan = -(-q // PANEL)
    pairs = npan * (npan + 1) // 2
    return (min(-(-n // WIDE_ROWS), max(1, WIDE_BLOCKS // pairs)),
            npan * PANEL, WIDE_THREADS)


def fused_gram_joint_plain(T32, A, w, precision: str = "highest"):
    """The kernel's function in plain torch (the CPU route, and the
    yardstick the kernel is held to on the card)."""
    check_precision("fused_gram_joint", precision)
    n, k = T32.shape
    s32 = torch.sqrt(w).to(F32)
    Y = torch.cat([T32.to(F32), A.to(F32)], dim=1) * s32[:, None]
    n_pad = -(-n // SUB) * SUB
    Yp = torch.zeros((n_pad, Y.shape[1]), dtype=F64, device=Y.device)
    Yp[:n] = Y
    Yb = Yp.reshape(n_pad // SUB, SUB, Y.shape[1])
    G = torch.sum(torch.bmm(Yb.transpose(1, 2), Yb), dim=0)
    return G[:k, :k], G[:k, k:], G[k:, k:]


def fused_gram_joint_cuda(T, A, w, precision: str = "highest"):
    """Launch the CUDA kernel on tensors on one card.  T may be f32 or
    f64 (the kernel rounds it to f32 as it converts); A and w are f64.
    Raises, naming the reason, on what the kernel cannot take: the checks
    of types, shapes, contiguity and 16-byte alignment come before the
    check of the device."""
    check_precision("fused_gram_joint", precision)
    if T.dtype not in (F32, F64) or A.dtype != F64 or w.dtype != F64:
        raise TypeError(
            "fused_gram_joint_cuda: T f32/f64, A f64, w f64 expected, got "
            f"{T.dtype}, {A.dtype}, {w.dtype}"
        )
    if T.dim() != 2 or A.dim() != 2 or w.dim() != 1:
        raise ValueError("fused_gram_joint_cuda: T (n,k), A (n,p1), w (n,)")
    n, k = T.shape
    p1 = A.shape[1]
    if A.shape[0] != n or w.shape[0] != n:
        raise ValueError(
            f"fused_gram_joint_cuda: row counts differ {n}, {A.shape[0]}, "
            f"{w.shape[0]}"
        )
    if not (T.is_contiguous() and A.is_contiguous() and w.is_contiguous()):
        raise ValueError("fused_gram_joint_cuda: inputs must be contiguous")
    for name, x in (("T", T), ("A", A), ("w", w)):
        if x.data_ptr() % ALIGN:
            raise ValueError(
                f"fused_gram_joint_cuda: {name} starts {x.data_ptr() % ALIGN} "
                f"bytes past a {ALIGN}-byte boundary; the kernel's bulk copies "
                "need 16-byte aligned tensors (take a .clone())"
            )
    tab = fused_block_table(n, k, p1)
    if tab is None:
        raise ValueError(
            f"fused_gram_joint_cuda: (n={n}, k={k}, p1={p1}) is outside "
            "fused_block_table; route through ops/ffgram.py::gram32_joint"
        )
    dev = T.device
    if dev.type != "cuda" or A.device != dev or w.device != dev:
        raise ValueError("fused_gram_joint_cuda: T, A, w must be on one card")
    nb, q_pad, threads = tab
    wide = k + p1 > Q_MAX
    if wide:
        npan = q_pad // PANEL
        scratch = nb * (npan * (npan + 1) // 2) * PANEL * PANEL
    else:
        scratch = nb * fused_tile_count(k + p1) * TILE_ROWS * TILE_COLS
    partial = torch.empty(scratch, dtype=F64, device=dev)
    gtt = torch.empty((k, k), dtype=F64, device=dev)
    gta = torch.empty((k, p1), dtype=F64, device=dev)
    gaa = torch.empty((p1, p1), dtype=F64, device=dev)
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = c_entry("fused_gram_wide" if wide else "fused_gram_joint",
                     [p, i, p, p, i, i, i, i, i, i, p, p, p, p, p])
    with torch.cuda.device(dev):
        err = launch(
            T.data_ptr(), int(T.dtype == F64), A.data_ptr(), w.data_ptr(),
            n, k, p1, q_pad, nb, threads, partial.data_ptr(),
            gtt.data_ptr(), gta.data_ptr(), gaa.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_gram_joint kernel launch failed: "
                           f"cudaError {err}")
    fused_gram_joint_cuda.launches += 1
    fused_gram_joint_cuda.wide_launches += wide
    return gtt, gta, gaa


fused_gram_joint_cuda.launches = 0
fused_gram_joint_cuda.wide_launches = 0


def fused_gram_joint(T32, A, w, precision: str = "highest"):
    """Joint Gram of [T | A] under diag(w): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if T32.device.type == "cpu":
        return fused_gram_joint_plain(T32, A, w, precision)
    if T32.device.type == "cuda":
        return fused_gram_joint_cuda(T32, A, w, precision)
    raise ValueError(f"fused_gram_joint: unsupported device {T32.device}")
