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
  (two passes, fixed-order f64 reduction, bitwise reproducible) and
  counts its launches in ``fused_gram_joint_cuda.launches``.
- :func:`fused_gram_joint` dispatches on where the tensors lie: the
  plain version for CPU tensors, the kernel for CUDA tensors, and no
  fallback between them.
- :func:`fused_block_table` says, from the shapes alone, whether the
  kernel's shared-memory design takes them; ``fitting/gls.py::_joint_gram``
  routes shapes outside it to ``gram32_joint``.
"""

from __future__ import annotations

import ctypes

import torch

F32 = torch.float32
F64 = torch.float64

#: rows per f32 sub-chunk (the reference's _SUB)
SUB = 128
#: side of the kernel's output tiles (the f64 MMA's m and n)
TILE = 8
#: most pass-1 blocks: two per SM of an H100; a constant, so the
#: reduction order (and so every bit of the result) depends on n alone
NB_MAX = 264
#: threads per pass-1 block: 8 warps
THREADS = 256
#: widest padded column count q_pad = roundup(k + p1, 8) the kernel takes:
#: its 10 x 11 / 2 = 55 tiles of the upper triangle fit 8 warps of at
#: most 8 tiles each, and 128 rows of f64 fit in shared memory
Q_MAX = 80


def fused_block_table(n: int, k: int, p1: int):
    """Launch geometry of the kernel for T (n, k), A (n, p1), or None
    when the shape is outside its design.  A pure function of the shapes.
    Returns (nb blocks, q_pad, threads per block)."""
    if n < 1 or k < 1 or p1 < 1:
        return None
    q_pad = -(-(k + p1) // TILE) * TILE
    if q_pad > Q_MAX:
        return None
    nb = min(-(-n // SUB), NB_MAX)
    return nb, q_pad, THREADS


def fused_gram_joint_plain(T32, A, w, precision: str = "highest"):
    """The kernel's function in plain torch (the CPU route, and the
    yardstick the kernel is held to on the card)."""
    _check_precision(precision)
    n, k = T32.shape
    s32 = torch.sqrt(w).to(F32)
    Y = torch.cat([T32.to(F32), A.to(F32)], dim=1) * s32[:, None]
    n_pad = -(-n // SUB) * SUB
    Yp = torch.zeros((n_pad, Y.shape[1]), dtype=F64, device=Y.device)
    Yp[:n] = Y
    Yb = Yp.reshape(n_pad // SUB, SUB, Y.shape[1])
    G = torch.sum(torch.bmm(Yb.transpose(1, 2), Yb), dim=0)
    return G[:k, :k], G[:k, k:], G[k:, k:]


def _check_precision(precision):
    if precision != "highest":
        raise ValueError(
            f"fused_gram_joint: precision={precision!r} is not ported; "
            "only the 'highest' rung the GLS step uses is"
        )


_launch = None


def _lib():
    """The kernel's C entry with its ctypes signature (built at first use:
    every pointer and the stream as c_void_p, ints as c_int)."""
    global _launch
    if _launch is None:
        from pint_tpu_torch.ops._cuda_build import load_library

        fn = load_library("fused_gram_joint").fused_gram_joint_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, i, i, i, i, i, i, p, p, p, p, p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def fused_gram_joint_cuda(T, A, w, precision: str = "highest"):
    """Launch the CUDA kernel on tensors on one card.  T may be f32 or
    f64 (the kernel rounds it to f32 in registers); A and w are f64."""
    _check_precision(precision)
    dev = T.device
    if dev.type != "cuda" or A.device != dev or w.device != dev:
        raise ValueError("fused_gram_joint_cuda: T, A, w must be on one card")
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
    tab = fused_block_table(n, k, p1)
    if tab is None:
        raise ValueError(
            f"fused_gram_joint_cuda: (n={n}, k={k}, p1={p1}) is outside "
            "fused_block_table; route through ops/ffgram.py::gram32_joint"
        )
    nb, q_pad, threads = tab
    nt = q_pad // TILE
    partial = torch.empty(nb * nt * (nt + 1) // 2 * TILE * TILE, dtype=F64,
                          device=dev)
    gtt = torch.empty((k, k), dtype=F64, device=dev)
    gta = torch.empty((k, p1), dtype=F64, device=dev)
    gaa = torch.empty((p1, p1), dtype=F64, device=dev)
    launch = _lib()
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
    return gtt, gta, gaa


fused_gram_joint_cuda.launches = 0


def fused_gram_joint(T32, A, w, precision: str = "highest"):
    """Joint Gram of [T | A] under diag(w): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if T32.device.type == "cpu":
        return fused_gram_joint_plain(T32, A, w, precision)
    if T32.device.type == "cuda":
        return fused_gram_joint_cuda(T32, A, w, precision)
    raise ValueError(f"fused_gram_joint: unsupported device {T32.device}")
