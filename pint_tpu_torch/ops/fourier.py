"""Streaming Fourier-basis products: hand-written CUDA fourier_gram and
fourier_apply.

Counterpart of ``pint_tpu/ops/pallas_kernels.py``.  For the red-noise
basis T = [sin(2 pi f_j t_i) | cos(2 pi f_j t_i)] (n, 2k), columns
[sin_1 .. sin_k, cos_1 .. cos_k], generated from t and the harmonic
frequencies and never written to device memory:

- ``fourier_gram(t, freqs, w, X)`` -> (Sigma = T^T diag(w) T (2k, 2k),
  TWX = T^T diag(w) X (2k, p)), f64;
- ``fourier_apply(t, freqs, z)`` -> y = T z (n, m) for z (2k, m), f32.

The basis values are the reference's: t, freqs, w, X and z are rounded
to f32 (the reference casts them before its kernel), the phase argument
is the f32 expression ``(f32(2 pi) * f_j) * t_i`` in that order, and its
sin and cos are f32 values: here the f32 roundings of the f64 sin and
cos of the f32 argument, i.e. the correctly rounded f32 values, which
every device computes alike (an f32 sine's last bit differs between the
CPU's and the card's libraries).  That argument carries ~1e-5 rad at
multi-year spans: the reference's documented price for f32 phases
(``pint_tpu/fitting/gls.py::gls_step_woodbury_fourier``), kept here
because it is the function the TPU kernel computes.  The products of
those f32 values are summed in f64, where the TPU summed in f32: on a
card with native f64 that costs little, and it keeps the sums from
growing an error with n (PERF.md).  Sigma is the kernel's upper
triangle mirrored, so it is exactly symmetric.

Each function comes three ways, as ``ops/fused_gram.py``:

- ``*_plain``: the same function in plain torch (the CPU route, and the
  yardstick the kernel is held to on the card);
- ``*_cuda``: launches ``csrc/fourier_gram.cu`` / ``csrc/fourier_apply.cu``
  (both generate the basis by ``csrc/fourier_basis.cuh``) and counts its
  launches in ``*_cuda.launches``;
- the dispatcher: the plain version for CPU tensors, the kernel for CUDA
  tensors, no fallback between them.

:func:`fourier_gram_table` and :func:`fourier_apply_table` say from the
shapes alone what the kernels take (k <= 64 harmonics, p <= 16 and
m <= 16 columns); the dispatchers raise ValueError on any other shape, on
every device, before any launch.  Only the ``precision='highest'`` rung
is ported.  The reference's TPU tile argument ``block`` is not part of
these signatures: the kernels choose their own geometry.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pint_tpu_torch.ops._cuda_build import c_entry, check_precision

F32 = torch.float32
F64 = torch.float64

#: 2 pi, rounded to f32 where it meets the f32 frequencies
TWO_PI = 2.0 * math.pi
#: rows per staged chunk of fourier_gram (a slot of its shared ring)
SUB = 64
#: fourier_gram's output tiles: 16 x 8, the f64 MMA m16n8k16's m and n
TILE_ROWS = 16
TILE = 8
#: most pass-1 blocks along n: a constant, so the reduction order (and so
#: every bit of the result) depends on n alone
NB_MAX = 264
#: threads per fourier_gram pass-1 block (12 warps of at most 2 tiles)
THREADS = 384
TILES_PER_BLOCK = 24
#: widest shapes the kernels take
K_MAX = 64
P_MAX = 16
M_MAX = 16
#: fourier_apply: rows and threads per block
APPLY_ROWS = 128
APPLY_THREADS = 256


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def fourier_gram_table(n: int, k: int, p: int):
    """Launch geometry of fourier_gram for n TOAs, k harmonics and p
    columns of X, or None when the shape is outside the kernel's design.
    Returns (nb blocks along n, ny tile groups, kb padded basis columns,
    q_pad padded columns, ntiles, threads per block)."""
    if n < 1 or not 1 <= k <= K_MAX or not 1 <= p <= P_MAX:
        return None
    kb = _ceil_to(2 * k, TILE_ROWS)
    q_pad = kb + _ceil_to(p, TILE)
    nbt, nt = kb // TILE_ROWS, q_pad // TILE
    ntiles = nbt * nt - nbt * (nbt - 1)  # row I holds tiles 2I .. nt - 1
    ny = -(-ntiles // TILES_PER_BLOCK)
    nb = min(-(-n // SUB), NB_MAX)
    return nb, ny, kb, q_pad, ntiles, THREADS


def fourier_apply_table(n: int, k: int, m: int):
    """Launch geometry of fourier_apply: (blocks of APPLY_ROWS rows,
    threads per block), or None when the shape is outside the kernel's
    design."""
    if n < 1 or not 1 <= k <= K_MAX or not 1 <= m <= M_MAX:
        return None
    return -(-n // APPLY_ROWS), APPLY_THREADS


def basis32(t, freqs):
    """The reference's f32 basis [sin | cos] (n, 2k): the argument
    (f32(2 pi) * f32(f_j)) * f32(t_i) in f32, then its sin and cos
    correctly rounded to f32 (through f64)."""
    fw = torch.tensor(TWO_PI, dtype=F32, device=t.device) * freqs.to(F32)
    arg = (fw[None, :] * t.to(F32)[:, None]).to(F64)
    return torch.cat([torch.sin(arg), torch.cos(arg)], dim=1).to(F32)


def fourier_gram_plain(t, freqs, w, X, precision: str = "highest"):
    """The kernel's function in plain torch: the f32 basis, its rows
    weighted in f32, and the products of f32 values summed in f64 over
    SUB-row chunks (``ops/fused_gram.py::fused_gram_joint_plain``)."""
    check_precision("fourier_gram", precision)
    T = basis32(t, freqs)
    k2 = T.shape[1]
    L = T * w.to(F32)[:, None]
    R = torch.cat([T, X.to(F32)], dim=1)
    n = T.shape[0]
    n_pad = _ceil_to(n, SUB)
    Lp = torch.zeros((n_pad, k2), dtype=F64, device=T.device)
    Rp = torch.zeros((n_pad, R.shape[1]), dtype=F64, device=T.device)
    Lp[:n] = L
    Rp[:n] = R
    G = torch.sum(torch.bmm(Lp.reshape(-1, SUB, k2).transpose(1, 2),
                            Rp.reshape(-1, SUB, R.shape[1])), dim=0)
    upper = torch.triu(G[:, :k2])
    return upper + torch.triu(G[:, :k2], 1).T, G[:, k2:]


def fourier_apply_plain(t, freqs, z, precision: str = "highest"):
    """y = T z in plain torch: the f32 basis and f32 z, multiplied in
    f64, rounded to f32."""
    check_precision("fourier_apply", precision)
    T = basis32(t, freqs)
    return (T.to(F64) @ z.to(F32).to(F64)).to(F32)


def _check_card(name, tensors, dims):
    index = tensors[0].get_device()  # -1 on the CPU
    if index < 0 or any(a.get_device() != index for a in tensors):
        raise ValueError(f"{name}: the inputs must lie on one card")
    dev = tensors[0].device
    for a, d in zip(tensors, dims):
        if a.dtype != F64 or a.dim() != d or not a.is_contiguous():
            raise ValueError(
                f"{name}: contiguous f64 inputs of dims {dims} expected, "
                f"got {[(x.dtype, tuple(x.shape)) for x in tensors]}"
            )
    return dev


_VP, _INT = ctypes.c_void_p, ctypes.c_int
#: the C entries' ctypes signatures: pointers and the stream as c_void_p
_GRAM_ARGS = [_VP] * 4 + [_INT] * 8 + [_VP] * 4
_APPLY_ARGS = [_VP] * 3 + [_INT] * 5 + [_VP] * 2


def _launch(dev, entry, *args):
    """Call a C entry on ``dev``'s current stream and return its
    cudaError code; the current device is switched only when it
    differs."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index == torch.cuda.current_device():
        return entry(*args, stream)
    with torch.cuda.device(dev):
        return entry(*args, stream)


def _gram_shape(t, freqs, w, X):
    n, k, p = t.shape[0], freqs.shape[0], X.shape[-1]
    if w.shape[0] != n or X.shape[0] != n:
        raise ValueError(
            f"fourier_gram: row counts differ {n}, {w.shape[0]}, {X.shape[0]}"
        )
    tab = fourier_gram_table(n, k, p)
    if tab is None:
        raise ValueError(
            f"fourier_gram: (n={n}, k={k}, p={p}) is outside "
            f"fourier_gram_table (1 <= k <= {K_MAX}, 1 <= p <= {P_MAX})"
        )
    return n, k, p, tab


def _apply_shape(t, freqs, z):
    n, k, m = t.shape[0], freqs.shape[0], z.shape[-1]
    if z.shape[0] != 2 * k:
        raise ValueError(
            f"fourier_apply: z has {z.shape[0]} rows, 2k = {2 * k}"
        )
    tab = fourier_apply_table(n, k, m)
    if tab is None:
        raise ValueError(
            f"fourier_apply: (n={n}, k={k}, m={m}) is outside "
            f"fourier_apply_table (1 <= k <= {K_MAX}, 1 <= m <= {M_MAX})"
        )
    return n, k, m, tab


def fourier_gram_cuda(t, freqs, w, X, precision: str = "highest"):
    """Launch ``csrc/fourier_gram.cu`` on f64 tensors on one card."""
    check_precision("fourier_gram", precision)
    dev = _check_card("fourier_gram_cuda", (t, freqs, w, X), (1, 1, 1, 2))
    n, k, p, (nb, ny, kb, q_pad, ntiles, threads) = _gram_shape(t, freqs, w, X)
    partial = torch.empty(nb * ntiles * TILE_ROWS * TILE, dtype=F64,
                          device=dev)
    sig = torch.empty((2 * k, 2 * k), dtype=F64, device=dev)
    twx = torch.empty((2 * k, p), dtype=F64, device=dev)
    launch = c_entry("fourier_gram", _GRAM_ARGS)
    err = _launch(dev, launch, t.data_ptr(), freqs.data_ptr(), w.data_ptr(),
                  X.data_ptr(), n, k, p, kb, q_pad, nb, ny, threads,
                  partial.data_ptr(), sig.data_ptr(), twx.data_ptr())
    if err != 0:
        raise RuntimeError(
            f"fourier_gram kernel launch failed: cudaError {err}"
        )
    fourier_gram_cuda.launches += 1
    return sig, twx


fourier_gram_cuda.launches = 0


def fourier_apply_cuda(t, freqs, z, precision: str = "highest"):
    """Launch ``csrc/fourier_apply.cu`` on f64 tensors on one card."""
    check_precision("fourier_apply", precision)
    dev = _check_card("fourier_apply_cuda", (t, freqs, z), (1, 1, 2))
    n, k, m, (blocks, threads) = _apply_shape(t, freqs, z)
    y = torch.empty((n, m), dtype=F32, device=dev)
    launch = c_entry("fourier_apply", _APPLY_ARGS)
    err = _launch(dev, launch, t.data_ptr(), freqs.data_ptr(), z.data_ptr(),
                  n, k, m, blocks, threads, y.data_ptr())
    if err != 0:
        raise RuntimeError(
            f"fourier_apply kernel launch failed: cudaError {err}"
        )
    fourier_apply_cuda.launches += 1
    return y


fourier_apply_cuda.launches = 0


def fourier_gram(t, freqs, w, X, precision: str = "highest"):
    """(Sigma (2k, 2k), TWX (2k, p)) f64 for T = [sin | cos](2 pi f t)
    without materializing T: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors.  Shapes outside fourier_gram_table raise."""
    _gram_shape(t, freqs, w, X)
    if t.device.type == "cpu":
        return fourier_gram_plain(t, freqs, w, X, precision)
    if t.device.type == "cuda":
        return fourier_gram_cuda(t, freqs, w, X, precision)
    raise ValueError(f"fourier_gram: unsupported device {t.device}")


def fourier_apply(t, freqs, z, precision: str = "highest"):
    """y (n, m) = T z, f32, without materializing T: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    _apply_shape(t, freqs, z)
    if t.device.type == "cpu":
        return fourier_apply_plain(t, freqs, z, precision)
    if t.device.type == "cuda":
        return fourier_apply_cuda(t, freqs, z, precision)
    raise ValueError(f"fourier_apply: unsupported device {t.device}")
