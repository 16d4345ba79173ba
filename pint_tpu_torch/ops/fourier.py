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

:func:`fourier_gram_table` and :func:`fourier_apply_table` give, from
the shapes alone, the geometry of one launch of each kernel.  A launch
takes at most :func:`gram_columns` columns of X (at least 64) and
``M_MAX`` columns of z; the CUDA wrappers cut wider X and z into column
slices, one launch each.  Each output column's sum is independent of the
others and the chunk height (:func:`gram_rows`) depends on k alone, so a
sliced call gives the bits of one wider launch.  The card takes every p
and m, and k up to the harmonics whose basis tile fits shared memory
(424 for fourier_gram, 598 for fourier_apply); the plain versions take
every shape.  ``precision`` takes the reference's three rungs, each
computing the same values (``_cuda_build.check_precision``).  The
reference's TPU tile argument ``block`` is not part of these
signatures: the kernels choose their own geometry.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from pint_tpu_torch.ops._cuda_build import (
    c_entry,
    check_precision,
    count_launches,
)

F32 = torch.float32
F64 = torch.float64

#: 2 pi, rounded to f32 where it meets the f32 frequencies
TWO_PI = 2.0 * math.pi
#: rows per 2-d chunk of the plain versions' sums, and per staged chunk
#: of fourier_gram where its ring holds them (gram_rows)
SUB = 64
#: fourier_gram's output tiles: 16 x 8, the f64 MMA m16n8k16's m and n
TILE_ROWS = 16
TILE = 8
#: most pass-1 blocks along n: a constant, so the reduction order (and so
#: every bit of the result) depends on n alone
NB_MAX = 264
#: threads per fourier_gram pass-1 block (12 warps), and the output
#: tiles a warp owns: 2 where two blocks fit an SM's shared memory, else 6
#: (one block an SM leaves it the registers of two)
THREADS = 384
WARPS = THREADS // 32
TILES_PER_WARP = (2, 6)
#: shared memory of an SM that blocks can have (bytes), and what the
#: card reserves for each block beside its own
SMEM_SM = 233_472
SMEM_BLOCK_RESERVED = 1024
#: shared memory a block can have on an H100 (bytes)
SMEM_MAX = 232_448
#: fourier_gram's chunk heights, and the columns of X its ring must hold
#: beside the basis for a height to be taken
GRAM_ROWS = (64, 32, 16)
GRAM_P_MIN = 64
#: columns of z per fourier_apply launch
M_MAX = 16
#: fourier_apply: rows per block (the first whose tiles fit), threads
APPLY_ROWS = (128, 64, 32, 16)
APPLY_THREADS = 256


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _mma_stride(cols8: int) -> int:
    """fourier_basis.cuh's fourier_mma_stride: 8 mod 16 floats a row."""
    return cols8 + 8 if cols8 % 16 == 0 else cols8


def _gram_smem(kb: int, q_pad: int, rows: int) -> int:
    """fourier_gram.cu's pass1_smem: two ring slots and the frequencies."""
    return (2 * rows * (_mma_stride(kb) + _mma_stride(q_pad)) * 4
            + _ceil_to(kb // 2, 64) * 4)


@functools.lru_cache(maxsize=128)
def gram_rows(k: int):
    """fourier_gram's chunk height for k harmonics: the largest of
    GRAM_ROWS whose ring holds the basis and GRAM_P_MIN columns of X
    (64 for k <= 88), or None past 424 harmonics.  A function of k
    alone, so the column slicing never changes a bit."""
    kb = _ceil_to(2 * k, TILE_ROWS)
    for rows in GRAM_ROWS:
        if _gram_smem(kb, kb + GRAM_P_MIN, rows) <= SMEM_MAX:
            return rows
    return None


@functools.lru_cache(maxsize=128)
def gram_columns(k: int):
    """Most columns of X one fourier_gram launch takes beside k
    harmonics (a multiple of 8, at least GRAM_P_MIN), or None."""
    rows = gram_rows(k)
    if rows is None:
        return None
    kb = _ceil_to(2 * k, TILE_ROWS)
    p = GRAM_P_MIN
    while _gram_smem(kb, kb + p + TILE, rows) <= SMEM_MAX:
        p += TILE
    return p


def gram_tiles(kb: int, q_pad: int, rows: int) -> int:
    """Output tiles a fourier_gram warp owns: 2 where two blocks' rings
    fit an SM, else 6."""
    two = 2 * (_gram_smem(kb, q_pad, rows) + SMEM_BLOCK_RESERVED) <= SMEM_SM
    return TILES_PER_WARP[0] if two else TILES_PER_WARP[1]


def fourier_gram_table(n: int, k: int, p: int):
    """Launch geometry of one fourier_gram launch for n TOAs, k harmonics
    and min(p, gram_columns(k)) columns of X, or None when the card
    cannot take k.  Returns (nb blocks along n, ny tile groups, kb padded
    basis columns, q_pad padded columns, ntiles, threads per block); the
    chunk height is gram_rows(k) and the tiles a warp owns gram_tiles."""
    cols = gram_columns(k) if k >= 1 else None
    if n < 1 or p < 1 or cols is None:
        return None
    kb = _ceil_to(2 * k, TILE_ROWS)
    q_pad = kb + _ceil_to(min(p, cols), TILE)
    rows = gram_rows(k)
    nbt, nt = kb // TILE_ROWS, q_pad // TILE
    ntiles = nbt * nt - nbt * (nbt - 1)  # row I holds tiles 2I .. nt - 1
    ny = -(-ntiles // (WARPS * gram_tiles(kb, q_pad, rows)))
    nb = min(-(-n // rows), NB_MAX)
    return nb, ny, kb, q_pad, ntiles, THREADS


def _apply_smem(k: int, m: int, rows: int) -> int:
    """fourier_apply.cu's apply_smem."""
    k4 = _ceil_to(2 * k, 4)
    sb = k4 if k4 % 8 == 4 else k4 + 4
    mz = 8 if m <= 8 else 16
    return k4 * mz * 8 + rows * sb * 4 + _ceil_to(k, 64) * 4


def apply_rows(k: int):
    """fourier_apply's rows per block for k harmonics: 128 up to k = 64
    (the geometry measured at the bench shape), past that the first of
    APPLY_ROWS whose tiles take at most a quarter of the shared memory at
    M_MAX columns, so that 4 blocks an SM keep the sincos chains in
    flight, else the fewest, 16, where they fit; None past 598
    harmonics.  The rows of a block change no output bit."""
    if k <= 64:
        return APPLY_ROWS[0]
    for rows in APPLY_ROWS:
        if _apply_smem(k, M_MAX, rows) <= SMEM_MAX // 4:
            return rows
    return APPLY_ROWS[-1] if _apply_smem(k, M_MAX, APPLY_ROWS[-1]) <= (
        SMEM_MAX) else None


def fourier_apply_table(n: int, k: int, m: int):
    """Launch geometry of fourier_apply: (blocks of apply_rows(k) rows,
    threads per block) for launches of at most M_MAX columns of z, or
    None when the card cannot take k."""
    rows = apply_rows(k) if k >= 1 else None
    if n < 1 or m < 1 or rows is None:
        return None
    return -(-n // rows), APPLY_THREADS


def basis32(t, freqs):
    """The reference's f32 basis [sin | cos] (n, 2k): the argument
    (f32(2 pi) * f32(f_j)) * f32(t_i) in f32, then its sin and cos
    correctly rounded to f32 (through f64)."""
    fw = torch.full((), TWO_PI, dtype=F32, device=t.device) * freqs.to(F32)
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
_GRAM_ARGS = [_VP] * 4 + [_INT] * 10 + [_VP] * 4
_APPLY_ARGS = [_VP] * 3 + [_INT] * 6 + [_VP] * 2


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
    return n, k, p


def _apply_shape(t, freqs, z):
    n, k, m = t.shape[0], freqs.shape[0], z.shape[-1]
    if z.shape[0] != 2 * k:
        raise ValueError(
            f"fourier_apply: z has {z.shape[0]} rows, 2k = {2 * k}"
        )
    return n, k, m


def _slices(total: int, width: int):
    """[c0, c1) column slices of at most ``width`` columns."""
    return [(c, min(c + width, total)) for c in range(0, total, width)]


def fourier_gram_cuda(t, freqs, w, X, precision: str = "highest"):
    """Launch ``csrc/fourier_gram.cu`` on f64 tensors on one card: one
    launch per slice of at most gram_columns(k) columns of X; Sigma is
    the first launch's (every launch computes the same bits).  Shapes the
    card cannot take raise before the device is looked at."""
    check_precision("fourier_gram", precision)
    n, k, p = _gram_shape(t, freqs, w, X)
    if fourier_gram_table(n, k, p) is None:
        raise ValueError(
            f"fourier_gram: (n={n}, k={k}, p={p}) is outside "
            "fourier_gram_table (k <= 424 harmonics on the card)"
        )
    width = gram_columns(k)
    dev = _check_card("fourier_gram_cuda", (t, freqs, w, X), (1, 1, 1, 2))
    launch = c_entry("fourier_gram", _GRAM_ARGS)
    rows = gram_rows(k)
    sig = None
    twx = torch.empty((2 * k, p), dtype=F64, device=dev)
    for c0, c1 in _slices(p, width):
        Xs = X if (c0, c1) == (0, p) else X[:, c0:c1].contiguous()
        nb, ny, kb, q_pad, ntiles, threads = fourier_gram_table(n, k, c1 - c0)
        partial = torch.empty(nb * ntiles * TILE_ROWS * TILE, dtype=F64,
                              device=dev)
        s = torch.empty((2 * k, 2 * k), dtype=F64, device=dev)
        tw = twx if Xs is X else torch.empty((2 * k, c1 - c0), dtype=F64,
                                             device=dev)
        err = _launch(dev, launch, t.data_ptr(), freqs.data_ptr(),
                      w.data_ptr(), Xs.data_ptr(), n, k, c1 - c0, kb, q_pad,
                      nb, ny, threads, rows, gram_tiles(kb, q_pad, rows),
                      partial.data_ptr(), s.data_ptr(), tw.data_ptr())
        if err != 0:
            raise RuntimeError(
                f"fourier_gram kernel launch failed: cudaError {err}"
            )
        fourier_gram_cuda.launches += 1
        if tw is not twx:
            twx[:, c0:c1] = tw
        if sig is None:
            sig = s
    return sig, twx


count_launches(fourier_gram_cuda, "launches")


def fourier_apply_cuda(t, freqs, z, precision: str = "highest"):
    """Launch ``csrc/fourier_apply.cu`` on f64 tensors on one card: one
    launch per slice of at most M_MAX columns of z.  Shapes the card
    cannot take raise before the device is looked at."""
    check_precision("fourier_apply", precision)
    n, k, m = _apply_shape(t, freqs, z)
    tab = fourier_apply_table(n, k, m)
    if tab is None:
        raise ValueError(
            f"fourier_apply: (n={n}, k={k}, m={m}) is outside "
            "fourier_apply_table (k <= 598 harmonics on the card)"
        )
    blocks, threads = tab
    dev = _check_card("fourier_apply_cuda", (t, freqs, z), (1, 1, 2))
    launch = c_entry("fourier_apply", _APPLY_ARGS)
    rows = apply_rows(k)
    y = torch.empty((n, m), dtype=F32, device=dev)
    for c0, c1 in _slices(m, M_MAX):
        zs = z if (c0, c1) == (0, m) else z[:, c0:c1].contiguous()
        ys = y if zs is z else torch.empty((n, c1 - c0), dtype=F32,
                                           device=dev)
        err = _launch(dev, launch, t.data_ptr(), freqs.data_ptr(),
                      zs.data_ptr(), n, k, c1 - c0, blocks, threads, rows,
                      ys.data_ptr())
        if err != 0:
            raise RuntimeError(
                f"fourier_apply kernel launch failed: cudaError {err}"
            )
        fourier_apply_cuda.launches += 1
        if ys is not y:
            y[:, c0:c1] = ys
    return y


count_launches(fourier_apply_cuda, "launches")


def fourier_gram(t, freqs, w, X, precision: str = "highest"):
    """(Sigma (2k, 2k), TWX (2k, p)) f64 for T = [sin | cos](2 pi f t)
    without materializing T: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
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
