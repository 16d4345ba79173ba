"""The mixed GLS step's fused joint Gram: a hand-written CUDA kernel.

Counterpart of ``pint_tpu/ops/pallas_fit.py``.  ``fused_gram_joint(T, A,
w)`` returns (G_TT (k, k), G_TA (k, p1), G_AA (p1, p1)) in f64 for
G = Y^T Y, Y = [f32(T) | f32(A)] * f32(sqrt(w)): T the noise basis, A the
column-normalized design matrix with the residual as last column, w the
inverse white variances.  Y holds the reference's f32 values (its
``'highest'`` rung: exact products of f32 operands, which every rung of
``precision`` computes here); their products are
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
  and ``csrc/fused_gram_wide.cu`` (the same pipeline with G's tiles split
  into balanced tile groups, :func:`wide_geometry`; the same contract) for
  wider Y; it counts its launches in
  ``fused_gram_joint_cuda.launches``, those of the wide path also in
  ``fused_gram_joint_cuda.wide_launches``.
- A pulsar axis: T (P, n, k), A (P, n, p1), w (P, n) give (P, k, k),
  (P, k, p1), (P, p1, p1) from ONE launch of either kernel (the
  reference's pallas_call under ``jax.vmap`` gains a batch grid axis);
  the plain version batches the same way.  The wrapper counts such
  launches in ``fused_gram_joint_cuda.batched_launches`` as well.
- :func:`fused_gram_joint` dispatches on where the tensors lie: the
  plain version for CPU tensors, the kernel for CUDA tensors, and no
  fallback between them.  It goes through ``_JointGram``, an
  ``autograd.Function`` whose ``vmap`` rule turns a call inside
  ``torch.func.vmap`` (``parallel/pta.py``'s batched step) into that one
  batched call.
- :func:`fused_block_table` says, from the shapes alone, which path
  takes them: it admits exactly the shapes the reference's table admits
  (pad128(k) + pad128(p1) <= 640), and ``fitting/gls.py::_joint_gram``
  routes only the others to ``gram32_joint``, as the reference does.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from pint_tpu_torch.ops._cuda_build import (
    c_entry,
    check_precision,
    count_launches,
)

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
#: the wide path (q > Q_MAX, csrc/fused_gram_wide.cu): MMA warps and
#: converter warps of a pass-1 block; an MMA warp's task, TASK_ROWS row
#: bands by TASK_COLS column bands of 16 Y columns; the ring's raw stages;
#: the chunk heights it may take, most first; the shared memory a block
#: may use; the most bands one tile group's Y tile holds (q = 640)
WIDE_MMA_WARPS = 8
WIDE_CONV_WARPS = 4
WIDE_THREADS = 32 * (WIDE_MMA_WARPS + WIDE_CONV_WARPS)
TASK_ROWS, TASK_COLS = 2, 3
WIDE_STAGES = 2
WIDE_CHUNK_ROWS = (32, 16)
SMEM_MAX = 232_448
BAND = 16
NBG_MAX = 40
#: a task's ints in the schedule table (row bands, column bands, their
#: slots in the group's Y tile, the live-tile mask) and a group's (its
#: band count, its bands, its MMA warps' tasks)
TASK_INTS = 2 * (TASK_ROWS + TASK_COLS) + 1
GROUP_INTS = 1 + NBG_MAX + WIDE_MMA_WARPS * TASK_INTS
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


def _wide_tasks(q: int):
    """The MMA warps' tasks that cover G's upper triangle at width q > 80:
    for each pair of row bands (2a, 2a + 1) of 16 Y columns, the column
    bands 2a, 2a + 1, ... in runs of TASK_COLS.  A task is (row bands,
    column bands, mask), -1 for a band past Y; bit (i TASK_COLS + j) 2 + h
    of the mask marks the live 16 x 8 tile (row band i, column tile
    2 cb[j] + h): in the upper triangle (rb[i] <= cb[j]) and not wholly
    past q.  Every live tile lies in exactly one task."""
    nbt, nt = -(-q // BAND), -(-q // TILE_COLS)
    tasks = []
    for a in range(-(-nbt // 2)):
        rows = [b if b < nbt else -1 for b in (2 * a, 2 * a + 1)]
        for c0 in range(2 * a, nbt, TASK_COLS):
            cols = [c if c < nbt else -1 for c in range(c0, c0 + TASK_COLS)]
            mask = 0
            for i, rb in enumerate(rows):
                for j, cb in enumerate(cols):
                    for h in range(2):
                        if 0 <= rb <= cb and 2 * cb + h < nt:
                            mask |= 1 << ((i * TASK_COLS + j) * 2 + h)
            tasks.append((rows, cols, mask))
    return tasks


def _least(loads, counts, cap):
    """Index of the least-loaded bin with room (ties: the lowest)."""
    return min((b for b in range(len(loads)) if counts[b] < cap),
               key=lambda b: (loads[b], b))


def _stage_bytes(rows: int, k: int, p1: int, es: int) -> int:
    """One raw stage: a chunk's T, A and w spans, each 16-byte aligned."""
    return _pad(_pad(rows * k * es, 16) + _pad(rows * p1 * 8, 16) + rows * 8,
                128)


def wide_y_stride(nbg: int) -> int:
    """A Y tile's row stride in f32 words for nbg bands: 8 mod 32, so a
    fragment load (4 rows t4 x 8 consecutive columns g) hits 32 banks."""
    return _pad(BAND * nbg, 32) + 8


def wide_smem(rows: int, ytiles: int, k: int, p1: int, es: int,
              nbg: int) -> int:
    """Pass 1's shared memory: the ring's raw stages, the f32 Y tiles, the
    converters' column map and the ring's mbarriers (fused_gram_wide.cu)."""
    return (WIDE_STAGES * _stage_bytes(rows, k, p1, es)
            + ytiles * rows * wide_y_stride(nbg) * 4 + BAND * NBG_MAX * 4
            + 2 * WIDE_STAGES * 8)


@functools.lru_cache(maxsize=64)
def wide_geometry(q: int):
    """The wide path's schedule at width q, a pure function of q.

    The tasks (:func:`_wide_tasks`) go to ngroups = ceil(tasks / 8) tile
    groups of 8 MMA warps, balanced by live 16 x 8 tiles (MMAs a 16-row
    step): longest first onto the 4 ngroups warp schedulers (two warps
    each, warps p and p + 4 of a block share scheduler p), then the
    schedulers, most loaded first, onto the groups.  A group's Y tile
    holds its bands alone.  The chunk height and the Y tiles in flight are
    the first of (32, 2), (16, 2), (16, 1) that fit SMEM_MAX with T in f64
    (so T in f32 takes the same geometry and bits).

    Returns a dict: rows, ytiles, ngroups, nbg (most bands of a group)
    and table (np.int32 (ngroups, GROUP_INTS): band count, bands padded
    with -1, then per MMA warp its row bands, column bands, their slots in
    the group's bands, and its mask)."""
    tasks = _wide_tasks(q)
    tiles = [bin(m).count("1") for _, _, m in tasks]
    ngroups = -(-len(tasks) // WIDE_MMA_WARPS)
    nsched = 4 * ngroups
    per = WIDE_MMA_WARPS // 4
    sload, scount = [0] * nsched, [0] * nsched
    stasks = [[] for _ in range(nsched)]
    for t in sorted(range(len(tasks)), key=lambda t: (-tiles[t], t)):
        s = _least(sload, scount, per)
        sload[s] += tiles[t]
        scount[s] += 1
        stasks[s].append(t)
    gload, gcount = [0] * ngroups, [0] * ngroups
    gsched = [[] for _ in range(ngroups)]
    for s in sorted(range(nsched), key=lambda s: (-sload[s], s)):
        g = _least(gload, gcount, 4)
        gload[g] += sload[s]
        gcount[g] += 1
        gsched[g].append(s)
    table = np.full((ngroups, GROUP_INTS), -1, dtype=np.int32)
    nbg = 0
    for g in range(ngroups):
        warps = [None] * WIDE_MMA_WARPS
        for p, s in enumerate(gsched[g]):
            for r, t in enumerate(stasks[s]):
                warps[p + 4 * r] = tasks[t]
        bands = sorted({b for w in warps if w for b in w[0] + w[1] if b >= 0})
        nbg = max(nbg, len(bands))
        table[g, 0] = len(bands)
        table[g, 1:1 + len(bands)] = bands
        for v, w in enumerate(warps):
            base = 1 + NBG_MAX + v * TASK_INTS
            if w is None:
                table[g, base + TASK_INTS - 1] = 0
                continue
            rows, cols, mask = w
            slots = [bands.index(b) if b >= 0 else -1 for b in rows + cols]
            table[g, base:base + TASK_INTS] = [*rows, *cols, *slots, mask]
    for rows, ytiles in ((WIDE_CHUNK_ROWS[0], 2), (WIDE_CHUNK_ROWS[1], 2),
                         (WIDE_CHUNK_ROWS[1], 1)):
        # T in f64 (k = q, p1 = 0 gives its 8 q + 8 bytes a row) takes the
        # most shared memory
        if wide_smem(rows, ytiles, q, 0, 8, nbg) <= SMEM_MAX:
            break
    table.setflags(write=False)
    return dict(rows=rows, ytiles=ytiles, ngroups=ngroups, nbg=nbg,
                table=table)


def fused_block_table(n: int, k: int, p1: int, npsr: int = 1):
    """Launch geometry for T (n, k), A (n, p1), or None when the
    reference's table refuses the shape (pad128(k) + pad128(p1) > 640).
    A pure function of the shapes.  Returns (nb, q_pad, threads): for
    q = k + p1 <= Q_MAX the narrow path's (pass-1 blocks, Y's width in
    16-column bands, 512); wider, the wide path's (row runs, Y's width in
    16-column bands, 384), whose pass 1 runs ngroups blocks a row run
    (:func:`wide_geometry`), at most NB_MAX in all.  With ``npsr``
    pulsars in one launch, ``nb`` is each pulsar's share: the single
    launch's count divided by npsr, rounded up (at least one)."""
    if not (1 <= n < 2**31 and k >= 1 and p1 >= 1 and 1 <= npsr <= 65535):
        return None
    if _pad(k, REF_LANES) + _pad(p1, REF_LANES) > REF_Q_MAX:
        return None
    q = k + p1
    if q <= Q_MAX:
        return (min(-(-n // ROWS), -(-NB_MAX // npsr)), _pad(q, TILE_ROWS),
                THREADS)
    geo = wide_geometry(q)
    return (min(-(-n // geo["rows"]), -(-(NB_MAX // geo["ngroups"]) // npsr)),
            _pad(q, BAND), WIDE_THREADS)


def fused_gram_joint_plain(T32, A, w, precision: str = "highest"):
    """The kernel's function in plain torch (the CPU route, and the
    yardstick the kernel is held to on the card); a leading pulsar axis
    (T (P, n, k), A (P, n, p1), w (P, n)) gives each pulsar's Grams."""
    check_precision("fused_gram_joint", precision)
    *lead, n, k = T32.shape
    s32 = torch.sqrt(w).to(F32)
    Y = torch.cat([T32.to(F32), A.to(F32)], dim=-1) * s32[..., None]
    q = Y.shape[-1]
    n_pad = -(-n // SUB) * SUB
    Yp = torch.nn.functional.pad(Y.to(F64), (0, 0, 0, n_pad - n))
    Yb = Yp.reshape(*lead, n_pad // SUB, SUB, q)
    G = torch.sum(Yb.transpose(-1, -2) @ Yb, dim=-3)
    return G[..., :k, :k], G[..., :k, k:], G[..., k:, k:]


def _aligned_rows(T, A, w):
    """Pad a pulsar batch's rows to a multiple of 4 with zero rows (zero
    weight: they add exact zeros), so that every pulsar's T, A and w
    start 16-byte aligned for the bulk copies."""
    n = T.shape[1]
    pad = -n % 4
    if pad == 0:
        return T, A, w
    return (torch.nn.functional.pad(T, (0, 0, 0, pad)),
            torch.nn.functional.pad(A, (0, 0, 0, pad)),
            torch.nn.functional.pad(w, (0, pad)))


def fused_gram_joint_cuda(T, A, w, precision: str = "highest"):
    """Launch the CUDA kernel on tensors on one card: T (n, k), A (n, p1),
    w (n,), or a pulsar batch T (P, n, k), A (P, n, p1), w (P, n) in ONE
    launch.  T may be f32 or f64 (the kernel rounds it to f32 as it
    converts); A and w are f64.  Raises, naming the reason, on what the
    kernel cannot take: the checks of types, shapes, contiguity and
    16-byte alignment come before the check of the device."""
    check_precision("fused_gram_joint", precision)
    if T.dtype not in (F32, F64) or A.dtype != F64 or w.dtype != F64:
        raise TypeError(
            "fused_gram_joint_cuda: T f32/f64, A f64, w f64 expected, got "
            f"{T.dtype}, {A.dtype}, {w.dtype}"
        )
    batched = T.dim() == 3
    if (T.dim() not in (2, 3) or A.dim() != T.dim()
            or w.dim() != T.dim() - 1):
        raise ValueError("fused_gram_joint_cuda: T (n,k), A (n,p1), w (n,); "
                         "with a pulsar axis T (P,n,k), A (P,n,p1), w (P,n)")
    if batched and not (A.shape[0] == w.shape[0] == T.shape[0]):
        raise ValueError(
            f"fused_gram_joint_cuda: pulsar counts differ {T.shape[0]}, "
            f"{A.shape[0]}, {w.shape[0]}")
    n, k = T.shape[-2:]
    p1 = A.shape[-1]
    if A.shape[-2] != n or w.shape[-1] != n:
        raise ValueError(
            f"fused_gram_joint_cuda: row counts differ {n}, {A.shape[-2]}, "
            f"{w.shape[-1]}"
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
    npsr = T.shape[0] if batched else 1
    if batched:
        T, A, w = _aligned_rows(T, A, w)
        n = T.shape[1]
    tab = fused_block_table(n, k, p1, npsr)
    if tab is None:
        raise ValueError(
            f"fused_gram_joint_cuda: (n={n}, k={k}, p1={p1}) is outside "
            "fused_block_table; route through ops/ffgram.py::gram32_joint"
        )
    dev = T.device
    if dev.type != "cuda" or A.device != dev or w.device != dev:
        raise ValueError("fused_gram_joint_cuda: T, A, w must be on one card")
    nb, q_pad, threads = tab
    q = k + p1
    wide = q > Q_MAX
    partial = torch.empty(
        npsr * nb * fused_tile_count(q) * TILE_ROWS * TILE_COLS, dtype=F64,
        device=dev)
    lead = (npsr,) if batched else ()
    gtt = torch.empty((*lead, k, k), dtype=F64, device=dev)
    gta = torch.empty((*lead, k, p1), dtype=F64, device=dev)
    gaa = torch.empty((*lead, p1, p1), dtype=F64, device=dev)
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if wide:
            geo = wide_geometry(q)
            table = _wide_table(q, dev)
            err = c_entry("fused_gram_wide",
                          [p, i, p, p, i, i, i, i, i, i, i, i, i, i, p, p,
                           p, p, p, p])(
                T.data_ptr(), int(T.dtype == F64), A.data_ptr(),
                w.data_ptr(), n, k, p1, geo["rows"], geo["ytiles"],
                geo["ngroups"], geo["nbg"], nb, threads, npsr,
                table.data_ptr(), partial.data_ptr(), gtt.data_ptr(),
                gta.data_ptr(), gaa.data_ptr(), stream)
        else:
            err = c_entry("fused_gram_joint",
                          [p, i, p, p, i, i, i, i, i, i, i, p, p, p, p, p])(
                T.data_ptr(), int(T.dtype == F64), A.data_ptr(),
                w.data_ptr(), n, k, p1, q_pad, nb, threads, npsr,
                partial.data_ptr(), gtt.data_ptr(), gta.data_ptr(),
                gaa.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_gram_joint kernel launch failed: "
                           f"cudaError {err}")
    fused_gram_joint_cuda.launches += 1
    fused_gram_joint_cuda.wide_launches += wide
    fused_gram_joint_cuda.batched_launches += batched
    fused_gram_joint_cuda.last_shape = (npsr, n, k, p1)
    return gtt, gta, gaa


count_launches(fused_gram_joint_cuda, "launches", "wide_launches",
               "batched_launches")
#: (pulsars, rows, k, p1) of the last launch
fused_gram_joint_cuda.last_shape = None


@functools.lru_cache(maxsize=16)
def _wide_table(q: int, device):
    """wide_geometry(q)'s table on the card, copied there once."""
    return torch.tensor(wide_geometry(q)["table"].tolist(), dtype=torch.int32,
                        device=device)


def _aligned(x):
    """x contiguous and starting 16-byte aligned (a copy if it is not)."""
    x = x.contiguous()
    return x if x.data_ptr() % ALIGN == 0 else x.clone()


def _joint_gram_direct(T32, A, w, precision):
    if T32.device.type == "cpu":
        return fused_gram_joint_plain(T32, A, w, precision)
    if T32.device.type == "cuda":
        return fused_gram_joint_cuda(_aligned(T32), _aligned(A),
                                     _aligned(w), precision)
    raise ValueError(f"fused_gram_joint: unsupported device {T32.device}")


class _JointGram(torch.autograd.Function):
    """The joint Gram as one operation that ``torch.func.vmap`` batches
    by a rule of its own: the pulsar axis goes to the kernel's batch axis,
    so a vmapped step launches the kernel once for all pulsars."""

    @staticmethod
    def forward(T32, A, w, precision):
        return _joint_gram_direct(T32, A, w, precision)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, T32, A, w, precision):
        B = info.batch_size

        def flat(x, d, core):
            # the vmapped axis first (a shared input expanded to it), then
            # every leading axis folded into one pulsar axis
            x = (x.unsqueeze(0).expand(B, *x.shape) if d is None
                 else x.movedim(d, 0))
            return x.reshape(-1, *x.shape[x.dim() - core:])

        outer = (T32.shape if in_dims[0] is None
                 else T32.movedim(in_dims[0], 0).shape[1:])[:-2]
        outs = _JointGram.apply(flat(T32, in_dims[0], 2),
                                flat(A, in_dims[1], 2),
                                flat(w, in_dims[2], 1), precision)
        return (tuple(o.reshape(B, *outer, *o.shape[-2:]) for o in outs),
                (0, 0, 0))


def fused_gram_joint(T32, A, w, precision: str = "highest"):
    """Joint Gram of [T | A] under diag(w): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors; inside ``torch.func.vmap``
    one batched call for the whole batch."""
    return _JointGram.apply(T32, A, w, precision)
