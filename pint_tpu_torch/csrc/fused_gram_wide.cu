// fused_gram_wide: fused_gram_joint's path for wide Y (q = k + p1 > 80) on
// Hopper (sm_90a).
//
// Replaces, with fused_gram_joint.cu, the TPU kernel
// pint_tpu/ops/pallas_fit.py:159 fused_gram_joint (_joint_gram_kernel
// :123, pallas_call :216), whose block table admits every shape with
// pad128(k) + pad128(p1) <= 640.  fused_gram_joint.cu keeps a block's
// whole Y tile in f64 and its 30 output tiles in 8 warps, which holds
// q <= 80 columns.  This kernel computes the same function with the same
// contract:
//
//   G = Y^T Y,  Y = [f32(T) | f32(A)] * f32(sqrt(w)),  G_TT, G_TA, G_AA f64,
//
// Y's values exactly the reference's f32 values (sqrt(w) in f64 rounded
// once to f32, each T and A value rounded to f32 and multiplied by it by
// __fmul_rn), their products exact in f64 and summed in f64 on the f64
// tensor cores (mma.sync m16n8k16, mma_f64.cuh), fixed order, no
// atomics, bitwise reproducible.
//
// Bound on an H100 SXM at the binary MSP's shape (n = 1e5, k = 60,
// p1 = 169, T in f64): 5.27e9 f64 flop over the upper triangle, 0.079 ms
// at the 67 TFLOP/s f64 tensor-core peak, against 184 MB of bytes, 0.055
// ms at 3.35 TB/s.  It is bound by operations, so the design keeps the f64
// tensor cores fed from registers, with the copies and the conversions in
// warps of their own (fused_gram_joint.cu's pipeline):
//   pass 1: ngroups x nbr <= 132 persistent blocks of 12 warps, one a SM.
//     Block (row run rb, tile group g) sums one tile group's 16 x 8 output
//     tiles over a contiguous run of chunks of ROWS rows (32, or 16 where
//     a stage of 32 rows does not fit shared memory).  ops/fused_gram.py::
//     wide_geometry builds the schedule table, a pure function of q:
//     - An MMA warp's task is 2 row bands by 3 column bands of 16 Y
//       columns: per 16-row step it loads 5 band fragments and runs up to
//       12 MMAs, the B fragments of column tiles 2 C and 2 C + 1 being the
//       halves of band C's fragment (Y^T Y is symmetric).  Tiles below
//       the diagonal or wholly past q are masked out of the task.
//     - Tile groups are 8 tasks, balanced by live tiles (the MMAs of a
//       step) over the 4 warp schedulers of a block; at q = 229: 3 groups
//       of 74-76 tiles, 22 at most on a scheduler where 18.75 is the mean.
//     - Copies: lane 0 of warp 8 copies each chunk's whole-row T, A and w
//       spans (each one contiguous, 16-byte aligned run of bytes: a chunk
//       starts at an even row) into a ring of two shared stages with one
//       cp.async.bulk each, completing on the stage's mbarrier
//       (bulk_copy.cuh); a ragged last span's last < 16 bytes are stored
//       by plain loads.
//     - Conversion: warps 8-11 convert only the group's own bands, each
//       element once (one f32 rounding, one f32 product), into an f32 Y
//       tile: those are Y's values exactly, and half the bytes of f64.
//       Rows past n and columns past q are zero.  Y tiles (two, or one
//       where two do not fit) are handed to the MMA warps and back by
//       named barriers.
//     - MMA: warps 0-7 widen their fragments to f64 as they load them
//       (a fragment load is one shared-memory wavefront: the Y row stride
//       is 8 mod 32 words) and keep their sums in registers.
//   pass 2: a block of 16 warps takes 32 consecutive partial elements, one
//     per lane, so a warp's loads are 256 contiguous bytes; warp w sums
//     row runs w, w + 16, ... and the block adds the 16 sums in order.
// Summation order: each block sums its rows 16 at a time in row order
// (the MMA's order inside a step); pass 2 as above.  The bits depend on
// (n, k, p1) alone through ROWS and nbr, which ops/fused_gram.py::
// fused_block_table derives from the shapes; which warp owns a tile does
// not change its bits.
//
// A pulsar axis, as in fused_gram_joint.cu: blockIdx.y is the pulsar of P
// matrices T (P, n, k), A (P, n, p1), w (P, n), one launch for all (the
// reference's pallas_call under jax.vmap).  Each pulsar's rows go to nbr =
// min(ceil(n / ROWS), ceil(floor(132 / ngroups) / P)) row runs, its
// partials to a slab of its own, reduced by pass 2 alone in the order
// above; for P = 1 this is the single launch, bit for bit.
//
// On an H100 (700 W; chip_smoke.py and profiling/torch_fused_gram_split.py,
// PERF.md) pass 1 takes ~0.21 ms at the MSP's shape, against ~0.32 for
// the panel-pair kernel this replaces and ~0.25 for one f64 GEMM of the
// same Y.  Alone, its converter warps take ~0.095 ms and its MMA warps
// ~0.13: the two add up more than they overlap, as if a scheduler's f64
// MMAs and its converter's instructions took turns.  The loops carry no
// branch around a load (the converters read a column map, the MMA warps
// a clamped slot), so each issues all its loads before their uses; with
// a branch per unit the converters alone took ~0.7 ms.  f64 Y tiles
// (one, 32 rows; or two, 16 rows) and 16-row chunks were slower in
// same-call A/B builds.  At q = 640 (19 tile groups, each copying and
// converting whole rows) it takes ~2.6 ms, the panel-pair kernel ~1.6.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "mma_f64.cuh"

#define MMA_WARPS 8           // MMA warps a block: warps 0-7
#define CONV_WARPS 4          // converter warps a block: warps 8-11
#define WTHREADS ((MMA_WARPS + CONV_WARPS) * 32)
#define STAGES 2              // raw chunk stages in the copy ring
#define YT_MAX 2              // most f32 Y tiles in flight
#define TASK_ROWS 2           // an MMA warp's task: row bands ...
#define TASK_COLS 3           // ... by column bands
#define TASK_INTS (2 * (TASK_ROWS + TASK_COLS) + 1)
#define BAND 16               // Y columns of a band
#define NBG_MAX 40            // most bands of a tile group (q = 640)
#define UNITS (NBG_MAX * BAND / 32)  // most 32-column units of a Y row
#define GROUP_INTS (1 + NBG_MAX + MMA_WARPS * TASK_INTS)
#define NB_MAX 132            // pass-1 blocks: one per SM of an H100
#define Q_MIN 81              // the narrow kernel takes q <= 80
#define Q_MAX 640             // the reference's widest
#define SMEM_MAX 232448       // shared memory a block may use
#define TROWS 16              // output tiles are 16 x 8 (the MMA's m and n)
#define TCOLS 8
#define TELEMS (TROWS * TCOLS)
#define P2_WARPS 16           // warps per pass-2 block

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// output tiles: bands I < ceil(q / 16) of 16 Y columns, column tiles
// 2 I <= J < ceil(q / 8) of 8, numbered row by row
__host__ __device__ inline int tile_count(int q) {
  const int nt = (q + TCOLS - 1) / TCOLS, nbt = (q + TROWS - 1) / TROWS;
  return nbt * nt - nbt * (nbt - 1);
}

__host__ __device__ inline int tile_index(int I, int J, int q) {
  const int nt = (q + TCOLS - 1) / TCOLS;
  return I * nt - I * (I - 1) + (J - 2 * I);
}

__host__ __device__ inline void tile_of(int idx, int q, int& I, int& J) {
  int row = (q + TCOLS - 1) / TCOLS;
  I = 0;
  while (row > 0 && idx >= row) {
    idx -= row;
    ++I;
    row -= 2;
  }
  J = 2 * I + idx;
}

// the shared-memory layout (ops/fused_gram.py's wide_smem): raw stages,
// f32 Y tiles of row stride y_stride(nbg), the column map, the mbarriers
__host__ __device__ inline int stage_bytes(int rows, int k, int p1, int es) {
  return round_up(round_up(rows * k * es, 16) + round_up(rows * p1 * 8, 16) +
                      rows * 8,
                  128);
}
__host__ __device__ inline int y_stride(int nbg) {
  return round_up(BAND * nbg, 32) + 8;
}
inline size_t wide_smem(int rows, int ytiles, int k, int p1, int es,
                        int nbg) {
  return (size_t)STAGES * stage_bytes(rows, k, p1, es) +
         (size_t)ytiles * rows * y_stride(nbg) * 4 + 32 * UNITS * 4 +
         2 * STAGES * sizeof(uint64_t);
}

// The Y-tile handoff between converter and MMA warps: named barriers
// 1 + b ("tile b is whole") and 1 + YT_MAX + b ("tile b is free"), each
// counting both kinds of warps: one kind arrives, the other waits.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(WTHREADS) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(WTHREADS) : "memory");
}

// One pass-1 block: its copy ring, its Y tiles and column map, and this
// MMA warp's task with its sums.
template <typename TT, int ROWS>
struct WideBlock {
  unsigned char* ring;
  float* ys;     // ytiles Y tiles, ROWS x S f32 each
  int* cmap;     // Y column slot -> its column's code (column_code)
  uint64_t* full;
  uint64_t* empty;
  const TT* T;
  const double* A;
  const double* w;
  long n, c0;
  int k, p1, q, nbg, S, tb, ab, stage, ytiles, nits, rb;
  int warp, lane, g, t4;
  int rband[TASK_ROWS], cband[TASK_COLS];  // an MMA warp's bands (or -1)
  int rslot[TASK_ROWS], cslot[TASK_COLS];  // their slots in the Y tile
  unsigned mask;                           // its live tiles
  double acc[TASK_ROWS][TASK_COLS][2][4];

  // Sets up the block from its group's row of the schedule table; thread
  // 0 initializes the barriers, and the caller syncs the block before any
  // other use.
  __device__ __forceinline__ WideBlock(unsigned char* smem, const TT* T_,
                                       const double* A_, const double* w_,
                                       long n_, int k_, int p1_, int ytiles_,
                                       int ngroups, int nbg_max, int nchunks,
                                       const int* __restrict__ table)
      : T(T_), A(A_), w(w_), n(n_), k(k_), p1(p1_), q(k_ + p1_),
        tb(round_up(ROWS * k_ * (int)sizeof(TT), 16)),
        ab(round_up(ROWS * p1_ * 8, 16)),
        stage(stage_bytes(ROWS, k_, p1_, (int)sizeof(TT))), ytiles(ytiles_),
        warp(threadIdx.x >> 5), lane(threadIdx.x & 31),
        g((threadIdx.x & 31) >> 2), t4(threadIdx.x & 3) {
    const int grp = blockIdx.x % ngroups, nbr = gridDim.x / ngroups;
    rb = blockIdx.x / ngroups;
    c0 = (long)nchunks * rb / nbr;
    nits = (int)((long)nchunks * (rb + 1) / nbr - c0);
    const int* row = table + grp * GROUP_INTS;
    nbg = row[0];
    if (nbg < 1 || nbg > nbg_max) __trap();  // a table not for this launch
    S = y_stride(nbg);
    ring = smem;
    ys = reinterpret_cast<float*>(smem + STAGES * stage);
    cmap = reinterpret_cast<int*>(ys + ytiles * ROWS * y_stride(nbg_max));
    full = reinterpret_cast<uint64_t*>(cmap + 32 * UNITS);
    empty = full + STAGES;
    for (int sl = threadIdx.x; sl < 32 * UNITS; sl += WTHREADS)
      cmap[sl] = column_code(
          sl < BAND * nbg ? BAND * row[1 + sl / BAND] + sl % BAND : q);
    const int* task = row + 1 + NBG_MAX + (warp < MMA_WARPS ? warp : 0) *
                                              TASK_INTS;
    // a band past Y (-1) has no live tile: its fragment is loaded from
    // slot 0 and masked out of every MMA, so no load waits on a branch
#pragma unroll
    for (int i = 0; i < TASK_ROWS; ++i) {
      rband[i] = task[i];
      rslot[i] = max(task[TASK_ROWS + TASK_COLS + i], 0);
    }
#pragma unroll
    for (int j = 0; j < TASK_COLS; ++j) {
      cband[j] = task[TASK_ROWS + j];
      cslot[j] = max(task[2 * TASK_ROWS + TASK_COLS + j], 0);
    }
    mask = warp < MMA_WARPS ? (unsigned)task[TASK_INTS - 1] : 0u;
#pragma unroll
    for (int i = 0; i < TASK_ROWS; ++i)
#pragma unroll
      for (int j = 0; j < TASK_COLS; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          acc[i][j][h][0] = acc[i][j][h][1] = acc[i][j][h][2] =
              acc[i][j][h][3] = 0.0;
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty + s, CONV_WARPS * 32);
      }
      mbar_fence_init();
    }
  }

  __device__ __forceinline__ int rows_of(int it) const {
    const long r0 = (c0 + it) * ROWS;
    return n - r0 < ROWS ? (int)(n - r0) : ROWS;
  }

  // The producer lane: chunk `it` into its stage once the stage is free.
  __device__ __forceinline__ void produce(int it) {
    const int s = it % STAGES;
    if (it >= STAGES) mbar_wait(empty + s, (uint32_t)((it / STAGES - 1) & 1));
    const long r0 = (c0 + it) * ROWS;
    const int rows = rows_of(it);
    unsigned char* st = ring + s * stage;
    const TT* Tc = T + r0 * k;
    const double* Ac = A + r0 * p1;
    const double* wc = w + r0;
    const int tbytes = rows * k * (int)sizeof(TT), abytes = rows * p1 * 8,
              wbytes = rows * 8;
    const uint32_t tx = bulk_tail(st, Tc, tbytes) +
                        bulk_tail(st + tb, Ac, abytes) +
                        bulk_tail(st + tb + ab, wc, wbytes);
    mbar_arrive_tx(full + s, tx);
    if (tbytes >= 16) bulk_copy(st, Tc, tbytes & ~15, full + s);
    if (abytes >= 16) bulk_copy(st + tb, Ac, abytes & ~15, full + s);
    if (wbytes >= 16) bulk_copy(st + tb + ab, wc, wbytes & ~15, full + s);
  }

  // converter warps: the raw stage of chunk `it` has landed / is free
  __device__ __forceinline__ void wait_full(int it) {
    mbar_wait(full + it % STAGES, (uint32_t)((it / STAGES) & 1));
  }
  __device__ __forceinline__ void release(int it) {
    mbar_arrive(empty + it % STAGES);
  }

  // Y tile it % ytiles: converters wait until the MMA warps are done with
  // chunk it - ytiles there, and mark it whole; the MMA warps wait for
  // it, and mark it free (but for the last ytiles chunks: nobody waits)
  __device__ __forceinline__ void y_wait_free(int it) const {
    if (it >= ytiles) named_sync(1 + YT_MAX + it % ytiles);
  }
  __device__ __forceinline__ void y_mark_whole(int it) const {
    named_arrive(1 + it % ytiles);
  }
  __device__ __forceinline__ void y_wait_whole(int it) const {
    named_sync(1 + it % ytiles);
  }
  __device__ __forceinline__ void y_mark_free(int it) const {
    if (it + ytiles < nits) named_arrive(1 + YT_MAX + it % ytiles);
  }

  // Column c of [T | A] (q: past it) as the converters read it: its byte
  // offset in a raw row of T (c < k) or of A, << 2; bit 1: T's; bit 0:
  // inside q (else Y's value is zero, read from a valid address)
  __device__ __forceinline__ int column_code(int c) const {
    return c < k ? (c * (int)sizeof(TT)) << 2 | 3
                 : (tb + (c - k) * 8) << 2 | (c < q ? 1 : 0);
  }

  // Converter warp v (0..3): chunk `it`'s raw stage into Y tile
  // it % ytiles, rows v, v + 4, ..., two 32-slot units of a row at a
  // time, a lane a slot: all loads of the two units' rows issued before
  // their products and stores, with no branch between them.
  __device__ __forceinline__ void convert(int it) {
    constexpr int RW = ROWS / CONV_WARPS;
    const int v = warp - MMA_WARPS;
    const unsigned char* st = ring + (it % STAGES) * stage;
    const double* wr = reinterpret_cast<const double*>(st + tb + ab);
    float* y = ys + (it % ytiles) * ROWS * S + v * S + lane;
    const int rows = rows_of(it), nu = (BAND * nbg + 31) / 32;
    // lane l < RW: f32(sqrt(w)) of row v + 4 l, then every lane all RW
    const int lr = v + CONV_WARPS * (lane < RW ? lane : 0);
    const float sv = lr < rows ? (float)sqrt(wr[lr]) : 0.0f;
    float sw[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) sw[i] = __shfl_sync(0xffffffffu, sv, i);
    const unsigned char* rt = st + v * k * (int)sizeof(TT);
    const unsigned char* ra = st + v * p1 * 8;
    const int dt = CONV_WARPS * k * (int)sizeof(TT), da = CONV_WARPS * p1 * 8;
#pragma unroll 1
    for (int u = 0; u < nu; u += 2) {
      int code[2];
      float x[2][RW];
#pragma unroll
      for (int e = 0; e < 2; ++e) code[e] = cmap[lane + 32 * (u + e)];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool t = code[e] & 2;
        const int off = code[e] >> 2;
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          if constexpr (sizeof(TT) == 8) {
            x[e][i] = (float)*reinterpret_cast<const double*>(
                (t ? rt + i * dt : ra + i * da) + off);
          } else {  // a T lane reads f32, an A lane f64: two loads
            const float xt =
                *reinterpret_cast<const float*>(rt + i * dt + (t ? off : 0));
            const double xa = *reinterpret_cast<const double*>(
                ra + i * da + (t ? tb : off));
            x[e][i] = t ? xt : (float)xa;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (u + e < nu) {  // warp-uniform: the row holds 32 nu slots
#pragma unroll
          for (int i = 0; i < RW; ++i)
            y[i * CONV_WARPS * S + 32 * (u + e)] =
                (code[e] & 1) && v + CONV_WARPS * i < rows
                    ? __fmul_rn(x[e][i], sw[i])
                    : 0.0f;
        }
      }
    }
  }

  // slot `b`'s fragment of the 16-row step at yr, widened to f64:
  // a[i] = Y[t4 + 4 (i / 2)][16 b + g + 8 (i % 2)]
  __device__ __forceinline__ void fragment(double (&a)[8], const float* yr,
                                           int b) const {
    const float* p = yr + BAND * b;
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = (double)p[4 * (i / 2) * S + 8 * (i % 2)];
  }

  // MMA warp: its task over Y tile it % ytiles, 16 rows an MMA; a step
  // loads its row bands' fragments, then each column band's in turn with
  // its up to four MMAs, the live ones (uniform predicates, no branches).
  __device__ __forceinline__ void contract(int it) {
    const float* y = ys + (it % ytiles) * ROWS * S;
#pragma unroll 1
    for (int r = 0; r < ROWS; r += 16) {
      const float* yr = y + (r + t4) * S + g;
      double fa[TASK_ROWS][8];
#pragma unroll
      for (int i = 0; i < TASK_ROWS; ++i) fragment(fa[i], yr, rslot[i]);
#pragma unroll
      for (int j = 0; j < TASK_COLS; ++j) {
        double fb[8];
        fragment(fb, yr, cslot[j]);
#pragma unroll
        for (int i = 0; i < TASK_ROWS; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (mask >> ((i * TASK_COLS + j) * 2 + h) & 1u) {
              const double bf[4] = {fb[h], fb[2 + h], fb[4 + h], fb[6 + h]};
              mma_f64_k16(acc[i][j][h], fa[i], bf);
            }
      }
    }
  }

  // D[g + 8 e][2 t4 + f] of each live tile -> partial[rb][tile][row * 8 +
  // column]: a warp writes a tile's 128 doubles contiguously
  __device__ __forceinline__ void store(double* partial) const {
    const int ntiles = tile_count(q);
#pragma unroll
    for (int i = 0; i < TASK_ROWS; ++i)
#pragma unroll
      for (int j = 0; j < TASK_COLS; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (mask >> ((i * TASK_COLS + j) * 2 + h) & 1u) {
            const int t = tile_index(rband[i], 2 * cband[j] + h, q);
            double* out = partial + ((long)rb * ntiles + t) * TELEMS +
                          g * TCOLS + 2 * t4;
            out[0] = acc[i][j][h][0];
            out[1] = acc[i][j][h][1];
            out[8 * TCOLS] = acc[i][j][h][2];
            out[8 * TCOLS + 1] = acc[i][j][h][3];
          }
  }
};

// Warps 0-7 run the MMAs, warps 8-11 convert, and lane 0 of warp 8 issues
// the copies: the first STAGES chunks up front, then chunk it + STAGES as
// soon as every converter has released chunk it's stage.
// blockIdx.y is the pulsar: its T, A and w, and its slab of partials.
template <typename TT, int ROWS>
__global__ void __launch_bounds__(WTHREADS, 1)
    wide_pass1(const TT* __restrict__ T, const double* __restrict__ A,
               const double* __restrict__ w, long n, int k, int p1,
               int ytiles, int ngroups, int nbg_max, int nchunks,
               const int* __restrict__ table, double* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long psr = blockIdx.y;
  partial += psr * (gridDim.x / ngroups) * (long)tile_count(k + p1) * TELEMS;
  WideBlock<TT, ROWS> b(smem, T + psr * n * k, A + psr * n * p1, w + psr * n,
                        n, k, p1, ytiles, ngroups, nbg_max, nchunks, table);
  __syncthreads();  // the barriers and the column map are ready
  if (b.warp >= MMA_WARPS) {
    const bool producer = b.warp == MMA_WARPS && b.lane == 0;
    if (producer)
      for (int it = 0; it < min(STAGES, b.nits); ++it) b.produce(it);
    for (int it = 0; it < b.nits; ++it) {
      b.wait_full(it);
      b.y_wait_free(it);
      b.convert(it);
      b.release(it);
      b.y_mark_whole(it);
      if (producer && it + STAGES < b.nits) b.produce(it + STAGES);
    }
  } else {
    for (int it = 0; it < b.nits; ++it) {
      b.y_wait_whole(it);
      b.contract(it);
      b.y_mark_free(it);
    }
    b.store(partial);
  }
}

// One lane per partial element (tile, e), 32 consecutive elements a
// block: warp w sums row runs w, w + 16, ... (contiguous 256-byte loads
// across the warp), then the block adds the 16 warp sums in order and
// scatters the upper-triangle element (a, c) to G_TT (both triangles),
// G_TA or G_AA (both triangles).  blockIdx.y is the pulsar.
__global__ void __launch_bounds__(P2_WARPS * 32)
    wide_pass2(const double* __restrict__ partial, int nbr, int k, int p1,
               double* __restrict__ gtt, double* __restrict__ gta,
               double* __restrict__ gaa) {
  __shared__ double red[P2_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = k + p1;
  const long npe = (long)tile_count(q) * TELEMS;
  const long psr = blockIdx.y;
  partial += psr * nbr * npe;
  gtt += psr * k * k;
  gta += psr * k * p1;
  gaa += psr * p1 * p1;
  const long pe = (long)blockIdx.x * 32 + lane;
  double s = 0.0;
  if (pe < npe) {
#pragma unroll 4
    for (int b = warp; b < nbr; b += P2_WARPS) s += partial[b * npe + pe];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || pe >= npe) return;
  double tot = red[0][lane];
#pragma unroll
  for (int v = 1; v < P2_WARPS; ++v) tot += red[v][lane];
  int I, J;
  tile_of((int)(pe / TELEMS), q, I, J);
  const int e = (int)(pe % TELEMS);
  const int a = I * TROWS + e / TCOLS, c = J * TCOLS + e % TCOLS;
  if (a > c || c >= q) return;  // the lower half of a diagonal block, or pad
  if (c < k)
    gtt[a * k + c] = gtt[c * k + a] = tot;
  else if (a < k)
    gta[a * p1 + (c - k)] = tot;
  else
    gaa[(a - k) * p1 + (c - k)] = gaa[(c - k) * p1 + (a - k)] = tot;
}

template <typename TT, int ROWS>
static cudaError_t launch_pass1(const void* T, const double* A,
                                const double* w, int n, int k, int p1,
                                int ytiles, int ngroups, int nbg_max,
                                int nbr, int npsr, const int* table,
                                double* partial, cudaStream_t stream) {
  const size_t smem = wide_smem(ROWS, ytiles, k, p1, (int)sizeof(TT), nbg_max);
  cudaError_t err = cudaFuncSetAttribute(
      wide_pass1<TT, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  wide_pass1<TT, ROWS><<<dim3(ngroups * nbr, npsr), WTHREADS, smem,
                         stream>>>(
      static_cast<const TT*>(T), A, w, n, k, p1, ytiles, ngroups, nbg_max,
      (n + ROWS - 1) / ROWS, table, partial);
  return cudaGetLastError();
}

// C entry: launches both passes on `stream` and returns cudaGetLastError().
// The caller allocates `partial` (npsr * nbr * tile_count(q) * 128 f64)
// and the outputs (npsr of each Gram block), puts ops/fused_gram.py::
// wide_geometry(q)'s table on the card, and checks shapes, types,
// contiguity and alignment against fused_block_table; the geometry is
// re-checked here.
extern "C" int fused_gram_wide_launch(const void* T, int t_is_f64,
                                      const double* A, const double* w,
                                      int n, int k, int p1, int rows,
                                      int ytiles, int ngroups, int nbg_max,
                                      int nbr, int threads, int npsr,
                                      const int* table, double* partial,
                                      double* gtt, double* gta, double* gaa,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int q = k + p1, es = t_is_f64 ? 8 : 4;
  // a pulsar's row runs: the single launch's NB_MAX / ngroups, shared out
  const int per =
      ngroups >= 1 && npsr >= 1 ? (NB_MAX / ngroups + npsr - 1) / npsr : 0;
  const bool strides = npsr == 1 || ((long)n * k * es % 16 == 0 &&
                                     (long)n * p1 * 8 % 16 == 0 &&
                                     (long)n * 8 % 16 == 0);
  const bool ok =
      threads == WTHREADS && n >= 1 && k >= 1 && p1 >= 1 && q >= Q_MIN &&
      q <= Q_MAX && (rows == 16 || rows == 32) && ytiles >= 1 &&
      ytiles <= YT_MAX && nbg_max >= 1 && nbg_max <= NBG_MAX &&
      BAND * (nbg_max - 1) < q && ngroups >= 1 && nbr >= 1 &&
      nbr <= (n + rows - 1) / rows && nbr <= per && npsr >= 1 &&
      npsr <= 65535 && strides &&
      wide_smem(rows, ytiles, k, p1, es, nbg_max) <= SMEM_MAX &&
      (uintptr_t)T % 16 == 0 && (uintptr_t)A % 16 == 0 &&
      (uintptr_t)w % 16 == 0;
  if (!ok) return (int)cudaErrorInvalidValue;  // outside the kernel's design
  cudaError_t err;
  if (rows == 32)
    err = t_is_f64 ? launch_pass1<double, 32>(T, A, w, n, k, p1, ytiles,
                                              ngroups, nbg_max, nbr, npsr,
                                              table, partial, s)
                   : launch_pass1<float, 32>(T, A, w, n, k, p1, ytiles,
                                             ngroups, nbg_max, nbr, npsr,
                                             table, partial, s);
  else
    err = t_is_f64 ? launch_pass1<double, 16>(T, A, w, n, k, p1, ytiles,
                                              ngroups, nbg_max, nbr, npsr,
                                              table, partial, s)
                   : launch_pass1<float, 16>(T, A, w, n, k, p1, ytiles,
                                             ngroups, nbg_max, nbr, npsr,
                                             table, partial, s);
  if (err != cudaSuccess) return (int)err;
  const long elems = (long)tile_count(q) * TELEMS;
  wide_pass2<<<dim3((unsigned)((elems + 31) / 32), npsr), P2_WARPS * 32, 0,
               s>>>(partial, nbr, k, p1, gtt, gta, gaa);
  return (int)cudaGetLastError();
}
