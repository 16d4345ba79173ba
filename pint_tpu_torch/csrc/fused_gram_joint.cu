// fused_gram_joint: the mixed GLS step's joint Gram on Hopper (sm_90a).
//
// Replaces the TPU kernel pint_tpu/ops/pallas_fit.py:159 fused_gram_joint
// (_joint_gram_kernel :123, pallas_call :216).  For a noise basis T (n, k)
// in f32 or f64, design-plus-residual columns A (n, p1) and weights w (n,),
// both f64, it computes the Gram of Y = [f32(T) | f32(A)] * f32(sqrt(w)):
//
//   G = Y^T Y  ->  G_TT (k, k), G_TA (k, p1), G_AA (p1, p1), all f64.
//
// Numerics.  Y holds exactly the reference's f32 values: sqrt(w) in f64
// rounded once to f32, each T and A value rounded to f32 and multiplied by
// it in f32 (__fmul_rn).  Their products are exact in f64 and are summed
// in f64 on the f64 tensor cores (mma.sync m16n8k16, mma_f64.cuh), where
// the TPU summed 128-row sub-chunks in f32 (on the bench pulsar those f32
// sums move the mixed step's covariance 1.4e-2 off the f64 step, past the
// 5e-3 gate; PERF.md).  Summation order: each block sums its contiguous
// run of rows 16 at a time in row order (the MMA's order inside a step);
// pass 2 sums the NB block partials as 16 strided runs (b = w, w + 16,
// ...), then the 16 runs in order.  No atomics: bitwise reproducible, and
// the bits depend on n alone through the block count NB = min(ceil(n /
// 64), 132).  G_TT and G_AA are read from one triangle, so exactly symmetric.
//
// A pulsar axis: one launch computes the Grams of P matrices T (P, n, k),
// A (P, n, p1), w (P, n), as the reference's pallas_call does under
// jax.vmap (its batch grid axis).  blockIdx.y is the pulsar: each pulsar's
// rows go to NB = min(ceil(n / 64), ceil(132 / P)) blocks, so the P NB
// blocks of both passes spread over the SMs in about one wave; each pulsar
// has its own slab of partials and pass 2 reduces it alone, in the order
// above.  For P = 1 this is the single launch, bit for bit.
//
// Bound on an H100 SXM at the bench shape (n = 1e5, k = 60, p1 = 7, T in
// f64): the function must read 8 n (k + p1 + 1) = 54.4 MB, 16.2 us at
// 3.35 TB/s; its products, in 16 x 8 tiles over the upper triangle (25
// tiles at q = k + p1 = 67), are 6.4e8 f64 flops, 9.6 us at the 67 TFLOP/s
// f64 tensor-core peak; the f32 roundings are 1.3e7 conversions.  It is
// bound by bytes, so the design keeps the copies running while the
// conversions and the tensor cores work, each in warps of its own:
//   pass 1: one persistent block per SM (NB <= 132) of 16 warps walks a
//     contiguous run of 64-row chunks.
//     - Copies: lane 0 of warp 8 copies each chunk's T, A and w spans
//       (each one contiguous run of bytes) into a ring of two shared stages
//       with one cp.async.bulk each, completing on the stage's mbarrier
//       (up to ~70 KB in flight per SM); a ragged last span's last < 16
//       bytes are stored by plain loads.  Chunk c + 2 is issued as soon as
//       every converter has released chunk c's stage.
//     - Conversion: warps 8-15 convert each element once (one f32
//       rounding, one f32 product, one widening) into an f64 Y tile, rows
//       past n and columns past q zero, all of a warp's loads issued
//       before its conversions; two Y tiles, handed to the MMA warps and
//       back by named barriers, so chunk c + 1 is converted while chunk c
//       is multiplied.
//     - MMA: warps 0-7 each own band pairs of Y's 16-column bands
//       (band_of) and load, per 16-row step, only their bands' A
//       fragments: Y^T Y is symmetric, so the B fragments of column tiles
//       2 I and 2 I + 1 are the halves of band I's A fragment.  Sums stay
//       in registers.  Y's row stride is 4 mod 16 doubles: a fragment load
//       is two shared-memory wavefronts.
//   pass 2: a block of 16 warps takes 32 consecutive partial elements, one
//     per lane, so a warp's loads are 256 contiguous bytes; warp w sums
//     blocks w, w + 16, ... and the block adds the 16 sums in order.
// On the card pass 1 is bound by the MMA warps, at about twice their
// tensor-core floor, and not by the copies (profiling/
// torch_fused_gram_split.py, PERF.md); ptxas gives pass 1 124 registers
// and no spills.  The copy-ring helpers are bulk_copy.cuh's, shared with
// fused_gram_wide.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "mma_f64.cuh"

#define ROWS 64               // rows per chunk
#define STAGES 2              // raw chunk stages in the copy ring
#define YTILES 2              // f64 Y tiles between converters and MMAs
#define GROUP 8               // MMA warps, and converter warps, a block
#define THREADS (2 * GROUP * 32)
#define NB_MAX 132            // pass-1 blocks: one per SM of an H100
#define Q_MAX 80              // most columns k + p1
#define TROWS 16              // output tiles are 16 x 8 (the MMA's m and n)
#define TCOLS 8
#define TELEMS (TROWS * TCOLS)
#define MAXT 6                // most output tiles one MMA warp owns
#define P2_WARPS 16           // warps per pass-2 block

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Y's padded width: whole 16-column bands
__host__ __device__ inline int y_cols(int q) { return round_up(q, TROWS); }

// Y's row stride in doubles: 4 mod 16, so a fragment load (4 rows t4 x 8
// consecutive columns g) touches each bank pair twice, and each half-warp
// (4 rows x 4 columns) each bank once
__host__ __device__ inline int y_stride(int qp) { return qp + 4; }

// output tiles: bands I < ceil(q / 16) of 16 Y columns, column tiles
// 2 I <= J < ceil(q / 8) of 8 (every band has at least one)
__host__ __device__ inline int tile_count(int q) {
  const int nt = (q + TCOLS - 1) / TCOLS, nbt = (q + TROWS - 1) / TROWS;
  return nbt * nt - nbt * (nbt - 1);
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

// bytes of one raw stage: T's span, A's, w's, each 16-byte aligned
__host__ __device__ inline int stage_bytes(int k, int p1, int es) {
  return round_up(round_up(ROWS * k * es, 16) + round_up(ROWS * p1 * 8, 16) +
                      ROWS * 8, 128);
}

inline size_t pass1_smem(int k, int p1, int es) {
  const int qp = y_cols(k + p1);
  return (size_t)STAGES * stage_bytes(k, p1, es) +
         YTILES * (size_t)ROWS * y_stride(qp) * sizeof(double) +
         2 * STAGES * sizeof(uint64_t);
}

// The MMA warps' share of the upper triangle of 16 x 16 band pairs
// (I <= I' < 5 bands of Y's columns), so that a warp loads only the A
// fragments of its bands: pair (I, I')'s tiles (I, 2 I') and (I, 2 I' + 1)
// take band I's fragment as A, and the even and odd halves of band I''s
// as B (b[i] = a[2 i + h]: Y^T Y is symmetric).  Warp w holds bands
// band_of(w, 0..2) in slots 0-2 and runs the live ones (pair_live) of its
// slot pairs (pair_a, pair_b): warps 0-5 (s0, s0) (s0, s1) (s1, s1),
// warps 6-7 (s0, s2) (s1, s2) (s2, s2).
//   w 0: bands 0, 1: (0, 0) (0, 1)    w 4: bands 0, 2: (0, 2)
//   w 1: bands 2, 3: (2, 2) (2, 3)    w 5: bands 0, 3: (0, 3)
//   w 2: bands 1, 2: (1, 1) (1, 2)    w 6: bands 0, 1, 4: (0, 4) (1, 4) (4, 4)
//   w 3: bands 1, 3: (1, 3) (3, 3)    w 7: bands 2, 3, 4: (2, 4) (3, 4)
// 15 pairs, 25 tiles at q = 67, so the schedulers (warps w and w + 4) run
// 6, 6, 7 and 6 tiles a step; a narrower Y drops the pairs past its bands.
// warp w's band in slot i: 3 bits each of one constant a slot (w 7 .. 0)
__device__ __forceinline__ int band_of(int w, int i) {
  const unsigned slot = i == 0 ? 020001120u : i == 1 ? 031323231u : 044323231u;
  return (int)(slot >> (3 * w)) & 7;
}
__host__ __device__ constexpr int pair_a(int w, int p) {
  return w >= 6 ? p : (p == 2 ? 1 : 0);
}
__host__ __device__ constexpr int pair_b(int w, int p) {
  return w >= 6 ? 2 : (p == 0 ? 0 : 1);
}
__host__ __device__ constexpr bool pair_live(int w, int p) {
  return w == 6 || (w == 3 ? p >= 1 : (w == 4 || w == 5) ? p == 1 : p < 2);
}

// The Y-tile handoff between converter and MMA warps: named barriers
// 1 + b ("tile b is whole") and 1 + YTILES + b ("tile b is free"), each
// counting both groups: one group arrives, the other waits.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(2 * GROUP * 32)
               : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(2 * GROUP * 32)
               : "memory");
}

// One pass-1 block: its copy ring, its Y tiles, and this MMA warp's
// output tiles with their sums.  fused_gram_pass1 runs its three roles;
// its halves, the copies and the conversion with the MMA, are also run
// alone to time them (profiling/fused_gram_split.cu).
template <typename TT>
struct FusedBlock {
  unsigned char* ring;
  double* ys;  // YTILES Y tiles, ROWS x S each
  uint64_t* full;
  uint64_t* empty;
  const TT* T;
  const double* A;
  const double* w;
  long n, c0;
  int k, p1, q, qp, S, tb, ab, stage, nits;
  int warp, lane, g, t4;
  int band0, band1, band2;  // an MMA warp's bands (clamped to Y's width)
  int tile[MAXT];    // its tiles' indices in the row-major list, or -1
  double acc[MAXT][4];

  // Sets up the block; thread 0 initializes the barriers, and the caller
  // syncs the block before any other use.
  __device__ __forceinline__ FusedBlock(unsigned char* smem, const TT* T_,
                                        const double* A_, const double* w_,
                                        long n_, int k_, int p1_,
                                        int nchunks)
      : T(T_), A(A_), w(w_), n(n_), k(k_), p1(p1_), q(k_ + p1_),
        qp(y_cols(k_ + p1_)), S(y_stride(y_cols(k_ + p1_))),
        tb(round_up(ROWS * k_ * (int)sizeof(TT), 16)),
        ab(round_up(ROWS * p1_ * 8, 16)),
        stage(stage_bytes(k_, p1_, (int)sizeof(TT))),
        warp(threadIdx.x >> 5), lane(threadIdx.x & 31),
        g((threadIdx.x & 31) >> 2), t4(threadIdx.x & 3) {
    ring = smem;
    ys = reinterpret_cast<double*>(smem + STAGES * stage);
    full = reinterpret_cast<uint64_t*>(ys + YTILES * ROWS * S);
    empty = full + STAGES;
    c0 = (long)nchunks * blockIdx.x / gridDim.x;
    nits = (int)((long)nchunks * (blockIdx.x + 1) / gridDim.x - c0);
    // an MMA warp's bands and tiles (band_of); a tile is live if its
    // bands and columns lie inside q
    const int nt = (q + TCOLS - 1) / TCOLS, nbt = (q + TROWS - 1) / TROWS;
    const int mw = warp < GROUP ? warp : 0;
    band0 = min(band_of(mw, 0), nbt - 1);
    band1 = min(band_of(mw, 1), nbt - 1);
    band2 = min(band_of(mw, 2), nbt - 1);
#pragma unroll
    for (int t = 0; t < MAXT; ++t) {
      const int I = band_of(mw, pair_a(mw, t / 2));
      const int Ib = band_of(mw, pair_b(mw, t / 2)), J = 2 * Ib + t % 2;
      const bool live = warp < GROUP && pair_live(mw, t / 2) && Ib < nbt &&
                        J < nt;
      tile[t] = live ? I * nt - I * (I - 1) + (J - 2 * I) : -1;
      acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0;
    }
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty + s, GROUP * 32);
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
    // the tails' plain stores come before the arrive, which releases them
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

  // Y tile it % YTILES: converters wait until the MMA warps are done with
  // chunk it - YTILES there, and mark it whole; the MMA warps wait for it,
  // and mark it free (but for the last YTILES chunks: nobody waits)
  __device__ __forceinline__ void y_wait_free(int it) const {
    if (it >= YTILES) named_sync(1 + YTILES + it % YTILES);
  }
  __device__ __forceinline__ void y_mark_whole(int it) const {
    named_arrive(1 + it % YTILES);
  }
  __device__ __forceinline__ void y_wait_whole(int it) const {
    named_sync(1 + it % YTILES);
  }
  __device__ __forceinline__ void y_mark_free(int it) const {
    if (it + YTILES < nits) named_arrive(1 + YTILES + it % YTILES);
  }

  // Converter warp v (0..7): chunk `it`'s raw stage into Y tile
  // it % YTILES, rows v, v + 8, ..., a lane each column of a row, 4 at a time
  // with all their loads issued before their conversions.  Rows past n
  // and columns past q are zero.
  __device__ __forceinline__ void convert(int it) {
    const int v = warp - GROUP;
    const unsigned char* st = ring + (it % STAGES) * stage;
    const TT* tr = reinterpret_cast<const TT*>(st);
    const double* ar = reinterpret_cast<const double*>(st + tb);
    const double* wr = reinterpret_cast<const double*>(st + tb + ab);
    double* y = ys + (it % YTILES) * ROWS * S;
    const int rows = rows_of(it);
    constexpr int RW = ROWS / GROUP, RG = RW / 2, CU = (Q_MAX + 31) / 32;
    // lane l < RW: f32(sqrt(w)) of row v + 8 l
    const float sv = (float)sqrt(wr[v + GROUP * (lane < RW ? lane : 0)]);
#pragma unroll
    for (int i0 = 0; i0 < RW; i0 += RG) {
      // column c's value: T's (c < k) or A's (k <= c < q); past q any
      // element of the stage, zeroed below.  T in f64 takes one load
      // from a chosen address, T in f32 a load of each type.
      float x[RG][CU];
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int u = 0; u < CU; ++u) {
          const int r = v + GROUP * (i0 + i), c = lane + 32 * u;
          if constexpr (sizeof(TT) == 8)
            x[i][u] = (float)(c < k ? tr[r * k + c]
                                    : ar[r * p1 + min(c - k, p1 - 1)]);
          else
            x[i][u] = c < k ? (float)tr[r * k + min(c, k - 1)]
                            : (float)ar[r * p1 + min(max(c - k, 0), p1 - 1)];
        }
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        const int r = v + GROUP * (i0 + i);
        const float s = __shfl_sync(0xffffffffu, sv, i0 + i);
#pragma unroll
        for (int u = 0; u < CU; ++u) {
          const int c = lane + 32 * u;
          const double yv = (double)__fmul_rn(x[i][u], s);
          if (c < qp) y[r * S + c] = (r < rows && c < q) ? yv : 0.0;
        }
      }
    }
  }

  // band `bi`'s A fragment of the 16-row step at yr: a[i] = Y[t4 + 4 (i /
  // 2)][16 bi + g + 8 (i % 2)]
  __device__ __forceinline__ void fragment(double (&a)[8], const double* yr,
                                           int bi) const {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = yr[4 * (i / 2) * S + bi * TROWS + 8 * (i % 2)];
  }

  // pair slot T0 / 2's two tiles: A = fa, B = the even and odd halves of fb
  template <int T0>
  __device__ __forceinline__ void pair(const double (&fa)[8],
                                       const double (&fb)[8]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (tile[T0 + h] >= 0) {  // uniform across the warp
        const double bf[4] = {fb[h], fb[2 + h], fb[4 + h], fb[6 + h]};
        mma_f64_k16(acc[T0 + h], fa, bf);
      }
    }
  }

  // MMA warp: its tiles over Y tile it % YTILES, 16 rows an MMA; a step
  // loads its bands' A fragments (8 doubles a lane each), two at a time.
  __device__ __forceinline__ void contract(int it) {
    const double* y = ys + (it % YTILES) * ROWS * S;
#pragma unroll 1  // one step's fragments and the sums fill the registers
    for (int r = 0; r < ROWS; r += 16) {
      const double* yr = y + (r + t4) * S + g;
      double fa[8], fb[8];
      fragment(fa, yr, band0);
      fragment(fb, yr, warp >= 6 ? band2 : band1);
      if (warp >= 6) {  // slots (0, 2) (1, 2) (2, 2)
        pair<0>(fa, fb);
        fragment(fa, yr, band1);
        pair<2>(fa, fb);
        pair<4>(fb, fb);
      } else {  // slots (0, 0) (0, 1) (1, 1)
        pair<0>(fa, fa);
        pair<2>(fa, fb);
        pair<4>(fb, fb);
      }
    }
  }

  // D[g + 8 h][2 t4 + i] of each tile -> partial[block][tile][row * 8 +
  // column]: a warp writes a tile's 128 doubles contiguously
  __device__ __forceinline__ void store(double* partial) const {
    const int ntiles = tile_count(q);
#pragma unroll
    for (int t = 0; t < MAXT; ++t) {
      if (tile[t] >= 0) {
        double* out = partial +
                      ((long)blockIdx.x * ntiles + tile[t]) * TELEMS +
                      g * TCOLS + 2 * t4;
        out[0] = acc[t][0];
        out[1] = acc[t][1];
        out[8 * TCOLS] = acc[t][2];
        out[8 * TCOLS + 1] = acc[t][3];
      }
    }
  }
};

// Warps 0-7 run the MMAs, warps 8-15 convert, and lane 0 of warp 8 issues
// the copies: the first STAGES chunks up front, then chunk it + STAGES as
// soon as every converter has released chunk it's stage.
// blockIdx.y is the pulsar: its T, A and w, and its slab of partials.
template <typename TT>
__global__ void __launch_bounds__(THREADS, 1)
    fused_gram_pass1(const TT* __restrict__ T, const double* __restrict__ A,
                     const double* __restrict__ w, long n, int k, int p1,
                     int nchunks, double* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long psr = blockIdx.y;
  partial += psr * gridDim.x * (long)tile_count(k + p1) * TELEMS;
  FusedBlock<TT> b(smem, T + psr * n * k, A + psr * n * p1, w + psr * n, n,
                   k, p1, nchunks);
  __syncthreads();  // the barriers are initialized
  if (b.warp >= GROUP) {
    const bool producer = b.warp == GROUP && b.lane == 0;
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
// block: warp w sums blocks w, w + 16, ... (contiguous 256-byte loads
// across the warp), then the block adds the 16 warp sums in order and
// scatters the upper-triangle element (a, c) to G_TT (both triangles),
// G_TA or G_AA (both triangles).  blockIdx.y is the pulsar.
__global__ void __launch_bounds__(P2_WARPS * 32)
    fused_gram_pass2(const double* __restrict__ partial, int nb, int k,
                     int p1, double* __restrict__ gtt,
                     double* __restrict__ gta, double* __restrict__ gaa) {
  __shared__ double red[P2_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = k + p1;
  const int npe = tile_count(q) * TELEMS;
  const long psr = blockIdx.y;
  partial += psr * nb * (long)npe;
  gtt += psr * k * k;
  gta += psr * k * p1;
  gaa += psr * p1 * p1;
  const int pe = blockIdx.x * 32 + lane;
  double s = 0.0;
  if (pe < npe) {
#pragma unroll 4
    for (int b = warp; b < nb; b += P2_WARPS) s += partial[(long)b * npe + pe];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || pe >= npe) return;
  double tot = red[0][lane];
#pragma unroll
  for (int v = 1; v < P2_WARPS; ++v) tot += red[v][lane];
  int I, J;
  tile_of(pe / TELEMS, q, I, J);
  const int e = pe % TELEMS;
  const int a = I * TROWS + e / TCOLS, c = J * TCOLS + e % TCOLS;
  if (a > c || c >= q) return;  // the lower half of a diagonal block, or pad
  if (c < k)
    gtt[a * k + c] = gtt[c * k + a] = tot;
  else if (a < k)
    gta[a * p1 + (c - k)] = tot;
  else
    gaa[(a - k) * p1 + (c - k)] = gaa[(c - k) * p1 + (a - k)] = tot;
}

// The shapes and pointers the design takes (ops/fused_gram.py's
// fused_block_table and the wrapper's checks, re-checked here): a pulsar's
// rows go to min(ceil(n / 64), ceil(132 / npsr)) blocks, and every
// pulsar's T, A and w start 16-byte aligned.
static bool check_shape(const void* T, const void* A, const void* w, int n,
                        int k, int p1, int q_pad, int nb, int threads,
                        int npsr, int es) {
  const int q = k + p1;
  const int nchunks = (n + ROWS - 1) / ROWS;
  const int per = (NB_MAX + npsr - 1) / (npsr > 0 ? npsr : 1);
  const bool strides = npsr == 1 || ((long)n * k * es % 16 == 0 &&
                                     (long)n * p1 * 8 % 16 == 0 &&
                                     (long)n * 8 % 16 == 0);
  return threads == THREADS && n >= 1 && k >= 1 && p1 >= 1 && q <= Q_MAX &&
         q_pad == y_cols(q) && npsr >= 1 && npsr <= 65535 && strides &&
         nb == (nchunks < per ? nchunks : per) &&
         (uintptr_t)T % 16 == 0 && (uintptr_t)A % 16 == 0 &&
         (uintptr_t)w % 16 == 0;
}

template <typename TT>
static cudaError_t launch_pass1(const void* T, const double* A,
                                const double* w, int n, int k, int p1,
                                int nb, int npsr, double* partial,
                                cudaStream_t stream) {
  const size_t smem = pass1_smem(k, p1, (int)sizeof(TT));
  cudaError_t err = cudaFuncSetAttribute(
      fused_gram_pass1<TT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fused_gram_pass1<TT><<<dim3(nb, npsr), THREADS, smem, stream>>>(
      static_cast<const TT*>(T), A, w, n, k, p1, (n + ROWS - 1) / ROWS,
      partial);
  return cudaGetLastError();
}

// C entry: launches both passes on `stream` and returns cudaGetLastError().
// The caller allocates `partial` (npsr * nb * ntiles * 128 f64) and the
// outputs (npsr of each Gram block), and checks shapes, types, contiguity
// and alignment.
extern "C" int fused_gram_joint_launch(const void* T, int t_is_f64,
                                       const double* A, const double* w,
                                       int n, int k, int p1, int q_pad,
                                       int nb, int threads, int npsr,
                                       double* partial, double* gtt,
                                       double* gta, double* gaa,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!check_shape(T, A, w, n, k, p1, q_pad, nb, threads, npsr,
                   t_is_f64 ? 8 : 4))
    return (int)cudaErrorInvalidValue;  // outside the kernel's design
  cudaError_t err =
      t_is_f64
          ? launch_pass1<double>(T, A, w, n, k, p1, nb, npsr, partial, s)
          : launch_pass1<float>(T, A, w, n, k, p1, nb, npsr, partial, s);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (tile_count(k + p1) * TELEMS + 31) / 32;
  fused_gram_pass2<<<dim3(blocks, npsr), P2_WARPS * 32, 0, s>>>(
      partial, nb, k, p1, gtt, gta, gaa);
  return (int)cudaGetLastError();
}
