// fused_gram_wide: fused_gram_joint's path for wide Y (q = k + p1 > 80).
//
// Replaces, with fused_gram_joint.cu, the TPU kernel
// pint_tpu/ops/pallas_fit.py:159 fused_gram_joint (_joint_gram_kernel
// :123, pallas_call :216), whose block table admits every shape with
// pad128(k) + pad128(p1) <= 640.  fused_gram_joint.cu keeps a block's
// whole Y tile of 64 rows in shared memory, which holds q <= 80 columns;
// at the reference's widest q = 640 that tile would be 320 KB.  This
// kernel computes the same function with the same contract:
//
//   G = Y^T Y,  Y = [f32(T) | f32(A)] * f32(sqrt(w)),  G_TT, G_TA, G_AA f64,
//
// Y's values exactly the reference's f32 values (sqrt(w) in f64 rounded
// once to f32, each T and A value rounded to f32 and multiplied by it by
// __fmul_rn), their products exact in f64 and summed in f64 on the f64
// tensor cores (mma.sync m16n8k16, mma_f64.cuh), fixed order, no
// atomics, bitwise reproducible.
//
// Design (simple and right first; its speed is measured in PERF.md):
//   Y's columns are cut into panels of 128 (the last one zero-padded), and
//   G's upper triangle into the panel pairs (I, J), I <= J.
//   pass 1: block (pair, rb) of 16 warps takes one panel pair and a
//     contiguous run of 32-row chunks (row block rb of nbr), one block an
//     SM, with a ring of two tile sets in shared memory (135 KB).  In each
//     step every warp stages its share of chunk c + 1 into one set, and
//     runs its MMAs over chunk c in the other; odd warps do the MMAs
//     first and even warps the staging first, so the SM holds both kinds
//     of work at once; one __syncthreads a chunk.  Staging: the two
//     panels' 32 x 128 values of T or A by plain loads from clamped valid
//     addresses, all issued before any is used (the spans of a panel need
//     no alignment: row strides of odd widths are not 16-byte multiples),
//     rounded and weighted as above into f64 tiles (one panel on the
//     diagonal, I = J); sqrt(w) of a chunk's rows comes from a ring of
//     three slots, filled two chunks ahead.  MMA: warp v owns 16 x 8
//     output tiles (band v / 2 of panel I, column tiles 8 (v % 2) .. + 7
//     of panel J), 8 MMAs each 16-row step on one A fragment, sums in
//     registers.  Tiles wholly below the diagonal, or wholly in the
//     padding past q, are skipped.  Block pairs run fastest in the grid,
//     so the blocks that read one row block's panels run together and
//     share them through L2.  Each block writes its f64 128 x 128 partial
//     to scratch.
//   pass 2: a block of 16 warps takes 32 consecutive partial elements, one
//     per lane; warp v sums row blocks v, v + 16, ..., the block adds the
//     16 sums in order and scatters the upper-triangle element to G_TT
//     (both triangles), G_TA or G_AA (both triangles).
// Summation order: each block sums its rows 16 at a time in row order
// (the MMA's order inside a step); pass 2 as above.  The bits depend on
// (n, k, p1) alone through nbr, which ops/fused_gram.py::
// fused_block_table derives from the shapes.
//
// Work at the binary MSP shape (n = 1e5, k = 60, p1 = 169): 2 panels, 3
// pairs; every panel value is staged once per pair that holds it (0.41 GB
// from L2, 183 MB of it from device memory), and the products over the
// live 16 x 8 tiles of the pair tiles are 5.8e9 f64 flop where the upper
// triangle needs 5.3e9.  On the card, in same-call A/B builds, loads
// issued back to back beat a first version that loaded inside branches,
// 128-column panels beat 64-column ones, the ring of two tile sets beat
// one set with the next chunk held in registers (which also spilled),
// and warps of 2 bands by 4 column tiles (32 fragment loads for 8 MMAs,
// not 40) were slower; the times are chip_smoke.py's (PERF.md).  ptxas:
// 128 registers, no spills.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_f64.cuh"

#define PW 128           // columns of a panel
#define WROWS 32         // rows per chunk
#define WTHREADS 512     // 16 warps
#define WTILES 8         // 16 x 8 output tiles a warp owns
#define WS (PW + 4)      // tile row stride in doubles, 4 mod 16: a
                         // fragment load (4 rows t4 x 8 columns g) is two
                         // shared-memory wavefronts
#define PELEMS (PW * PW) // partial elements of a pair
#define P2_WARPS 16      // warps per pass-2 block
#define RSTEP (WTHREADS / PW)          // a thread stages rows r0 + RSTEP i
#define SROWS (WROWS / RSTEP)          // rows of a panel a thread stages

__host__ __device__ inline int wide_pairs(int npan) {
  return npan * (npan + 1) / 2;
}

// pair p of the row-major upper triangle of panel pairs -> (I, J)
__host__ __device__ inline void pair_of(int p, int npan, int& I, int& J) {
  I = 0;
  int row = npan;
  while (p >= row) {
    p -= row;
    ++I;
    --row;
  }
  J = I + p;
}

__device__ __forceinline__ long last_row(long r, long n) {
  return r < n ? r : n - 1;
}

// 16 values of one Y column (rows r0, r0 + 4, ... of the chunk at row0)
// as f32: from T for c < k, from A for k <= c < q, zero past q and past
// n.  The column is fixed for a thread, so its source and stride are
// chosen once and the 16 loads, from clamped valid addresses, issue back
// to back with no branch between them.
template <typename TT>
__device__ __forceinline__ void wide_fetch(float (&x)[SROWS],
                                           const TT* T, const double* A,
                                           long n, int k, int p1, int c,
                                           long row0, int r0, int rows) {
  if (c < k) {
    const TT* src = T + c;
#pragma unroll
    for (int i = 0; i < SROWS; ++i)
      x[i] = (float)src[last_row(row0 + r0 + RSTEP * i, n) * k];
  } else {
    const double* src = A + min(c - k, p1 - 1);
#pragma unroll
    for (int i = 0; i < SROWS; ++i)
      x[i] = (float)src[last_row(row0 + r0 + RSTEP * i, n) * p1];
  }
#pragma unroll
  for (int i = 0; i < SROWS; ++i)
    if (c >= k + p1 || r0 + RSTEP * i >= rows) x[i] = 0.0f;
}

template <typename TT>
__global__ void __launch_bounds__(WTHREADS, 1)
    wide_pass1(const TT* __restrict__ T, const double* __restrict__ A,
               const double* __restrict__ w, long n, int k, int p1,
               int npan, int nchunks, double* __restrict__ partial) {
  extern __shared__ __align__(16) double wsm[];
  // two tile sets, each panel I then panel J (unused on the diagonal),
  // WROWS x WS doubles a panel; then the ring of three sqrt(w) slots
  double* ys = wsm;
  float* sw = reinterpret_cast<float*>(ys + 4 * WROWS * WS);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int pair = blockIdx.x, rb = blockIdx.y, nbr = gridDim.y;
  int I, J;
  pair_of(pair, npan, I, J);
  const bool diag = I == J;
  const long c0 = (long)nchunks * rb / nbr;
  const long c1 = (long)nchunks * (rb + 1) / nbr;

  // this warp's output tiles: band `band` of panel I, column tiles
  // jt0 .. jt0 + 7 of panel J; on the diagonal, tiles wholly below it
  // (last column < first row) are skipped
  const int band = warp >> 1, jt0 = WTILES * (warp & 1);
  // live tiles jt0 + t, tlo <= t < thi: those with t < tlo lie wholly
  // below the diagonal, those with t >= thi wholly in the padding columns
  // past q, and a band wholly in the padding rows has none
  const int q = k + p1;
  const int tlo = diag ? max(0, min(WTILES, 2 * band - jt0)) : 0;
  const int thi = I * PW + 16 * band >= q
                      ? 0
                      : max(0, min(WTILES, (q - J * PW + 7) / 8 - jt0));
  double acc[WTILES][4];
#pragma unroll
  for (int t = 0; t < WTILES; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0;

  // staging: column cc of the panels, rows r0, r0 + RSTEP, ..., SROWS
  // of them, into tile set `set` (all the loads issued before the
  // stores); sqrt(w) of the chunk's rows from its slot of the sw ring
  const int cc = tid & (PW - 1), r0 = tid / PW;
  const int ci = I * PW + cc, cj = J * PW + cc;
  const int nits = (int)(c1 - c0);
  auto stage = [&](int it) {
    const long row0 = (c0 + it) * WROWS;
    const int rows = n - row0 < WROWS ? (int)(n - row0) : WROWS;
    float xi[SROWS], xj[SROWS];
    wide_fetch(xi, T, A, n, k, p1, ci, row0, r0, rows);
    if (!diag) wide_fetch(xj, T, A, n, k, p1, cj, row0, r0, rows);
    double* di = ys + (it & 1) * 2 * WROWS * WS;
    const float* s_ = sw + (it % 3) * WROWS;
#pragma unroll
    for (int i = 0; i < SROWS; ++i) {
      const int r = r0 + RSTEP * i;
      di[r * WS + cc] = (double)__fmul_rn(xi[i], s_[r]);
      if (!diag) di[WROWS * WS + r * WS + cc] = (double)__fmul_rn(xj[i], s_[r]);
    }
  };
  // sqrt(w) of chunk it's rows into its slot (it % 3) of the ring
  auto weights = [&](int it) {
    const long row0 = (c0 + it) * WROWS;
    if (tid < WROWS)
      sw[(it % 3) * WROWS + tid] =
          row0 + tid < n ? (float)sqrt(w[row0 + tid]) : 0.0f;
  };
  auto contract = [&](int it) {
    const double* yi = ys + (it & 1) * 2 * WROWS * WS;
    const double* yb = diag ? yi : yi + WROWS * WS;
#pragma unroll 1
    for (int r = 0; r < WROWS; r += 16) {
      const double* ar = yi + (r + t4) * WS + 16 * band + g;
      const double* br = yb + (r + t4) * WS + g;
      double a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = ar[4 * (i / 2) * WS + 8 * (i % 2)];
#pragma unroll
      for (int t = 0; t < WTILES; ++t) {
        if (t >= tlo && t < thi) {  // uniform across the warp
          double b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) b[i] = br[4 * i * WS + 8 * (jt0 + t)];
          mma_f64_k16(acc[t], a, b);
        }
      }
    }
  };
  // chunk it is multiplied from tile set it & 1 while chunk it + 1 is
  // staged into the other; odd warps multiply first and even warps stage
  // first, so the SM holds both kinds of work at once.  One barrier a
  // chunk: the sqrt(w) of chunk it + 2 goes into the slot of chunk it - 1,
  // last read before the previous barrier.
  if (nits > 0) weights(0);
  if (nits > 1) weights(1);
  __syncthreads();
  if (nits > 0) stage(0);
  __syncthreads();
  const bool mma_first = warp & 1;
  for (int it = 0; it < nits; ++it) {
    if (it + 2 < nits) weights(it + 2);
    if (mma_first) contract(it);
    if (it + 1 < nits) stage(it + 1);
    if (!mma_first) contract(it);
    __syncthreads();
  }

  // D[g + 8 h][2 t4 + e] of tile t -> partial[rb][pair][row * PW + col]
  double* out = partial + ((long)rb * gridDim.x + pair) * PELEMS;
#pragma unroll
  for (int t = 0; t < WTILES; ++t) {
    if (t >= tlo && t < thi) {
      const int row = 16 * band + g, col = 8 * (jt0 + t) + 2 * t4;
      out[row * PW + col] = acc[t][0];
      out[row * PW + col + 1] = acc[t][1];
      out[(row + 8) * PW + col] = acc[t][2];
      out[(row + 8) * PW + col + 1] = acc[t][3];
    }
  }
}

// One lane per partial element, 32 consecutive elements a block of
// P2_WARPS warps: warp v sums row blocks v, v + P2_WARPS, ... (contiguous
// 256-byte loads across the warp), then the block adds the P2_WARPS sums
// in order and scatters the upper-triangle element.
__global__ void __launch_bounds__(P2_WARPS * 32)
    wide_pass2(const double* __restrict__ partial, int nbr, int npairs,
               int npan, int k, int p1, double* __restrict__ gtt,
               double* __restrict__ gta, double* __restrict__ gaa) {
  __shared__ double red[P2_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long npe = (long)npairs * PELEMS;
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
  const int pair = (int)(pe / PELEMS), e = (int)(pe % PELEMS);
  int I, J;
  pair_of(pair, npan, I, J);
  const int q = k + p1;
  const int a = I * PW + e / PW, c = J * PW + e % PW;
  if (a > c || c >= q) return;  // below the diagonal, or padding
  if (c < k)
    gtt[a * k + c] = gtt[c * k + a] = tot;
  else if (a < k)
    gta[a * p1 + (c - k)] = tot;
  else
    gaa[(a - k) * p1 + (c - k)] = gaa[(c - k) * p1 + (a - k)] = tot;
}

inline size_t wide_smem() {
  return 4 * (size_t)WROWS * WS * sizeof(double) + 3 * WROWS * sizeof(float);
}

template <typename TT>
static cudaError_t launch_wide(const void* T, const double* A,
                               const double* w, int n, int k, int p1,
                               int npan, int nbr, double* partial,
                               cudaStream_t stream) {
  const size_t smem = wide_smem();
  cudaError_t err = cudaFuncSetAttribute(
      wide_pass1<TT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  wide_pass1<TT><<<dim3(wide_pairs(npan), nbr), WTHREADS, smem, stream>>>(
      static_cast<const TT*>(T), A, w, n, k, p1, npan,
      (n + WROWS - 1) / WROWS, partial);
  return cudaGetLastError();
}

// C entry: launches both passes on `stream` and returns cudaGetLastError().
// The caller allocates `partial` (nbr * npairs * 4096 f64) and the
// outputs, and checks shapes, types and contiguity against
// ops/fused_gram.py's fused_block_table, which this re-checks.
extern "C" int fused_gram_wide_launch(const void* T, int t_is_f64,
                                      const double* A, const double* w,
                                      int n, int k, int p1, int q_pad,
                                      int nbr, int threads, double* partial,
                                      double* gtt, double* gta, double* gaa,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int npan = q_pad / PW, nchunks = (n + WROWS - 1) / WROWS;
  if (threads != WTHREADS || n < 1 || k < 1 || p1 < 1 || q_pad % PW != 0 ||
      q_pad < k + p1 || q_pad - PW >= k + p1 || nbr < 1 || nbr > nchunks)
    return (int)cudaErrorInvalidValue;  // outside the kernel's design
  cudaError_t err =
      t_is_f64 ? launch_wide<double>(T, A, w, n, k, p1, npan, nbr, partial, s)
               : launch_wide<float>(T, A, w, n, k, p1, npan, nbr, partial, s);
  if (err != cudaSuccess) return (int)err;
  const long elems = (long)wide_pairs(npan) * PELEMS;
  wide_pass2<<<(unsigned)((elems + 31) / 32), P2_WARPS * 32, 0, s>>>(
      partial, nbr, wide_pairs(npan), npan, k, p1, gtt, gta, gaa);
  return (int)cudaGetLastError();
}
