// fourier_gram: the streaming-basis GLS step's Grams on Hopper (sm_90a).
//
// Replaces the TPU kernel pint_tpu/ops/pallas_kernels.py:114 fourier_gram
// (_gram_kernel :86, pallas_call :162).  For TOA times t (n,), harmonic
// frequencies f (k,), weights w (n,) and columns X (n, p), with the
// red-noise basis T = [sin(2 pi f_j t_i) | cos(2 pi f_j t_i)] (n, 2k)
// generated in shared memory and never written to device memory:
//
//   Sigma = T^T diag(w) T (2k, 2k),  TWX = T^T diag(w) X (2k, p),  f64.
//
// Numerics.  t, f, w and X are read in f64 and rounded to f32, as the
// reference casts them before its kernel.  The basis values are
// fourier_basis.cuh's: the correctly rounded f32 sin and cos of the
// reference's f32 argument, so the card's step agrees with the port's on
// the CPU to 1e-8 (PERF.md).  The weighted basis is f32(T * w), the
// reference's Tw, by __fmul_rn.  The products of these f32 values are
// exact in f64 and are summed in f64 on the f64 tensor cores (mma.sync
// m16n8k16, mma_f64.cuh), where the TPU summed in f32.  Zero-weight
// rows and padding add exact zeros.  Sigma is the upper triangle (rows
// Tw, columns T), mirrored, so it is exactly symmetric.  Summation order:
// each block sums its contiguous run of rows 16 at a time in row order
// (the MMA's order inside a step); pass 2 sums the NB block partials as 8
// strided runs (b = w, w + 8, ...), then the 8 runs in order.  (An
// earlier layout of this kernel summed 4-row steps over 128-row chunks,
// so its last bits differ from this one's.)  No atomics: bitwise
// reproducible from run to run, and the bits depend on n and k alone
// through the chunk height R (64, or 32 or 16 past k = 88) and the block
// count NB = min(ceil(n / R), 264): not on p, so ops/fourier.py's launches
// over column slices of a wide X give the bits of one wider launch.
//
// Bound on an H100 SXM at the bench shape (n = 1e5, k = 30, p = 7): the
// function reads 8 n (p + 2) = 7.2 MB (2.2 us at 3.35 TB/s) and does
// n (2k (2k + 1) / 2 + 2k p) = 2.25e8 f64 FMAs (6.7 us at the 67 TFLOP/s
// f64 tensor-core peak, which m16n8k4/k8/k16 reach and m8n8k4 does not:
// 66 vs 33 TFLOP/s, profiling/f64_rates.py): bound by operations.  Beside
// that it needs n k = 3e6 sincos (libdevice: ~8.2 us on the whole card at
// 3.7e11 a second), and its 16 x 8 output tiles (24 at the bench shape)
// compute 3072 products a row where 2250 are needed (9.3 us at the peak),
// each operand an f32 load and an f32 -> f64 conversion.  The sincos run
// on the f64 FMA pipe and the products on the tensor cores, so the design
// overlaps the two:
//   pass 1: block (bx, by) of 12 warps walks a contiguous run of 64-row
//     chunks with a ring of two shared slots, each holding the chunk's
//     f32 tiles Tw = f32(T * w) (64 x kb, formed once as it is staged)
//     and [T | 0 | X | 0] (64 x q_pad), widened when loaded as an MMA
//     operand (36.9 KB a slot at the bench shape, 2 blocks = 24 warps per
//     SM).  In each step every warp stages its share of chunk c + 1 into
//     one slot (6 threads a row, each rounding the row's t and w once) and
//     runs its MMA tiles over chunk c in the other; odd warps do the MMA
//     first and even warps the staging first, so the SM's schedulers hold
//     both kinds of instruction at once.  One __syncthreads a chunk.  A
//     fixed split into producer and consumer warps was not taken: the
//     register file allows ~24 warps per SM (at 18 warps a block ptxas
//     cannot place the f64 MMA in the 56 registers left), and the
//     latency-bound sincos chains need most of them in flight, while the
//     MMA needs few; here every warp does both.  Each warp owns a run of
//     at most 2 output tiles of 16 x 8 over the upper block triangle (by
//     picks a group of 24 tiles; one group covers k <= 30 with p <= 8) and
//     keeps their sums in registers; its MMA is m16n8k16 (a quarter of
//     m16n8k4's instructions for the same products).  The block writes
//     its f64 partial tiles to scratch, a warp's 128 doubles of a tile
//     contiguous.  t, w and X are read by plain loads in the staging (9
//     doubles a row).
//   pass 2: a block of 8 warps takes 32 consecutive partial elements, one
//     per lane, so a warp's loads are 256 contiguous bytes; warp w sums
//     blocks w, w + 8, ... and the block adds the 8 sums in order.
// Wide shapes: more harmonics take chunks of R = 32 or 16 rows (the
// template parameter of GramBlockT and gram_pass1), so the ring of two
// slots fits shared memory with at least 64 columns of X; more columns
// take more tile groups along y (each generating its chunks' basis
// again) and a larger ring (164 KB at k = 30, p = 169: one block an SM,
// whose warps then own up to MAXT_WIDE = 6 tiles each in the registers
// the second block would have had, so fewer groups generate the basis).
// ptxas on the H100 (chip_smoke.py's build log): pass 1 79 registers
// (the cap of 2 blocks of 384 threads is 80) for each R, no spills, a
// 40-byte stack frame (libdevice sincos' large-argument branch), 74 KB of
// dynamic shared memory at the bench shape; pass 2 30 registers, 2 KB.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fourier_basis.cuh"
#include "mma_f64.cuh"

#define SUB 64        // rows per chunk where the ring holds them (k <= 88)
#define TROWS 16      // output tiles are 16 x 8 (the MMA's m and n)
#define TCOLS 8
#define TELEMS (TROWS * TCOLS)
#define WARPS 12      // warps per pass-1 block
#define THREADS (WARPS * 32)
#define MAXT 2        // output tiles a warp owns where 2 blocks fit an SM
#define MAXT_WIDE 6   // ... where the ring leaves room for one block
#define P2_WARPS 8    // warps per pass-2 block

// bytes of one ring slot of R-row chunks: Tw (R x row stride of kb), then
// [T | X] (R x row stride of q_pad), both f32
__host__ __device__ inline int slot_bytes(int kb, int q_pad, int R = SUB) {
  return R * (fourier_mma_stride(kb) + fourier_mma_stride(q_pad)) *
         (int)sizeof(float);
}

// the ring's two slots, then f32(2 pi) f_j for k rounded up to 64
inline size_t pass1_smem(int kb, int q_pad, int R = SUB) {
  return 2 * (size_t)slot_bytes(kb, q_pad, R) +
         (size_t)((kb / 2 + 63) / 64 * 64) * sizeof(float);
}

// One pass-1 block: its ring of two chunk slots of R rows in shared
// memory, and this warp's output tiles with their sums.  gram_pass1 runs
// it; its halves, staging and MMA, are also run alone to time them
// (profiling/fourier_gram_split.cu).  R is 64 for 2k <= 208 harmonic
// columns; wider bases take chunks of 32 or 16 rows, so that the ring
// fits shared memory (ops/fourier.py::gram_rows).
template <int R, int TW>
struct GramBlockT {
  static constexpr int TPR = THREADS / R;  // staging threads a row

  char* ring;
  float* fw;  // f32(2 pi) f_j
  const double* t;
  const double* w;
  const double* X;
  int n, k, p, kb, SW, SQ, slot;
  int tid, warp, g, t4, first, mine;
  int tI[TW], tJ[TW];
  double acc[TW][4];

  // Sets up the block and writes fw and the pad columns of both slots;
  // the caller syncs before staging.
  __device__ __forceinline__ GramBlockT(void* smem, const double* t_,
                                       const double* freqs,
                                       const double* w_, const double* X_,
                                       int n_, int k_, int p_, int kb_,
                                       int q_pad, int ntiles)
      : ring(static_cast<char*>(smem)), t(t_), w(w_), X(X_), n(n_), k(k_),
        p(p_), kb(kb_), SW(fourier_mma_stride(kb_)),
        SQ(fourier_mma_stride(q_pad)), slot(slot_bytes(kb_, q_pad, R)),
        tid(threadIdx.x), warp(threadIdx.x >> 5),
        g((threadIdx.x & 31) >> 2), t4(threadIdx.x & 3) {
    fw = reinterpret_cast<float*>(ring + 2 * slot);
    // this block's group of tiles, and this warp's contiguous run of it;
    // tiles run row-major over the block triangle, row I (basis columns
    // 16 I .. 16 I + 15) holding the column tiles J = 2 I .. nt - 1
    const int nt = q_pad / TCOLS;
    const int tile0 = blockIdx.y * (WARPS * TW);
    const int count = min(WARPS * TW, ntiles - tile0);
    const int per = (count + WARPS - 1) / WARPS;
    first = tile0 + warp * per;
    mine = max(0, min(per, tile0 + count - first));
#pragma unroll
    for (int j = 0; j < TW; ++j) {
      int tt = first + j, I = 0, row = nt;
      while (row > 0 && tt >= row) {
        tt -= row;
        ++I;
        row -= 2;
      }
      tI[j] = I;
      tJ[j] = 2 * I + tt;
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0;
    }

    for (int j = tid; j < k; j += THREADS) fw[j] = fourier_omega(freqs[j]);
    // the pad columns of both slots: Tw's [2k, SW), [T | X]'s [2k, kb)
    // and [kb + p, SQ)
    for (int idx = tid; idx < 2 * R; idx += THREADS) {
      float* tw = tw_of(idx / R) + (idx % R) * SW;
      float* tx = tx_of(idx / R) + (idx % R) * SQ;
      for (int c = 2 * k; c < SW; ++c) tw[c] = 0.0f;
      for (int c = 2 * k; c < kb; ++c) tx[c] = 0.0f;
      for (int c = kb + p; c < SQ; ++c) tx[c] = 0.0f;
    }
  }

  // slot s's Tw and [T | X] tiles
  __device__ __forceinline__ float* tw_of(int s) const {
    return reinterpret_cast<float*>(ring + s * slot);
  }
  __device__ __forceinline__ float* tx_of(int s) const {
    return reinterpret_cast<float*>(ring + s * slot) + R * SW;
  }

  // chunk c into slot s: sin in column j, cos in column k + j, rows past
  // n zero; X rounded to f32 after the basis' kb columns.  TPR threads
  // share a row, so each rounds its row's t and w to f32 once.
  __device__ __forceinline__ void stage(long c, int s) {
    float* tw = tw_of(s);
    float* tx = tx_of(s);
    const long r0 = c * R;
    const int rows = (long)n - r0 < R ? (int)((long)n - r0) : R;
    const int r = tid / TPR;
    const bool live = r < rows;
    const float tr = live ? (float)t[r0 + r] : 0.0f;
    const float wr = live ? (float)w[r0 + r] : 0.0f;
    for (int j = tid - r * TPR; j < k; j += TPR) {
      const float2 sc =
          live ? fourier_pair(fw[j], tr) : make_float2(0.0f, 0.0f);
      tx[r * SQ + j] = sc.x;
      tx[r * SQ + k + j] = sc.y;
      tw[r * SW + j] = __fmul_rn(sc.x, wr);
      tw[r * SW + k + j] = __fmul_rn(sc.y, wr);
    }
    const double* Xc = X + r0 * p;
    for (int idx = tid; idx < R * p; idx += THREADS) {
      const int rx = idx / p;
      tx[rx * SQ + kb + (idx - rx * p)] = rx < rows ? (float)Xc[idx] : 0.0f;
    }
  }

  // this warp's tiles over the chunk in slot s, 16 rows an MMA
  __device__ __forceinline__ void contract(int s) {
    const float* tw = tw_of(s);
    const float* tx = tx_of(s);
    for (int r = 0; r < R; r += 16) {
      const float* ar = tw + (r + t4) * SW + g;
      const float* br = tx + (r + t4) * SQ + g;
      double a[8];
#pragma unroll
      for (int j = 0; j < TW; ++j) {
        if (j < mine) {  // uniform across the warp
          if (j == 0 || tI[j] != tI[j - 1]) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
              a[i] = (double)ar[4 * (i / 2) * SW + tI[j] * TROWS + 8 * (i % 2)];
          }
          double b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            b[i] = (double)br[4 * i * SQ + tJ[j] * TCOLS];
          mma_f64_k16(acc[j], a, b);
        }
      }
    }
  }

  // D[g + 8 h][2 t4 + i] of each tile -> partial[block][tile][row * 8 +
  // column]: a warp writes a tile's 128 doubles contiguously
  __device__ __forceinline__ void store(double* partial, int ntiles) const {
#pragma unroll
    for (int j = 0; j < TW; ++j) {
      if (j < mine) {
        double* out = partial +
                      ((long)blockIdx.x * ntiles + first + j) * TELEMS +
                      g * TCOLS + 2 * t4;
        out[0] = acc[j][0];
        out[1] = acc[j][1];
        out[8 * TCOLS] = acc[j][2];
        out[8 * TCOLS + 1] = acc[j][3];
      }
    }
  }
};

using GramBlock = GramBlockT<SUB, MAXT>;

// this block's contiguous run [c0, c0 + count) of the n's R-row chunks
__device__ __forceinline__ long chunk_first(int nchunks) {
  return (long)nchunks * blockIdx.x / gridDim.x;
}
__device__ __forceinline__ int chunk_count(int nchunks) {
  return (int)((long)nchunks * (blockIdx.x + 1) / gridDim.x -
               chunk_first(nchunks));
}

template <int R, int TW>
__global__ void __launch_bounds__(THREADS, TW == MAXT ? 2 : 1)
    gram_pass1(const double* __restrict__ t, const double* __restrict__ freqs,
               const double* __restrict__ w, const double* __restrict__ X,
               int n, int k, int p, int kb, int q_pad, int nchunks,
               int ntiles, double* __restrict__ partial) {
  extern __shared__ double smem[];
  GramBlockT<R, TW> b(smem, t, freqs, w, X, n, k, p, kb, q_pad, ntiles);
  __syncthreads();
  const long c0 = chunk_first(nchunks);
  const int nits = chunk_count(nchunks);
  b.stage(c0, 0);
  __syncthreads();
  const bool mma_first = b.warp & 1;
  for (int it = 0; it < nits; ++it) {
    const int cur = it & 1;
    if (mma_first) b.contract(cur);
    if (it + 1 < nits) b.stage(c0 + it + 1, cur ^ 1);
    if (!mma_first) b.contract(cur);
    __syncthreads();  // slot cur is free, slot cur ^ 1 is staged
  }
  b.store(partial, ntiles);
}

// One lane per partial element (tile, e), 32 consecutive elements a
// block: warp w sums blocks w, w + 8, ... (contiguous 256-byte loads
// across the warp), then the block adds the 8 warp sums in order and
// scatters each element to Sigma (both triangles) or TWX.  Sigma(i, j)
// and Sigma(j, i) are the same upper-triangle element, so Sigma is exactly
// symmetric.
__global__ void __launch_bounds__(P2_WARPS * 32)
    gram_pass2(const double* __restrict__ partial, int nb, int k, int p,
               int kb, int q_pad, int ntiles, double* __restrict__ sig,
               double* __restrict__ twx) {
  __shared__ double red[P2_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int npe = ntiles * TELEMS;
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
  const int nt = q_pad / TCOLS;
  int tt = pe / TELEMS, I = 0, row = nt;
  while (tt >= row) {
    tt -= row;
    ++I;
    row -= 2;
  }
  const int e = pe % TELEMS;
  const int k2 = 2 * k;
  const int a = I * TROWS + e / TCOLS, c = (2 * I + tt) * TCOLS + e % TCOLS;
  if (a >= k2) return;  // a pad row of the basis
  if (c < kb) {
    if (c < k2 && a <= c) sig[a * k2 + c] = sig[c * k2 + a] = tot;
  } else if (c - kb < p) {
    twx[a * p + (c - kb)] = tot;
  }
}

static int check_shape(int n, int k, int p, int kb, int q_pad, int nb,
                       int ny, int threads, int* ntiles, int tw = MAXT) {
  const int nt = q_pad / TCOLS, nbt = kb / TROWS;
  *ntiles = nbt * nt - nbt * (nbt - 1);
  return threads == THREADS && k >= 1 && p >= 1 &&
         kb % TROWS == 0 && kb >= 2 * k && q_pad % TCOLS == 0 &&
         q_pad >= kb + p && ny * WARPS * tw >= *ntiles && nb >= 1 &&
         n >= 1;
}

template <int R, int TW>
static cudaError_t launch_pass1(const double* t, const double* freqs,
                                const double* w, const double* X, int n,
                                int k, int p, int kb, int q_pad, int nb,
                                int ny, int ntiles, double* partial,
                                cudaStream_t s) {
  const size_t smem = pass1_smem(kb, q_pad, R);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gram_pass1<R, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  gram_pass1<R, TW><<<dim3(nb, ny), THREADS, smem, s>>>(
      t, freqs, w, X, n, k, p, kb, q_pad, (n + R - 1) / R, ntiles, partial);
  return cudaGetLastError();
}

template <int R>
static cudaError_t launch_rows(const double* t, const double* freqs,
                               const double* w, const double* X, int n, int k,
                               int p, int kb, int q_pad, int nb, int ny,
                               int ntiles, int tw, double* partial,
                               cudaStream_t s) {
  if (tw == MAXT)
    return launch_pass1<R, MAXT>(t, freqs, w, X, n, k, p, kb, q_pad, nb, ny,
                                 ntiles, partial, s);
  return launch_pass1<R, MAXT_WIDE>(t, freqs, w, X, n, k, p, kb, q_pad, nb,
                                    ny, ntiles, partial, s);
}

// C entry: launches both passes on `stream` and returns cudaGetLastError().
// The caller allocates `partial` (nb * ntiles * 128 f64) and the outputs,
// and checks shapes, types and contiguity against ops/fourier.py's
// fourier_gram_table, which this re-checks; `rows` is the chunk height
// R (64, 32 or 16), nb at most ceil(n / rows), and `tiles` the output
// tiles a warp owns (MAXT, or MAXT_WIDE where the ring leaves room for
// one block an SM).
extern "C" int fourier_gram_launch(const double* t, const double* freqs,
                                   const double* w, const double* X, int n,
                                   int k, int p, int kb, int q_pad, int nb,
                                   int ny, int threads, int rows, int tiles,
                                   double* partial, double* sig, double* twx,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int ntiles;
  if (!check_shape(n, k, p, kb, q_pad, nb, ny, threads, &ntiles, tiles) ||
      (tiles != MAXT && tiles != MAXT_WIDE) ||
      (long)nb * rows > (long)n + rows - 1)
    return (int)cudaErrorInvalidValue;  // outside the kernel's design
  cudaError_t err;
  if (rows == 64)
    err = launch_rows<64>(t, freqs, w, X, n, k, p, kb, q_pad, nb, ny, ntiles,
                          tiles, partial, s);
  else if (rows == 32)
    err = launch_rows<32>(t, freqs, w, X, n, k, p, kb, q_pad, nb, ny, ntiles,
                          tiles, partial, s);
  else if (rows == 16)
    err = launch_rows<16>(t, freqs, w, X, n, k, p, kb, q_pad, nb, ny, ntiles,
                          tiles, partial, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  const int blocks = (ntiles * TELEMS + 31) / 32;
  gram_pass2<<<blocks, P2_WARPS * 32, 0, s>>>(partial, nb, k, p, kb, q_pad,
                                              ntiles, sig, twx);
  return (int)cudaGetLastError();
}
