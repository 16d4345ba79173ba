// fused_gram_joint: the mixed GLS step's joint Gram on Hopper (sm_90a).
//
// Replaces the TPU kernel pint_tpu/ops/pallas_fit.py::fused_gram_joint
// (_joint_gram_kernel / _fused_gram_32).  It computes, for a noise basis
// T (n, k) and design-plus-residual columns A (n, p1) under weights
// w (n,), the Gram of Y = [f32(T) | f32(A)] * f32(sqrt(w)):
//
//   G = Y^T Y  ->  G_TT (k, k), G_TA (k, p1), G_AA (p1, p1), all f64.
//
// Numerics.  The row scale is sqrt(w) in f64 rounded once to f32, and T
// and A are read in their stored type and rounded to f32 in registers
// (the same values as casting outside the kernel, without a separate
// cast pass over T): Y holds exactly the reference's f32 values.  The
// products of f32 values are exact in f64, and this kernel sums them in
// f64 (DFMA), where the TPU summed each 128-row sub-chunk in f32.  On
// the bench pulsar the f32 sub-chunk sums are what moves the mixed
// step's covariance off the f64 step (1.4e-2 at 1e5 TOAs on an H100,
// past the 5e-3 gate), while f64 sums of the same f32 values stay near
// 1e-8 (PERF.md); the H100 runs f64 FMA at half its f32 rate, which
// keeps this kernel bound by bytes.  FMA contraction is harmless here: the kernel holds no
// double-double arithmetic.
//
// Structure.  On the TPU the grid ran in order and carried a
// Neumaier-compensated sum from one grid step to the next.  Here blocks
// run in parallel, so:
//   pass 1: block b owns a contiguous range of 128-row sub-chunks.  For
//           each it stages Y (128 x q_pad values, rounded to f32 and
//           stored widened to f64, ~74 KB at the bench's q = 67) in
//           shared memory, eight loads in flight per thread.  Each warp
//           owns a run of 8 x 8 tiles of the upper triangle and
//           accumulates them with the f64 tensor-core MMA
//           (mma.sync m8n8k4 f64: exact products of the f32 values, f64
//           sums).  The block writes its f64 partial triangle to
//           scratch.
//   pass 2: one warp per output element sums the block partials in a
//           fixed order (lanes, then a shuffle tree), mirrored into the
//           three output blocks.
// No atomics: results are bitwise reproducible from run to run.  Ragged
// n and q edges are masked (zero rows / zero pad columns in shared
// memory); a zero-weight row contributes exactly zero.
//
// Bound on an H100 SXM at the bench shapes (n = 1e5, k = 60, p1 = 7,
// T in f64): the function must read 8*n*(k + p1 + 1) = 54.4 MB, which
// at 3.35 TB/s is 16.2 us, while its n*q*(q+1) = 4.6e8 f64 flops take
// 13.4 us at 34 TFLOP/s without the tensor cores: it is bound by bytes.
// Each block stages, then computes, with no overlap of the two (no
// cp.async/TMA pipeline); PERF.md has the measurements and the tuning
// tried.

#include <cuda_runtime.h>
#include <stdint.h>

#define SUB 128
#define TILE 8        // output tiles are 8 x 8 (the MMA's m and n)
#define WARPS 8       // warps per pass-1 block
#define MAXT 8        // most output tiles one warp owns
#define UNROLL 8      // loads in flight per thread while staging

// Row stride of the shared tile, in doubles: a multiple of 8 that is 8
// mod 16, so a warp's MMA operand load (4 rows x 8 consecutive doubles)
// touches every bank pair exactly twice.
__host__ __device__ inline int row_stride(int q_pad) {
  return q_pad % 16 == 0 ? q_pad + 8 : q_pad;
}

// Stage rows x ncols of a row-major source (row stride ncols) into
// columns col0.. of the shared tile: rounded to f32 and row-scaled in
// f32 (the reference's values), stored widened to f64 (exact).
template <typename TS>
__device__ __forceinline__ void stage(const TS* __restrict__ src, int rows,
                                      int ncols, int col0, int stride,
                                      const float* ss, double* ys) {
  const int total = rows * ncols;
  for (int base = threadIdx.x; base < total; base += blockDim.x * UNROLL) {
    TS v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int idx = base + u * blockDim.x;
      v[u] = idx < total ? src[idx] : TS(0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < total) {
        const int r = idx / ncols;
        ys[r * stride + col0 + (idx - r * ncols)] =
            (double)((float)v[u] * ss[r]);
      }
    }
  }
}

// d += a * b for one 8 x 8 x 4 f64 MMA fragment (PTX ISA fragment layout:
// a = A[lane/4][lane%4], b = B[lane%4][lane/4], d = D[lane/4][2(lane%4)+i]).
__device__ __forceinline__ void mma_f64(double& d0, double& d1, double a,
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

template <typename TT>
__global__ void gram_pass1(const TT* __restrict__ T,
                           const double* __restrict__ A,
                           const double* __restrict__ w,
                           int n, int k, int p1, int q_pad, int nchunks,
                           double* __restrict__ partial) {
  extern __shared__ double2 smem2[];
  const int S = row_stride(q_pad);
  double* ys = reinterpret_cast<double*>(smem2);       // SUB x S
  float* ss = reinterpret_cast<float*>(ys + SUB * S);  // SUB row scales

  const int q = k + p1;
  const int nt = q_pad / TILE;
  const int ntiles = nt * (nt + 1) / 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  // this warp's tiles: a contiguous run of the row-major triangle
  const int per = (ntiles + WARPS - 1) / WARPS;
  const int first = warp * per;
  const int mine = max(0, min(per, ntiles - first));
  int tI[MAXT], tJ[MAXT];
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
    int tt = first + j, I = 0, row = nt;
    while (row > 0 && tt >= row) {
      tt -= row;
      ++I;
      --row;
    }
    tI[j] = I;
    tJ[j] = I + tt;
  }
  double acc[MAXT][2];
#pragma unroll
  for (int j = 0; j < MAXT; ++j) acc[j][0] = acc[j][1] = 0.0;

  const long c0 = (long)nchunks * blockIdx.x / gridDim.x;
  const long c1 = (long)nchunks * (blockIdx.x + 1) / gridDim.x;
  for (long c = c0; c < c1; ++c) {
    const long r0 = c * SUB;
    const int rows = (long)n - r0 < SUB ? (int)((long)n - r0) : SUB;
    __syncthreads();  // the previous chunk's reads are done
    for (int r = tid; r < SUB; r += blockDim.x)
      ss[r] = r < rows ? (float)sqrt(w[r0 + r]) : 0.0f;
    __syncthreads();
    stage(T + r0 * k, rows, k, 0, S, ss, ys);
    stage(A + r0 * p1, rows, p1, k, S, ss, ys);
    const int padc = q_pad - q;
    for (int idx = tid; idx < rows * padc; idx += blockDim.x) {
      const int r = idx / padc;
      ys[r * S + q + (idx - r * padc)] = 0.0;
    }
    for (int idx = rows * S + tid; idx < SUB * S; idx += blockDim.x)
      ys[idx] = 0.0;
    __syncthreads();

    for (int r = 0; r < SUB; r += 4) {
      const double* yr = ys + (r + t4) * S + g;
      double a = 0.0;
#pragma unroll
      for (int j = 0; j < MAXT; ++j) {
        if (j < mine) {  // uniform across the warp
          if (j == 0 || tI[j] != tI[j - 1]) a = yr[tI[j] * TILE];
          mma_f64(acc[j][0], acc[j][1], a, yr[tJ[j] * TILE]);
        }
      }
    }
  }

  // D[g][2 t4 + i] of each tile -> partial[block][tile][g * 8 + 2 t4 + i]
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
    if (j < mine) {
      double* out = partial + ((long)blockIdx.x * ntiles + first + j) *
                                  (TILE * TILE) + g * TILE + 2 * t4;
      out[0] = acc[j][0];
      out[1] = acc[j][1];
    }
  }
}

// One warp per output element: lanes stride over the block partials,
// then a fixed shuffle tree adds the 32 lane sums.  The order is fixed,
// so the result is bitwise reproducible, and (i, j) and (j, i) agree.
__global__ void gram_pass2(const double* __restrict__ partial, int nb,
                           int q_pad, int k, int p1,
                           double* __restrict__ gtt,
                           double* __restrict__ gta,
                           double* __restrict__ gaa) {
  const int q = k + p1;
  const int elem = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (elem >= q * q) return;  // uniform across the warp
  const int i = elem / q, j = elem - (elem / q) * q;
  if (i >= k && j < k) return;  // G_AT is G_TA transposed: not an output
  const int a = min(i, j), c = max(i, j);
  const int nt = q_pad / TILE;
  const int ntiles = nt * (nt + 1) / 2;
  const int I = a / TILE, J = c / TILE;
  const int tile = I * nt - I * (I - 1) / 2 + (J - I);
  const int e = (a % TILE) * TILE + (c % TILE);
  double s = 0.0;
  for (int b = lane; b < nb; b += 32)
    s += partial[((long)b * ntiles + tile) * (TILE * TILE) + e];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane != 0) return;
  if (i < k && j < k)
    gtt[i * k + j] = s;
  else if (i < k)
    gta[i * p1 + (j - k)] = s;
  else
    gaa[(i - k) * p1 + (j - k)] = s;
}

template <typename TT>
static cudaError_t launch_pass1(const void* T, const double* A,
                                const double* w, int n, int k, int p1,
                                int q_pad, int nchunks, int nb, int threads,
                                double* partial, cudaStream_t stream) {
  const size_t smem = (size_t)SUB * row_stride(q_pad) * sizeof(double) +
                      SUB * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gram_pass1<TT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  gram_pass1<TT><<<nb, threads, smem, stream>>>(
      static_cast<const TT*>(T), A, w, n, k, p1, q_pad, nchunks, partial);
  return cudaGetLastError();
}

// C entry: launches both passes on `stream` and returns cudaGetLastError().
// The caller allocates `partial` (nb * ntiles * 64 f64) and the outputs,
// and checks shapes, types and contiguity.
extern "C" int fused_gram_joint_launch(const void* T, int t_is_f64,
                                       const double* A, const double* w,
                                       int n, int k, int p1, int q_pad,
                                       int nb, int threads, double* partial,
                                       double* gtt, double* gta, double* gaa,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = q_pad / TILE;
  if (threads != WARPS * 32 || q_pad % TILE != 0 ||
      nt * (nt + 1) / 2 > WARPS * MAXT)
    return (int)cudaErrorInvalidValue;  // outside the kernel's design
  const int nchunks = (n + SUB - 1) / SUB;
  cudaError_t err =
      t_is_f64 ? launch_pass1<double>(T, A, w, n, k, p1, q_pad, nchunks, nb,
                                      threads, partial, s)
               : launch_pass1<float>(T, A, w, n, k, p1, q_pad, nchunks, nb,
                                     threads, partial, s);
  if (err != cudaSuccess) return (int)err;
  const int q = k + p1;
  const int t2 = 256;  // 8 warps, one output element each
  gram_pass2<<<(q * q * 32 + t2 - 1) / t2, t2, 0, s>>>(
      partial, nb, q_pad, k, p1, gtt, gta, gaa);
  return (int)cudaGetLastError();
}
