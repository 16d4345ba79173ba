// fourier_apply: y = T z for the red-noise basis on Hopper (sm_90a).
//
// Replaces the TPU kernel pint_tpu/ops/pallas_kernels.py:210
// fourier_apply (_apply_kernel :197, pallas_call :242).  For TOA times t
// (n,), harmonic frequencies f (k,) and coefficients z (2k, m) with rows
// [sin; cos],
//
//   y (n, m) = T z,  T = [sin(2 pi f_j t_i) | cos(2 pi f_j t_i)],  f32,
//
// without writing T to device memory.
//
// Numerics: the basis values are fourier_basis.cuh's (the correctly
// rounded f32 sin and cos of the reference's f32 argument), z is rounded
// to f32, and the products of these f32 values, exact in f64, are summed
// in f64 on the f64 tensor cores (mma.sync m16n8k4) and rounded to f32
// once.  Summation order: basis columns in steps of 4 ([sin_1 .. sin_k,
// cos_1 .. cos_k] in that order), each step's 4 products as the MMA adds
// them.  With z a block of identity columns every output is one product
// by 1.0 plus exact zeros, i.e. the generated basis value itself:
// chip_smoke.py's bitwise basis check.
//
// Bound on an H100 SXM at n = 1e5, k = 30, m = 8: the function reads
// 0.8 MB of t and writes 3.2 MB of y (1.2 us at 3.35 TB/s) and does 4.8e7
// f64 FMAs (1.4 us at the 67 TFLOP/s f64 tensor-core peak, which m16n8k4
// reaches).  What holds it is the n k = 3e6 sincos of the basis: libdevice
// runs 3.7e11 pairs a second on the whole card (profiling/f64_rates.py),
// so ~8.2 us, and each is a latency-bound chain of ~30 dependent f64
// operations, so the design keeps as many independent chains in flight
// as the card holds.
//
// Structure: a block of 8 warps owns ROWS = 128 rows (past k = 64, 64, 32
// or 16 rows, so that a block's tiles take at most a quarter of shared
// memory and 4 blocks an SM keep their sincos chains in flight;
// ops/fourier.py::apply_rows, which also launches one kernel per slice of
// at most 16 columns of z).
//   1. the k f32 products 2 pi f_j go to shared memory;
//   2. the block's ROWS x k (row, harmonic) pairs, spread over all 256
//      threads (2 a row, 15 pairs a thread at k = 30), write the f32 basis
//      tile [sin | cos | 0] (ROWS x 4 ceil(2k / 4)) to shared memory;
//      then z (f32 values widened to f64, columns padded to 8 or 16 with
//      zeros), whose loads wait while other warps still run sincos;
//   3. each warp takes 16 x 8 output tiles and runs the k-steps of the
//      f64 MMA (m16n8k4) on them from shared memory; its y tile (16 rows
//      x 8 columns) is written as 128 contiguous floats at m = 8.
// 35 KB of shared memory and 40 registers a thread at the bench shape
// (ptxas, chip_smoke.py's build log on the H100; no spills, a 40-byte
// stack frame for libdevice sincos' large-argument branch): 6 blocks, 48
// warps, per SM, 782 blocks.
// On the card 256 rows a block, and 2 or 4 independent sincos chains a
// thread, ran within the noise of this geometry; 64 rows ran slower
// (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fourier_basis.cuh"
#include "mma_f64.cuh"

#define THREADS 256  // 8 warps
#define M_MAX 16     // most columns of z

// basis columns padded to the MMA's k-step of 4
__host__ __device__ inline int basis_cols(int k) { return (2 * k + 3) & ~3; }

// Row stride, in floats, of the basis tile: 4 mod 8, so each load of a
// warp's A fragment (8 rows g x 4 consecutive columns t4) hits 32
// distinct banks.
__host__ __device__ inline int basis_stride(int k) {
  const int k4 = basis_cols(k);
  return k4 % 8 == 4 ? k4 : k4 + 4;
}

// z's columns padded to the MMA's n of 8
__host__ __device__ inline int z_cols(int m) { return m <= 8 ? 8 : 16; }

// z, the basis tile of `rows` rows, and f32(2 pi) f_j for k rounded up to
// 64 harmonics
inline size_t apply_smem(int k, int m, int rows) {
  return (size_t)basis_cols(k) * z_cols(m) * sizeof(double) +
         (size_t)rows * basis_stride(k) * sizeof(float) +
         (size_t)((k + 63) / 64 * 64) * sizeof(float);
}

// ROWS rows a block: 128 where the basis tile fits shared memory, else
// 64, 32 or 16 (ops/fourier.py::fourier_apply_table).  The rows of a
// block change no output bit: each output sums its own row's products.
template <int ROWS>
__global__ void __launch_bounds__(THREADS)
    apply_kernel(const double* __restrict__ t,
                 const double* __restrict__ freqs,
                 const double* __restrict__ z, int n, int k, int m,
                 float* __restrict__ y) {
  extern __shared__ double smem[];
  const int k2 = 2 * k, k4 = basis_cols(k), SB = basis_stride(k);
  const int mz = z_cols(m);
  double* zs = smem;                                  // k4 x mz
  float* bs = reinterpret_cast<float*>(zs + k4 * mz);  // ROWS x SB
  float* fw = bs + ROWS * SB;                          // k
  const int tid = threadIdx.x;
  const long row0 = (long)blockIdx.x * ROWS;

  for (int j = tid; j < k; j += THREADS) fw[j] = fourier_omega(freqs[j]);
  if (k4 > k2)  // k odd: the two pad columns of the last k-step
    for (int r = tid; r < ROWS; r += THREADS)
      bs[r * SB + k2] = bs[r * SB + k2 + 1] = 0.0f;
  __syncthreads();

  // the basis tile: sin in column j, cos in column k + j; rows past n 0.
  // THREADS / ROWS threads share a row and round its t to f32 once.
  {
    const int tpr = THREADS / ROWS, r = tid / tpr;
    const bool live = row0 + r < n;
    const float tr = live ? (float)t[row0 + r] : 0.0f;
    for (int j = tid - r * tpr; j < k; j += tpr) {
      const float2 sc =
          live ? fourier_pair(fw[j], tr) : make_float2(0.0f, 0.0f);
      bs[r * SB + j] = sc.x;
      bs[r * SB + k + j] = sc.y;
    }
  }
  // z, after the basis: its loads wait while other warps run sincos
  for (int idx = tid; idx < k4 * mz; idx += THREADS) {
    const int r = idx / mz, c = idx - r * mz;
    zs[idx] = r < k2 && c < m ? (double)(float)z[r * m + c] : 0.0;
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rtiles = ROWS / 16, ntiles = rtiles * (mz / 8);
  for (int tile = warp; tile < ntiles; tile += THREADS / 32) {
    const int rt = tile % rtiles, ct = tile / rtiles;
    const float* a = bs + (rt * 16 + g) * SB + t4;
    const double* b = zs + t4 * mz + ct * 8 + g;
    double d[4] = {0.0, 0.0, 0.0, 0.0};
    for (int kk = 0; kk < k4; kk += 4) {
      const double ak[2] = {(double)a[kk], (double)a[8 * SB + kk]};
      mma_f64_k4(d, ak, b + kk * mz);
    }
    const int c = ct * 8 + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the tile
      const long i = row0 + rt * 16 + 8 * h + g;
      if (i < n) {
        if (c < m) y[i * m + c] = (float)d[2 * h];
        if (c + 1 < m) y[i * m + c + 1] = (float)d[2 * h + 1];
      }
    }
  }
}

// C entry: launches the kernel on `stream` and returns cudaGetLastError().
// The caller allocates y and checks shapes, types and contiguity against
// ops/fourier.py's fourier_apply_table, which this re-checks.
template <int ROWS>
static cudaError_t launch_apply(const double* t, const double* freqs,
                                const double* z, int n, int k, int m,
                                int blocks, float* y, cudaStream_t s) {
  const size_t smem = apply_smem(k, m, ROWS);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        apply_kernel<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  apply_kernel<ROWS><<<blocks, THREADS, smem, s>>>(t, freqs, z, n, k, m, y);
  return cudaGetLastError();
}

extern "C" int fourier_apply_launch(const double* t, const double* freqs,
                                    const double* z, int n, int k, int m,
                                    int blocks, int threads, int rows,
                                    float* y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || m < 1 || m > M_MAX || n < 1 || threads != THREADS ||
      (long)blocks * rows < n)
    return (int)cudaErrorInvalidValue;  // outside the kernel's design
  cudaError_t err;
  if (rows == 128)
    err = launch_apply<128>(t, freqs, z, n, k, m, blocks, y, s);
  else if (rows == 64)
    err = launch_apply<64>(t, freqs, z, n, k, m, blocks, y, s);
  else if (rows == 32)
    err = launch_apply<32>(t, freqs, z, n, k, m, blocks, y, s);
  else if (rows == 16)
    err = launch_apply<16>(t, freqs, z, n, k, m, blocks, y, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}
