// f64 rates of the card for the Fourier kernels' work: the f64 mma.sync
// shapes of sm_90 (their fragment layouts, checked on known operands, and
// their throughput), libdevice's f64 sincos of an f32 argument and the
// port's basis generator fourier_pair (fourier_basis.cuh), and the
// f32 <-> f64 conversions.  Built and driven by
// profiling/f64_rates.py (nvcc, ctypes); not part of the port.
//
// Fragment layouts, as the PTX ISA gives them for .f64 (g = lane / 4,
// t4 = lane % 4):
//   A (16 x K): a[i] = A[g + 8 (i % 2)][t4 + 4 (i / 2)]   (m8n8k4: a = A[g][t4])
//   B (K x 8):  b[i] = B[t4 + 4 i][g]
//   C (16 x 8): c[i] = C[g + 8 (i / 2)][2 t4 + i % 2]    (m8n8k4: rows g only)

#include <cuda_runtime.h>

#include "../pint_tpu_torch/csrc/fourier_basis.cuh"

template <int M, int K>
struct Mma;

template <>
struct Mma<8, 4> {
  static constexpr int NA = 1, NB = 1, NC = 2;
  __device__ static void run(double* d, const double* a, const double* b) {
    asm volatile(
        "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, "
        "{%0,%1};\n"
        : "+d"(d[0]), "+d"(d[1])
        : "d"(a[0]), "d"(b[0]));
  }
};

template <>
struct Mma<16, 4> {
  static constexpr int NA = 2, NB = 1, NC = 4;
  __device__ static void run(double* d, const double* a, const double* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
        "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  }
};

template <>
struct Mma<16, 8> {
  static constexpr int NA = 4, NB = 2, NC = 4;
  __device__ static void run(double* d, const double* a, const double* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  }
};

template <>
struct Mma<16, 16> {
  static constexpr int NA = 8, NB = 4, NC = 4;
  __device__ static void run(double* d, const double* a, const double* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
          "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
};

// D (M x 8) = A (M x K, row-major) B (K x 8, row-major), one warp
template <int M, int K>
__global__ void layout_kernel(const double* A, const double* B, double* D) {
  using S = Mma<M, K>;
  const int lane = threadIdx.x, g = lane >> 2, t4 = lane & 3;
  double a[S::NA], b[S::NB], d[S::NC];
  for (int i = 0; i < S::NA; ++i)
    a[i] = A[(g + 8 * (i % 2)) * K + t4 + 4 * (i / 2)];
  for (int i = 0; i < S::NB; ++i) b[i] = B[(t4 + 4 * i) * 8 + g];
  for (int i = 0; i < S::NC; ++i) d[i] = 0.0;
  S::run(d, a, b);
  for (int i = 0; i < S::NC; ++i)
    D[(g + 8 * (i / 2)) * 8 + 2 * t4 + i % 2] = d[i];
}

// ACC independent accumulators per warp, `iters` MMAs on each (ACC = 1
// on one warp per scheduler measures the latency of one MMA)
template <int M, int K, int ACC>
__global__ void rate_kernel(int iters, double* out) {
  using S = Mma<M, K>;
  double a[S::NA], b[S::NB], d[ACC][S::NC];
  for (int i = 0; i < S::NA; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < S::NB; ++i) b[i] = 1e-3 * (blockIdx.x + i);
  for (int j = 0; j < ACC; ++j)
    for (int i = 0; i < S::NC; ++i) d[j][i] = 0.0;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < ACC; ++j) S::run(d[j], a, b);
  double s = 0.0;
  for (int j = 0; j < ACC; ++j)
    for (int i = 0; i < S::NC; ++i) s += d[j][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// `iters` f64 sincos of f32 arguments per thread, 4 independent chains,
// each result rounded to f32 and fed back as the next argument (mode 2)
__global__ void sincos_kernel(int iters, double* out) {
  float x[4];
  for (int j = 0; j < 4; ++j) x[j] = 1e-3f * (threadIdx.x + 37 * j) + 1.0f;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      double s, c;
      sincos((double)(x[j] * 187.0f), &s, &c);
      x[j] = (float)s + (float)c;
    }
  out[blockIdx.x * blockDim.x + threadIdx.x] = x[0] + x[1] + x[2] + x[3];
}

// the same chains through fourier_basis.cuh's fourier_pair (mode 5)
__global__ void pair_kernel(int iters, double* out) {
  float x[4];
  for (int j = 0; j < 4; ++j) x[j] = 1e-3f * (threadIdx.x + 37 * j) + 1.0f;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 sc = fourier_pair(187.0f, x[j]);
      x[j] = sc.x + sc.y + 1.5f;
    }
  out[blockIdx.x * blockDim.x + threadIdx.x] = x[0] + x[1] + x[2] + x[3];
}

// `iters` f32 -> f64 -> f32 round trips per thread, 8 independent chains
// (mode 3): two conversions each, plus an f64 add to keep them live
__global__ void cvt_kernel(int iters, double* out) {
  float x[8];
  for (int j = 0; j < 8; ++j) x[j] = 1e-3f * (threadIdx.x + j);
#pragma unroll 4
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = (float)((double)x[j] + 1e-300);
  double s = 0.0;
  for (int j = 0; j < 8; ++j) s += x[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int M, int K>
static int run_pair(int mode, const double* A, const double* B, double* D,
                    int blocks, int threads, int iters) {
  if (mode == 0)
    layout_kernel<M, K><<<1, 32>>>(A, B, D);
  else if (mode == 1)
    rate_kernel<M, K, 4><<<blocks, threads>>>(iters, D);
  else
    rate_kernel<M, K, 1><<<blocks, threads>>>(iters, D);
  return (int)cudaGetLastError();
}

// shape: 0 m8n8k4, 1 m16n8k4, 2 m16n8k8, 3 m16n8k16; mode 0: layout
// check (A, B in, D out), mode 1: MMA rate kernel, mode 2: sincos rate,
// mode 3: conversion rate, mode 4: MMA rate with one accumulator per warp,
// mode 5: fourier_pair's rate (D gets blocks * threads).
extern "C" int f64_rates_run(int shape, int mode, const double* A,
                             const double* B, double* D, int blocks,
                             int threads, int iters) {
  if (mode == 2) {
    sincos_kernel<<<blocks, threads>>>(iters, D);
    return (int)cudaGetLastError();
  }
  if (mode == 3) {
    cvt_kernel<<<blocks, threads>>>(iters, D);
    return (int)cudaGetLastError();
  }
  if (mode == 5) {
    pair_kernel<<<blocks, threads>>>(iters, D);
    return (int)cudaGetLastError();
  }
  switch (shape) {
    case 0: return run_pair<8, 4>(mode, A, B, D, blocks, threads, iters);
    case 1: return run_pair<16, 4>(mode, A, B, D, blocks, threads, iters);
    case 2: return run_pair<16, 8>(mode, A, B, D, blocks, threads, iters);
    case 3: return run_pair<16, 16>(mode, A, B, D, blocks, threads, iters);
  }
  return (int)cudaErrorInvalidValue;
}
