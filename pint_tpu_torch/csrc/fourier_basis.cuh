// fourier_basis.cuh: the red-noise basis value of one (TOA row, harmonic),
// shared by fourier_gram.cu and fourier_apply.cu, so one bitwise check of
// either kernel's basis (chip_smoke.py's, through fourier_apply with
// identity columns) holds both.
//
// The value is the reference's f32 basis (ops/fourier.py::basis32):
//   arg = (f32(2 pi) * f32(f_j)) * f32(t_i)   in f32, in that order,
//   (sin, cos) = the f32 roundings of the f64 sin and cos of arg.
// Both products are __fmul_rn, which the compiler never contracts into
// an FMA.  The f64 sincos of an f32 argument, rounded to f32, is the
// correctly rounded f32 value but for ties within a few f64 ulps (~1e-8
// of values), so the basis is the same on every device (the CPU's f64
// torch.sin and torch.cos give the same f32 values).  Never the
// __sinf/__cosf intrinsics, never sincosf, never --use_fast_math.
//
// Cost: libdevice's f64 sincos, one call for both values: 3.66e11 pairs
// a second on the whole H100, ~8.2 us for the bench shape's 3e6
// (profiling/f64_rates.py, PERF.md).  For the fit's arguments (|arg| <=
// 2 pi k, ~400 at k = 64: models/noise.py measures t from the first TOA
// and sets f_j = j / T_span) it takes its Cody-Waite branch: the
// reduction by pi/2 (a round to integer and its conversions, three
// FMAs) and two polynomials, ~30 f64 operations a pair; larger arguments
// take its Payne-Hanek branch, so any t is right.

#pragma once

#include <cuda_runtime.h>

// f32(2 pi)
#define FOURIER_TWO_PI_F32 ((float)6.283185307179586)

// The harmonic's f32 angular frequency f32(2 pi) * f32(f_j).
__device__ __forceinline__ float fourier_omega(double f) {
  return __fmul_rn(FOURIER_TWO_PI_F32, (float)f);
}

// The (sin, cos) f32 pair of one (row, harmonic): omega from
// fourier_omega, t the row's f32 time.
__device__ __forceinline__ float2 fourier_pair(float omega, float t) {
  double s, c;
  sincos((double)__fmul_rn(omega, t), &s, &c);
  return make_float2((float)s, (float)c);
}

// Row stride, in 4-byte words, of a shared f32 tile that a warp reads as
// an MMA operand by rows (lane (g, t4) reads row t4 and column 8 I + g):
// a multiple of 8 that is 8 mod 16, so the 4 rows fall on 4 disjoint
// sets of 8 banks.
__host__ __device__ inline int fourier_mma_stride(int cols8) {
  return cols8 % 16 == 0 ? cols8 + 8 : cols8;
}
