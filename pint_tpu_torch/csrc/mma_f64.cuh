// mma_f64.cuh: the f64 tensor-core MMAs of the port's kernels
// (fused_gram_joint.cu, fourier_gram.cu, fourier_apply.cu).
//
// d += A B for one 16 x 8 x K f64 MMA: the sm_90 shapes K = 4 and 16
// run at the card's 67 TFLOP/s f64 tensor-core rate, twice m8n8k4's
// (profiling/f64_rates.py, PERF.md).  Each product is exact and each
// sum an f64 add.  PTX ISA fragment layout, g = lane / 4, t4 = lane % 4:
//   a[i] = A[g + 8 (i % 2)][t4 + 4 (i / 2)],  i < K / 2,
//   b[i] = B[t4 + 4 i][g],                    i < K / 4,
//   d[i] = D[g + 8 (i / 2)][2 t4 + i % 2].

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void mma_f64_k4(double (&d)[4], const double* a,
                                           const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}

__device__ __forceinline__ void mma_f64_k16(double (&d)[4], const double* a,
                                            const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}
