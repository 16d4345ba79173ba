// fused_gram_wide's pass 1 in parts: the kernel's own block (WideBlock of
// pint_tpu_torch/csrc/fused_gram_wide.cu) at the kernel's launch
// geometry, running
//   mode 0: only its bulk copies (the converter warps wait for each stage
//           and release it; the MMA warps idle);
//   mode 1: only its conversion and MMA, with their Y-tile handoff, on raw
//           stages left in place (zeroed; no copy is issued);
//   mode 2: only its converter warps, with no handoff;
//   mode 3: only its MMA warps, with no handoff, over zeroed Y tiles;
// to time each part against the whole pass
// (profiling/torch_fused_gram_split.py).  The partials it writes mean
// nothing.

#include "../pint_tpu_torch/csrc/fused_gram_wide.cu"

template <typename TT, int ROWS, int MODE>
__global__ void __launch_bounds__(WTHREADS, 1)
    wide_part(const TT* __restrict__ T, const double* __restrict__ A,
              const double* __restrict__ w, long n, int k, int p1,
              int ytiles, int ngroups, int nbg_max, int nchunks,
              const int* __restrict__ table, double* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char smem[];
  WideBlock<TT, ROWS> b(smem, T, A, w, n, k, p1, ytiles, ngroups, nbg_max,
                        nchunks, table);
  if (MODE != 0)  // stages and Y tiles of zeros
    for (int i = threadIdx.x;
         i < (STAGES * b.stage + ytiles * ROWS * y_stride(nbg_max) * 4) / 16;
         i += WTHREADS)
      reinterpret_cast<double2*>(b.ring)[i] = make_double2(0.0, 0.0);
  __syncthreads();
  if (b.warp >= MMA_WARPS) {
    const bool producer = MODE == 0 && b.warp == MMA_WARPS && b.lane == 0;
    if (producer)
      for (int it = 0; it < min(STAGES, b.nits); ++it) b.produce(it);
    for (int it = 0; it < b.nits; ++it) {
      if (MODE == 0) {
        b.wait_full(it);
        b.release(it);
        if (producer && it + STAGES < b.nits) b.produce(it + STAGES);
      } else if (MODE == 1) {
        b.y_wait_free(it);
        b.convert(it);
        b.y_mark_whole(it);
      } else if (MODE == 2) {
        b.convert(it);
      }
    }
  } else {
    for (int it = 0; it < b.nits; ++it) {
      if (MODE == 1) b.y_wait_whole(it);
      if (MODE == 1 || MODE == 3) b.contract(it);
      if (MODE == 1) b.y_mark_free(it);
    }
    b.store(partial);
  }
}

template <typename TT, int ROWS, int MODE>
static int launch_part(const void* T, const double* A, const double* w,
                       int n, int k, int p1, int ytiles, int ngroups,
                       int nbg_max, int nbr, const int* table,
                       double* partial, cudaStream_t s) {
  const size_t smem = wide_smem(ROWS, ytiles, k, p1, (int)sizeof(TT), nbg_max);
  cudaError_t err = cudaFuncSetAttribute(
      wide_part<TT, ROWS, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  wide_part<TT, ROWS, MODE><<<ngroups * nbr, WTHREADS, smem, s>>>(
      static_cast<const TT*>(T), A, w, n, k, p1, ytiles, ngroups, nbg_max,
      (n + ROWS - 1) / ROWS, table, partial);
  return (int)cudaGetLastError();
}

template <typename TT, int ROWS>
static int launch_mode(const void* T, const double* A, const double* w,
                       int n, int k, int p1, int ytiles, int ngroups,
                       int nbg_max, int nbr, const int* table,
                       double* partial, int mode, cudaStream_t s) {
#define PART(M)                                                          \
  launch_part<TT, ROWS, M>(T, A, w, n, k, p1, ytiles, ngroups, nbg_max, \
                           nbr, table, partial, s)
  switch (mode) {
    case 0: return PART(0);
    case 1: return PART(1);
    case 2: return PART(2);
    case 3: return PART(3);
  }
#undef PART
  return (int)cudaErrorInvalidValue;
}

// Launches wide_part<., ., mode> with fused_gram_wide_launch's arguments
// (less the outputs); returns cudaGetLastError().
extern "C" int fused_gram_wide_part(const void* T, int t_is_f64,
                                    const double* A, const double* w, int n,
                                    int k, int p1, int rows, int ytiles,
                                    int ngroups, int nbg_max, int nbr,
                                    const int* table, double* partial,
                                    int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 32)
    return t_is_f64 ? launch_mode<double, 32>(T, A, w, n, k, p1, ytiles,
                                              ngroups, nbg_max, nbr, table,
                                              partial, mode, s)
                    : launch_mode<float, 32>(T, A, w, n, k, p1, ytiles,
                                             ngroups, nbg_max, nbr, table,
                                             partial, mode, s);
  return t_is_f64 ? launch_mode<double, 16>(T, A, w, n, k, p1, ytiles,
                                            ngroups, nbg_max, nbr, table,
                                            partial, mode, s)
                  : launch_mode<float, 16>(T, A, w, n, k, p1, ytiles,
                                           ngroups, nbg_max, nbr, table,
                                           partial, mode, s);
}
