// fused_gram_joint's pass 1 in parts: the kernel's own block (FusedBlock
// of pint_tpu_torch/csrc/fused_gram_joint.cu) at the kernel's launch
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

#include "../pint_tpu_torch/csrc/fused_gram_joint.cu"

template <typename TT, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    pass1_part(const TT* __restrict__ T, const double* __restrict__ A,
               const double* __restrict__ w, long n, int k, int p1,
               int nchunks, double* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char smem[];
  FusedBlock<TT> b(smem, T, A, w, n, k, p1, nchunks);
  if (MODE != 0)  // stages and Y tiles of zeros
    for (int i = threadIdx.x;
         i < (STAGES * b.stage + YTILES * ROWS * b.S * 8) / 16; i += THREADS)
      reinterpret_cast<double2*>(b.ring)[i] = make_double2(0.0, 0.0);
  __syncthreads();
  if (b.warp >= GROUP) {
    const bool producer = MODE == 0 && b.warp == GROUP && b.lane == 0;
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

template <typename TT, int MODE>
static int launch_part(const void* T, const double* A, const double* w,
                       int n, int k, int p1, int nb, double* partial,
                       cudaStream_t s) {
  const size_t smem = pass1_smem(k, p1, (int)sizeof(TT));
  cudaError_t err = cudaFuncSetAttribute(
      pass1_part<TT, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  pass1_part<TT, MODE><<<nb, THREADS, smem, s>>>(
      static_cast<const TT*>(T), A, w, n, k, p1, (n + ROWS - 1) / ROWS,
      partial);
  return (int)cudaGetLastError();
}

template <typename TT>
static int launch_mode(const void* T, const double* A, const double* w,
                       int n, int k, int p1, int nb, double* partial,
                       int mode, cudaStream_t s) {
  switch (mode) {
    case 0: return launch_part<TT, 0>(T, A, w, n, k, p1, nb, partial, s);
    case 1: return launch_part<TT, 1>(T, A, w, n, k, p1, nb, partial, s);
    case 2: return launch_part<TT, 2>(T, A, w, n, k, p1, nb, partial, s);
    case 3: return launch_part<TT, 3>(T, A, w, n, k, p1, nb, partial, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Launches pass1_part<., mode> with fused_gram_joint_launch's arguments
// (less the outputs); returns cudaGetLastError().
extern "C" int fused_gram_part(const void* T, int t_is_f64, const double* A,
                               const double* w, int n, int k, int p1,
                               int q_pad, int nb, int threads,
                               double* partial, int mode, void* stream) {
  if (!check_shape(T, A, w, n, k, p1, q_pad, nb, threads, 1,
                   t_is_f64 ? 8 : 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return t_is_f64 ? launch_mode<double>(T, A, w, n, k, p1, nb, partial,
                                        mode, s)
                  : launch_mode<float>(T, A, w, n, k, p1, nb, partial, mode,
                                       s);
}
