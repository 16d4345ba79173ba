// fourier_gram's pass 1 in halves: the kernel's own block (GramBlock of
// pint_tpu_torch/csrc/fourier_gram.cu) running only its basis staging, or
// only its MMA over a zeroed ring, at the kernel's launch geometry, to
// time each half against the whole pass
// (profiling/torch_fourier_split.py).  The partials it writes mean
// nothing.

#include "../pint_tpu_torch/csrc/fourier_gram.cu"

template <bool STAGE>
__global__ void __launch_bounds__(THREADS, 2)
    pass1_half(const double* __restrict__ t, const double* __restrict__ freqs,
               const double* __restrict__ w, const double* __restrict__ X,
               int n, int k, int p, int kb, int q_pad, int nchunks,
               int ntiles, double* __restrict__ partial) {
  extern __shared__ double smem[];
  GramBlock b(smem, t, freqs, w, X, n, k, p, kb, q_pad, ntiles);
  if (!STAGE) {  // the MMA alone reads a ring of zeros
    float* ring = reinterpret_cast<float*>(b.ring);
    for (int i = b.tid; i < 2 * b.slot / (int)sizeof(float); i += THREADS)
      ring[i] = 0.0f;
  }
  __syncthreads();
  const long c0 = chunk_first(nchunks);
  const int nits = chunk_count(nchunks);
  if (STAGE) b.stage(c0, 0);
  __syncthreads();
  for (int it = 0; it < nits; ++it) {
    if (!STAGE)
      b.contract(it & 1);
    else if (it + 1 < nits)
      b.stage(c0 + it + 1, (it & 1) ^ 1);
    __syncthreads();
  }
  b.store(partial, ntiles);
}

// Launches pass1_half<stage_only != 0> with fourier_gram_launch's
// arguments (less Sigma and TWX); returns cudaGetLastError().
extern "C" int fourier_gram_half(const double* t, const double* freqs,
                                 const double* w, const double* X, int n,
                                 int k, int p, int kb, int q_pad, int nb,
                                 int ny, int threads, double* partial,
                                 int stage_only, void* stream) {
  int ntiles;
  if (!check_shape(n, k, p, kb, q_pad, nb, ny, threads, &ntiles))
    return (int)cudaErrorInvalidValue;
  const auto kernel = stage_only ? pass1_half<true> : pass1_half<false>;
  const size_t smem = pass1_smem(kb, q_pad);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(nb, ny), THREADS, smem, s>>>(t, freqs, w, X, n, k, p, kb,
                                             q_pad, (n + SUB - 1) / SUB,
                                             ntiles, partial);
  return (int)cudaGetLastError();
}
