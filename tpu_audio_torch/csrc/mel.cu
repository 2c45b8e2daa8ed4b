// Fused log-mel projection: out[t, m] = log10(max(sum_f (re^2 + im^2)[t, f]
// * filters[f, m], 1e-10)).
//
// Replaces tpu_audio/ops/pallas_mel.py:fused_log_mel (pallas_call at :72).
// The global max - 8 clamp and the (x + 4) / 4 normalisation stay outside,
// as in the JAX package, because they need a max across all frames.
//
// Bound on the H100: at whisper-large-v3's frontend (T = 3000 frames,
// F = 201 bins, M = 128 mels) the product is 2*3000*201*128 = 154 MFLOP and
// the traffic 2*3000*201*4 B in + 103 KB of filters + 1.5 MB out, about
// 6.4 MB: a few microseconds of either roofline, so launch latency and
// occupancy bound it, not bytes or FLOPs.
//
// Design: one block per tile of TILE_T frames. The block squares the tile's
// spectrum into shared memory once; each thread then owns one mel column and
// keeps TILE_T f32 accumulators, reading the filter column from global
// memory (neighbouring threads read neighbouring mels: coalesced, and the
// 103 KB filterbank stays in L1/L2 across blocks). f32 throughout, no
// cuBLAS, no tensor cores: the product is too small for them to matter.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int TILE_T = 16;

__global__ void fused_log_mel_kernel(const float* __restrict__ re,
                                     const float* __restrict__ im,
                                     const float* __restrict__ fb,
                                     float* __restrict__ out, int T, int F,
                                     int M) {
  extern __shared__ float power[];  // [TILE_T, F]
  const int t0 = blockIdx.x * TILE_T;
  const int nt = min(TILE_T, T - t0);
  for (int i = threadIdx.x; i < TILE_T * F; i += blockDim.x) {
    const int tt = i / F;
    float p = 0.0f;
    if (tt < nt) {
      const size_t at = (size_t)(t0 + tt) * F + (i - tt * F);
      const float r = re[at], m = im[at];
      p = r * r + m * m;
    }
    power[i] = p;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    float acc[TILE_T];
#pragma unroll
    for (int tt = 0; tt < TILE_T; ++tt) acc[tt] = 0.0f;
    for (int f = 0; f < F; ++f) {
      const float w = fb[(size_t)f * M + m];
#pragma unroll
      for (int tt = 0; tt < TILE_T; ++tt) acc[tt] += power[tt * F + f] * w;
    }
    for (int tt = 0; tt < nt; ++tt)
      out[(size_t)(t0 + tt) * M + m] = log10f(fmaxf(acc[tt], 1e-10f));
  }
}

}  // namespace

extern "C" int tpa_fused_log_mel(const float* re, const float* im,
                                 const float* fb, float* out, int T, int F,
                                 int M, cudaStream_t stream) {
  const int threads = 128;
  const dim3 grid((T + TILE_T - 1) / TILE_T);
  const size_t smem = sizeof(float) * TILE_T * F;
  fused_log_mel_kernel<<<grid, threads, smem, stream>>>(re, im, fb, out, T, F,
                                                        M);
  return (int)cudaGetLastError();
}

extern "C" const char* tpa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
