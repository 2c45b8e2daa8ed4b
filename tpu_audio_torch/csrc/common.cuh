// Shared device helpers for the tpu_audio_torch kernels: warp and block
// reductions. Built without --use_fast_math, so '/', sqrtf, expf, tanhf
// and log10f are the IEEE / full-accuracy versions the plain PyTorch
// references are compared against.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace tpa {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum (is_max=false) or max (is_max=true) over the block; every thread
// gets the result. `red` is __shared__ scratch of at least 32 floats.
// blockDim.x must be a multiple of 32.
__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float r = lane < nw ? red[lane] : (is_max ? -INFINITY : 0.0f);
    r = is_max ? warp_max(r) : warp_sum(r);
    if (lane == 0) red[0] = r;
  }
  __syncthreads();
  return red[0];
}

}  // namespace tpa

// ---------------------------------------------------------------------------
// Split-S single-query attention. A block takes one head and ATTN_CHUNK
// positions, and writes an unnormalised partial: the chunk's max score m,
// its sum of exp(score - m), and sum_s exp(score_s - m) * v[s, :]. One
// combine block per head rescales the partials to the global max and
// divides by the global sum. Spreading positions over many blocks keeps the
// whole card loading (one block per head would use H of 132 SMs).
// ---------------------------------------------------------------------------
namespace tpa {

constexpr int ATTN_CHUNK = 64;     // positions per block
constexpr int ATTN_THREADS = 128;  // a thread pair per position
constexpr int ATTN_HD = 64;        // head dim (every whisper size)

// Score: term(s, j) is head-dim element j's contribution to position s's
// dot product and finish(s, dot) the final score; Value: at(s, j).
// part_o [HD] and part_ml [2] are this block's slots. Every load of a
// thread is independent of its others (a thread pair per position for the
// scores, unrolled P.V), so they overlap instead of queuing one latency
// after another.
template <int HD, class Score, class Value>
__device__ void attn_partial(const Score& score, const Value& value, int s0,
                             int s1, float* part_o, float* part_ml) {
  static_assert(ATTN_THREADS == 2 * ATTN_CHUNK && ATTN_THREADS % HD == 0, "");
  constexpr int G = ATTN_THREADS / HD;  // position groups in P.V
  __shared__ float sc[ATTN_CHUNK];
  __shared__ float acc_part[G][HD];
  __shared__ float red[32];
  const int n = s1 - s0;
  const int i = threadIdx.x >> 1, half = threadIdx.x & 1;
  float dot = 0.0f;
  if (i < n) {
#pragma unroll
    for (int jj = 0; jj < HD / 2; ++jj) dot += score.term(s0 + i, half * (HD / 2) + jj);
  }
  dot += __shfl_xor_sync(0xffffffffu, dot, 1);
  const float s_i = i < n ? score.finish(s0 + i, dot) : -INFINITY;
  const float mx = block_reduce(s_i, red, true);
  float e = 0.0f;
  if (i < n && half == 0) {
    e = expf(s_i - mx);
    sc[i] = e;
  }
  const float sum = block_reduce(e, red, false);  // also publishes sc
  const int j = threadIdx.x % HD, g = threadIdx.x / HD;
  float acc = 0.0f;
#pragma unroll 8
  for (int k = g; k < n; k += G) acc += sc[k] * value.at(s0 + k, j);
  acc_part[g][j] = acc;
  __syncthreads();
  if (threadIdx.x < HD) {
    float o = 0.0f;
#pragma unroll
    for (int k = 0; k < G; ++k) o += acc_part[k][threadIdx.x];
    part_o[threadIdx.x] = o;
  }
  if (threadIdx.x == 0) {
    part_ml[0] = mx;
    part_ml[1] = sum;
  }
}

// Element j of one head's attention output from its nc partials, laid out
// [nc, hd] (part_o) and [nc, 2] (part_ml).
__device__ __forceinline__ float combine_partials(const float* __restrict__ part_o,
                                                  const float* __restrict__ ml,
                                                  int nc, int hd, int j) {
  float m = -INFINITY;
#pragma unroll 8
  for (int c = 0; c < nc; ++c) m = fmaxf(m, ml[2 * c]);
  float l = 0.0f, o = 0.0f;
#pragma unroll 8
  for (int c = 0; c < nc; ++c) {
    const float w = expf(ml[2 * c] - m);
    l += ml[2 * c + 1] * w;
    o += part_o[(size_t)c * hd + j] * w;
  }
  return o / l;
}

// out[h * hd + j] for head h = blockIdx.x, j = threadIdx.x (hd threads),
// from nc partials per head laid out [H, nc, hd] and [H, nc, 2].
static __global__ void attn_combine_kernel(const float* __restrict__ part_o,
                                           const float* __restrict__ part_ml,
                                           float* __restrict__ out, int nc,
                                           int hd) {
  const int h = blockIdx.x, j = threadIdx.x;
  out[(size_t)h * hd + j] = combine_partials(part_o + (size_t)h * nc * hd,
                                             part_ml + (size_t)h * nc * 2, nc, hd, j);
}

inline int attn_chunks(int n) { return (n + ATTN_CHUNK - 1) / ATTN_CHUNK; }

}  // namespace tpa
