// The staged GQA attention of the Llama stacks' attention launches, shared
// by the one-token and serving lanes kernels (fused_llama.cu,
// fused_llama_lanes.cu): a block stages a 64-position chunk of one KV head's
// K and V rows in shared memory and computes the query heads sharing them in
// groups of 128 threads, each with tpa::attn_partial's order of sums and
// reduction tree over tpa::SelfScore / SelfValue's arithmetic. Each file's
// __global__ wrapper reads its offsets its own way.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "decoder_common.cuh"

namespace {

constexpr int HD = tpa::LLAMA_HD;
constexpr int CH = tpa::ATTN_CHUNK;
constexpr int KV_LD = HD + 8;  // bf16 a staged V row

constexpr int AT = tpa::ATTN_THREADS;  // threads of one query head's group
constexpr int MAX_GROUP = 4;           // query heads an attention block computes at once
// The staged K rows of a chunk, as two tables of half rows (64 bf16 and 8
// of padding a row, the second table 4 16-byte units past the first's
// end): the 16-byte loads of the score loop, a thread pair a position,
// then fall in distinct banks.
constexpr int K_LD = HD / 2 + 8;
constexpr int K_HALF = CH * K_LD + 32;

// The two bf16 of a 32-bit word as f32 (__bfloat162float): the one at the
// lower address, and the other.
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// tpa::block_reduce over the AT threads of one query head's group of a block
// of several such groups (`red`: that group's 32 floats), every thread of
// the block calling it at once: the same tree as block_reduce in an AT-thread
// block.
__device__ __forceinline__ float group_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x % AT) >> 5;
  constexpr int nw = AT / 32;
  v = is_max ? tpa::warp_max(v) : tpa::warp_sum(v);
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float r = lane < nw ? red[lane] : (is_max ? -INFINITY : 0.0f);
    r = is_max ? tpa::warp_max(r) : tpa::warp_sum(r);
    if (lane == 0) red[0] = r;
  }
  __syncthreads();
  return red[0];
}

// tpa::attn_partial<HD> with tpa::SelfScore / SelfValue for one query head
// q (f32), over the staged rows s0.. of a chunk (K in the half tables sk, V
// rows of KV_LD in sv) and the current token's f32 k_new / v_new at row
// `offset`, by the head's group of AT threads of a block whose groups all
// call it at once. The same order of sums and reduction tree: a thread pair
// a position, each term k * (q * sm) in jj order (K and q read 16 bytes at a
// time); max and sum by group_reduce; P.V with k ascending (the
// probabilities read 16 bytes at a time); the group's one position group
// summed onto 0. sc [CH] (16-byte aligned) and red [32] are the group's own.
__device__ void group_partial(const float* q, const float* k_new, const float* v_new,
                              const __nv_bfloat16* sk, const __nv_bfloat16* sv, int s0,
                              int s1, int offset, float sm, float* sc, float* red,
                              float* part_o, float* part_ml) {
  static_assert(AT == HD && AT == 2 * CH, "one thread a head dim, a pair a position");
  const int t = threadIdx.x % AT;
  const int n = s1 - s0;
  const int i = t >> 1, half = t & 1;
  const float* qh = q + half * (HD / 2);
  float dot = 0.0f;
  if (i < n) {
    if (s0 + i == offset) {
      const float* kh = k_new + half * (HD / 2);
#pragma unroll
      for (int jj = 0; jj < HD / 2; ++jj) dot += kh[jj] * (qh[jj] * sm);
    } else {
      const uint4* k8 = reinterpret_cast<const uint4*>(sk + half * K_HALF + i * K_LD);
      const float4* q4 = reinterpret_cast<const float4*>(qh);
#pragma unroll
      for (int u = 0; u < HD / 16; ++u) {
        const uint4 kk = k8[u];
        const float4 qa = q4[2 * u], qb = q4[2 * u + 1];
        dot += bf16_lo(kk.x) * (qa.x * sm);
        dot += bf16_hi(kk.x) * (qa.y * sm);
        dot += bf16_lo(kk.y) * (qa.z * sm);
        dot += bf16_hi(kk.y) * (qa.w * sm);
        dot += bf16_lo(kk.z) * (qb.x * sm);
        dot += bf16_hi(kk.z) * (qb.y * sm);
        dot += bf16_lo(kk.w) * (qb.z * sm);
        dot += bf16_hi(kk.w) * (qb.w * sm);
      }
    }
  }
  dot += __shfl_xor_sync(0xffffffffu, dot, 1);
  const float s_i = i < n ? dot : -INFINITY;
  const float mx = group_reduce(s_i, red, true);
  float e = 0.0f;
  if (i < n && half == 0) {
    e = expf(s_i - mx);
    sc[i] = e;
  }
  const float sum = group_reduce(e, red, false);  // also publishes sc
  float acc = 0.0f;
  const float4* sc4 = reinterpret_cast<const float4*>(sc);
#pragma unroll 2
  for (int k4 = 0; k4 < n; k4 += 4) {
    const float4 p4 = sc4[k4 / 4];
    const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k4 + u;
      if (k < n)
        acc += p[u] * (s0 + k == offset ? v_new[t] : __bfloat162float(sv[k * KV_LD + t]));
    }
  }
  float o = 0.0f;
  o += acc;
  part_o[t] = o;
  if (t == 0) {
    part_ml[0] = mx;
    part_ml[1] = sum;
  }
}

}  // namespace
