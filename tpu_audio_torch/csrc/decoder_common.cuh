// Device pieces shared by the decoder stacks: Whisper's one-token stack
// (fused_decoder.cu) and serving lanes stack (fused_decoder_lanes.cu), and
// the Llama one-token and serving lanes stacks (fused_llama.cu,
// fused_llama_lanes.cu). Each pair computes every per-row quantity with
// these same functions, in the same order, so a serving lane agrees with
// the one-token kernel on the same inputs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace tpa {

constexpr int GEMV_THREADS = 256;
constexpr int MAX_LANES = 32;  // int32 accumulators a GEMV thread keeps

enum GemvMode { STORE = 0, GELU = 1, ADD = 2 };

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// int8 codes xq [K] = round-half-even of xf / xs on a true division,
// clamped to +-127, with xs = max(max|xf| / 127, 1e-12) for the f32 row xf
// [K] each thread has written its share of (i = tid, tid + GEMV_THREADS,
// ...). Returns xs; on return the codes are visible to the whole block.
__device__ __forceinline__ float quantize_staged_row(const float* xf, int8_t* xq,
                                                     int K, float* red) {
  const int tid = threadIdx.x;
  float amax = 0.0f;
  for (int i = tid; i < K; i += GEMV_THREADS) amax = fmaxf(amax, fabsf(xf[i]));
  amax = block_reduce(amax, red, true);  // also orders the xf writes
  const float xs = fmaxf(amax / 127.0f, 1e-12f);
  for (int i = tid; i < K; i += GEMV_THREADS) {
    const float qv = fminf(fmaxf(rintf(xf[i] / xs), -127.0f), 127.0f);
    xq[i] = (int8_t)qv;
  }
  __syncthreads();
  return xs;
}

// The int8 input of a GEMV: LayerNorm (eps 1e-5) of x [K] when ln_w is
// given, else x itself, into xf [K]; then its codes xq [K] and scale (the
// return value) by quantize_staged_row. Every thread of a GEMV_THREADS
// block calls it. `red` is __shared__ scratch of 32 floats.
__device__ __forceinline__ float ln_quantize_row(const float* __restrict__ x,
                                                 const float* __restrict__ ln_w,
                                                 const float* __restrict__ ln_b,
                                                 float* xf, int8_t* xq, int K,
                                                 float* red) {
  const int tid = threadIdx.x;
  if (ln_w != nullptr) {
    float s = 0.0f;
    for (int i = tid; i < K; i += GEMV_THREADS) s += x[i];
    const float mean = block_reduce(s, red, false) / (float)K;
    float v = 0.0f;
    for (int i = tid; i < K; i += GEMV_THREADS) {
      const float z = x[i] - mean;
      v += z * z;
    }
    const float var = block_reduce(v, red, false) / (float)K;
    const float rstd = 1.0f / sqrtf(var + 1e-5f);
    for (int i = tid; i < K; i += GEMV_THREADS)
      xf[i] = (x[i] - mean) * rstd * ln_w[i] + ln_b[i];
  } else {
    for (int i = tid; i < K; i += GEMV_THREADS) xf[i] = x[i];
  }
  return quantize_staged_row(xf, xq, K, red);
}

// GEMV epilogue of one output: acc * (w_scale * xs) + bias, then tanh-GELU
// (GELU) or added into *out (ADD), else stored.
template <int MODE>
__device__ __forceinline__ void gemv_epilogue(int acc, float w_scale, float xs,
                                              const float* bias, float* out) {
  float val = __fmul_rn((float)acc, __fmul_rn(w_scale, xs));
  if (bias != nullptr) val = __fadd_rn(val, *bias);
  if (MODE == GELU) val = gelu_tanh(val);
  if (MODE == ADD) *out = __fadd_rn(*out, val);
  else *out = val;
}

// Self-attention score/value of one head: cache rows below `offset` (bf16),
// the current token's f32 k/v at `offset`.
struct SelfScore {
  const float* q;
  const float* k_new;
  const __nv_bfloat16* kc;
  int offset, d;
  float sm;
  __device__ float term(int s, int j) const {
    const float k = s == offset ? k_new[j] : __bfloat162float(kc[(size_t)s * d + j]);
    return k * (q[j] * sm);
  }
  __device__ float finish(int, float dot) const { return dot; }
};

struct SelfValue {
  const float* v_new;
  const __nv_bfloat16* vc;
  int offset, d;
  __device__ float at(int s, int j) const {
    return s == offset ? v_new[j] : __bfloat162float(vc[(size_t)s * d + j]);
  }
};

// ---------------------------------------------------------------------------
// The Llama stacks' per-token pieces: the one-token kernel (fused_llama.cu)
// and the serving lanes kernel (fused_llama_lanes.cu) run each lane row
// through these same functions, so a lane agrees bit for bit with the
// one-token kernel on the same inputs.
// ---------------------------------------------------------------------------

constexpr int LLAMA_HD = 128;  // head dim
constexpr int QUANT_PLAIN = 0, QUANT_RMS = 1, QUANT_SWIGLU = 2;

// A Llama GEMV input: xf = RMSNorm(x) * w (QUANT_RMS), x (QUANT_PLAIN) or
// silu(x[:K]) * x[K:2K] (QUANT_SWIGLU) into xf [K], then its int8 codes xq
// [K] and scale (the return value) by quantize_staged_row. Every thread of
// a GEMV_THREADS block calls it.
__device__ __forceinline__ float llama_quantize_row(const float* __restrict__ x,
                                                    const float* __restrict__ w,
                                                    int mode, float eps, float* xf,
                                                    int8_t* xq, int K, float* red) {
  const int tid = threadIdx.x;
  if (mode == QUANT_RMS) {
    float ss = 0.0f;
    for (int i = tid; i < K; i += GEMV_THREADS) ss += x[i] * x[i];
    const float ms = block_reduce(ss, red, false) / (float)K;
    const float r = 1.0f / sqrtf(ms + eps);
    for (int i = tid; i < K; i += GEMV_THREADS) xf[i] = x[i] * r * w[i];
  } else if (mode == QUANT_SWIGLU) {
    for (int i = tid; i < K; i += GEMV_THREADS) {
      const float g = x[i];
      xf[i] = g * (1.0f / (1.0f + expf(-g))) * x[K + i];
    }
  } else {
    for (int i = tid; i < K; i += GEMV_THREADS) xf[i] = x[i];
  }
  return quantize_staged_row(xf, xq, K, red);
}

// Head b of one token's q/k/v row qkv = [q (d), k (dkv), v (dkv)], in
// place, by a block of LLAMA_HD threads: b < heads is q head b, else k head
// b - heads. The optional per-head RMSNorm (qn_w / kn_w, null without
// qk_norm; the weights broadcast over the heads), then half-split RoPE at
// angle float(offset) * inv_freq (full-range sincosf). The k heads also
// write the rotated k row and the v row of their head, as bf16, into the
// cache rows kc_row / vc_row.
__device__ __forceinline__ void llama_rope_head(float* qkv, const float* qn_w,
                                                const float* kn_w,
                                                const float* __restrict__ inv_freq,
                                                __nv_bfloat16* kc_row,
                                                __nv_bfloat16* vc_row, int d, int dkv,
                                                int heads, float eps, int offset, int b) {
  constexpr int HD = LLAMA_HD;
  __shared__ float sh[HD];
  __shared__ float red[32];
  const int j = threadIdx.x;
  const bool is_k = b >= heads;
  const int col = is_k ? d + (b - heads) * HD : b * HD;
  float v = qkv[col + j];
  const float* nw = is_k ? kn_w : qn_w;
  if (nw != nullptr) {
    const float ms = block_reduce(v * v, red, false) / (float)HD;
    v = v * (1.0f / sqrtf(ms + eps)) * nw[col - (is_k ? d : 0) + j];
  }
  sh[j] = v;
  __syncthreads();
  const float rot = sh[(j + HD / 2) % HD];
  float sn, cs;
  sincosf((float)offset * inv_freq[j % (HD / 2)], &sn, &cs);
  const float sign = j < HD / 2 ? -1.0f : 1.0f;
  const float out = v * cs + rot * (sign * sn);
  qkv[col + j] = out;
  if (is_k) {
    const int g = (b - heads) * HD + j;
    kc_row[g] = __float2bfloat16(out);
    vc_row[g] = __float2bfloat16(qkv[d + dkv + g]);
  }
}

// ---------------------------------------------------------------------------
// Whisper's attention over staged rows: the one-token and serving lanes
// stacks (fused_decoder.cu, fused_decoder_lanes.cu) copy a block's 64
// positions of one head into shared memory with 16-byte cp.async and run
// attn_partial on these types.
// ---------------------------------------------------------------------------

constexpr int SELF_LD = ATTN_HD + 8;    // bf16 a staged self-cache row
constexpr int CROSS_LD = ATTN_HD + 16;  // int8 a staged cross K/V row

// Self-attention score/value of one head over the staged cache rows s0..
// (bf16, SELF_LD a row), the current token's f32 k/v at `offset`: the
// arithmetic of tpa::SelfScore / SelfValue.
struct StagedSelfScore {
  const float* q;
  const float* k_new;
  const __nv_bfloat16* kc;
  int s0, offset;
  float sm;
  __device__ float term(int s, int j) const {
    const float k = s == offset ? k_new[j] : __bfloat162float(kc[(s - s0) * SELF_LD + j]);
    return k * (q[j] * sm);
  }
  __device__ float finish(int, float dot) const { return dot; }
};

struct StagedSelfValue {
  const float* v_new;
  const __nv_bfloat16* vc;
  int s0, offset;
  __device__ float at(int s, int j) const {
    return s == offset ? v_new[j] : __bfloat162float(vc[(s - s0) * SELF_LD + j]);
  }
};

// Cross-attention score/value of one head over the staged int8 rows s0..
// (CROSS_LD a row) and their staged scales: tpa::CrossScore / CrossValue's
// arithmetic.
struct StagedCrossScore {
  const float* q;
  const int8_t* ck;
  const float* ks;
  int s0;
  float sm;
  __device__ float term(int s, int j) const {
    return (float)ck[(s - s0) * CROSS_LD + j] * (q[j] * sm);
  }
  __device__ float finish(int s, float dot) const { return dot * ks[s - s0]; }
};

struct StagedCrossValue {
  const int8_t* cv;
  const float* vs;
  int s0;
  __device__ float at(int s, int j) const {
    return vs[s - s0] * (float)cv[(s - s0) * CROSS_LD + j];
  }
};

}  // namespace tpa
