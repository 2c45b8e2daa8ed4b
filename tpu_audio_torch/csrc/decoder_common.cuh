// Device pieces shared by the two Whisper decoder stacks: the one-token
// stack (fused_decoder.cu) and the serving lanes stack
// (fused_decoder_lanes.cu). Both compute every per-row quantity with these
// same functions, in the same order, so a serving lane agrees with the
// one-token kernel on the same inputs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace tpa {

constexpr int GEMV_THREADS = 256;

enum GemvMode { STORE = 0, GELU = 1, ADD = 2 };

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// The int8 input of a GEMV: LayerNorm (eps 1e-5) of x [K] when ln_w is
// given, else x itself, into xf [K]; then codes xq [K] = round-half-even of
// xf / xs on a true division, clamped to +-127, with xs = max(max|xf| / 127,
// 1e-12). Returns xs. Every thread of a GEMV_THREADS block calls it; on
// return the codes are visible to the whole block. `red` is __shared__
// scratch of 32 floats.
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

// Cross-attention score/value of one head over int8 position-major K/V with
// one f32 scale per position: score = (code . q*sm) * ks[s]; the V scale is
// folded into the value.
struct CrossScore {
  const float* q;
  const int8_t* ck;
  const float* ks;
  int d;
  float sm;
  __device__ float term(int s, int j) const {
    return (float)ck[(size_t)s * d + j] * (q[j] * sm);
  }
  __device__ float finish(int s, float dot) const { return dot * ks[s]; }
};

struct CrossValue {
  const int8_t* cv;
  const float* vs;
  int d;
  __device__ float at(int s, int j) const {
    return vs[s] * (float)cv[(size_t)s * d + j];
  }
};

}  // namespace tpa
