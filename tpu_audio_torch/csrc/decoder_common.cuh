// Device pieces shared by the decoder stacks: Whisper's one-token stack
// (fused_decoder.cu) and serving lanes stack (fused_decoder_lanes.cu), and
// the Llama stack (fused_llama.cu). The Whisper stacks compute every
// per-row quantity with these same functions, in the same order, so a
// serving lane agrees with the one-token kernel on the same inputs.
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

// ---------------------------------------------------------------------------
// int8 GEMV over pre-quantised inputs, one weight row per warp.
// ---------------------------------------------------------------------------

// out[m * ldo + o] (=, or +=) epilogue(sum_i xq[m, i] * w[o, i]) for o < N
// and every lane m < n (n <= NL).
template <int MODE, int NL>
static __global__ void __launch_bounds__(GEMV_THREADS)
int8_gemv_lanes_kernel(const int8_t* __restrict__ xq_g,
                       const float* __restrict__ xs,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ w_scale,
                       const float* __restrict__ bias, float* __restrict__ out,
                       int ldo, int N, int K, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int4* xv = reinterpret_cast<int4*>(smem_raw);  // [n, K / 16]
  const int nvec = K / 16;
  const int4* src = reinterpret_cast<const int4*>(xq_g);
  for (int i = threadIdx.x; i < n * nvec; i += GEMV_THREADS) xv[i] = src[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = GEMV_THREADS / 32;
  for (int row = blockIdx.x * nwarps + warp; row < N; row += gridDim.x * nwarps) {
    const int4* wv = reinterpret_cast<const int4*>(w + (size_t)row * K);
    int acc[NL];
#pragma unroll
    for (int m = 0; m < NL; ++m) acc[m] = 0;
    for (int c = lane; c < nvec; c += 32) {
      const int4 a = __ldg(wv + c);  // each weight row is read once for all lanes
#pragma unroll
      for (int m = 0; m < NL; ++m) {
        if (m < n) {
          const int4 b = xv[m * nvec + c];
          acc[m] = __dp4a(a.x, b.x, acc[m]);
          acc[m] = __dp4a(a.y, b.y, acc[m]);
          acc[m] = __dp4a(a.z, b.z, acc[m]);
          acc[m] = __dp4a(a.w, b.w, acc[m]);
        }
      }
    }
    const float ws = w_scale[row];
#pragma unroll
    for (int m = 0; m < NL; ++m) {
      if (m < n) {
        const int s = tpa::warp_sum_int(acc[m]);
        if (lane == 0)
          tpa::gemv_epilogue<MODE>(s, ws, xs[m], bias != nullptr ? bias + row : nullptr,
                                   out + (size_t)m * ldo + row);
      }
    }
  }
}

template <int MODE, int NL>
static cudaError_t gemv_lanes_nl(const int8_t* xq, const float* xs, const int8_t* w,
                          const float* scale, const float* bias, float* out,
                          int ldo, int N, int K, int n, cudaStream_t stream) {
  const auto kernel = int8_gemv_lanes_kernel<MODE, NL>;
  const size_t smem = (size_t)n * K;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int rows_per_block = GEMV_THREADS / 32;
  const int blocks = (N + rows_per_block - 1) / rows_per_block;
  kernel<<<blocks, GEMV_THREADS, smem, stream>>>(xq, xs, w, scale, bias, out,
                                                 ldo, N, K, n);
  return cudaSuccess;
}

// The accumulator count is a template parameter so the sums stay in
// registers; n picks the smallest of 1, 2, 4, 8, 16, 32 that holds it.
template <int MODE>
static cudaError_t gemv_lanes(const int8_t* xq, const float* xs, const int8_t* w,
                       const float* scale, const float* bias, float* out, int ldo,
                       int N, int K, int n, cudaStream_t stream) {
  if (n <= 1) return gemv_lanes_nl<MODE, 1>(xq, xs, w, scale, bias, out, ldo, N, K, n, stream);
  if (n <= 2) return gemv_lanes_nl<MODE, 2>(xq, xs, w, scale, bias, out, ldo, N, K, n, stream);
  if (n <= 4) return gemv_lanes_nl<MODE, 4>(xq, xs, w, scale, bias, out, ldo, N, K, n, stream);
  if (n <= 8) return gemv_lanes_nl<MODE, 8>(xq, xs, w, scale, bias, out, ldo, N, K, n, stream);
  if (n <= 16) return gemv_lanes_nl<MODE, 16>(xq, xs, w, scale, bias, out, ldo, N, K, n, stream);
  return gemv_lanes_nl<MODE, MAX_LANES>(xq, xs, w, scale, bias, out, ldo, N, K, n, stream);
}

}  // namespace tpa
