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

// Row m = blockIdx.x of x (row stride ldx): the int8 codes xq[m, :K] and
// scale xs[m] of a GEMV input (llama_quantize_row); the staged f32 row
// takes K floats of dynamic shared memory.
static __global__ void rms_quantize_rows_kernel(const float* __restrict__ x, int ldx,
                                                const float* __restrict__ w, int mode,
                                                float eps, int8_t* __restrict__ xq,
                                                float* __restrict__ xs, int K) {
  extern __shared__ float xf[];  // [K]
  __shared__ float red[32];
  const int m = blockIdx.x;
  const float s = llama_quantize_row(x + (size_t)m * ldx, w, mode, eps, xf,
                                     xq + (size_t)m * K, K, red);
  if (threadIdx.x == 0) xs[m] = s;
}

// rms_quantize_rows_kernel over n rows, past 48 KB of shared memory by
// opt-in (up to the 227 KB a block may have).
static cudaError_t quantize_rows(const float* x, int ldx, const float* w, int mode,
                                 float eps, int8_t* xq, float* xs, int K, int n,
                                 cudaStream_t stream) {
  const size_t smem = (size_t)K * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rms_quantize_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  rms_quantize_rows_kernel<<<n, GEMV_THREADS, smem, stream>>>(x, ldx, w, mode, eps, xq,
                                                              xs, K);
  return cudaSuccess;
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

// Chunk c (ATTN_CHUNK positions from valid_from) of split-S GQA attention
// for query head h, which reads K/V head h / rep, of one token's rotated
// qkv over one layer's position-major bf16 caches kc/vc [s_max, dkv]
// (K after RoPE); the token's own f32 k/v stand at row offset. Writes the
// block's partial to part_o [LLAMA_HD] and part_ml [2].
__device__ __forceinline__ void llama_attn_partial(const float* __restrict__ qkv,
                                                   const __nv_bfloat16* __restrict__ kc,
                                                   const __nv_bfloat16* __restrict__ vc,
                                                   float* part_o, float* part_ml,
                                                   int offset, int valid_from, int c,
                                                   int h, int d, int dkv, int rep,
                                                   float sm) {
  constexpr int HD = LLAMA_HD;
  const int kv = (h / rep) * HD;
  const SelfScore score{qkv + h * HD, qkv + d + kv, kc + kv, offset, dkv, sm};
  const SelfValue value{qkv + d + dkv + kv, vc + kv, offset, dkv};
  const int s0 = valid_from + c * ATTN_CHUNK;
  const int s1 = min(offset + 1, s0 + ATTN_CHUNK);
  attn_partial<HD>(score, value, s0, s1, part_o, part_ml);
}

}  // namespace tpa
