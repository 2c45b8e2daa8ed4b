// One Llama-family decode token for each of n serving lanes, through all L
// layers, with int8 weights and dynamically quantized int8 activations (the
// w8a8 decode step of Orpheus-3B continuous-batching serving).
//
// Replaces tpu_audio/ops/pallas_fused_llama.py:fused_llama_stack_lanes
// (pallas_call at :808, kernel body _build_kernel_lanes :528). Each lane is
// one request with its own position-major bf16 cache slot, write offset and
// left-pad start (valid_from); its row goes through the layer of
// fused_llama.cu (RMSNorm -> int8 q/k/v -> optional per-head q/k RMSNorm ->
// half-split RoPE at the lane's own offset -> GQA attention over the lane's
// rows valid_from..offset, with its current token's f32 k/v at the offset
// -> int8 o + residual -> RMSNorm -> int8 gate and up -> SwiGLU -> int8 down,
// its scale after the int32 sum -> residual), with one activation scale per
// lane row. Every per-row quantity comes from the device functions of
// decoder_common.cuh that the one-token kernel uses, in the same order, so
// lane m is bit-equal to fused_llama.cu run on lane m's inputs.
//
// Bound on the H100: a step streams the layers' int8 weights once for all
// lanes (2,818.6 MB at Orpheus-3B: (2d + 2dkv + 3ffn) * d * L, d = 3072,
// dkv = 1024, ffn = 8192, L = 28) plus, per lane, 4 * dkv * L = 114,688
// bytes of bf16 cache per attended position: 0.84 ms at 3.35 TB/s for the
// weights, ~0.014 ms more per lane at 400 positions. The operations (~5.6 G
// int8 multiply-adds a lane) stay far below the int8 rate up to the lane
// limit, so the kernel is memory-bound; this first version is bound in
// practice by its small kernels' latency (PERF.md).
//
// Design (11 launches a layer, whatever n):
//   rms_quantize_rows - one block per lane row: RMSNorm (or nothing, or
//                       SwiGLU) and the int8 codes and scale of a GEMV
//                       input, into a global int8 [n, K] + f32 [n] buffer.
//   int8 GEMV         - decoder_common.cuh's lanes GEMV: one warp per weight
//                       row streams it once (16-byte loads) into n exact
//                       __dp4a int32 sums over the n staged int8 rows in
//                       shared memory (n * K bytes: at the down projection,
//                       K = ffn = 8192, 28 lanes fit in the 227 KB a block
//                       may opt into and 29 do not; supported_lanes() in
//                       ops/fused_llama.py states the limit).
//   rope_qk_lanes     - grid (heads + kv_heads, lanes): the optional head
//                       RMSNorm and the rotation at the lane's offset, read
//                       from device memory; the k heads' blocks write the
//                       lane's new k (rotated) and v rows, as bf16, into its
//                       slot at its offset.
//   attention         - split-S partials with grid (chunks, heads, lanes)
//                       over the stacked [slots, L, s_max, dkv] caches: the
//                       grid is sized from s_max (no host read of the
//                       offsets), a lane's chunks start at its valid_from,
//                       and a block past its lane's offset exits at once;
//                       one combine block per (head, lane).
// An offset outside [0, s_max) is clamped to it (as kernel 4 does): a lane
// frozen at the cache's end overwrites its own last row, never another's.
// Lanes must have distinct slots. Left out, as TPU artifacts: the 8-row x
// padding, the 8-lane cap, angle tables built outside the kernel and the
// S_MAX_CAP VMEM cap.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decoder_common.cuh"

namespace {

using tpa::ADD;
using tpa::MAX_LANES;
using tpa::QUANT_PLAIN;
using tpa::QUANT_RMS;
using tpa::QUANT_SWIGLU;
using tpa::STORE;
using tpa::gemv_lanes;
using tpa::quantize_rows;

constexpr int HD = tpa::LLAMA_HD;

__device__ __forceinline__ int lane_offset(const long long* offsets, int m, int s_max) {
  return (int)min(max(offsets[m], 0LL), (long long)s_max - 1);
}

__device__ __forceinline__ int lane_start(const long long* valid_from, int m, int offset) {
  return (int)min(max(valid_from[m], 0LL), (long long)offset);
}

// grid (heads + kv_heads, lanes). qkv is this layer's [n, d + 2dkv] q/k/v;
// kc/vc point at layer l of slot 0 of the [slots, L, s_max, dkv] caches.
__global__ void rope_qk_lanes_kernel(float* __restrict__ qkv, const float* __restrict__ qn_w,
                                     const float* __restrict__ kn_w,
                                     const float* __restrict__ inv_freq,
                                     __nv_bfloat16* __restrict__ kc,
                                     __nv_bfloat16* __restrict__ vc, size_t slot_stride,
                                     const long long* __restrict__ offsets,
                                     const long long* __restrict__ lanes, int s_max, int d,
                                     int dkv, int heads, float eps) {
  const int m = blockIdx.y;
  const int off = lane_offset(offsets, m, s_max);
  const size_t row = (size_t)lanes[m] * slot_stride + (size_t)off * dkv;
  tpa::llama_rope_head(qkv + (size_t)m * (d + 2 * dkv), qn_w, kn_w, inv_freq, kc + row,
                       vc + row, d, dkv, heads, eps, off, blockIdx.x);
}

// grid (chunks of 0..s_max, heads, lanes). Partials laid out [n, heads, nc,
// HD] and [n, heads, nc, 2] with nc = gridDim.x.
__global__ void gqa_attn_partial_lanes(const float* __restrict__ qkv,
                                       const __nv_bfloat16* __restrict__ kc,
                                       const __nv_bfloat16* __restrict__ vc,
                                       size_t slot_stride,
                                       const long long* __restrict__ offsets,
                                       const long long* __restrict__ valid_from,
                                       const long long* __restrict__ lanes,
                                       float* __restrict__ part_o,
                                       float* __restrict__ part_ml, int s_max, int d,
                                       int dkv, int rep, float sm) {
  const int c = blockIdx.x, h = blockIdx.y, m = blockIdx.z;
  const int offset = lane_offset(offsets, m, s_max);
  const int vf = lane_start(valid_from, m, offset);
  if (vf + c * tpa::ATTN_CHUNK > offset) return;  // past this lane's rows
  const size_t base = (size_t)lanes[m] * slot_stride;
  const size_t slot = ((size_t)m * gridDim.y + h) * gridDim.x + c;
  tpa::llama_attn_partial(qkv + (size_t)m * (d + 2 * dkv), kc + base, vc + base,
                          part_o + slot * HD, part_ml + slot * 2, offset, vf, c, h, d,
                          dkv, rep, sm);
}

// out[m, h * HD + j] for head h = blockIdx.x, lane m = blockIdx.y from the
// lane's (offset - valid_from) / 64 + 1 partials (the one-token kernel's
// combine, tpa::combine_partials).
__global__ void attn_combine_lanes(const float* __restrict__ part_o,
                                   const float* __restrict__ part_ml,
                                   float* __restrict__ out, int nc_stride,
                                   const long long* __restrict__ offsets,
                                   const long long* __restrict__ valid_from, int s_max) {
  const int h = blockIdx.x, m = blockIdx.y, heads = gridDim.x;
  const int offset = lane_offset(offsets, m, s_max);
  const int nc = (offset - lane_start(valid_from, m, offset)) / tpa::ATTN_CHUNK + 1;
  const size_t base = ((size_t)m * heads + h) * nc_stride;
  out[((size_t)m * heads + h) * HD + threadIdx.x] = tpa::combine_partials(
      part_o + base * HD, part_ml + base * 2, nc, HD, threadIdx.x);
}

}  // namespace

// Runs all L layers for one token on each of n lanes. `resid` [n, d] holds
// the lanes' embedded tokens on entry and the stack outputs (before the
// final norm) on return. offsets, valid_from and lanes are [n] int64 device
// arrays: lane m writes at offsets[m], attends rows valid_from[m]..offsets[m]
// and reads and writes slot lanes[m] of kcache/vcache [slots, L, s_max, dkv]
// bf16 (K after RoPE). The pack layout is tpa_fused_llama_stack's. qkv [L,
// n, d + 2dkv] receives each layer's f32 q/k/v after RoPE (k and v are the
// lanes' new cache rows). scratch holds attn [n, d], gate/up [n, 2 ffn], xs
// [n] padded to a multiple of 4, then the attention partials [n, heads, nc,
// 128] and [n, heads, nc, 2] with nc = ceil(s_max / 64); xq is int8 [n,
// max(d, ffn)]. tap_q / tap_s, when not null, receive a copy of every GEMV
// input's int8 codes and scales, int8 [L, 4, n, max(d, ffn)] and f32 [L, 4,
// n], in the order of the layer's GEMV inputs (q/k/v, o, gate/up, down).
extern "C" int tpa_fused_llama_stack_lanes(
    float* resid, const long long* offsets, const long long* valid_from,
    const long long* lanes, const int8_t* w_in, const int8_t* w_down,
    const float* scales, const float* norms, const float* inv_freq,
    __nv_bfloat16* kcache, __nv_bfloat16* vcache, float* qkv, float* scratch, int8_t* xq,
    int8_t* tap_q, float* tap_s, int n, int L, int d, int ffn, int heads, int kv_heads,
    int s_max, int qk_norm, float eps, cudaStream_t stream) {
  if (n < 1 || n > MAX_LANES || s_max < 1 || heads % kv_heads)
    return (int)cudaErrorInvalidValue;
  const int dkv = kv_heads * HD, rep = heads / kv_heads, kmax = max(d, ffn);
  const int R = 2 * d + 2 * dkv + 2 * ffn, ldq = d + 2 * dkv;
  const float sm = 1.0f / sqrtf((float)HD);
  const int nc = tpa::attn_chunks(s_max);
  float* attn = scratch;
  float* gu = attn + (size_t)n * d;
  float* xs = gu + (size_t)n * 2 * ffn;
  float* part_o = xs + ((n + 3) / 4) * 4;
  float* part_ml = part_o + (size_t)n * heads * nc * HD;
  const size_t slot_stride = (size_t)L * s_max * dkv;
  const dim3 rope_grid(heads + kv_heads, n), attn_grid(nc, heads, n), combine_grid(heads, n);
  cudaError_t err = cudaSuccess;
  auto keep = [&err](cudaError_t e) {
    if (err == cudaSuccess) err = e;
  };
  auto tap = [&](int l, int gemv, int K) {
    if (tap_q == nullptr) return;
    const size_t i = (size_t)l * 4 + gemv;
    keep(cudaMemcpy2DAsync(tap_q + i * n * kmax, kmax, xq, K, K, n,
                           cudaMemcpyDeviceToDevice, stream));
    keep(cudaMemcpyAsync(tap_s + i * n, xs, n * sizeof(float), cudaMemcpyDeviceToDevice,
                         stream));
  };
  for (int l = 0; l < L; ++l) {
    const int8_t* wl = w_in + (size_t)l * R * d;
    const float* sl = scales + (size_t)l * (R + d);
    const float* nl = norms + (size_t)l * 4 * d;
    float* qkvl = qkv + (size_t)l * n * ldq;
    __nv_bfloat16* kcl = kcache + (size_t)l * s_max * dkv;
    __nv_bfloat16* vcl = vcache + (size_t)l * s_max * dkv;

    keep(quantize_rows(resid, d, nl, QUANT_RMS, eps, xq, xs, d, n, stream));
    tap(l, 0, d);
    keep(gemv_lanes<STORE>(xq, xs, wl, sl, nullptr, qkvl, ldq, ldq, d, n, stream));
    rope_qk_lanes_kernel<<<rope_grid, HD, 0, stream>>>(
        qkvl, qk_norm ? nl + 2 * d : nullptr, qk_norm ? nl + 3 * d : nullptr, inv_freq, kcl,
        vcl, slot_stride, offsets, lanes, s_max, d, dkv, heads, eps);
    gqa_attn_partial_lanes<<<attn_grid, tpa::ATTN_THREADS, 0, stream>>>(
        qkvl, kcl, vcl, slot_stride, offsets, valid_from, lanes, part_o, part_ml, s_max, d,
        dkv, rep, sm);
    attn_combine_lanes<<<combine_grid, HD, 0, stream>>>(part_o, part_ml, attn, nc, offsets,
                                                        valid_from, s_max);
    keep(quantize_rows(attn, d, nullptr, QUANT_PLAIN, eps, xq, xs, d, n, stream));
    tap(l, 1, d);
    keep(gemv_lanes<ADD>(xq, xs, wl + (size_t)ldq * d, sl + ldq, nullptr, resid, d, d, d,
                         n, stream));
    keep(quantize_rows(resid, d, nl + d, QUANT_RMS, eps, xq, xs, d, n, stream));
    tap(l, 2, d);
    keep(gemv_lanes<STORE>(xq, xs, wl + (size_t)(d + ldq) * d, sl + d + ldq, nullptr, gu,
                           2 * ffn, 2 * ffn, d, n, stream));
    keep(quantize_rows(gu, 2 * ffn, nullptr, QUANT_SWIGLU, eps, xq, xs, ffn, n, stream));
    tap(l, 3, ffn);
    keep(gemv_lanes<ADD>(xq, xs, w_down + (size_t)l * d * ffn, sl + R, nullptr, resid, d,
                         d, ffn, n, stream));
  }
  keep(cudaGetLastError());
  return (int)err;
}
