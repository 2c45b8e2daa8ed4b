// One Llama-family decode token through all L layers with int8 weights and
// dynamically quantized int8 activations (the w8a8 decode of Orpheus-3B).
//
// Replaces tpu_audio/ops/pallas_fused_llama.py:fused_llama_stack
// (pallas_call at :451, kernel body _build_kernel :195). Per layer, as
// there:
//   RMSNorm -> int8 q/k/v (one act scale for the token) -> optional
//   per-head q/k RMSNorm (Qwen3 / VyvoTTS) -> half-split RoPE of q and k at
//   the write offset (angle = float(offset) * inv_freq, full-range sincosf)
//   -> GQA attention over the bf16 position-major [S, n_kv * 128] cache,
//   which holds K after RoPE, over rows valid_from..offset with the current
//   token's unrounded f32 k/v at offset -> int8 o-proj + residual ->
//   RMSNorm -> int8 gate and up (one act scale) -> SwiGLU -> int8 down (its
//   scale after the int32 sum) + residual.
//
// Bound on the H100: at Orpheus-3B (d = 3072, dkv = 1024, ffn = 8192, L =
// 28) a token streams (2d + 2dkv + 3ffn) * d * L = 2,818.6 MB of int8
// weights and 3.7 MB of f32 scales, plus 4 * dkv * L = 114,688 bytes of
// bf16 cache per attended position: ~0.86 ms at 3.35 TB/s at position 400.
// The operations (~5.6 G int8 multiply-adds) are far below the card's int8
// rate, so the kernel is memory-bound; this first version is bound in
// practice by its small kernels' own latency and the host's launches.
//
// Design. The TPU kernel walks a sequential grid (layer, weight chunk)
// and keeps the residual in VMEM. Hopper blocks run in no order, so the
// layer loop runs here on the host side of this file and each stage is its
// own small kernel, stream-ordered (11 launches a layer):
//   rms_quantize  - one block: the RMSNorm (or nothing, or SwiGLU of the
//                   gate/up outputs) of a GEMV input, staged in shared
//                   memory (past 48 KB by opt-in, up to the card's 227 KB),
//                   and its int8 codes and scale, once, into global memory
//                   (the device function of the Whisper kernels does the
//                   quantisation).
//   int8 GEMV     - decoder_common.cuh's one-warp-per-row GEMV at one lane:
//                   16-byte weight loads, __dp4a into an exact int32 sum,
//                   epilogue acc * (w_scale * x_scale), stored or added into
//                   the residual. q/k/v is one GEMV over 5120 rows, gate and
//                   up one over 2 ffn rows.
//   rope_qk       - one block per q and k head: the optional head RMSNorm
//                   and the rotation in place; the k heads' blocks also
//                   write the new k (rotated) and v rows, as bf16, into the
//                   caches at the offset. Attention never reads that row
//                   from the cache: it takes the f32 values.
//   attention     - split-S partials (common.cuh: 64 positions x one query
//                   head a block; query head h reads K/V head h / rep) and
//                   one combine block per head.
// The stages' device code lives in decoder_common.cuh (the row quantise
// kernel, llama_rope_head, llama_attn_partial), shared with the serving lanes
// kernel (fused_llama_lanes.cu), whose lanes agree with this kernel bit for
// bit. The TPU kernel's pack-time GQA permutation of q rows and o columns
// is a lane-layout device and is left out: the pack keeps the checkpoint's
// head order, so newk/newv come out in it too. CUDA graphs, wgmma and TMA
// are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decoder_common.cuh"

namespace {

using tpa::ADD;
using tpa::QUANT_PLAIN;
using tpa::QUANT_RMS;
using tpa::QUANT_SWIGLU;
using tpa::STORE;
using tpa::gemv_lanes;

constexpr int HD = tpa::LLAMA_HD;

// Block b < heads rotates q head b, block heads + g rotates k head g (in
// place in qkv = [q (d), k (dkv), v (dkv)]) and writes the rotated k row
// and the v row of head g into the caches' row at the offset (kc_row,
// vc_row): tpa::llama_rope_head.
__global__ void rope_qk_kernel(float* __restrict__ qkv, const float* __restrict__ qn_w,
                               const float* __restrict__ kn_w,
                               const float* __restrict__ inv_freq,
                               __nv_bfloat16* __restrict__ kc_row,
                               __nv_bfloat16* __restrict__ vc_row, int d, int dkv,
                               int heads, float eps, int offset) {
  tpa::llama_rope_head(qkv, qn_w, kn_w, inv_freq, kc_row, vc_row, d, dkv, heads, eps,
                       offset, blockIdx.x);
}

// grid (chunks of valid_from..offset, query heads). qkv is this layer's
// rotated [q, k, v]; kc/vc this layer's [s_max, dkv] caches.
__global__ void gqa_attn_partial(const float* __restrict__ qkv,
                                 const __nv_bfloat16* __restrict__ kc,
                                 const __nv_bfloat16* __restrict__ vc,
                                 float* __restrict__ part_o,
                                 float* __restrict__ part_ml, int offset,
                                 int valid_from, int d, int dkv, int rep, float sm) {
  const int c = blockIdx.x, h = blockIdx.y;
  const size_t slot = (size_t)h * gridDim.x + c;
  tpa::llama_attn_partial(qkv, kc, vc, part_o + slot * HD, part_ml + slot * 2, offset,
                          valid_from, c, h, d, dkv, rep, sm);
}

// The one-row quantise (decoder_common.cuh) of a GEMV input.
cudaError_t quantize(const float* x, const float* w, int mode, float eps, int8_t* xq,
                     float* xs, int K, cudaStream_t stream) {
  return tpa::quantize_rows(x, K, w, mode, eps, xq, xs, K, 1, stream);
}

}  // namespace

// Runs all L layers for one token. `resid` [d] holds the embedded token on
// entry and the stack output (before the final norm) on return. Pack layout
// per layer l (see tpu_audio_torch/ops/fused_llama.py:pack_llama_weights),
// with R = 2d + 2dkv + 2ffn:
//   w_in     [L, R, d]     int8  rows q (d), k, v (dkv each), o (d), gate, up
//   w_down   [L, d, ffn]   int8  output-major
//   scales   [L, R + d]    f32   per output row, same order, down last
//   norms    [L, 4, d]     f32   input and post-attention RMSNorm, q and k
//                                head norms (qk_norm only; k's first dkv)
//   inv_freq [64]          f32   RoPE inverse frequencies
// kcache/vcache [L, s_max, dkv] bf16, K after RoPE; rows valid_from..offset
// are attended and row `offset` is written. qkv [L, d + 2dkv] receives each
// layer's f32 q/k/v after RoPE (k and v are the returned new cache rows);
// scratch holds attn [d], gate/up [2 ffn], xs (4 floats), then the
// attention partials [heads, nc, 128] and [heads, nc, 2] with nc =
// ceil((offset + 1 - valid_from) / 64); xq is int8 [max(d, ffn)].
// tap_q / tap_s, when not null, receive a copy of every GEMV input's int8
// codes and scale, int8 [L, 4, max(d, ffn)] and f32 [L, 4], in the order of
// the layer's GEMV inputs (q/k/v, o, gate/up, down).
extern "C" int tpa_fused_llama_stack(
    float* resid, const int8_t* w_in, const int8_t* w_down, const float* scales,
    const float* norms, const float* inv_freq, __nv_bfloat16* kcache,
    __nv_bfloat16* vcache, float* qkv, float* scratch, int8_t* xq, int8_t* tap_q,
    float* tap_s, int L, int d, int ffn, int heads, int kv_heads, int s_max,
    int offset, int valid_from, int qk_norm, float eps, cudaStream_t stream) {
  if (valid_from < 0 || valid_from > offset || offset >= s_max || heads % kv_heads)
    return (int)cudaErrorInvalidValue;
  const int dkv = kv_heads * HD, rep = heads / kv_heads, kmax = max(d, ffn);
  const int R = 2 * d + 2 * dkv + 2 * ffn;
  const float sm = 1.0f / sqrtf((float)HD);
  const int nc = tpa::attn_chunks(offset + 1 - valid_from);
  float* attn = scratch;
  float* gu = attn + d;
  float* xs = gu + 2 * ffn;
  float* part_o = xs + 4;
  float* part_ml = part_o + (size_t)heads * nc * HD;
  cudaError_t err = cudaSuccess;
  auto keep = [&err](cudaError_t e) {
    if (err == cudaSuccess) err = e;
  };
  auto tap = [&](int l, int gemv, int K) {
    if (tap_q == nullptr) return;
    const size_t i = (size_t)l * 4 + gemv;
    keep(cudaMemcpyAsync(tap_q + i * kmax, xq, K, cudaMemcpyDeviceToDevice, stream));
    keep(cudaMemcpyAsync(tap_s + i, xs, sizeof(float), cudaMemcpyDeviceToDevice, stream));
  };
  for (int l = 0; l < L; ++l) {
    const int8_t* wl = w_in + (size_t)l * R * d;
    const float* sl = scales + (size_t)l * (R + d);
    const float* nl = norms + (size_t)l * 4 * d;
    float* qkvl = qkv + (size_t)l * (d + 2 * dkv);
    __nv_bfloat16* kcl = kcache + (size_t)l * s_max * dkv;
    __nv_bfloat16* vcl = vcache + (size_t)l * s_max * dkv;

    keep(quantize(resid, nl, QUANT_RMS, eps, xq, xs, d, stream));
    tap(l, 0, d);
    keep(gemv_lanes<STORE>(xq, xs, wl, sl, nullptr, qkvl, 0, d + 2 * dkv, d, 1, stream));
    rope_qk_kernel<<<heads + kv_heads, HD, 0, stream>>>(
        qkvl, qk_norm ? nl + 2 * d : nullptr, qk_norm ? nl + 3 * d : nullptr, inv_freq,
        kcl + (size_t)offset * dkv, vcl + (size_t)offset * dkv, d, dkv, heads, eps,
        offset);
    gqa_attn_partial<<<dim3(nc, heads), tpa::ATTN_THREADS, 0, stream>>>(
        qkvl, kcl, vcl, part_o, part_ml, offset, valid_from, d, dkv, rep, sm);
    tpa::attn_combine_kernel<<<heads, HD, 0, stream>>>(part_o, part_ml, attn, nc, HD);
    keep(quantize(attn, nullptr, QUANT_PLAIN, eps, xq, xs, d, stream));
    tap(l, 1, d);
    keep(gemv_lanes<ADD>(xq, xs, wl + (size_t)(d + 2 * dkv) * d, sl + d + 2 * dkv,
                         nullptr, resid, 0, d, d, 1, stream));
    keep(quantize(resid, nl + d, QUANT_RMS, eps, xq, xs, d, stream));
    tap(l, 2, d);
    keep(gemv_lanes<STORE>(xq, xs, wl + (size_t)(2 * d + 2 * dkv) * d,
                           sl + 2 * d + 2 * dkv, nullptr, gu, 0, 2 * ffn, d, 1, stream));
    keep(quantize(gu, nullptr, QUANT_SWIGLU, eps, xq, xs, ffn, stream));
    tap(l, 3, ffn);
    keep(gemv_lanes<ADD>(xq, xs, w_down + (size_t)l * d * ffn, sl + R, nullptr, resid,
                         0, d, ffn, 1, stream));
  }
  keep(cudaGetLastError());
  return (int)err;
}
