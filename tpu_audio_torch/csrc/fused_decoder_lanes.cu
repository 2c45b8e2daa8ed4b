// One Whisper decode token for each of n serving lanes, through all L
// decoder layers, with int8 weights and dynamically quantized int8
// activations (the w8 kv8d configuration of continuous-batching serving).
//
// Replaces tpu_audio/ops/pallas_fused_decoder.py:fused_stack_lanes
// (pallas_call at :949, kernel body _build_kernel_lanes :585). Each lane is
// one request with its own self-attention cache, write offset and int8
// cross K/V; its row goes through the layer function of fused_decoder.cu
// (LN eps 1e-5 -> int8 q/k/v -> self-attention with the current token's
// unrounded f32 k/v at the lane's offset -> out-proj + residual -> LN ->
// cross-q -> attention over the lane's int8 cross K/V, scores times the
// per-position K scale, V scale folded into the values -> cross-out +
// residual -> LN -> fc1 + tanh-GELU -> fc2, its scale after the int32 sum
// -> residual), with one activation scale per lane row (max|x|/127, round
// half to even on a true division). At n = 1 that is the one-token kernel.
//
// Bound on the H100: a step streams the layers' int8 weights once for all
// lanes (734 MB at whisper-large-v3: 14 d^2 L bytes, d = 1280, L = 32) plus,
// per lane, its int8 cross K/V (123 MB: 2 * 1500 * d * L) and its bf16 self
// cache (up to 73 MB at 448 positions). So at n = 8 the cross K/V (983 MB)
// weigh more than the weights: ~0.5 ms at 3.35 TB/s for the whole step.
// This first version is bound in practice by its own small kernels'
// latency and by the byte loads of the attention partials (PERF.md).
//
// Design:
//   ln_quantize_rows - one block per lane row: the LayerNorm and int8
//                      quantisation of each GEMV input happen once per row
//                      into a global int8 [n, K] + f32 [n] buffer, by the
//                      same device function as the one-token GEMV prologue.
//   int8_gemv_lanes  - one warp per output row streams that weight row once
//                      (16-byte loads) and multiplies it into all n staged
//                      int8 lane rows, one exact __dp4a int32 sum per lane;
//                      the epilogue is the one-token kernel's. Shared memory
//                      holds only the n int8 rows (n * K bytes: 40 KB at
//                      n = 8, K = ffn = 5120). Staging the f32 row beside
//                      them, as the one-token GEMV does, would need 5 n K
//                      bytes (200 KB at n = 8) and redo the LayerNorm in
//                      every block; a separate quantise launch per stage is
//                      the cheaper of the two ways out. Above 48 KB (n > 9
//                      at ffn 5120) the kernel opts in to large dynamic
//                      shared memory, up to the 227 KB a block may have:
//                      supported_lanes() in ops/fused_decoder.py states the
//                      limit (n <= MAX_LANES = 32 accumulators a thread).
//   self_attn        - grid (chunks, heads, lanes) over the stacked
//                      [slots, L, s_max, d] caches. A block reads its lane's
//                      slot index and offset from device memory; the grid is
//                      sized from s_max (no host read of the offsets), and a
//                      block whose chunk lies past its lane's offset exits
//                      at once. The block holding a lane's offset writes
//                      that lane's new k/v row (bf16) into its slot in
//                      place. Lanes must have distinct slots.
//   cross_attn       - grid (chunks, heads, lanes), each lane over its own
//                      slot of the stacked int8 cross K/V; one combine per
//                      lane and head.
// 16 launches a layer. An offset outside [0, s_max) is clamped to that
// range (as the JAX package's dynamic_update_slice clamps): a serving lane
// frozen at the cache's end overwrites its own last row, never another's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decoder_common.cuh"

namespace {

using tpa::ADD;
using tpa::GELU;
using tpa::GEMV_THREADS;
using tpa::MAX_LANES;
using tpa::STORE;
using tpa::gemv_lanes;

__device__ __forceinline__ int lane_offset(const int* offsets, int m, int s_max) {
  return min(max(offsets[m], 0), s_max - 1);
}

// Row m = blockIdx.x of x (row stride ldx): optional LayerNorm, then its
// int8 codes xq[m, :K] and scale xs[m].
__global__ void ln_quantize_rows_kernel(const float* __restrict__ x, int ldx,
                                        const float* __restrict__ ln_w,
                                        const float* __restrict__ ln_b,
                                        int8_t* __restrict__ xq,
                                        float* __restrict__ xs, int K) {
  extern __shared__ __align__(16) float xf[];  // [K]
  __shared__ float red[32];
  const int m = blockIdx.x;
  const float s = tpa::ln_quantize_row(x + (size_t)m * ldx, ln_w, ln_b, xf,
                                       xq + (size_t)m * K, K, red);
  if (threadIdx.x == 0) xs[m] = s;
}

// grid (chunks of 0..s_max, heads, lanes). qkv is this layer's [n, 3d] q/k/v;
// kc/vc point at layer l of slot 0 of the [slots, L, s_max, d] caches.
__global__ void self_attn_partial_lanes(const float* __restrict__ qkv,
                                        const int* __restrict__ offsets,
                                        const int* __restrict__ lanes,
                                        __nv_bfloat16* __restrict__ kc,
                                        __nv_bfloat16* __restrict__ vc,
                                        size_t slot_stride,
                                        float* __restrict__ part_o,
                                        float* __restrict__ part_ml, int s_max,
                                        int d, int hd, float sm) {
  const int c = blockIdx.x, h = blockIdx.y, m = blockIdx.z, nc = gridDim.x;
  const int offset = lane_offset(offsets, m, s_max);
  const int s0 = c * tpa::ATTN_CHUNK;
  if (s0 > offset) return;  // past this lane's offset: the combine skips it
  const int col = h * hd;
  const float* q = qkv + (size_t)m * 3 * d;
  const size_t base = (size_t)lanes[m] * slot_stride;
  const tpa::SelfScore score{q + col, q + d + col, kc + base + col, offset, d, sm};
  const tpa::SelfValue value{q + 2 * d + col, vc + base + col, offset, d};
  const int s1 = min(offset + 1, s0 + tpa::ATTN_CHUNK);
  const size_t slot = ((size_t)m * gridDim.y + h) * nc + c;
  tpa::attn_partial<tpa::ATTN_HD>(score, value, s0, s1,
                                  part_o + slot * tpa::ATTN_HD, part_ml + slot * 2);
  if (offset < s1 && threadIdx.x < hd) {
    const size_t row = base + (size_t)offset * d + col + threadIdx.x;
    kc[row] = __float2bfloat16(q[d + col + threadIdx.x]);
    vc[row] = __float2bfloat16(q[2 * d + col + threadIdx.x]);
  }
}

// grid (chunks of 0..S, heads, lanes). q2 [n, d]; ck/cv point at layer l of
// slot 0 of the [slots, L, s_ck, d] cross K/V, ks/vs at layer l of slot 0 of
// the [slots, L, s_ck] scales.
__global__ void cross_attn_partial_lanes(const float* __restrict__ q2,
                                         const int* __restrict__ lanes,
                                         const int8_t* __restrict__ ck,
                                         const float* __restrict__ ks,
                                         const int8_t* __restrict__ cv,
                                         const float* __restrict__ vs,
                                         size_t slot_kv, size_t slot_s,
                                         float* __restrict__ part_o,
                                         float* __restrict__ part_ml, int S,
                                         int d, int hd, float sm) {
  const int c = blockIdx.x, h = blockIdx.y, m = blockIdx.z, nc = gridDim.x;
  const int col = h * hd;
  const size_t lane = (size_t)lanes[m];
  const tpa::CrossScore score{q2 + (size_t)m * d + col, ck + lane * slot_kv + col,
                              ks + lane * slot_s, d, sm};
  const tpa::CrossValue value{cv + lane * slot_kv + col, vs + lane * slot_s, d};
  const int s0 = c * tpa::ATTN_CHUNK;
  const int s1 = min(S, s0 + tpa::ATTN_CHUNK);
  const size_t slot = ((size_t)m * gridDim.y + h) * nc + c;
  tpa::attn_partial<tpa::ATTN_HD>(score, value, s0, s1,
                                  part_o + slot * tpa::ATTN_HD, part_ml + slot * 2);
}

// out[m, h * hd + j] for head h = blockIdx.x, lane m = blockIdx.y,
// j = threadIdx.x, from the partials laid out [n, heads, nc_stride, hd] and
// [n, heads, nc_stride, 2]: lane m's first offset_m / 64 + 1 chunks (self)
// or nc_fixed chunks (cross, offsets == nullptr), by tpa::combine_partials
// as tpa::attn_combine_kernel.
__global__ void attn_combine_lanes(const float* __restrict__ part_o,
                                   const float* __restrict__ part_ml,
                                   float* __restrict__ out, int nc_stride,
                                   int nc_fixed, const int* __restrict__ offsets,
                                   int s_max, int hd) {
  const int h = blockIdx.x, m = blockIdx.y, j = threadIdx.x, heads = gridDim.x;
  const int nc = offsets != nullptr
                     ? lane_offset(offsets, m, s_max) / tpa::ATTN_CHUNK + 1
                     : nc_fixed;
  const size_t base = ((size_t)m * heads + h) * nc_stride;
  out[(size_t)m * heads * hd + (size_t)h * hd + j] =
      tpa::combine_partials(part_o + base * hd, part_ml + base * 2, nc, hd, j);
}

void ln_quantize(const float* x, int ldx, const float* ln_w, const float* ln_b,
                 int8_t* xq, float* xs, int K, int n, cudaStream_t stream) {
  ln_quantize_rows_kernel<<<n, GEMV_THREADS, (size_t)K * sizeof(float), stream>>>(
      x, ldx, ln_w, ln_b, xq, xs, K);
}

}  // namespace

// Runs all L layers for one token on each of n lanes. `resid` [n, d] holds
// the lanes' embedded tokens on entry and the stack outputs on return.
// offsets [n] and lanes [n] are int32 device arrays: lane m writes at
// offsets[m] and reads and writes slot lanes[m] of the stacked state
//   kcache/vcache [slots, L, s_max, d] bf16,
//   ck/cv [slots, L, s_ck, d] int8, ks/vs [slots, L, s_ck] f32 (the first
//   s_src rows are attended).
// The pack layout is tpa_fused_stack's. qkv [L, n, 3d] receives each
// layer's f32 q/k/v (k and v are the lanes' new cache rows). scratch holds
// attn, q2, ca [n, d] each, h [n, ffn], xs [n] padded to a multiple of 4,
// then the attention partials [n, heads, nc, hd] and [n, heads, nc, 2] with
// nc = ceil(max(s_max, s_src) / 64); xq is int8 [n, max(d, ffn)].
// tap_q / tap_s, when not null, receive a copy of every GEMV input's int8
// codes and scales, int8 [L, 6, n, max(d, ffn)] and f32 [L, 6, n], in the
// order of the layer's six GEMVs (q/k/v, out, cross-q, cross-out, fc1, fc2):
// what the check of the rounding against the plain version reads.
extern "C" int tpa_fused_stack_lanes(
    float* resid, const int* offsets, const int* lanes, const int8_t* w_in,
    const int8_t* w_fc2, const float* scales, const float* biases,
    const float* ln, const int8_t* ck, const float* ks, const int8_t* cv,
    const float* vs, __nv_bfloat16* kcache, __nv_bfloat16* vcache, float* qkv,
    float* scratch, int8_t* xq, int8_t* tap_q, float* tap_s, int n, int L, int d,
    int ffn, int heads, int s_src, int s_ck, int s_max, cudaStream_t stream) {
  if (n < 1 || n > MAX_LANES) return (int)cudaErrorInvalidValue;
  const int hd = d / heads, kmax = max(d, ffn);
  const float sm = 1.0f / sqrtf((float)hd);
  const int n_in = 6 * d + ffn, n_sc = 7 * d + ffn;
  float* attn = scratch;
  float* q2 = attn + (size_t)n * d;
  float* ca = q2 + (size_t)n * d;
  float* hbuf = ca + (size_t)n * d;
  float* xs = hbuf + (size_t)n * ffn;
  const int nc_self = tpa::attn_chunks(s_max);
  const int nc_cross = tpa::attn_chunks(s_src);
  const int nc = max(nc_self, nc_cross);
  float* part_o = xs + ((n + 3) / 4) * 4;
  float* part_ml = part_o + (size_t)n * heads * nc * hd;
  const size_t slot_cache = (size_t)L * s_max * d;
  const size_t slot_kv = (size_t)L * s_ck * d, slot_s = (size_t)L * s_ck;
  const dim3 self_grid(nc_self, heads, n), cross_grid(nc_cross, heads, n);
  const dim3 combine_grid(heads, n);
  cudaError_t err = cudaSuccess;
  auto keep = [&err](cudaError_t e) {
    if (err == cudaSuccess) err = e;
  };
  auto tap = [&](int l, int gemv, int K) {
    if (tap_q == nullptr) return;
    const size_t i = (size_t)l * 6 + gemv;
    keep(cudaMemcpy2DAsync(tap_q + i * n * kmax, kmax, xq, K, K, n,
                           cudaMemcpyDeviceToDevice, stream));
    keep(cudaMemcpyAsync(tap_s + i * n, xs, n * sizeof(float), cudaMemcpyDeviceToDevice,
                         stream));
  };
  for (int l = 0; l < L; ++l) {
    const int8_t* wl = w_in + (size_t)l * n_in * d;
    const float* sl = scales + (size_t)l * n_sc;
    const float* bl = biases + (size_t)l * n_sc;
    const float* lnl = ln + (size_t)l * 6 * d;
    float* qkvl = qkv + (size_t)l * n * 3 * d;

    ln_quantize(resid, d, lnl, lnl + d, xq, xs, d, n, stream);
    tap(l, 0, d);
    keep(gemv_lanes<STORE>(xq, xs, wl, sl, bl, qkvl, 3 * d, 3 * d, d, n, stream));
    self_attn_partial_lanes<<<self_grid, tpa::ATTN_THREADS, 0, stream>>>(
        qkvl, offsets, lanes, kcache + (size_t)l * s_max * d,
        vcache + (size_t)l * s_max * d, slot_cache, part_o, part_ml, s_max, d, hd, sm);
    attn_combine_lanes<<<combine_grid, hd, 0, stream>>>(part_o, part_ml, attn, nc_self,
                                                        0, offsets, s_max, hd);
    ln_quantize(attn, d, nullptr, nullptr, xq, xs, d, n, stream);
    tap(l, 1, d);
    keep(gemv_lanes<ADD>(xq, xs, wl + (size_t)3 * d * d, sl + 3 * d, bl + 3 * d, resid,
                         d, d, d, n, stream));
    ln_quantize(resid, d, lnl + 2 * d, lnl + 3 * d, xq, xs, d, n, stream);
    tap(l, 2, d);
    keep(gemv_lanes<STORE>(xq, xs, wl + (size_t)4 * d * d, sl + 4 * d, bl + 4 * d, q2,
                           d, d, d, n, stream));
    cross_attn_partial_lanes<<<cross_grid, tpa::ATTN_THREADS, 0, stream>>>(
        q2, lanes, ck + (size_t)l * s_ck * d, ks + (size_t)l * s_ck,
        cv + (size_t)l * s_ck * d, vs + (size_t)l * s_ck, slot_kv, slot_s, part_o,
        part_ml, s_src, d, hd, sm);
    attn_combine_lanes<<<combine_grid, hd, 0, stream>>>(part_o, part_ml, ca, nc_cross,
                                                        nc_cross, nullptr, s_max, hd);
    ln_quantize(ca, d, nullptr, nullptr, xq, xs, d, n, stream);
    tap(l, 3, d);
    keep(gemv_lanes<ADD>(xq, xs, wl + (size_t)5 * d * d, sl + 5 * d, bl + 5 * d, resid,
                         d, d, d, n, stream));
    ln_quantize(resid, d, lnl + 4 * d, lnl + 5 * d, xq, xs, d, n, stream);
    tap(l, 4, d);
    keep(gemv_lanes<GELU>(xq, xs, wl + (size_t)6 * d * d, sl + 6 * d, bl + 6 * d, hbuf,
                          ffn, ffn, d, n, stream));
    ln_quantize(hbuf, ffn, nullptr, nullptr, xq, xs, ffn, n, stream);
    tap(l, 5, ffn);
    keep(gemv_lanes<ADD>(xq, xs, w_fc2 + (size_t)l * d * ffn, sl + 6 * d + ffn,
                         bl + 6 * d + ffn, resid, d, d, ffn, n, stream));
  }
  keep(cudaGetLastError());
  return (int)err;
}
