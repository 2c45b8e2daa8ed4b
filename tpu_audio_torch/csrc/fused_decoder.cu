// One Whisper decode token through all L decoder layers with int8 weights
// and dynamically quantized int8 activations (the w8 kv8d configuration).
//
// Replaces tpu_audio/ops/pallas_fused_decoder.py:fused_stack (pallas_call
// at :504, kernel body _build_kernel :180). Per layer, as there:
//   LN -> int8 q/k/v (one act scale for the live row) -> self-attention over
//   the bf16 [S, d] cache with the current k/v (unrounded f32) at `offset`
//   -> int8 out-proj + residual -> LN -> int8 cross-q -> attention over int8
//   cross K/V with per-position f32 scales -> int8 cross-out + residual ->
//   LN -> int8 fc1 + tanh-GELU -> int8 fc2 (weight scale after the int32
//   accumulation) + residual.
//
// Bound on the H100: at whisper-large-v3 (d = 1280, ffn = 5120, L = 32,
// 20 heads, 1500 source positions) a token streams 14*d*d*L = 734 MB of int8
// weights plus 2*1500*d*L = 123 MB of int8 cross K/V (and under 100 MB of
// bf16 self cache): ~0.26 ms at 3.35 TB/s. The FLOPs (~1.7 GOP) are
// negligible. So it is memory-bound, and at this first version bound in
// practice by launch latency and by the small kernels' own latency.
//
// Design. The TPU kernel walks a sequential grid (layer, step) and carries
// the residual in VMEM across grid steps. Hopper blocks run in no order, so
// here the layer loop runs on the host side of this file and each stage is
// its own small kernel, stream-ordered:
//   int8_gemv     - every block first builds the int8 input itself: optional
//                   LayerNorm of the f32 input vector, max|x|/127 scale and
//                   round-half-even codes (a true division, as the JAX
//                   package does) in shared memory. Recomputing this per
//                   block costs a few KB of L2 reads and saves separate
//                   normalise/quantise launches. Then one warp per output
//                   row: 16-byte weight loads, __dp4a into an exact int32
//                   sum, and the epilogue acc * (w_scale[o] * x_scale) +
//                   bias, optionally tanh-GELU, or added into the residual.
//                   fc2 is stored output-major so it is one more such GEMV;
//                   its per-channel scale is then applied after the
//                   accumulation exactly as in the TPU kernel.
//   self_attn     - split-S attention (common.cuh: blocks of 64 positions
//                   x 1 head, then a combine per head) over positions
//                   0..offset; the current token's k/v come from the f32
//                   projection, and the block holding `offset` then writes
//                   them (as bf16) into the caches in place. No block of
//                   the launch reads that row, so there is no race.
//   cross_attn    - split-S attention over the int8 position-major cross
//                   K/V: score = (code . q*sm) * k_scale[s]; the V scale is
//                   folded into the value.
// That is 10 launches per layer, 320 per token. (One block per head, the
// first version, kept 112 of 132 SMs idle in attention: 9.6 ms a token.)
// CUDA graphs, wgmma and TMA are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decoder_common.cuh"

namespace {

using tpa::GEMV_THREADS;
using tpa::GELU;
using tpa::ADD;
using tpa::STORE;

// out[o] (=, or +=) epilogue(sum_i xq[i] * w[o, i]) for o < N, where xq is
// the int8 quantisation of LN(x) (ln_w != nullptr) or of x.
template <int MODE>
__global__ void int8_gemv_kernel(const float* __restrict__ x,
                                 const float* __restrict__ ln_w,
                                 const float* __restrict__ ln_b,
                                 const int8_t* __restrict__ w,
                                 const float* __restrict__ w_scale,
                                 const float* __restrict__ bias,
                                 float* __restrict__ out, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* xq = reinterpret_cast<int8_t*>(smem_raw);       // [K]
  float* xf = reinterpret_cast<float*>(smem_raw + K);     // [K] (K % 16 == 0)
  __shared__ float red[32];
  const float xs = tpa::ln_quantize_row(x, ln_w, ln_b, xf, xq, K, red);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = GEMV_THREADS / 32;
  const int4* xv = reinterpret_cast<const int4*>(xq);
  const int nvec = K / 16;
  for (int row = blockIdx.x * nwarps + warp; row < N; row += gridDim.x * nwarps) {
    const int4* wv = reinterpret_cast<const int4*>(w + (size_t)row * K);
    int acc = 0;
    for (int c = lane; c < nvec; c += 32) {
      const int4 a = __ldg(wv + c);
      const int4 b = xv[c];
      acc = __dp4a(a.x, b.x, acc);
      acc = __dp4a(a.y, b.y, acc);
      acc = __dp4a(a.z, b.z, acc);
      acc = __dp4a(a.w, b.w, acc);
    }
    acc = tpa::warp_sum_int(acc);
    if (lane == 0)
      tpa::gemv_epilogue<MODE>(acc, w_scale[row], xs,
                               bias != nullptr ? bias + row : nullptr, out + row);
  }
}

using tpa::CrossScore;
using tpa::CrossValue;
using tpa::SelfScore;
using tpa::SelfValue;

// grid (chunks of positions 0..offset, heads). The block holding `offset`
// then writes this head's new k/v row into the caches (as bf16); no block
// of the launch reads that row from the cache.
__global__ void self_attn_partial(const float* __restrict__ q,
                                  const float* __restrict__ k_new,
                                  const float* __restrict__ v_new,
                                  __nv_bfloat16* __restrict__ kcache,
                                  __nv_bfloat16* __restrict__ vcache,
                                  float* __restrict__ part_o,
                                  float* __restrict__ part_ml, int offset,
                                  int d, int hd, float sm) {
  const int c = blockIdx.x, h = blockIdx.y, nc = gridDim.x;
  const int col = h * hd;
  const SelfScore score{q + col, k_new + col, kcache + col, offset, d, sm};
  const SelfValue value{v_new + col, vcache + col, offset, d};
  const int s0 = c * tpa::ATTN_CHUNK;
  const int s1 = min(offset + 1, s0 + tpa::ATTN_CHUNK);
  const size_t slot = (size_t)h * nc + c;
  tpa::attn_partial<tpa::ATTN_HD>(score, value, s0, s1,
                                  part_o + slot * tpa::ATTN_HD, part_ml + slot * 2);
  if (offset < s1 && threadIdx.x < hd) {
    const size_t row = (size_t)offset * d + col + threadIdx.x;
    kcache[row] = __float2bfloat16(k_new[col + threadIdx.x]);
    vcache[row] = __float2bfloat16(v_new[col + threadIdx.x]);
  }
}

__global__ void cross_attn_partial(const float* __restrict__ q,
                                   const int8_t* __restrict__ ck,
                                   const float* __restrict__ ks,
                                   const int8_t* __restrict__ cv,
                                   const float* __restrict__ vs,
                                   float* __restrict__ part_o,
                                   float* __restrict__ part_ml, int S, int d,
                                   int hd, float sm) {
  const int c = blockIdx.x, h = blockIdx.y, nc = gridDim.x;
  const int col = h * hd;
  const CrossScore score{q + col, ck + col, ks, d, sm};
  const CrossValue value{cv + col, vs, d};
  const int s0 = c * tpa::ATTN_CHUNK;
  const int s1 = min(S, s0 + tpa::ATTN_CHUNK);
  const size_t slot = (size_t)h * nc + c;
  tpa::attn_partial<tpa::ATTN_HD>(score, value, s0, s1,
                                  part_o + slot * tpa::ATTN_HD, part_ml + slot * 2);
}

template <int MODE>
void gemv(const float* x, const float* ln_w, const float* ln_b, const int8_t* w,
          const float* scale, const float* bias, float* out, int N, int K,
          cudaStream_t stream) {
  const int rows_per_block = GEMV_THREADS / 32;
  const int blocks = (N + rows_per_block - 1) / rows_per_block;
  const size_t smem = (size_t)K * (1 + sizeof(float));
  int8_gemv_kernel<MODE><<<blocks, GEMV_THREADS, smem, stream>>>(
      x, ln_w, ln_b, w, scale, bias, out, N, K);
}

}  // namespace

// Runs all L layers for one token. `resid` [d] holds the embedded token on
// entry and the stack output on return. Pack layout per layer l (see
// tpu_audio_torch/ops/fused_decoder.py:pack_decoder_weights):
//   w_in   [L, 6d + ffn, d] int8  rows q, k, v, o, cross-q, cross-o, fc1
//   w_fc2  [L, d, ffn]      int8  output-major
//   scales [L, 7d + ffn]    f32   per output row, same order, fc2 last
//   biases [L, 7d + ffn]    f32   (k rows are zero)
//   ln     [L, 6, d]        f32   self, cross, final LayerNorm (w, b)
// ck/cv [L, s_ck, d] and ks/vs [L, s_ck]: the first s_src rows are attended.
// qkv [L, 3d] receives each layer's f32 q/k/v (k and v are the returned new
// cache rows); scratch holds attn [d], q2 [d], ca [d], h [ffn], then the
// split-S attention partials [heads, nc, hd] and [heads, nc, 2] with
// nc = ceil(max(s_max, s_src) / 64).
extern "C" int tpa_fused_stack(float* resid, const int8_t* w_in,
                               const int8_t* w_fc2, const float* scales,
                               const float* biases, const float* ln,
                               const int8_t* ck, const float* ks,
                               const int8_t* cv, const float* vs,
                               __nv_bfloat16* kcache, __nv_bfloat16* vcache,
                               float* qkv, float* scratch, int L, int d,
                               int ffn, int heads, int s_src, int s_ck,
                               int s_max, int offset, cudaStream_t stream) {
  const int hd = d / heads;
  const float sm = 1.0f / sqrtf((float)hd);
  const int n_in = 6 * d + ffn, n_sc = 7 * d + ffn;
  float* attn = scratch;
  float* q2 = scratch + d;
  float* ca = scratch + 2 * d;
  float* hbuf = scratch + 3 * d;
  const int nc_self = tpa::attn_chunks(offset + 1);
  const int nc_cross = tpa::attn_chunks(s_src);
  float* part_o = scratch + 3 * d + ffn;  // [heads, max(nc), hd]
  float* part_ml = part_o + (size_t)heads * max(tpa::attn_chunks(s_max), nc_cross) * hd;
  for (int l = 0; l < L; ++l) {
    const int8_t* wl = w_in + (size_t)l * n_in * d;
    const float* sl = scales + (size_t)l * n_sc;
    const float* bl = biases + (size_t)l * n_sc;
    const float* lnl = ln + (size_t)l * 6 * d;
    float* qkvl = qkv + (size_t)l * 3 * d;
    __nv_bfloat16* kcl = kcache + (size_t)l * s_max * d;
    __nv_bfloat16* vcl = vcache + (size_t)l * s_max * d;
    const size_t xkv = (size_t)l * s_ck * d;

    gemv<STORE>(resid, lnl, lnl + d, wl, sl, bl, qkvl, 3 * d, d, stream);
    self_attn_partial<<<dim3(nc_self, heads), tpa::ATTN_THREADS, 0, stream>>>(
        qkvl, qkvl + d, qkvl + 2 * d, kcl, vcl, part_o, part_ml, offset, d, hd, sm);
    tpa::attn_combine_kernel<<<heads, hd, 0, stream>>>(part_o, part_ml, attn,
                                                       nc_self, hd);
    gemv<ADD>(attn, nullptr, nullptr, wl + (size_t)3 * d * d, sl + 3 * d,
              bl + 3 * d, resid, d, d, stream);
    gemv<STORE>(resid, lnl + 2 * d, lnl + 3 * d, wl + (size_t)4 * d * d,
                sl + 4 * d, bl + 4 * d, q2, d, d, stream);
    cross_attn_partial<<<dim3(nc_cross, heads), tpa::ATTN_THREADS, 0, stream>>>(
        q2, ck + xkv, ks + (size_t)l * s_ck, cv + xkv, vs + (size_t)l * s_ck,
        part_o, part_ml, s_src, d, hd, sm);
    tpa::attn_combine_kernel<<<heads, hd, 0, stream>>>(part_o, part_ml, ca,
                                                       nc_cross, hd);
    gemv<ADD>(ca, nullptr, nullptr, wl + (size_t)5 * d * d, sl + 5 * d,
              bl + 5 * d, resid, d, d, stream);
    gemv<GELU>(resid, lnl + 4 * d, lnl + 5 * d, wl + (size_t)6 * d * d,
               sl + 6 * d, bl + 6 * d, hbuf, ffn, d, stream);
    gemv<ADD>(hbuf, nullptr, nullptr, w_fc2 + (size_t)l * d * ffn,
              sl + 6 * d + ffn, bl + 6 * d + ffn, resid, d, ffn, stream);
  }
  return (int)cudaGetLastError();
}
