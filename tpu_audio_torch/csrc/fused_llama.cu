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
// Bound on the H100: bytes. At Orpheus-3B (d = 3072, dkv = 1024, ffn =
// 8192, L = 28) a token streams (2d + 2dkv + 3ffn) * d * L = 2,818.6 MB of
// int8 weights and 3.7 MB of f32 scales, plus 4 * dkv * L = 114,688 bytes
// of bf16 cache per attended position: ~0.86 ms at 3.35 TB/s at position
// 400. The operations (~5.6 G int8 multiply-adds) are far below the card's
// int8 rate. What the TPU kernel gets right is a weight stream that Mosaic
// double-buffers across grid steps, which never waits on the layer chain,
// and a GQA permutation of q that lets one K/V pass serve the query heads
// sharing it. Hopper blocks run in no order, so the layer loop runs on the
// host side of this file, 9 launches a layer:
//   quantise, q/k/v GEMV, RoPE, attention, o GEMV, quantise, gate/up GEMV,
//   quantise, down GEMV.
// The design gets the two properties back as follows.
//   Loads before the dependency wait. Every launch after a call's first is
//     a programmatic dependent launch (PDL, hopper.cuh's Chain): it starts
//     while its predecessor runs, and before griddepcontrol.wait it only
//     reads what no launch of the call writes (weights, their scales, the
//     RMSNorm weights, cache rows valid_from..offset - 1) and writes
//     nothing. A GEMV warp loads its rows' 16-byte chunks into registers
//     there (ld.global.nc.L1::no_allocate) with their scales, a quantise
//     block copies its RMSNorm weight into shared memory, an attention block
//     issues its K/V row copies. So the weight stream runs one stage ahead
//     of the chain, and at one token the GEMVs take about their bytes' time.
//   Short quantise chains. A GEMV input's codes and scale come from
//     tpa::llama_quantize_row in one 256-thread block, as in the parent: a
//     quantise launch copies the row into shared memory with every 16-byte
//     load in flight before it runs; the o GEMV's blocks quantise the
//     attention output themselves (a plain row: no RMSNorm, a block's
//     quantisation is shorter than a launch's chain); and the gate/up GEMV
//     writes silu(gate) * up in its epilogue (a warp takes the gate and up
//     rows of one output), so that the down projection's quantise rounds an
//     ffn-wide row with no expf and reads half the bytes.
//   GQA-grouped attention from 16-byte loads. One block a (64-position
//     chunk of the live rows, KV head) stages the chunk's K and V rows with
//     16-byte cp.async and computes the rep query heads sharing them, up to
//     4 at once in groups of 128 threads (llama_attention.cuh, shared with
//     the serving lanes kernel): each K/V row is read once, not rep times.
//   The combine folded in. The last of a (layer, KV head)'s blocks to arrive
//     (an arrival counter each, zeroed once a call by the wrapper, behind
//     __threadfence) combines its heads' partials in chunk order, reading
//     them in place from L2 (tpa::combine_partials_l2), so no cache length
//     is too long for shared memory. No float atomics: the result does not
//     depend on block order.
// The arithmetic is the parent's, function for function: llama_quantize_row
// in a 256-thread block (the SwiGLU in the gate/up epilogue is its
// expression on the same f32 values), exact int32 dp4a sums, gemv_epilogue
// with no bias, llama_rope_head, attn_partial's order of sums and reduction
// tree (group_partial, group_reduce), combine_partials' expressions in chunk
// order. So the kernel is bit-equal to its parent, and each lane of
// fused_llama_lanes.cu to it. A tapped call stays a PDL chain: a quantise
// launch, and block 0 of the o GEMV, write their codes and scale into the
// tap. Shared memory bounds the widths (ops/fused_llama.py:supported): a
// quantise block holds a d-wide row, its RMSNorm weight and the normed row
// (12 d bytes), or the ffn-wide SwiGLU row and its copy (8 ffn bytes): d up
// to 19,285 and ffn up to 28,928 in the 226 KB a block may use. The cache
// length is not bounded.
// Measured at Orpheus-3B, offset 400 (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py --fused-llama-timing, PERF.md): 1.92 ms a call against 2.62
// on the device for the parent's 11 stream-ordered launches a layer (3.15
// a call with their enqueue). Tried as copies of this file timed beside it,
// and not kept: a quantise launch before every GEMV with the SwiGLU in the
// down quantise (10 launches a layer, 1.97 ms: that quantise alone took
// 10.6 us a layer); the quantisation folded into every GEMV's blocks (6
// launches, 2.69 ms: every block of the 1,024-block gate/up GEMV, in four
// waves, and of the down GEMV repeats a chain of block reductions as long
// as a quantise launch's, 27 and 39 us a layer for the two).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <utility>

#include "decoder_common.cuh"
#include "hopper.cuh"
#include "llama_attention.cuh"

namespace {

using tpa::ADD;
using tpa::GEMV_THREADS;
using tpa::QUANT_PLAIN;
using tpa::QUANT_RMS;
using tpa::STORE;

constexpr int GEMV_WARPS = GEMV_THREADS / 32;
constexpr int SWIGLU = 3;                   // a GEMV epilogue beside STORE and ADD
constexpr int IN_CODES = 0, IN_PLAIN = 1;  // a GEMV's input

// The codes xq [K] and scale *xs of a GEMV input row x [K]
// (tpa::llama_quantize_row, QUANT_RMS or QUANT_PLAIN, on copies in shared
// memory: the RMSNorm weight copied before the wait, the row after it, every
// 16-byte load in flight at once), one block; with a tap, also into tap_q /
// tap_s. Dynamic shared memory: the row, the RMSNorm weight (QUANT_RMS) and
// the f32 row llama_quantize_row builds.
__global__ void __launch_bounds__(GEMV_THREADS)
fl5_quantize(const float* x, const float* w, int mode, float eps, int8_t* xq, float* xs,
             int K, int8_t* tap_q, float* tap_s) {
  extern __shared__ __align__(16) float qrow[];
  __shared__ float red[32];
  float* xin = qrow;                             // [K]
  float* wn = xin + K;                           // [K], QUANT_RMS only
  float* xf = wn + (mode == QUANT_RMS ? K : 0);  // [K]
  if (mode == QUANT_RMS)
    for (int i = 4 * threadIdx.x; i < K; i += 4 * GEMV_THREADS) cp_async16(wn + i, w + i);
  dependency_wait();
  release_dependents();
  for (int i = 4 * threadIdx.x; i < K; i += 4 * GEMV_THREADS) cp_async16(xin + i, x + i);
  cp_async_wait_all();
  __syncthreads();
  const float s = tpa::llama_quantize_row(xin, wn, mode, eps, xf, xq, K, red);
  if (threadIdx.x == 0) *xs = s;
  if (tap_q != nullptr) {  // the block's own codes, visible after the reduction's barrier
    for (int i = threadIdx.x; i < K / 16; i += GEMV_THREADS)
      reinterpret_cast<int4*>(tap_q)[i] = reinterpret_cast<const int4*>(xq)[i];
    if (threadIdx.x == 0) *tap_s = s;
  }
}

struct GemvArgs {
  const void* x;         // IN_CODES: int8 codes [K]; IN_PLAIN: the f32 row [K]
  const float* xs;       // IN_CODES: the codes' scale
  const int8_t* w;       // [rows, K] int8
  const float* w_scale;  // [rows]
  float* out;            // [N], stored (STORE), added into (ADD) or SwiGLU (SWIGLU)
  int8_t* tap_q;         // IN_PLAIN: receives the block's codes, and tap_s
  float* tap_s;          // their scale; null without a tap
  int input, epi, N, K;
};

// out[o] (=, or +=) gemv_epilogue(sum_i xq[i] * w[o, i]) for o < N, a warp
// R rows: o = R * (warp's index) + r. SWIGLU (R = 2): a warp's rows are g =
// w[o] and u = w[N + o] (the gate and up rows of output o) and out[o] =
// silu(g) * u with llama_quantize_row's expression. xq and its scale are
// the quantise launch's (IN_CODES), staged after the wait, or built here by
// tpa::llama_quantize_row on the f32 row (IN_PLAIN). Before the wait a lane
// loads chunks lane, lane + 32, ... (C of them; rows wider than 512 C bytes
// load the rest after the wait) of each of its rows, and the rows' scales.
template <int R, int C>
__global__ void __launch_bounds__(GEMV_THREADS) fl5_gemv(const GemvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[32];
  const int K = a.K;
  int8_t* xq = reinterpret_cast<int8_t*>(smem_raw);    // [K]
  float* xf = reinterpret_cast<float*>(smem_raw + K);  // [K], IN_PLAIN (K % 16 == 0)
  float* xin = xf + K;                                 // [K], IN_PLAIN
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvec = K / 16;
  const int o = blockIdx.x * GEMV_WARPS + warp;
  const bool pair = a.epi == SWIGLU;
  const int rows = pair ? 2 * a.N : a.N;

  int4 wr[R][C];
  float ws[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = min(pair ? o + r * a.N : o * R + r, rows - 1);
    const int4* wv = reinterpret_cast<const int4*>(a.w + (size_t)row * K);
#pragma unroll
    for (int c = 0; c < C; ++c)
      wr[r][c] = lane + 32 * c < nvec ? ld_stream(wv + lane + 32 * c) : make_int4(0, 0, 0, 0);
    ws[r] = a.w_scale[row];
  }
  dependency_wait();
  release_dependents();
  float old_out[R];  // the rows an ADD adds into, read at once from L2
  if (a.epi == ADD && lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) old_out[r] = __ldcg(a.out + min(o * R + r, a.N - 1));
  }
  float xs;
  if (a.input == IN_CODES) {
    const int4* src = reinterpret_cast<const int4*>(a.x);
    for (int i = threadIdx.x; i < nvec; i += GEMV_THREADS) cp_async16(xq + 16 * i, src + i);
    xs = __ldcg(a.xs);
    cp_async_wait_all();
    __syncthreads();
  } else {
    const float* src = static_cast<const float*>(a.x);
    for (int i = 4 * threadIdx.x; i < K; i += 4 * GEMV_THREADS) cp_async16(xin + i, src + i);
    cp_async_wait_all();
    __syncthreads();
    xs = tpa::llama_quantize_row(xin, nullptr, QUANT_PLAIN, 0.0f, xf, xq, K, red);
    if (a.tap_q != nullptr && blockIdx.x == 0) {
      for (int i = threadIdx.x; i < nvec; i += GEMV_THREADS)
        reinterpret_cast<int4*>(a.tap_q)[i] = reinterpret_cast<const int4*>(xq)[i];
      if (threadIdx.x == 0) *a.tap_s = xs;
    }
  }
  const int4* xv = reinterpret_cast<const int4*>(xq);
  int sum[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = min(pair ? o + r * a.N : o * R + r, rows - 1);
    int acc = 0;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (lane + 32 * c < nvec) acc = dot16(wr[r][c], xv[lane + 32 * c], acc);
    const int4* wv = reinterpret_cast<const int4*>(a.w + (size_t)row * K);
    for (int i = lane + 32 * C; i < nvec; i += 32) acc = dot16(ld_stream(wv + i), xv[i], acc);
    sum[r] = tpa::warp_sum_int(acc);
  }
  if (lane != 0) return;
  if (pair) {
    if (o < a.N) {
      float g = 0.0f, u = 0.0f;
      tpa::gemv_epilogue<STORE>(sum[0], ws[0], xs, nullptr, &g);
      tpa::gemv_epilogue<STORE>(sum[R - 1], ws[R - 1], xs, nullptr, &u);
      a.out[o] = g * (1.0f / (1.0f + expf(-g))) * u;
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = o * R + r;
    if (row < a.N) {
      float y = a.epi == ADD ? old_out[r] : 0.0f;
      if (a.epi == ADD)
        tpa::gemv_epilogue<ADD>(sum[r], ws[r], xs, nullptr, &y);
      else
        tpa::gemv_epilogue<STORE>(sum[r], ws[r], xs, nullptr, &y);
      a.out[row] = y;
    }
  }
}

// grid heads + kv_heads: tpa::llama_rope_head on this layer's q/k/v (qkv),
// the k heads' blocks also writing the cache rows at the offset.
__global__ void fl5_rope(float* __restrict__ qkv, const float* __restrict__ qn_w,
                         const float* __restrict__ kn_w, const float* __restrict__ inv_freq,
                         __nv_bfloat16* __restrict__ kc_row, __nv_bfloat16* __restrict__ vc_row,
                         int d, int dkv, int heads, float eps, int offset) {
  dependency_wait();
  release_dependents();
  tpa::llama_rope_head(qkv, qn_w, kn_w, inv_freq, kc_row, vc_row, d, dkv, heads, eps, offset,
                       blockIdx.x);
}

// grid (chunks of valid_from..offset, kv_heads), hp * AT threads: hp groups
// of AT, hp a divisor of rep. Block (c, g) stages rows valid_from + 64 c..
// of KV head g of this layer's caches kc/vc [s_max, dkv] (those below the
// offset, before the wait) and writes the partials of query heads g * rep ..
// g * rep + rep - 1, hp at once, laid out [heads, nc, HD] and [heads, nc, 2]
// (nc = gridDim.x). The last of KV head g's nc blocks to arrive (counts:
// this layer's [kv_heads]) combines the rep heads from L2, hp at once, into
// out[h * HD + j].
__global__ void __launch_bounds__(MAX_GROUP * AT)
fl5_attn(const float* qkv, const __nv_bfloat16* kc, const __nv_bfloat16* vc, float* part_o,
         float* part_ml, int* counts, float* out, int offset, int valid_from, int d, int dkv,
         int rep, float sm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(16) float sc[MAX_GROUP][CH];
  __shared__ float red[MAX_GROUP][32];
  __shared__ int last;
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // 2 tables [CH, K_LD]
  __nv_bfloat16* sv = sk + 2 * K_HALF;                             // [CH, KV_LD]
  float* sq = reinterpret_cast<float*>(sv + CH * KV_LD);  // [rep q heads, k, v][HD]
  const int c = blockIdx.x, g = blockIdx.y, nc = gridDim.x;
  const int hp = blockDim.x / AT, grp = threadIdx.x / AT, t = threadIdx.x % AT;
  const size_t kv_at = (size_t)g * HD;
  const int s0 = valid_from + c * CH;
  const int s1 = min(offset + 1, s0 + CH);
  const int staged = min(s1, offset) - s0;  // the rows below offset
  constexpr int V = HD * 2 / 16;            // 16-byte pieces a row
  for (int i = threadIdx.x; i < staged * V; i += blockDim.x) {
    const int r = i / V, e = (i % V) * 8;
    const size_t at = kv_at + (size_t)(s0 + r) * dkv + e;
    cp_async16(sk + (e / (HD / 2)) * K_HALF + r * K_LD + e % (HD / 2), kc + at);
    cp_async16(sv + r * KV_LD + e, vc + at);
  }
  dependency_wait();
  release_dependents();
  // the rep rotated q heads, then this KV head's new k and v (f32)
  constexpr int Q = HD / 4;  // 16-byte pieces a head
  for (int i = threadIdx.x; i < (rep + 2) * Q; i += blockDim.x) {
    const int r = i / Q, e = (i % Q) * 4;
    const float* src = r < rep ? qkv + (g * rep + r) * HD : qkv + d + (r - rep) * dkv + g * HD;
    cp_async16(sq + r * HD + e, src + e);
  }
  cp_async_wait_all();
  __syncthreads();
  for (int r0 = 0; r0 < rep; r0 += hp) {
    const int r = r0 + grp;
    const size_t slot = (size_t)(g * rep + r) * nc + c;
    group_partial(sq + r * HD, sq + rep * HD, sq + (rep + 1) * HD, sk, sv, s0, s1, offset, sm,
                  sc[grp], red[grp], part_o + slot * HD, part_ml + slot * 2);
  }
  __threadfence();  // this block's partials, before its arrival
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counts + g, 1) == nc - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int r0 = 0; r0 < rep; r0 += hp) {
    const size_t h = (size_t)g * rep + r0 + grp;
    out[h * HD + t] = tpa::combine_partials_l2(part_o + h * nc * HD, part_ml + h * nc * 2, nc,
                                               HD, t);
  }
}

using GemvKernel = void (*)(GemvArgs);
constexpr int GEMV_KINDS = 4;
constexpr int GEMV_C[GEMV_KINDS] = {4, 6, 8, 16};  // chunks a lane holds a row

#define TPA_GEMV_R(R) {fl5_gemv<R, 4>, fl5_gemv<R, 6>, fl5_gemv<R, 8>, fl5_gemv<R, 16>}
const GemvKernel GEMV_KERNELS[2][GEMV_KINDS] = {TPA_GEMV_R(1), TPA_GEMV_R(2)};
#undef TPA_GEMV_R

// configure() for every kernel of the chain, once a device and process;
// the shared memory a block may opt into.
cudaError_t configure_chain(int* opt_in) {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(opt_in, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess || (done.load() >> dev & 1)) return e;
  const void* kernels[3 + 2 * GEMV_KINDS] = {reinterpret_cast<const void*>(fl5_quantize),
                                            reinterpret_cast<const void*>(fl5_rope),
                                            reinterpret_cast<const void*>(fl5_attn)};
  for (int i = 0; i < 2 * GEMV_KINDS; ++i)
    kernels[3 + i] = reinterpret_cast<const void*>(GEMV_KERNELS[i / GEMV_KINDS][i % GEMV_KINDS]);
  for (const void* k : kernels)
    if (e == cudaSuccess) e = configure(k, *opt_in);
  if (e == cudaSuccess) done.fetch_or(1ull << dev);
  return e;
}

// Dynamic shared memory of a quantise launch (the row, the RMSNorm weight
// for QUANT_RMS, the f32 row llama_quantize_row builds) and of a GEMV (the
// codes [K]; for IN_PLAIN also the row and the f32 row).
size_t quantize_smem(int mode, int K) {
  return (size_t)K * sizeof(float) * (mode == QUANT_RMS ? 3 : 2);
}

size_t gemv_smem(int input, int K) { return (size_t)K * (input == IN_PLAIN ? 9 : 1); }

// C the smallest chunk count that covers a row (else 16), R = 2 rows a
// warp where C <= 8 or for SWIGLU's row pairs, else 1; a block of 8 warps.
void gemv(Chain& chain, const GemvArgs& a) {
  const int chunks = (a.K / 16 + 31) / 32;
  int ci = 0;
  while (ci < GEMV_KINDS - 1 && GEMV_C[ci] < chunks) ++ci;
  const int R = GEMV_C[ci] <= 8 || a.epi == SWIGLU ? 2 : 1;
  const int outs = GEMV_WARPS * (a.epi == SWIGLU ? 1 : R);
  chain.launch(GEMV_KERNELS[R - 1][ci], dim3((a.N + outs - 1) / outs), dim3(GEMV_THREADS),
               gemv_smem(a.input, a.K), a);
}

void quantize(Chain& chain, const float* x, const float* w, int mode, float eps, int8_t* xq,
              float* xs, int K, int8_t* tap_q, float* tap_s) {
  chain.launch(fl5_quantize, dim3(1), dim3(GEMV_THREADS), quantize_smem(mode, K), x, w, mode,
               eps, xq, xs, K, tap_q, tap_s);
}

// The f32 scratch of one call, in 4-byte words from its start: attn [d],
// h [ffn] (the SwiGLU of the gate/up GEMV), xs (the quantise launch's scale,
// padded to 4), the attention partials [heads, nc, 128] and [heads, nc, 2]
// with nc = ceil(s_max / 64) (a call lays out its own live chunks' in their
// first words), then the int32 arrival counters [L, kv_heads]; at[6] is the
// total.
struct Scratch {
  enum { ATTN, H, XS, PART_O, PART_ML, COUNTS, TOTAL };
  size_t at[TOTAL + 1];
};

Scratch scratch_layout(int L, int d, int ffn, int heads, int kv_heads, int s_max) {
  const size_t nc = tpa::attn_chunks(s_max);
  const size_t len[Scratch::TOTAL] = {(size_t)d, (size_t)ffn, 4, heads * nc * HD,
                                      heads * nc * 2, (size_t)L * kv_heads};
  Scratch s;
  s.at[0] = 0;
  for (int i = 0; i < Scratch::TOTAL; ++i) s.at[i + 1] = s.at[i] + len[i];
  return s;
}

}  // namespace

// The scratch layout tpa_fused_llama_stack uses (Scratch): the start of
// each region in 4-byte words, then the total, into starts[7].
extern "C" int tpa_fused_llama_stack_scratch(int L, int d, int ffn, int heads, int kv_heads,
                                             int s_max, long long* starts) {
  const Scratch s = scratch_layout(L, d, ffn, heads, kv_heads, s_max);
  for (int i = 0; i <= Scratch::TOTAL; ++i) starts[i] = (long long)s.at[i];
  return 0;
}

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
// layer's f32 q/k/v after RoPE (k and v are the returned new cache rows).
// scratch is laid out as Scratch says (tpa_fused_llama_stack_scratch), and
// the caller zeroes its arrival counters; xq is int8 [max(d, ffn)]. Every
// pointer is 16-byte aligned. tap_q / tap_s, when not null, receive every
// GEMV input's int8 codes and scale, int8 [L, 4, max(d, ffn)] and f32 [L,
// 4], in the order of the layer's GEMV inputs (q/k/v, o, gate/up, down).
extern "C" int tpa_fused_llama_stack(
    float* resid, const int8_t* w_in, const int8_t* w_down, const float* scales,
    const float* norms, const float* inv_freq, __nv_bfloat16* kcache,
    __nv_bfloat16* vcache, float* qkv, float* scratch, int8_t* xq, int8_t* tap_q,
    float* tap_s, int L, int d, int ffn, int heads, int kv_heads, int s_max,
    int offset, int valid_from, int qk_norm, float eps, cudaStream_t stream) {
  if (valid_from < 0 || valid_from > offset || offset >= s_max || heads % kv_heads ||
      d != heads * HD || ffn % 16)
    return (int)cudaErrorInvalidValue;
  const int dkv = kv_heads * HD, rep = heads / kv_heads, kmax = max(d, ffn);
  const int R = 2 * d + 2 * dkv + 2 * ffn, ldq = d + 2 * dkv;
  const float sm = 1.0f / sqrtf((float)HD);
  const int nc = tpa::attn_chunks(offset + 1 - valid_from);
  const Scratch at = scratch_layout(L, d, ffn, heads, kv_heads, s_max);
  float* attn = scratch + at.at[Scratch::ATTN];
  float* h = scratch + at.at[Scratch::H];
  float* xs = scratch + at.at[Scratch::XS];
  float* part_o = scratch + at.at[Scratch::PART_O];
  float* part_ml = scratch + at.at[Scratch::PART_ML];
  int* counts = reinterpret_cast<int*>(scratch + at.at[Scratch::COUNTS]);
  int opt_in = 0;
  cudaFuncAttributes fq, fg;
  Chain chain(stream);
  chain.keep(configure_chain(&opt_in));
  chain.keep(cudaFuncGetAttributes(&fq, fl5_quantize));
  chain.keep(cudaFuncGetAttributes(&fg, GEMV_KERNELS[0][0]));
  if (chain.error() != cudaSuccess) return (int)chain.error();
  // the widest quantise (a d-wide RMSNorm row, the ffn-wide SwiGLU row) and
  // the o GEMV's own quantisation within the shared memory a block may have
  if (std::max(quantize_smem(QUANT_RMS, d), quantize_smem(QUANT_PLAIN, ffn)) +
              fq.sharedSizeBytes > (size_t)opt_in ||
      gemv_smem(IN_PLAIN, d) + fg.sharedSizeBytes > (size_t)opt_in)
    return (int)cudaErrorInvalidValue;
  // an attention block computes hp query heads at once: the largest divisor
  // of rep up to MAX_GROUP; its shared memory holds the staged K/V rows,
  // the rep q heads, k and v
  int hp = 1;
  for (int g = 1; g <= std::min(rep, MAX_GROUP); ++g)
    if (rep % g == 0) hp = g;
  const size_t attn_smem = (2 * K_HALF + CH * KV_LD) * sizeof(__nv_bfloat16) +
                           (size_t)(rep + 2) * HD * sizeof(float);
  for (int l = 0; l < L; ++l) {
    const int8_t* wl = w_in + (size_t)l * R * d;
    const float* sl = scales + (size_t)l * (R + d);
    const float* nl = norms + (size_t)l * 4 * d;
    float* qkvl = qkv + (size_t)l * ldq;
    __nv_bfloat16* kcl = kcache + (size_t)l * s_max * dkv;
    __nv_bfloat16* vcl = vcache + (size_t)l * s_max * dkv;
    // the tap of GEMV input g of this layer, or null
    auto tq = [&](int g) {
      return tap_q == nullptr ? nullptr : tap_q + ((size_t)l * 4 + g) * kmax;
    };
    auto ts = [&](int g) { return tap_s == nullptr ? nullptr : tap_s + (size_t)l * 4 + g; };

    quantize(chain, resid, nl, QUANT_RMS, eps, xq, xs, d, tq(0), ts(0));
    gemv(chain, {xq, xs, wl, sl, qkvl, nullptr, nullptr, IN_CODES, STORE, ldq, d});
    chain.launch(fl5_rope, dim3(heads + kv_heads), dim3(HD), 0, qkvl,
                 qk_norm ? nl + 2 * d : nullptr, qk_norm ? nl + 3 * d : nullptr, inv_freq,
                 kcl + (size_t)offset * dkv, vcl + (size_t)offset * dkv, d, dkv, heads, eps,
                 offset);
    chain.launch(fl5_attn, dim3(nc, kv_heads), dim3(hp * AT), attn_smem, qkvl, kcl, vcl,
                 part_o, part_ml, counts + (size_t)l * kv_heads, attn, offset, valid_from, d,
                 dkv, rep, sm);
    gemv(chain, {attn, nullptr, wl + (size_t)ldq * d, sl + ldq, resid, tq(1), ts(1),
                 IN_PLAIN, ADD, d, d});
    quantize(chain, resid, nl + d, QUANT_RMS, eps, xq, xs, d, tq(2), ts(2));
    gemv(chain, {xq, xs, wl + (size_t)(d + ldq) * d, sl + d + ldq, h, nullptr, nullptr,
                 IN_CODES, SWIGLU, ffn, d});
    quantize(chain, h, nullptr, QUANT_PLAIN, eps, xq, xs, ffn, tq(3), ts(3));
    gemv(chain, {xq, xs, w_down + (size_t)l * d * ffn, sl + R, resid, nullptr, nullptr,
                 IN_CODES, ADD, d, ffn});
  }
  if (chain.error() != cudaSuccess) return (int)chain.error();
  return (int)cudaGetLastError();
}
