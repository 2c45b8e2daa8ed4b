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
// Bound on the H100: bytes. At whisper-large-v3 (d = 1280, ffn = 5120,
// L = 32, 20 heads, 1500 source positions) a token streams 14*d*d*L = 734 MB
// of int8 weights plus 2*1500*d*L = 123 MB of int8 cross K/V (and under
// 100 MB of bf16 self cache): ~0.26 ms at 3.35 TB/s. The operations
// (~1.7 GOP) are negligible. What the TPU kernel gets right is a uniform
// weight stream that Mosaic double-buffers across grid steps and that never
// waits on the layer chain. Hopper blocks run in no order, so the layer loop
// runs on the host side of this file, 8 stream-ordered launches a layer:
//   q/k/v GEMV, self-attention, out GEMV, cross-q GEMV, cross-attention,
//   cross-out GEMV, fc1 GEMV, fc2 GEMV.
// The design gets the stream back as follows.
//   Loads before the dependency wait. Every launch after a call's first is
//     a programmatic dependent launch (PDL): it starts while its predecessor
//     runs, and before griddepcontrol.wait it only reads what no launch of
//     the call writes (weights, scales, biases, LayerNorm parameters, cross
//     K/V and their scales, self-cache rows below `offset`) and writes
//     nothing. A GEMV lane loads its 16-byte chunks of its rows into
//     registers there (ld.global.nc.L1::no_allocate), with the rows'
//     scales and biases; the LayerNorm parameters go to shared memory by
//     cp.async. So the weight stream runs one stage ahead of the chain.
//     After the wait a GEMV stages x by 16-byte cp.async (all in flight at
//     once) and reads the rows an ADD adds into at once.
//   16-byte attention loads. An attention block (64 positions x 1 head)
//     stages its K and V rows in shared memory with 16-byte cp.async before
//     the wait (a head's 64 values are strided by d between positions; the
//     staged rows are padded by 16 bytes to spread the banks). The old
//     kernel's loads were one byte (int8) or two (bf16) a thread a load.
//   The combine folded in. The last block of a head to finish (an arrival
//     counter per layer, stage and head, zeroed once a call by the wrapper,
//     behind __threadfence) copies the head's partials with 16-byte L2 loads
//     and combines them in chunk order. No float atomics: the result does not
//     depend on block order.
//   Grids. A GEMV block is 8 warps of R rows (R = ceil(N / GEMV_R1_ROWS):
//     160 blocks at every GEMV of large-v3); a lane holds C chunks a row (C =
//     3 at K = 1280, 10 at 5120).
// The arithmetic is the old kernel's and kernel 4's, function for function:
// ln_quantize_row builds each LayerNorm GEMV input and quantize_staged_row
// the others (256 threads), exact int32 dp4a sums, gemv_epilogue, attn_partial's order of sums (on Score / Value types
// that read the staged rows), combine_partials. So this kernel stays bit
// for bit equal to fused_decoder_lanes.cu at one lane.
// Measured at large-v3, offset 100 (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py --fused-stack-timing, PERF.md): 1.42 ms a call back to back
// against 2.98 for the old 10-launch chain. What holds it now is each
// launch's chain after its wait (the release, x from L2, the LayerNorm's
// and quantisation's block reductions, the combine), 3-7 us a stage, not
// the bytes. Tried as copies of this file timed beside it, and not kept:
// no PDL (1.83 ms); an L2 prefetch of the next stage's first bytes by
// every launch (cp.async.bulk.prefetch.L2; 1.60 ms: its traffic delays the
// chain's own loads, and one stage of lead already covers the stream); x
// staged through registers (the same time, 26 more registers at q/k/v);
// GEMV grids of at most 132 blocks, so that neighbours always fit beside
// each other (1056 rows at one row a warp; the same time).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <utility>

#include "decoder_common.cuh"
#include "hopper.cuh"

namespace {

using tpa::ADD;
using tpa::CROSS_LD;
using tpa::GELU;
using tpa::GEMV_THREADS;
using tpa::SELF_LD;
using tpa::STORE;
using tpa::StagedCrossScore;
using tpa::StagedCrossValue;
using tpa::StagedSelfScore;
using tpa::StagedSelfValue;

constexpr int HD = tpa::ATTN_HD;
constexpr int CH = tpa::ATTN_CHUNK;
constexpr int GEMV_WARPS = GEMV_THREADS / 32;
constexpr int GEMV_R1_ROWS = 1280;  // rows a GEMV takes at one row a warp
constexpr int GEMV_MAX_R = 4;       // fc1 of large-v3 (5120 rows)

struct GemvArgs {
  const float* x;     // [K] input (the residual for the LayerNorm GEMVs)
  const float* ln_w;  // [K] LayerNorm weight and bias, or null
  const float* ln_b;
  const int8_t* w;    // [N, K] int8
  const float* w_scale;
  const float* bias;  // [N] or null
  float* out;         // [N]
  int mode, N, K;
};

__device__ __forceinline__ void epilogue(int mode, int acc, float ws, float xs,
                                         const float* bias, float* out) {
  if (mode == GELU)
    tpa::gemv_epilogue<GELU>(acc, ws, xs, bias, out);
  else if (mode == ADD)
    tpa::gemv_epilogue<ADD>(acc, ws, xs, bias, out);
  else
    tpa::gemv_epilogue<STORE>(acc, ws, xs, bias, out);
}

// out[o] (=, +=, or GELU) epilogue(sum_i xq[i] * w[o, i]) for the R rows of
// each warp, where xq is the int8 quantisation of LN(x) (ln_w != nullptr)
// or of x. Before the wait each lane loads chunks lane, lane + 32, ... (C
// of them) of each of its rows, and the rows' scales and biases.
template <int R, int C>
__global__ void __launch_bounds__(GEMV_THREADS) fs_gemv(const GemvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = a.K;
  int8_t* xq = reinterpret_cast<int8_t*>(smem_raw);    // [K]
  float* xf = reinterpret_cast<float*>(smem_raw + K);  // [K] (K % 16 == 0)
  float* lw = xf + K;  // with a LayerNorm: its weight [K], bias [K], and x [K]
  float* lb = lw + K;
  float* xin = lb + K;
  __shared__ float red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvec = K / 16;
  const int row0 = (blockIdx.x * GEMV_WARPS + warp) * R;

  int4 wr[R][C];
  float ws[R], bs[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = min(row0 + r, a.N - 1);
    const int4* wv = reinterpret_cast<const int4*>(a.w + (size_t)row * K);
#pragma unroll
    for (int c = 0; c < C; ++c)
      wr[r][c] = lane + 32 * c < nvec ? ld_stream(wv + lane + 32 * c) : make_int4(0, 0, 0, 0);
    ws[r] = a.w_scale[row];
    bs[r] = a.bias != nullptr ? a.bias[row] : 0.0f;
  }
  if (a.ln_w != nullptr) {
    for (int i = threadIdx.x * 4; i < K; i += GEMV_THREADS * 4) {
      cp_async16(lw + i, a.ln_w + i);
      cp_async16(lb + i, a.ln_b + i);
    }
  }
  dependency_wait();
  release_dependents();
  float old_out[R];  // the rows an ADD adds into, read at once
  if (a.mode == ADD && lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) old_out[r] = __ldcg(a.out + min(row0 + r, a.N - 1));
  }
  // x into shared memory by 16-byte cp.async, all in flight at once (through
  // L2, past L1); without a LayerNorm straight into xf, which
  // quantize_staged_row then reads as ln_quantize_row would have copied it
  const bool ln = a.ln_w != nullptr;
  float* xs_in = ln ? xin : xf;
  for (int i = threadIdx.x * 4; i < K; i += GEMV_THREADS * 4) cp_async16(xs_in + i, a.x + i);
  cp_async_wait_all();
  __syncthreads();
  const float xs = ln ? tpa::ln_quantize_row(xin, lw, lb, xf, xq, K, red)
                      : tpa::quantize_staged_row(xf, xq, K, red);
  const int4* xv = reinterpret_cast<const int4*>(xq);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    int acc = 0;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (lane + 32 * c < nvec) acc = dot16(wr[r][c], xv[lane + 32 * c], acc);
    // rows wider than C chunks a lane (K > 32 * 16 * C) load the rest here
    const int4* wv = reinterpret_cast<const int4*>(a.w + (size_t)min(row, a.N - 1) * K);
    for (int i = lane + 32 * C; i < nvec; i += 32) acc = dot16(ld_stream(wv + i), xv[i], acc);
    acc = tpa::warp_sum_int(acc);
    const float b = bs[r];
    if (lane == 0 && row < a.N) {
      float y = a.mode == ADD ? old_out[r] : 0.0f;
      epilogue(a.mode, acc, ws[r], xs, a.bias != nullptr ? &b : nullptr, &y);
      a.out[row] = y;
    }
  }
}

// After attn_partial: the last of the nc blocks of head blockIdx.y to
// arrive combines the head's partials (laid out [heads, nc, HD] and
// [heads, nc, 2]) into out[head * HD + j] by tpa::combine_partials, in chunk
// order. `sbuf` is shared memory of nc * (HD + 2) floats (the staging area:
// attn_partial has finished reading it).
__device__ __forceinline__ void combine_last(const float* part_o, const float* part_ml,
                                             int* count, int nc, float* out, float* sbuf) {
  __shared__ int last;
  __threadfence();  // this block's partial, before its arrival
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(count + blockIdx.y, 1) == nc - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t base = (size_t)blockIdx.y * nc;
  float* sml = sbuf + nc * HD;
  // every load of a thread in flight at once (16 bytes each for part_o)
  const float4* po = reinterpret_cast<const float4*>(part_o + base * HD);
  const int n4 = nc * HD / 4;
  for (int i0 = threadIdx.x; i0 < max(n4, 2 * nc); i0 += 4 * blockDim.x) {
    float4 v[4];
    float m[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n4) v[u] = __ldcg(po + i);
      if (i < 2 * nc) m[u] = __ldcg(part_ml + base * 2 + i);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n4) reinterpret_cast<float4*>(sbuf)[i] = v[u];
      if (i < 2 * nc) sml[i] = m[u];
    }
  }
  __syncthreads();
  if (threadIdx.x < HD)
    out[blockIdx.y * HD + threadIdx.x] = tpa::combine_partials(sbuf, sml, nc, HD, threadIdx.x);
}

// grid (chunks of positions 0..offset, heads). qkv: this layer's [3d] q/k/v;
// kc/vc: this layer's [s_max, d] caches. The block holding `offset` then
// writes this head's new k/v row into the caches (as bf16); no block of the
// call reads that row from the cache.
__global__ void __launch_bounds__(tpa::ATTN_THREADS)
fs_self_attn(const float* qkv, __nv_bfloat16* kc, __nv_bfloat16* vc, float* part_o,
             float* part_ml, int* count, float* out, int offset, int d, float sm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [CH, SELF_LD]
  __nv_bfloat16* sv = sk + CH * SELF_LD;
  const int c = blockIdx.x, h = blockIdx.y, nc = gridDim.x;
  const int col = h * HD;
  const int s0 = c * CH;
  const int s1 = min(offset + 1, s0 + CH);
  const int staged = min(s1, offset) - s0;  // the rows below offset
  constexpr int V = HD * 2 / 16;            // 16-byte pieces a row
  for (int i = threadIdx.x; i < staged * V; i += blockDim.x) {
    const int r = i / V, e = (i % V) * 8;
    const size_t g = (size_t)(s0 + r) * d + col + e;
    cp_async16(sk + r * SELF_LD + e, kc + g);
    cp_async16(sv + r * SELF_LD + e, vc + g);
  }
  dependency_wait();
  release_dependents();
  cp_async_wait_all();
  __syncthreads();
  const StagedSelfScore score{qkv + col, qkv + d + col, sk, s0, offset, sm};
  const StagedSelfValue value{qkv + 2 * d + col, sv, s0, offset};
  const size_t slot = (size_t)h * nc + c;
  tpa::attn_partial<HD>(score, value, s0, s1, part_o + slot * HD, part_ml + slot * 2);
  if (offset < s1 && threadIdx.x < HD) {
    const size_t row = (size_t)offset * d + col + threadIdx.x;
    kc[row] = __float2bfloat16(qkv[d + col + threadIdx.x]);
    vc[row] = __float2bfloat16(qkv[2 * d + col + threadIdx.x]);
  }
  combine_last(part_o, part_ml, count, nc, out, reinterpret_cast<float*>(smem_raw));
}

// grid (chunks of positions 0..S, heads) over one layer's int8 cross K/V
// [s_ck, d] and their per-position scales.
__global__ void __launch_bounds__(tpa::ATTN_THREADS)
fs_cross_attn(const float* q, const int8_t* ck, const float* ks, const int8_t* cv,
              const float* vs, float* part_o, float* part_ml, int* count, float* out,
              int S, int d, float sm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* sk = reinterpret_cast<int8_t*>(smem_raw);  // [CH, CROSS_LD]
  int8_t* sv = sk + CH * CROSS_LD;
  float* sks = reinterpret_cast<float*>(sv + CH * CROSS_LD);  // [CH]
  float* svs = sks + CH;
  const int c = blockIdx.x, h = blockIdx.y, nc = gridDim.x;
  const int col = h * HD;
  const int s0 = c * CH;
  const int s1 = min(S, s0 + CH);
  constexpr int V = HD / 16;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < (s1 - s0) * V; i += blockDim.x) {
    const int r = i / V, e = (i % V) * 16;
    const size_t g = (size_t)(s0 + r) * d + col + e;
    cp_async16(sk + r * CROSS_LD + e, ck + g);
    cp_async16(sv + r * CROSS_LD + e, cv + g);
  }
  for (int i = threadIdx.x; i < s1 - s0; i += blockDim.x) {
    cp_async4(sks + i, ks + s0 + i);
    cp_async4(svs + i, vs + s0 + i);
  }
  dependency_wait();
  release_dependents();
  cp_async_wait_all();
  __syncthreads();
  const StagedCrossScore score{q + col, sk, sks, s0, sm};
  const StagedCrossValue value{sv, svs, s0};
  const size_t slot = (size_t)h * nc + c;
  tpa::attn_partial<HD>(score, value, s0, s1, part_o + slot * HD, part_ml + slot * 2);
  combine_last(part_o, part_ml, count, nc, out, reinterpret_cast<float*>(smem_raw));
}

using GemvKernel = void (*)(GemvArgs);
constexpr int GEMV_CS[] = {1, 2, 3, 4, 6, 8, 10};  // chunks a lane holds a row

#define TPA_GEMV_ROW(R)                                                              \
  {fs_gemv<R, 1>, fs_gemv<R, 2>, fs_gemv<R, 3>, fs_gemv<R, 4>, fs_gemv<R, 6>, \
   fs_gemv<R, 8>, fs_gemv<R, 10>}
const GemvKernel GEMV_KERNELS[GEMV_MAX_R][7] = {TPA_GEMV_ROW(1), TPA_GEMV_ROW(2),
                                               TPA_GEMV_ROW(3), TPA_GEMV_ROW(4)};
#undef TPA_GEMV_ROW

// R rows a warp and C chunks a lane for an [N, K] GEMV, and its grid.
void gemv(Chain& chain, const GemvArgs& a) {
  const int R = std::min(GEMV_MAX_R, (a.N + GEMV_R1_ROWS - 1) / GEMV_R1_ROWS);
  const int chunks = (a.K / 16 + 31) / 32;
  int ci = 0;
  while (ci < 6 && GEMV_CS[ci] < chunks) ++ci;
  const int blocks = (a.N + GEMV_WARPS * R - 1) / (GEMV_WARPS * R);
  const size_t smem = (size_t)a.K * (1 + sizeof(float)) +
                      (a.ln_w != nullptr ? 3 * (size_t)a.K * sizeof(float) : 0);
  chain.launch(GEMV_KERNELS[R - 1][ci], dim3(blocks), dim3(GEMV_THREADS), smem, a);
}

// The f32 scratch of one call, in 4-byte words from its start: attn [d],
// q2 [d], ca [d], h [ffn], the split-S attention partials [heads, nc, hd]
// and [heads, nc, 2] with nc = ceil(max(s_max, s_src) / 64), then the
// int32 arrival counters [L, 2 (self, cross), heads]; at[7] is the total.
struct Scratch {
  enum { ATTN, Q2, CA, H, PART_O, PART_ML, COUNTS, TOTAL };
  size_t at[TOTAL + 1];
};

Scratch scratch_layout(int d, int ffn, int L, int heads, int s_max, int s_src) {
  const size_t nc = tpa::attn_chunks(std::max(s_max, s_src));
  const size_t len[Scratch::TOTAL] = {(size_t)d, (size_t)d, (size_t)d, (size_t)ffn,
                                      heads * nc * HD, heads * nc * 2, (size_t)L * 2 * heads};
  Scratch s;
  s.at[0] = 0;
  for (int i = 0; i < Scratch::TOTAL; ++i) s.at[i + 1] = s.at[i] + len[i];
  return s;
}

}  // namespace

// The scratch layout tpa_fused_stack uses (Scratch): the start of each
// region in 4-byte words, then the total, into starts[8].
extern "C" int tpa_fused_stack_scratch(int d, int ffn, int L, int heads, int s_max,
                                       int s_src, long long* starts) {
  const Scratch s = scratch_layout(d, ffn, L, heads, s_max, s_src);
  for (int i = 0; i <= Scratch::TOTAL; ++i) starts[i] = (long long)s.at[i];
  return 0;
}

// Runs all L layers for one token. `resid` [d] holds the embedded token on
// entry and the stack output on return. Pack layout per layer l (see
// tpu_audio_torch/ops/fused_decoder.py:pack_decoder_weights):
//   w_in   [L, 6d + ffn, d] int8  rows q, k, v, o, cross-q, cross-o, fc1
//   w_fc2  [L, d, ffn]      int8  output-major
//   scales [L, 7d + ffn]    f32   per output row, same order, fc2 last
//   biases [L, 7d + ffn]    f32   (k rows are zero)
//   ln     [L, 6, d]        f32   self, cross, final LayerNorm (w, b)
// ck/cv [L, s_ck, d] and ks/vs [L, s_ck]: the first s_src rows are attended.
// Every pointer is 16-byte aligned. qkv [L, 3d] receives each layer's f32
// q/k/v (k and v are the returned new cache rows); scratch is laid out as
// Scratch says (tpa_fused_stack_scratch), and the caller zeroes its
// arrival counters.
extern "C" int tpa_fused_stack(float* resid, const int8_t* w_in,
                               const int8_t* w_fc2, const float* scales,
                               const float* biases, const float* ln,
                               const int8_t* ck, const float* ks,
                               const int8_t* cv, const float* vs,
                               __nv_bfloat16* kcache, __nv_bfloat16* vcache,
                               float* qkv, float* scratch, int L, int d,
                               int ffn, int heads, int s_src, int s_ck,
                               int s_max, int offset, cudaStream_t stream) {
  if (d != heads * HD || d % 16 != 0 || ffn % 16 != 0) return (int)cudaErrorInvalidValue;
  const float sm = 1.0f / sqrtf((float)HD);
  const int n_in = 6 * d + ffn, n_sc = 7 * d + ffn;
  const int nc_self = tpa::attn_chunks(offset + 1);
  const int nc_cross = tpa::attn_chunks(s_src);
  const Scratch at = scratch_layout(d, ffn, L, heads, s_max, s_src);
  float* attn = scratch + at.at[Scratch::ATTN];
  float* q2 = scratch + at.at[Scratch::Q2];
  float* ca = scratch + at.at[Scratch::CA];
  float* hbuf = scratch + at.at[Scratch::H];
  float* part_o = scratch + at.at[Scratch::PART_O];
  float* part_ml = scratch + at.at[Scratch::PART_ML];
  int* counts = reinterpret_cast<int*>(scratch + at.at[Scratch::COUNTS]);
  const size_t self_smem = std::max(2 * CH * SELF_LD * sizeof(__nv_bfloat16),
                               (size_t)nc_self * (HD + 2) * sizeof(float));
  const size_t cross_smem = std::max(2 * CH * (CROSS_LD + sizeof(float)),
                                (size_t)nc_cross * (HD + 2) * sizeof(float));
  if (std::max(self_smem, cross_smem) > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 attn_block(tpa::ATTN_THREADS);
  Chain chain(stream);
  for (int l = 0; l < L; ++l) {
    const int8_t* wl = w_in + (size_t)l * n_in * d;
    const float* sl = scales + (size_t)l * n_sc;
    const float* bl = biases + (size_t)l * n_sc;
    const float* lnl = ln + (size_t)l * 6 * d;
    const int8_t* fc2l = w_fc2 + (size_t)l * d * ffn;
    float* qkvl = qkv + (size_t)l * 3 * d;
    __nv_bfloat16* kcl = kcache + (size_t)l * s_max * d;
    __nv_bfloat16* vcl = vcache + (size_t)l * s_max * d;
    const size_t xkv = (size_t)l * s_ck * d;
    const size_t dd = (size_t)d * d;

    gemv(chain, {resid, lnl, lnl + d, wl, sl, bl, qkvl, STORE, 3 * d, d});
    chain.launch(fs_self_attn, dim3(nc_self, heads), attn_block, self_smem, qkvl, kcl, vcl,
                 part_o, part_ml, counts + (size_t)(2 * l) * heads, attn, offset, d, sm);
    gemv(chain, {attn, nullptr, nullptr, wl + 3 * dd, sl + 3 * d, bl + 3 * d, resid, ADD,
                 d, d});
    gemv(chain, {resid, lnl + 2 * d, lnl + 3 * d, wl + 4 * dd, sl + 4 * d, bl + 4 * d, q2,
                 STORE, d, d});
    chain.launch(fs_cross_attn, dim3(nc_cross, heads), attn_block, cross_smem, q2, ck + xkv,
                 ks + (size_t)l * s_ck, cv + xkv, vs + (size_t)l * s_ck, part_o, part_ml,
                 counts + (size_t)(2 * l + 1) * heads, ca, s_src, d, sm);
    gemv(chain, {ca, nullptr, nullptr, wl + 5 * dd, sl + 5 * d, bl + 5 * d, resid, ADD, d,
                 d});
    gemv(chain, {resid, lnl + 4 * d, lnl + 5 * d, wl + 6 * dd, sl + 6 * d, bl + 6 * d, hbuf,
                 GELU, ffn, d});
    gemv(chain, {hbuf, nullptr, nullptr, fc2l, sl + 6 * d + ffn, bl + 6 * d + ffn, resid,
                 ADD, d, ffn});
  }
  if (chain.error() != cudaSuccess) return (int)chain.error();
  return (int)cudaGetLastError();
}
