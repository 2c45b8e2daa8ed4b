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
// half to even on a true division). Every per-row quantity is computed by
// the device functions fused_decoder.cu uses, in the same order, so lane m
// is bit-equal to that kernel run on lane m's inputs.
//
// Bound on the H100: bytes. A step streams the layers' int8 weights once
// for all lanes (734 MB at whisper-large-v3: 14 d^2 L bytes, d = 1280,
// L = 32) plus, per lane, its int8 cross K/V (123 MB: 2 * 1500 * d * L)
// and the bf16 self-cache rows it attends (up to 73 MB at 448 positions):
// ~0.22 ms at 3.35 TB/s for the weights, ~0.04 ms more a lane. The
// operations (~1.7 G int8 multiply-adds a lane) stay far below the int8
// rate. Hopper blocks run in no order, so the layer loop runs on the host
// side of this file, 14 launches a layer:
//   quantise, q/k/v GEMV, self-attention, quantise, out GEMV, quantise,
//   cross-q GEMV, cross-attention, quantise, cross-out GEMV, quantise, fc1
//   GEMV, quantise, fc2 GEMV.
// What the design does about the bound:
//   Loads before the dependency wait. Every launch after a call's first is
//     a programmatic dependent launch (PDL, hopper.cuh's Chain): before
//     griddepcontrol.wait it only reads what no launch of the call writes
//     (weights, scales, biases, LayerNorm parameters, the lanes and offsets
//     arrays, each lane's cross K/V and scales, self-cache rows below each
//     lane's offset) and writes nothing. A GEMV warp loads its row's 16-byte
//     chunks into registers there (ld.global.nc.L1::no_allocate), a quantise
//     block its LayerNorm parameters into shared memory, an attention block
//     issues its K/V copies. So the weight stream runs one stage ahead of
//     the chain.
//   A quantise launch a GEMV input: one 256-thread block a lane row runs
//     ln_quantize_row (kernel 3's GEMV prologue) on a shared-memory copy of
//     the row, into the int8 codes xq [n, K] and scales xs [n] in global
//     memory, once for all the GEMV's blocks.
//   One warp a weight row, and lane m of the warp finishes output m (as
//     fused_llama_lanes.cu's GEMV): 16 warps a block stage the n int8 rows
//     and their scales after the wait, exact __dp4a int32 sums, then
//     gemv_epilogue with the row's bias (tanh-GELU for fc1; an ADD reads
//     the old residual through L2).
//   Staged attention with the combines folded in (fused_decoder.cu's, with a
//     lane dimension). Grids (chunk, head, lane), the self grid sized from
//     s_max with no host read of the offsets (a block past its lane's
//     offset exits before it arrives anywhere). Each block stages its 64
//     positions of its lane's slot with 16-byte cp.async into padded rows
//     (tpa::SELF_LD, CROSS_LD), the cross blocks also their scales, and runs
//     attn_partial on tpa::Staged* types; the current token's k/v come from
//     the f32 q/k/v, and the block holding the offset writes them into the
//     cache after the wait. The last of a (layer, stage, head, lane)'s live
//     chunks to arrive (offset / 64 + 1 for self, ceil(s_src / 64) for
//     cross; an arrival counter each, zeroed once a call by the wrapper,
//     behind __threadfence) combines them in chunk order with
//     combine_partials. No float atomics: the result does not depend on
//     block order.
// The GEMV stages the n int8 rows of its input (n * K bytes: the fc2 input,
// K = ffn = 5120, takes 160 KB at 32 lanes), within the shared memory a
// block may opt into (supported_lanes() in ops/fused_decoder.py; n <= 32 at
// large-v3). Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py
// --fused-lanes-timing, PERF.md): 1.65 / 2.18 / 2.87 / 6.96 ms of device
// time at 1 / 4 / 8 / 32 lanes against the parent's 2.51 / 3.55 / 4.81 /
// 14.23, which ran 16 stream-ordered launches a layer (a combine launch
// after each attention, byte loads of K/V, lane 0 of a warp finishing
// every output). Tried as copies of this file timed beside it, and not
// kept: the quantisation folded into each GEMV's blocks (8 launches a
// layer, a warp a lane row repeating ln_quantize_row's sums and tree bit
// for bit; 2.88 / 3.75 ms at 1 / 4 lanes, slower than the parent: every
// block repeats the serial warp reductions, in 2-3 waves of blocks at
// q/k/v and fc1); the three quantise launches without a LayerNorm folded
// into their neighbours (11 launches a layer: the combines and fc1's
// epilogue atomicMax each row's max|x|, the next GEMV rounds the f32 rows;
// 1.56 ms at one lane, slower from 4 lanes, every block reading the f32
// rows).
// An offset outside [0, s_max) is clamped to that range (as the JAX
// package's dynamic_update_slice clamps): a serving lane frozen at the
// cache's end overwrites its own last row, never another's. Lanes must have
// distinct slots.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "decoder_common.cuh"
#include "hopper.cuh"

namespace {

using tpa::ADD;
using tpa::CROSS_LD;
using tpa::GELU;
using tpa::MAX_LANES;
using tpa::SELF_LD;
using tpa::STORE;

constexpr int HD = tpa::ATTN_HD;
constexpr int CH = tpa::ATTN_CHUNK;
constexpr int LANE_GEMV_THREADS = 512;  // a GEMV block: a warp a weight row
constexpr int GEMV_WARPS = LANE_GEMV_THREADS / 32;

__device__ __forceinline__ int lane_offset(const int* offsets, int m, int s_max) {
  return min(max(offsets[m], 0), s_max - 1);
}

struct LaneGemv {
  const int8_t* xq;      // [n, K] codes of the input rows
  const float* xs;       // [n] their scales
  const int8_t* w;       // [N, K] int8
  const float* w_scale;  // [N]
  const float* bias;     // [N]
  float* out;            // out[m * ldo + row]
  int8_t* tap_q;         // null, or this input's codes [n, tap_ld] and scales [n]
  float* tap_s;
  int ldo, tap_ld, mode, N, K, n;
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

// out[m * ldo + o] (=, +=, or GELU) epilogue(sum_i xq[m, i] * w[o, i]) for
// o < N and every lane m < n (n <= NL), one warp a row: a lane holds C
// 16-byte chunks of it (chunks lane, lane + 32, ...; rows wider than 512 C
// bytes load the rest after), loaded with the row's scale and bias before
// the wait; the n int8 rows of x and their scales are staged in shared
// memory after it. Lane m of the warp finishes output m (every lane holds
// every sum), so a row's n epilogues run at once. Block 0 copies the codes
// and scales into the tap when there is one.
template <int NL, int C>
__global__ void __launch_bounds__(LANE_GEMV_THREADS) fd4_gemv(const LaneGemv a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float sxs[MAX_LANES];
  const int K = a.K, nvec = K / 16;
  int8_t* xq = reinterpret_cast<int8_t*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * GEMV_WARPS + warp;
  const int4* wv = reinterpret_cast<const int4*>(a.w + (size_t)min(row, a.N - 1) * K);
  int4 wr[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    wr[c] = lane + 32 * c < nvec ? ld_stream(wv + lane + 32 * c) : make_int4(0, 0, 0, 0);
  const float ws = a.w_scale[min(row, a.N - 1)], bs = a.bias[min(row, a.N - 1)];
  dependency_wait();
  release_dependents();
  const int4* src = reinterpret_cast<const int4*>(a.xq);
  for (int i = threadIdx.x; i < a.n * nvec; i += LANE_GEMV_THREADS)
    cp_async16(reinterpret_cast<int4*>(xq) + i, src + i);
  if (threadIdx.x < a.n) sxs[threadIdx.x] = __ldcg(a.xs + threadIdx.x);
  cp_async_wait_all();
  __syncthreads();
  const int4* xv = reinterpret_cast<const int4*>(xq);
  if (a.tap_q != nullptr && blockIdx.x == 0) {
    for (int i = threadIdx.x; i < a.n * nvec; i += LANE_GEMV_THREADS)
      reinterpret_cast<int4*>(a.tap_q + (size_t)(i / nvec) * a.tap_ld)[i % nvec] = xv[i];
    if (threadIdx.x < a.n) a.tap_s[threadIdx.x] = sxs[threadIdx.x];
  }
  if (row >= a.N) return;
  int acc[NL];
#pragma unroll
  for (int m = 0; m < NL; ++m) acc[m] = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (lane + 32 * c < nvec) {
#pragma unroll
      for (int m = 0; m < NL; ++m)
        if (m < a.n) acc[m] = dot16(wr[c], xv[m * nvec + lane + 32 * c], acc[m]);
    }
  }
  for (int i = lane + 32 * C; i < nvec; i += 32) {
    const int4 b = ld_stream(wv + i);
#pragma unroll
    for (int m = 0; m < NL; ++m)
      if (m < a.n) acc[m] = dot16(b, xv[m * nvec + i], acc[m]);
  }
  int mine = 0;
#pragma unroll
  for (int m = 0; m < NL; ++m) {
    if (m < a.n) {
      const int s = tpa::warp_sum_int(acc[m]);
      if (lane == m) mine = s;
    }
  }
  if (lane < a.n) {
    // what a predecessor wrote is read from L2
    float* o = a.out + (size_t)lane * a.ldo + row;
    float y = a.mode == ADD ? __ldcg(o) : 0.0f;
    epilogue(a.mode, mine, ws, sxs[lane], &bs, &y);
    *o = y;
  }
}

// Row m = blockIdx.x of x (row stride ldx): its int8 codes xq[m, :K] and
// scale xs[m] by tpa::ln_quantize_row (256 threads), the LayerNorm
// parameters copied into shared memory before the wait, the row after it.
__global__ void __launch_bounds__(tpa::GEMV_THREADS)
fd4_quantize(const float* x, int ldx, const float* ln_w, const float* ln_b, int8_t* xq,
             float* xs, int K) {
  extern __shared__ __align__(16) float qrow[];
  __shared__ float red[32];
  float* xin = qrow;
  float* xf = xin + K;
  float* lw = xf + K;
  float* lb = lw + K;
  if (ln_w != nullptr) {
    for (int i = 4 * threadIdx.x; i < K; i += 4 * tpa::GEMV_THREADS) {
      cp_async16(lw + i, ln_w + i);
      cp_async16(lb + i, ln_b + i);
    }
  }
  dependency_wait();
  release_dependents();
  const int m = blockIdx.x;
  for (int i = 4 * threadIdx.x; i < K; i += 4 * tpa::GEMV_THREADS)
    cp_async16(xin + i, x + (size_t)m * ldx + i);
  cp_async_wait_all();
  __syncthreads();
  const float s = tpa::ln_quantize_row(xin, ln_w != nullptr ? lw : nullptr, lb, xf,
                                       xq + (size_t)m * K, K, red);
  if (threadIdx.x == 0) xs[m] = s;
}

// After this block's partial: the last of `arrivals` blocks to arrive at
// *count combines the nc partials po [nc, HD] and pml [nc, 2] by
// tpa::combine_partials, in chunk order, into out[j]. `sbuf` is shared
// memory of nc * (HD + 2) floats (the staging area: attn_partial has
// finished reading it).
__device__ __forceinline__ void combine_last_lane(const float* po, const float* pml,
                                                  int* count, int arrivals, int nc,
                                                  float* out, float* sbuf) {
  __shared__ int last;
  __threadfence();  // this block's partial, before its arrival
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(count, 1) == arrivals - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* sml = sbuf + nc * HD;
  // every load of a thread in flight at once (16 bytes each for po)
  const float4* po4 = reinterpret_cast<const float4*>(po);
  const int n4 = nc * HD / 4;
  for (int i0 = threadIdx.x; i0 < max(n4, 2 * nc); i0 += 4 * blockDim.x) {
    float4 v[4];
    float ml[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n4) v[u] = __ldcg(po4 + i);
      if (i < 2 * nc) ml[u] = __ldcg(pml + i);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n4) reinterpret_cast<float4*>(sbuf)[i] = v[u];
      if (i < 2 * nc) sml[i] = ml[u];
    }
  }
  __syncthreads();
  if (threadIdx.x < HD) out[threadIdx.x] = tpa::combine_partials(sbuf, sml, nc, HD, threadIdx.x);
}

// grid (chunks of 0..s_max, heads, lanes). qkv is this layer's [n, 3d]
// q/k/v; kc/vc point at layer l of slot 0 of the [slots, L, s_max, d]
// caches. Block (c, h, m) stages rows 64 c.. below lane m's offset of head
// h of slot lanes[m], and writes its partial at [m, h, c] of the partials
// laid out [n, heads, gridDim.x, HD] and [.., 2]; the block holding the
// offset writes the lane's new k/v row of head h into the caches (bf16). The
// last of the lane's offset / 64 + 1 chunks to arrive (counts: this layer's
// self counters [heads, n]) combines them into out[m, h * HD + j].
__global__ void __launch_bounds__(tpa::ATTN_THREADS)
fd4_self_attn(const float* qkv, __nv_bfloat16* kc, __nv_bfloat16* vc, size_t slot_stride,
              const int* offsets, const int* lanes, float* part_o, float* part_ml,
              int* counts, float* out, int s_max, int d, float sm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(16) float sq[3 * HD];  // the lane's q, new k and new v of head h
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [CH, SELF_LD]
  __nv_bfloat16* sv = sk + CH * SELF_LD;
  const int c = blockIdx.x, h = blockIdx.y, m = blockIdx.z;
  const int heads = gridDim.y, n = gridDim.z;
  const int offset = lane_offset(offsets, m, s_max);
  const int s0 = c * CH;
  if (s0 > offset) return;  // past the lane's offset: not one of its live chunks
  const size_t base = (size_t)lanes[m] * slot_stride + h * HD;
  const int s1 = min(offset + 1, s0 + CH);
  const int staged = min(s1, offset) - s0;  // the rows below offset
  constexpr int V = HD * 2 / 16;            // 16-byte pieces a row
  for (int i = threadIdx.x; i < staged * V; i += blockDim.x) {
    const int r = i / V, e = (i % V) * 8;
    const size_t g = base + (size_t)(s0 + r) * d + e;
    cp_async16(sk + r * SELF_LD + e, kc + g);
    cp_async16(sv + r * SELF_LD + e, vc + g);
  }
  dependency_wait();
  release_dependents();
  const float* row = qkv + (size_t)m * 3 * d + h * HD;
  if (threadIdx.x < 3 * HD / 4) {
    const int p = threadIdx.x / (HD / 4), e = threadIdx.x % (HD / 4) * 4;
    cp_async16(sq + p * HD + e, row + (size_t)p * d + e);
  }
  cp_async_wait_all();
  __syncthreads();
  const tpa::StagedSelfScore score{sq, sq + HD, sk, s0, offset, sm};
  const tpa::StagedSelfValue value{sq + 2 * HD, sv, s0, offset};
  const size_t first = ((size_t)m * heads + h) * gridDim.x;  // the (lane, head)'s partials
  tpa::attn_partial<HD>(score, value, s0, s1, part_o + (first + c) * HD,
                        part_ml + (first + c) * 2);
  if (offset < s1 && threadIdx.x < HD) {
    const size_t at = base + (size_t)offset * d + threadIdx.x;
    kc[at] = __float2bfloat16(sq[HD + threadIdx.x]);
    vc[at] = __float2bfloat16(sq[2 * HD + threadIdx.x]);
  }
  const int live = offset / CH + 1;
  float* sbuf = reinterpret_cast<float*>(smem_raw);
  combine_last_lane(part_o + first * HD, part_ml + first * 2, counts + h * n + m, live, live,
                    out + (size_t)m * d + h * HD, sbuf);
}

// grid (chunks of 0..S, heads, lanes). q2 is [n, d]; ck/cv point at layer l
// of slot 0 of the [slots, L, s_ck, d] cross K/V, ks/vs at layer l of slot
// 0 of the [slots, L, s_ck] scales. Block (c, h, m) stages positions 64 c..
// of head h of slot lanes[m], with their scales; its partial and the
// combine of the lane's gridDim.x chunks are laid out as fd4_self_attn's.
__global__ void __launch_bounds__(tpa::ATTN_THREADS)
fd4_cross_attn(const float* q2, const int* lanes, const int8_t* ck, const float* ks,
               const int8_t* cv, const float* vs, size_t slot_kv, size_t slot_s,
               float* part_o, float* part_ml, int* counts, float* out, int S, int d,
               float sm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(16) float sq[HD];
  int8_t* sk = reinterpret_cast<int8_t*>(smem_raw);  // [CH, CROSS_LD]
  int8_t* sv = sk + CH * CROSS_LD;
  float* sks = reinterpret_cast<float*>(sv + CH * CROSS_LD);  // [CH]
  float* svs = sks + CH;
  const int c = blockIdx.x, h = blockIdx.y, m = blockIdx.z;
  const int heads = gridDim.y, n = gridDim.z;
  const size_t src = (size_t)lanes[m];  // the lane's slot
  const int8_t* kl = ck + src * slot_kv + h * HD;
  const int8_t* vl = cv + src * slot_kv + h * HD;
  const float* ksl = ks + src * slot_s;
  const float* vsl = vs + src * slot_s;
  const int s0 = c * CH;
  const int s1 = min(S, s0 + CH);
  constexpr int V = HD / 16;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < (s1 - s0) * V; i += blockDim.x) {
    const int r = i / V, e = (i % V) * 16;
    const size_t g = (size_t)(s0 + r) * d + e;
    cp_async16(sk + r * CROSS_LD + e, kl + g);
    cp_async16(sv + r * CROSS_LD + e, vl + g);
  }
  for (int i = threadIdx.x; i < s1 - s0; i += blockDim.x) {
    cp_async4(sks + i, ksl + s0 + i);
    cp_async4(svs + i, vsl + s0 + i);
  }
  dependency_wait();
  release_dependents();
  if (threadIdx.x < HD / 4)
    cp_async16(sq + 4 * threadIdx.x, q2 + (size_t)m * d + h * HD + 4 * threadIdx.x);
  cp_async_wait_all();
  __syncthreads();
  const tpa::StagedCrossScore score{sq, sk, sks, s0, sm};
  const tpa::StagedCrossValue value{sv, svs, s0};
  const size_t own = ((size_t)m * heads + h) * gridDim.x;  // the (lane, head)'s partials
  tpa::attn_partial<HD>(score, value, s0, s1, part_o + (own + c) * HD, part_ml + (own + c) * 2);
  combine_last_lane(part_o + own * HD, part_ml + own * 2, counts + h * n + m, gridDim.x,
                    gridDim.x, out + (size_t)m * d + h * HD, reinterpret_cast<float*>(smem_raw));
}

using GemvKernel = void (*)(LaneGemv);
constexpr int GEMV_KINDS = 2;
constexpr int GEMV_C[GEMV_KINDS] = {3, 10};  // chunks a lane holds a row: d, ffn of large-v3
constexpr int GEMV_NLS = 6;                  // NL = 1, 2, 4, 8, 16, 32

#define TPA_GEMV_NL(NL) {fd4_gemv<NL, 3>, fd4_gemv<NL, 10>}
const GemvKernel GEMV_KERNELS[GEMV_NLS][GEMV_KINDS] = {
    TPA_GEMV_NL(1), TPA_GEMV_NL(2), TPA_GEMV_NL(4), TPA_GEMV_NL(8), TPA_GEMV_NL(16),
    TPA_GEMV_NL(MAX_LANES)};
#undef TPA_GEMV_NL

// configure() for every kernel of the chain, once a device and process;
// the shared memory a block may opt into.
cudaError_t configure_chain(int* opt_in) {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(opt_in, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess || (done.load() >> dev & 1)) return e;
  const void* kernels[3 + GEMV_NLS * GEMV_KINDS] = {
      reinterpret_cast<const void*>(fd4_self_attn), reinterpret_cast<const void*>(fd4_cross_attn),
      reinterpret_cast<const void*>(fd4_quantize)};
  for (int i = 0; i < GEMV_NLS * GEMV_KINDS; ++i)
    kernels[3 + i] = reinterpret_cast<const void*>(GEMV_KERNELS[i / GEMV_KINDS][i % GEMV_KINDS]);
  for (const void* k : kernels)
    if (e == cudaSuccess) e = configure(k, *opt_in);
  if (e == cudaSuccess) done.fetch_or(1ull << dev);
  return e;
}

// The accumulator count NL is the smallest of 1, 2, 4, 8, 16, 32 that holds
// n; C the smallest chunk count that covers a row (else 10); a block of 16
// warps a row each.
void gemv(Chain& chain, const LaneGemv& a) {
  int nli = 0;
  while ((1 << nli) < a.n) ++nli;
  const int chunks = (a.K / 16 + 31) / 32;
  int ci = 0;
  while (ci < GEMV_KINDS - 1 && GEMV_C[ci] < chunks) ++ci;
  const size_t smem = (size_t)a.n * a.K;
  chain.launch(GEMV_KERNELS[nli][ci], dim3((a.N + GEMV_WARPS - 1) / GEMV_WARPS),
               dim3(LANE_GEMV_THREADS), smem, a);
}

// The f32 scratch of one call, in 4-byte words from its start: attn, q2, ca
// [n, d] each, h [n, ffn], the scales xs [n] of a GEMV input padded to a
// multiple of 4, the split-S attention partials [n, heads, nc, hd] and [n,
// heads, nc, 2] with nc = ceil(max(s_max, s_src) / 64), then the int32
// arrival counters [L, 2 (self, cross), heads, n]; at[8] is the total.
struct Scratch {
  enum { ATTN, Q2, CA, H, XS, PART_O, PART_ML, COUNTS, TOTAL };
  size_t at[TOTAL + 1];
};

Scratch scratch_layout(int n, int d, int ffn, int L, int heads, int s_max, int s_src) {
  const size_t nc = tpa::attn_chunks(std::max(s_max, s_src));
  const size_t len[Scratch::TOTAL] = {(size_t)n * d, (size_t)n * d, (size_t)n * d,
                                      (size_t)n * ffn, (size_t)(n + 3) / 4 * 4,
                                      n * heads * nc * HD, n * heads * nc * 2,
                                      (size_t)L * 2 * heads * n};
  Scratch s;
  s.at[0] = 0;
  for (int i = 0; i < Scratch::TOTAL; ++i) s.at[i + 1] = s.at[i] + len[i];
  return s;
}

}  // namespace

// The scratch layout tpa_fused_stack_lanes uses (Scratch): the start of each
// region in 4-byte words, then the total, into starts[9].
extern "C" int tpa_fused_stack_lanes_scratch(int n, int d, int ffn, int L, int heads,
                                             int s_max, int s_src, long long* starts) {
  const Scratch s = scratch_layout(n, d, ffn, L, heads, s_max, s_src);
  for (int i = 0; i <= Scratch::TOTAL; ++i) starts[i] = (long long)s.at[i];
  return 0;
}

// Runs all L layers for one token on each of n lanes. `resid` [n, d] holds
// the lanes' embedded tokens on entry and the stack outputs on return.
// offsets [n] and lanes [n] are int32 device arrays: lane m writes at
// offsets[m] and reads and writes slot lanes[m] of the stacked state
//   kcache/vcache [slots, L, s_max, d] bf16,
//   ck/cv [slots, L, s_ck, d] int8, ks/vs [slots, L, s_ck] f32 (the first
//   s_src rows are attended).
// The pack layout is tpa_fused_stack's. qkv [L, n, 3d] receives each
// layer's f32 q/k/v (k and v are the lanes' new cache rows). scratch is laid
// out as Scratch says (tpa_fused_stack_lanes_scratch), and the caller zeroes
// its arrival counters; xq is int8 [n, max(d, ffn)], the codes of a GEMV
// input. Every pointer is 16-byte aligned. tap_q / tap_s, when not null,
// receive every GEMV input's int8 codes and scales, int8 [L, 6, n,
// max(d, ffn)] and f32 [L, 6, n], in the order of the layer's six GEMVs
// (q/k/v, out, cross-q, cross-out, fc1, fc2): what the check of the rounding
// against the plain version reads.
extern "C" int tpa_fused_stack_lanes(
    float* resid, const int* offsets, const int* lanes, const int8_t* w_in,
    const int8_t* w_fc2, const float* scales, const float* biases,
    const float* ln, const int8_t* ck, const float* ks, const int8_t* cv,
    const float* vs, __nv_bfloat16* kcache, __nv_bfloat16* vcache, float* qkv,
    float* scratch, int8_t* xq, int8_t* tap_q, float* tap_s, int n, int L, int d,
    int ffn, int heads, int s_src, int s_ck, int s_max, cudaStream_t stream) {
  if (n < 1 || n > MAX_LANES || d != heads * HD || d % 16 || ffn % 16 || s_src < 1 ||
      s_max < 1)
    return (int)cudaErrorInvalidValue;
  const int kmax = std::max(d, ffn);
  const float sm = 1.0f / sqrtf((float)HD);
  const int n_in = 6 * d + ffn, n_sc = 7 * d + ffn;
  const Scratch at = scratch_layout(n, d, ffn, L, heads, s_max, s_src);
  float* attn = scratch + at.at[Scratch::ATTN];
  float* q2 = scratch + at.at[Scratch::Q2];
  float* ca = scratch + at.at[Scratch::CA];
  float* hbuf = scratch + at.at[Scratch::H];
  float* xs = scratch + at.at[Scratch::XS];
  float* part_o = scratch + at.at[Scratch::PART_O];
  float* part_ml = scratch + at.at[Scratch::PART_ML];
  int* counts = reinterpret_cast<int*>(scratch + at.at[Scratch::COUNTS]);
  const int nc_self = tpa::attn_chunks(s_max);
  const int nc_cross = tpa::attn_chunks(s_src);
  const size_t self_smem = std::max(2 * CH * SELF_LD * sizeof(__nv_bfloat16),
                                    (size_t)nc_self * (HD + 2) * sizeof(float));
  const size_t cross_smem = std::max(2 * CH * (CROSS_LD + sizeof(float)),
                                     (size_t)nc_cross * (HD + 2) * sizeof(float));
  if (std::max(self_smem, cross_smem) > 48 * 1024) return (int)cudaErrorInvalidValue;
  const size_t slot_cache = (size_t)L * s_max * d;
  const size_t slot_kv = (size_t)L * s_ck * d, slot_s = (size_t)L * s_ck;
  const dim3 self_grid(nc_self, heads, n), cross_grid(nc_cross, heads, n);
  const dim3 attn_block(tpa::ATTN_THREADS);
  int opt_in = 0;
  Chain chain(stream);
  chain.keep(configure_chain(&opt_in));
  // the quantise launch of GEMV input g of layer l (x [n, ldx], LayerNorm
  // lw / lb or nulls), then the GEMV (w, its scales ws and biases b, into out
  // [n, ldo], N outputs of K inputs)
  auto stage = [&](const float* x, int ldx, const float* lw, const float* lb, const int8_t* w,
                   const float* ws, const float* b, float* out, int ldo, int mode, int N, int K,
                   int l, int g) {
    chain.launch(fd4_quantize, dim3(n), dim3(tpa::GEMV_THREADS),
                 (size_t)(lw != nullptr ? 4 : 2) * K * sizeof(float), x, ldx, lw, lb, xq, xs, K);
    LaneGemv a{xq, xs, w, ws, b, out, nullptr, nullptr, ldo, kmax, mode, N, K, n};
    if (tap_q != nullptr) {
      const size_t i = ((size_t)l * 6 + g) * n;
      a.tap_q = tap_q + i * kmax;
      a.tap_s = tap_s + i;
    }
    gemv(chain, a);
  };
  for (int l = 0; l < L; ++l) {
    const int8_t* wl = w_in + (size_t)l * n_in * d;
    const float* sl = scales + (size_t)l * n_sc;
    const float* bl = biases + (size_t)l * n_sc;
    const float* lnl = ln + (size_t)l * 6 * d;
    const size_t dd = (size_t)d * d;
    float* qkvl = qkv + (size_t)l * n * 3 * d;
    int* self_counts = counts + (size_t)(2 * l) * heads * n;
    int* cross_counts = counts + (size_t)(2 * l + 1) * heads * n;
    stage(resid, d, lnl, lnl + d, wl, sl, bl, qkvl, 3 * d, STORE, 3 * d, d, l, 0);
    chain.launch(fd4_self_attn, self_grid, attn_block, self_smem, qkvl,
                 kcache + (size_t)l * s_max * d, vcache + (size_t)l * s_max * d, slot_cache,
                 offsets, lanes, part_o, part_ml, self_counts, attn, s_max, d, sm);
    stage(attn, d, nullptr, nullptr, wl + 3 * dd, sl + 3 * d, bl + 3 * d, resid, d, ADD, d, d,
          l, 1);
    stage(resid, d, lnl + 2 * d, lnl + 3 * d, wl + 4 * dd, sl + 4 * d, bl + 4 * d, q2, d, STORE,
          d, d, l, 2);
    chain.launch(fd4_cross_attn, cross_grid, attn_block, cross_smem, q2, lanes,
                 ck + (size_t)l * s_ck * d, ks + (size_t)l * s_ck, cv + (size_t)l * s_ck * d,
                 vs + (size_t)l * s_ck, slot_kv, slot_s, part_o, part_ml, cross_counts, ca,
                 s_src, d, sm);
    stage(ca, d, nullptr, nullptr, wl + 5 * dd, sl + 5 * d, bl + 5 * d, resid, d, ADD, d, d,
          l, 3);
    stage(resid, d, lnl + 4 * d, lnl + 5 * d, wl + 6 * dd, sl + 6 * d, bl + 6 * d, hbuf, ffn,
          GELU, ffn, d, l, 4);
    stage(hbuf, ffn, nullptr, nullptr, w_fc2 + (size_t)l * d * ffn, sl + 6 * d + ffn,
          bl + 6 * d + ffn, resid, d, ADD, d, ffn, l, 5);
  }
  if (chain.error() != cudaSuccess) return (int)chain.error();
  return (int)cudaGetLastError();
}
