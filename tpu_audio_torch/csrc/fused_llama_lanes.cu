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
// Bound on the H100: bytes. A step streams the layers' int8 weights once
// for all lanes (2,818.6 MB at Orpheus-3B: (2d + 2dkv + 3ffn) * d * L, d =
// 3072, dkv = 1024, ffn = 8192, L = 28) plus, per lane, 4 * dkv * L =
// 114,688 bytes of bf16 cache per attended position: 0.84 ms at 3.35 TB/s
// for the weights, ~0.014 ms more per lane at 400 positions. The operations
// (~5.6 G int8 multiply-adds a lane) stay far below the int8 rate up to the
// lane limit. What the TPU kernel gets right is a weight stream that Mosaic
// double-buffers across grid steps, which never waits on the layer chain,
// and a GQA permutation of q that lets one K/V pass serve the query heads
// sharing it. Hopper blocks run in no order, so the layer loop runs on the
// host side of this file, 10 stream-ordered launches a layer:
//   quantise, q/k/v GEMV, RoPE, attention, quantise, o GEMV, quantise,
//   gate/up GEMV, quantise (SwiGLU), down GEMV.
// The design gets the two properties back as follows.
//   Loads before the dependency wait. Every launch after a call's first (or
//     after a tap's copies) is a programmatic dependent launch (PDL): it
//     starts while its predecessor runs, and before griddepcontrol.wait it
//     only reads what no launch of the call writes (weights and their
//     scales, RMSNorm weights, the lanes, offsets and valid_from arrays,
//     cache rows below each lane's offset) and writes nothing. A GEMV warp
//     loads its row's 16-byte chunks into registers there (ld.global.nc.
//     L1::no_allocate) with its scale, a quantise block its RMSNorm
//     weight, an attention block its K/V rows. So the weight stream runs
//     one stage ahead of the chain: at one lane the GEMVs take about their
//     bytes' time.
//   GQA-grouped attention from 16-byte loads. One block a (64-position
//     chunk, KV head, lane) stages the chunk's K and V rows of its KV head
//     with 16-byte cp.async and computes the rep query heads sharing them,
//     up to 4 at once in groups of 128 threads, each with attn_partial's
//     order of sums and reduction tree (group_partial, group_reduce). Each
//     K/V row is read from L2 once, not rep times; the score loop reads K
//     (laid out in two half tables, so that a thread pair's 16-byte loads
//     fall in distinct banks) and q 16 bytes at a time.
//   The combine folded in. The last of a (layer, KV head, lane)'s live
//     chunks to arrive (an arrival counter each, zeroed once a call by the
//     wrapper, behind __threadfence) copies its heads' partials with
//     16-byte L2 loads and combines them in chunk order with
//     combine_partials. No float atomics: the result does not depend on
//     block order.
//   Short post-wait chains. A quantise block copies its row into shared
//     memory with every 16-byte load in flight before llama_quantize_row
//     reads it; a GEMV block stages the n int8 rows and their scales, and
//     lane m of a warp finishes lane m's output, so a row's n epilogues run
//     at once. Every kernel of the chain asks for the same L1/shared split
//     (the most shared memory), so that no SM drains to change it.
// The GEMV stages the n int8 rows of x in shared memory (n * K bytes: at the
// down projection, K = ffn = 8192, 28 lanes fit in the 227 KB a block may
// opt into and 29 do not; supported_lanes() in ops/fused_llama.py states
// the limit) and sums each weight chunk against them with exact __dp4a
// int32 sums, one warp a weight row, 16 warps a block. The scratch layout is
// decided here (Scratch), and tpa_fused_llama_stack_lanes_scratch exposes
// it to the wrapper. Two more limits come from shared memory, and the
// wrapper's predicates state them: a quantise block holds three f32 rows of
// its input (12 * max(d, ffn) bytes, so d and ffn up to 19,285:
// supported_lanes()), and the combine a head's partials over the whole
// cache (s_max up to 28,352: LANES_S_MAX). Reading them from global
// memory instead would lift both limits, at the cost of the staging's
// point: every 16-byte load of a row in flight at once.
// Tried and not kept (timed as copies of this file beside it; PERF.md):
// GEMV grids of as many blocks as fit at once, each warp walking row
// groups with the next group's chunks in registers (slower than the
// 11-launch kernel from 8 lanes: a quarter of the warps an SM); the query
// heads of a block one after another; 8-warp GEMV blocks; a register cap
// for 3 attention blocks an SM (spills). Not built: folding the
// quantise launches into each GEMV's prologue (6 launches a layer). Every
// GEMV block would run the n rows' quantisations one after another, each a
// chain of block reductions as long as a quantise launch's own, and at the
// lane limit the down GEMV's 28 staged rows take 224 of the 227 KB a block
// may have, with no room for the 32 KB f32 row llama_quantize_row stages.
// An offset outside [0, s_max) is clamped to it (as kernel 4 does): a lane
// frozen at the cache's end overwrites its own last row, never another's.
// Lanes must have distinct slots. Left out, as TPU artifacts: the 8-row x
// padding, the 8-lane cap, angle tables built outside the kernel and the
// S_MAX_CAP VMEM cap.
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
using tpa::MAX_LANES;
using tpa::QUANT_PLAIN;
using tpa::QUANT_RMS;
using tpa::QUANT_SWIGLU;
using tpa::STORE;

constexpr int LANE_GEMV_THREADS = 512;  // a GEMV block: a warp a weight row
constexpr int GEMV_WARPS = LANE_GEMV_THREADS / 32;

__device__ __forceinline__ int lane_offset(const long long* offsets, int m, int s_max) {
  return (int)min(max(offsets[m], 0LL), (long long)s_max - 1);
}

__device__ __forceinline__ int lane_start(const long long* valid_from, int m, int offset) {
  return (int)min(max(valid_from[m], 0LL), (long long)offset);
}

// Row m = blockIdx.x of x (row stride ldx): the int8 codes xq[m, :K] and
// scale xs[m] of a GEMV input, by tpa::llama_quantize_row on copies in
// shared memory: the RMSNorm weight copied before the wait, the row (2K
// floats for SwiGLU, else K) after it, each with every 16-byte load in
// flight at once. Dynamic shared memory: the row, the weight (QUANT_RMS)
// and the f32 row llama_quantize_row stages.
__global__ void __launch_bounds__(GEMV_THREADS)
fl6_quantize(const float* x, int ldx, const float* w, int mode, float eps, int8_t* xq,
             float* xs, int K) {
  extern __shared__ __align__(16) float qrow[];
  __shared__ float red[32];
  const int kin = mode == QUANT_SWIGLU ? 2 * K : K;
  float* xin = qrow;                                  // [kin]
  float* wn = xin + kin;                              // [K], QUANT_RMS only
  float* xf = wn + (mode == QUANT_RMS ? K : 0);       // [K]
  if (mode == QUANT_RMS)
    for (int i = 4 * threadIdx.x; i < K; i += 4 * GEMV_THREADS) cp_async16(wn + i, w + i);
  dependency_wait();
  release_dependents();
  const int m = blockIdx.x;
  const float* row = x + (size_t)m * ldx;
  for (int i = 4 * threadIdx.x; i < kin; i += 4 * GEMV_THREADS) cp_async16(xin + i, row + i);
  cp_async_wait_all();
  __syncthreads();
  const float s = tpa::llama_quantize_row(xin, wn, mode, eps, xf, xq + (size_t)m * K, K, red);
  if (threadIdx.x == 0) xs[m] = s;
}

struct LaneGemv {
  const int8_t* xq;      // [n, K] codes
  const float* xs;       // [n] their scales
  const int8_t* w;       // [N, K] int8
  const float* w_scale;  // [N]
  float* out;            // out[m * ldo + row]
  int mode, ldo, N, K, n;
};

// out[m * ldo + o] (=, or +=) gemv_epilogue(sum_i xq[m, i] * w[o, i]) for o <
// N and every lane m < n (n <= NL), one warp a row: a lane holds C 16-byte
// chunks of it (chunks lane, lane + 32, ...; rows wider than 512 C bytes
// load the rest after), loaded with the row's scale before the wait; the
// n int8 rows of x and their scales are staged in shared memory after it.
// Lane m of the warp finishes output m (every lane holds every sum), so a
// row's n epilogues, with their reads of what a predecessor wrote, run at
// once.
template <int NL, int C>
__global__ void __launch_bounds__(LANE_GEMV_THREADS) fl6_gemv(const LaneGemv a) {
  extern __shared__ __align__(16) int4 xv[];  // [n, K / 16]
  __shared__ float sxs[MAX_LANES];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvec = a.K / 16;
  const int row = blockIdx.x * GEMV_WARPS + warp;
  const int4* wv = reinterpret_cast<const int4*>(a.w + (size_t)min(row, a.N - 1) * a.K);
  int4 wr[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    wr[c] = lane + 32 * c < nvec ? ld_stream(wv + lane + 32 * c) : make_int4(0, 0, 0, 0);
  const float ws = a.w_scale[min(row, a.N - 1)];
  dependency_wait();
  release_dependents();
  const int4* src = reinterpret_cast<const int4*>(a.xq);
  for (int i = threadIdx.x; i < a.n * nvec; i += LANE_GEMV_THREADS) cp_async16(xv + i, src + i);
  if (threadIdx.x < a.n) sxs[threadIdx.x] = __ldcg(a.xs + threadIdx.x);
  cp_async_wait_all();
  __syncthreads();
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
    if (a.mode == ADD)
      tpa::gemv_epilogue<ADD>(mine, ws, sxs[lane], nullptr, &y);
    else
      tpa::gemv_epilogue<STORE>(mine, ws, sxs[lane], nullptr, &y);
    *o = y;
  }
}

// grid (heads + kv_heads, lanes). qkv is this layer's [n, d + 2dkv] q/k/v;
// kc/vc point at layer l of slot 0 of the [slots, L, s_max, dkv] caches.
__global__ void fl6_rope(float* __restrict__ qkv, const float* __restrict__ qn_w,
                         const float* __restrict__ kn_w, const float* __restrict__ inv_freq,
                         __nv_bfloat16* __restrict__ kc, __nv_bfloat16* __restrict__ vc,
                         size_t slot_stride, const long long* __restrict__ offsets,
                         const long long* __restrict__ lanes, int s_max, int d, int dkv,
                         int heads, float eps) {
  const int m = blockIdx.y;
  const int off = lane_offset(offsets, m, s_max);
  const size_t row = (size_t)lanes[m] * slot_stride + (size_t)off * dkv;
  dependency_wait();
  release_dependents();
  tpa::llama_rope_head(qkv + (size_t)m * (d + 2 * dkv), qn_w, kn_w, inv_freq, kc + row,
                       vc + row, d, dkv, heads, eps, off, blockIdx.x);
}

// grid (chunks of 0..s_max, kv_heads, lanes), hp * AT threads: hp groups of
// AT, hp a divisor of rep. Block (c, g, m) stages rows valid_from + 64 c..
// of KV head g of lane m's slot and writes the partials of query heads g *
// rep .. g * rep + rep - 1, hp at once, laid out [n, heads, nc_all, HD] and
// [n, heads, nc_all, 2] (nc_all = gridDim.x); a block past its lane's offset
// exits at once. The last of the lane's (offset - valid_from) / 64 + 1
// chunks of KV head g to arrive (counts: this layer's [kv_heads, n])
// combines the rep heads, hp at once, into out[m, h * HD + j].
__global__ void __launch_bounds__(MAX_GROUP * AT)
fl6_attn(const float* qkv, const __nv_bfloat16* kc, const __nv_bfloat16* vc,
         size_t slot_stride, const long long* offsets, const long long* valid_from,
         const long long* lanes, float* part_o, float* part_ml, int* counts, float* out,
         int s_max, int d, int dkv, int rep, float sm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(16) float sc[MAX_GROUP][CH];
  __shared__ float red[MAX_GROUP][32];
  __shared__ int last;
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // 2 tables [CH, K_LD]
  __nv_bfloat16* sv = sk + 2 * K_HALF;                             // [CH, KV_LD]
  float* sq = reinterpret_cast<float*>(sv + CH * KV_LD);  // [rep q heads, k, v][HD]
  const int c = blockIdx.x, g = blockIdx.y, m = blockIdx.z;
  const int nc_all = gridDim.x, heads = gridDim.y * rep;
  const int hp = blockDim.x / AT, grp = threadIdx.x / AT, t = threadIdx.x % AT;
  const int offset = lane_offset(offsets, m, s_max);
  const int vf = lane_start(valid_from, m, offset);
  if (vf + c * CH > offset) return;  // past this lane's rows
  const size_t base = (size_t)lanes[m] * slot_stride;
  const size_t kv_at = base + (size_t)g * HD;
  const int s0 = vf + c * CH;
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
  const float* row = qkv + (size_t)m * (d + 2 * dkv);
  constexpr int Q = HD / 4;  // 16-byte pieces a head
  for (int i = threadIdx.x; i < (rep + 2) * Q; i += blockDim.x) {
    const int r = i / Q, e = (i % Q) * 4;
    const float* src = r < rep ? row + (g * rep + r) * HD : row + d + (r - rep) * dkv + g * HD;
    cp_async16(sq + r * HD + e, src + e);
  }
  cp_async_wait_all();
  __syncthreads();
  for (int r0 = 0; r0 < rep; r0 += hp) {
    const int r = r0 + grp;
    const size_t slot = ((size_t)m * heads + g * rep + r) * nc_all + c;
    group_partial(sq + r * HD, sq + rep * HD, sq + (rep + 1) * HD, sk, sv, s0, s1, offset, sm,
                  sc[grp], red[grp], part_o + slot * HD, part_ml + slot * 2);
  }
  const int nc = (offset - vf) / CH + 1;
  __threadfence();  // this block's partials, before its arrival
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counts + (size_t)g * gridDim.z + m, 1) == nc - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // hp heads' nc partials at a time into shared memory (the staging area:
  // the partials have finished reading it), every load of a thread in
  // flight at once, 16 bytes each for part_o; then each group's head by
  // combine_partials in chunk order
  float* sbuf = reinterpret_cast<float*>(smem_raw);  // [hp][nc, HD]
  float* sml = sbuf + (size_t)hp * nc * HD;          // [hp][nc, 2]
  const int n4 = nc * HD / 4;
  for (int r0 = 0; r0 < rep; r0 += hp) {
    const size_t hb0 = ((size_t)m * heads + g * rep + r0) * nc_all;
    for (int i0 = threadIdx.x; i0 < hp * n4; i0 += 4 * blockDim.x) {
      float4 v[4];
      float ml[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * blockDim.x, h = i / n4, k = i % n4;
        if (i < hp * n4) v[u] = __ldcg(reinterpret_cast<const float4*>(part_o) +
                                       (hb0 + (size_t)h * nc_all) * (HD / 4) + k);
        if (i < hp * 2 * nc)
          ml[u] = __ldcg(part_ml + (hb0 + (size_t)(i / (2 * nc)) * nc_all) * 2 + i % (2 * nc));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < hp * n4) reinterpret_cast<float4*>(sbuf)[i] = v[u];
        if (i < hp * 2 * nc) sml[i] = ml[u];
      }
    }
    __syncthreads();
    out[(size_t)m * d + (g * rep + r0 + grp) * HD + t] =
        tpa::combine_partials(sbuf + (size_t)grp * nc * HD, sml + grp * 2 * nc, nc, HD, t);
    __syncthreads();
  }
}

using GemvKernel = void (*)(LaneGemv);
constexpr int GEMV_KINDS = 4;
constexpr int GEMV_C[GEMV_KINDS] = {4, 6, 8, 16};  // chunks a lane holds a row
constexpr int GEMV_NLS = 6;                         // NL = 1, 2, 4, 8, 16, 32

#define TPA_GEMV_NL(NL) {fl6_gemv<NL, 4>, fl6_gemv<NL, 6>, fl6_gemv<NL, 8>, fl6_gemv<NL, 16>}
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
      reinterpret_cast<const void*>(fl6_quantize), reinterpret_cast<const void*>(fl6_rope),
      reinterpret_cast<const void*>(fl6_attn)};
  for (int i = 0; i < GEMV_NLS * GEMV_KINDS; ++i)
    kernels[3 + i] = reinterpret_cast<const void*>(GEMV_KERNELS[i / GEMV_KINDS][i % GEMV_KINDS]);
  for (const void* k : kernels)
    if (e == cudaSuccess) e = configure(k, *opt_in);
  if (e == cudaSuccess) done.fetch_or(1ull << dev);
  return e;
}

// The accumulator count NL is the smallest of 1, 2, 4, 8, 16, 32 that holds
// n; C the smallest chunk count that covers a row (else 16); a block of 8
// warps a row each.
void gemv(Chain& chain, const LaneGemv& a) {
  int nli = 0;
  while ((1 << nli) < a.n) ++nli;
  const int chunks = (a.K / 16 + 31) / 32;
  int ci = 0;
  while (ci < GEMV_KINDS - 1 && GEMV_C[ci] < chunks) ++ci;
  const GemvKernel kernel = GEMV_KERNELS[nli][ci];
  const size_t smem = (size_t)a.n * a.K;
  const dim3 grid((a.N + GEMV_WARPS - 1) / GEMV_WARPS);
  chain.launch(kernel, grid, dim3(LANE_GEMV_THREADS), smem, a);
}

void quantize(Chain& chain, const float* x, int ldx, const float* w, int mode, float eps,
              int8_t* xq, float* xs, int K, int n) {
  // the row (2K floats for SwiGLU), the RMSNorm weight, the staged f32 row
  const size_t smem =
      (size_t)((mode == QUANT_SWIGLU ? 2 : 1) + (mode == QUANT_RMS ? 1 : 0) + 1) * K *
      sizeof(float);
  chain.launch(fl6_quantize, dim3(n), dim3(GEMV_THREADS), smem, x, ldx, w, mode, eps, xq,
               xs, K);
}

// The f32 scratch of one call, in 4-byte words from its start: attn [n, d],
// gate/up [n, 2 ffn], xs [n] padded to a multiple of 4, the attention
// partials [n, heads, nc, 128] and [n, heads, nc, 2] with nc = ceil(s_max /
// 64), then the int32 arrival counters [L, kv_heads, n]; at[6] is the total.
struct Scratch {
  enum { ATTN, GU, XS, PART_O, PART_ML, COUNTS, TOTAL };
  size_t at[TOTAL + 1];
};

Scratch scratch_layout(int n, int L, int d, int ffn, int heads, int kv_heads, int s_max) {
  const size_t nc = tpa::attn_chunks(s_max);
  const size_t len[Scratch::TOTAL] = {
      (size_t)n * d, (size_t)n * 2 * ffn, (size_t)((n + 3) / 4) * 4, n * heads * nc * HD,
      n * heads * nc * 2, (size_t)L * kv_heads * n};
  Scratch s;
  s.at[0] = 0;
  for (int i = 0; i < Scratch::TOTAL; ++i) s.at[i + 1] = s.at[i] + len[i];
  return s;
}

}  // namespace

// The scratch layout tpa_fused_llama_stack_lanes uses (Scratch): the start
// of each region in 4-byte words, then the total, into starts[7].
extern "C" int tpa_fused_llama_stack_lanes_scratch(int n, int L, int d, int ffn, int heads,
                                                   int kv_heads, int s_max,
                                                   long long* starts) {
  const Scratch s = scratch_layout(n, L, d, ffn, heads, kv_heads, s_max);
  for (int i = 0; i <= Scratch::TOTAL; ++i) starts[i] = (long long)s.at[i];
  return 0;
}

// Runs all L layers for one token on each of n lanes. `resid` [n, d] holds
// the lanes' embedded tokens on entry and the stack outputs (before the
// final norm) on return. offsets, valid_from and lanes are [n] int64 device
// arrays: lane m writes at offsets[m], attends rows valid_from[m]..offsets[m]
// and reads and writes slot lanes[m] of kcache/vcache [slots, L, s_max, dkv]
// bf16 (K after RoPE). The pack layout is tpa_fused_llama_stack's. qkv [L,
// n, d + 2dkv] receives each layer's f32 q/k/v after RoPE (k and v are the
// lanes' new cache rows). scratch is laid out as Scratch says
// (tpa_fused_llama_stack_lanes_scratch), and the caller zeroes its arrival
// counters; xq is int8 [n, max(d, ffn)]. Every pointer is 16-byte aligned.
// tap_q / tap_s, when not null, receive a copy of every GEMV input's int8
// codes and scales, int8 [L, 4, n, max(d, ffn)] and f32 [L, 4, n], in the
// order of the layer's GEMV inputs (q/k/v, o, gate/up, down).
extern "C" int tpa_fused_llama_stack_lanes(
    float* resid, const long long* offsets, const long long* valid_from,
    const long long* lanes, const int8_t* w_in, const int8_t* w_down,
    const float* scales, const float* norms, const float* inv_freq,
    __nv_bfloat16* kcache, __nv_bfloat16* vcache, float* qkv, float* scratch, int8_t* xq,
    int8_t* tap_q, float* tap_s, int n, int L, int d, int ffn, int heads, int kv_heads,
    int s_max, int qk_norm, float eps, cudaStream_t stream) {
  if (n < 1 || n > MAX_LANES || s_max < 1 || heads % kv_heads || d % 16 || ffn % 16)
    return (int)cudaErrorInvalidValue;
  const int dkv = kv_heads * HD, rep = heads / kv_heads, kmax = max(d, ffn);
  const int R = 2 * d + 2 * dkv + 2 * ffn, ldq = d + 2 * dkv;
  const float sm = 1.0f / sqrtf((float)HD);
  const int nc = tpa::attn_chunks(s_max);
  const Scratch at = scratch_layout(n, L, d, ffn, heads, kv_heads, s_max);
  float* attn = scratch + at.at[Scratch::ATTN];
  float* gu = scratch + at.at[Scratch::GU];
  float* xs = scratch + at.at[Scratch::XS];
  float* part_o = scratch + at.at[Scratch::PART_O];
  float* part_ml = scratch + at.at[Scratch::PART_ML];
  int* counts = reinterpret_cast<int*>(scratch + at.at[Scratch::COUNTS]);
  const size_t slot_stride = (size_t)L * s_max * dkv;
  const dim3 rope_grid(heads + kv_heads, n), attn_grid(nc, kv_heads, n);
  // An attention block's shared memory: the staged K/V rows, q heads, k and
  // v; later the partials of the query heads it combines at once. It
  // computes hp query heads at once: the largest divisor of rep up to
  // MAX_GROUP whose partials fit.
  int opt_in = 0;
  cudaFuncAttributes fa;
  Chain chain(stream);
  chain.keep(configure_chain(&opt_in));
  chain.keep(cudaFuncGetAttributes(&fa, fl6_attn));
  if (chain.error() != cudaSuccess) return (int)chain.error();
  const size_t head_smem = (size_t)nc * (HD + 2) * sizeof(float);
  int hp = 0;
  for (int h = 1; h <= std::min(rep, MAX_GROUP); ++h)
    if (rep % h == 0 && h * head_smem + fa.sharedSizeBytes <= (size_t)opt_in) hp = h;
  if (hp == 0) return (int)cudaErrorInvalidValue;
  const size_t attn_smem =
      std::max((2 * K_HALF + CH * KV_LD) * sizeof(__nv_bfloat16) +
                   (size_t)(rep + 2) * HD * sizeof(float),
               hp * head_smem);
  auto tap = [&](int l, int gemv, int K) {
    if (tap_q == nullptr) return;
    const size_t i = (size_t)l * 4 + gemv;
    chain.copy(cudaMemcpy2DAsync(tap_q + i * n * kmax, kmax, xq, K, K, n,
                                 cudaMemcpyDeviceToDevice, stream));
    chain.copy(cudaMemcpyAsync(tap_s + i * n, xs, n * sizeof(float),
                               cudaMemcpyDeviceToDevice, stream));
  };
  for (int l = 0; l < L; ++l) {
    const int8_t* wl = w_in + (size_t)l * R * d;
    const float* sl = scales + (size_t)l * (R + d);
    const float* nl = norms + (size_t)l * 4 * d;
    float* qkvl = qkv + (size_t)l * n * ldq;
    __nv_bfloat16* kcl = kcache + (size_t)l * s_max * dkv;
    __nv_bfloat16* vcl = vcache + (size_t)l * s_max * dkv;

    quantize(chain, resid, d, nl, QUANT_RMS, eps, xq, xs, d, n);
    tap(l, 0, d);
    gemv(chain, {xq, xs, wl, sl, qkvl, STORE, ldq, ldq, d, n});
    chain.launch(fl6_rope, rope_grid, dim3(HD), 0, qkvl, qk_norm ? nl + 2 * d : nullptr,
                 qk_norm ? nl + 3 * d : nullptr, inv_freq, kcl, vcl, slot_stride, offsets,
                 lanes, s_max, d, dkv, heads, eps);
    chain.launch(fl6_attn, attn_grid, dim3(hp * AT), attn_smem, qkvl, kcl, vcl,
                 slot_stride, offsets, valid_from, lanes, part_o, part_ml,
                 counts + (size_t)l * kv_heads * n, attn, s_max, d, dkv, rep, sm);
    quantize(chain, attn, d, nullptr, QUANT_PLAIN, eps, xq, xs, d, n);
    tap(l, 1, d);
    gemv(chain, {xq, xs, wl + (size_t)ldq * d, sl + ldq, resid, ADD, d, d, d, n});
    quantize(chain, resid, d, nl + d, QUANT_RMS, eps, xq, xs, d, n);
    tap(l, 2, d);
    gemv(chain, {xq, xs, wl + (size_t)(d + ldq) * d, sl + d + ldq, gu, STORE, 2 * ffn,
                 2 * ffn, d, n});
    quantize(chain, gu, 2 * ffn, nullptr, QUANT_SWIGLU, eps, xq, xs, ffn, n);
    tap(l, 3, ffn);
    gemv(chain, {xq, xs, w_down + (size_t)l * d * ffn, sl + R, resid, ADD, d, d, ffn, n});
  }
  if (chain.error() != cudaSuccess) return (int)chain.error();
  return (int)cudaGetLastError();
}
