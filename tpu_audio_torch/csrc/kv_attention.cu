// Single-query attention over int8 K/V with per-position group scales and
// biases (the codes of tpu_audio_torch.core.kv_cache._quantize, bits=8):
//   k[s, d] = code_k[s, d] * ks[s, g(d)] + kb[s, g(d)]   (same for v)
//   p = softmax(where(s < valid, (q . k[s]) * sm_scale, -1e9))   (f32)
//   out = sum_s p[s] v[s]
//
// Replaces tpu_audio/ops/pallas_kv_attention.py:decode_attention_int8
// (pallas_call at :154). The TPU kernel stored the codes transposed,
// [H, D, S], to put positions on the 128-wide lanes; this port keeps the
// position-major [H, S, D] layout that _quantize produces.
//
// Bound on the H100: at whisper-large-v3's cross attention (H = 20 heads,
// S = 1500 positions, D = 64, G = 1) one call reads 2*20*1500*64 B of codes
// plus 4*20*1500*4 B of scales and biases, about 4.3 MB, and does ~8 MFLOP:
// memory-bound, 1.3 us at 3.35 TB/s. It runs once per decoder layer and
// token, and a decode step reads 32 layers' planes (138 MB, past the 50 MB
// L2), so on its path every call finds its planes cold.
//
// Design: one launch, grid (chunks of 64 positions, heads), 128 threads.
//   A programmatic dependent launch. The kernel's first statement is the
//     dependency wait: it is a standalone op, so it cannot know which launch
//     wrote q or the planes, and reads and writes nothing before the wait.
//     Only the launch overlaps the previous kernel's tail.
//   Staged rows. A block copies its 64 rows of K codes and of V codes into
//     shared memory with 16-byte cp.async (64 B a row, padded to ROW_LD as
//     the decoder stacks pad their cross rows), and the rows' G scales and
//     biases of K and V and the head's q with 4-byte cp.async: every copy of
//     the block is issued before any is waited on. The first version loaded
//     each code as one byte from global memory, and its scale and bias again
//     for every element.
//   The arithmetic of the first version. attn_partial (common.cuh) runs on
//     StagedGroupScore / StagedGroupValue, whose expressions are the first
//     version's GroupScore / GroupValue evaluated on the staged copies (the
//     group index d / (D / G) taken by a shift: G divides 64), so the
//     partials and their order of sums are unchanged.
//   The combine folded in. The last of a head's nc blocks to arrive (an
//     int32 arrival counter a head, behind __threadfence) copies the head's
//     partials into shared memory with one round of 16-byte L2 loads and
//     combines them with combine_partials in chunk order (kernel 3's
//     combine_last), or, where nc (D + 2) floats exceed both 48 KB and the
//     block's staging area (S > 11,904 at G <= 32), reads them from L2 with
//     combine_partials_l2 (the same expressions). Then it sets its counter
//     back to 0 for the next call. No float atomics: the result does not
//     depend on the order in which blocks finish, and it is bit-equal to the
//     first version's separate combine launch.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py
// --kv-mel-timing, PERF.md), device ms a call at whisper-large-v3, one
// layer's planes back to back / 32 layers' in rotation: 0.0078 / 0.0086,
// against the first version's 0.0165 / 0.0256 (partial and combine
// launches). Tried as copies of this file timed beside it, and not kept:
// a stream-ordered launch combining from L2 (0.0121 / 0.0121), the same as
// a programmatic dependent launch (0.0120 / 0.0121).
// The head dim is fixed at 64 (every whisper size); G is any divisor of it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int CH = tpa::ATTN_CHUNK;
constexpr int HD = tpa::ATTN_HD;
constexpr int ROW_LD = HD + 16;  // int8 a staged K/V row (16-byte aligned)

// Dynamic shared memory of a block at G groups: the K and V rows, q, and
// the rows' K and V scales and biases.
inline size_t smem_bytes(int G) {
  return (size_t)2 * CH * ROW_LD + sizeof(float) * (HD + 4 * CH * G);
}

// Score of one head over the staged rows s0.. (ROW_LD bytes a row) and
// their staged scales and biases ([CH, G] each): the expressions of the
// first version's GroupScore on the same values.
struct StagedGroupScore {
  const float* q;    // [HD] this head, staged
  const int8_t* kc;  // [CH, ROW_LD]
  const float* ks;   // [CH, G]
  const float* kb;
  int G, gshift, s0, valid;
  float sm;
  __device__ float term(int s, int d) const {
    const int r = s - s0, g = d >> gshift;
    return q[d] * ((float)kc[r * ROW_LD + d] * ks[r * G + g] + kb[r * G + g]);
  }
  __device__ float finish(int s, float dot) const {
    return s < valid ? dot * sm : -1e9f;
  }
};

struct StagedGroupValue {
  const int8_t* vc;  // [CH, ROW_LD]
  const float* vs;   // [CH, G]
  const float* vb;
  int G, gshift, s0;
  __device__ float at(int s, int d) const {
    const int r = s - s0, g = d >> gshift;
    return (float)vc[r * ROW_LD + d] * vs[r * G + g] + vb[r * G + g];
  }
};

__global__ void __launch_bounds__(tpa::ATTN_THREADS)
decode_attention_int8_kernel(const float* __restrict__ q, const int8_t* __restrict__ kc,
                             const float* __restrict__ ks, const float* __restrict__ kb,
                             const int8_t* __restrict__ vc, const float* __restrict__ vs,
                             const float* __restrict__ vb, float* __restrict__ out,
                             float* part_o, float* part_ml, int* counts, int S, int G,
                             int gshift, int valid, float sm_scale, bool stage) {
  dependency_wait();  // nothing is read or written before it
  release_dependents();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* sk = reinterpret_cast<int8_t*>(smem_raw);  // [CH, ROW_LD]
  int8_t* sv = sk + CH * ROW_LD;
  float* sq = reinterpret_cast<float*>(sv + CH * ROW_LD);  // [HD]
  float* sks = sq + HD;                                    // [CH, G] each
  float* skb = sks + CH * G;
  float* svs = skb + CH * G;
  float* svb = svs + CH * G;
  const int c = blockIdx.x, h = blockIdx.y, nc = gridDim.x;
  const int s0 = c * CH;
  const int n = min(S - s0, CH);
  const size_t row0 = (size_t)h * S + s0;
  constexpr int V = HD / 16;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < n * V; i += blockDim.x) {
    const int r = i / V, e = (i % V) * 16;
    const size_t g = (row0 + r) * HD + e;
    cp_async16(sk + r * ROW_LD + e, kc + g);
    cp_async16(sv + r * ROW_LD + e, vc + g);
  }
  const size_t sc0 = row0 * G;
  for (int i = threadIdx.x; i < n * G; i += blockDim.x) {
    cp_async4(sks + i, ks + sc0 + i);
    cp_async4(skb + i, kb + sc0 + i);
    cp_async4(svs + i, vs + sc0 + i);
    cp_async4(svb + i, vb + sc0 + i);
  }
  if (threadIdx.x < HD) cp_async4(sq + threadIdx.x, q + (size_t)h * HD + threadIdx.x);
  cp_async_wait_all();
  __syncthreads();
  const StagedGroupScore score{sq, sk, sks, skb, G, gshift, s0, valid, sm_scale};
  const StagedGroupValue value{sv, svs, svb, G, gshift, s0};
  const size_t slot = (size_t)h * nc + c;
  tpa::attn_partial<HD>(score, value, s0, s0 + n, part_o + slot * HD, part_ml + slot * 2);

  __shared__ int last;
  __threadfence();  // this block's partial, before its arrival
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counts + h, 1) == nc - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t base = (size_t)h * nc;
  if (stage) {  // the partials into shared memory, every load in flight at once
    float* sbuf = reinterpret_cast<float*>(smem_raw);  // [nc, HD], then [nc, 2]
    float* sml = sbuf + nc * HD;
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
      out[(size_t)h * HD + threadIdx.x] = tpa::combine_partials(sbuf, sml, nc, HD, threadIdx.x);
  } else if (threadIdx.x < HD) {
    out[(size_t)h * HD + threadIdx.x] = tpa::combine_partials_l2(
        part_o + base * HD, part_ml + base * 2, nc, HD, threadIdx.x);
  }
  if (threadIdx.x == 0) counts[h] = 0;  // zero again for the next call
}

}  // namespace

// Scratch, in 4-byte words: part_o [H, nc, D] and part_ml [H, nc, 2] f32
// (nc = ceil(S / 64)), then counts [H] int32 at part_ml + 2 * H * nc: the
// arrival counters of the folded combine. The counters must be zero before
// the first call on a scratch buffer; each call leaves them zero again.
extern "C" int tpa_decode_attention_int8(const float* q, const int8_t* kc,
                                         const float* ks, const float* kb,
                                         const int8_t* vc, const float* vs,
                                         const float* vb, float* out,
                                         float* part_o, float* part_ml, int H,
                                         int S, int D, int G, int valid,
                                         float sm_scale, cudaStream_t stream) {
  if (D != HD || G < 1 || HD % G || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const int nc = tpa::attn_chunks(S);
  int* counts = reinterpret_cast<int*>(part_ml + (size_t)2 * H * nc);
  size_t smem = smem_bytes(G);
  const size_t combine = (size_t)nc * (HD + 2) * sizeof(float);
  const bool stage = combine <= std::max(smem, (size_t)48 * 1024);
  if (stage) smem = std::max(smem, combine);
  const int gshift = __builtin_ctz(HD / G);  // D / G is a power of two
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nc, H);
  cfg.blockDim = dim3(tpa::ATTN_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, decode_attention_int8_kernel, q, kc, ks, kb, vc,
                                           vs, vb, out, part_o, part_ml, counts, S, G, gshift,
                                           valid, sm_scale, stage);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
