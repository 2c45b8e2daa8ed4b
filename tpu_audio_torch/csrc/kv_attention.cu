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
// memory-bound, 1.3 us at 3.35 TB/s, so in practice bound by latency and
// launch overhead. It runs once per decoder layer and token.
//
// Design: split-S (common.cuh). Blocks of (64 positions, 1 head): a thread
// pair per position computes its score (all of a thread's 32 loads issued
// before it sums), the chunk's max and exp-sum in shared memory, then P.V
// with the loads unrolled; a combine pass per head rescales the partials and
// divides by the total sum, as the TPU kernel divides after P.V. The head
// dim is fixed at 64 (every whisper size). (A first version with one block
// per head left 112 SMs idle and measured slower than the plain version.)
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

struct GroupScore {
  const float* q;     // [D] this head
  const int8_t* kc;   // [S, D] this head
  const float* ks;    // [S, G]
  const float* kb;
  int D, G, gs, valid;
  float sm;
  __device__ float term(int s, int d) const {
    const int g = d / gs;
    return q[d] * ((float)kc[(size_t)s * D + d] * ks[(size_t)s * G + g]
                   + kb[(size_t)s * G + g]);
  }
  __device__ float finish(int s, float dot) const {
    return s < valid ? dot * sm : -1e9f;
  }
};

struct GroupValue {
  const int8_t* vc;
  const float* vs;
  const float* vb;
  int D, G, gs;
  __device__ float at(int s, int d) const {
    const int g = d / gs;
    return (float)vc[(size_t)s * D + d] * vs[(size_t)s * G + g]
           + vb[(size_t)s * G + g];
  }
};

__global__ void decode_attention_int8_partial(
    const float* __restrict__ q, const int8_t* __restrict__ kc,
    const float* __restrict__ ks, const float* __restrict__ kb,
    const int8_t* __restrict__ vc, const float* __restrict__ vs,
    const float* __restrict__ vb, float* __restrict__ part_o,
    float* __restrict__ part_ml, int S, int D, int G, int valid,
    float sm_scale) {
  const int c = blockIdx.x, h = blockIdx.y, nc = gridDim.x;
  const size_t code = (size_t)h * S * D, scale = (size_t)h * S * G;
  const int gs = D / G;
  const GroupScore score{q + (size_t)h * D, kc + code, ks + scale, kb + scale,
                         D, G, gs, valid, sm_scale};
  const GroupValue value{vc + code, vs + scale, vb + scale, D, G, gs};
  const int s0 = c * tpa::ATTN_CHUNK;
  const int s1 = min(S, s0 + tpa::ATTN_CHUNK);
  const size_t slot = (size_t)h * nc + c;
  tpa::attn_partial<tpa::ATTN_HD>(score, value, s0, s1,
                                  part_o + slot * tpa::ATTN_HD, part_ml + slot * 2);
}

}  // namespace

// part_o [H, nc, D] and part_ml [H, nc, 2] are scratch, nc = ceil(S / 64).
extern "C" int tpa_decode_attention_int8(const float* q, const int8_t* kc,
                                         const float* ks, const float* kb,
                                         const int8_t* vc, const float* vs,
                                         const float* vb, float* out,
                                         float* part_o, float* part_ml, int H,
                                         int S, int D, int G, int valid,
                                         float sm_scale, cudaStream_t stream) {
  const int nc = tpa::attn_chunks(S);
  decode_attention_int8_partial<<<dim3(nc, H), tpa::ATTN_THREADS, 0, stream>>>(
      q, kc, ks, kb, vc, vs, vb, part_o, part_ml, S, D, G, valid, sm_scale);
  tpa::attn_combine_kernel<<<H, D, 0, stream>>>(part_o, part_ml, out, nc, D);
  return (int)cudaGetLastError();
}
