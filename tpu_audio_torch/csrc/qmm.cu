// MLX grouped-affine GEMV: y[b, o] = sum_i x[b, i] * w[o, i], with
//   w[o, i] = scales[o, i / g] * q[o, i] + biases[o, i / g]
// and q the `bits`-wide codes packed 32 / bits to a 32-bit word, least
// significant bits first (the layout of MLX's 4/8-bit checkpoints). Per group
//   y[b, o] += scales[o, grp] * sum_{i in grp} x[b, i] q[o, i]
//            + biases[o, grp] * sum_{i in grp} x[b, i]
// in f32, stored in x's dtype.
//
// Replaces tpu_audio/ops/pallas_qmm.py:quantized_matvec (pallas_call at
// :146). Left out as TPU artifacts: the nibble planes and the plane-transposed
// x prepared outside (Mosaic could not shape-cast the unpack across lanes),
// the bias term computed outside as `xg @ biases.T`, the pre-expanded word
// scales (`scales_w`, bf16), the O tiles and the padding of x to 8 rows. Here
// scales and biases are read once a group in their stored dtype (f32, bf16 or
// f16) and converted in registers, and the group sums of x are taken inside.
//
// Bound on the H100: a weight-streaming GEMV. At one row of x (a decode step)
// it reads bits / 8 bytes a weight plus 2 * 4 / g bytes of f32 scales and
// biases (0.625 B a weight at 4 bits, g 64) and does 2 operations a weight:
// bytes, 0.526 ms for Orpheus-3B's 2,818.6 M layer weights at 3.35 TB/s. At
// 63 rows (the prefill) it does 126 f32 operations a weight (no tensor cores):
// operations, ~5.3 ms for the layers at 67 TFLOP/s.
//
// Design: a block of 8 warps owns 16 output rows, a warp 2 of them. The block
// stages up to RB rows of x into shared memory as f32 in plane order
// xs[b][n][word] (element n of every word side by side, each plane padded by
// 4 floats so that the coalesced reads of x land in distinct banks; the
// loads unrolled, since a decode GEMV is short and this chain of loads is a
// good part of it), so that a lane that holds 4 consecutive words of a weight
// row reads the 4 matching x values of code n with one conflict-free 16-byte
// load; then the group sums of x (a warp a group). Each lane streams its
// rows in 16-byte chunks of 4 words with the scales of their groups and the
// biases of the groups each chunk opens, unpacks the codes in registers
// (shift, mask, and the 2^23 float trick instead of an int-to-float
// conversion), and keeps f32 sums of x*q per row of x and per group, scaled
// once a group. Rows of x beyond RB go in further passes over the same
// weights (read again, from L2 where they fit); RB is 8 at most, fewer where
// 8 rows of x do not fit the 227 KB of shared memory a block may have. A
// warp sum ends each output. Measured: a decode GEMV is short, and its chain
// of latencies (staging, one to three chunks a lane, warp sums) rather than
// the bytes sets its time; see PERF.md.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int QMM_WARPS = 8;  // warps a block
constexpr int QMM_RO = 2;     // output rows a warp

// dtype codes (ops/qmm.py)
enum QmmDtype { QMM_F32 = 0, QMM_BF16 = 1, QMM_F16 = 2 };

__device__ __forceinline__ float load_f(const void* p, size_t i, int dt) {
  if (dt == QMM_BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dt == QMM_F16) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_f(void* p, size_t i, int dt, float v) {
  if (dt == QMM_BF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else if (dt == QMM_F16)
    static_cast<__half*>(p)[i] = __float2half(v);
  else
    static_cast<float*>(p)[i] = v;
}

// code n of word w as an exact float: (q | 0x4B000000) is the float 2^23 + q
template <int BITS>
__device__ __forceinline__ float code(uint32_t w, int n) {
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  const int shift = BITS * n;
  return __uint_as_float(((w >> shift) & MASK) | 0x4B000000u) - 8388608.0f;
}

// A lane's 16-byte chunk c (words 4c..4c+3) of each of its RO weight rows,
// with the scales of the chunk's groups and the biases of the groups it
// opens (0 for a group an earlier chunk opened).
template <int RO>
struct Chunk {
  uint4 w[RO];
  float sc0[RO], sc1[RO], bi0[RO], bi1[RO];

  __device__ __forceinline__ void fetch(const uint32_t* const* wrow, const size_t* srow,
                                        int c, int wpg, const void* scales,
                                        const void* biases, int s_dt) {
    const int grp0 = (4 * c) / wpg;
    const bool opens = (4 * c) % wpg == 0;
#pragma unroll
    for (int r = 0; r < RO; ++r) {
      w[r] = reinterpret_cast<const uint4*>(wrow[r])[c];
      sc0[r] = load_f(scales, srow[r] + grp0, s_dt);
      sc1[r] = wpg == 2 ? load_f(scales, srow[r] + grp0 + 1, s_dt) : sc0[r];
      bi0[r] = opens ? load_f(biases, srow[r] + grp0, s_dt) : 0.0f;
      bi1[r] = wpg == 2 ? load_f(biases, srow[r] + grp0 + 1, s_dt) : 0.0f;
    }
  }
};

template <int BITS, int RB>
__global__ void __launch_bounds__(QMM_WARPS * 32)
quantized_matvec_kernel(const void* __restrict__ x, int x_dt,
                        const uint32_t* __restrict__ w,
                        const void* __restrict__ scales,
                        const void* __restrict__ biases, int s_dt,
                        void* __restrict__ out, int B, int O, int I, int gs,
                        int vec) {
  constexpr int PW = 32 / BITS;  // codes a word
  extern __shared__ __align__(16) float smem[];
  const int NW = I / PW;         // words a row
  const int NWp = NW + 4;        // a plane's stride: 16-byte aligned, banks staggered
  const int G = I / gs;          // groups a row
  const int wpg = gs / PW;       // words a group (>= 2)
  float* xs = smem;              // [RB][PW][NWp]
  float* xg = smem + RB * PW * NWp;  // [RB][G]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o0 = (blockIdx.x * QMM_WARPS + warp) * QMM_RO;
  const uint32_t* wrow[QMM_RO];
  size_t srow[QMM_RO];
  bool live[QMM_RO];
#pragma unroll
  for (int r = 0; r < QMM_RO; ++r) {
    live[r] = o0 + r < O;
    const int o = live[r] ? o0 + r : O - 1;  // a dead row reads a live one
    wrow[r] = w + (size_t)o * NW;
    srow[r] = (size_t)o * G;
  }

  // 16-byte loads of 4 words; wpg >= 2, so words 0-1 and 2-3 of a chunk each
  // lie in one group (the same group unless wpg == 2)
  const int n_chunks = vec ? NW / 4 : 0;
  for (int b0 = 0; b0 < B; b0 += RB) {
    __syncthreads();  // the previous pass is done with xs and xg
#pragma unroll 8
    for (int idx = threadIdx.x; idx < RB * I; idx += blockDim.x) {
      // x[b0 + b, i] to xs[b][n][wi], i = wi * PW + n: coalesced reads, and
      // the padded stride spreads a warp's writes over the banks
      const int b = idx / I, i = idx - b * I;
      const int wi = i / PW, n = i - wi * PW;
      xs[(b * PW + n) * NWp + wi] =
          b0 + b < B ? load_f(x, (size_t)(b0 + b) * I + i, x_dt) : 0.0f;
    }
    __syncthreads();
    // the group sums of x: a warp a (row, group), from the staged rows
    for (int t = warp; t < RB * G; t += QMM_WARPS) {
      const int b = t / G, gg = t - b * G;
      float s = 0.0f;
      for (int i = gg * gs + lane; i < (gg + 1) * gs; i += 32) {
        const int wi = i / PW;
        s += xs[(b * PW + (i - wi * PW)) * NWp + wi];
      }
      s = tpa::warp_sum(s);
      if (lane == 0) xg[t] = s;
    }
    __syncthreads();

    float acc[RB][QMM_RO];
#pragma unroll
    for (int b = 0; b < RB; ++b)
#pragma unroll
      for (int r = 0; r < QMM_RO; ++r) acc[b][r] = 0.0f;

    for (int c = lane; c < n_chunks; c += 32) {
      Chunk<QMM_RO> cur;
      cur.fetch(wrow, srow, c, wpg, scales, biases, s_dt);
      const int grp0 = (4 * c) / wpg;
      float lo[RB][QMM_RO], hi[RB][QMM_RO];
#pragma unroll
      for (int b = 0; b < RB; ++b)
#pragma unroll
        for (int r = 0; r < QMM_RO; ++r) lo[b][r] = hi[b][r] = 0.0f;
#pragma unroll
      for (int n = 0; n < PW; ++n) {
        float4 xv[RB];
#pragma unroll
        for (int b = 0; b < RB; ++b)
          xv[b] = reinterpret_cast<const float4*>(xs + (b * PW + n) * NWp)[c];
#pragma unroll
        for (int r = 0; r < QMM_RO; ++r) {
          const uint4 wv = cur.w[r];
          const float q0 = code<BITS>(wv.x, n), q1 = code<BITS>(wv.y, n);
          const float q2 = code<BITS>(wv.z, n), q3 = code<BITS>(wv.w, n);
#pragma unroll
          for (int b = 0; b < RB; ++b) {
            lo[b][r] += xv[b].x * q0 + xv[b].y * q1;
            hi[b][r] += xv[b].z * q2 + xv[b].w * q3;
          }
        }
      }
#pragma unroll
      for (int b = 0; b < RB; ++b) {
#pragma unroll
        for (int r = 0; r < QMM_RO; ++r) {
          float v = cur.sc0[r] * lo[b][r] + cur.sc1[r] * hi[b][r];
          // the bias term, once a group, where the chunk opens the group
          v += cur.bi0[r] * xg[b * G + grp0];
          if (wpg == 2) v += cur.bi1[r] * xg[b * G + grp0 + 1];
          acc[b][r] += v;
        }
      }
    }
    // one word at a time where the rows are not 16-byte aligned (vec == 0)
    for (int wi = 4 * n_chunks + lane; wi < NW; wi += 32) {
      const int grp = wi / wpg;
      const bool opens = wi % wpg == 0;
#pragma unroll
      for (int r = 0; r < QMM_RO; ++r) {
        const uint32_t wd = wrow[r][wi];
        const float sc = load_f(scales, srow[r] + grp, s_dt);
        const float bi = opens ? load_f(biases, srow[r] + grp, s_dt) : 0.0f;
#pragma unroll
        for (int b = 0; b < RB; ++b) {
          float s = 0.0f;
#pragma unroll
          for (int n = 0; n < PW; ++n) s += xs[(b * PW + n) * NWp + wi] * code<BITS>(wd, n);
          acc[b][r] += sc * s + bi * xg[b * G + grp];
        }
      }
    }
#pragma unroll
    for (int b = 0; b < RB; ++b) {
#pragma unroll
      for (int r = 0; r < QMM_RO; ++r) {
        const float y = tpa::warp_sum(acc[b][r]);
        if (lane == 0 && live[r] && b0 + b < B)
          store_f(out, (size_t)(b0 + b) * O + o0 + r, x_dt, y);
      }
    }
  }
}

template <int BITS, int RB>
cudaError_t launch(const void* x, int x_dt, const uint32_t* w, const void* scales,
                   const void* biases, int s_dt, void* out, int B, int O, int I,
                   int gs, int vec, cudaStream_t stream) {
  const auto kernel = quantized_matvec_kernel<BITS, RB>;
  const size_t smem = (size_t)RB * (I + 4 * (32 / BITS) + I / gs) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int rows = QMM_WARPS * QMM_RO;
  kernel<<<(O + rows - 1) / rows, QMM_WARPS * 32, smem, stream>>>(
      x, x_dt, w, scales, biases, s_dt, out, B, O, I, gs, vec);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_bits(int rb, const void* x, int x_dt, const uint32_t* w,
                        const void* scales, const void* biases, int s_dt, void* out,
                        int B, int O, int I, int gs, int vec, cudaStream_t stream) {
  switch (rb) {
    case 1: return launch<BITS, 1>(x, x_dt, w, scales, biases, s_dt, out, B, O, I, gs, vec, stream);
    case 2: return launch<BITS, 2>(x, x_dt, w, scales, biases, s_dt, out, B, O, I, gs, vec, stream);
    case 4: return launch<BITS, 4>(x, x_dt, w, scales, biases, s_dt, out, B, O, I, gs, vec, stream);
    case 8: return launch<BITS, 8>(x, x_dt, w, scales, biases, s_dt, out, B, O, I, gs, vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [B, I] (x_dt), w [O, I * bits / 32] words, scales/biases [O, I / gs]
// (s_dt), out [B, O] (x_dt). rb: rows of x a pass (1, 2, 4 or 8); vec: the
// rows of w are 16-byte aligned (I * bits % 128 == 0 and w aligned).
extern "C" int tpa_quantized_matvec(const void* x, int x_dt, const void* w,
                                    const void* scales, const void* biases, int s_dt,
                                    void* out, int B, int O, int I, int gs, int bits,
                                    int rb, int vec, cudaStream_t stream) {
  const uint32_t* wp = static_cast<const uint32_t*>(w);
  cudaError_t e;
  switch (bits) {
    case 2: e = launch_bits<2>(rb, x, x_dt, wp, scales, biases, s_dt, out, B, O, I, gs, vec, stream); break;
    case 4: e = launch_bits<4>(rb, x, x_dt, wp, scales, biases, s_dt, out, B, O, I, gs, vec, stream); break;
    case 8: e = launch_bits<8>(rb, x, x_dt, wp, scales, biases, s_dt, out, B, O, I, gs, vec, stream); break;
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}
