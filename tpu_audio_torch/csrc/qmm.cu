// MLX grouped-affine GEMV: y[b, o] = sum_i x[b, i] * w[o, i], with
//   w[o, i] = scales[o, i / g] * q[o, i] + biases[o, i / g]
// and q the `bits`-wide codes packed 32 / bits to a 32-bit word, least
// significant bits first (the layout of MLX's 4/8-bit checkpoints). Per group
//   y[b, o] += scales[o, grp] * sum_{i in grp} x[b, i] q[o, i]
//            + biases[o, grp] * sum_{i in grp} x[b, i]
// in f32, stored in x's dtype.
//
// Replaces tpu_audio/ops/pallas_qmm.py:quantized_matvec (pallas_call at
// :146) with three kernels (ops/qmm.py:route picks one by shape): the
// decode kernel for 1 row of whole 16-byte chunks (a decode step's GEMVs),
// the GEMV below for rows that are not 16-byte aligned (and any 1-64 rows
// through qmm.gemv), and the tensor-core tile further down for 2-64 rows.
// Left out as TPU artifacts: the nibble planes and the plane-transposed
// x prepared outside (Mosaic could not shape-cast the unpack across lanes),
// the bias term computed outside as `xg @ biases.T`, the pre-expanded word
// scales (`scales_w`, bf16), the O tiles and the padding of x to 8 rows. Here
// scales and biases are read once a group in their stored dtype (f32, bf16 or
// f16) and converted in registers, and the group sums of x are taken inside.
//
// Bound on the H100: a weight-streaming GEMV. At one row of x (a decode step)
// it reads bits / 8 bytes a weight plus 2 * 4 / g bytes of f32 scales and
// biases (0.625 B a weight at 4 bits, g 64) and does 2 operations a weight:
// bytes, 0.526 ms for Orpheus-3B's 2,818.6 M layer weights at 3.35 TB/s.
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

// ---------------------------------------------------------------------------
// The decode kernel for 1 row of x whose rows (and W's) are whole 16-byte
// chunks on 16-byte aligned pointers: a decode step's GEMVs.
//
// Bound on the H100: bytes, as for the GEMV above: 0.625 B a weight at 4
// bits, g 64 (0.5 of codes, 0.125 of f32 scales and biases), 0.544 ms for
// a 4-bit Orpheus-3B step's 113 GEMVs at 3.35 TB/s. At one row a GEMV of
// 3-30 MB is a chain of latencies more than a stream of bytes: the GEMV
// above staged x and its group sums behind three barriers before its first
// weight load, and then waited for one 16-byte chunk at a time.
//
// Design: weights first. A lane owns chunks lane + 32k of its warp's slice
// of RW rows, and issues every one of them (NC a pass, a template
// parameter: 3 at 3,072 inputs and 4 bits, 8 at 8,192) as read-only loads
// that skip L1, with the scales and biases of their groups, before it
// touches x. Then the block stages x once into the conflict-free planes of
// the GEMV above (f32, plane n holds code n of every word), with one
// barrier, while those loads are in flight. There is no group-sum pass:
// each chunk adds bias * (its own sum of x), taken while it multiplies, so
// sum_g b_g sum_{i in g} x_i becomes sum_chunks b_g(c) sum_{i in c} x_i;
// a chunk that spans two groups (2 bits, g 32) keeps two halves. Codes
// enter as the floats 1 + q / FRAC (below), 2.4-3 instructions a code with
// the FMA. Enough in flight: 8 warps a block, 1 row a warp where 2 would
// leave fewer than DECODE_BLOCKS blocks (o: 384 blocks), and rows of many
// chunks split over KS warps of the block (their sums added in warp order
// through shared memory: no float atomics, so greedy runs repeat exactly);
// ops/qmm.py's decode_shape picks RW, KS and NC. A warp sum ends each
// output.
//
// Measured (PERF.md): a 4-bit step's 113 GEMVs ~1.45 ms of device time
// against the GEMV's ~2.54 and the library's ~1.14. Tried in one call and
// not kept: the GEMV's exact codes (2^23 + q, a subtract a code; 1.51 ms
// against this design's 1.42) and 1 + q / 2^BITS at 4 bits too (1.45).
// Cutting a third of the unpack's instructions moved the step by 6%: what
// holds the kernel back is that a block loads, then waits a round trip,
// then computes, so the load pipe idles while a wave of blocks computes
// (2.6-4.5 waves at gate/up and the band head).
// ---------------------------------------------------------------------------

constexpr int DEC_WARPS = 8;  // warps a block

// a 16-byte read-only load that does not allocate in L1 (each weight is
// read once a call)
__device__ __forceinline__ uint4 ld_stream16(const uint32_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// x[i..i+3] as f32 (i a multiple of 4; x 16-byte aligned)
__device__ __forceinline__ float4 load4_f(const void* p, size_t i, int dt) {
  if (dt == QMM_F32) return *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
  const uint2 r = *reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(p) + i);
  if (dt == QMM_BF16)
    return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xFFFF0000u),
                       __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xFFFF0000u));
  const __half2 h0 = *reinterpret_cast<const __half2*>(&r.x);
  const __half2 h1 = *reinterpret_cast<const __half2*>(&r.y);
  return make_float4(__low2float(h0), __high2float(h0), __low2float(h1), __high2float(h1));
}

// The decode kernel reads code q as the exact float f = 1 + q / FRAC (q at
// the top of the mantissa), so that sum x * q = FRAC * (sum x * f - sum x)
// with the chunk's own sum of x: no int-to-float subtract a code.
// 2 and 8 bits, FRAC = 2^BITS: code n of word w, one shift and one LOP3.
template <int BITS>
__device__ __forceinline__ float code_frac(uint32_t w, int n) {
  constexpr uint32_t MASK = ((1u << BITS) - 1u) << (23 - BITS);
  const int s = 23 - BITS - BITS * n;
  const uint32_t v = s >= 0 ? w << s : w >> -s;
  return __uint_as_float((v & MASK) | 0x3F800000u);
}

// 4 bits, FRAC = 128: codes m, m + 2, m + 4, m + 6 of word w (m = 0, 1),
// one a byte as 0x80 | q (one shift and one LOP3 for four codes) ...
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t w, int m) {
  return ((w >> (4 * m)) & 0x0F0F0F0Fu) | 0x80808080u;
}

// ... and byte k of them as 1 + q / 128 with one PRMT (0x3F above it)
__device__ __forceinline__ float byte_frac(uint32_t b, int k) {
  return __uint_as_float(__byte_perm(b, 0x3Fu, 0x4055u | (k << 8)));
}

template <int BITS, int NC, int RW>
__global__ void __launch_bounds__(DEC_WARPS * 32)
quantized_matvec_decode_kernel(const void* __restrict__ x, int x_dt,
                               const uint32_t* __restrict__ w,
                               const void* __restrict__ scales,
                               const void* __restrict__ biases, int s_dt,
                               void* __restrict__ out, int O, int I, int gs, int ks) {
  constexpr int PW = 32 / BITS;  // codes a word
  extern __shared__ __align__(16) float dsmem[];
  const int NW = I / PW;         // words a row
  const int NWp = NW + 4;        // a plane's stride, as in the GEMV above
  const int CR = NW / 4;         // chunks a row
  const int G = I / gs;
  const int wpg = gs / PW;       // words a group (>= 2)
  const bool two = BITS == 2 && wpg == 2;  // a chunk spans two groups
  constexpr float FRAC = BITS == 4 ? 128.0f : (float)(1 << BITS);
  const int nct = (CR + 32 * ks - 1) / (32 * ks);  // chunks a lane, all passes
  float* xs = dsmem;                               // [PW][NWp]
  float* part = dsmem + PW * NWp;                  // [DEC_WARPS][RW]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slice = warp % ks;
  const int o0 = (blockIdx.x * (DEC_WARPS / ks) + warp / ks) * RW;
  const uint32_t* wrow[RW];
  size_t srow[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int o = min(o0 + r, O - 1);  // a dead row reads a live one
    wrow[r] = w + (size_t)o * NW;
    srow[r] = (size_t)o * G;
  }

  float acc[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) acc[r] = 0.0f;
  for (int k0 = 0; k0 < nct; k0 += NC) {
    // the weights first: every chunk of the pass, with its groups' scales
    // and biases
    uint4 wv[NC][RW];
    float sc0[NC][RW], sc1[NC][RW], bi0[NC][RW], bi1[NC][RW];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = (slice * nct + k0 + k) * 32 + lane;
      const bool ok = k0 + k < nct && c < CR;
      const int g0 = 4 * c / wpg;
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        if (ok) {
          wv[k][r] = ld_stream16(wrow[r] + 4 * (size_t)c);
          sc0[k][r] = load_f(scales, srow[r] + g0, s_dt);
          bi0[k][r] = load_f(biases, srow[r] + g0, s_dt);
          sc1[k][r] = two ? load_f(scales, srow[r] + g0 + 1, s_dt) : sc0[k][r];
          bi1[k][r] = two ? load_f(biases, srow[r] + g0 + 1, s_dt) : bi0[k][r];
        } else {
          wv[k][r] = make_uint4(0u, 0u, 0u, 0u);
          sc0[k][r] = sc1[k][r] = bi0[k][r] = bi1[k][r] = 0.0f;
        }
      }
    }
    if (k0 == 0) {
      // x into the planes while the weights are in flight: inputs i..i+3
      // lie in one word (PW >= 4), as codes i % PW.. of word i / PW
#pragma unroll 4
      for (int i4 = threadIdx.x; i4 < I / 4; i4 += blockDim.x) {
        const float4 v = load4_f(x, 4 * (size_t)i4, x_dt);
        const int wi = 4 * i4 / PW, n = 4 * i4 % PW;
        xs[n * NWp + wi] = v.x;
        xs[(n + 1) * NWp + wi] = v.y;
        xs[(n + 2) * NWp + wi] = v.z;
        xs[(n + 3) * NWp + wi] = v.w;
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = (slice * nct + k0 + k) * 32 + lane;
      if (k0 + k >= nct || c >= CR) continue;
      // words 0-1 and 2-3 of the chunk: the sums of x * f and of x
      float xlo = 0.0f, xhi = 0.0f, lo[RW], hi[RW];
      uint32_t ws[RW][4], nb[RW][4][2];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        lo[r] = hi[r] = 0.0f;
        ws[r][0] = wv[k][r].x, ws[r][1] = wv[k][r].y, ws[r][2] = wv[k][r].z, ws[r][3] = wv[k][r].w;
        if constexpr (BITS == 4) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            nb[r][j][0] = nibble_bytes(ws[r][j], 0);
            nb[r][j][1] = nibble_bytes(ws[r][j], 1);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < PW; ++n) {
        const float4 xv = reinterpret_cast<const float4*>(xs + n * NWp)[c];
        xlo += xv.x + xv.y;
        xhi += xv.z + xv.w;
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          float f[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            f[j] = BITS == 4 ? byte_frac(nb[r][j][n % 2], n / 2) : code_frac<BITS>(ws[r][j], n);
          lo[r] += xv.x * f[0] + xv.y * f[1];
          hi[r] += xv.z * f[2] + xv.w * f[3];
        }
      }
#pragma unroll
      for (int r = 0; r < RW; ++r)
        acc[r] += (sc0[k][r] * FRAC) * (lo[r] - xlo) + (sc1[k][r] * FRAC) * (hi[r] - xhi) +
                  (bi0[k][r] * xlo + bi1[k][r] * xhi);  // the chunk's bias term
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) acc[r] = tpa::warp_sum(acc[r]);
  if (ks > 1) {
    // the KS slices of a row, added in warp order
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < RW; ++r) part[warp * RW + r] = acc[r];
    __syncthreads();
    if (slice == 0)
#pragma unroll
      for (int r = 0; r < RW; ++r)
        for (int s = 1; s < ks; ++s) acc[r] += part[(warp + s) * RW + r];
  }
  if (lane == 0 && slice == 0)
#pragma unroll
    for (int r = 0; r < RW; ++r)
      if (o0 + r < O) store_f(out, o0 + r, x_dt, acc[r]);
}

template <int BITS, int NC, int RW>
cudaError_t launch_decode(const void* x, int x_dt, const uint32_t* w, const void* scales,
                          const void* biases, int s_dt, void* out, int O, int I, int gs,
                          int ks, cudaStream_t stream) {
  const auto kernel = quantized_matvec_decode_kernel<BITS, NC, RW>;
  const size_t smem = (size_t)(I + 4 * (32 / BITS) + DEC_WARPS * RW) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int rows = DEC_WARPS / ks * RW;
  kernel<<<(O + rows - 1) / rows, DEC_WARPS * 32, smem, stream>>>(
      x, x_dt, w, scales, biases, s_dt, out, O, I, gs, ks);
  return cudaGetLastError();
}

template <int BITS, int RW>
cudaError_t launch_decode_nc(int nc, const void* x, int x_dt, const uint32_t* w,
                             const void* scales, const void* biases, int s_dt, void* out,
                             int O, int I, int gs, int ks, cudaStream_t stream) {
  switch (nc) {
    case 1: return launch_decode<BITS, 1, RW>(x, x_dt, w, scales, biases, s_dt, out, O, I, gs, ks, stream);
    case 2: return launch_decode<BITS, 2, RW>(x, x_dt, w, scales, biases, s_dt, out, O, I, gs, ks, stream);
    case 3: return launch_decode<BITS, 3, RW>(x, x_dt, w, scales, biases, s_dt, out, O, I, gs, ks, stream);
    case 4: return launch_decode<BITS, 4, RW>(x, x_dt, w, scales, biases, s_dt, out, O, I, gs, ks, stream);
    case 5: return launch_decode<BITS, 5, RW>(x, x_dt, w, scales, biases, s_dt, out, O, I, gs, ks, stream);
    case 8: return launch_decode<BITS, 8, RW>(x, x_dt, w, scales, biases, s_dt, out, O, I, gs, ks, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int BITS>
cudaError_t launch_decode_bits(int nc, int rw, const void* x, int x_dt, const uint32_t* w,
                               const void* scales, const void* biases, int s_dt, void* out,
                               int O, int I, int gs, int ks, cudaStream_t stream) {
  if (ks != 1 && ks != 2 && ks != 4) return cudaErrorInvalidValue;
  switch (rw) {
    case 1: return launch_decode_nc<BITS, 1>(nc, x, x_dt, w, scales, biases, s_dt, out, O, I, gs, ks, stream);
    case 2: return launch_decode_nc<BITS, 2>(nc, x, x_dt, w, scales, biases, s_dt, out, O, I, gs, ks, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The tile for 2-64 rows of x: bf16 tensor cores (mma.sync m16n8k16, f32
// sums), with output features on the MMA's M side (16 weight rows a
// fragment) and rows of x on its N side (8 a fragment, NB fragments).
//
// Bound on the H100: at 63 rows a weight is used 63 times, so the work is
// the tensor cores': f32 x is split into two bf16 parts, x_hi = bf16(x) and
// x_lo = bf16(x - x_hi), each multiplied by the exact bf16 codes into the
// same f32 fragment, which keeps ~2^-17 of x (the tile must meet 1e-4 of
// the largest output; bf16 x alone misses it). The codes are taken signed,
// q - 2^(bits - 1) (integers -128..127, exact in bf16), and 2^(bits - 1) *
// scale joins the bias: a product then weighs at most half the group's
// range, which halves what the split's residual costs. That is 4 * rows *
// O * I operations at 989 TFLOP/s (2 * rows * O * I for bf16 x, one
// product): ~0.72 ms for the 112 GEMVs of a 63-row Orpheus-3B prefill,
// against 0.53 ms for their bytes at 3.35 TB/s.
//
// Design. A first kernel splits x once a call (every block of the tile
// reads all of it) into quads of 16 bytes, {hi(x0, x1), hi(x2, x3), lo(x0,
// x1), lo(x2, x3)} (bf16 x: its own pairs, 8 bytes), and takes the f32
// group sums of x. The tile: a block of TILE_WARPS warps owns TILE_BM
// output rows, a warp 16 of them (one M fragment) and every N fragment,
// over one slice of the input features (grid.y slices of whole groups; the
// slices' partial sums go to `part` and a third kernel adds them in slice
// order, so the result does not depend on the schedule: no float atomics).
// The block streams its weight rows and the split rows of x through shared
// memory with cp.async, TILE_STAGES stages of TILE_KC inputs in flight, and
// stages the scales, biases (+ 2^(bits - 1) * scale) and group sums of x of
// TILE_SG groups at a time. A k-step of 16 inputs gives lane (g, t) of a
// warp the inputs 4t..4t+3 (the order inside a k-step is free, as long as A
// and B agree): four codes of one word of rows g and g + 8, unpacked
// straight into bf16 pairs, and one quad of x in row g of each N fragment.
// Each group accumulates x * q into a fresh fragment P; at the group's end
// y += scale * P + bias * (group sum of x) in f32, for the (row, output) of
// each accumulator the lane holds. Measured: the tile is latency-bound at
// two warps a scheduler (see PERF.md), so it keeps a k-step's work per N
// fragment to one shared-memory load and two MMAs.
// ---------------------------------------------------------------------------

constexpr int TILE_WARPS = 8;              // warps a block
constexpr int TILE_BM = 16 * TILE_WARPS;   // output rows a block
constexpr int TILE_KC = 64;                // inputs a stage
constexpr int TILE_STAGES = 3;             // stages in flight
constexpr int TILE_XPAD = 16;              // inputs padding a staged row of x
constexpr int TILE_SG = 16;                // groups of scales, biases, sums staged at once
constexpr int TILE_SGP = TILE_SG + 1;      // their row stride (banks staggered)

// words of a staged weight row: its stage's words, padded to 4 mod 8 so that
// the 8 rows a warp reads at once (1, 2 or 4 words each) land in distinct
// banks, and to a multiple of 4 for the 16-byte copies
template <int BITS>
__host__ __device__ constexpr int tile_ws() {
  return TILE_KC * BITS / 32 + (TILE_KC * BITS / 32 % 8 == 0 ? 4 : 8);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// codes n0..n0+3 of word w, minus 2^(BITS - 1), as two exact bf16 pairs.
// 2 and 4 bits: (q | 0x4300) is the bf16 128 + q, so one bf16x2 subtract
// of 128 + 2^(BITS - 1) leaves q - 2^(BITS - 1); 8 bits through f32.
template <int BITS>
__device__ __forceinline__ void codes4(uint32_t w, int n0, uint32_t& p01, uint32_t& p23) {
  constexpr float MID = 1 << (BITS - 1);
  if constexpr (BITS == 8) {
    p01 = bf16x2(code<8>(w, 0) - MID, code<8>(w, 1) - MID);
    p23 = bf16x2(code<8>(w, 2) - MID, code<8>(w, 3) - MID);
  } else {
    constexpr uint32_t M = (1u << BITS) - 1u;
    constexpr uint32_t OFF = 0x4300u + (1u << (BITS - 1));  // bf16 128 + MID
    const uint32_t v = w >> (BITS * n0);
    p01 = bf16x2_sub((v & M) | ((v >> BITS & M) << 16) | 0x43004300u, OFF * 0x10001u);
    p23 = bf16x2_sub((v >> 2 * BITS & M) | ((v >> 3 * BITS & M) << 16) | 0x43004300u,
                     OFF * 0x10001u);
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x [B, I] -> xq [B, I / 4] quads (split: 16 bytes {hi01, hi23, lo01, lo23};
// bf16 x: 8 bytes, its own pairs) and xg [B, G] the f32 group sums. A warp a
// (row, group), a lane a quad.
__global__ void quantized_matvec_tile_split(const void* __restrict__ x, int x_dt,
                                            uint32_t* __restrict__ xq, float* __restrict__ xg,
                                            int B, int I, int gs) {
  const int G = I / gs;
  const int t = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (t >= B * G) return;
  const int b = t / G, grp = t - b * G;
  float s = 0.0f;
  if (lane < gs / 4) {
    const size_t i = (size_t)b * I + grp * gs + 4 * lane;  // the quad's first input
    float v[4];
    if (x_dt == QMM_F32) {
      const float4 f = *reinterpret_cast<const float4*>(static_cast<const float*>(x) + i);
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
      const uint2 r = *reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(x) + i);
      if (x_dt == QMM_BF16) {
        reinterpret_cast<uint2*>(xq)[i / 4] = r;
        v[0] = __uint_as_float(r.x << 16), v[1] = __uint_as_float(r.x & 0xFFFF0000u);
        v[2] = __uint_as_float(r.y << 16), v[3] = __uint_as_float(r.y & 0xFFFF0000u);
      } else {
        const __half2 h0 = *reinterpret_cast<const __half2*>(&r.x);
        const __half2 h1 = *reinterpret_cast<const __half2*>(&r.y);
        v[0] = __low2float(h0), v[1] = __high2float(h0);
        v[2] = __low2float(h1), v[3] = __high2float(h1);
      }
    }
    if (x_dt != QMM_BF16) {
      uint4 q;
      q.x = bf16x2(v[0], v[1]);
      q.y = bf16x2(v[2], v[3]);
      q.z = bf16x2(v[0] - __uint_as_float(q.x << 16), v[1] - __uint_as_float(q.x & 0xFFFF0000u));
      q.w = bf16x2(v[2] - __uint_as_float(q.y << 16), v[3] - __uint_as_float(q.y & 0xFFFF0000u));
      reinterpret_cast<uint4*>(xq)[i / 4] = q;
    }
    s = ((v[0] + v[1]) + v[2]) + v[3];
  }
  s = tpa::warp_sum(s);
  if (lane == 0) xg[t] = s;
}

template <int BITS, int NB>
__global__ void __launch_bounds__(TILE_WARPS * 32)
quantized_matvec_tile_kernel(const uint32_t* __restrict__ xq, const float* __restrict__ xg,
                             int split, const uint32_t* __restrict__ w,
                             const void* __restrict__ scales,
                             const void* __restrict__ biases, int s_dt,
                             void* __restrict__ out, int x_dt, float* __restrict__ part,
                             int B, int O, int I, int gs) {
  constexpr int PW = 32 / BITS;             // codes a word
  constexpr float MID = 1 << (BITS - 1);    // codes are taken as q - MID
  constexpr int WS = tile_ws<BITS>();       // words a staged weight row
  constexpr int XS = TILE_KC + TILE_XPAD;   // inputs a staged row of x
  constexpr int XR = 8 * NB;                // staged rows of x
  extern __shared__ __align__(16) unsigned char tsmem[];
  const int esz = split ? 4 : 2;            // bytes an input of x (a quad's quarter)
  const int x_stage = XR * XS * esz;        // bytes of a stage's x
  unsigned char* xs0 = tsmem;
  uint32_t* ws0 = reinterpret_cast<uint32_t*>(tsmem + TILE_STAGES * x_stage);
  // the scales, the biases (+ MID * scale) and x's group sums of TILE_SG groups
  float* ss = reinterpret_cast<float*>(ws0 + TILE_STAGES * TILE_BM * WS);  // [TILE_BM][TILE_SGP]
  float* sb = ss + TILE_BM * TILE_SGP;
  float* sx = sb + TILE_BM * TILE_SGP;                                     // [XR][TILE_SGP]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int NW = I / PW, G = I / gs;
  const int m0 = blockIdx.x * TILE_BM;

  // this block's slice of the input features: whole units of max(TILE_KC, gs)
  const int unit = gs > TILE_KC ? gs : TILE_KC;
  const int n_units = (I + unit - 1) / unit;
  const int k_begin = blockIdx.y * n_units / gridDim.y * unit;
  const int k_end = min((blockIdx.y + 1) * n_units / gridDim.y * unit, I);
  const int n_stages = (k_end - k_begin + TILE_KC - 1) / TILE_KC;
  const int g_begin = k_begin / gs, g_end = k_end / gs;

  auto load = [&](int st) {
    const int k0 = k_begin + st * TILE_KC;
    const int len = min(TILE_KC, k_end - k0);  // a multiple of 32
    unsigned char* xs = xs0 + (st % TILE_STAGES) * x_stage;
    uint32_t* ws = ws0 + (st % TILE_STAGES) * TILE_BM * WS;
    const int epc = 16 / esz;  // inputs a 16-byte chunk
    const int xc = len / epc;  // chunks a row of x
    for (int c = threadIdx.x; c < XR * xc; c += blockDim.x) {
      const int r = c / xc, e = (c - r * xc) * epc;
      const bool live = r < B;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(xq) +
                                 ((size_t)(live ? r : 0) * I + k0 + e) * esz;
      cp_async16(xs + (r * XS + e) * esz, src, live);
    }
    const int wc = len * BITS / 128;  // chunks a weight row
    for (int c = threadIdx.x; c < TILE_BM * wc; c += blockDim.x) {
      const int r = c / wc, e = (c - r * wc) * 4;
      const int o = min(m0 + r, O - 1);  // a dead row reads a live one
      cp_async16(ws + r * WS + e, w + (size_t)o * NW + k0 / PW + e, true);
    }
  };
  // groups grp0..grp0 + TILE_SG - 1 (as far as the slice goes): every load
  // issued before any store
  auto load_groups = [&](int grp0) {
    constexpr int PER = TILE_BM * TILE_SG / (TILE_WARPS * 32);  // a thread's rows of w
    constexpr int PERX = XR * TILE_SG / (TILE_WARPS * 32) + 1;   // of x (at most)
    float sv[PER], bv[PER], xv[PERX];
#pragma unroll
    for (int n = 0; n < PER; ++n) {
      const int idx = threadIdx.x + n * TILE_WARPS * 32;
      const int r = idx / TILE_SG, c = idx - r * TILE_SG;
      const size_t at = (size_t)min(m0 + r, O - 1) * G + min(grp0 + c, g_end - 1);
      sv[n] = load_f(scales, at, s_dt);
      bv[n] = load_f(biases, at, s_dt);
    }
#pragma unroll
    for (int n = 0; n < PERX; ++n) {
      const int idx = threadIdx.x + n * TILE_WARPS * 32;
      const int r = idx / TILE_SG, c = idx - r * TILE_SG;
      xv[n] = idx < XR * TILE_SG && r < B ? xg[(size_t)r * G + min(grp0 + c, g_end - 1)] : 0.0f;
    }
#pragma unroll
    for (int n = 0; n < PER; ++n) {
      const int idx = threadIdx.x + n * TILE_WARPS * 32;
      const int r = idx / TILE_SG, c = idx - r * TILE_SG;
      ss[r * TILE_SGP + c] = sv[n];
      sb[r * TILE_SGP + c] = bv[n] + MID * sv[n];
    }
#pragma unroll
    for (int n = 0; n < PERX; ++n) {
      const int idx = threadIdx.x + n * TILE_WARPS * 32;
      const int r = idx / TILE_SG, c = idx - r * TILE_SG;
      if (idx < XR * TILE_SG) sx[r * TILE_SGP + c] = xv[n];
    }
  };

  const int lrow = warp * 16 + g;  // the lane's first row in the block (and lrow + 8)
  float y[NB][4], p[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) y[j][c] = p[j][c] = 0.0f;

#pragma unroll
  for (int st = 0; st < TILE_STAGES - 1; ++st) {
    if (st < n_stages) load(st);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  load_groups(g_begin);  // while the first stages are in flight
  for (int st = 0; st < n_stages; ++st) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(TILE_STAGES - 2));
    __syncthreads();  // stage st landed, and stage st - 1's buffer is free
    if (st + TILE_STAGES - 1 < n_stages) load(st + TILE_STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const int k0 = k_begin + st * TILE_KC;
    const int len = min(TILE_KC, k_end - k0);
    const unsigned char* xs = xs0 + (st % TILE_STAGES) * x_stage;
    const uint32_t* ws = ws0 + (st % TILE_STAGES) * TILE_BM * WS;
#pragma unroll
    for (int ks = 0; ks < TILE_KC; ks += 16) {
      if (ks >= len) break;
      const int k = k0 + ks;
      const int grp = k / gs;
      if (k % gs == 0 && grp != g_begin && (grp - g_begin) % TILE_SG == 0) {
        __syncthreads();  // every warp is done with the staged groups
        load_groups(grp);
        __syncthreads();
      }
      // A: codes 4t..4t+3 of the k-step, rows lrow and lrow + 8
      const int wi = (ks + 4 * t) / PW, n0 = (ks + 4 * t) % PW;
      uint32_t a[4];
      codes4<BITS>(ws[lrow * WS + wi], n0, a[0], a[2]);
      codes4<BITS>(ws[(lrow + 8) * WS + wi], n0, a[1], a[3]);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        // B: the quad x[8j + g, k + 4t .. k + 4t + 3]
        const int off = ((8 * j + g) * XS + ks + 4 * t) * esz;
        if (split) {
          const uint4 q = *reinterpret_cast<const uint4*>(xs + off);
          mma_bf16(p[j], a, q.x, q.y);  // x_hi
          mma_bf16(p[j], a, q.z, q.w);  // x_lo
        } else {
          const uint2 q = *reinterpret_cast<const uint2*>(xs + off);
          mma_bf16(p[j], a, q.x, q.y);
        }
      }
      if ((k + 16) % gs == 0) {  // the group closes: scale it, add its bias term
        const int c0 = (grp - g_begin) % TILE_SG;
        const float sc[2] = {ss[lrow * TILE_SGP + c0], ss[(lrow + 8) * TILE_SGP + c0]};
        const float bi[2] = {sb[lrow * TILE_SGP + c0], sb[(lrow + 8) * TILE_SGP + c0]};
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          // x's group sums of rows 8j + 2t and 8j + 2t + 1, the lane's columns
          const float xgs[2] = {sx[(8 * j + 2 * t) * TILE_SGP + c0],
                                sx[(8 * j + 2 * t + 1) * TILE_SGP + c0]};
#pragma unroll
          for (int c = 0; c < 4; ++c) {  // (output lrow + 8 (c >> 1), row 8j + 2t + (c & 1))
            y[j][c] += sc[c >> 1] * p[j][c] + bi[c >> 1] * xgs[c & 1];
            p[j][c] = 0.0f;
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int b = 8 * j + 2 * t + (c & 1);
      const int o = m0 + lrow + 8 * (c >> 1);
      if (b < B && o < O) {
        if (part != nullptr)
          part[((size_t)blockIdx.y * B + b) * O + o] = y[j][c];
        else
          store_f(out, (size_t)b * O + o, x_dt, y[j][c]);
      }
    }
  }
}

// out[i] = the slices' partial sums part[0][i] + part[1][i] + ..., in order
__global__ void quantized_matvec_tile_reduce(const float* __restrict__ part, int slices,
                                             int n, void* __restrict__ out, int x_dt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int k = 0; k < slices; ++k) s += part[(size_t)k * n + i];
  store_f(out, i, x_dt, s);
}

template <int BITS, int NB>
cudaError_t launch_tile(const uint32_t* xq, const float* xg, int split, const uint32_t* w,
                        const void* scales, const void* biases, int s_dt, void* out,
                        int x_dt, float* part, int B, int O, int I, int gs, int slices,
                        cudaStream_t stream) {
  const auto kernel = quantized_matvec_tile_kernel<BITS, NB>;
  const size_t smem = (size_t)TILE_STAGES * (8 * NB * (TILE_KC + TILE_XPAD) * (split ? 4 : 2) +
                                             TILE_BM * tile_ws<BITS>() * 4) +
                      (2 * TILE_BM + 8 * NB) * TILE_SGP * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((O + TILE_BM - 1) / TILE_BM, slices);
  kernel<<<grid, TILE_WARPS * 32, smem, stream>>>(xq, xg, split, w, scales, biases, s_dt, out,
                                                  x_dt, slices > 1 ? part : nullptr, B, O, I,
                                                  gs);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_tile_bits(const uint32_t* xq, const float* xg, int split, const uint32_t* w,
                             const void* scales, const void* biases, int s_dt, void* out,
                             int x_dt, float* part, int B, int O, int I, int gs, int slices,
                             cudaStream_t stream) {
  if (B <= 8) return launch_tile<BITS, 1>(xq, xg, split, w, scales, biases, s_dt, out, x_dt, part, B, O, I, gs, slices, stream);
  if (B <= 16) return launch_tile<BITS, 2>(xq, xg, split, w, scales, biases, s_dt, out, x_dt, part, B, O, I, gs, slices, stream);
  if (B <= 32) return launch_tile<BITS, 4>(xq, xg, split, w, scales, biases, s_dt, out, x_dt, part, B, O, I, gs, slices, stream);
  if (B <= 64) return launch_tile<BITS, 8>(xq, xg, split, w, scales, biases, s_dt, out, x_dt, part, B, O, I, gs, slices, stream);
  return cudaErrorInvalidValue;
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

// The decode kernel: x [1, I] (x_dt), w [O, I * bits / 32] words with rows
// of whole 16-byte chunks on a 16-byte aligned pointer (x too),
// scales/biases [O, I / gs] (s_dt), out [1, O] (x_dt). nc: chunks a lane a
// pass (1, 2, 3, 4, 5 or 8), rw: rows a warp (1 or 2), ks: warps a row
// (1, 2 or 4); ops/qmm.py:decode_shape picks them.
extern "C" int tpa_quantized_matvec_decode(const void* x, int x_dt, const void* w,
                                           const void* scales, const void* biases, int s_dt,
                                           void* out, int O, int I, int gs, int bits, int nc,
                                           int rw, int ks, cudaStream_t stream) {
  const uint32_t* wp = static_cast<const uint32_t*>(w);
  cudaError_t e;
  switch (bits) {
    case 2: e = launch_decode_bits<2>(nc, rw, x, x_dt, wp, scales, biases, s_dt, out, O, I, gs, ks, stream); break;
    case 4: e = launch_decode_bits<4>(nc, rw, x, x_dt, wp, scales, biases, s_dt, out, O, I, gs, ks, stream); break;
    case 8: e = launch_decode_bits<8>(nc, rw, x, x_dt, wp, scales, biases, s_dt, out, O, I, gs, ks, stream); break;
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}

// The tile: x [B, I] (x_dt), B <= 64, w [O, I * bits / 32] words with rows of
// whole 16-byte chunks on a 16-byte aligned pointer (x too), scales/biases
// [O, I / gs] (s_dt), out [B, O] (x_dt). Scratch: xq [B, I] at 4 bytes an
// input (2 for bf16 x), xg [B, I / gs] f32, and for slices > 1 part
// [slices, B, O] f32. Launches the split of x, the tile over `slices`
// slices of the input features, and for slices > 1 their sum.
extern "C" int tpa_quantized_matvec_tile(const void* x, int x_dt, const void* w,
                                         const void* scales, const void* biases, int s_dt,
                                         void* out, void* xq, void* xg, void* part, int B,
                                         int O, int I, int gs, int bits, int slices,
                                         cudaStream_t stream) {
  const uint32_t* wp = static_cast<const uint32_t*>(w);
  uint32_t* q = static_cast<uint32_t*>(xq);
  float* sums = static_cast<float*>(xg);
  float* pp = static_cast<float*>(part);
  const int split = x_dt != QMM_BF16;  // bf16 x is its own one bf16 part
  const int n_groups = B * (I / gs);
  quantized_matvec_tile_split<<<(n_groups + 7) / 8, 256, 0, stream>>>(x, x_dt, q, sums, B, I, gs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  switch (bits) {
    case 2: e = launch_tile_bits<2>(q, sums, split, wp, scales, biases, s_dt, out, x_dt, pp, B, O, I, gs, slices, stream); break;
    case 4: e = launch_tile_bits<4>(q, sums, split, wp, scales, biases, s_dt, out, x_dt, pp, B, O, I, gs, slices, stream); break;
    case 8: e = launch_tile_bits<8>(q, sums, split, wp, scales, biases, s_dt, out, x_dt, pp, B, O, I, gs, slices, stream); break;
    default: e = cudaErrorInvalidValue;
  }
  if (e == cudaSuccess && slices > 1) {
    quantized_matvec_tile_reduce<<<(B * O + 255) / 256, 256, 0, stream>>>(pp, slices, B * O,
                                                                         out, x_dt);
    e = cudaGetLastError();
  }
  return (int)e;
}
