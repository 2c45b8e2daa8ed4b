// Fused log-mel projection: out[t, m] = log10(max(sum_f (re^2 + im^2)[t, f]
// * filters[f, m], 1e-10)).
//
// Replaces tpu_audio/ops/pallas_mel.py:fused_log_mel (pallas_call at :72).
// The global max - 8 clamp and the (x + 4) / 4 normalisation stay outside,
// as in the JAX package, because they need a max across all frames.
//
// Bound on the H100: at whisper-large-v3's frontend (T = 3000 frames,
// F = 201 bins, M = 128 mels) the dense product is 2*3000*201*128 = 154
// MFLOP and the traffic 2*3000*201*4 B in + 103 KB of filters + 1.5 MB out,
// about 6.4 MB: a few microseconds of either roofline.
//
// Design: band-limited tiles. A mel filterbank is banded: at 128 Slaney
// mels 394 of its 25,728 weights are nonzero, and the bins between the
// first and last nonzero weight of each group of 16 mels add up to 3,328
// products a frame. Grid (tiles of TT frames, groups of MG mels), 128
// threads. A block
//   - finds the bins [lo, hi] where any mel of its group has a nonzero
//     weight (each thread scans some bins of the group's filter columns,
//     then a shared-memory min and max): any filterbank is taken, a dense
//     one gives [0, F - 1], and no host work or extra launch is needed;
//   - walks lo..hi in pieces of KF bins: stages the power r * r + m * m of
//     its frames and the group's weights of those bins in shared memory,
//     and has each thread add them into its 4 frames x 2 mels of outputs in
//     ascending bin order;
//   - writes log10f(fmaxf(acc, 1e-10f)).
// Every load of a piece (and of a round of the band scan) is issued before
// the first is used: the loops have fixed trip counts and unroll.
// Bit-equal to the first version (one thread a mel, every bin 0..F-1): it
// summed acc += p * w over f in ascending order from 0, and a bin where
// every weight of the group is zero adds exactly 0 to a finite sum, so the
// skipped bins change no bit; the bins kept are summed in the same order
// with the same expressions. The one exception: a non-finite power (inf or
// NaN) in a skipped bin gives NaN there and a finite value here. Finite
// audio cannot give one. Takes any T, F and M up to MG * 65535.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py
// --kv-mel-timing, PERF.md), device ms a call at [3000, 201] x [201, 128]:
// 0.0105 against the first version's 0.0282. Tried and not kept: the same
// tiles with staging loops of a trip count the compiler could not see, so
// that each thread waited on its loads one at a time (0.0204).
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int TT = 64;       // frames a block
constexpr int MG = 16;       // mels a block
constexpr int KF = 32;       // bins a staged piece
constexpr int THREADS = 128;
constexpr int FRAMES = 4;    // frames a thread: ty + 16 k
constexpr int MELS = 2;      // mels a thread: 2 tx, 2 tx + 1
constexpr int PLD = KF + 1;  // f32 a staged power row
constexpr int SCAN = 8;      // filter weights a thread loads a round of the band scan
static_assert(THREADS == (TT / FRAMES) * (MG / MELS), "");
static_assert(TT * KF % THREADS == 0 && KF * MG % THREADS == 0, "");

__global__ void __launch_bounds__(THREADS)
fused_log_mel_kernel(const float* __restrict__ re, const float* __restrict__ im,
                     const float* __restrict__ fb, float* __restrict__ out, int T, int F,
                     int M) {
  __shared__ float power[TT * PLD];  // [TT, PLD]: bins f0.. of the block's frames
  __shared__ float w[KF * MG];       // [KF, MG]: the group's weights of those bins
  __shared__ int band[2];
  const int t0 = blockIdx.x * TT, m0 = blockIdx.y * MG;
  const int mg = min(MG, M - m0);
  if (threadIdx.x == 0) {
    band[0] = F;
    band[1] = -1;
  }
  __syncthreads();
  int lo = F, hi = -1;
  for (int i0 = threadIdx.x; i0 < F * MG; i0 += SCAN * THREADS) {
    float v[SCAN];  // every load of a round in flight at once
#pragma unroll
    for (int u = 0; u < SCAN; ++u) {
      const int i = i0 + u * THREADS, f = i / MG, j = i % MG;
      v[u] = i < F * MG && j < mg ? fb[(size_t)f * M + m0 + j] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < SCAN; ++u) {
      if (v[u] != 0.0f) {
        const int f = (i0 + u * THREADS) / MG;
        lo = min(lo, f);
        hi = max(hi, f);
      }
    }
  }
  if (hi >= 0) {
    atomicMin(band, lo);
    atomicMax(band + 1, hi);
  }
  __syncthreads();
  lo = band[0];
  hi = band[1];

  const int tx = threadIdx.x % (MG / MELS), ty = threadIdx.x / (MG / MELS);
  float acc[FRAMES][MELS];
#pragma unroll
  for (int k = 0; k < FRAMES; ++k)
#pragma unroll
    for (int j = 0; j < MELS; ++j) acc[k][j] = 0.0f;
  for (int f0 = lo; f0 <= hi; f0 += KF) {
    const int nf = min(KF, hi + 1 - f0);
    constexpr int PER = TT * KF / THREADS, WPER = KF * MG / THREADS;
    float r[PER], m[PER], wv[WPER];  // every load of the piece in flight at once
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * THREADS, tt = i / KF, kf = i % KF;
      r[u] = m[u] = 0.0f;
      if (t0 + tt < T && kf < nf) {
        const size_t at = (size_t)(t0 + tt) * F + f0 + kf;
        r[u] = re[at];
        m[u] = im[at];
      }
    }
#pragma unroll
    for (int u = 0; u < WPER; ++u) {
      const int i = threadIdx.x + u * THREADS, kf = i / MG, j = i % MG;
      wv[u] = kf < nf && j < mg ? fb[(size_t)(f0 + kf) * M + m0 + j] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * THREADS;
      power[(i / KF) * PLD + i % KF] = r[u] * r[u] + m[u] * m[u];
    }
#pragma unroll
    for (int u = 0; u < WPER; ++u) w[threadIdx.x + u * THREADS] = wv[u];
    __syncthreads();
    for (int kf = 0; kf < nf; ++kf) {
      float wj[MELS];
#pragma unroll
      for (int j = 0; j < MELS; ++j) wj[j] = w[kf * MG + tx * MELS + j];
#pragma unroll
      for (int k = 0; k < FRAMES; ++k) {
        const float p = power[(ty + k * (TT / FRAMES)) * PLD + kf];
#pragma unroll
        for (int j = 0; j < MELS; ++j) acc[k][j] += p * wj[j];
      }
    }
    __syncthreads();  // the next piece overwrites power and w
  }
#pragma unroll
  for (int k = 0; k < FRAMES; ++k) {
    const int t = t0 + ty + k * (TT / FRAMES);
#pragma unroll
    for (int j = 0; j < MELS; ++j) {
      const int m = tx * MELS + j;
      if (t < T && m < mg) out[(size_t)t * M + m0 + m] = log10f(fmaxf(acc[k][j], 1e-10f));
    }
  }
}

}  // namespace

extern "C" int tpa_fused_log_mel(const float* re, const float* im,
                                 const float* fb, float* out, int T, int F,
                                 int M, cudaStream_t stream) {
  if (T < 1 || F < 0 || M < 1 || (M + MG - 1) / MG > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + TT - 1) / TT, (M + MG - 1) / MG);
  fused_log_mel_kernel<<<grid, THREADS, 0, stream>>>(re, im, fb, out, T, F, M);
  return (int)cudaGetLastError();
}

extern "C" const char* tpa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
