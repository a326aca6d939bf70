// Pitch NCCF kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   mfcc_tpu/ops/kernels/fused_nccf.py::fused_nccf
// Work-rate audio (B, Nw) float32 plus a per-utterance ballast (B,) in,
// the ballasted and the plain NCCF on the lag grid out, each
// (B, T, n_lags) float32.  For frame t with extended window
// E = x[t*hop : t*hop + w + max_lag] and A = E[0 : w]:
//   num[L]   = sum_j A[j] * E[j + L]           (L = min_lag .. max_lag)
//   e0       = sum_j A[j]^2,  e_lag[L] = sum_j E[j + L]^2
//   prod     = max(e0 * e_lag, 1e-30)
//   nccf_b   = num / sqrt(prod + ball[b]),  nccf_p = num / sqrt(prod)
//
// What bounds it on the card: very little.  In the direct time domain a
// frame costs w * n_lags multiply-adds for the numerators and as many for
// the lag energies: 2 * 100 * 71 = 14,200 FMAs at the default config,
// 0.9 G for a 64 x 10 s batch, a few hundredths of a millisecond of fp32
// issue.  The outputs (2 x 18 MB) and the input (10 MB) take ~10 us of
// HBM time.  The inner loop reads two shared-memory words per two FMAs, so
// shared-memory bandwidth (~0.1 ms for the batch) is the nearest limit.
//
// What the design does about it: the TPU kernel computes the numerators by
// the correlation theorem (two length-180 DFTs and a lag-grid IDFT, ~78k
// MACs a frame) because the MXU wants GEMMs.  Here the direct correlation
// is 11x fewer operations and more accurate, so it is used instead.  A
// block of 256 threads owns TM consecutive frames of one utterance:
//   1. stage the tile's span of work-rate samples ((TM-1)*hop + w +
//      max_lag floats) in shared memory once; samples past the row's end
//      read 0 (those frames are invalid and masked by every caller);
//   2. one thread per frame sums e0;
//   3. one thread per (frame, lag) output, in output order, so that a warp
//      reads consecutive E samples (conflict-free) and one broadcast A
//      sample per step, and writes consecutive output words (coalesced).
// TM is 32 when the span fits in shared memory, else 8, else 1, so every
// config whose single extended window fits (w + max_lag <= 58,000
// samples) runs; the Python wrapper refuses larger ones.
//
// Numerics: fp32 with FMA accumulation; the floor, the ballast add, the
// square roots and the divisions are spelled __fmul_rn / __fadd_rn /
// __fsqrt_rn / __fdiv_rn (IEEE, nothing contracted).  Build without
// --use_fast_math.  Kernel vs the plain correlation-theorem version: a
// different summation, bounded by 2e-5 on valid frames.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Params {
  const float* x;     // (B, ldx) work-rate rows, Nw valid samples each
  const float* ball;  // (B,) ballast * mean_energy^2
  float* out_b;       // (B, T, n_lags) ballasted NCCF
  float* out_p;       // (B, T, n_lags) plain NCCF
  long long ldx, Nw;
  int T, tiles, TM, w, hop, min_lag, n_lags, span;
};

__global__ void __launch_bounds__(kThreads) nccf_kernel(const Params p) {
  extern __shared__ float smem[];
  float* z = smem;            // (span) work-rate samples of this tile
  float* e0s = z + p.span;    // (TM) frame energies

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.tiles;
  const int t0 = (blockIdx.x % p.tiles) * p.TM;
  const int tm = min(p.TM, p.T - t0);
  const float* xb = p.x + static_cast<long long>(b) * p.ldx;
  const long long s0 = static_cast<long long>(t0) * p.hop;

  for (int i = tid; i < p.span; i += kThreads) {
    const long long g = s0 + i;
    z[i] = g < p.Nw ? xb[g] : 0.0f;
  }
  __syncthreads();

  for (int m = tid; m < tm; m += kThreads) {
    const float* a = z + m * p.hop;
    float s = 0.0f;
    for (int j = 0; j < p.w; ++j) s = fmaf(a[j], a[j], s);
    e0s[m] = s;
  }
  __syncthreads();

  const float ball = p.ball[b];
  const long long base = (static_cast<long long>(b) * p.T + t0) * p.n_lags;
  float* ob = p.out_b + base;
  float* op = p.out_p + base;
  const int n_out = tm * p.n_lags;
  for (int o = tid; o < n_out; o += kThreads) {
    const int m = o / p.n_lags;
    const int l = o - m * p.n_lags;
    const float* a = z + m * p.hop;
    const float* e = a + p.min_lag + l;
    float num = 0.0f, el = 0.0f;
#pragma unroll 4
    for (int j = 0; j < p.w; ++j) {
      const float ev = e[j];
      num = fmaf(a[j], ev, num);
      el = fmaf(ev, ev, el);
    }
    const float prod = fmaxf(__fmul_rn(e0s[m], el), 1e-30f);
    ob[o] = __fdiv_rn(num, __fsqrt_rn(__fadd_rn(prod, ball)));
    op[o] = __fdiv_rn(num, __fsqrt_rn(prod));
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 is
// success.  Launches on `stream` and does not synchronize.
extern "C" int mfcc_fused_nccf(const float* x, long long ldx, long long Nw,
                               const float* ball, float* out_b, float* out_p,
                               int B, int T, int w, int hop, int min_lag,
                               int n_lags, void* stream) {
  if (B <= 0 || T <= 0 || w <= 0 || hop <= 0 || min_lag < 0 || n_lags <= 0 ||
      ldx < Nw)
    return cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int n = w + min_lag + n_lags - 1;  // extended window w + max_lag
  // the largest frame tile whose span fits in shared memory
  const int kTiles[] = {32, 8, 1};
  for (int TM : kTiles) {
    const int span = (TM - 1) * hop + n;
    const size_t bytes = sizeof(float) * (static_cast<size_t>(span) + TM);
    if (bytes > static_cast<size_t>(max_smem)) continue;
    err = cudaFuncSetAttribute(nccf_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    const int tiles = (T + TM - 1) / TM;
    const long long blocks = static_cast<long long>(tiles) * B;
    if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
    const Params p{x, ball, out_b, out_p, ldx, Nw, T, tiles, TM, w, hop,
                   min_lag, n_lags, span};
    nccf_kernel<<<static_cast<unsigned>(blocks), kThreads, bytes,
                  static_cast<cudaStream_t>(stream)>>>(p);
    return cudaGetLastError();
  }
  return cudaErrorInvalidConfiguration;
}

extern "C" const char* mfcc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
