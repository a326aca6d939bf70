// Device code shared by the four spectral kernels of the port
// (fused_raw_dit.cu, fused_raw.cu, fused_mfcc.cu, fused_dit.cu; the FFT
// tile they all run is in fft_tile.cuh):
//
// - acc_log: the accurate f32 log of mfcc_tpu/ops/xmath.py, every step one
//   correctly rounded operation (__fmul_rn / __fadd_rn / __fsub_rn /
//   __fdiv_rn, so nvcc contracts none of them into FMAs).  It rounds
//   exactly as the port's ops/xmath does; the exported entry mfcc_acc_log
//   applies it to a buffer so that this can be checked bit for bit.
// - stage_span: one tile's audio span into shared memory, optionally
//   pre-emphasized with each sample's true predecessor (x[-1] := x[0] only
//   at the row start).
// - direct_features: the direct window-folded DFT tile (a register-tiled
//   outer product over 256-bin blocks in natural bin order, the last bin a
//   separate per-frame dot product), mel accumulation, then the epilogue.
//   fused_raw_dit.cu, fused_raw.cu and fused_mfcc.cu run it where the FFT
//   tile does not apply (an n_fft that is no power of two from 64 to 4096,
//   and in fused_raw.cu no 2^a 5^b either, or a frame tile whose shared
//   memory does not fit).
// - finish: the epilogue every spectral kernel shares: absolute and
//   relative floors, accurate log, then the lifter-folded DCT (cepstra,
//   optional log energy in c0) or the log-mel energies, written to (B, T,
//   n_out); in its Guard mode (fused_raw.cu's NeMo kernels only) the
//   additive log guard in place of the floors.
// - Projection: what the band stage projects |X|^2 on.  "mel" and "bark"
//   (fused_raw_dit.cu's PLP front half: the bark + equal-loudness
//   filterbank, no relative floor, no DCT) differ only in the host's
//   constants; "spec" has no projection, and spec_log writes the floored
//   log of each |X|^2 bin straight to the output in natural bin order.
// - launch_tiles: picks the largest frame tile whose shared memory fits.
//
// Build without --use_fast_math (it makes division approximate).

#pragma once

#include <cuda_runtime.h>

namespace spectral {

constexpr int kThreads = 256;
constexpr int kBins = 256;        // DFT bins per direct bin block
constexpr int kCols = 2 * kBins;  // basis columns per block: cos | sin
constexpr int kChunk = 16;        // basis rows staged per step

// The f32 values of the reference's constants (mfcc_tpu/ops/xmath.py):
// sqrt(2), ln 2, 2/9, 2/7, 2/5, 2/3 rounded to float32.
__device__ __forceinline__ float acc_log(float x) {
  const float kSqrt2 = 0x1.6a09e6p+0f;
  const float kLn2 = 0x1.62e430p-1f;
  const float kC9 = 0x1.c71c72p-3f, kC7 = 0x1.24924ap-2f;
  const float kC5 = 0x1.99999ap-2f, kC3 = 0x1.555556p-1f;
  const int bits = __float_as_int(x);
  int e = ((bits >> 23) & 0xFF) - 127;
  float m = __int_as_float((bits & 0x007FFFFF) | 0x3F800000);
  if (m >= kSqrt2) {  // centre the mantissa in [sqrt(2)/2, sqrt(2))
    m = __fmul_rn(m, 0.5f);
    e += 1;
  }
  const float r = __fdiv_rn(__fsub_rn(m, 1.0f), __fadd_rn(m, 1.0f));
  const float r2 = __fmul_rn(r, r);
  float p = __fadd_rn(__fmul_rn(kC9, r2), kC7);
  p = __fadd_rn(__fmul_rn(p, r2), kC5);
  p = __fadd_rn(__fmul_rn(p, r2), kC3);
  p = __fadd_rn(__fmul_rn(p, r2), 2.0f);
  return __fadd_rn(__fmul_rn(static_cast<float>(e), kLn2), __fmul_rn(r, p));
}

// The projection of the band stage (the host passes fused_raw_dit.cu an
// int; the other entries project on mel).
enum Projection {
  kMelProjection = 0,
  kBarkProjection = 1,
  kSpecProjection = 2
};

// What the epilogue needs: the projection, the floors and the output.
struct Epilogue {
  const float* melw;  // (n_bins, n_mels): mel or bark; null for spec
  const float* dctm;  // (n_mels, n_mfcc) lifter-folded DCT-II
  float* out;         // (B, T, n_out)
  int T, n_mels, n_out;  // n_mels: the bands (n_bark for bark, n_bins spec)
  float log_floor, rel_floor;
  int apply_dct;      // 0: write the log band energies (n_out == n_mels)
  int append_energy;  // log frame energy in c0 (only with apply_dct)
  int projection = kMelProjection;
};

// Floats a tile stages per frame for the band energies: none for the
// spectrogram, whose logs go from |X|^2 straight to the output.
__host__ __device__ inline int staged_width(const Epilogue& e) {
  return e.projection == kSpecProjection ? 0 : e.n_mels;
}

// The spectrogram's output: bin k of frame t (of the row's T) of row b is
// the floored accurate log of its power v, as finish() logs a band.
__device__ __forceinline__ void spec_log(const Epilogue& e, int b, int t,
                                         int k, float v) {
  if (t < e.T)
    e.out[(static_cast<long long>(b) * e.T + t) * e.n_out + k] =
        acc_log(fmaxf(v, e.log_floor));
}

// Shared-memory layout of a tile of TM frames: a buffer of buf_floats(TM)
// floats (a basis chunk, later one bin block's power), the audio span, the
// (TM, n_mels) mel energies, and two (TM) per-frame vectors.
__host__ __device__ constexpr int buf_floats(int TM) {
  return kChunk * kCols > TM * kBins ? kChunk * kCols : TM * kBins;
}

// z[i] = x[s0 + i] (pre-emphasized when preemph != 0), zero past the row.
__device__ __forceinline__ void stage_span(const float* xb, long long N,
                                           long long s0, int span,
                                           float preemph, float* z) {
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const long long g = s0 + i;
    float v = 0.0f;
    if (g < N) {
      v = xb[g];
      if (preemph != 0.0f) {
        const float prev = g > 0 ? xb[g - 1] : v;
        v = __fsub_rn(v, __fmul_rn(preemph, prev));
      }
    }
    z[i] = v;
  }
}

// Floors, log, then DCT (+ energy) or log-mel, for the tile's frames.
// mel: (TM, n_mels) energies, overwritten with their logs; rowv: (TM)
// work space; en: (TM) unwindowed frame energies.  Ends the kernel's work.
// Guard: the additive log guard of NeMo's preprocessor, log(e +
// log_floor) with the sum rounded to f32, in place of the floors (no
// relative floor, no DCT: the host refuses them); a compile-time mode, so
// that every instantiation without it is as it was.
template <int TM, bool Guard = false>
__device__ __forceinline__ void finish(const Epilogue& p, float* mel,
                                       float* rowv, const float* en, int b,
                                       int t0) {
  const int tid = threadIdx.x;
  if constexpr (Guard) {
    for (int o = tid; o < TM * p.n_mels; o += kThreads)
      mel[o] = acc_log(__fadd_rn(mel[o], p.log_floor));
  } else {
    // the reference takes e = max(e, rel) with rel = max_j(e) * rel_floor,
    // then log(max(e, log_floor)); max is exact, so one per-frame floor
    // max(log_floor, rel) gives the same bits
    for (int m = tid; m < TM; m += kThreads) {
      float f = p.log_floor;
      if (p.rel_floor > 0.0f) {
        float mx = mel[m * p.n_mels];
        for (int j = 1; j < p.n_mels; ++j)
          mx = fmaxf(mx, mel[m * p.n_mels + j]);
        f = fmaxf(f, __fmul_rn(mx, p.rel_floor));
      }
      rowv[m] = f;
    }
    __syncthreads();
    for (int o = tid; o < TM * p.n_mels; o += kThreads)
      mel[o] = acc_log(fmaxf(mel[o], rowv[o / p.n_mels]));
  }
  __syncthreads();
  for (int o = tid; o < TM * p.n_out; o += kThreads) {
    const int m = o / p.n_out, c = o - m * p.n_out;
    if (t0 + m >= p.T) continue;
    float v;
    if (!p.apply_dct) {
      v = mel[m * p.n_mels + c];
    } else if (p.append_energy && c == 0) {
      v = acc_log(fmaxf(en[m], p.log_floor));
    } else {
      v = 0.0f;
      for (int j = 0; j < p.n_mels; ++j)
        v = fmaf(mel[m * p.n_mels + j], __ldg(p.dctm + j * p.n_out + c), v);
    }
    p.out[(static_cast<long long>(b) * p.T + t0 + m) * p.n_out + c] = v;
  }
}

// ---------------------------------------------------------------------------
// The direct window-folded DFT tile.
//
// What bounds it on the card: fp32 FMA rate.  A frame of frame_len samples
// against 256 cos + 256 sin columns per bin block is frame_len * 512 FMAs
// a block; audio in and features out are a few hundred bytes a frame, three
// orders of magnitude under the FMA work.  The contract is true fp32, so no
// tensor cores and no TF32.
//
// What the design does about it: a block of 256 threads owns TM = 8*FR
// frames of one row and all bins of a 256-bin block.  Each thread keeps FR
// frames x 8 bins x (cos, sin) = 16*FR accumulators; per basis row it reads
// FR broadcast samples and four conflict-free float4 basis vectors from
// shared memory and runs 16*FR FMAs.  The span is staged once; the
// window-folded bases stream from L2 in 16-row chunks.  Bins stay in
// natural order, so the plain mel (or bark) matrix serves, and the
// spectrogram logs each block's power as it leaves the block (no identity
// projection, no n_bins^2 MACs).
// ---------------------------------------------------------------------------

struct DirectParams {
  const float* x;      // (B, N) audio
  const float* basis;  // (nbb, frame_len, 512) window-folded [cos | sin]
  const float* last;   // (frame_len, 2) window-folded cos/sin, last bin
  Epilogue e;
  long long N;
  int tiles, nbb, frame_len, hop, n_bins, span;
  float preemph;       // 0: the host pre-emphasized (or the config has none)
};

template <int FR>
__device__ __forceinline__ void direct_features(const DirectParams& p) {
  constexpr int TM = 8 * FR;
  extern __shared__ __align__(16) float smem[];
  float* buf = smem;
  float* z = buf + buf_floats(TM);     // the (pre-emphasized) span
  float* mel = z + p.span;              // (TM, n_mels) mel energies, logs
  float* rowv = mel + TM * staged_width(p.e);  // (TM) last-bin power
  float* en = rowv + TM;                // (TM) frame energy
  const bool spec = p.e.projection == kSpecProjection;

  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int b = blockIdx.x / p.tiles;
  const int t0 = (blockIdx.x % p.tiles) * TM;
  const float* xb = p.x + static_cast<long long>(b) * p.N;

  stage_span(xb, p.N, static_cast<long long>(t0) * p.hop, p.span, p.preemph,
             z);
  for (int i = tid; i < TM * staged_width(p.e); i += kThreads) mel[i] = 0.0f;
  __syncthreads();

  const int main_bins = p.n_bins - 1;
  for (int bb = 0; bb < p.nbb; ++bb) {
    float ac[FR][8], as[FR][8];
#pragma unroll
    for (int i = 0; i < FR; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ac[i][j] = 0.0f;
        as[i][j] = 0.0f;
      }
    }
    const float* basis =
        p.basis + static_cast<long long>(bb) * p.frame_len * kCols;
    for (int k0 = 0; k0 < p.frame_len; k0 += kChunk) {
      float4* b4 = reinterpret_cast<float4*>(buf);
      for (int i = tid; i < kChunk * (kCols / 4); i += kThreads) {
        const int r = i / (kCols / 4), c4 = i % (kCols / 4);
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (k0 + r < p.frame_len)
          v = __ldg(reinterpret_cast<const float4*>(
                        basis + static_cast<long long>(k0 + r) * kCols) + c4);
        b4[i] = v;
      }
      __syncthreads();
      const float* zf = z + ty * FR * p.hop + k0;
#pragma unroll 4
      for (int kk = 0; kk < kChunk; ++kk) {
        float a[FR];
#pragma unroll
        for (int i = 0; i < FR; ++i) a[i] = zf[i * p.hop + kk];
        const float4* row = reinterpret_cast<const float4*>(buf + kk * kCols);
        const float4 c0 = row[tx], c1 = row[32 + tx];
        const float4 s0v = row[64 + tx], s1v = row[96 + tx];
        const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        const float sv[8] = {s0v.x, s0v.y, s0v.z, s0v.w,
                             s1v.x, s1v.y, s1v.z, s1v.w};
#pragma unroll
        for (int i = 0; i < FR; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            ac[i][j] = fmaf(a[i], cv[j], ac[i][j]);
            as[i][j] = fmaf(a[i], sv[j], as[i][j]);
          }
        }
      }
      __syncthreads();
    }

    // ---- |X|^2 of this bin block -> buf as (TM, 256), natural bin order
    float4* pw = reinterpret_cast<float4*>(buf);
#pragma unroll
    for (int i = 0; i < FR; ++i) {
      float pv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        pv[j] = ac[i][j] * ac[i][j] + as[i][j] * as[i][j];
      const int m = ty * FR + i;
      pw[m * (kBins / 4) + tx] = make_float4(pv[0], pv[1], pv[2], pv[3]);
      pw[m * (kBins / 4) + 32 + tx] = make_float4(pv[4], pv[5], pv[6], pv[7]);
    }
    __syncthreads();
    const int nb = min(kBins, main_bins - bb * kBins);
    if (spec) {  // ---- spectrogram: this block's bins, logged ----
      for (int o = tid; o < TM * nb; o += kThreads) {
        const int m = o / nb, c = o - m * nb;
        spec_log(p.e, b, t0 + m, bb * kBins + c, buf[m * kBins + c]);
      }
      __syncthreads();
      continue;
    }

    // ---- mel projection of this bin block, accumulated over blocks ----
    const float* w0 = p.e.melw + static_cast<long long>(bb) * kBins * p.e.n_mels;
    for (int o = tid; o < TM * p.e.n_mels; o += kThreads) {
      const int m = o / p.e.n_mels, j = o - m * p.e.n_mels;
      const float* pr = buf + m * kBins;
      float acc = mel[o];
      for (int c = 0; c < nb; ++c)
        acc = fmaf(pr[c],
                   __ldg(w0 + static_cast<long long>(c) * p.e.n_mels + j), acc);
      mel[o] = acc;
    }
    __syncthreads();
  }

  // ---- last bin (Nyquist for even n_fft) and the unwindowed energy of the
  // frame: G threads per frame, then a shuffle reduction ----
  {
    constexpr int G = kThreads / TM;
    const int m = tid / G, l = tid % G;
    const float* zm = z + m * p.hop;
    float sc = 0.0f, ss = 0.0f, se = 0.0f;
    for (int k = l; k < p.frame_len; k += G) {
      const float v = zm[k];
      sc = fmaf(v, __ldg(p.last + 2 * k), sc);
      ss = fmaf(v, __ldg(p.last + 2 * k + 1), ss);
      se = fmaf(v, v, se);
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      sc += __shfl_xor_sync(0xffffffffu, sc, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      se += __shfl_xor_sync(0xffffffffu, se, off);
    }
    if (l == 0) {
      rowv[m] = sc * sc + ss * ss;
      en[m] = se;
    }
  }
  __syncthreads();
  if (spec) {  // the last bin
    for (int m = tid; m < TM; m += kThreads)
      spec_log(p.e, b, t0 + m, main_bins, rowv[m]);
    return;
  }
  for (int o = tid; o < TM * p.e.n_mels; o += kThreads) {
    const int m = o / p.e.n_mels, j = o - m * p.e.n_mels;
    mel[o] = fmaf(rowv[m],
                  __ldg(p.e.melw +
                        static_cast<long long>(main_bins) * p.e.n_mels + j),
                  mel[o]);
  }
  __syncthreads();
  finish<TM>(p.e, mel, rowv, en, b, t0);
}

// ---------------------------------------------------------------------------
// Launch: the largest frame tile (FR = 8, 4, 2, 1) whose shared memory
// fits.  `kernels[i]` is the kernel instantiated at FR = 8 >> i; span(FR)
// gives that tile's staged span.
// ---------------------------------------------------------------------------

template <typename Params>
using KernelFn = void (*)(const Params);

template <typename Params, typename SpanFn>
cudaError_t launch_tiles(Params p, int B, const KernelFn<Params> kernels[4],
                         SpanFn span_of, cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < 4; ++i) {
    const int FR = 8 >> i, TM = 8 * FR;
    p.span = span_of(FR);
    const size_t bytes = sizeof(float) *
        (static_cast<size_t>(buf_floats(TM)) + p.span +
         TM * staged_width(p.e) + 2 * TM);
    if (bytes > static_cast<size_t>(max_smem)) continue;
    const void* fn = reinterpret_cast<const void*>(kernels[i]);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    p.tiles = (p.e.T + TM - 1) / TM;
    const long long blocks = static_cast<long long>(p.tiles) * B;
    if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
    void* args[] = {&p};
    err = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(blocks)),
                           dim3(kThreads), args, bytes, stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  return cudaErrorInvalidConfiguration;  // not even an 8-frame tile fits
}

// The checks every spectral C entry makes on the epilogue's arguments: a
// projection other than mel has no DCT (the reference asserts it) and no
// relative floor.
inline bool epilogue_ok(const Epilogue& e) {
  return e.T > 0 && e.n_mels > 0 && e.n_out > 0 &&
         (e.apply_dct || e.n_out == e.n_mels) &&
         (e.apply_dct || !e.append_energy) &&
         e.projection >= kMelProjection && e.projection <= kSpecProjection &&
         (e.projection == kMelProjection ||
          (!e.apply_dct && e.rel_floor == 0.0f));
}

// Direct-form launch of fused_raw_dit.cu, fused_raw.cu and fused_mfcc.cu
// (through launch_spectral in fft_tile.cuh); each passes its own
// __global__ entry at FR = 8, 4, 2, 1.
inline cudaError_t launch_direct(DirectParams p, int B,
                                 const KernelFn<DirectParams> kernels[4],
                                 cudaStream_t stream) {
  if (B <= 0 || p.frame_len <= 0 || p.hop <= 0 || p.n_bins < 1 ||
      p.nbb != (p.n_bins - 1 + kBins - 1) / kBins || !epilogue_ok(p.e))
    return cudaErrorInvalidValue;
  const int fl = p.frame_len, hop = p.hop;
  return launch_tiles<DirectParams>(p, B, kernels, [fl, hop](int FR) {
    const int fl_pad = (fl + kChunk - 1) / kChunk * kChunk;
    return ((8 * FR - 1) * hop + fl_pad + 3) / 4 * 4;
  }, stream);
}

__global__ void acc_log_kernel(const float* __restrict__ x,
                               float* __restrict__ y, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    y[i] = acc_log(x[i]);
}

}  // namespace spectral

// Test entry: y[i] = acc_log(x[i]) for n floats, on `stream`.  Returns a
// cudaError_t; 0 is success.
extern "C" int mfcc_acc_log(const float* x, float* y, long long n,
                            void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  spectral::acc_log_kernel<<<1024, spectral::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(x, y, n);
  return cudaGetLastError();
}

extern "C" const char* mfcc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
