// The shared-memory FFT tile of the spectral kernels fused_raw_dit.cu and
// fused_mfcc.cu, and the launch of it or of the direct tile of
// spectral.cuh.  The host picks the FFT tile for a power-of-two n_fft from
// 64 to 4096 when the output is cepstra or log-mel bounded to <= 50 dB
// (the reference's accuracy rule): in spectral valleys ~120 dB under the
// peak (Hann or Povey windows) an f32 FFT rounds 2.7-6x worse than the
// direct form, so unbounded log-mel keeps the direct tile.
//
// What it computes: exactly what the direct tile computes, the (B, T,
// n_out) cepstra or log-mel energies of raw audio (pre-emphasis in the
// kernel) or of audio the host pre-emphasized, by a radix FFT instead of a
// dense DFT.
//
// What bounds the function on the card (64 x 10 s batches, 67 TFLOP/s
// fp32, 3.35 TB/s HBM): at 16 kHz MFCC-13 the audio in and features out
// are 44.3 MB, 13.2 us of HBM time, and its ~16 kflop a frame of FFT, mel,
// log and DCT are 1.0 GFLOP, ~15 us: bytes and operations about equally.
// At 44.1 kHz (n_fft 2048) the bytes are 34.7 us and the operations (~64
// kflop a frame, 4.1 GFLOP) 61 us: operations bound.  The direct tile
// this replaces did frame_len x 512 FMAs a frame per 256-bin block (26.2
// and 288.3 GFLOP), 26-70x the function's operations, so no schedule of
// that form comes near the bound.
//
// What the design does about it:
// - Two real frames per complex FFT: Z[n] = w[n] z_a[n] + i w[n] z_b[n],
//   zero-padded to n_fft; after the FFT,
//     X_a[k] =  1/2 (Z[k] + conj Z[N-k]),  X_b[k] = -i/2 (Z[k] - conj Z[N-k])
//   for k = 0..N/2 (Z[N] := Z[0]).  No extra twiddle pass, no power-domain
//   combine (what costs the DIT form its valley accuracy); the 1/2 is exact.
// - Stockham radix passes (radix-8, then one radix-2 or radix-4 pass where
//   log2 n_fft is no multiple of 3: last, where its strided writes are
//   contiguous), each butterfly's points in registers, natural order in
//   and out.  The first pass reads the windowed frames straight from the
//   staged span.  Shared memory holds only the exchange between passes,
//   ping-pong, with one pad word per 32 so that power-of-two strides
//   spread over the banks.  A block runs a "wave" of FFT pairs at a time
//   (kWavePoints complex points in all), so every pass has work for all
//   256 threads and the tile's shared memory stays small enough for four
//   blocks per SM.
// - Twiddles (cos, sin of 2 pi m / n_fft) and the window come from float32
//   tables the host builds in float64; no sincosf and no fast math.
// - |X|^2 of bins 0..N/2 lands in shared memory in natural order (in place
//   of the spectrum: the split at bin k reads bins k and N-k and writes
//   bin k only, so no two threads touch one word).  The mel projection
//   sums each band over its nonzero bin range [lo_j, hi_j) only (the
//   skipped terms are exact zeros), cut into chunks of at most 16 bins so
//   that a wide band (240 bins at 44.1 kHz) does not hold the block: one
//   thread per (frame, chunk) loads the chunk's 16 weights as four float4
//   and sums its bins in ascending order, then one per (frame, band) adds
//   the band's chunk sums in order.  The chunk sums live in the exchange
//   buffer the spectrum does not occupy.
// - The unwindowed frame energy and the epilogue (floors, accurate log,
//   DCT or log-mel) are those of the direct tile (spectral.cuh).
// - The frame tile TM (64, 32, 16 or 8 frames of one row) is the largest
//   whose shared memory lets four blocks share an SM (the kernels are
//   built for 64 registers a thread to match); a frame past the row's last
//   is computed from zeros and not written, which also gives the last
//   frame of an odd count its partner.

#pragma once

#include "spectral.cuh"

namespace spectral {

constexpr int kFftMin = 64, kFftMax = 4096;  // n_fft range of the FFT tile
constexpr int kWavePoints = 2048;            // complex points per wave
constexpr int kMelChunk = 16;                // bins per mel chunk
constexpr int kFftSmemTarget = 55 * 1024;    // four blocks on one SM

// One pad word after every 32, so strided exchanges spread over the banks.
__host__ __device__ __forceinline__ int fft_pad(int i) { return i + (i >> 5); }

// The shapes the tile takes (the host wrapper asks for it only on these).
inline bool fft_tile_ok(int n_fft, int frame_len) {
  return n_fft >= kFftMin && n_fft <= kFftMax && (n_fft & (n_fft - 1)) == 0 &&
         frame_len >= 1 && frame_len <= n_fft;
}

struct FftParams {
  const float* x;            // (B, N) audio
  const float* win;          // (frame_len) window
  const float2* tw;          // (n_fft) cos, sin of 2 pi m / n_fft
  const float4* chunk_w;     // (n_chunks, kMelChunk) weights, zero-padded
  const int2* chunks;        // (n_chunks) bins [k0, k1)
  const int2* band_chunks;   // (n_mels) chunks [c0, c1) of band j
  Epilogue e;
  long long N;
  int tiles, frame_len, hop, log2n, pairs, span, n_chunks;
  float preemph;       // 0: the host pre-emphasized (or the config has none)
};

// Forward DFTs of 2, 4 and 8 points held in registers, natural order.
__device__ __forceinline__ void dft4(float& r0, float& i0, float& r1,
                                     float& i1, float& r2, float& i2,
                                     float& r3, float& i3) {
  const float t0r = r0 + r2, t0i = i0 + i2, t1r = r0 - r2, t1i = i0 - i2;
  const float t2r = r1 + r3, t2i = i1 + i3, t3r = r1 - r3, t3i = i1 - i3;
  r0 = t0r + t2r;
  i0 = t0i + t2i;
  r2 = t0r - t2r;
  i2 = t0i - t2i;
  r1 = t1r + t3i;  // t1 - i t3
  i1 = t1i - t3r;
  r3 = t1r - t3i;  // t1 + i t3
  i3 = t1i + t3r;
}

template <int R>
__device__ __forceinline__ void dft(float (&re)[R], float (&im)[R]);

template <>
__device__ __forceinline__ void dft<2>(float (&re)[2], float (&im)[2]) {
  const float ar = re[0] + re[1], ai = im[0] + im[1];
  re[1] = re[0] - re[1];
  im[1] = im[0] - im[1];
  re[0] = ar;
  im[0] = ai;
}

template <>
__device__ __forceinline__ void dft<4>(float (&re)[4], float (&im)[4]) {
  dft4(re[0], im[0], re[1], im[1], re[2], im[2], re[3], im[3]);
}

template <>
__device__ __forceinline__ void dft<8>(float (&re)[8], float (&im)[8]) {
  const float h = 0x1.6a09e6p-1f;  // sqrt(1/2) rounded to float32
  dft4(re[0], im[0], re[2], im[2], re[4], im[4], re[6], im[6]);  // E
  dft4(re[1], im[1], re[3], im[3], re[5], im[5], re[7], im[7]);  // O
  // O[q] *= W8^q, W8 = exp(-2 pi i / 8)
  const float o1r = h * (re[3] + im[3]), o1i = h * (im[3] - re[3]);
  const float o2r = im[5], o2i = -re[5];
  const float o3r = h * (im[7] - re[7]), o3i = -h * (re[7] + im[7]);
  const float o0r = re[1], o0i = im[1];
  const float e0r = re[0], e0i = im[0], e1r = re[2], e1i = im[2];
  const float e2r = re[4], e2i = im[4], e3r = re[6], e3i = im[6];
  re[0] = e0r + o0r;
  im[0] = e0i + o0i;
  re[4] = e0r - o0r;
  im[4] = e0i - o0i;
  re[1] = e1r + o1r;
  im[1] = e1i + o1i;
  re[5] = e1r - o1r;
  im[5] = e1i - o1i;
  re[2] = e2r + o2r;
  im[2] = e2i + o2i;
  re[6] = e2r - o2r;
  im[6] = e2i - o2i;
  re[3] = e3r + o3r;
  im[3] = e3i + o3i;
  re[7] = e3r - o3r;
  im[7] = e3i - o3i;
}

// One Stockham radix-R pass over `pairs` FFTs of 2^log2n points, from
// (sr, si) to (dr, di); ns = 2^log2ns is the length of the sub-transforms
// already done.  Butterfly j of an FFT reads points j + r n/R, multiplies
// point r by W^(k r) (k = j mod ns, W = exp(-2 pi i / (ns R))), takes the
// R-point DFT and writes point q to (j - k) R + k + q ns.
template <int R>
__device__ __forceinline__ void fft_pass(const float* sr, const float* si,
                                         float* dr, float* di,
                                         const float2* tw, int log2n,
                                         int log2ns, int pairs, int nfp) {
  constexpr int LR = R == 8 ? 3 : R == 4 ? 2 : 1;
  const int lq = log2n - LR, nq = 1 << lq, ns = 1 << log2ns;
  const int tws = log2n - log2ns - LR;  // table stride n / (ns R)
  for (int u = threadIdx.x; u < (pairs << lq); u += kThreads) {
    const int f = u >> lq, j = u & (nq - 1), k = j & (ns - 1);
    const float* xr = sr + f * nfp;
    const float* xi = si + f * nfp;
    float vr[R], vi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int idx = fft_pad(j + r * nq);
      vr[r] = xr[idx];
      vi[r] = xi[idx];
    }
    if (k != 0) {
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const float2 w = __ldg(tw + ((k * r) << tws));  // (cos, sin)
        const float a = vr[r], b = vi[r];
        vr[r] = a * w.x + b * w.y;  // (a + i b)(cos - i sin)
        vi[r] = b * w.x - a * w.y;
      }
    }
    dft<R>(vr, vi);
    float* yr = dr + f * nfp;
    float* yi = di + f * nfp;
    const int base = ((j - k) << LR) + k;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int idx = fft_pad(base + r * ns);
      yr[idx] = vr[r];
      yi[idx] = vi[r];
    }
  }
}

// The first radix-8 pass (ns = 1, no twiddles), its inputs read straight
// from the span: point s of pair f is w[s] (z_a[s] + i z_b[s]) for the
// frames a = 2 (q0 + f) and b = a + 1, zero past the frame.
__device__ __forceinline__ void fft_first_pass(const float* z,
                                               const float* win,
                                               int frame_len, int hop,
                                               int q0, float* dr, float* di,
                                               int log2n, int pairs,
                                               int nfp) {
  const int lq = log2n - 3, nq = 1 << lq;
  for (int u = threadIdx.x; u < (pairs << lq); u += kThreads) {
    const int f = u >> lq, j = u & (nq - 1);
    const float* za = z + 2 * (q0 + f) * hop;
    float vr[8], vi[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int s = j + r * nq;
      float a = 0.0f, c = 0.0f;
      if (s < frame_len) {
        const float w = __ldg(win + s);
        a = w * za[s];
        c = w * za[s + hop];
      }
      vr[r] = a;
      vi[r] = c;
    }
    dft<8>(vr, vi);
    float* yr = dr + f * nfp;
    float* yi = di + f * nfp;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int idx = fft_pad(8 * j + r);
      yr[idx] = vr[r];
      yi[idx] = vi[r];
    }
  }
}

// Shared-memory floats of an FFT tile of TM frames.
inline size_t fft_smem_bytes(int TM, int pairs, int nfp, int span,
                             int n_mels) {
  return sizeof(float) * (4 * static_cast<size_t>(pairs) * nfp + span +
                          static_cast<size_t>(TM) * n_mels + 2 * TM);
}

template <int TM>
__device__ __forceinline__ void fft_features(const FftParams& p) {
  static_assert(TM >= 8 && kThreads % TM == 0, "frame tile");
  extern __shared__ __align__(16) float smem[];
  const int n = 1 << p.log2n, nfp = fft_pad(n), wave = p.pairs * nfp;
  float* const re0 = smem;               // ping-pong exchange: (re0, im0)
  float* const im0 = smem + wave;        // and (re1, im1), `pairs` FFTs
  float* const re1 = smem + 2 * wave;    // of nfp floats each
  float* const im1 = smem + 3 * wave;
  float* z = smem + 4 * wave;            // the (pre-emphasized) span
  float* mel = z + p.span;               // (TM, n_mels) mel energies, logs
  float* rowv = mel + TM * p.e.n_mels;   // (TM) floors (epilogue)
  float* en = rowv + TM;                 // (TM) frame energy

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.tiles;
  const int t0 = (blockIdx.x % p.tiles) * TM;
  const float* xb = p.x + static_cast<long long>(b) * p.N;
  stage_span(xb, p.N, static_cast<long long>(t0) * p.hop, p.span, p.preemph,
             z);
  __syncthreads();

  // ---- unwindowed frame energy: G threads per frame, shuffle sum ----
  {
    constexpr int G = kThreads / TM;
    const int m = tid / G, l = tid % G;
    const float* zm = z + m * p.hop;
    float se = 0.0f;
    for (int k = l; k < p.frame_len; k += G) se = fmaf(zm[k], zm[k], se);
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      se += __shfl_xor_sync(0xffffffffu, se, off);
    if (l == 0) en[m] = se;
  }

  const int half = n >> 1, nm = p.e.n_mels;
  for (int w0 = 0; w0 < TM / 2; w0 += p.pairs) {
    // ---- the FFT of frames 2q + i 2q+1 (q = w0 + f, windowed): the first
    // radix-8 pass reads the span, then radix-8 passes, then a radix-2 or
    // radix-4 pass where log2 n_fft % 3 != 0.  `odd` says whether the
    // spectrum ended in (re1, im1) ----
    fft_first_pass(z, p.win, p.frame_len, p.hop, w0, re0, im0, p.log2n,
                   p.pairs, nfp);
    __syncthreads();
    bool odd = false;
    int log2ns = 3;
    for (; log2ns + 3 <= p.log2n; log2ns += 3) {
      if (odd)
        fft_pass<8>(re1, im1, re0, im0, p.tw, p.log2n, log2ns, p.pairs, nfp);
      else
        fft_pass<8>(re0, im0, re1, im1, p.tw, p.log2n, log2ns, p.pairs, nfp);
      odd = !odd;
      __syncthreads();
    }
    if (log2ns < p.log2n) {
      float* sr = odd ? re1 : re0;
      float* si = odd ? im1 : im0;
      float* dr = odd ? re0 : re1;
      float* di = odd ? im0 : im1;
      if (p.log2n - log2ns == 1)
        fft_pass<2>(sr, si, dr, di, p.tw, p.log2n, log2ns, p.pairs, nfp);
      else
        fft_pass<4>(sr, si, dr, di, p.tw, p.log2n, log2ns, p.pairs, nfp);
      odd = !odd;
      __syncthreads();
    }

    // ---- split the two real spectra: |X_a[k]|^2 -> re[k], |X_b[k]|^2 ->
    // im[k], k = 0..N/2 ----
    float* zr = odd ? re1 : re0;
    float* zi = odd ? im1 : im0;
    for (int i = tid; i < p.pairs * (half + 1); i += kThreads) {
      const int f = i / (half + 1), k = i - f * (half + 1);
      const int pk = f * nfp + fft_pad(k);
      const int pn = f * nfp + fft_pad((n - k) & (n - 1));
      const float a = zr[pk], bi = zi[pk], c = zr[pn], d = zi[pn];
      const float xr = 0.5f * (a + c), xi = 0.5f * (bi - d);
      const float yr = 0.5f * (bi + d), yi = 0.5f * (c - a);
      zr[pk] = xr * xr + xi * xi;
      zi[pk] = yr * yr + yi * yi;
    }
    __syncthreads();

    // ---- sparse mel: chunk sums over ascending bins, then band sums of
    // the chunks in order (part: the free exchange buffer) ----
    float* part = odd ? re0 : re1;
    const int nch = p.n_chunks;
    for (int o = tid; o < 2 * p.pairs * nch; o += kThreads) {
      const int mm = o / nch, c = o - mm * nch;
      const float* pw = ((mm & 1) ? zi : zr) + (mm >> 1) * nfp;
      const int2 ch = __ldg(p.chunks + c);
      float w[kMelChunk];
#pragma unroll
      for (int v = 0; v < kMelChunk / 4; ++v) {
        const float4 w4 = __ldg(p.chunk_w + c * (kMelChunk / 4) + v);
        w[4 * v] = w4.x;
        w[4 * v + 1] = w4.y;
        w[4 * v + 2] = w4.z;
        w[4 * v + 3] = w4.w;
      }
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < kMelChunk; ++i)
        if (ch.x + i < ch.y) acc = fmaf(pw[fft_pad(ch.x + i)], w[i], acc);
      part[o] = acc;
    }
    __syncthreads();
    for (int o = tid; o < 2 * p.pairs * nm; o += kThreads) {
      const int mm = o / nm, j = o - mm * nm;
      const int2 bc = __ldg(p.band_chunks + j);
      float acc = 0.0f;
      for (int c = bc.x; c < bc.y; ++c) acc += part[mm * nch + c];
      mel[(2 * w0 + mm) * nm + j] = acc;
    }
    __syncthreads();
  }
  finish<TM>(p.e, mel, rowv, en, b, t0);
}

// The FFT launch: the largest frame tile (TM = 64, 32, 16, 8) whose shared
// memory lets four blocks share an SM, else TM = 8 if it fits at all.
// `kernels[i]` is the kernel instantiated at TM = 64 >> i.
inline cudaError_t launch_fft(FftParams p, int B,
                              const KernelFn<FftParams> kernels[4],
                              cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int nfp = fft_pad(1 << p.log2n);
  int pick = -1;
  size_t bytes = 0;
  for (int i = 0; i < 4 && pick < 0; ++i) {
    const int TM = 64 >> i;
    int pairs = kWavePoints >> p.log2n;
    pairs = pairs < 1 ? 1 : (pairs > TM / 2 ? TM / 2 : pairs);
    const int span = ((TM - 1) * p.hop + p.frame_len + 3) / 4 * 4;
    bytes = fft_smem_bytes(TM, pairs, nfp, span, p.e.n_mels);
    if (bytes <= static_cast<size_t>(kFftSmemTarget) ||
        (i == 3 && bytes <= static_cast<size_t>(max_smem))) {
      pick = i;
      p.pairs = pairs;
      p.span = span;
      p.tiles = (p.e.T + TM - 1) / TM;
    }
  }
  if (pick < 0) return cudaErrorInvalidConfiguration;
  const void* fn = reinterpret_cast<const void*>(kernels[pick]);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(p.tiles) * B;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  void* args[] = {&p};
  err = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(blocks)),
                         dim3(kThreads), args, bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// What the C entries of fused_raw_dit.cu and fused_mfcc.cu take: the audio,
// the tile the host picked (fft != 0: the FFT tile), the constants of both
// tiles (those of the other tile are null), the epilogue and the shape.
struct SpectralArgs {
  const float* x;
  int B;
  long long N;
  const float* basis;  // direct tile: (nbb, frame_len, 512)
  int nbb;
  const float* last;   // direct tile: (frame_len, 2)
  const float* win;          // FFT tile: (frame_len)
  const float* tw;           // FFT tile: (n_fft, 2)
  const float* chunk_w;      // FFT tile: (n_chunks, kMelChunk)
  const int* chunks;         // FFT tile: (n_chunks, 2)
  const int* band_chunks;    // FFT tile: (n_mels, 2)
  int n_chunks;
  Epilogue e;                // melw: the direct tile's (n_bins, n_mels)
  int frame_len, hop, n_bins, n_fft, fft;
  float preemph;
};

// The tile the host picked: the FFT tile (refused on a shape it does not
// take) or the direct tile; the constants of the picked tile must be given.
inline cudaError_t launch_spectral(const SpectralArgs& a,
                                   const KernelFn<FftParams> fft_kernels[4],
                                   const KernelFn<DirectParams> direct[4],
                                   cudaStream_t stream) {
  if (a.B <= 0 || a.frame_len <= 0 || a.hop <= 0 ||
      a.n_bins != a.n_fft / 2 + 1 || !epilogue_ok(a.e))
    return cudaErrorInvalidValue;
  if (a.fft) {
    // the chunk sums of a wave must fit in one exchange buffer
    if (!fft_tile_ok(a.n_fft, a.frame_len) || a.win == nullptr ||
        a.tw == nullptr || a.chunk_w == nullptr || a.chunks == nullptr ||
        a.band_chunks == nullptr || a.n_chunks < 0 ||
        a.n_chunks > fft_pad(a.n_fft))
      return cudaErrorInvalidValue;
    int log2n = 0;
    while ((1 << log2n) < a.n_fft) ++log2n;
    const FftParams p{a.x, a.win, reinterpret_cast<const float2*>(a.tw),
                      reinterpret_cast<const float4*>(a.chunk_w),
                      reinterpret_cast<const int2*>(a.chunks),
                      reinterpret_cast<const int2*>(a.band_chunks), a.e, a.N,
                      0, a.frame_len, a.hop, log2n, 0, 0, a.n_chunks,
                      a.preemph};
    return launch_fft(p, a.B, fft_kernels, stream);
  }
  if (a.basis == nullptr || a.last == nullptr || a.e.melw == nullptr)
    return cudaErrorInvalidValue;
  const DirectParams p{a.x, a.basis, a.last, a.e, a.N, 0, a.nbb, a.frame_len,
                       a.hop, a.n_bins, 0, a.preemph};
  return launch_direct(p, a.B, direct, stream);
}

}  // namespace spectral
