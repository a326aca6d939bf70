// The shared-memory FFT tile of the four spectral kernels (fused_raw_dit.cu,
// fused_raw.cu, fused_mfcc.cu, fused_dit.cu), and the launch of it or of
// the direct tile of spectral.cuh.  One tile in two flavours, by its scalar
// type S; the host picks one from the config (_spectral.fft_tile) for a
// power-of-two n_fft from 64 to 4096 that holds the frame (fused_raw.cu
// also runs the float64 flavour at n_fft = 2^a 5^b: the mixed-radix tile,
// fft_mixed_features below):
// - float ("fft"), for cepstra and log-mel bounded to <= 50 dB, where the
//   floors bound the spectral valleys;
// - double ("fft64", the float64 front), for unbounded log-mel, PLP's bark
//   bands and the spectrogram (fused_raw_dit.cu's projections).  In valleys
//   120-140 dB under the peak (Hann or Povey windows) an f32 FFT carries
//   rounding of order eps32 x the frame's peak into every bin: 2.7-6x the
//   direct form's error, ~1e-2 off the float64 oracle.  With pre-emphasis,
//   window, twiddles, radix passes, split and |X|^2 in float64 the rounding
//   no longer scales with the peak; the stages after |X|^2 (mel, floors,
//   log) sum positive terms, whose f32 rounding is relative to each bin, so
//   they stay f32 and the accurate log stays bit for bit.  A numpy twin of
//   this data flow is within 2e-6 of the oracle on raw audio for Hamming,
//   Hann and Povey windows (tests/test_torch_kernels.py).
//
// What it computes: exactly what the direct tile computes, the (B, T,
// n_out) cepstra or log-mel energies of raw audio (pre-emphasis in the
// kernel) or of audio the host pre-emphasized, by a radix FFT instead of a
// dense DFT; in fused_raw_dit.cu also PLP's log bark energies (the same
// sparse band sums over the bark + equal-loudness filterbank: ~1,000
// nonzeros at 16 kHz against the mel matrix's ~500) and the log
// spectrogram (no band stage: each bin's floored log goes from the split
// straight to the output, in natural bin order).
//
// What bounds the function on the card (64 x 10 s batches, 67 TFLOP/s
// fp32, 3.35 TB/s HBM): at 16 kHz MFCC-13 the audio in and features out
// are 44.3 MB, 13.2 us of HBM time, and its ~16 kflop a frame of FFT, mel,
// log and DCT are 1.0 GFLOP, ~15 us: bytes and operations about equally.
// At 44.1 kHz (n_fft 2048) the bytes are 34.7 us and the operations (~64
// kflop a frame, 4.1 GFLOP) 61 us: operations bound.  Unbounded log-mel-80
// at 16 kHz (fused_raw) is 61.4 MB and 1.0 GFLOP (18.3 us, bytes), and at
// the 22.05 kHz TTS geometry (fused_dit, n_fft 1024) 74.0 MB and 1.7 GFLOP
// (25.9 us, operations).  The direct and DIT tiles these replace did
// frame_len x 512 FMAs a frame per 256-bin block (26.2, 28.8 and 288.3
// GFLOP) and half that per bin pair (62.1 GFLOP), 26-70x the function's
// operations, so no schedule of that form comes near the bound.  The f64
// flavour's radix passes (0.74 and 1.41 GFLOP at 16 kHz and TTS) run on
// the FP64 units at half the FP32 rate (~34 TFLOP/s non-tensor on the H100
// SXM, NVIDIA's data sheet: 22 and 41 us), and its complex points take 16
// bytes, so each pass moves twice the f32 tile's exchange bytes through
// shared memory; that exchange, not the FP64 rate, is what it pays for
// the precision.
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
//   ping-pong, in split re / im planes with one pad element per 32 floats
//   or 16 doubles (a double takes two four-byte banks), so that
//   power-of-two strides spread over the banks.  A block runs a "wave" of
//   FFT pairs at a time (FftFlavour::kWavePoints complex points in all), so
//   every pass has work for its threads while the tile's shared memory
//   lets FftFlavour::kBlocks blocks share an SM: f32 2048 points, four
//   blocks and 64 registers; f64 1024 points (16 KB a plane), three blocks
//   and 80 registers (a radix-8 butterfly holds 16 doubles).
// - Twiddles (cos, sin of 2 pi m / n_fft) and the window come from tables
//   the host builds in float64: rounded to float32 for the f32 flavour,
//   kept in float64 for the f64 one (rounded to f32 they would put an
//   eps32 x peak floor back into every bin).  No sincos, no fast math.
// - Pre-emphasis: the f32 flavour stages the pre-emphasized span in f32,
//   rounding as the plain version does; the f64 flavour stages the raw f32
//   samples (exact in float64) with one predecessor before the span, and
//   pre-emphasizes in float64 as it reads, with the config's coefficient
//   as a double.  Both take each sample's true predecessor (x[-1] := x[0]
//   at the row start).
// - |X|^2 of bins 0..N/2 lands in shared memory in natural order, rounded
//   to f32 (in place of the spectrum: the split at bin k reads bins k and
//   N-k and writes bin k only, so no two threads touch one word).  The mel
//   projection sums each band over its nonzero bin range [lo_j, hi_j) only
//   (the skipped terms are exact zeros), cut into chunks of at most 16
//   bins so that a wide band (240 bins at 44.1 kHz) does not hold the
//   block: one thread per (frame, chunk) loads the chunk's 16 weights as
//   four float4 and sums its bins in ascending order in f32, then one per
//   (frame, band) adds the band's chunk sums in order.  The chunk sums
//   live in the exchange buffer the spectrum does not occupy.
// - The unwindowed frame energy (in S) and the epilogue (floors, accurate
//   log, DCT or log-mel) are those of the direct tile (spectral.cuh).
// - The spectrogram (bark and mel share the path above) stages no band
//   energies: the split rounds each |X|^2 to f32 and writes its floored
//   accurate log to the output, n_fft/2 + 1 consecutive floats a frame,
//   so a block's stores coalesce and the frame tile is not cut for an
//   (TM, n_bins) buffer.  The frame energy, which nothing reads there, is
//   skipped.  (Staging (TM, n_bins) and running finish() is the other
//   epilogue, TM 16 at 16 kHz; ablate_fft_tile.py times it as
//   "spec_staged": 18-20 % slower on the H100.)  The spectrogram is a
//   compile-time flavour of the tile (Spec), which only fused_raw_dit.cu
//   instantiates: decided at run time, its branches cost the mel paths
//   2-4 % on the H100 (ablate_fft_tile.py's "mel_runtime_branch").
// - The frame tile TM (64, 32, 16 or 8 frames of one row) is the largest
//   whose shared memory lets kBlocks blocks share an SM; a frame past the
//   row's last is computed from what the span holds and not written,
//   which also gives the last frame of an odd count its partner.

#pragma once

#include "spectral.cuh"

namespace spectral {

constexpr int kFftMin = 64, kFftMax = 4096;  // n_fft range of the FFT tile
constexpr int kMelChunk = 16;                // bins per mel chunk

// The tile a C entry runs (the host passes it as an int): the entry's other
// tile (the direct tile; fused_dit.cu's DIT tile), or a flavour of the FFT
// tile (kFft64MixedTile: the float64 front at n_fft = 2^a 5^b, b >= 1, in
// fused_raw.cu alone).
enum Tile { kOtherTile = 0, kFftTile = 1, kFft64Tile = 2, kFft64MixedTile = 3 };

// Each flavour's layout.  kWavePoints: complex points per wave;
// kPadShift: one pad element after every 2^kPadShift; kRadix: the radix of
// the passes; kSpanLead: samples staged before the span; kBlocks: blocks
// per SM, which sets the shared-memory target and (through the kernels'
// __launch_bounds__) the register budget.
template <typename S>
struct FftFlavour;

template <>
struct FftFlavour<float> {
  using C = float2;
  static constexpr int kWavePoints = 2048;
  static constexpr int kPadShift = 5;
  static constexpr int kRadix = 8;
  static constexpr int kSpanLead = 0;
  static constexpr int kBlocks = 4;
  static constexpr float kSqrtHalf = 0x1.6a09e6p-1f;  // rounded to float32
};

template <>
struct FftFlavour<double> {
  using C = double2;
  static constexpr int kWavePoints = 1024;
  static constexpr int kPadShift = 4;
  static constexpr int kRadix = 8;
  static constexpr int kSpanLead = 1;
  static constexpr int kBlocks = 3;
  static constexpr double kSqrtHalf = 0x1.6a09e667f3bcdp-1;
};

// The shared memory one block may take so that kBlocks blocks share an
// SM's 228 KB (each block also holds 1 KB of the system's): 55 KB for
// four, 74 KB for three, 112 KB for two.
template <typename S>
constexpr size_t fft_smem_target() {
  return static_cast<size_t>(228 / FftFlavour<S>::kBlocks - 2) * 1024;
}

template <typename S>
__host__ __device__ __forceinline__ int fft_pad(int i) {
  return i + (i >> FftFlavour<S>::kPadShift);
}

// The shapes the tile takes (the host wrapper asks for it only on these).
inline bool fft_tile_ok(int n_fft, int frame_len) {
  return n_fft >= kFftMin && n_fft <= kFftMax && (n_fft & (n_fft - 1)) == 0 &&
         frame_len >= 1 && frame_len <= n_fft;
}

template <typename S>
struct FftParams {
  const float* x;            // (B, N) audio
  const S* win;              // (frame_len) window
  const typename FftFlavour<S>::C* tw;  // (n_fft) cos, sin of 2 pi m / n_fft
  const float4* chunk_w;     // (n_chunks, kMelChunk) weights, zero-padded
  const int2* chunks;        // (n_chunks) bins [k0, k1)
  const int2* band_chunks;   // (n_mels) chunks [c0, c1) of band j
  Epilogue e;
  long long N;
  int tiles, frame_len, hop, log2n, pairs, span, n_chunks;
  S preemph;           // 0: the host pre-emphasized (or the config has none)
};

// The mixed tile's parameters: the float64 flavour's (log2n unused), its
// plan, the radix of each pass over n points in order (mixed_plan), and
// where each row turns to zeros the host wrote (zero_tail; lengths null:
// every frame is computed).
constexpr int kMixedMaxPasses = 8;
struct FftMixedParams {
  FftParams<double> f;
  int n, passes;
  int radix[kMixedMaxPasses];
  const long long* lengths;   // (B) each row's own samples, or null
  long long len_offset, len_chunk;
};

// The sample of a row of n from which every sample is a zero the host wrote
// (framing.stft_center_batch's layout): the row's own `length` samples,
// cut to `chunk`, begin at `offset`, and zeros follow them up to a right
// reflect pad of n - offset - chunk samples.  Where that pad reflects a
// sample of the row (length past chunk - 1 - pad), no sample is known:
// -> n.  _spectral.zero_tail is its twin.
__host__ __device__ inline long long zero_tail(long long length,
                                               long long offset,
                                               long long chunk, long long n) {
  const long long pad = n - offset - chunk;
  if (length < 0) length = 0;
  if (pad > 0 && length > chunk - 1 - pad) return n;
  return offset + (length < chunk ? length : chunk);
}

// The float64 flavour's parameters for its kernels in the Guard mode of
// finish (fused_raw.cu's, for NeMo's log(e + guard)): a type of their own,
// so that those kernels are overloads beside the others, which stay as
// they were.
struct FftGuardParams {
  FftParams<double> f;
};

// The FFT tile's own parameters inside a kernel's.
inline FftParams<float>& fft_params(FftParams<float>& p) { return p; }
inline FftParams<double>& fft_params(FftParams<double>& p) { return p; }
inline FftParams<double>& fft_params(FftMixedParams& q) { return q.f; }
inline FftParams<double>& fft_params(FftGuardParams& q) { return q.f; }

__device__ __forceinline__ float fma_s(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_s(double a, double b, double c) {
  return fma(a, b, c);
}

// z[i] = x[s0 + i] for i = -1 .. span-1, zero past the row, where x[-1] is
// x[0] (the f64 flavour's span: raw samples and the first one's
// predecessor).
__device__ __forceinline__ void stage_raw_span(const float* xb, long long N,
                                               long long s0, int span,
                                               float* z) {
  for (int i = static_cast<int>(threadIdx.x) - 1; i < span; i += kThreads) {
    const long long g = s0 + i;
    z[i] = g < N ? xb[g > 0 ? g : 0] : 0.0f;
  }
}

// Sample s of a staged span in S: as staged (f32: pre-emphasized there),
// or pre-emphasized here in float64 from the raw samples (f64).
template <typename S>
__device__ __forceinline__ S span_sample(const float* z, int s, S preemph) {
  if constexpr (FftFlavour<S>::kSpanLead != 0)
    return static_cast<S>(z[s]) - preemph * static_cast<S>(z[s - 1]);
  else
    return z[s];
}

// Forward DFTs of 2, 4 and 8 points held in registers, natural order.
template <typename S>
__device__ __forceinline__ void dft4(S& r0, S& i0, S& r1, S& i1, S& r2, S& i2,
                                     S& r3, S& i3) {
  const S t0r = r0 + r2, t0i = i0 + i2, t1r = r0 - r2, t1i = i0 - i2;
  const S t2r = r1 + r3, t2i = i1 + i3, t3r = r1 - r3, t3i = i1 - i3;
  r0 = t0r + t2r;
  i0 = t0i + t2i;
  r2 = t0r - t2r;
  i2 = t0i - t2i;
  r1 = t1r + t3i;  // t1 - i t3
  i1 = t1i - t3r;
  r3 = t1r - t3i;  // t1 + i t3
  i3 = t1i + t3r;
}

// cos and sin of 2 pi / 5 and 4 pi / 5, correctly rounded to float64 (the
// mixed tile's 5-point DFT)
constexpr double kCos5a = 0x1.3c6ef372fe950p-2, kCos5b = -0x1.9e3779b97f4a8p-1;
constexpr double kSin5a = 0x1.e6f0e134454ffp-1, kSin5b = 0x1.2cf2304755a5ep-1;

template <int R, typename S>
__device__ __forceinline__ void dft(S (&re)[R], S (&im)[R]) {
  if constexpr (R == 2) {
    const S ar = re[0] + re[1], ai = im[0] + im[1];
    re[1] = re[0] - re[1];
    im[1] = im[0] - im[1];
    re[0] = ar;
    im[0] = ai;
  } else if constexpr (R == 4) {
    dft4(re[0], im[0], re[1], im[1], re[2], im[2], re[3], im[3]);
  } else if constexpr (R == 5) {
    // the pairs (1, 4) and (2, 3): a = x_p + x_5-p, b = x_p - x_5-p;
    // X1, X4 = m1 -+ i t1 and X2, X3 = m2 -+ i t2
    const S c1 = kCos5a, c2 = kCos5b, s1 = kSin5a, s2 = kSin5b;
    const S a1r = re[1] + re[4], a1i = im[1] + im[4];
    const S b1r = re[1] - re[4], b1i = im[1] - im[4];
    const S a2r = re[2] + re[3], a2i = im[2] + im[3];
    const S b2r = re[2] - re[3], b2i = im[2] - im[3];
    const S m1r = re[0] + c1 * a1r + c2 * a2r, m1i = im[0] + c1 * a1i + c2 * a2i;
    const S m2r = re[0] + c2 * a1r + c1 * a2r, m2i = im[0] + c2 * a1i + c1 * a2i;
    const S t1r = s1 * b1r + s2 * b2r, t1i = s1 * b1i + s2 * b2i;
    const S t2r = s2 * b1r - s1 * b2r, t2i = s2 * b1i - s1 * b2i;
    re[0] = re[0] + a1r + a2r;
    im[0] = im[0] + a1i + a2i;
    re[1] = m1r + t1i;  // m - i t
    im[1] = m1i - t1r;
    re[4] = m1r - t1i;  // m + i t
    im[4] = m1i + t1r;
    re[2] = m2r + t2i;
    im[2] = m2i - t2r;
    re[3] = m2r - t2i;
    im[3] = m2i + t2r;
  } else {
    static_assert(R == 8, "radix");
    const S h = FftFlavour<S>::kSqrtHalf;
    dft4(re[0], im[0], re[2], im[2], re[4], im[4], re[6], im[6]);  // E
    dft4(re[1], im[1], re[3], im[3], re[5], im[5], re[7], im[7]);  // O
    // O[q] *= W8^q, W8 = exp(-2 pi i / 8)
    const S o1r = h * (re[3] + im[3]), o1i = h * (im[3] - re[3]);
    const S o2r = im[5], o2i = -re[5];
    const S o3r = h * (im[7] - re[7]), o3i = -h * (re[7] + im[7]);
    const S o0r = re[1], o0i = im[1];
    const S e0r = re[0], e0i = im[0], e1r = re[2], e1i = im[2];
    const S e2r = re[4], e2i = im[4], e3r = re[6], e3i = im[6];
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
}

__host__ __device__ constexpr int log2_radix(int R) {
  return R == 8 ? 3 : R == 4 ? 2 : 1;
}

// The mixed tile's plan of n = 2^a 5^b (b >= 1): the power-of-two part in
// radix-kMixedPow2Radix passes, then one radix-2 or radix-4 pass for what
// is left of it, and the b radix-5 passes after those; the first pass
// reads the span.  false for any other n.  _spectral.fft_radices is its
// mirror.
constexpr int kMixedPow2Radix = 4;
// complex points a wave of the mixed tile (the float64 flavour's
// FftFlavour::kWavePoints is 1024): at 400 points four FFTs, TM 16
constexpr int kMixedWavePoints = 2048;

inline bool mixed_plan(int n, FftMixedParams& q) {
  int a = 0, b = 0, m = n;
  for (; m > 1 && m % 2 == 0; m /= 2) ++a;
  for (; m > 1 && m % 5 == 0; m /= 5) ++b;
  if (m != 1 || b == 0) return false;
  int pow2[kMixedMaxPasses], np2 = 0;
  constexpr int lr = log2_radix(kMixedPow2Radix);
  for (; a >= lr; a -= lr) pow2[np2++] = kMixedPow2Radix;
  if (a > 0) pow2[np2++] = 1 << a;
  if (np2 + b > kMixedMaxPasses) return false;
  q.n = n;
  q.passes = 0;
  for (int i = 0; i < np2; ++i) q.radix[q.passes++] = pow2[i];
  for (int i = 0; i < b; ++i) q.radix[q.passes++] = 5;
  return true;
}

// One Stockham radix-R pass over `pairs` FFTs of 2^log2n points, from
// (sr, si) to (dr, di); ns = 2^log2ns is the length of the sub-transforms
// already done.  Butterfly j of an FFT reads points j + r n/R, multiplies
// point r by W^(k r) (k = j mod ns, W = exp(-2 pi i / (ns R))), takes the
// R-point DFT and writes point q to (j - k) R + k + q ns.
template <int R, typename S>
__device__ __forceinline__ void fft_pass(const S* sr, const S* si, S* dr,
                                         S* di,
                                         const typename FftFlavour<S>::C* tw,
                                         int log2n, int log2ns, int pairs,
                                         int nfp) {
  constexpr int LR = log2_radix(R);
  const int lq = log2n - LR, nq = 1 << lq, ns = 1 << log2ns;
  const int tws = log2n - log2ns - LR;  // table stride n / (ns R)
  for (int u = threadIdx.x; u < (pairs << lq); u += kThreads) {
    const int f = u >> lq, j = u & (nq - 1), k = j & (ns - 1);
    const S* xr = sr + f * nfp;
    const S* xi = si + f * nfp;
    S vr[R], vi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int idx = fft_pad<S>(j + r * nq);
      vr[r] = xr[idx];
      vi[r] = xi[idx];
    }
    if (k != 0) {
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const auto w = __ldg(tw + ((k * r) << tws));  // (cos, sin)
        const S a = vr[r], b = vi[r];
        vr[r] = a * w.x + b * w.y;  // (a + i b)(cos - i sin)
        vi[r] = b * w.x - a * w.y;
      }
    }
    dft<R>(vr, vi);
    S* yr = dr + f * nfp;
    S* yi = di + f * nfp;
    const int base = ((j - k) << LR) + k;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int idx = fft_pad<S>(base + r * ns);
      yr[idx] = vr[r];
      yi[idx] = vi[r];
    }
  }
}

// The first radix-R pass (ns = 1, no twiddles), its inputs read straight
// from the span: point s of pair f is w[s] (z_a[s] + i z_b[s]) for the
// frames a = 2 (q0 + f) and b = a + 1, zero past the frame.
template <int R, typename S>
__device__ __forceinline__ void fft_first_pass(const float* z, const S* win,
                                               int frame_len, int hop,
                                               int q0, S preemph, S* dr,
                                               S* di, int log2n, int pairs,
                                               int nfp) {
  constexpr int LR = log2_radix(R);
  const int lq = log2n - LR, nq = 1 << lq;
  for (int u = threadIdx.x; u < (pairs << lq); u += kThreads) {
    const int f = u >> lq, j = u & (nq - 1);
    const float* za = z + 2 * (q0 + f) * hop;
    S vr[R], vi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = j + r * nq;
      S a = 0, c = 0;
      if (s < frame_len) {
        const S w = __ldg(win + s);
        a = w * span_sample(za, s, preemph);
        c = w * span_sample(za + hop, s, preemph);
      }
      vr[r] = a;
      vi[r] = c;
    }
    dft<R>(vr, vi);
    S* yr = dr + f * nfp;
    S* yi = di + f * nfp;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int idx = fft_pad<S>(R * j + r);
      yr[idx] = vr[r];
      yi[idx] = vi[r];
    }
  }
}

// Shared-memory bytes of an FFT tile of TM frames: the four exchange
// planes, then in floats the span (with its lead), the (TM, staged) band
// energies (staged_width) and two (TM) vectors.
template <typename S>
inline size_t fft_smem_bytes(int TM, int pairs, int nfp, int span,
                             int staged) {
  return sizeof(S) * 4 * static_cast<size_t>(pairs) * nfp +
         sizeof(float) * (span + FftFlavour<S>::kSpanLead +
                          static_cast<size_t>(TM) * staged + 2 * TM);
}

template <int TM, typename S, bool Spec = false, bool Guard = false>
__device__ __forceinline__ void fft_features(const FftParams<S>& p) {
  static_assert(TM >= 8 && kThreads % TM == 0, "frame tile");
  constexpr int R = FftFlavour<S>::kRadix, LR = log2_radix(R);
  extern __shared__ __align__(16) float smem[];
  const int n = 1 << p.log2n, nfp = fft_pad<S>(n), wave = p.pairs * nfp;
  S* const re0 = reinterpret_cast<S*>(smem);  // ping-pong exchange: (re0,
  S* const im0 = re0 + wave;                  // im0) and (re1, im1),
  S* const re1 = re0 + 2 * wave;              // `pairs` FFTs of nfp
  S* const im1 = re0 + 3 * wave;              // elements each
  // the span: pre-emphasized (f32), or raw after its lead sample (f64)
  float* z = reinterpret_cast<float*>(re0 + 4 * wave) +
             FftFlavour<S>::kSpanLead;
  float* mel = z + p.span;               // (TM, n_mels) mel energies, logs
  float* rowv = mel + TM * staged_width(p.e);  // (TM) floors (epilogue)
  float* en = rowv + TM;                 // (TM) frame energy
  constexpr bool spec = Spec;  // the spectrogram: no band stage

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.tiles;
  const int t0 = (blockIdx.x % p.tiles) * TM;
  const float* xb = p.x + static_cast<long long>(b) * p.N;
  const long long s0 = static_cast<long long>(t0) * p.hop;
  if constexpr (FftFlavour<S>::kSpanLead != 0)
    stage_raw_span(xb, p.N, s0, p.span, z);
  else
    stage_span(xb, p.N, s0, p.span, p.preemph, z);
  __syncthreads();

  // ---- unwindowed frame energy: G threads per frame, shuffle sum (not
  // in the Guard mode, whose log-mel never reads it) ----
  if (!spec && !Guard) {
    constexpr int G = kThreads / TM;
    const int m = tid / G, l = tid % G;
    const float* zm = z + m * p.hop;
    S se = 0;
    for (int k = l; k < p.frame_len; k += G) {
      const S v = span_sample(zm, k, p.preemph);
      se = fma_s(v, v, se);
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      se += __shfl_xor_sync(0xffffffffu, se, off);
    if (l == 0) en[m] = static_cast<float>(se);
  }

  const int half = n >> 1, nm = p.e.n_mels;
  for (int w0 = 0; w0 < TM / 2; w0 += p.pairs) {
    // ---- the FFT of frames 2q + i 2q+1 (q = w0 + f, windowed): the first
    // radix-R pass reads the span, then radix-R passes, then a radix-2 or
    // radix-4 pass where log2 n_fft is no multiple of log2 R.  `odd` says
    // whether the spectrum ended in (re1, im1) ----
    fft_first_pass<R>(z, p.win, p.frame_len, p.hop, w0, p.preemph, re0, im0,
                      p.log2n, p.pairs, nfp);
    __syncthreads();
    bool odd = false;
    int log2ns = LR;
    for (; log2ns + LR <= p.log2n; log2ns += LR) {
      if (odd)
        fft_pass<R>(re1, im1, re0, im0, p.tw, p.log2n, log2ns, p.pairs, nfp);
      else
        fft_pass<R>(re0, im0, re1, im1, p.tw, p.log2n, log2ns, p.pairs, nfp);
      odd = !odd;
      __syncthreads();
    }
    if (log2ns < p.log2n) {
      S* sr = odd ? re1 : re0;
      S* si = odd ? im1 : im0;
      S* dr = odd ? re0 : re1;
      S* di = odd ? im0 : im1;
      if (p.log2n - log2ns == 1)
        fft_pass<2>(sr, si, dr, di, p.tw, p.log2n, log2ns, p.pairs, nfp);
      else
        fft_pass<4>(sr, si, dr, di, p.tw, p.log2n, log2ns, p.pairs, nfp);
      odd = !odd;
      __syncthreads();
    }

    // ---- split the two real spectra: |X_a[k]|^2 -> re[k], |X_b[k]|^2 ->
    // im[k], k = 0..N/2, each rounded to f32 where the mel reads it (the
    // spectrogram: logged and written out instead) ----
    S* zr = odd ? re1 : re0;
    S* zi = odd ? im1 : im0;
    for (int i = tid; i < p.pairs * (half + 1); i += kThreads) {
      const int f = i / (half + 1), k = i - f * (half + 1);
      const int pk = f * nfp + fft_pad<S>(k);
      const int pn = f * nfp + fft_pad<S>((n - k) & (n - 1));
      const S a = zr[pk], bi = zi[pk], c = zr[pn], d = zi[pn];
      const S xr = S(0.5) * (a + c), xi = S(0.5) * (bi - d);
      const S yr = S(0.5) * (bi + d), yi = S(0.5) * (c - a);
      const float pa = static_cast<float>(xr * xr + xi * xi);
      const float pb = static_cast<float>(yr * yr + yi * yi);
      if (spec) {
        const int m = 2 * (w0 + f);
        spec_log(p.e, b, t0 + m, k, pa);
        spec_log(p.e, b, t0 + m + 1, k, pb);
      } else {
        zr[pk] = pa;
        zi[pk] = pb;
      }
    }
    __syncthreads();
    if (spec) continue;

    // ---- sparse mel in f32: chunk sums over ascending bins, then band
    // sums of the chunks in order (part: the free exchange buffers) ----
    float* part = reinterpret_cast<float*>(odd ? re0 : re1);
    const int nch = p.n_chunks;
    for (int o = tid; o < 2 * p.pairs * nch; o += kThreads) {
      const int mm = o / nch, c = o - mm * nch;
      const S* pw = ((mm & 1) ? zi : zr) + (mm >> 1) * nfp;
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
        if (ch.x + i < ch.y)
          acc = fmaf(static_cast<float>(pw[fft_pad<S>(ch.x + i)]), w[i], acc);
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
  if (spec) return;  // the split wrote the spectrogram
  finish<TM, Guard>(p.e, mel, rowv, en, b, t0);
}

// ---------------------------------------------------------------------------
// The mixed-radix tile: the float64-front flavour at n_fft = 2^a 5^b (b >=
// 1), which only fused_raw.cu instantiates (raw_fft_kernel<TM> on
// FftMixedParams; every power-of-two instantiation above is untouched).
// It replaces the direct tile for Whisper's n_fft of 400 = 2^4 5^2
// (models/whisper: the periodic Hann window, the Hz-triangle bank, no
// pre-emphasis), where the direct tile did 400 x 512 FMAs a frame, 31x the
// front end's least operations.
//
// What bounds it on the card: at Whisper's cell batch (256 rows x 3,000
// frames, 128 mels) the least work is the int16 samples and the features,
// 0.50 GB: 0.1485 ms at 3.35 TB/s; the operations of the frames that read
// a sample, 4.3 GFLOP, are 0.065 ms at 67 TFLOP/s.  Bytes.  The kernel
// itself reads the float32 rows the host padded (its 884 MB are 0.264 ms).
//
// What the design does about it: the data flow of fft_features, with the
// passes a plan of radix-5 and radix-2/4/8 Stockham passes (mixed_plan):
// each span is read once into shared memory and each feature written
// once, and between them the transform stays on chip, ~3 blocks an SM.
// - The pass over n points that are no power of two indexes by division:
//   butterfly j of an FFT is j = u mod n/R, k = j mod ns; the twiddle of
//   point r is table entry k r n / (ns R), below n since k < ns and r < R
//   (no shift, no mask); the 5-point DFT holds its points in registers.
// - The split's partner of bin k is bin n - k, and bin 0 its own.
// - The frame energy, which only a cepstral c0 reads, is computed only
//   where the epilogue appends it (Whisper's log-mel never does).
// - The plan and the wave: 4 4 5 5 at 400 points (the first pass reads
//   the span), 2-4 % ahead of 8 2 5 5 and 7 % of 5 5 4 4 on the H100; a
//   wave of kMixedWavePoints, four FFTs of 400 points, so that every pass
//   has work for the block's threads (320-400 butterflies), at TM 16
//   (~72 KB, three blocks an SM): 6 % ahead of two FFTs at TM 32, and 13-
//   19 % of two blocks an SM at TM 64 (tools/ablate_fft_tile.py).  The
//   pairs are a power of two, as launch_fft takes them.
// - Whisper pads every row to 30 s: in the cell 57.6 % of the frames read
//   only the zeros past a row's end, whose transform is known.  Given the
//   rows' lengths (FftMixedParams::lengths), a tile that stages nothing
//   but such zeros (zero_tail) writes the floored log of zero band
//   energies through the same epilogue, with no staging and no transform:
//   the bits the transform gives.  A tile that straddles a row's end
//   computes every frame, as without lengths.
// ---------------------------------------------------------------------------

// One Stockham radix-R pass of the mixed tile over `pairs` FFTs of n
// points, ns the length of the sub-transforms done (fft_pass's data flow
// with n = R nq any multiple of R).
template <int R>
__device__ __forceinline__ void mixed_pass(const double* sr, const double* si,
                                           double* dr, double* di,
                                           const double2* tw, int n, int ns,
                                           int pairs, int nfp) {
  const int nq = n / R, step = n / (ns * R);
  for (int u = threadIdx.x; u < pairs * nq; u += kThreads) {
    const int f = u / nq, j = u - f * nq, k = j % ns;
    const double* xr = sr + f * nfp;
    const double* xi = si + f * nfp;
    double vr[R], vi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int idx = fft_pad<double>(j + r * nq);
      vr[r] = xr[idx];
      vi[r] = xi[idx];
    }
    if (k != 0) {
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const double2 w = __ldg(tw + k * r * step);  // (cos, sin)
        const double a = vr[r], c = vi[r];
        vr[r] = a * w.x + c * w.y;  // (a + i c)(cos - i sin)
        vi[r] = c * w.x - a * w.y;
      }
    }
    dft<R>(vr, vi);
    double* yr = dr + f * nfp;
    double* yi = di + f * nfp;
    const int base = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int idx = fft_pad<double>(base + r * ns);
      yr[idx] = vr[r];
      yi[idx] = vi[r];
    }
  }
}

// The mixed tile's first pass (ns = 1, no twiddles) from the span:
// fft_first_pass's data flow over n = R nq points.
template <int R>
__device__ __forceinline__ void mixed_first_pass(const float* z,
                                                 const double* win,
                                                 int frame_len, int hop,
                                                 int q0, double preemph,
                                                 double* dr, double* di,
                                                 int n, int pairs, int nfp) {
  const int nq = n / R;
  for (int u = threadIdx.x; u < pairs * nq; u += kThreads) {
    const int f = u / nq, j = u - f * nq;
    const float* za = z + 2 * (q0 + f) * hop;
    double vr[R], vi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = j + r * nq;
      double a = 0, c = 0;
      if (s < frame_len) {
        const double w = __ldg(win + s);
        a = w * span_sample(za, s, preemph);
        c = w * span_sample(za + hop, s, preemph);
      }
      vr[r] = a;
      vi[r] = c;
    }
    dft<R>(vr, vi);
    double* yr = dr + f * nfp;
    double* yi = di + f * nfp;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int idx = fft_pad<double>(R * j + r);
      yr[idx] = vr[r];
      yi[idx] = vi[r];
    }
  }
}

template <int TM>
__device__ __forceinline__ void fft_mixed_features(const FftMixedParams& q) {
  static_assert(TM >= 8 && kThreads % TM == 0, "frame tile");
  const FftParams<double>& p = q.f;
  extern __shared__ __align__(16) float smem[];
  const int n = q.n, nfp = fft_pad<double>(n), wave = p.pairs * nfp;
  double* const re0 = reinterpret_cast<double*>(smem);  // as fft_features
  double* const im0 = re0 + wave;
  double* const re1 = re0 + 2 * wave;
  double* const im1 = re0 + 3 * wave;
  float* z = reinterpret_cast<float*>(re0 + 4 * wave) + 1;  // raw, lead 1
  float* bands = z + p.span;                  // (TM, n_mels) energies, logs
  float* rowv = bands + TM * p.e.n_mels;      // (TM) floors (epilogue)
  float* en = rowv + TM;                      // (TM) frame energy

  const int tid = threadIdx.x, b = blockIdx.x / p.tiles;
  const int t0 = (blockIdx.x % p.tiles) * TM;
  const long long s0 = static_cast<long long>(t0) * p.hop;
  // ---- a tile whose every staged sample, from its first frame's
  // predecessor s0 - 1 on, is a zero the host wrote: its frames' band and
  // frame energies are exact zeros, as the transform gives them.  Both
  // paths end in one finish: an early return with a copy of its own
  // spilled and ran 1-2 % slower on the H100 ----
  if (q.lengths != nullptr &&
      s0 > zero_tail(__ldg(q.lengths + b), q.len_offset, q.len_chunk, p.N)) {
    for (int o = tid; o < TM * p.e.n_mels; o += kThreads) bands[o] = 0.0f;
    if (tid < TM) en[tid] = 0.0f;
    __syncthreads();
  } else {
    stage_raw_span(p.x + static_cast<long long>(b) * p.N, p.N, s0, p.span, z);
    __syncthreads();

    // ---- the unwindowed frame energy, where c0 reads it ----
    if (p.e.append_energy) {
      constexpr int G = kThreads / TM;
      const int m = tid / G, l = tid % G;
      double sum = 0;
      for (int k = l; k < p.frame_len; k += G) {
        const double v = span_sample(z + m * p.hop, k, p.preemph);
        sum = fma(v, v, sum);
      }
  #pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (l == 0) en[m] = static_cast<float>(sum);
    }

    const int half = n >> 1, nm = p.e.n_mels, nch = p.n_chunks;
    for (int w0 = 0; w0 < TM / 2; w0 += p.pairs) {
      // ---- the FFT of frames 2q + i 2q+1 (q = w0 + f, windowed): the plan's
      // passes in order, the first from the span into (re0, im0); `odd`
      // says whether the spectrum ended in (re1, im1) ----
      bool odd = false;
      for (int s = 0, ns = 1; s < q.passes; ns *= q.radix[s], ++s) {
        double* sr = odd ? re1 : re0;
        double* si = odd ? im1 : im0;
        double* dr = odd ? re0 : re1;
        double* di = odd ? im0 : im1;
        if (s == 0) {
          switch (q.radix[0]) {
            case 2: mixed_first_pass<2>(z, p.win, p.frame_len, p.hop, w0,
                                        p.preemph, re0, im0, n, p.pairs, nfp);
              break;
            case 4: mixed_first_pass<4>(z, p.win, p.frame_len, p.hop, w0,
                                        p.preemph, re0, im0, n, p.pairs, nfp);
              break;
            case 5: mixed_first_pass<5>(z, p.win, p.frame_len, p.hop, w0,
                                        p.preemph, re0, im0, n, p.pairs, nfp);
              break;
            default: mixed_first_pass<8>(z, p.win, p.frame_len, p.hop, w0,
                                         p.preemph, re0, im0, n, p.pairs, nfp);
          }
        } else {
          switch (q.radix[s]) {
            case 2: mixed_pass<2>(sr, si, dr, di, p.tw, n, ns, p.pairs, nfp);
              break;
            case 4: mixed_pass<4>(sr, si, dr, di, p.tw, n, ns, p.pairs, nfp);
              break;
            case 5: mixed_pass<5>(sr, si, dr, di, p.tw, n, ns, p.pairs, nfp);
              break;
            default: mixed_pass<8>(sr, si, dr, di, p.tw, n, ns, p.pairs, nfp);
          }
          odd = !odd;
        }
        __syncthreads();
      }

      // ---- split the two real spectra: |X_a[k]|^2 -> re[k], |X_b[k]|^2 ->
      // im[k], k = 0..n/2, rounded to f32; bin k's partner is n - k, bin
      // 0's itself ----
      double* zr = odd ? re1 : re0;
      double* zi = odd ? im1 : im0;
      for (int o = tid; o < p.pairs * (half + 1); o += kThreads) {
        const int f = o / (half + 1), k = o - f * (half + 1);
        const int pk = f * nfp + fft_pad<double>(k);
        const int pn = f * nfp + fft_pad<double>(k == 0 ? 0 : n - k);
        const double a = zr[pk], bi = zi[pk], c = zr[pn], d = zi[pn];
        const double xr = 0.5 * (a + c), xi = 0.5 * (bi - d);
        const double yr = 0.5 * (bi + d), yi = 0.5 * (c - a);
        zr[pk] = static_cast<float>(xr * xr + xi * xi);
        zi[pk] = static_cast<float>(yr * yr + yi * yi);
      }
      __syncthreads();

      // ---- sparse bands in f32, as fft_features sums them ----
      float* part = reinterpret_cast<float*>(odd ? re0 : re1);
      for (int o = tid; o < 2 * p.pairs * nch; o += kThreads) {
        const int mm = o / nch, c = o - mm * nch;
        const double* pw = ((mm & 1) ? zi : zr) + (mm >> 1) * nfp;
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
        float sum = 0.0f;
  #pragma unroll
        for (int i = 0; i < kMelChunk; ++i)
          if (ch.x + i < ch.y)
            sum = fmaf(static_cast<float>(pw[fft_pad<double>(ch.x + i)]), w[i],
                       sum);
        part[o] = sum;
      }
      __syncthreads();
      for (int o = tid; o < 2 * p.pairs * nm; o += kThreads) {
        const int mm = o / nm, j = o - mm * nm;
        const int2 bc = __ldg(p.band_chunks + j);
        float sum = 0.0f;
        for (int c = bc.x; c < bc.y; ++c) sum += part[mm * nch + c];
        bands[(2 * w0 + mm) * nm + j] = sum;
      }
      __syncthreads();
    }
  }
  finish<TM>(p.e, bands, rowv, en, b, t0);
}

// The FFT launch over n-point transforms, waves of at most wave_points
// complex points: the largest frame tile (TM = 64, 32, 16, 8) whose shared
// memory lets kBlocks blocks share an SM, else TM = 8 if it fits at all.
// `kernels[i]` is the kernel instantiated at TM = 64 >> i, on parameters P
// (FftParams<S>, or FftMixedParams).
template <typename S, typename P>
inline cudaError_t launch_fft(P params, int n, int wave_points, int B,
                              const KernelFn<P> kernels[4],
                              cudaStream_t stream) {
  FftParams<S>& p = fft_params(params);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int nfp = fft_pad<S>(n);
  int pick = -1;
  size_t bytes = 0;
  // FFTs a wave: the most whose points fit wave_points, a power of two so
  // that the waves tile the TM / 2 pairs of a frame tile
  int wave_pairs = 1;
  while (4 * wave_pairs * n <= 2 * wave_points) wave_pairs *= 2;
  for (int i = 0; i < 4 && pick < 0; ++i) {
    const int TM = 64 >> i;
    const int pairs = wave_pairs > TM / 2 ? TM / 2 : wave_pairs;
    const int span = ((TM - 1) * p.hop + p.frame_len + 3) / 4 * 4;
    bytes = fft_smem_bytes<S>(TM, pairs, nfp, span, staged_width(p.e));
    if (bytes <= fft_smem_target<S>() ||
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
  void* args[] = {&params};
  err = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(blocks)),
                         dim3(kThreads), args, bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// What the C entries take: the audio, the tile the host picked (Tile), the
// constants of the entry's other tile and of the FFT tile (those of the
// tile not run are null), the epilogue and the shape.
struct SpectralArgs {
  const float* x;
  int B;
  long long N;
  const float* basis;  // direct tile: (nbb, frame_len, 512)
  int nbb;
  const float* last;   // direct tile: (frame_len, 2)
  const void* win;           // FFT tile: (frame_len) float, double (fft64)
  const void* tw;            // FFT tile: (n_fft, 2) float, double (fft64)
  const float* chunk_w;      // FFT tile: (n_chunks, kMelChunk); not spec
  const int* chunks;         // FFT tile: (n_chunks, 2); not spec
  const int* band_chunks;    // FFT tile: (n_mels, 2); not spec
  int n_chunks;
  Epilogue e;                // melw: the direct tile's (n_bins, n_mels)
  int frame_len, hop, n_bins, n_fft, tile;
  double preemph;            // 0 where the host pre-emphasized
  // the mixed tile: each row's own samples (null: all computed), where
  // they begin and the most of them (zero_tail)
  const long long* lengths = nullptr;
  long long len_offset = 0, len_chunk = 0;
  // 1: the additive log guard, log(e + log_floor) (finish's Guard mode),
  // on the float64 flavour's power-of-two tile alone; 0: the floors
  int log_guard = 0;
};

// The checks of launch_spectral and launch_fft_tile on the projection: the
// spectrogram writes n_bins logs a frame.
inline bool projection_ok(const SpectralArgs& a) {
  return a.e.projection != kSpecProjection || a.e.n_out == a.n_bins;
}

// The checks of every FFT tile on the arguments: the shape (n_fft's own
// rule aside), the constants (the band chunks, but for the spectrogram) and
// a chunk count whose sums fit in the free exchange buffers.
inline bool fft_args_ok(const SpectralArgs& a) {
  const bool bands = a.e.projection != kSpecProjection;
  return a.B > 0 && a.frame_len > 0 && a.hop > 0 &&
         a.n_bins == a.n_fft / 2 + 1 && epilogue_ok(a.e) && projection_ok(a) &&
         a.win != nullptr && a.tw != nullptr &&
         (!bands || (a.chunk_w != nullptr && a.chunks != nullptr &&
                     a.band_chunks != nullptr)) &&
         a.n_chunks >= 0 && a.n_chunks <= fft_pad<float>(a.n_fft);
}

// An FFT tile (kFftTile or kFft64Tile), refused on a shape it does not take
// or without its constants.  fft32[i] and fft64[i] are the entry's kernels
// of each flavour at TM = 64 >> i, spec32 and spec64 its spectrogram
// kernels (fft_features<TM, S, true>; null in an entry without the spec
// projection, which then refuses it).
inline cudaError_t launch_fft_tile(
    const SpectralArgs& a, const KernelFn<FftParams<float>> fft32[4],
    const KernelFn<FftParams<double>> fft64[4], cudaStream_t stream,
    const KernelFn<FftParams<float>>* spec32 = nullptr,
    const KernelFn<FftParams<double>>* spec64 = nullptr) {
  const bool bands = a.e.projection != kSpecProjection;
  if (!bands && (spec32 == nullptr || spec64 == nullptr))
    return cudaErrorInvalidValue;
  if (!fft_args_ok(a) || (a.tile != kFftTile && a.tile != kFft64Tile) ||
      !fft_tile_ok(a.n_fft, a.frame_len))
    return cudaErrorInvalidValue;
  int log2n = 0;
  while ((1 << log2n) < a.n_fft) ++log2n;
  const float4* chunk_w = reinterpret_cast<const float4*>(a.chunk_w);
  const int2* chunks = reinterpret_cast<const int2*>(a.chunks);
  const int2* band_chunks = reinterpret_cast<const int2*>(a.band_chunks);
  if (a.tile == kFftTile) {
    const FftParams<float> p{a.x, static_cast<const float*>(a.win),
                             static_cast<const float2*>(a.tw), chunk_w,
                             chunks, band_chunks, a.e, a.N, 0, a.frame_len,
                             a.hop, log2n, 0, 0, a.n_chunks,
                             static_cast<float>(a.preemph)};
    return launch_fft<float>(p, a.n_fft, FftFlavour<float>::kWavePoints, a.B,
                             bands ? fft32 : spec32, stream);
  }
  const FftParams<double> p{a.x, static_cast<const double*>(a.win),
                            static_cast<const double2*>(a.tw), chunk_w,
                            chunks, band_chunks, a.e, a.N, 0, a.frame_len,
                            a.hop, log2n, 0, 0, a.n_chunks, a.preemph};
  return launch_fft<double>(p, a.n_fft, FftFlavour<double>::kWavePoints, a.B,
                            bands ? fft64 : spec64, stream);
}

// The mixed tile (kFft64MixedTile) of an entry whose kernels at TM = 64 >> i
// are mixed[i] (null: the entry has none, and refuses it), on the band
// projections at an n_fft from kFftMin to kFftMax that mixed_plan takes;
// with the rows' lengths where given (a.lengths).
inline cudaError_t launch_fft_mixed(const SpectralArgs& a,
                                    const KernelFn<FftMixedParams>* mixed,
                                    cudaStream_t stream) {
  FftMixedParams q{};
  if (mixed == nullptr || !fft_args_ok(a) ||
      a.e.projection == kSpecProjection || a.n_fft < kFftMin ||
      a.n_fft > kFftMax || a.frame_len > a.n_fft || !mixed_plan(a.n_fft, q) ||
      (a.lengths != nullptr && (a.len_offset < 0 || a.len_chunk < 0)))
    return cudaErrorInvalidValue;
  q.f = FftParams<double>{
      a.x, static_cast<const double*>(a.win),
      static_cast<const double2*>(a.tw),
      reinterpret_cast<const float4*>(a.chunk_w),
      reinterpret_cast<const int2*>(a.chunks),
      reinterpret_cast<const int2*>(a.band_chunks), a.e, a.N, 0, a.frame_len,
      a.hop, 0, 0, 0, a.n_chunks, a.preemph};
  q.lengths = a.lengths;
  q.len_offset = a.len_offset;
  q.len_chunk = a.len_chunk;
  return launch_fft<double>(q, a.n_fft, kMixedWavePoints, a.B, mixed,
                            stream);
}

// The float64 flavour's power-of-two tile in finish's Guard mode, on an
// entry whose kernels at TM = 64 >> i are guarded[i] (null: the entry has
// none, and refuses it): log-mel on the mel projection, no relative floor,
// a positive guard.
inline cudaError_t launch_fft_guarded(const SpectralArgs& a,
                                      const KernelFn<FftGuardParams>* guarded,
                                      cudaStream_t stream) {
  if (guarded == nullptr || a.tile != kFft64Tile || !fft_args_ok(a) ||
      !fft_tile_ok(a.n_fft, a.frame_len) ||
      a.e.projection != kMelProjection || a.e.apply_dct ||
      a.e.rel_floor != 0.0f || !(a.e.log_floor > 0.0f))
    return cudaErrorInvalidValue;
  int log2n = 0;
  while ((1 << log2n) < a.n_fft) ++log2n;
  const FftGuardParams q{FftParams<double>{
      a.x, static_cast<const double*>(a.win),
      static_cast<const double2*>(a.tw),
      reinterpret_cast<const float4*>(a.chunk_w),
      reinterpret_cast<const int2*>(a.chunks),
      reinterpret_cast<const int2*>(a.band_chunks), a.e, a.N, 0, a.frame_len,
      a.hop, log2n, 0, 0, a.n_chunks, a.preemph}};
  return launch_fft<double>(q, a.n_fft, FftFlavour<double>::kWavePoints, a.B,
                            guarded, stream);
}

// The tile the host picked: a flavour of the FFT tile, or the direct tile
// (its constants must be given); with a.log_guard, the guarded float64
// tile (launch_fft_guarded).
inline cudaError_t launch_spectral(
    const SpectralArgs& a, const KernelFn<FftParams<float>> fft32[4],
    const KernelFn<FftParams<double>> fft64[4],
    const KernelFn<DirectParams> direct[4], cudaStream_t stream,
    const KernelFn<FftParams<float>>* spec32 = nullptr,
    const KernelFn<FftParams<double>>* spec64 = nullptr,
    const KernelFn<FftMixedParams>* mixed = nullptr,
    const KernelFn<FftGuardParams>* guarded = nullptr) {
  if (a.log_guard != 0) return launch_fft_guarded(a, guarded, stream);
  if (a.tile == kFft64MixedTile) return launch_fft_mixed(a, mixed, stream);
  if (a.tile != kOtherTile)
    return launch_fft_tile(a, fft32, fft64, stream, spec32, spec64);
  if (a.B <= 0 || a.frame_len <= 0 || a.hop <= 0 ||
      a.n_bins != a.n_fft / 2 + 1 || !epilogue_ok(a.e) ||
      !projection_ok(a) || a.basis == nullptr || a.last == nullptr ||
      (a.e.melw == nullptr && a.e.projection != kSpecProjection))
    return cudaErrorInvalidValue;
  const DirectParams p{a.x, a.basis, a.last, a.e, a.N, 0, a.nbb, a.frame_len,
                       a.hop, a.n_bins, 0, static_cast<float>(a.preemph)};
  return launch_direct(p, a.B, direct, stream);
}

}  // namespace spectral
