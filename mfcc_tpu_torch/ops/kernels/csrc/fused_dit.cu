// Fused spectral kernel for NVIDIA Hopper (sm_90a), pre-emphasized input:
// FFT tile or radix-2 DIT tile.
//
// Replaces the Pallas TPU kernel
//   mfcc_tpu/ops/kernels/fused_dit.py::fused_features_dit
// (B, N) float32 audio that the host has already pre-emphasized in,
// (B, T, n_mfcc) cepstra or (B, T, n_mels) log-mel energies out.  The model
// layer sends it the configs the raw kernels do not take whose n_fft is a
// multiple of 4 and whose hop is even (the 22.05 kHz TTS geometry, 16 kHz
// at a 12.5 ms hop).
//
// What bounds it on the card: at its main path, unbounded log-mel-80 at
// the TTS geometry (1024-sample frames, hop 256, n_fft 1024) on 64 x 10 s,
// the audio in and features out are 74.0 MB (22.1 us at 3.35 TB/s) and the
// function's operations 1.7 GFLOP (25.9 us at the 67 TFLOP/s fp32 peak):
// operations.  The DIT tile below did 62.1 GFLOP of fp32 FMAs, 36x that.
//
// What the design does about it: at a power-of-two n_fft from 64 to 4096
// (the TTS geometry's 1024) the entry runs the shared-memory FFT tile of
// fft_tile.cuh with pre-emphasis off, for unbounded log-mel in its
// float64-front flavour: window, twiddles, radix passes, split and |X|^2
// in float64 on the FP64 units (half the FP32 rate, ~34 TFLOP/s on the
// H100 SXM; 16-byte complex points, so twice the f32 tile's exchange bytes
// through shared memory), then the f32 mel and epilogue.  The DIT form's
// extra rounding stage in deep valleys (5.8e-5 to 1.8e-3 off the float64
// oracle at this geometry, reference and plain version alike) goes with
// it; what stays is the f32 rounding of the host's pre-emphasis (~4e-3 in
// Hann valleys, none on the kernel's own input).  Cepstra and log-mel
// <= 50 dB run the tile's f32 flavour.  Other configs with n_fft % 4 == 0
// run the radix-2 DIT tile below; the host picks the tile from the config,
// in the same C entry.
//
// The DIT tile: with E and O the window-folded n_fft/2-point real DFTs of
// a frame's even and odd samples and W = exp(-2 pi i / n_fft),
//     X[j]          = E[j] + W^j O[j]           j = 0 .. n_fft/4 - 1
//     X[n_fft/2 - j] = conj(E[j] - W^j O[j])
//     X[n_fft/4]    = E[n_fft/4] - i O[n_fft/4]  (both real: basis (-1)^m)
// so |X|^2 over all n_fft/2 + 1 bins takes 2 x (frame_len/2) x (n_fft/2)
// FMAs a frame, half the direct form's, bound by the fp32 FMA rate.
// A block of 256 threads owns TM = 8*FR
// frames of one row and 128 half-DFT bins.  The block stages its span once
// (no parity deinterleave on the host: the TPU kernel's even/odd streams
// are a DMA-layout need); threads read a frame's even and odd samples at
// stride 2 from shared memory as broadcasts.  Each thread keeps FR frames x
// 4 bins x (E, O) x (cos, sin) = 16*FR accumulators, reading per basis row
// four conflict-free float4 vectors [E cos | E sin | O cos | O sin].  The
// twiddle combine happens in registers: p_plus[j] is natural bin j,
// p_minus[j] is bin n_fft/2 - j (j = 0 is the Nyquist), and
// mid = e_last^2 + o_last^2 is bin n_fft/4.  The mel projection reads the
// plain mel matrix at those natural bins (the TPU kernel's M1/M2 folding is
// a GEMM-layout device), then the shared epilogue.  An odd frame_len gives
// uneven streams (even ceil(fl/2), odd floor(fl/2) samples); the odd basis
// rows past the stream are zero, as are all rows past the even stream, so
// the reads past a frame's end multiply by zero.

#include "fft_tile.cuh"

namespace {

using spectral::kChunk;
using spectral::kThreads;

constexpr int kHalf = 128;       // half-DFT bins per block
constexpr int kRow = 4 * kHalf;  // basis row: E cos | E sin | O cos | O sin

struct DitParams {
  const float* y;      // (B, N) pre-emphasized audio
  const float* basis;  // (nbb, le_pad, 512) window-folded half-DFT bases
  const float* last;   // (le_pad, 2) even / odd half-DFT bin n_fft/4
  const float* tw;     // (2, nb2) cos, sin of 2 pi j / n_fft
  spectral::Epilogue e;
  long long N;
  int tiles, nbb, le_pad, frame_len, hop, n_fft, span;
};

template <int FR>
__global__ void __launch_bounds__(kThreads, 1) dit_kernel(const DitParams p) {
  constexpr int TM = 8 * FR;
  static_assert(kChunk * kRow <= spectral::buf_floats(TM) &&
                TM * 2 * kHalf <= spectral::buf_floats(TM), "buffer");
  extern __shared__ __align__(16) float smem[];
  float* buf = smem;
  float* z = buf + spectral::buf_floats(TM);  // the span
  float* mel = z + p.span;                    // (TM, n_mels)
  float* rowv = mel + TM * p.e.n_mels;        // (TM) mid-bin power, floor
  float* en = rowv + TM;                      // (TM) frame energy

  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int b = blockIdx.x / p.tiles;
  const int t0 = (blockIdx.x % p.tiles) * TM;
  const float* yb = p.y + static_cast<long long>(b) * p.N;
  const int nb2 = p.n_fft / 4, half = p.n_fft / 2;

  spectral::stage_span(yb, p.N, static_cast<long long>(t0) * p.hop, p.span,
                       0.0f, z);
  for (int i = tid; i < TM * p.e.n_mels; i += kThreads) mel[i] = 0.0f;
  __syncthreads();

  for (int bb = 0; bb < p.nbb; ++bb) {
    float er[FR][4], ei[FR][4], o_r[FR][4], oi[FR][4];
#pragma unroll
    for (int i = 0; i < FR; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        er[i][q] = 0.0f;
        ei[i][q] = 0.0f;
        o_r[i][q] = 0.0f;
        oi[i][q] = 0.0f;
      }
    }
    const float* basis = p.basis + static_cast<long long>(bb) * p.le_pad * kRow;
    for (int k0 = 0; k0 < p.le_pad; k0 += kChunk) {
      float4* b4 = reinterpret_cast<float4*>(buf);
      for (int i = tid; i < kChunk * (kRow / 4); i += kThreads)
        b4[i] = __ldg(reinterpret_cast<const float4*>(
                          basis + static_cast<long long>(k0) * kRow) + i);
      __syncthreads();
      const float* zf = z + ty * FR * p.hop + 2 * k0;
#pragma unroll 4
      for (int kk = 0; kk < kChunk; ++kk) {
        float ae[FR], ao[FR];
#pragma unroll
        for (int i = 0; i < FR; ++i) {
          ae[i] = zf[i * p.hop + 2 * kk];
          ao[i] = zf[i * p.hop + 2 * kk + 1];
        }
        const float4* row = reinterpret_cast<const float4*>(buf + kk * kRow);
        const float4 ce4 = row[tx], se4 = row[32 + tx];
        const float4 co4 = row[64 + tx], so4 = row[96 + tx];
        const float ce[4] = {ce4.x, ce4.y, ce4.z, ce4.w};
        const float se[4] = {se4.x, se4.y, se4.z, se4.w};
        const float co[4] = {co4.x, co4.y, co4.z, co4.w};
        const float so[4] = {so4.x, so4.y, so4.z, so4.w};
#pragma unroll
        for (int i = 0; i < FR; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            er[i][q] = fmaf(ae[i], ce[q], er[i][q]);
            ei[i][q] = fmaf(ae[i], se[q], ei[i][q]);
            o_r[i][q] = fmaf(ao[i], co[q], o_r[i][q]);
            oi[i][q] = fmaf(ao[i], so[q], oi[i][q]);
          }
        }
      }
      __syncthreads();
    }

    // ---- twiddle combine in registers -> buf as (TM, 256):
    // cols 0..127 p_plus (bins j), cols 128..255 p_minus (bins half - j)
    const int j0 = bb * kHalf;
    float ct[4], st[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + 4 * tx + q;
      ct[q] = j < nb2 ? __ldg(p.tw + j) : 0.0f;
      st[q] = j < nb2 ? __ldg(p.tw + nb2 + j) : 0.0f;
    }
    float4* pw = reinterpret_cast<float4*>(buf);
#pragma unroll
    for (int i = 0; i < FR; ++i) {
      float pp[4], pm[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // B = W^j O[j] in the stored (sum x cos, sum x sin) convention
        const float b_re = ct[q] * o_r[i][q] - st[q] * oi[i][q];
        const float b_im = ct[q] * oi[i][q] + st[q] * o_r[i][q];
        const float ar = er[i][q] + b_re, ai = ei[i][q] + b_im;
        const float dr = er[i][q] - b_re, di = ei[i][q] - b_im;
        pp[q] = ar * ar + ai * ai;
        pm[q] = dr * dr + di * di;
      }
      const int m = ty * FR + i;
      pw[m * (2 * kHalf / 4) + tx] = make_float4(pp[0], pp[1], pp[2], pp[3]);
      pw[m * (2 * kHalf / 4) + 32 + tx] =
          make_float4(pm[0], pm[1], pm[2], pm[3]);
    }
    __syncthreads();

    // ---- mel projection at the natural bins, accumulated over blocks ----
    const int nb = min(kHalf, nb2 - j0);
    const int nm = p.e.n_mels;
    for (int o = tid; o < TM * nm; o += kThreads) {
      const int m = o / nm, j = o - m * nm;
      const float* pr = buf + m * 2 * kHalf;
      float acc = mel[o];
      for (int c = 0; c < nb; ++c)
        acc = fmaf(pr[c],
                   __ldg(p.e.melw + static_cast<long long>(j0 + c) * nm + j),
                   acc);
      for (int c = 0; c < nb; ++c)
        acc = fmaf(pr[kHalf + c],
                   __ldg(p.e.melw +
                         static_cast<long long>(half - j0 - c) * nm + j),
                   acc);
      mel[o] = acc;
    }
    __syncthreads();
  }

  // ---- mid bin n_fft/4 (both half-DFTs real there) and the unwindowed
  // frame energy: G threads per frame, then a shuffle reduction ----
  {
    constexpr int G = kThreads / TM;
    const int m = tid / G, l = tid % G;
    const float* zm = z + m * p.hop;
    float se_ = 0.0f, so_ = 0.0f, sq = 0.0f;
    for (int k = l; k < p.le_pad; k += G) {
      se_ = fmaf(zm[2 * k], __ldg(p.last + 2 * k), se_);
      so_ = fmaf(zm[2 * k + 1], __ldg(p.last + 2 * k + 1), so_);
    }
    for (int k = l; k < p.frame_len; k += G) sq = fmaf(zm[k], zm[k], sq);
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      se_ += __shfl_xor_sync(0xffffffffu, se_, off);
      so_ += __shfl_xor_sync(0xffffffffu, so_, off);
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    }
    if (l == 0) {
      rowv[m] = se_ * se_ + so_ * so_;
      en[m] = sq;
    }
  }
  __syncthreads();
  for (int o = tid; o < TM * p.e.n_mels; o += kThreads) {
    const int m = o / p.e.n_mels, j = o - m * p.e.n_mels;
    mel[o] = fmaf(rowv[m],
                  __ldg(p.e.melw + static_cast<long long>(nb2) * p.e.n_mels + j),
                  mel[o]);
  }
  __syncthreads();
  spectral::finish<TM>(p.e, mel, rowv, en, b, t0);
}

template <int TM, typename S>
__global__ void __launch_bounds__(kThreads, spectral::FftFlavour<S>::kBlocks)
    dit_fft_kernel(const spectral::FftParams<S> p) {
  spectral::fft_features<TM, S>(p);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 is
// success.  Launches on `stream` and does not synchronize.  tile is a
// spectral::Tile: kFftTile or kFft64Tile run that flavour of the FFT tile
// (win, tw, chunk_w, chunks, band_chunks given, win and tw in float or in
// double; basis, last, dtw and melw may be null), kOtherTile the DIT tile
// (basis, le_pad, last, dtw, melw given; the FFT tile's may be null).
extern "C" int mfcc_fused_dit(
    const float* y, int B, long long N, int T, const float* basis, int nbb,
    int le_pad, const float* last, const float* dtw, const float* melw,
    const void* win, const void* tw, const float* chunk_w, const int* chunks,
    const int* band_chunks, int n_chunks, const float* dctm, float* out,
    int frame_len, int hop, int n_bins, int n_fft, int tile, int n_mels,
    int n_out, float log_floor, float rel_floor, int append_energy,
    int apply_dct, void* stream) {
  const spectral::Epilogue e{melw, dctm, out, T, n_mels, n_out, log_floor,
                             rel_floor, apply_dct, append_energy};
  if (tile != spectral::kOtherTile) {
    const spectral::SpectralArgs a{y, B, N, nullptr, 0, nullptr, win, tw,
                                   chunk_w, chunks, band_chunks, n_chunks, e,
                                   frame_len, hop, n_bins, n_fft, tile, 0.0};
    const spectral::KernelFn<spectral::FftParams<float>> fft32[4] = {
        dit_fft_kernel<64, float>, dit_fft_kernel<32, float>,
        dit_fft_kernel<16, float>, dit_fft_kernel<8, float>};
    const spectral::KernelFn<spectral::FftParams<double>> fft64[4] = {
        dit_fft_kernel<64, double>, dit_fft_kernel<32, double>,
        dit_fft_kernel<16, double>, dit_fft_kernel<8, double>};
    return spectral::launch_fft_tile(a, fft32, fft64,
                                     static_cast<cudaStream_t>(stream));
  }
  if (B <= 0 || frame_len < 2 || hop <= 0 || n_fft % 4 != 0 ||
      nbb != (n_fft / 4 + kHalf - 1) / kHalf || le_pad % kChunk != 0 ||
      le_pad < (frame_len + 1) / 2 || basis == nullptr || last == nullptr ||
      dtw == nullptr || melw == nullptr || !spectral::epilogue_ok(e))
    return cudaErrorInvalidValue;
  const DitParams p{y, basis, last, dtw, e, N, 0, nbb, le_pad, frame_len,
                    hop, n_fft, 0};
  const spectral::KernelFn<DitParams> kernels[4] = {
      dit_kernel<8>, dit_kernel<4>, dit_kernel<2>, dit_kernel<1>};
  return spectral::launch_tiles<DitParams>(
      p, B, kernels,
      [hop, le_pad](int FR) {
        return ((8 * FR - 1) * hop + 2 * le_pad + 3) / 4 * 4;
      },
      static_cast<cudaStream_t>(stream));
}
