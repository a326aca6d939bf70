// Fused raw-audio spectral kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   mfcc_tpu/ops/kernels/fused_raw_dit.py::fused_features_raw_dit
// in its three projections: raw (B, N) float32 audio in; out (B, T, n_mfcc)
// cepstra or (B, T, n_mels) log-mel energies ("mel", apply_dct or not),
// (B, T, n_bark) floored-log bark + equal-loudness band energies ("bark",
// PLP's front half, no relative floor), or (B, T, n_bins) the floored log
// power spectrum in natural bin order ("spec").  One launch reads the
// audio once and writes the features once; pre-emphasis, window, DFT
// power, projection, floors, accurate log, lifter-folded DCT and the
// optional log-energy c0 all happen on chip.  The model layer sends it
// cepstra and log-mel bounded to <= 50 dB, as the reference does
// (models/mfcc.py), PLP (models/plp.py) and the log spectrogram
// (models/spectrogram.py).  The spectrogram writes 1.6x the bytes of its
// 16 kHz audio (257 floats a frame), so it is bound by its bytes: 107 MB
// for 64 x 10 s, 32 us at 3.35 TB/s.
//
// The TPU kernel's radix-2 DIT on the raw layout (parity deinterleave,
// lane-phase periods, roll+select assembly, packed bin permutation, LEAD
// rows) exists to feed the MXU GEMMs and does not carry over.  For a
// power-of-two n_fft from 64 to 4096 this kernel runs the shared-memory
// FFT tile of fft_tile.cuh (two real frames per complex FFT, radix-8
// Stockham passes, sparse mel).  At the 16 kHz MFCC-13 main path the
// function is bound by its bytes and its operations about equally (44 MB
// of audio and features, 13.2 us; ~16 kflop a frame, ~15 us at the fp32
// peak); the direct form did 26 times the operations, so the FFT tile
// decides how near the kernel comes (fft_tile.cuh says how it is laid
// out).  Unbounded log-mel at such an n_fft (which the model layer sends
// to fused_raw.cu, but a direct caller may ask for) runs the tile's
// float64-front flavour, as in every spectral entry.  Any other config (an
// odd n_fft or one that is no power of two) runs the direct window-folded
// DFT tile of spectral.cuh; the host picks the tile from the config, in
// the same C entry.
//
// Numerics: the accurate log and the f32 pre-emphasis round exactly as the
// plain PyTorch version does; the DFT (FFT or direct), projection and DCT
// sum in another order.  The tile flavour per projection is the host's
// (_spectral.fft_tile): bark and spec on the float64 front, whose |X|^2
// holds the oracle in the valleys an f32 FFT does not (PLP-13 1.8-2.7e-4
// off in Hann and Povey two-tone valleys through the f32 tile).

#include "fft_tile.cuh"

namespace {

template <int TM, typename S, bool Spec>
__global__ void __launch_bounds__(spectral::kThreads,
                                  spectral::FftFlavour<S>::kBlocks)
    raw_dit_fft_kernel(const spectral::FftParams<S> p) {
  spectral::fft_features<TM, S, Spec>(p);
}

template <int FR>
__global__ void __launch_bounds__(spectral::kThreads, 1)
    raw_dit_kernel(const spectral::DirectParams p) {
  spectral::direct_features<FR>(p);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 is
// success.  Launches on `stream` and does not synchronize.  tile is a
// spectral::Tile: kFftTile or kFft64Tile run that flavour of the FFT tile
// (win, tw, chunk_w, chunks, band_chunks given, win and tw in float or in
// double; basis, last and melw may be null), kOtherTile the direct tile
// (basis, last, melw given; the FFT tile's constants may be null).
// projection is a spectral::Projection: kMelProjection with melw and the
// FFT tile's chunks over the mel matrix, kBarkProjection with them over the
// bark matrix (n_mels = n_out = n_bark, no DCT, no relative floor), or
// kSpecProjection with no projection constants (n_mels = n_out = n_bins,
// no DCT); a projection other than mel with apply_dct set is refused.
extern "C" int mfcc_fused_raw_dit(
    const float* x, int B, long long N, int T, const float* basis, int nbb,
    const float* last, const float* melw, const void* win, const void* tw,
    const float* chunk_w, const int* chunks, const int* band_chunks,
    int n_chunks, const float* dctm, float* out, int frame_len, int hop,
    int n_bins, int n_fft, int tile, double preemph, int projection,
    int n_mels, int n_out, float log_floor, float rel_floor, int append_energy,
    int apply_dct, void* stream) {
  const spectral::Epilogue e{melw,      dctm,      out,
                             T,         n_mels,    n_out,
                             log_floor, rel_floor, apply_dct,
                             append_energy, projection};
  const spectral::SpectralArgs a{x, B, N, basis, nbb, last, win, tw, chunk_w,
                                 chunks, band_chunks, n_chunks, e, frame_len,
                                 hop, n_bins, n_fft, tile, preemph};
  // the FFT tile's kernels at TM = 64 >> i: band projections (mel, bark)
  // and the spectrogram, in each flavour
  using spectral::FftParams;
  using spectral::KernelFn;
  const KernelFn<FftParams<float>> fft32[4] = {
      raw_dit_fft_kernel<64, float, false>,
      raw_dit_fft_kernel<32, float, false>,
      raw_dit_fft_kernel<16, float, false>,
      raw_dit_fft_kernel<8, float, false>};
  const KernelFn<FftParams<double>> fft64[4] = {
      raw_dit_fft_kernel<64, double, false>,
      raw_dit_fft_kernel<32, double, false>,
      raw_dit_fft_kernel<16, double, false>,
      raw_dit_fft_kernel<8, double, false>};
  const KernelFn<FftParams<float>> spec32[4] = {
      raw_dit_fft_kernel<64, float, true>,
      raw_dit_fft_kernel<32, float, true>,
      raw_dit_fft_kernel<16, float, true>,
      raw_dit_fft_kernel<8, float, true>};
  const KernelFn<FftParams<double>> spec64[4] = {
      raw_dit_fft_kernel<64, double, true>,
      raw_dit_fft_kernel<32, double, true>,
      raw_dit_fft_kernel<16, double, true>,
      raw_dit_fft_kernel<8, double, true>};
  const spectral::KernelFn<spectral::DirectParams> direct_tiles[4] = {
      raw_dit_kernel<8>, raw_dit_kernel<4>, raw_dit_kernel<2>,
      raw_dit_kernel<1>};
  return spectral::launch_spectral(a, fft32, fft64, direct_tiles,
                                   static_cast<cudaStream_t>(stream), spec32,
                                   spec64);
}
