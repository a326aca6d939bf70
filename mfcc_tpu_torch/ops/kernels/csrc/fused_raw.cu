// Fused raw-audio spectral kernel for NVIDIA Hopper (sm_90a): FFT tile or
// direct tile.
//
// Replaces the Pallas TPU kernel
//   mfcc_tpu/ops/kernels/fused_raw.py::fused_features_raw
// raw (B, N) float32 audio in, in-kernel pre-emphasis (each frame's true
// predecessor, x[-1] := x[0] at the row start), DFT power in natural bin
// order, mel, floors, accurate log, then log-mel energies or cepstra out.
// The model layer sends it unbounded-range log-mel (routes.py), which the
// reference keeps on the direct form for deep spectral valleys.  The TPU
// kernel's lane-phase period layout, roll-based pre-emphasis and
// boundary-split GEMMs do not carry over.
//
// What bounds it on the card: at its main path, unbounded log-mel-80 at
// 16 kHz on 64 x 10 s, the audio in and features out are 61.4 MB (18.3 us
// at 3.35 TB/s) and the function's operations 1.0 GFLOP (15.2 us at the
// 67 TFLOP/s fp32 peak): bytes.  The direct tile did 28.8 GFLOP of fp32
// FMAs (frame_len x 512 a frame), 28x the function.
//
// What the design does about it: at an n_fft from 64 to 4096 that is a
// power of two, the kernel runs the shared-memory FFT tile of fft_tile.cuh,
// for unbounded log-mel in its float64-front flavour, and at one of the
// form 2^a 5^b (Whisper's 400) that flavour's mixed-radix tile, radix-5
// passes beside the radix-2/4/8 ones: pre-emphasis (with the
// config's coefficient as a double), window, twiddles, radix passes, split
// and |X|^2 in float64 on the FP64 units (half the FP32 rate, ~34 TFLOP/s
// on the H100 SXM; 16-byte complex points, so twice the f32 tile's
// exchange bytes through shared memory), then the f32 mel and epilogue.
// In valleys 120-140 dB under the peak the f32 FFT was 2.7-6x the direct
// form's error; the f64 front is within 2e-6 of the float64 oracle there,
// where the direct f32 form is ~1e-2 off.  Cepstra and log-mel <= 50 dB
// run the f32 flavour, with pre-emphasis in f32 as the plain version
// rounds it.  NeMo's log-mel (log(e + guard), pre-emphasized and centred
// on the host) runs the float64 flavour's power-of-two tile in finish's
// Guard mode, kernels of their own.  Any other n_fft runs the direct window-folded DFT tile of
// spectral.cuh; the host picks the tile from the config and n_fft's
// factors, in the same C entry.

#include "fft_tile.cuh"

namespace {

template <int TM, typename S>
__global__ void __launch_bounds__(spectral::kThreads,
                                  spectral::FftFlavour<S>::kBlocks)
    raw_fft_kernel(const spectral::FftParams<S> p) {
  spectral::fft_features<TM, S>(p);
}

// The mixed-radix tile (n_fft = 2^a 5^b): raw_fft_kernel on its own
// parameters, so that each power-of-two instantiation above stays as it
// was and a trace names this one raw_fft_kernel too.
template <int TM>
__global__ void __launch_bounds__(spectral::kThreads,
                                  spectral::FftFlavour<double>::kBlocks)
    raw_fft_kernel(const spectral::FftMixedParams p) {
  spectral::fft_mixed_features<TM>(p);
}

// The float64 flavour's power-of-two tile with NeMo's additive log guard
// (finish's Guard mode): raw_fft_kernel on its own parameters, so that
// every instantiation above stays as it was and a trace names this one
// raw_fft_kernel too.
template <int TM>
__global__ void __launch_bounds__(spectral::kThreads,
                                  spectral::FftFlavour<double>::kBlocks)
    raw_fft_kernel(const spectral::FftGuardParams p) {
  spectral::fft_features<TM, double, false, true>(p.f);
}

template <int FR>
__global__ void __launch_bounds__(spectral::kThreads, 1)
    raw_kernel(const spectral::DirectParams p) {
  spectral::direct_features<FR>(p);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 is
// success.  Launches on `stream` and does not synchronize.  tile is a
// spectral::Tile: kFftTile, kFft64Tile or kFft64MixedTile run that flavour
// of the FFT tile (win, tw, chunk_w, chunks, band_chunks given, win and tw
// in float or in double; basis, last and melw may be null), kOtherTile the
// direct tile
// (basis, last, melw given; the FFT tile's constants may be null).
// lengths (B) int64 on the device, or null: each row's own samples, which
// begin at len_offset and are cut to len_chunk (spectral::zero_tail); the
// mixed tile then skips the frame tiles wholly in the zeros after them.
// The other tiles compute every frame whatever it says.  log_guard 1: the
// log is log(e + log_floor) (NeMo's additive guard) in place of the
// floors, on kFft64Tile alone (any other tile is refused); 0: the floors.
extern "C" int mfcc_fused_raw(
    const float* x, int B, long long N, int T, const float* basis, int nbb,
    const float* last, const float* melw, const void* win, const void* tw,
    const float* chunk_w, const int* chunks, const int* band_chunks,
    int n_chunks, const float* dctm, float* out, int frame_len, int hop,
    int n_bins, int n_fft, int tile, double preemph, int log_guard,
    const long long* lengths, long long len_offset, long long len_chunk,
    int n_mels, int n_out, float log_floor, float rel_floor,
    int append_energy, int apply_dct, void* stream) {
  const spectral::Epilogue e{melw, dctm, out, T, n_mels, n_out, log_floor,
                             rel_floor, apply_dct, append_energy};
  const spectral::SpectralArgs a{x, B, N, basis, nbb, last, win, tw, chunk_w,
                                 chunks, band_chunks, n_chunks, e, frame_len,
                                 hop, n_bins, n_fft, tile, preemph, lengths,
                                 len_offset, len_chunk, log_guard};
  const spectral::KernelFn<spectral::FftParams<float>> fft32[4] = {
      raw_fft_kernel<64, float>, raw_fft_kernel<32, float>,
      raw_fft_kernel<16, float>, raw_fft_kernel<8, float>};
  const spectral::KernelFn<spectral::FftParams<double>> fft64[4] = {
      raw_fft_kernel<64, double>, raw_fft_kernel<32, double>,
      raw_fft_kernel<16, double>, raw_fft_kernel<8, double>};
  const spectral::KernelFn<spectral::FftMixedParams> mixed[4] = {
      raw_fft_kernel<64>, raw_fft_kernel<32>, raw_fft_kernel<16>,
      raw_fft_kernel<8>};
  const spectral::KernelFn<spectral::FftGuardParams> guarded[4] = {
      raw_fft_kernel<64>, raw_fft_kernel<32>, raw_fft_kernel<16>,
      raw_fft_kernel<8>};
  const spectral::KernelFn<spectral::DirectParams> direct_tiles[4] = {
      raw_kernel<8>, raw_kernel<4>, raw_kernel<2>, raw_kernel<1>};
  return spectral::launch_spectral(a, fft32, fft64, direct_tiles,
                                   static_cast<cudaStream_t>(stream), nullptr,
                                   nullptr, mixed, guarded);
}
