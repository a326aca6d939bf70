// Fused spectral kernel for NVIDIA Hopper (sm_90a), pre-emphasized input.
//
// Replaces the Pallas TPU kernel
//   mfcc_tpu/ops/kernels/fused_mfcc.py::fused_features
// (B, N) float32 audio that the host has already pre-emphasized in, DFT
// power over all n_bins, mel, floors, accurate log, then cepstra with the
// optional log energy of the frames in c0, or log-mel energies.  The model
// layer sends it the configs that neither raw kernel nor the DIT kernel
// takes (an odd hop, n_fft % 4 != 0: 44.1 kHz at 25/10 ms).
//
// The TPU kernel's hop-block decomposition (re/im = sum_k V_k @ C_k, rows
// shifted by sublane rolls) exists to make overlapping frames static
// slices of one VMEM buffer for the MXU; it does not carry over.  Frames
// here are offsets into the tile's staged span.  For cepstra and log-mel
// bounded to <= 50 dB at a power-of-two n_fft from 64 to 4096 (44.1 kHz:
// n_fft 2048, 1102-sample frames at hop 441) it runs the shared-memory FFT
// tile of fft_tile.cuh with pre-emphasis off.  The function is bound there
// by its operations (~64 kflop a frame, 61 us for a 64 x 10 s batch at the
// fp32 peak, against 35 us of HBM traffic); the direct form it replaces did
// 70 times that work (288 GFLOP), so the FFT is what brings the kernel near
// its bound.  Unbounded log-mel at such an n_fft runs the tile's
// float64-front flavour (fft_tile.cuh: it holds the float64 oracle in deep
// spectral valleys, where the f32 FFT does not).  Any other n_fft runs the
// direct window-folded DFT tile of spectral.cuh, in the same C entry; the
// host picks the tile from the config.

#include "fft_tile.cuh"

namespace {

template <int TM, typename S>
__global__ void __launch_bounds__(spectral::kThreads,
                                  spectral::FftFlavour<S>::kBlocks)
    mfcc_fft_kernel(const spectral::FftParams<S> p) {
  spectral::fft_features<TM, S>(p);
}

template <int FR>
__global__ void __launch_bounds__(spectral::kThreads, 1)
    mfcc_kernel(const spectral::DirectParams p) {
  spectral::direct_features<FR>(p);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 is
// success.  Launches on `stream` and does not synchronize.  tile is a
// spectral::Tile: kFftTile or kFft64Tile run that flavour of the FFT tile
// (win, tw, chunk_w, chunks, band_chunks given, win and tw in float or in
// double; basis, last and melw may be null), kOtherTile the direct tile
// (basis, last, melw given; the FFT tile's constants may be null).
extern "C" int mfcc_fused_mfcc(
    const float* y, int B, long long N, int T, const float* basis, int nbb,
    const float* last, const float* melw, const void* win, const void* tw,
    const float* chunk_w, const int* chunks, const int* band_chunks,
    int n_chunks, const float* dctm, float* out, int frame_len, int hop,
    int n_bins, int n_fft, int tile, int n_mels, int n_out, float log_floor,
    float rel_floor, int append_energy, int apply_dct, void* stream) {
  const spectral::Epilogue e{melw, dctm, out, T, n_mels, n_out, log_floor,
                             rel_floor, apply_dct, append_energy};
  const spectral::SpectralArgs a{y, B, N, basis, nbb, last, win, tw, chunk_w,
                                 chunks, band_chunks, n_chunks, e, frame_len,
                                 hop, n_bins, n_fft, tile, 0.0};
  const spectral::KernelFn<spectral::FftParams<float>> fft32[4] = {
      mfcc_fft_kernel<64, float>, mfcc_fft_kernel<32, float>,
      mfcc_fft_kernel<16, float>, mfcc_fft_kernel<8, float>};
  const spectral::KernelFn<spectral::FftParams<double>> fft64[4] = {
      mfcc_fft_kernel<64, double>, mfcc_fft_kernel<32, double>,
      mfcc_fft_kernel<16, double>, mfcc_fft_kernel<8, double>};
  const spectral::KernelFn<spectral::DirectParams> direct_tiles[4] = {
      mfcc_kernel<8>, mfcc_kernel<4>, mfcc_kernel<2>, mfcc_kernel<1>};
  return spectral::launch_spectral(a, fft32, fft64, direct_tiles,
                                   static_cast<cudaStream_t>(stream));
}
