// Fused raw-audio spectral kernel for NVIDIA Hopper (sm_90a), direct form.
//
// Replaces the Pallas TPU kernel
//   mfcc_tpu/ops/kernels/fused_raw.py::fused_features_raw
// raw (B, N) float32 audio in, in-kernel pre-emphasis (each frame's true
// predecessor, x[-1] := x[0] at the row start), the direct window-folded
// DFT in natural bin order for bins 0..n_bins-2 with the last bin as a
// separate per-frame dot product, mel, floors, accurate log, then log-mel
// energies or cepstra out.  The model layer sends it unbounded-range
// log-mel, which the reference keeps on the direct form for deep spectral
// valleys (routes.py).
//
// The TPU kernel's lane-phase period layout, roll-based pre-emphasis and
// boundary-split GEMMs do not carry over.  This is the direct tile of
// spectral.cuh for every config, kept for the valley accuracy: in spectral
// valleys ~120 dB under the peak an f32 FFT rounds worse than the direct
// form, so fused_raw_dit.cu runs its FFT tile (fft_tile.cuh) only for
// cepstra and log-mel bounded to <= 50 dB.

#include "spectral.cuh"

namespace {

template <int FR>
__global__ void __launch_bounds__(spectral::kThreads, 1)
    raw_kernel(const spectral::DirectParams p) {
  spectral::direct_features<FR>(p);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 is
// success.  Launches on `stream` and does not synchronize.
extern "C" int mfcc_fused_raw(
    const float* x, int B, long long N, int T, const float* basis, int nbb,
    const float* last, const float* melw, const float* dctm, float* out,
    int frame_len, int hop, int n_bins, float preemph, int n_mels, int n_out,
    float log_floor, float rel_floor, int append_energy, int apply_dct,
    void* stream) {
  const spectral::Epilogue e{melw, dctm, out, T, n_mels, n_out, log_floor,
                             rel_floor, apply_dct, append_energy};
  const spectral::DirectParams p{x, basis, last, e, N, 0, nbb, frame_len,
                                 hop, n_bins, 0, preemph};
  const spectral::KernelFn<spectral::DirectParams> kernels[4] = {
      raw_kernel<8>, raw_kernel<4>, raw_kernel<2>, raw_kernel<1>};
  return spectral::launch_direct(p, B, kernels,
                                 static_cast<cudaStream_t>(stream));
}
