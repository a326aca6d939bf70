// Fused raw-audio spectral kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   mfcc_tpu/ops/kernels/fused_raw_dit.py::fused_features_raw_dit
// with projection="mel": raw (B, N) float32 audio in, (B, T, n_mfcc)
// cepstra or (B, T, n_mels) log-mel energies out (apply_dct).  One launch
// reads the audio once and writes the features once; pre-emphasis, window,
// DFT power, mel projection, absolute and relative floors, accurate log,
// lifter-folded DCT and the optional log-energy c0 all happen on chip.
// The model layer sends it cepstra and log-mel bounded to <= 50 dB, as the
// reference does (models/mfcc.py).
//
// The TPU kernel's radix-2 DIT on the raw layout (parity deinterleave,
// lane-phase periods, roll+select assembly, packed bin permutation, LEAD
// rows) does not carry over: this kernel is the direct window-folded DFT
// tile of spectral.cuh, in natural bin order with the plain mel matrix
// (what bounds it and what the tile does about it are noted there).  It
// is the same tile as fused_raw.cu; whether this route should move to a
// raw-input DIT tile (2x fewer FMAs, the reference's choice) is an H100
// A/B left open.
//
// Numerics: the accurate log and the pre-emphasis round exactly as the
// plain PyTorch version does; only the DFT/mel/DCT summation order differs.

#include "spectral.cuh"

namespace {

template <int FR>
__global__ void __launch_bounds__(spectral::kThreads, 1)
    raw_dit_kernel(const spectral::DirectParams p) {
  spectral::direct_features<FR>(p);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 is
// success.  Launches on `stream` and does not synchronize.
extern "C" int mfcc_fused_raw_dit(
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
      raw_dit_kernel<8>, raw_dit_kernel<4>, raw_dit_kernel<2>,
      raw_dit_kernel<1>};
  return spectral::launch_direct(p, B, kernels,
                                 static_cast<cudaStream_t>(stream));
}
