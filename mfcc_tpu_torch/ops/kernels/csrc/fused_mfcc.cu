// Fused spectral kernel for NVIDIA Hopper (sm_90a), pre-emphasized input.
//
// Replaces the Pallas TPU kernel
//   mfcc_tpu/ops/kernels/fused_mfcc.py::fused_features
// (B, N) float32 audio that the host has already pre-emphasized in, the
// direct window-folded DFT over all n_bins (256-bin blocks plus the last
// bin's cos/sin columns), |X|^2, mel, floors, accurate log, then cepstra
// with the optional log energy of the frames in c0, or log-mel energies.
// The model layer sends it the configs that neither raw kernel nor the
// DIT kernel takes (an odd hop, n_fft % 4 != 0: 44.1 kHz at 25/10 ms).
//
// The TPU kernel's hop-block decomposition (re/im = sum_k V_k @ C_k, rows
// shifted by sublane rolls) exists to make overlapping frames static
// slices of one VMEM buffer; it does not carry over.  Frames here are
// offsets into the tile's staged span, as in the direct tile of
// spectral.cuh, which this kernel runs with pre-emphasis off.  Large
// frames (1102 samples at 44.1 kHz) fall to smaller frame tiles where a
// 64-frame span does not fit in shared memory.

#include "spectral.cuh"

namespace {

template <int FR>
__global__ void __launch_bounds__(spectral::kThreads, 1)
    mfcc_kernel(const spectral::DirectParams p) {
  spectral::direct_features<FR>(p);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 is
// success.  Launches on `stream` and does not synchronize.
extern "C" int mfcc_fused_mfcc(
    const float* y, int B, long long N, int T, const float* basis, int nbb,
    const float* last, const float* melw, const float* dctm, float* out,
    int frame_len, int hop, int n_bins, int n_mels, int n_out,
    float log_floor, float rel_floor, int append_energy, int apply_dct,
    void* stream) {
  const spectral::Epilogue e{melw, dctm, out, T, n_mels, n_out, log_floor,
                             rel_floor, apply_dct, append_energy};
  const spectral::DirectParams p{y, basis, last, e, N, 0, nbb, frame_len,
                                 hop, n_bins, 0, 0.0f};
  const spectral::KernelFn<spectral::DirectParams> kernels[4] = {
      mfcc_kernel<8>, mfcc_kernel<4>, mfcc_kernel<2>, mfcc_kernel<1>};
  return spectral::launch_direct(p, B, kernels,
                                 static_cast<cudaStream_t>(stream));
}
