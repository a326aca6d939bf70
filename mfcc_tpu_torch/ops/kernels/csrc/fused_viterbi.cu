// Pitch Viterbi kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   mfcc_tpu/ops/kernels/fused_viterbi.py::viterbi_pallas
// (its forward recursion and its backtrace).  Masked ballasted NCCF
// scores s (B, T, n) float32 in, the min-plus Viterbi path (B, T) int32
// out:
//   cost_0 = -s_0
//   cost_t[i] = min_j (cost_{t-1}[j] + trans[j, i]) - s_t[i],  t >= 1
//   bp_t[i]   = the first j reaching that minimum (strict <)
//   path[T-1] = the first argmin of cost_{T-1}; path[t-1] = bp_t[path[t]]
// The path is bit-identical to the plain PyTorch version
// (ops/pitch.viterbi: torch.argmin over cost[:, None] + trans), and so to
// the JAX package's: every value is one correctly rounded f32 add or
// subtract of the same operands, min is exact, and the running argmin
// scans j upward with strict < exactly as a first-index argmin does.
// There is no multiply, so no FMA contraction can change a bit; there is
// no tree reduction, so no tie can go to another index.
//
// What bounds it on the card: the T-step chain is sequential, and each
// step is n dependent compare-selects per destination state, about n
// cycles of latency plus one barrier.  One block runs one utterance (or
// one viterbi_blocked chunk), so a batch of B fills B of the 132 SMs;
// the kernel's time is the chain's latency, not a share of a peak.
//
// What the design does about it: one block per utterance, one thread per
// destination state i (the block loops if n exceeds it), the cost vector
// double-buffered in shared memory (one barrier per step), the transition
// matrix in shared memory when it fits (n <= ~230), read with stride 1
// across the warp.  Backpointers go to global memory (the wrapper's
// scratch, (B, T, n) int32); after the last step one thread takes the
// final argmin and walks the backtrace.

#include <cuda_runtime.h>

namespace {

struct Params {
  const float* s;      // (B, T, n) scores
  const float* trans;  // (n, n) transition costs, [from j, to i]
  int* bp;             // (B, T, n) backpointers (row t = 0 unused)
  int* path;           // (B, T) output
  int T, n, trans_in_smem;
};

__global__ void viterbi_kernel(const Params p) {
  extern __shared__ float smem[];
  float* cur = smem;          // (n) cost at t - 1
  float* nxt = smem + p.n;    // (n) cost at t
  const int n = p.n, tid = threadIdx.x, nth = blockDim.x;
  const long long row = static_cast<long long>(blockIdx.x) * p.T;
  const float* s = p.s + row * n;
  int* bp = p.bp + row * n;

  const float* trans = p.trans;
  if (p.trans_in_smem) {
    float* tr = smem + 2 * n;
    for (int k = tid; k < n * n; k += nth) tr[k] = p.trans[k];
    trans = tr;
  }
  for (int i = tid; i < n; i += nth) cur[i] = -s[i];
  __syncthreads();

  for (int t = 1; t < p.T; ++t) {
    const float* st = s + static_cast<long long>(t) * n;
    int* bpt = bp + static_cast<long long>(t) * n;
    for (int i = tid; i < n; i += nth) {
      const float sv = st[i];
      float best = __fadd_rn(cur[0], trans[i]);
      int arg = 0;
      for (int j = 1; j < n; ++j) {
        const float c = __fadd_rn(cur[j], trans[j * n + i]);
        if (c < best) {
          best = c;
          arg = j;
        }
      }
      nxt[i] = __fsub_rn(best, sv);
      bpt[i] = arg;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // the barrier after the last step also makes every backpointer write of
  // the block visible to thread 0
  if (tid == 0) {
    int k = 0;
    float best = cur[0];
    for (int i = 1; i < n; ++i) {
      if (cur[i] < best) {
        best = cur[i];
        k = i;
      }
    }
    int* path = p.path + row;
    path[p.T - 1] = k;
    for (int t = p.T - 1; t > 0; --t) {
      k = bp[static_cast<long long>(t) * n + k];
      path[t - 1] = k;
    }
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 is
// success.  Launches on `stream` and does not synchronize.
extern "C" int mfcc_fused_viterbi(const float* s, const float* trans, int* bp,
                                  int* path, int B, int T, int n,
                                  void* stream) {
  if (B <= 0 || T <= 0 || n <= 0) return cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  size_t bytes = sizeof(float) * 2 * static_cast<size_t>(n);
  const size_t with_trans = bytes + sizeof(float) * static_cast<size_t>(n) * n;
  const int trans_in_smem = with_trans <= static_cast<size_t>(max_smem);
  if (trans_in_smem) bytes = with_trans;
  if (bytes > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(viterbi_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  // one thread per state, whole warps, at most 1024 (the block loops)
  const int threads = n >= 1024 ? 1024 : (n + 31) / 32 * 32;
  const Params p{s, trans, bp, path, T, n, trans_in_smem};
  viterbi_kernel<<<B, threads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

extern "C" const char* mfcc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
