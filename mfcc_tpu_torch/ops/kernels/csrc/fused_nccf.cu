// Pitch NCCF kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   mfcc_tpu/ops/kernels/fused_nccf.py::fused_nccf
// Work-rate audio (B, Nw) float32 plus a per-utterance ballast (B,) in,
// the ballasted and the plain NCCF on the lag grid out, each
// (B, T, n_lags) float32.  For frame t with extended window
// E = x[t*hop : t*hop + w + max_lag] and A = E[0 : w]:
//   num[L]   = sum_j A[j] * E[j + L]           (L = min_lag .. max_lag)
//   e0       = sum_j A[j]^2,  e_lag[L] = sum_j E[j + L]^2
//   prod     = max(e0 * e_lag, 1e-30)
//   nccf_b   = num / sqrt(prod + ball[b]),  nccf_p = num / sqrt(prod)
//
// What bounds it on the card: in the direct time domain a frame costs
// w * n_lags multiply-adds for the numerators, 7,100 at the default
// config, 0.45 G for a 64 x 10 s batch: ~14 us of fp32 FMA issue.  The
// outputs (2 x 18 MB) and the input (10 MB) take ~14 us of HBM time.
// A design with one thread per output reads two shared-memory words
// (A[j], E[j + L]) for every two FMAs and recomputes e_lag for every
// (frame, lag), so shared-memory wavefronts (~0.12 ms for the batch) are
// its limit.  With those cut, the
// stores come next: a thread's R outputs R words apart touch ~8x the
// memory sectors of the same outputs stored by consecutive threads.
//
// What the design does about it: the TPU kernel computes the numerators by
// the correlation theorem (two length-180 DFTs and a lag-grid IDFT) because
// the MXU wants GEMMs.  Here the direct correlation is 11x fewer operations
// and more accurate, so it is used instead.  A block of 256 threads owns TM
// consecutive frames of one utterance:
//   1. stage the tile's span of work-rate samples ((TM-1)*hop + w +
//      max_lag floats, plus a zero pad) in shared memory once; samples past
//      the row's end read 0 (those frames are invalid and masked by every
//      caller);
//   2. the energy of every window position of the span (position p: sum
//      over j of z[p + j]^2), R consecutive positions a thread: frame m's
//      e0 is position m*hop, its e_lag[L] position m*hop + L, so each is
//      summed once per tile, not once for every (frame, lag);
//   3. each thread computes R consecutive lags of one frame, keeping the
//      R-sample window of E in registers and sliding it by one new sample
//      a step: per j one broadcast load of A[j] and one load of E, shared
//      by R FMAs.  The j-loop is unrolled by R so the window rotates by
//      register renaming.
// Lane mapping: a warp holds 4 frames x 8 lag groups (R = 9 covers the 71
// default lags in one pass).  With R odd the 8 groups of a frame hit 8
// banks whose residues mod 8 all differ, and frames hop = 40 apart (8 mod
// 32) shift them by 8, 16, 24: every warp-wide load of steps 2 and 3 is
// conflict-free or a broadcast at the default config
// (tools/ablate_pitch.py counts the wavefronts of any config, and A/Bs R:
// R = 9 measured faster than 5, 3 and 1 lags a thread).
//   4. the outputs are staged in shared memory in the tile's own layout and
//      stored coalesced (a thread's R consecutive lags, stored straight
//      from registers, would touch ~8x the memory sectors).
// TM is 32 when the span, the energies and the staged outputs fit in
// shared memory, else 8, else 1 (then outputs are stored directly if the
// stage does not fit); a window too large for the energies (w + max_lag up
// to 58,000 samples) keeps the lag energies in each thread's registers
// instead (R more FMAs a step, no more loads).  The Python wrapper refuses
// larger windows.
//
// Numerics: bit-identical to the one-thread-per-output design.  Every sum
// is fmaf over j = 0 .. w-1 ascending from 0 (e0 and e_lag are the same
// sums at the same positions); the floor, the ballast add, the square
// roots and the divisions are spelled __fmul_rn / __fadd_rn / __fsqrt_rn /
// __fdiv_rn (IEEE, nothing contracted).  Build without --use_fast_math.
// Kernel vs the plain correlation-theorem version: a different summation,
// bounded by 2e-5 on valid frames.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kFrameLanes = 8;          // lag groups a frame: 4 frames a warp
constexpr int kMaxLagsPerThread = 15;   // R's ceiling (odd)

struct Params {
  const float* x;     // (B, ldx) work-rate rows, Nw valid samples each
  const float* ball;  // (B,) ballast * mean_energy^2
  float* out_b;       // (B, T, n_lags) ballasted NCCF
  float* out_p;       // (B, T, n_lags) plain NCCF
  long long ldx, Nw;
  int T, tiles, TM, w, hop, min_lag, n_lags, span, passes;
  int energies;       // floats of the energy region
  int stage_out;      // outputs staged in shared memory, then stored coalesced
};

// sum_j v[j + r]^2 (ENERGY) or sum_j a[j] * v[j + r] over j = 0 .. w-1
// ascending, for r = 0 .. R-1, into acc; with LAG_ENERGY also
// sum_j v[j + r]^2 into el.  v[0 .. w + R - 2] must be readable.
template <int R, bool ENERGY, bool LAG_ENERGY>
__device__ __forceinline__ void slide(const float* a, const float* v, int w,
                                      float (&acc)[R], float (&el)[R]) {
  float win[R];   // win[q % R] = v[q] for the R samples of the current step
#pragma unroll
  for (int r = 0; r < R - 1; ++r) win[r] = v[r];
  int j0 = 0;
  auto step = [&](int j, int jj) {
    win[(jj + R - 1) % R] = v[j + R - 1];
    const float av = ENERGY ? 0.0f : a[j];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float ev = win[(jj + r) % R];
      acc[r] = fmaf(ENERGY ? ev : av, ev, acc[r]);
      if (LAG_ENERGY) el[r] = fmaf(ev, ev, el[r]);
    }
  };
  for (; j0 + R <= w; j0 += R) {
#pragma unroll
    for (int jj = 0; jj < R; ++jj) step(j0 + jj, jj);
  }
#pragma unroll
  for (int jj = 0; jj < R; ++jj)   // the last w % R steps
    if (j0 + jj < w) step(j0 + jj, jj);
}

// SHARED_ENERGY: window energies once per position in shared memory;
// else the lag energies in each thread's registers and e0 once per frame.
template <int R, bool SHARED_ENERGY>
__global__ void __launch_bounds__(kThreads) nccf_kernel(const Params p) {
  extern __shared__ float smem[];
  float* z = smem;              // (span) work-rate samples of this tile
  float* en = z + p.span;       // window energies by position, or (TM) e0
  float* sb = en + p.energies;  // (TM, n_lags) x 2 staged outputs

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.tiles;
  const int t0 = (blockIdx.x % p.tiles) * p.TM;
  const int tm = min(p.TM, p.T - t0);
  const float* xb = p.x + static_cast<long long>(b) * p.ldx;
  const long long s0 = static_cast<long long>(t0) * p.hop;

  for (int i = tid; i < p.span; i += kThreads) {
    const long long g = s0 + i;
    z[i] = g < p.Nw ? xb[g] : 0.0f;
  }
  __syncthreads();

  float unused[R];
  if (SHARED_ENERGY) {
    // positions 0 .. (tm-1)*hop + max_lag, R consecutive a thread
    const int npos = (tm - 1) * p.hop + p.min_lag + p.n_lags;
    for (int c = tid; c * R < npos; c += kThreads) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      slide<R, true, false>(nullptr, z + c * R, p.w, acc, unused);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (c * R + r < npos) en[c * R + r] = acc[r];
    }
  } else {
    for (int m = tid; m < tm; m += kThreads) {
      const float* a = z + m * p.hop;
      float s = 0.0f;
      for (int j = 0; j < p.w; ++j) s = fmaf(a[j], a[j], s);
      en[m] = s;
    }
  }
  __syncthreads();

  const float ball = p.ball[b];
  const long long base = (static_cast<long long>(b) * p.T + t0) * p.n_lags;
  // the tile's outputs are tm * n_lags contiguous floats of each output: a
  // thread's R lags go to shared memory first, so the stores coalesce
  const int n_out = tm * p.n_lags;
  float* ob = p.stage_out ? sb : p.out_b + base;
  float* op = p.stage_out ? sb + n_out : p.out_p + base;
  // task o: lag group g of frame m in lag pass c; a warp holds 4 frames x
  // 8 groups of one pass
  const int n_tasks = tm * kFrameLanes * p.passes;
  for (int o = tid; o < n_tasks; o += kThreads) {
    const int g = o % kFrameLanes, mc = o / kFrameLanes;
    const int m = mc % tm, c = mc / tm;
    const int l0 = (c * kFrameLanes + g) * R;
    if (l0 >= p.n_lags) continue;
    const float* a = z + m * p.hop;
    float num[R], el[R];
#pragma unroll
    for (int r = 0; r < R; ++r) num[r] = el[r] = 0.0f;
    if (SHARED_ENERGY)
      slide<R, false, false>(a, a + p.min_lag + l0, p.w, num, el);
    else
      slide<R, false, true>(a, a + p.min_lag + l0, p.w, num, el);
    const float e0 = SHARED_ENERGY ? en[m * p.hop] : en[m];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int l = l0 + r;
      if (l >= p.n_lags) break;
      const float elv = SHARED_ENERGY ? en[m * p.hop + p.min_lag + l] : el[r];
      const float prod = fmaxf(__fmul_rn(e0, elv), 1e-30f);
      const int out = m * p.n_lags + l;
      ob[out] = __fdiv_rn(num[r], __fsqrt_rn(__fadd_rn(prod, ball)));
      op[out] = __fdiv_rn(num[r], __fsqrt_rn(prod));
    }
  }
  if (p.stage_out) {
    __syncthreads();
    for (int i = tid; i < n_out; i += kThreads) {
      p.out_b[base + i] = ob[i];
      p.out_p[base + i] = op[i];
    }
  }
}

typedef void (*Kernel)(Params);

template <int R>
Kernel kernel_for(int r, bool shared_energy) {
  if constexpr (R > kMaxLagsPerThread) {
    return nullptr;
  } else {
    if (r == R)
      return shared_energy ? nccf_kernel<R, true> : nccf_kernel<R, false>;
    return kernel_for<R + 2>(r, shared_energy);
  }
}

// How the kernel tiles a config on a card with `max_smem` bytes of opt-in
// shared memory a block.
struct Plan {
  int TM, R, passes, shared_energy, span, energies, stage_out;
  size_t smem;
};

cudaError_t plan(int w, int hop, int min_lag, int n_lags, int max_smem,
                 Plan* pl) {
  Plan q{};
  // R: odd (conflict-free lag groups), so that 8 groups cover the lags
  q.R = std::min(kMaxLagsPerThread,
                 ((n_lags + kFrameLanes - 1) / kFrameLanes) | 1);
  q.passes = (n_lags + kFrameLanes * q.R - 1) / (kFrameLanes * q.R);
  const int max_lag = min_lag + n_lags - 1;
  // zero pad: the last lag group's window and the last energy chunk read
  // past the span
  const int pad = std::max(kFrameLanes * q.R * q.passes - n_lags, q.R - 1);
  const int kTiles[] = {32, 8, 1};
  for (int shared_energy = 1; shared_energy >= 0; --shared_energy) {
    for (int TM : kTiles) {
      if (!shared_energy && TM != 1) continue;
      for (int stage_out = 1; stage_out >= 0; --stage_out) {
        const long long span =
            static_cast<long long>(TM - 1) * hop + w + max_lag + pad;
        const long long energies =
            shared_energy ? static_cast<long long>(TM - 1) * hop + max_lag + 1
                          : TM;
        const size_t bytes = sizeof(float) *
            (span + energies + (stage_out ? 2LL * TM * n_lags : 0));
        if (bytes > static_cast<size_t>(max_smem)) continue;
        q.TM = TM;
        q.shared_energy = shared_energy;
        q.span = static_cast<int>(span);
        q.energies = static_cast<int>(energies);
        q.stage_out = stage_out;
        q.smem = bytes;
        *pl = q;
        return cudaSuccess;
      }
    }
  }
  return cudaErrorInvalidConfiguration;
}

cudaError_t device_plan(int w, int hop, int min_lag, int n_lags, Plan* pl) {
  if (w <= 0 || hop <= 0 || min_lag < 0 || n_lags <= 0)
    return cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  return plan(w, hop, min_lag, n_lags, max_smem, pl);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 is
// success.  Launches on `stream` and does not synchronize; writes the tile
// it chose into shape[0..4] (frames a tile TM, lags a thread R, lag
// passes, energies shared by the tile, outputs staged: 1/0).
extern "C" int mfcc_fused_nccf(const float* x, long long ldx, long long Nw,
                               const float* ball, float* out_b, float* out_p,
                               int B, int T, int w, int hop, int min_lag,
                               int n_lags, void* stream, int* shape) {
  if (B <= 0 || T <= 0 || ldx < Nw) return cudaErrorInvalidValue;
  Plan pl;
  cudaError_t err = device_plan(w, hop, min_lag, n_lags, &pl);
  if (err != cudaSuccess) return err;
  const int out[5] = {pl.TM, pl.R, pl.passes, pl.shared_energy, pl.stage_out};
  for (int i = 0; i < 5; ++i) shape[i] = out[i];
  const Kernel kernel = kernel_for<1>(pl.R, pl.shared_energy);
  if (kernel == nullptr) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pl.smem));
  if (err != cudaSuccess) return err;
  const int tiles = (T + pl.TM - 1) / pl.TM;
  const long long blocks = static_cast<long long>(tiles) * B;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  const Params p{x, ball, out_b, out_p, ldx, Nw, T, tiles, pl.TM, w, hop,
                 min_lag, n_lags, pl.span, pl.passes, pl.energies,
                 pl.stage_out};
  kernel<<<static_cast<unsigned>(blocks), kThreads, pl.smem,
           static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

extern "C" const char* mfcc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
