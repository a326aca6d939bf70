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
// stage does not fit).
//
// Windows beyond shared memory (ROADMAP.md kernels item 5): the
// lag-blocked tiling.  What bounds it: the same w * n_lags multiply-adds,
// now up to 25.6 M a frame (63,961 lags of a 400-sample frame; 18 M for a
// 64,000-sample frame at 281 lags), plus as many again for the lag
// energies, which no tile-wide position sum can serve once the window
// does not fit.  A block owns TM frames and one block of Lb = 32 * R * P
// lags of them; a warp holds the 32 lag groups of one frame in one of its
// P columns (TM * P = 8 warps; A[j] a broadcast, the E loads R words
// apart: conflict-free for odd R whatever the hop).  It walks the frames'
// windows in sample chunks of Jc <= 4,096: per chunk it stages A[j0 : j0
// + Jc] of its frames and the matching Jc + Lb + R - 2 samples of E from
// the lag block's first lag on, then each thread slides its R lags over
// the chunk.  The numerators, the lag energies and e0 stay in registers
// across chunks, and the outputs are staged and stored as in step 4.
// Shared memory holds 2 * ((TM - 1) * hop + Jc) + Lb + R - 2 samples
// whatever the window, so every config the reference takes has a tiling.
// The planner takes it where no whole-window tiling with shared energies
// fits, also where a one-frame window with the lag energies in registers
// would: that tile ran 3.1-4.3x slower at a 40,400-sample window on the
// H100 (PERF.md row 5).  The grid is rows x frame tiles x lag blocks;
// where that is short of the SMs, the planner takes fewer lags a thread
// (and so fewer frames a block and more lag blocks), which spreads the
// same chains over more SMs and changes no bit.
//
// Numerics: bit-identical to the one-thread-per-output design, in every
// tiling.  Every sum is one fmaf chain over j = 0 .. w-1 ascending from 0
// (e0 and e_lag are the same sums at the same positions; a sample chunk
// continues the chain where the last one stopped); the floor, the ballast
// add, the square roots and the divisions are spelled __fmul_rn /
// __fadd_rn / __fsqrt_rn / __fdiv_rn (IEEE, nothing contracted).  Build without --use_fast_math.
// Kernel vs the plain correlation-theorem version: a different summation,
// bounded by 2e-5 on valid frames.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kFrameLanes = 8;          // lag groups a frame: 4 frames a warp
constexpr int kMaxLagsPerThread = 15;   // R's ceiling (odd)
constexpr int kWarps = kThreads / 32;   // TM * P of the lag-blocked tiling
constexpr int kMaxChunk = 4096;         // samples a chunk of that tiling

struct Params {
  const float* x;     // (B, ldx) work-rate rows, Nw valid samples each
  const float* ball;  // (B,) ballast * mean_energy^2
  float* out_b;       // (B, T, n_lags) ballasted NCCF
  float* out_p;       // (B, T, n_lags) plain NCCF
  long long ldx, Nw;
  int T, tiles, TM, w, hop, min_lag, n_lags, span, passes;
  int energies;       // floats of the energy region
  int stage_out;      // outputs staged in shared memory, then stored coalesced
  // the lag-blocked tiling: lags a block, lag blocks, samples a chunk,
  // floats of the staged A span
  int lag_block, lag_blocks, chunk, span_a;
};

// sum_j v[j + r]^2 (ENERGY) or sum_j a[j] * v[j + r] over j = 0 .. w-1
// ascending, for r = 0 .. R-1, into acc; with LAG_ENERGY also
// sum_j v[j + r]^2 into el, with FRAME_ENERGY sum_j a[j]^2 into *ea.
// v[0 .. w + R - 2] must be readable.
template <int R, bool ENERGY, bool LAG_ENERGY, bool FRAME_ENERGY = false>
__device__ __forceinline__ void slide(const float* a, const float* v, int w,
                                      float (&acc)[R], float (&el)[R],
                                      float* ea = nullptr) {
  float win[R];   // win[q % R] = v[q] for the R samples of the current step
#pragma unroll
  for (int r = 0; r < R - 1; ++r) win[r] = v[r];
  int j0 = 0;
  auto step = [&](int j, int jj) {
    win[(jj + R - 1) % R] = v[j + R - 1];
    const float av = ENERGY ? 0.0f : a[j];
    if (FRAME_ENERGY) *ea = fmaf(av, av, *ea);
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

// The whole-window tiles: window energies once per position in shared
// memory.
template <int R>
__global__ void __launch_bounds__(kThreads) nccf_kernel(const Params p) {
  extern __shared__ float smem[];
  float* z = smem;              // (span) work-rate samples of this tile
  float* en = z + p.span;       // window energies by position
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
    float num[R];
#pragma unroll
    for (int r = 0; r < R; ++r) num[r] = 0.0f;
    slide<R, false, false>(a, a + p.min_lag + l0, p.w, num, unused);
    const float e0 = en[m * p.hop];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int l = l0 + r;
      if (l >= p.n_lags) break;
      const float prod =
          fmaxf(__fmul_rn(e0, en[m * p.hop + p.min_lag + l]), 1e-30f);
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

// The lag-blocked tiling: TM frames x the lag block [lb0, lb0 + lag_block)
// a block, a warp the 32 lag groups of R lags of one frame in one of the
// frame's P columns, the windows walked in sample chunks.  Shared memory:
// a chunk's A span (span_a floats) and E span; after the last chunk, the
// staged outputs.  Every thread sums its frame's e0 beside its lags (one
// FMA a step; the same chain in every thread of a frame).
template <int R>
__global__ void __launch_bounds__(kThreads) nccf_lag_kernel(const Params p) {
  extern __shared__ float smem[];
  float* za = smem;             // A of the tile's frames, this chunk
  float* ze = za + p.span_a;    // E from the lag block's first lag, this chunk
  float* sb = smem;             // (tm, nl) x 2 staged outputs, at the end

  const int tid = threadIdx.x;
  const int lb = blockIdx.x % p.lag_blocks;
  const int bt = blockIdx.x / p.lag_blocks;
  const int b = bt / p.tiles;
  const int t0 = (bt % p.tiles) * p.TM;
  const int tm = min(p.TM, p.T - t0);
  const int lb0 = lb * p.lag_block;
  const int nl = min(p.lag_block, p.n_lags - lb0);   // lags of this block
  const float* xb = p.x + static_cast<long long>(b) * p.ldx;
  const long long sa = static_cast<long long>(t0) * p.hop;
  const long long se = sa + p.min_lag + lb0;

  // warp k: frame k % TM, column k / TM; lane g: lag group g of it
  const int k = tid / 32, g = tid % 32;
  const int m = k % p.TM, c = k / p.TM;
  const int l0 = (c * 32 + g) * R;
  const bool active = m < tm && l0 < nl;
  float num[R], el[R];
#pragma unroll
  for (int r = 0; r < R; ++r) num[r] = el[r] = 0.0f;
  float e0 = 0.0f;
  for (int j0 = 0; j0 < p.w; j0 += p.chunk) {
    const int jc = min(p.chunk, p.w - j0);
    const int na = (tm - 1) * p.hop + jc;
    const int ne = na + nl + R - 2;   // the last group's window end
    __syncthreads();                  // the last chunk is read
    for (int i = tid; i < na; i += kThreads) {
      const long long gi = sa + j0 + i;
      za[i] = gi < p.Nw ? xb[gi] : 0.0f;
    }
    for (int i = tid; i < ne; i += kThreads) {
      const long long gi = se + j0 + i;
      ze[i] = gi < p.Nw ? xb[gi] : 0.0f;
    }
    __syncthreads();
    if (active)
      slide<R, false, true, true>(za + m * p.hop, ze + m * p.hop + l0, jc,
                                  num, el, &e0);
  }
  __syncthreads();   // every chunk is read: the spans take the outputs

  const float ball = p.ball[b];
  const int n_out = tm * nl;
  if (active) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int l = l0 + r;
      if (l >= nl) break;
      const float prod = fmaxf(__fmul_rn(e0, el[r]), 1e-30f);
      sb[m * nl + l] = __fdiv_rn(num[r], __fsqrt_rn(__fadd_rn(prod, ball)));
      sb[n_out + m * nl + l] = __fdiv_rn(num[r], __fsqrt_rn(prod));
    }
  }
  __syncthreads();
  // frame m's nl lags are contiguous in each output
  const long long base = (static_cast<long long>(b) * p.T + t0) * p.n_lags
                         + lb0;
  for (int i = tid; i < n_out; i += kThreads) {
    const int out = (i / nl) * p.n_lags + i % nl;
    p.out_b[base + out] = sb[i];
    p.out_p[base + out] = sb[n_out + i];
  }
}

typedef void (*Kernel)(Params);

template <int R>
Kernel kernel_for(int r, bool lag_blocked) {
  if constexpr (R > kMaxLagsPerThread) {
    return nullptr;
  } else {
    if (r == R) return lag_blocked ? nccf_lag_kernel<R> : nccf_kernel<R>;
    return kernel_for<R + 2>(r, lag_blocked);
  }
}

// How the kernel tiles a config on a card with `max_smem` bytes of opt-in
// shared memory a block and `sms` SMs.
struct Plan {
  int TM, R, passes, shared_energy, span, energies, stage_out;
  int lag_block, lag_blocks, chunk, span_a;   // lag-blocked: else 0
  size_t smem;
};

// The lag-blocked tiling at R lags a thread: the fewest columns P (a power
// of two, a warp each) whose Lb = 32 R P lags cover the grid, TM = 8 / P
// frames; the longest chunk up to kMaxChunk that fits; more columns,
// fewer frames where none fits.  False if nothing fits.
bool lag_tiling(int R, int w, int hop, int n_lags, int max_smem, Plan* pl) {
  const int groups = (n_lags + R - 1) / R;
  int P = 1;
  while (P < kWarps && 32 * P < groups) P *= 2;
  for (; P <= kWarps; P *= 2) {
    const int TM = kWarps / P, Lb = 32 * R * P;
    // floats: 2 x ((TM-1)*hop + Jc) + Lb + R - 2 samples, or the staged
    // outputs 2 x TM x Lb if more
    const long long fixed = 2LL * (TM - 1) * hop + Lb + R - 2;
    const long long jc = std::min<long long>(
        std::min(w, kMaxChunk), (max_smem / 4 - fixed) / 2);
    if (jc < 1) continue;
    const long long floats = std::max(fixed + 2 * jc, 2LL * TM * Lb);
    if (floats * 4 > max_smem) continue;
    Plan q{};
    q.TM = TM;
    q.R = R;
    q.passes = 1;
    q.stage_out = 1;
    q.lag_block = Lb;
    q.lag_blocks = (n_lags + Lb - 1) / Lb;
    q.chunk = static_cast<int>(jc);
    q.span_a = static_cast<int>((TM - 1) * hop + jc);
    q.smem = static_cast<size_t>(floats) * sizeof(float);
    *pl = q;
    return true;
  }
  return false;
}

// The lag-blocked tiling of B rows of T frames: R odd, at most 15 and at
// most ceil(n_lags / 32) (one warp's 32 lag groups cover the grid where
// they can).  Every warp of a block takes w steps of 2R + 3 instructions
// (R numerator and R energy FMAs, e0's FMA, two shared loads), so the
// busiest SM issues ceil(blocks / SMs) x (2R + 3) of them a warp and
// step: the planner takes the R with the fewest, the widest on a tie.  A
// grid that fills the card keeps the widest R; a short one (a few frames,
// or a wide frame's few lags) takes a narrower R and more blocks.
cudaError_t plan_lag_blocked(int w, int hop, int n_lags, int B, int T,
                             int max_smem, int sms, Plan* pl) {
  const int widest = std::min(kMaxLagsPerThread, ((n_lags + 31) / 32) | 1);
  long long best = -1;
  for (int R = widest; R >= 1; R -= 2) {
    Plan q;
    if (!lag_tiling(R, w, hop, n_lags, max_smem, &q)) continue;
    const long long blocks =
        static_cast<long long>(B) * ((T + q.TM - 1) / q.TM) * q.lag_blocks;
    const long long cost = (blocks + sms - 1) / sms * (2 * R + 3);
    if (best < 0 || cost < best) {
      best = cost;
      *pl = q;
    }
  }
  return best < 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

cudaError_t plan(int w, int hop, int min_lag, int n_lags, int B, int T,
                 int max_smem, int sms, Plan* pl) {
  Plan q{};
  // R: odd (conflict-free lag groups), so that 8 groups cover the lags
  q.R = std::min(kMaxLagsPerThread,
                 ((n_lags + kFrameLanes - 1) / kFrameLanes) | 1);
  q.passes = (n_lags + kFrameLanes * q.R - 1) / (kFrameLanes * q.R);
  q.shared_energy = 1;
  const int max_lag = min_lag + n_lags - 1;
  // zero pad: the last lag group's window and the last energy chunk read
  // past the span
  const int pad = std::max(kFrameLanes * q.R * q.passes - n_lags, q.R - 1);
  for (int TM : {32, 8, 1}) {
    for (int stage_out = 1; stage_out >= 0; --stage_out) {
      const long long span =
          static_cast<long long>(TM - 1) * hop + w + max_lag + pad;
      const long long energies = static_cast<long long>(TM - 1) * hop +
                                 max_lag + 1;
      const size_t bytes = sizeof(float) *
          (span + energies + (stage_out ? 2LL * TM * n_lags : 0));
      if (bytes > static_cast<size_t>(max_smem)) continue;
      q.TM = TM;
      q.span = static_cast<int>(span);
      q.energies = static_cast<int>(energies);
      q.stage_out = stage_out;
      q.smem = bytes;
      *pl = q;
      return cudaSuccess;
    }
  }
  return plan_lag_blocked(w, hop, n_lags, B, T, max_smem, sms, pl);
}

cudaError_t device_plan(int w, int hop, int min_lag, int n_lags, int B,
                        int T, Plan* pl) {
  if (w <= 0 || hop <= 0 || min_lag < 0 || n_lags <= 0)
    return cudaErrorInvalidValue;
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  return plan(w, hop, min_lag, n_lags, B, T, max_smem, sms, pl);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 is
// success.  Launches on `stream` and does not synchronize; writes the tile
// it chose into shape[0..6] (frames a tile TM, lags a thread R, lag passes
// a thread, energies shared by the tile, outputs staged: 1/0, and for the
// lag-blocked tiling the lags a block and the samples a chunk, else 0, 0).
extern "C" int mfcc_fused_nccf(const float* x, long long ldx, long long Nw,
                               const float* ball, float* out_b, float* out_p,
                               int B, int T, int w, int hop, int min_lag,
                               int n_lags, void* stream, int* shape) {
  if (B <= 0 || T <= 0 || ldx < Nw) return cudaErrorInvalidValue;
  Plan pl;
  cudaError_t err = device_plan(w, hop, min_lag, n_lags, B, T, &pl);
  if (err != cudaSuccess) return err;
  const int out[7] = {pl.TM, pl.R, pl.passes, pl.shared_energy, pl.stage_out,
                      pl.lag_block, pl.chunk};
  for (int i = 0; i < 7; ++i) shape[i] = out[i];
  const Kernel kernel = kernel_for<1>(pl.R, pl.lag_block > 0);
  if (kernel == nullptr) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pl.smem));
  if (err != cudaSuccess) return err;
  const int tiles = (T + pl.TM - 1) / pl.TM;
  const long long blocks = static_cast<long long>(tiles) * B *
                           std::max(pl.lag_blocks, 1);
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  const Params p{x, ball, out_b, out_p, ldx, Nw, T, tiles, pl.TM, w, hop,
                 min_lag, n_lags, pl.span, pl.passes, pl.energies,
                 pl.stage_out, pl.lag_block, pl.lag_blocks, pl.chunk,
                 pl.span_a};
  kernel<<<static_cast<unsigned>(blocks), kThreads, pl.smem,
           static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

extern "C" const char* mfcc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
