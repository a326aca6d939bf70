// Pitch Viterbi kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   mfcc_tpu/ops/kernels/fused_viterbi.py::viterbi_pallas
// (its forward recursion and its backtrace).  Masked ballasted NCCF
// scores s (B, T, n) float32 in, the min-plus Viterbi path (B, T) int32
// out:
//   cost_0 = -s_0
//   cost_t[i] = min_j (cost_{t-1}[j] + trans[j, i]) - s_t[i],  t >= 1
//   bp_t[i]   = the first j reaching that minimum
//   path[T-1] = the first argmin of cost_{T-1}; path[t-1] = bp_t[path[t]]
// The path is bit-identical to the plain PyTorch version
// (ops/pitch.viterbi: torch.argmin over cost[:, None] + trans), and so to
// the JAX package's.  Every candidate is one correctly rounded f32 add of
// the same operands and min is exact, so only the tie rule could move an
// index.  Here every merge of two partial minima joins two contiguous
// ranges of j, the higher range winning only if strictly smaller: inside a
// lane (a tree of pairs) and across the K lanes of a state (warp
// shuffles).  That merge is associative over contiguous ranges, so the
// result is the first-index argmin for every K and every tree.  There is
// no multiply, so no FMA contraction.
//
// What bounds it on the card: the T-step chain.  One block runs one
// utterance (or one viterbi_blocked chunk); each step needs all n costs of
// the step before, so a step is a min over n candidates per state and one
// block barrier.  Its floor is the dependent part of a step, ceil(log2 n)
// compare-select pairs and the barrier (chip_smoke.py `_chain_ms`); the
// B utterances fill B of the 132 SMs.  Short of that floor a step is
// bound by what one SM issues for it: n^2 candidates at ~4 instructions
// each over 4 schedulers x 32 lanes, ~160 cycles at 71 lags.
//
// What the design does about it:
// - K lanes per destination state, lane k keeping trans[j, i] for its
//   ceil(n / K) values of j in registers (J slots: that count rounded up to
//   one of the ten widths built), the j-loop fully unrolled and
//   its argmin a tree of contiguous pairs (ceil(log2 J) dependent
//   compare-selects, not J - 1), then log2 K rounds of warp shuffles.  A
//   step is bound by the instructions each warp issues (~4 a candidate),
//   so K is the fewest lanes whose range fits in registers: K = 1 at 71
//   lags (3 warps, 72 transitions a thread, costs read as float4); more
//   lanes measured slower (tools/ablate_pitch.py, PERF.md);
// - the scores of kChunk steps are staged in shared memory by cp.async one
//   chunk ahead, so no step loads from global memory;
// - backpointers are bytes (uint16 above 256 states) in shared memory:
//   70.7 KB for 996 steps x 71 states.  A chain longer than the budget
//   (a long unblocked stream) flushes each full time block of TB steps to
//   a global buffer, coalesced, 16 bytes a thread;
// - the backtrace walks the time blocks from the last, each spilled block
//   first loaded back into shared memory by the whole block, one thread
//   following the pointers there; the path is staged in shared memory and
//   written out coalesced.
// Where K * n exceeds the threads a block may have at that range, or a
// lane's range exceeds kMaxSlots, the lane groups loop over the states and
// read the transitions from shared memory, or from global memory when the
// n * n floats do not fit (n above ~230).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMinLanes = 1;      // K: the fewest lanes a state ...
constexpr int kMaxLanes = 8;      // ... whose range fits in registers
constexpr int kMaxSlots = 72;     // transitions a lane keeps in registers
constexpr int kChunk = 32;        // steps of scores one cp.async group stages
constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* s;       // (B, T, n) scores
  const float* trans;   // (n, n) transition costs, [from j, to i]
  void* spill;          // (B, Tpad, n) backpointers of flushed blocks, or null
  int* path;            // (B, T) output
  int T, n, K, J;       // J = ceil(n / K): the j range of one lane
  int TB;               // steps of backpointers held in shared memory
  int CS;               // steps of scores in one staged chunk
  int trans_in_smem;    // state-loop path: transitions in shared memory
};

// Byte offsets of the shared-memory regions, the same on host and device.
struct Layout {
  size_t cur, scores, trans, path, bp, bytes;
};

__host__ __device__ inline Layout layout(int n, int K, int J, int CS, int TB,
                                         int trans_in_smem, int bp_bytes) {
  Layout l;
  l.cur = 0;                                            // 2 x K*J floats
  l.scores = l.cur + sizeof(float) * 2 * static_cast<size_t>(K) * J;
  l.trans = l.scores + sizeof(float) * 2 * static_cast<size_t>(CS) * n;
  l.path = l.trans +
           (trans_in_smem ? sizeof(float) * static_cast<size_t>(n) * n : 0);
  l.bp = (l.path + sizeof(int) * static_cast<size_t>(TB) + 15) / 16 * 16;
  l.bytes = l.bp + static_cast<size_t>(TB) * n * bp_bytes;
  return l;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The scores of steps [t0, t0 + cnt) into buf, as one cp.async group.
__device__ __forceinline__ void stage_scores(float* buf, const float* s,
                                             int t0, int cnt, int n) {
  const float* src = s + static_cast<long long>(t0) * n;
  for (int i = threadIdx.x; i < cnt * n; i += blockDim.x)
    cp_async4(buf + i, src + i);
  cp_async_commit();
}

// Merge the partial minima of a state's K lanes (lane k holds the first
// argmin of its range, ranges ascending with k): the lower range wins
// ties.  Lane 0 of the group ends with the state's first-index argmin.
__device__ __forceinline__ void merge_lanes(float& best, int& arg, int k,
                                            int K) {
  for (int off = 1; off < K; off <<= 1) {
    const float ov = __shfl_down_sync(kFull, best, off, K);
    const int oa = __shfl_down_sync(kFull, arg, off, K);
    if ((k & (2 * off - 1)) == 0 && ov < best) {
      best = ov;
      arg = oa;
    }
  }
}

// The first argmin of c[LO, HI) as a tree of contiguous pairs, the right
// (higher) half winning only if strictly smaller: ceil(log2(HI - LO))
// dependent compare-selects, not HI - LO - 1.
template <int LO, int HI, int J>
__device__ __forceinline__ void lane_argmin(const float (&c)[J], float& v,
                                            int& a) {
  if constexpr (HI - LO == 1) {
    v = c[LO];
    a = LO;
  } else {
    constexpr int MID = LO + (HI - LO + 1) / 2;
    float v2;
    int a2;
    lane_argmin<LO, MID>(c, v, a);
    lane_argmin<MID, HI>(c, v2, a2);
    if (v2 < v) {
      v = v2;
      a = a2;
    }
  }
}

// Threads a block of the register path may have at J transitions a lane
// (~2J + 32 registers a thread within the SM's 65,536).
__host__ __device__ constexpr int reg_threads(int J) {
  return J <= 0 ? kMaxThreads
                : (65536 / (2 * J + 32) / 32 * 32 < kMaxThreads
                       ? 65536 / (2 * J + 32) / 32 * 32 : kMaxThreads);
}

// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) with the
// whole block.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       size_t bytes) {
  uint4* d = static_cast<uint4*>(dst);
  const uint4* s = static_cast<const uint4*>(src);
  for (size_t i = threadIdx.x; i < bytes / 16; i += blockDim.x) d[i] = s[i];
}

// J > 0: one state per lane group, its transitions in registers (J of
// them per lane).  J == 0: lane groups loop over the states, transitions
// read from shared or global memory.
template <int J, typename BP>
__global__ void __launch_bounds__(reg_threads(J))
    viterbi_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = p.n, K = p.K, jn = J > 0 ? J : p.J, npad = K * jn;
  const Layout lay = layout(n, K, jn, p.CS, p.TB, p.trans_in_smem, sizeof(BP));
  float* cur = reinterpret_cast<float*>(smem + lay.cur);  // cost at t - 1
  float* nxt = cur + npad;                                // cost at t
  float* scores = reinterpret_cast<float*>(smem + lay.scores);
  int* path_s = reinterpret_cast<int*>(smem + lay.path);
  BP* bp = reinterpret_cast<BP*>(smem + lay.bp);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int k = tid % K, groups = nth / K;
  const long long row = static_cast<long long>(blockIdx.x) * p.T;
  const float* s = p.s + row * n;

  const float* tr = p.trans;
  if (J == 0 && p.trans_in_smem) {
    float* t = reinterpret_cast<float*>(smem + lay.trans);
    for (int x = tid; x < n * n; x += nth) t[x] = p.trans[x];
    tr = t;
  }
  // register path: this thread's state and its lane's transitions (0 past
  // the grid; the cost there is +inf, so those candidates never win)
  const int i_reg = tid / K;
  float tv[J > 0 ? J : 1];
#pragma unroll
  for (int m = 0; m < (J > 0 ? J : 1); ++m) {
    const int j = k * jn + m;
    tv[m] = (J > 0 && i_reg < n && j < n) ? p.trans[j * n + i_reg] : 0.0f;
  }
  for (int j = tid; j < npad; j += nth) {
    cur[j] = j < n ? -s[j] : CUDART_INF_F;
    nxt[j] = CUDART_INF_F;
  }
  __syncthreads();   // at T == 1 no step barrier precedes the backtrace
  const int nchunks = (p.T - 1 + p.CS - 1) / p.CS;   // steps 1 .. T-1
  if (nchunks > 0) stage_scores(scores, s, 1, min(p.CS, p.T - 1), n);
  const int q_last = (p.T - 1) / p.TB;
  int r = 1 % p.TB, q = 0;   // step t's backpointer row and time block

  for (int c = 0; c < nchunks; ++c) {
    const int t0 = 1 + c * p.CS, cnt = min(p.CS, p.T - t0);
    if (c + 1 < nchunks) {   // the next chunk goes into the other buffer
      const int t1 = t0 + p.CS;
      stage_scores(scores + ((c + 1) & 1) * p.CS * n, s, t1,
                   min(p.CS, p.T - t1), n);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sc = scores + (c & 1) * p.CS * n;
    for (int u = 0; u < cnt; ++u) {
      const float* st = sc + u * n;
      BP* bpt = bp + static_cast<size_t>(r) * n;
      if constexpr (J > 0) {
        // every built width is a multiple of 4: 16-byte aligned vector loads
        const float* cj = cur + k * jn;
        float cand[J];
#pragma unroll
        for (int m = 0; m < J; m += 4) {
          const float4 c4 = *reinterpret_cast<const float4*>(cj + m);
          cand[m] = __fadd_rn(c4.x, tv[m]);
          cand[m + 1] = __fadd_rn(c4.y, tv[m + 1]);
          cand[m + 2] = __fadd_rn(c4.z, tv[m + 2]);
          cand[m + 3] = __fadd_rn(c4.w, tv[m + 3]);
        }
        float best;
        int arg;
        lane_argmin<0, (J > 0 ? J : 1)>(cand, best, arg);
        arg += k * jn;
        merge_lanes(best, arg, k, K);
        if (k == 0 && i_reg < n) {
          nxt[i_reg] = __fsub_rn(best, st[i_reg]);
          bpt[i_reg] = static_cast<BP>(arg);
        }
      } else {
        const int j0 = k * jn, j1 = min(j0 + jn, n);
        for (int i0 = 0; i0 < n; i0 += groups) {
          const int i = i0 + tid / K, ic = min(i, n - 1);
          float best = CUDART_INF_F;
          int arg = j0;
          for (int j = j0; j < j1; ++j) {
            const float cand =
                __fadd_rn(cur[j], tr[static_cast<size_t>(j) * n + ic]);
            if (cand < best) {
              best = cand;
              arg = j;
            }
          }
          merge_lanes(best, arg, k, K);
          if (k == 0 && i < n) {
            nxt[i] = __fsub_rn(best, st[i]);
            bpt[i] = static_cast<BP>(arg);
          }
        }
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
      if (++r == p.TB) {   // a full time block
        r = 0;
        if (q < q_last) {  // not the last: flush it
          const size_t blk = static_cast<size_t>(p.TB) * n * sizeof(BP);
          const size_t off = (static_cast<size_t>(blockIdx.x) * (q_last + 1) +
                              q) * blk;
          copy16(static_cast<unsigned char*>(p.spill) + off, bp, blk);
          __syncthreads();
        }
        ++q;
      }
    }
  }

  // backtrace, time blocks from the last; cur holds cost_{T-1}
  int kk = 0;
  for (int q = q_last; q >= 0; --q) {
    const int lo = q * p.TB, hi = min(lo + p.TB, p.T);
    if (q < q_last) {
      const size_t blk = static_cast<size_t>(p.TB) * n * sizeof(BP);
      copy16(bp, static_cast<const unsigned char*>(p.spill) +
                     (static_cast<size_t>(blockIdx.x) * (q_last + 1) + q) * blk,
             blk);
      __syncthreads();
    }
    if (tid == 0) {
      if (q == q_last) {
        float best = cur[0];
        for (int i = 1; i < n; ++i) {
          if (cur[i] < best) {
            best = cur[i];
            kk = i;
          }
        }
      }
      for (int t = hi - 1; t >= lo; --t) {
        path_s[t - lo] = kk;
        if (t > 0) kk = bp[static_cast<size_t>(t - lo) * n + kk];
      }
    }
    __syncthreads();
    for (int x = tid; x < hi - lo; x += nth) p.path[row + lo + x] = path_s[x];
    __syncthreads();
  }
}

typedef void (*Kernel)(Params);

// The register-path widths built: 4, 12, 20, ..., 68 (J / 4 odd, so the
// 16-byte cost loads of up to 8 lanes of a state fall in distinct bank
// groups) and kMaxSlots.  A lane's range is padded up to the next width;
// padded slots cost +inf and never win.
__host__ __device__ constexpr int next_width(int J) {
  return J + 8 < kMaxSlots ? J + 8 : kMaxSlots;
}

__host__ __device__ constexpr int built_width(int j) {
  return j > kMaxSlots - 4 ? (j <= kMaxSlots ? kMaxSlots : j)
                           : (j + 3) / 8 * 8 + 4;
}

template <int J>
Kernel byte_kernel(int j) {
  if (j == J) return viterbi_kernel<J, uint8_t>;
  if constexpr (J == kMaxSlots) {
    return nullptr;
  } else {
    return byte_kernel<next_width(J)>(j);
  }
}

// How the kernel runs a (B, T, n) problem on a card with `max_smem` bytes
// of opt-in shared memory a block.
struct Plan {
  int K, J, threads, reg, CS, TB, trans_in_smem, bp_bytes;
  size_t smem;
  long long spill_bytes;
};

cudaError_t plan(int B, int T, int n, int max_smem, Plan* pl) {
  if (B <= 0 || T <= 0 || n <= 0 || n > 65536) return cudaErrorInvalidValue;
  Plan q{};
  // the register path at the fewest lanes that fit, else the state loop
  for (int K = kMinLanes; K <= kMaxLanes && !q.reg; K *= 2) {
    const int threads = (n * K + 31) / 32 * 32;
    const int J = built_width((n + K - 1) / K);
    if (J <= kMaxSlots && threads <= reg_threads(J)) {
      q.K = K;
      q.J = J;
      q.threads = threads;
      q.reg = 1;
    }
  }
  if (!q.reg) {
    q.K = kMaxLanes;
    q.J = (n + q.K - 1) / q.K;
    q.threads = std::min(kMaxThreads, (n * q.K + 31) / 32 * 32);
  }
  q.bp_bytes = n <= 256 ? 1 : 2;
  q.CS = std::min(kChunk, std::max(1, 8192 / n));
  const size_t row = static_cast<size_t>(n) * q.bp_bytes + sizeof(int);
  const size_t fixed = layout(n, q.K, q.J, q.CS, 0, 0, q.bp_bytes).bytes + 16;
  const size_t tr = sizeof(float) * static_cast<size_t>(n) * n;
  if (fixed + 16 * row > static_cast<size_t>(max_smem))
    return cudaErrorInvalidValue;
  q.trans_in_smem =
      !q.reg && fixed + tr + 16 * row <= static_cast<size_t>(max_smem);
  const size_t budget = max_smem - fixed - (q.trans_in_smem ? tr : 0);
  if (static_cast<size_t>(T) * row <= budget) {
    q.TB = T;   // every backpointer stays in shared memory
  } else {      // full blocks of TB steps (a multiple of 16) spill
    q.TB = static_cast<int>(budget / row) / 16 * 16;
    const long long blocks = (T - 1) / q.TB + 1;
    q.spill_bytes = static_cast<long long>(B) * blocks * q.TB * n * q.bp_bytes;
  }
  q.smem = layout(n, q.K, q.J, q.CS, q.TB, q.trans_in_smem, q.bp_bytes).bytes;
  *pl = q;
  return cudaSuccess;
}

cudaError_t device_plan(int B, int T, int n, Plan* pl) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  return plan(B, T, n, max_smem, pl);
}

}  // namespace

// Plain C interface (loaded with ctypes).
//
// mfcc_viterbi_plan: the launch shape for (B, T, n) into shape[0..5] (K,
// J, threads, register path, TB, score chunk) and the bytes of the spill
// buffer the launch needs (0: none); a negative cudaError_t on failure.
extern "C" long long mfcc_viterbi_plan(int B, int T, int n, int* shape) {
  Plan pl;
  const cudaError_t err = device_plan(B, T, n, &pl);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  const int out[6] = {pl.K, pl.J, pl.threads, pl.reg, pl.TB, pl.CS};
  for (int i = 0; i < 6; ++i) shape[i] = out[i];
  return pl.spill_bytes;
}

// mfcc_fused_viterbi: launches on `stream` and does not synchronize.
// `spill` holds mfcc_viterbi_plan's bytes (null when it says 0).  Returns
// a cudaError_t; 0 is success.
extern "C" int mfcc_fused_viterbi(const float* s, const float* trans,
                                  void* spill, int* path, int B, int T, int n,
                                  void* stream) {
  Plan pl;
  cudaError_t err = device_plan(B, T, n, &pl);
  if (err != cudaSuccess) return err;
  if (pl.spill_bytes > 0 && spill == nullptr) return cudaErrorInvalidValue;
  Kernel kernel = pl.reg ? byte_kernel<4>(pl.J)
                         : pl.bp_bytes == 1 ? viterbi_kernel<0, uint8_t>
                                            : viterbi_kernel<0, uint16_t>;
  if (kernel == nullptr) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pl.smem));
  if (err != cudaSuccess) return err;
  const Params p{s, trans, spill, path, T, n, pl.K, pl.J, pl.TB, pl.CS,
                 pl.trans_in_smem};
  kernel<<<B, pl.threads, pl.smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

extern "C" const char* mfcc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
