// [static, delta, delta-delta] in one pass, for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes the deltas in plain
// jnp (mfcc_tpu/ops/deltas.py), which XLA fuses on the TPU.  Its plain
// PyTorch twin (ops/deltas.plain_append_deltas) runs on the card as two
// deltas calls of ~20 elementwise ATen passes each and a cat; this kernel
// writes the same (B, T, 3F) output in one launch, equal in every bit.
//
// For one row, with cap = min(max(length, 1), T) - 1 (T - 1 without
// lengths), window W and denom = 2 sum_{n=1..W} n^2 rounded to float32:
//   d[t] = (sum_{n=1..W} n (f[min(t + n, cap)] - f[max(t - n, 0)])) / denom
// for every t in [0, T), padded frames past cap too (there the plain chain's
// `where` reads f[cap] for every forward neighbour, as min() does here);
// delta-delta is the same formula applied to d.  The plain chain's order
// and roundings are kept: acc = 0 + 1 (p - m), then acc + n (p - m) for
// n = 2..W, then a true division, each through an _rn intrinsic, which nvcc
// never contracts into an FMA (at W = 3, an FMA of 3 (p - m) + acc rounds
// once where torch's mul and add round twice).
//
// What bounds it on the card: bytes.  It reads the static features once
// and writes the output once, about 2 flops a byte at W = 2: at a mean
// sorted batch of the benchmark (256 x ~1,350 x 80 float32) 110.6 MB in and
// 331.8 MB out, 0.132 ms at 3.35 TB/s.
//
// What the design does about it:
// - one block per (row, tile of TT frames, chunk of FC columns; FC = F up
//   to 128 columns), which stages in shared memory the tile's static frames
//   with a halo of 2W on each side and the W + 1 frames ending at the row's
//   cap, read as 16-byte loads where F % 4 == 0 (scalar loads otherwise);
// - delta for the tile and a halo of W on each side, and delta at cap, then
//   delta-delta for the tile, each from shared memory into shared memory:
//   no intermediate touches device memory, and the halo is re-read from L2
//   by the neighbouring tile, not recomputed from device memory;
// - the tile's output rows [static | delta | delta-delta] are one
//   contiguous span of TT x 3F floats (FC = F), written by consecutive
//   threads as 16-byte stores.
// A tile of padded frames past its row's cap by more than W finds f[cap]
// and d[cap] outside its halo: those come from the cap frames.  Nothing is
// read from the host, so the launch needs no synchronisation.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFrames = 32;      // TT, halved while shared memory is short
constexpr int kMaxCols = 128;        // FC: columns a block stages
constexpr size_t kSmemBudget = 48 * 1024;   // dynamic shared memory, no opt-in

struct Params {
  const float* f;        // (B, T, F) static features
  const int* lengths;    // (B,) frame counts, or null
  float* out;            // (B, T, 3F)
  int T, F, W, TT, FC, n_tiles;
  float denom;
};

template <int V>
struct Vec {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load(const float* p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r.v[0] = q.x;
    r.v[1] = q.y;
    r.v[2] = q.z;
    r.v[3] = q.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store(float* p, const Vec<V>& a) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2],
                                                a.v[3]);
  } else {
    *p = a.v[0];
  }
}

// acc + n (p - m), rounded after each operation as the plain chain rounds
template <int V>
__device__ __forceinline__ void accumulate(Vec<V>& acc, float n,
                                           const Vec<V>& p, const Vec<V>& m) {
#pragma unroll
  for (int k = 0; k < V; ++k)
    acc.v[k] = __fadd_rn(acc.v[k], __fmul_rn(n, __fsub_rn(p.v[k], m.v[k])));
}

template <int V>
__device__ __forceinline__ Vec<V> divided(Vec<V> acc, float denom) {
#pragma unroll
  for (int k = 0; k < V; ++k) acc.v[k] = __fdiv_rn(acc.v[k], denom);
  return acc;
}

template <int V>
__device__ __forceinline__ Vec<V> zero() {
  Vec<V> r;
#pragma unroll
  for (int k = 0; k < V; ++k) r.v[k] = 0.0f;
  return r;
}

// Shared memory, rows of FC floats: static frames s0 .. s0 + TT + 4W - 1
// (s0 = t0 - 2W), then the cap frames max(cap - W + k, 0) for k = 0..W;
// deltas of frames d0 .. d0 + TT + 2W - 1 (d0 = t0 - W), then delta at cap;
// then the tile's delta-deltas.  Frames outside [0, T) are staged clipped
// into it and never read by a frame inside it.
template <int V>
__global__ void __launch_bounds__(kThreads)
append_deltas_tile_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int W = p.W, TT = p.TT, T = p.T, F = p.F, FC = p.FC;
  const int b = blockIdx.x / p.n_tiles;
  const int t0 = (blockIdx.x - b * p.n_tiles) * TT;
  const int c0 = blockIdx.y * FC;
  const int nv = min(FC, F - c0) / V;   // vectors of a frame in this chunk
  const int cap = p.lengths ? min(max(p.lengths[b], 1), T) - 1 : T - 1;
  const int NS = TT + 4 * W, ND = TT + 2 * W;
  const int s0 = t0 - 2 * W, d0 = t0 - W;
  float* sF = reinterpret_cast<float*>(smem4);
  float* sC = sF + NS * FC;              // f[cap] is row W
  float* sD = sC + (W + 1) * FC;
  float* sDc = sD + ND * FC;             // d[cap]
  float* sDD = sDc + FC;
  const float* f = p.f + static_cast<size_t>(b) * T * F + c0;

  for (int i = threadIdx.x; i < (NS + W + 1) * nv; i += blockDim.x) {
    const int r = i / nv, c = (i - r * nv) * V;
    const int g = r < NS ? s0 + r : cap - W + (r - NS);
    store<V>(sF + r * FC + c,
             load<V>(f + static_cast<size_t>(min(max(g, 0), T - 1)) * F + c));
  }
  __syncthreads();

  for (int i = threadIdx.x; i < (ND + 1) * nv; i += blockDim.x) {
    const int r = i / nv, c = (i - r * nv) * V;
    Vec<V> acc = zero<V>();
    if (r < ND) {
      const int j = d0 + r;
      for (int n = 1; n <= W; ++n) {
        const int gp = min(j + n, cap), gm = max(j - n, 0);
        const float* pp = gp >= s0 ? sF + (gp - s0) * FC : sC + W * FC;
        accumulate<V>(acc, static_cast<float>(n), load<V>(pp + c),
                      load<V>(sF + (gm - s0) * FC + c));
      }
      store<V>(sD + r * FC + c, divided<V>(acc, p.denom));
    } else {
      for (int n = 1; n <= W; ++n)
        accumulate<V>(acc, static_cast<float>(n), load<V>(sC + W * FC + c),
                      load<V>(sC + (W - n) * FC + c));
      store<V>(sDc + c, divided<V>(acc, p.denom));
    }
  }
  __syncthreads();

  const int nt = min(TT, T - t0);
  for (int i = threadIdx.x; i < nt * nv; i += blockDim.x) {
    const int r = i / nv, c = (i - r * nv) * V;
    const int t = t0 + r;
    Vec<V> acc = zero<V>();
    for (int n = 1; n <= W; ++n) {
      const int gp = min(t + n, cap), gm = max(t - n, 0);
      const float* pp = gp >= d0 ? sD + (gp - d0) * FC : sDc;
      accumulate<V>(acc, static_cast<float>(n), load<V>(pp + c),
                    load<V>(sD + (gm - d0) * FC + c));
    }
    store<V>(sDD + r * FC + c, divided<V>(acc, p.denom));
  }
  __syncthreads();

  float* out = p.out + (static_cast<size_t>(b) * T + t0) * 3 * F + c0;
  for (int i = threadIdx.x; i < nt * 3 * nv; i += blockDim.x) {
    const int r = i / (3 * nv), q = i - r * 3 * nv;
    const int s = q / nv, c = (q - s * nv) * V;
    const float* src = s == 0   ? sF + (r + 2 * W) * FC
                       : s == 1 ? sD + (r + W) * FC
                                : sDD + r * FC;
    store<V>(out + static_cast<size_t>(r) * 3 * F + s * F + c,
             load<V>(src + c));
  }
}

size_t smem_bytes(int TT, int FC, int W) {
  return static_cast<size_t>(3 * TT + 7 * W + 2) * FC * sizeof(float);
}

struct Tile {
  int TT, FC, V;   // frames, columns, floats a load
};

// The tile for F columns at window W >= 0: 16-byte loads where F % 4 == 0
// and both arrays are 16-byte aligned; kTileFrames frames of up to
// kMaxCols columns, the frames halved, then the columns, while shared
// memory exceeds the budget.  False where one frame of V columns does.
bool plan(int F, int W, bool aligned, Tile* t) {
  t->V = F % 4 == 0 && aligned ? 4 : 1;
  t->TT = kTileFrames;
  t->FC = std::min(F, kMaxCols);
  while (t->TT > 1 && smem_bytes(t->TT, t->FC, W) > kSmemBudget) t->TT /= 2;
  while (t->FC > t->V && smem_bytes(t->TT, t->FC, W) > kSmemBudget)
    t->FC = std::max(t->V, t->FC / 2 / t->V * t->V);
  return smem_bytes(t->TT, t->FC, W) <= kSmemBudget;
}

}  // namespace

// Plain C interface (loaded with ctypes).
//
// mfcc_append_deltas: f (B, T, F) float32 contiguous, lengths (B,) int32 on
// the card or null, out (B, T, 3F) float32; window W (W < 1 is W = 0, as
// the plain chain's empty sum), denom its float32 divisor.  Launches on
// `stream` and does not synchronize.  Returns a cudaError_t; 0 is success.
extern "C" int mfcc_append_deltas(const float* f, const int* lengths,
                                  float* out, int B, int T, int F, int W,
                                  float denom, void* stream) {
  if (B < 0 || T < 0 || F < 1) return cudaErrorInvalidValue;
  W = std::max(W, 0);
  Tile t;
  if (!plan(F, W,
            reinterpret_cast<uintptr_t>(f) % 16 == 0 &&
                reinterpret_cast<uintptr_t>(out) % 16 == 0,
            &t))
    return cudaErrorInvalidValue;
  if (B == 0 || T == 0) return cudaSuccess;
  const int n_tiles = (T + t.TT - 1) / t.TT;
  const long long blocks = static_cast<long long>(B) * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const Params p{f, lengths, out, T, F, W, t.TT, t.FC, n_tiles, denom};
  const dim3 grid(static_cast<unsigned>(blocks), (F + t.FC - 1) / t.FC);
  const size_t smem = smem_bytes(t.TT, t.FC, W);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t.V == 4)
    append_deltas_tile_kernel<4><<<grid, kThreads, smem, s>>>(p);
  else
    append_deltas_tile_kernel<1><<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

extern "C" const char* mfcc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
