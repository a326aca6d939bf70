// Fused raw-audio MFCC kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   mfcc_tpu/ops/kernels/fused_raw_dit.py::fused_features_raw_dit
// with projection="mel" and apply_dct=True: raw (B, N) float32 audio in,
// (B, T, n_out) float32 cepstra out.  One launch reads the audio once and
// writes the features once; pre-emphasis, window, DFT power, mel
// projection, absolute and relative floors, accurate log, lifter-folded DCT
// and the optional log-energy c0 all happen on chip.
//
// What bounds it on the card: fp32 FMA throughput.  In direct form a
// 400-sample frame against 256 cos + 256 sin columns is 400 * 512 FMAs,
// about 0.41 MFLOP per frame; the mel (257 x 26) and DCT (26 x 13) stages
// add under 4 %.  The audio (4 B/sample, read ~once) and the features
// (52 B/frame) are a few hundred bytes per frame, three orders of magnitude
// under the FMA work, so memory bandwidth is not the limit.  The contract is
// true fp32 (matmul_precision="highest"), so this kernel uses no tensor
// cores and no TF32.
//
// What the design does about it: a register-tiled outer product.  A block of
// 256 threads owns TM = 8*FR frames of one utterance and all DFT bins of a
// 256-bin block.  Each thread keeps FR frames x 8 bins x (cos, sin) = 16*FR
// fp32 accumulators; per basis row it reads FR broadcast samples and four
// conflict-free float4 basis vectors from shared memory and issues 16*FR
// FMAs.  The tile's audio span (with each frame's true predecessor sample)
// is staged and pre-emphasized once in shared memory; the window-folded
// bases stream from L2 in 16-row chunks.  The TPU layout (parity
// deinterleave, lane-phase periods, roll+select assembly, packed bin
// permutation, LEAD rows) does not carry over: bins stay in natural order and
// the plain mel matrix is used.  The last bin (Nyquist for even n_fft) is a
// separate per-frame dot product, so the main product stays at exactly
// 256-column blocks.
//
// Numerics: the accurate log and the pre-emphasis are spelled with
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn so nvcc contracts none of
// their steps into FMAs; they round exactly as the plain PyTorch version
// does.  Only the DFT/mel/DCT summation order differs from the plain path.
// Build without --use_fast_math (it makes division approximate).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 256;    // DFT bins per bin block
constexpr int kCols = 2 * kBins;  // basis columns per block: cos | sin
constexpr int kChunk = 16;    // basis rows staged per step

struct Params {
  const float* x;      // (B, N) raw audio
  const float* basis;  // (nbb, frame_len, 512) window-folded [cos | sin]
  const float* last;   // (frame_len, 2) window-folded cos/sin, last bin
  const float* melw;   // (n_bins, n_mels)
  const float* dctm;   // (n_mels, n_out) lifter-folded DCT-II
  float* out;          // (B, T, n_out)
  long long N;
  int T, tiles, nbb, frame_len, hop, n_bins, n_mels, n_out, span;
  float preemph, log_floor, rel_floor;
  int append_energy;
};

// The f32 values of the reference's constants (mfcc_tpu/ops/xmath.py):
// sqrt(2), ln 2, 2/9, 2/7, 2/5, 2/3 rounded to float32.
__device__ __forceinline__ float acc_log(float x) {
  const float kSqrt2 = 0x1.6a09e6p+0f;
  const float kLn2 = 0x1.62e430p-1f;
  const float kC9 = 0x1.c71c72p-3f, kC7 = 0x1.24924ap-2f;
  const float kC5 = 0x1.99999ap-2f, kC3 = 0x1.555556p-1f;
  const int bits = __float_as_int(x);
  int e = ((bits >> 23) & 0xFF) - 127;
  float m = __int_as_float((bits & 0x007FFFFF) | 0x3F800000);
  if (m >= kSqrt2) {  // centre the mantissa in [sqrt(2)/2, sqrt(2))
    m = __fmul_rn(m, 0.5f);
    e += 1;
  }
  const float r = __fdiv_rn(__fsub_rn(m, 1.0f), __fadd_rn(m, 1.0f));
  const float r2 = __fmul_rn(r, r);
  float p = __fadd_rn(__fmul_rn(kC9, r2), kC7);
  p = __fadd_rn(__fmul_rn(p, r2), kC5);
  p = __fadd_rn(__fmul_rn(p, r2), kC3);
  p = __fadd_rn(__fmul_rn(p, r2), 2.0f);
  return __fadd_rn(__fmul_rn(static_cast<float>(e), kLn2), __fmul_rn(r, p));
}

template <int FR>
struct Tile {
  static constexpr int TM = 8 * FR;  // frames per block
  // shared buffer: a basis chunk (kChunk x 512), later the power (TM x 256)
  static constexpr int kBuf = kChunk * kCols > TM * kBins ? kChunk * kCols
                                                         : TM * kBins;
  static int span(int frame_len, int hop) {
    const int fl_pad = (frame_len + kChunk - 1) / kChunk * kChunk;
    return ((TM - 1) * hop + fl_pad + 3) / 4 * 4;
  }
  static size_t smem_bytes(int span, int n_mels) {
    return sizeof(float) *
           (static_cast<size_t>(kBuf) + span + TM * n_mels + 2 * TM);
  }
};

template <int FR>
__global__ void __launch_bounds__(kThreads, 1) mfcc_kernel(const Params p) {
  constexpr int TM = Tile<FR>::TM;
  extern __shared__ __align__(16) float smem[];
  float* buf = smem;
  float* z = buf + Tile<FR>::kBuf;    // pre-emphasized audio span
  float* mel = z + p.span;            // (TM, n_mels) mel energies, then logs
  float* rowv = mel + TM * p.n_mels;  // (TM) last-bin power, then floor
  float* en = rowv + TM;              // (TM) frame energy

  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int b = blockIdx.x / p.tiles;
  const int t0 = (blockIdx.x % p.tiles) * TM;
  const float* xb = p.x + static_cast<long long>(b) * p.N;
  const long long s0 = static_cast<long long>(t0) * p.hop;

  // ---- stage + pre-emphasize the span; every sample takes its true
  // predecessor from the signal, only sample 0 of the row takes x[0] ----
  for (int i = tid; i < p.span; i += kThreads) {
    const long long g = s0 + i;
    float v = 0.0f;
    if (g < p.N) {
      v = xb[g];
      if (p.preemph != 0.0f) {
        const float prev = g > 0 ? xb[g - 1] : v;
        v = __fsub_rn(v, __fmul_rn(p.preemph, prev));
      }
    }
    z[i] = v;
  }
  for (int i = tid; i < TM * p.n_mels; i += kThreads) mel[i] = 0.0f;
  __syncthreads();

  const int main_bins = p.n_bins - 1;
  for (int bb = 0; bb < p.nbb; ++bb) {
    float ac[FR][8], as[FR][8];
#pragma unroll
    for (int i = 0; i < FR; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ac[i][j] = 0.0f;
        as[i][j] = 0.0f;
      }
    }
    const float* basis =
        p.basis + static_cast<long long>(bb) * p.frame_len * kCols;
    for (int k0 = 0; k0 < p.frame_len; k0 += kChunk) {
      float4* b4 = reinterpret_cast<float4*>(buf);
      for (int i = tid; i < kChunk * (kCols / 4); i += kThreads) {
        const int r = i / (kCols / 4), c4 = i % (kCols / 4);
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (k0 + r < p.frame_len)
          v = __ldg(reinterpret_cast<const float4*>(
                        basis + static_cast<long long>(k0 + r) * kCols) + c4);
        b4[i] = v;
      }
      __syncthreads();
      const float* zf = z + ty * FR * p.hop + k0;
#pragma unroll 4
      for (int kk = 0; kk < kChunk; ++kk) {
        float a[FR];
#pragma unroll
        for (int i = 0; i < FR; ++i) a[i] = zf[i * p.hop + kk];
        const float4* row = reinterpret_cast<const float4*>(buf + kk * kCols);
        const float4 c0 = row[tx], c1 = row[32 + tx];
        const float4 s0v = row[64 + tx], s1v = row[96 + tx];
        const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        const float sv[8] = {s0v.x, s0v.y, s0v.z, s0v.w,
                             s1v.x, s1v.y, s1v.z, s1v.w};
#pragma unroll
        for (int i = 0; i < FR; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            ac[i][j] = fmaf(a[i], cv[j], ac[i][j]);
            as[i][j] = fmaf(a[i], sv[j], as[i][j]);
          }
        }
      }
      __syncthreads();
    }

    // ---- |X|^2 of this bin block -> buf as (TM, 256), natural bin order
    float4* pw = reinterpret_cast<float4*>(buf);
#pragma unroll
    for (int i = 0; i < FR; ++i) {
      float pv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        pv[j] = ac[i][j] * ac[i][j] + as[i][j] * as[i][j];
      const int m = ty * FR + i;
      pw[m * (kBins / 4) + tx] = make_float4(pv[0], pv[1], pv[2], pv[3]);
      pw[m * (kBins / 4) + 32 + tx] = make_float4(pv[4], pv[5], pv[6], pv[7]);
    }
    __syncthreads();

    // ---- mel projection of this bin block, accumulated over blocks ----
    const int nb = min(kBins, main_bins - bb * kBins);
    const float* w0 = p.melw + static_cast<long long>(bb) * kBins * p.n_mels;
    for (int o = tid; o < TM * p.n_mels; o += kThreads) {
      const int m = o / p.n_mels, j = o - m * p.n_mels;
      const float* pr = buf + m * kBins;
      float acc = mel[o];
      for (int c = 0; c < nb; ++c)
        acc = fmaf(pr[c], __ldg(w0 + static_cast<long long>(c) * p.n_mels + j),
                   acc);
      mel[o] = acc;
    }
    __syncthreads();
  }

  // ---- last bin (Nyquist for even n_fft) and the unwindowed energy of the
  // pre-emphasized frame: G threads per frame, then a shuffle reduction ----
  {
    constexpr int G = kThreads / TM;
    const int m = tid / G, l = tid % G;
    const float* zm = z + m * p.hop;
    float sc = 0.0f, ss = 0.0f, se = 0.0f;
    for (int k = l; k < p.frame_len; k += G) {
      const float v = zm[k];
      sc = fmaf(v, __ldg(p.last + 2 * k), sc);
      ss = fmaf(v, __ldg(p.last + 2 * k + 1), ss);
      se = fmaf(v, v, se);
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      sc += __shfl_xor_sync(0xffffffffu, sc, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      se += __shfl_xor_sync(0xffffffffu, se, off);
    }
    if (l == 0) {
      rowv[m] = sc * sc + ss * ss;
      en[m] = se;
    }
  }
  __syncthreads();
  for (int o = tid; o < TM * p.n_mels; o += kThreads) {
    const int m = o / p.n_mels, j = o - m * p.n_mels;
    mel[o] = fmaf(rowv[m],
                  __ldg(p.melw + static_cast<long long>(main_bins) * p.n_mels + j),
                  mel[o]);
  }
  __syncthreads();

  // ---- floors: the reference takes e = max(e, rel) with rel = max_j(e) *
  // rel_floor, then log(max(e, log_floor)); max is exact, so one per-frame
  // floor max(log_floor, rel) gives the same bits ----
  for (int m = tid; m < TM; m += kThreads) {
    float f = p.log_floor;
    if (p.rel_floor > 0.0f) {
      float mx = mel[m * p.n_mels];
      for (int j = 1; j < p.n_mels; ++j) mx = fmaxf(mx, mel[m * p.n_mels + j]);
      f = fmaxf(f, __fmul_rn(mx, p.rel_floor));
    }
    rowv[m] = f;
  }
  __syncthreads();
  for (int o = tid; o < TM * p.n_mels; o += kThreads)
    mel[o] = acc_log(fmaxf(mel[o], rowv[o / p.n_mels]));
  __syncthreads();

  // ---- DCT (lifter folded in), optional log energy in c0, write ----
  for (int o = tid; o < TM * p.n_out; o += kThreads) {
    const int m = o / p.n_out, c = o - m * p.n_out;
    if (t0 + m >= p.T) continue;
    float v;
    if (p.append_energy && c == 0) {
      v = acc_log(fmaxf(en[m], p.log_floor));
    } else {
      v = 0.0f;
      for (int j = 0; j < p.n_mels; ++j)
        v = fmaf(mel[m * p.n_mels + j], __ldg(p.dctm + j * p.n_out + c), v);
    }
    p.out[(static_cast<long long>(b) * p.T + t0 + m) * p.n_out + c] = v;
  }
}

// Launch with FR frames per thread if its shared memory fits; *launched
// says whether it did.
template <int FR>
cudaError_t try_launch(Params p, int B, int max_smem, cudaStream_t stream,
                       bool* launched) {
  constexpr int TM = Tile<FR>::TM;
  *launched = false;
  p.span = Tile<FR>::span(p.frame_len, p.hop);
  const size_t bytes = Tile<FR>::smem_bytes(p.span, p.n_mels);
  if (bytes > static_cast<size_t>(max_smem)) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      mfcc_kernel<FR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  p.tiles = (p.T + TM - 1) / TM;
  const long long blocks = static_cast<long long>(p.tiles) * B;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  mfcc_kernel<FR><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(p);
  *launched = true;
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 is
// success.  Launches on `stream` and does not synchronize.
extern "C" int mfcc_fused_raw_dit(
    const float* x, int B, long long N, int T, const float* basis, int nbb,
    const float* last, const float* melw, const float* dctm, float* out,
    int frame_len, int hop, int n_bins, int n_mels, int n_out, float preemph,
    float log_floor, float rel_floor, int append_energy, void* stream) {
  if (B <= 0 || T <= 0 || frame_len <= 0 || hop <= 0 || n_bins < 1 ||
      nbb != (n_bins - 1 + kBins - 1) / kBins || n_mels <= 0 || n_out <= 0)
    return cudaErrorInvalidValue;
  Params p{x, basis, last, melw, dctm, out, N, T, 0, nbb, frame_len, hop,
           n_bins, n_mels, n_out, 0, preemph, log_floor, rel_floor,
           append_energy};
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool launched = false;
  // the largest frame tile whose audio span fits in shared memory
  if ((err = try_launch<8>(p, B, max_smem, s, &launched)) || launched) return err;
  if ((err = try_launch<4>(p, B, max_smem, s, &launched)) || launched) return err;
  if ((err = try_launch<2>(p, B, max_smem, s, &launched)) || launched) return err;
  if ((err = try_launch<1>(p, B, max_smem, s, &launched)) || launched) return err;
  return cudaErrorInvalidConfiguration;
}

extern "C" const char* mfcc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
