"""``ops/deltas`` and ``kernels/fused_deltas`` on the CPU: the clip formula
of the kernel's note, written as numpy index arrays, against the plain
chain bit for bit; the kernel's source built for the host with g++ (its
blocks run one after another, each thread's loop run by one thread, which
is what a block's barriers allow) against the plain chain bit for bit; the
route ``append_deltas`` takes; the plain chain's divisor.  The card's own
cases (``tests/test_torch_cuda.py``) take ``CASES`` and :func:`case` from
here.  Imports no jax."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from mfcc_tpu_torch import FeatureConfig, backend
from mfcc_tpu_torch.ops import deltas
from mfcc_tpu_torch.ops.kernels import fused_deltas, routes

# (layout, T): a ragged batch whose frame counts are 0, 1, 2, 3, 4, 5, 2W,
# 2W + 1 and T (at T = 70 the later tiles of the short rows lie wholly past
# their last valid frame); T = 1; T < 2W; one (T, F) utterance and a batch,
# both without frame counts
LAYOUTS = (("ragged", 70), ("one_frame", 1), ("short", 3), ("utterance", 37),
           ("batch", 45))
CASES = [(layout, T, F, W) for layout, T in LAYOUTS for F in (1, 13, 26, 80)
         for W in (1, 2, 3)]


def case(layout: str, T: int, F: int, W: int, seed: int = 0):
    """-> (features float32, frame counts int32 or None) of a CASES case."""
    rng = np.random.default_rng([seed, T, F, W])
    if layout == "ragged":
        lens = np.array([0, 1, 2, 3, 4, 5, 2 * W, 2 * W + 1, T], np.int32)
    elif layout in ("one_frame", "short"):
        lens = np.array([T, max(T - 1, 0), 0], np.int32)
    else:
        lens = None
    B = 4 if lens is None else len(lens)
    shape = (T, F) if layout == "utterance" else (B, T, F)
    return rng.standard_normal(shape).astype(np.float32), lens


def _formula(f: np.ndarray, W: int, lens) -> np.ndarray:
    """d[t] = (sum_n n (f[min(t + n, cap)] - f[max(t - n, 0)])) / denom,
    cap = max(length, 1) - 1 (T - 1 without lengths), in float32, the
    plain chain's order: 0 + 1 (p - m), then + n (p - m), then divide."""
    T = f.shape[-2]
    cap = (np.full(f.shape[:-2], T - 1) if lens is None
           else np.maximum(lens, 1) - 1)
    t = np.arange(T)
    acc = np.zeros_like(f)
    for n in range(1, W + 1):
        plus = np.take_along_axis(
            f, np.minimum(t + n, cap[..., None])[..., None], axis=-2)
        minus = f[..., np.maximum(t - n, 0), :]
        acc = acc + np.float32(n) * (plus - minus)
    return acc / np.float32(fused_deltas.denominator(W))


@pytest.mark.parametrize("layout,T,F,W", CASES)
def test_clip_formula_equals_plain_chain(layout, T, F, W):
    f, lens = case(layout, T, F, W)
    d1 = _formula(f, W, lens)
    want = np.concatenate([f, d1, _formula(d1, W, lens)], axis=-1)
    got = deltas.plain_append_deltas(
        torch.from_numpy(f), W,
        None if lens is None else torch.from_numpy(lens))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


# the kernel's source for the host: CUDA's names as plain C++, each block's
# threads one thread, its shared memory filled with NaN (a read of a row no
# thread staged shows in the output), AddressSanitizer on every array
HOST_PRELUDE = r"""
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(n)
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct Index { unsigned x, y, z; };
Index threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};
inline void __syncthreads() {}
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
float4* g_smem = nullptr;
"""
HOST_MAIN = r"""
template <typename T>
std::vector<T> slurp(const char* path, size_t n) {
  std::vector<T> v(n);
  FILE* fp = fopen(path, "rb");
  if (n && fread(v.data(), sizeof(T), n, fp) != n) exit(3);
  fclose(fp);
  return v;
}

int main(int argc, char** argv) {
  // dir B T F W has_lengths aligned denom
  const std::string dir = argv[1];
  const int B = atoi(argv[2]), T = atoi(argv[3]), F = atoi(argv[4]);
  const int W = std::max(atoi(argv[5]), 0), has_len = atoi(argv[6]);
  const float denom = static_cast<float>(atof(argv[8]));
  Tile t;
  if (!plan(F, W, atoi(argv[7]) != 0, &t)) { printf("refused\n"); return 0; }
  std::vector<float> f = slurp<float>((dir + "/f.bin").c_str(),
                                      size_t(B) * T * F);
  std::vector<int> len = slurp<int>((dir + "/len.bin").c_str(),
                                    has_len ? B : 0);
  std::vector<float> out(size_t(B) * T * 3 * F);
  const int n_tiles = (T + t.TT - 1) / t.TT;
  const Params p{f.data(), has_len ? len.data() : nullptr, out.data(), T, F,
                 W, t.TT, t.FC, n_tiles, denom};
  const size_t n4 = (smem_bytes(t.TT, t.FC, W) + 15) / 16;
  for (unsigned y = 0; y < unsigned((F + t.FC - 1) / t.FC); ++y)
    for (unsigned x = 0; x < unsigned(B * n_tiles); ++x) {
      std::vector<float4> smem(n4, {NAN, NAN, NAN, NAN});
      g_smem = smem.data();
      blockIdx = {x, y, 0};
      if (t.V == 4) append_deltas_tile_kernel<4>(p);
      else append_deltas_tile_kernel<1>(p);
    }
  FILE* fp = fopen((dir + "/out.bin").c_str(), "wb");
  fwrite(out.data(), sizeof(float), out.size(), fp);
  fclose(fp);
  printf("%d %d %d\n", t.TT, t.FC, t.V);
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``csrc/fused_deltas.cu``'s kernel and planner (the source between
    its namespace's braces) built for the host with g++: (features, frame
    counts or None, W, aligned) -> (output, (TT, FC, V)), or None where
    the planner refuses."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a C++ compiler (the port's native WAV decoder needs one)"
    src = (Path(fused_deltas.__file__).parent / "csrc" / "fused_deltas.cu"
           ).read_text()
    body = src[src.index("namespace {"):src.index("}  // namespace") + 1]
    shared = "extern __shared__ float4 smem4[];"
    assert body.count(shared) == 1
    body = body.replace(shared, "float4* smem4 = g_smem;")
    d = tmp_path_factory.mktemp("fused_deltas")
    (d / "host.cpp").write_text("#include <string>\n" + HOST_PRELUDE + body
                                + HOST_MAIN)
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off",
                    "-fno-strict-aliasing", "-fsanitize=address",
                    "-o", str(d / "host"), str(d / "host.cpp")], check=True)

    def run(f, lens, W, aligned=True):
        *lead, T, F = f.shape
        B = int(np.prod(lead, dtype=np.int64))
        f.astype(np.float32).tofile(d / "f.bin")
        if lens is not None:
            np.asarray(lens, np.int32).tofile(d / "len.bin")
        out = subprocess.run(
            [str(d / "host"), str(d), str(B), str(T), str(F), str(W),
             str(int(lens is not None)), str(int(aligned)),
             repr(fused_deltas.denominator(W))],
            check=True, capture_output=True, text=True).stdout.split()
        if out == ["refused"]:
            return None
        got = np.fromfile(d / "out.bin", np.float32).reshape(*lead, T, 3 * F)
        return got, tuple(map(int, out))
    return run


def _plain(f, lens, W) -> np.ndarray:
    return deltas.plain_append_deltas(
        torch.from_numpy(f), W,
        None if lens is None else torch.from_numpy(lens)).numpy()


@pytest.mark.parametrize("layout,T,F,W", CASES)
def test_host_built_kernel_equals_plain_chain(host_kernel, layout, T, F, W):
    f, lens = case(layout, T, F, W)
    got, tile = host_kernel(f, lens, W)
    assert tile == (32, F, 4 if F % 4 == 0 else 1)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _plain(f, lens, W).view(np.uint32))


@pytest.mark.parametrize("F,W,aligned,tile", [
    (80, 2, False, (32, 80, 1)),    # a misaligned array: scalar loads
    (80, 9, True, (16, 80, 4)),     # a wide window halves the frames
    (300, 2, True, (16, 128, 4)),   # three column chunks, the last of 44
    (257, 1, True, (16, 128, 1)),   # an odd width: scalar chunks
    (4, 438, True, (1, 4, 4)),      # a window that leaves one frame
])
def test_host_built_kernel_tiles(host_kernel, F, W, aligned, tile):
    """The planner's other tiles (frames halved, columns chunked, scalar
    loads), each equal to the plain chain on a ragged batch."""
    rng = np.random.default_rng(F + W)
    T = 75
    f = rng.standard_normal((3, T, F)).astype(np.float32)
    lens = np.array([T, 7, 0], np.int32)
    got, planned = host_kernel(f, lens, W, aligned)
    assert planned == tile
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _plain(f, lens, W).view(np.uint32))


def test_host_built_kernel_refuses_a_window_past_shared_memory(host_kernel):
    f = np.zeros((1, 4, 4), np.float32)
    assert host_kernel(f, None, 439) is None


BITS = {torch.float32: torch.int32, torch.float64: torch.int64,
        torch.bfloat16: torch.int16, torch.float16: torch.int16}


def _seed_deltas(feat, window, lengths):
    """``ops/deltas.deltas`` as it was before its divisor was made on the
    device: divided by ``torch.tensor(denom)``, a copy from the host."""
    T = feat.shape[-2]
    denom = 2.0 * sum(n * n for n in range(1, window + 1))
    t = torch.arange(T, device=feat.device)
    if lengths is not None:
        hi_cap = torch.clamp(lengths.to(feat.device, torch.int64), min=1) - 1
        last = torch.gather(
            feat, -2, hi_cap[..., None, None].expand(
                *feat.shape[:-2], 1, feat.shape[-1]))
    out = torch.zeros_like(feat)
    for n in range(1, window + 1):
        plus = torch.cat(
            [feat[..., n:, :], feat[..., -1:, :].expand(
                *feat.shape[:-2], min(n, T), feat.shape[-1])],
            dim=-2)[..., :T, :]
        minus = torch.cat(
            [feat[..., :1, :].expand(*feat.shape[:-2], min(n, T),
                                     feat.shape[-1]),
             feat[..., :max(T - n, 0), :]], dim=-2)
        if lengths is not None:
            ragged_edge = (t + n)[:, None] > hi_cap[..., None, None]
            plus = torch.where(ragged_edge, last, plus)
        out = out + n * (plus - minus)
    return out / torch.tensor(denom, dtype=feat.dtype, device=feat.device)


@pytest.mark.parametrize("dtype", list(BITS))
@pytest.mark.parametrize("with_lengths", [False, True])
def test_plain_deltas_divisor_bits_unchanged(dtype, with_lengths):
    """The divisor, now a 0-d tensor made on the features' device (no host
    copy, so no sync on the card), gives the bits the host copy gave."""
    rng = np.random.default_rng(7)
    feat = torch.from_numpy(rng.standard_normal((3, 40, 6))).to(dtype)
    lens = torch.tensor([40, 9, 1]) if with_lengths else None
    for window in (1, 2, 3):
        got = deltas.deltas(feat, window, lens)
        want = _seed_deltas(feat, window, lens)
        assert got.dtype == dtype
        assert torch.equal(got.view(BITS[dtype]), want.view(BITS[dtype]))


def _fake_card(monkeypatch):
    """``backend.resolve`` as on a card (the precision rule kept), and the
    kernel wrapper a recorder running the plain chain: -> the calls."""
    calls = []
    monkeypatch.setattr(backend, "resolve", lambda name, x, cfg: (
        "cuda" if name != "torch" and routes.kernel_precision_supported(cfg)
        else "torch"))
    monkeypatch.setattr(fused_deltas, "fused_append_deltas",
                        lambda feat, window, lengths=None: calls.append(
                            (tuple(feat.shape), window)) or
                        deltas.plain_append_deltas(feat, window, lengths))
    return calls


@pytest.mark.parametrize("precision,backend_name,kernel", [
    ("highest", "auto", True), ("highest", "cuda", True),
    ("highest", "torch", False), ("high", "auto", False),
    ("high", "cuda", False)])
def test_append_deltas_route(monkeypatch, precision, backend_name, kernel):
    """What ``backend.resolve`` routes to "cuda" goes to the kernel with the
    config's window, the rest (the "torch" backend, "high", which the
    kernels do not take) to the plain chain; equal either way."""
    calls = _fake_card(monkeypatch)
    f, lens = case("ragged", 70, 13, 3)
    cfg = FeatureConfig(deltas=True, delta_window=3,
                        matmul_precision=precision)
    got = deltas.append_deltas(torch.from_numpy(f), cfg,
                               torch.from_numpy(lens), backend_name)
    assert calls == ([((9, 70, 13), 3)] if kernel else [])
    assert torch.equal(got, deltas.plain_append_deltas(
        torch.from_numpy(f), 3, torch.from_numpy(lens)))


def test_append_deltas_on_a_cpu_tensor_is_plain(monkeypatch):
    monkeypatch.setattr(fused_deltas, "fused_append_deltas", None)
    f, lens = case("ragged", 70, 13, 2)
    got = deltas.append_deltas(torch.from_numpy(f), FeatureConfig(deltas=True),
                               torch.from_numpy(lens))
    assert torch.equal(got, deltas.plain_append_deltas(
        torch.from_numpy(f), 2, torch.from_numpy(lens)))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        deltas.append_deltas(torch.from_numpy(f), FeatureConfig(deltas=True),
                             backend="cuda")


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """On the CPU every call is refused before a build: a rank below 2, a
    tensor off the card (the card's own cases check the dtype and the
    layout)."""
    with pytest.raises(ValueError, match="T, F"):
        fused_deltas.fused_append_deltas(torch.zeros(5), 2)
    with pytest.raises(ValueError, match="CUDA device"):
        fused_deltas.fused_append_deltas(torch.zeros((2, 5, 3)), 2)
