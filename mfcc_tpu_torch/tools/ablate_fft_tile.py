"""Where the FFT tile's time goes: build variants of ``csrc/`` with one
stage of ``fft_tile.cuh`` cut out or one constant changed, and time each
on the card beside the unchanged build.

    python -m mfcc_tpu_torch.tools.ablate_fft_tile

Each variant is a copy of the sources under ``build/ablate/<name>/`` with
the text edits of :data:`VARIANTS` applied, built by nvcc with the port's
flags.  A variant with a stage cut out computes wrong features: its time
says only what that stage costs.  A variant named ``f64_*`` changes the
float64-front flavour only (an A/B of its layout) and ``wave*`` the f32
flavour only; each is built for the sources that run that flavour.  The
batches are the main paths' (64 x 10 s of seeded noise), one per source:
``fused_raw_dit`` at MFCC-13, 16 kHz, and ``fused_mfcc`` at MFCC-13, 44.1
kHz (n_fft 2048, host pre-emphasis), on the f32 flavour; ``fused_raw`` at
unbounded log-mel-80, 16 kHz, and ``fused_dit`` at unbounded log-mel-80 at
the 22.05 kHz TTS geometry (n_fft 1024, host pre-emphasis), on the f64
flavour.  Times are CUDA events around 20 back-to-back calls, two passes
in turns; then, for the unchanged build, each of those wrappers
back-to-back against one call per event pair (the host's share), the host
time to enqueue one call, and the tile each kernel replaced (the direct
or DIT tile) on the same work.  Needs one card.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from .. import FeatureConfig
from ..ops import framing
from ..ops.kernels import (_build, _spectral, fused_dit, fused_mfcc,
                           fused_raw, fused_raw_dit)

TILE = "fft_tile.cuh"
# name -> [(file in csrc/, text, replacement)]
VARIANTS = {
    "base": [],
    "no_stage": [(TILE, "    stage_raw_span(xb, p.N, s0, p.span, z);",
                  "    { if (p.preemph == 12345.0) z[tid] = xb[tid]; }"),
                 (TILE, "    stage_span(xb, p.N, s0, p.span, p.preemph, z);",
                  "    { if (p.preemph == 12345.0f) z[tid] = xb[tid]; }")],
    "no_energy": [(TILE, "      se = fma_s(v, v, se);", "")],
    "no_radix": [(TILE, "    for (; log2ns + LR <= p.log2n; log2ns += LR) {",
                  "    for (; log2ns + LR <= 0; log2ns += LR) {")],
    "no_split": [(TILE, "    for (int i = tid; i < p.pairs * (half + 1); "
                        "i += kThreads) {",
                  "    for (int i = tid; i < 0; i += kThreads) {")],
    "no_mel": [(TILE, "          acc = fmaf(static_cast<float>(pw[fft_pad<S>("
                      "ch.x + i)]), w[i], acc);",
                "          acc += w[i];")],
    "no_finish": [(TILE, "  finish<TM>(p.e, mel, rowv, en, b, t0);\n}",
                   "  if (tid < TM && mel[tid] == 12345.0f) "
                   "p.e.out[tid] = en[0];\n}")],
    "wave4096": [(TILE, "  static constexpr int kWavePoints = 2048;",
                  "  static constexpr int kWavePoints = 4096;")],
    "wave1024": [(TILE, "  static constexpr int kWavePoints = 2048;",
                  "  static constexpr int kWavePoints = 1024;")],
    "f64_radix4": [(TILE, "  static constexpr int kRadix = 8;\n"
                          "  static constexpr int kSpanLead = 1;",
                    "  static constexpr int kRadix = 4;\n"
                    "  static constexpr int kSpanLead = 1;")],
    "f64_2blocks": [(TILE, "  static constexpr int kBlocks = 3;",
                     "  static constexpr int kBlocks = 2;")],
    "f64_wave2048_2blocks": [
        (TILE, "  static constexpr int kWavePoints = 1024;",
         "  static constexpr int kWavePoints = 2048;"),
        (TILE, "  static constexpr int kBlocks = 3;",
         "  static constexpr int kBlocks = 2;")],
}
# source -> (entry, takes preemph, C types of the other tile's constants,
# the other tile)
SOURCES = {
    "fused_raw_dit": ("mfcc_fused_raw_dit", True, _spectral.DIRECT_ARGTYPES,
                      _spectral.DIRECT_TILE),
    "fused_mfcc": ("mfcc_fused_mfcc", False, _spectral.DIRECT_ARGTYPES,
                   _spectral.DIRECT_TILE),
    "fused_raw": ("mfcc_fused_raw", True, _spectral.DIRECT_ARGTYPES,
                  _spectral.DIRECT_TILE),
    "fused_dit": ("mfcc_fused_dit", False, fused_dit.DIT_ARGTYPES,
                  fused_dit.DIT_TILE),
}
F32_SOURCES, F64_SOURCES = ("fused_raw_dit", "fused_mfcc"), ("fused_raw",
                                                             "fused_dit")
CALLS = 20


def variant_sources(name: str) -> dict:
    """{file name: text} of csrc/ with variant ``name``'s edits applied;
    raises if an edit no longer matches the sources exactly once."""
    files = {p.name: p.read_text() for p in _build.CSRC.iterdir()}
    for fname, old, new in VARIANTS[name]:
        if files[fname].count(old) != 1:
            raise ValueError(f"variant {name}: edit does not match {fname}")
        files[fname] = files[fname].replace(old, new)
    return files


def sources_of(name: str) -> tuple:
    """The kernel sources a variant changes the time of."""
    if name.startswith("f64_"):
        return F64_SOURCES
    if name.startswith("wave"):
        return F32_SOURCES
    return F32_SOURCES + F64_SOURCES


def _build_one(name: str, src: str):
    d = _build.BUILD_DIR.parent / "ablate" / name
    so = d / f"lib{src}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(d / f"{src}.cu")], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
    entry, raw, other_types, _ = SOURCES[src]
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, entry)
    fn.argtypes = _spectral.entry_argtypes(other_types, raw)
    fn.restype = ctypes.c_int
    lib.mfcc_error_string.argtypes = [ctypes.c_int]
    lib.mfcc_error_string.restype = ctypes.c_char_p
    return lib


def _ms(fn, calls: int = CALLS) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _single_ms(fn, calls: int = CALLS) -> float:
    out = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return float(np.median(out))


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_fft_tile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    jobs = [(n, s) for n in VARIANTS for s in sources_of(n)]
    for name in VARIANTS:
        d = _build.BUILD_DIR.parent / "ablate" / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for fname, text in variant_sources(name).items():
            (d / fname).write_text(text)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        built = dict(zip(jobs, pool.map(lambda j: _build_one(*j), jobs)))
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    tts = dict(sample_rate=22050, frame_ms=46.44, hop_ms=11.61, n_fft=1024)
    cfgs = {"fused_raw_dit": (FeatureConfig(), True),
            "fused_mfcc": (FeatureConfig(sample_rate=44100, n_fft=2048), True),
            "fused_raw": (FeatureConfig(n_mels=80, n_mfcc=80), False),
            "fused_dit": (FeatureConfig(n_mels=80, n_mfcc=80, **tts), False)}
    paths = {}
    for src, (cfg, dct) in cfgs.items():
        x = torch.from_numpy((0.3 * rng.standard_normal(
            (64, 10 * cfg.sample_rate))).astype(np.float32)).to(dev)
        raw = SOURCES[src][1]
        paths[src] = (x if raw else framing.preemphasize(x, cfg).contiguous(),
                      cfg, dct, cfg.preemph if raw else None)

    def call(lib_of, src, tile=None):
        x, cfg, dct, pre = paths[src]
        return lambda: _spectral.launch_spectral(
            lib_of, SOURCES[src][0], src, x, cfg, dct, pre,
            other=SOURCES[src][3], tile=tile)

    times = {j: [] for j in jobs}
    for order in (jobs, jobs[::-1]):
        for name, src in order:
            times[name, src].append(_ms(call(lambda: built[name, src], src)))
    for (name, src), t in times.items():
        x, cfg, dct, _ = paths[src]
        print(f"{name:22s} {src:14s} {cfg.sample_rate} Hz n_fft {cfg.n_fft} "
              f"{'cepstra' if dct else 'log-mel'} "
              + " / ".join(f"{v:.4f}" for v in t) + f" ms ({smi})")
    modules = {"fused_raw_dit": (fused_raw_dit, "fused_features_raw_dit"),
               "fused_mfcc": (fused_mfcc, "fused_features"),
               "fused_raw": (fused_raw, "fused_features_raw"),
               "fused_dit": (fused_dit, "fused_features_dit")}
    for src, (module, fn) in modules.items():
        x, cfg, dct, _ = paths[src]
        wrapper = (lambda m=module, f=fn, x=x, cfg=cfg, dct=dct:
                   getattr(m, f)(x, cfg, apply_dct=dct))
        b2b = _ms(wrapper)
        t0 = time.perf_counter()
        for _ in range(CALLS):
            wrapper()
        enqueue = (time.perf_counter() - t0) / CALLS * 1e3
        torch.cuda.synchronize()
        other = _ms(call(module._lib, src, SOURCES[src][3][0]), calls=5)
        print(f"{src}: back-to-back {b2b:.4f} ms, one call per event pair "
              f"{_single_ms(wrapper):.4f} ms, host enqueue {enqueue:.4f} ms; "
              f"its {SOURCES[src][3][0]} tile on the same work {other:.4f} "
              f"ms ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
