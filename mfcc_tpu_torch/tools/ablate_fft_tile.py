"""Where the FFT tile's time goes: build variants of ``csrc/`` with one
stage of ``fft_tile.cuh`` cut out or one constant changed, and time each
on the card beside the unchanged build and the direct tile.

    python -m mfcc_tpu_torch.tools.ablate_fft_tile

Each variant is a copy of the sources under ``build/ablate/<name>/`` with
the text edits of :data:`VARIANTS` applied, built by nvcc with the port's
flags.  A variant with a stage cut out computes wrong features: its time
says only what that stage costs.  The batches are the main paths' (64 x
10 s of seeded noise): ``fused_raw_dit`` at MFCC-13, 16 kHz, and
``fused_mfcc`` at MFCC-13, 44.1 kHz (n_fft 2048, host pre-emphasis); the
direct tile on the same work is ``fused_raw`` with ``apply_dct=True``.
Times are CUDA events around 20 back-to-back calls, two passes in turns;
the wrappers' host cost is one call per event pair against back-to-back
calls, and the host time to enqueue one call.  Needs one card.
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
from ..ops.kernels import _build, _spectral, fused_mfcc, fused_raw, fused_raw_dit

TILE = "fft_tile.cuh"
# name -> [(file in csrc/, text, replacement)]
VARIANTS = {
    "base": [],
    "no_stage": [(TILE, "  stage_span(xb, p.N, static_cast<long long>(t0) * "
                        "p.hop, p.span, p.preemph,\n             z);",
                  "  if (p.preemph == 12345.0f) z[tid] = xb[tid];")],
    "no_energy": [(TILE, "    for (int k = l; k < p.frame_len; k += G) "
                         "se = fmaf(zm[k], zm[k], se);", "")],
    "no_r8": [(TILE, "    for (; log2ns + 3 <= p.log2n; log2ns += 3) {",
               "    for (; log2ns + 3 <= 0; log2ns += 3) {")],
    "no_split": [(TILE, "    for (int i = tid; i < p.pairs * (half + 1); "
                        "i += kThreads) {",
                  "    for (int i = tid; i < 0; i += kThreads) {")],
    "no_mel": [(TILE, "        if (ch.x + i < ch.y) acc = fmaf(pw[fft_pad("
                      "ch.x + i)], w[i], acc);",
                "        if (ch.x + i < ch.y) acc += w[i];")],
    "no_finish": [(TILE, "  finish<TM>(p.e, mel, rowv, en, b, t0);\n}",
                   "  if (tid < TM && mel[tid] == 12345.0f) "
                   "p.e.out[tid] = en[0];\n}")],
    "wave4096": [(TILE, "constexpr int kWavePoints = 2048;",
                  "constexpr int kWavePoints = 4096;")],
    "wave1024": [(TILE, "constexpr int kWavePoints = 2048;",
                  "constexpr int kWavePoints = 1024;")],
}
SOURCES = {"fused_raw_dit": ("mfcc_fused_raw_dit", True),
           "fused_mfcc": ("mfcc_fused_mfcc", False)}
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


def _build_variant(name: str) -> dict:
    d = _build.BUILD_DIR.parent / "ablate" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for fname, text in variant_sources(name).items():
        (d / fname).write_text(text)
    libs = {}
    for src, (entry, raw) in SOURCES.items():
        so = d / f"lib{src}.so"
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(so), str(d / f"{src}.cu")],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, entry)
        fn.argtypes = (_spectral.SPECTRAL_ARGTYPES
                       + ([ctypes.c_float] if raw else [])
                       + _spectral.EPILOGUE_ARGTYPES + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.mfcc_error_string.argtypes = [ctypes.c_int]
        lib.mfcc_error_string.restype = ctypes.c_char_p
        libs[src] = lib
    return libs


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
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        libs = dict(zip(VARIANTS, pool.map(_build_variant, VARIANTS)))
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    c16 = FeatureConfig()
    c44 = FeatureConfig(sample_rate=44100, n_fft=2048)
    x16 = torch.from_numpy((0.3 * rng.standard_normal((64, 160000)))
                           .astype(np.float32)).to(dev)
    x44 = torch.from_numpy((0.3 * rng.standard_normal((64, 441000)))
                           .astype(np.float32)).to(dev)
    y44 = framing.preemphasize(x44, c44).contiguous()
    paths = {"fused_raw_dit": (x16, c16, c16.preemph),
             "fused_mfcc": (y44, c44, None)}

    def call(name, src):
        x, cfg, pre = paths[src]
        return lambda: _spectral.launch_spectral(
            lambda: libs[name][src], SOURCES[src][0], src, x, cfg, True, pre)

    times = {n: {s: [] for s in SOURCES} for n in VARIANTS}
    for order in (list(VARIANTS), list(VARIANTS)[::-1]):
        for name in order:
            for src in SOURCES:
                times[name][src].append(_ms(call(name, src)))
    for name, t in times.items():
        print(f"{name:10s} fused_raw_dit 16 kHz "
              + " / ".join(f"{v:.4f}" for v in t["fused_raw_dit"])
              + " ms   fused_mfcc 44.1 kHz "
              + " / ".join(f"{v:.4f}" for v in t["fused_mfcc"]) + f" ms ({smi})")
    wrappers = {
        "fused_raw_dit 16 kHz": lambda: fused_raw_dit.fused_features_raw_dit(
            x16, c16),
        "fused_mfcc 44.1 kHz": lambda: fused_mfcc.fused_features(y44, c44),
        "fused_raw (direct) 16 kHz": lambda: fused_raw.fused_features_raw(
            x16, c16, apply_dct=True),
        "fused_raw (direct) 44.1 kHz": lambda: fused_raw.fused_features_raw(
            x44, c44, apply_dct=True)}
    for name, fn in wrappers.items():
        b2b = _ms(fn)
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        enqueue = (time.perf_counter() - t0) / CALLS * 1e3
        torch.cuda.synchronize()
        print(f"{name}: back-to-back {b2b:.4f} ms, one call per event pair "
              f"{_single_ms(fn):.4f} ms, host enqueue {enqueue:.4f} ms "
              f"({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
