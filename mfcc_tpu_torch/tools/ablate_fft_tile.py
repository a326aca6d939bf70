"""Where the FFT tile's time goes: build variants of ``csrc/`` with one
stage of ``fft_tile.cuh`` cut out, one constant changed or the
spectrogram's other epilogue, and time each on the card beside the
unchanged build.

    python -m mfcc_tpu_torch.tools.ablate_fft_tile [--variants base,...]
                                                   [--passes 2]

Each variant is a copy of the sources under ``build/ablate/<name>/`` with
the text edits of :data:`VARIANTS` applied, built by nvcc with the port's
flags.  A variant with a stage cut out computes wrong features: its time
says only what that stage costs.  A variant named ``f64_*`` changes the
float64-front flavour only (an A/B of its layout) and ``wave*`` the f32
flavour only; each is built for the sources that run that flavour.
``spec_staged`` swaps the spectrogram's epilogue (each |X|^2's log written
from the split) for the other one (a (TM, n_bins) buffer staged, then
``finish``), and times the spectrogram path only; ``mel_split`` takes the
``mel_runtime_branch`` decides the spectrogram's branches in the tile at
run time, not at compile time (``fft_features<TM, S, Spec>``), an A/B of
what that costs the mel paths, which it times.  A variant named
``mixed_*`` changes the mixed-radix tile's plan (``spectral::mixed_plan``:
``mixed_radix8`` takes the power-of-two part in radix-8 passes, 8 2 5 5 at
400 points; ``mixed_wave1024`` the float64 flavour's wave, two FFTs of 400
points at TM 32) and times Whisper's path
alone (the ``f64_*`` variants time it too): ``fused_raw`` on Whisper's front (``models/whisper.front``) at the
whisper128 cell's batch shape, 256 rows of the 30 s window reflect-padded
to 480,400 samples, 3,000 frames of 400 points and 128 mels a row.  The batches are the
main paths' (64 x 10 s of seeded noise), one per path: ``fused_raw_dit``
at MFCC-13, 16 kHz, and ``fused_mfcc`` at MFCC-13, 44.1 kHz (n_fft 2048,
host pre-emphasis), on the f32 flavour; ``fused_raw`` at unbounded
log-mel-80, 16 kHz, ``fused_dit`` at unbounded log-mel-80 at the 22.05 kHz
TTS geometry (n_fft 1024, host pre-emphasis), and ``fused_raw_dit``'s bark
and spec projections at 16 kHz, on the f64 flavour.  Times are CUDA events around 20 back-to-back calls, ``--passes``
passes in turns (forward, then backward); then, for the unchanged build, each of those wrappers
back-to-back against one call per event pair (the host's share), the host
time to enqueue one call, and the tile each kernel replaced (the direct
or DIT tile) on the same work.  Needs one card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import sys
import time

import numpy as np
import torch

from .. import FeatureConfig
from ..config import WHISPER128
from . import _ablate
from ..models import whisper
from ..ops import framing
from ..ops.kernels import (_spectral, fused_dit, fused_mfcc,
                           fused_raw, fused_raw_dit)
from ..utils import report

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
    "no_finish": [(TILE, "  finish<TM, Guard>(p.e, mel, rowv, en, b, t0);\n}",
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
    "spec_staged": [
        ("spectral.cuh",
         "  return e.projection == kSpecProjection ? 0 : e.n_mels;",
         "  return e.n_mels;"),
        (TILE, "        spec_log(p.e, b, t0 + m, k, pa);\n"
               "        spec_log(p.e, b, t0 + m + 1, k, pb);",
         "        mel[m * nm + k] = pa;\n        mel[(m + 1) * nm + k] = pb;"),
        (TILE, "  if (spec) return;  // the split wrote the spectrogram\n", "")],
    "mel_runtime_branch": [
        (TILE, "  constexpr bool spec = Spec;  // the spectrogram: no band stage",
         "  const bool spec = p.e.projection == kSpecProjection;")],
    "mixed_radix8": [(TILE, "constexpr int kMixedPow2Radix = 4;",
                      "constexpr int kMixedPow2Radix = 8;")],
    "mixed_wave1024": [(TILE, "constexpr int kMixedWavePoints = 2048;",
                        "constexpr int kMixedWavePoints = 1024;")],
}
# source -> (entry, takes preemph, C types of the other tile's constants,
# the other tile, takes a projection)
SOURCES = {
    "fused_raw_dit": ("mfcc_fused_raw_dit", True, _spectral.DIRECT_ARGTYPES,
                      _spectral.DIRECT_TILE, True),
    "fused_mfcc": ("mfcc_fused_mfcc", False, _spectral.DIRECT_ARGTYPES,
                   _spectral.DIRECT_TILE, False),
    "fused_raw": ("mfcc_fused_raw", True, _spectral.DIRECT_ARGTYPES,
                  _spectral.DIRECT_TILE, False),
    "fused_dit": ("mfcc_fused_dit", False, fused_dit.DIT_ARGTYPES,
                  fused_dit.DIT_TILE, False),
}
_TTS = dict(sample_rate=22050, frame_ms=46.44, hop_ms=11.61, n_fft=1024)
# timed path -> (source, config, apply_dct, projection)
PATHS = {
    "fused_raw_dit": ("fused_raw_dit", FeatureConfig(), True, "mel"),
    "fused_mfcc": ("fused_mfcc", FeatureConfig(sample_rate=44100, n_fft=2048),
                   True, "mel"),
    "fused_raw": ("fused_raw", FeatureConfig(n_mels=80, n_mfcc=80), False,
                  "mel"),
    "fused_dit": ("fused_dit", FeatureConfig(n_mels=80, n_mfcc=80, **_TTS),
                  False, "mel"),
    "fused_raw_dit/bark": ("fused_raw_dit", FeatureConfig(), False, "bark"),
    "fused_raw_dit/spec": ("fused_raw_dit", FeatureConfig(), False, "spec"),
    "fused_raw/whisper": ("fused_raw", WHISPER128.feature_config(), False,
                          "mel"),
}
F32_PATHS = ("fused_raw_dit", "fused_mfcc")
F64_PATHS = ("fused_raw", "fused_dit", "fused_raw_dit/bark",
             "fused_raw_dit/spec")
MIXED_PATHS = ("fused_raw/whisper",)
# a path's front end (its own window and bank), and its batch shape where
# it is not 64 x 10 s
FRONTS = {"fused_raw/whisper": whisper.front(WHISPER128)}
SHAPES = {"fused_raw/whisper": (256, WHISPER128.chunk_samples
                                + WHISPER128.n_fft)}
CALLS = 20


def variant_sources(name: str) -> dict:
    """{file name: text} of csrc/ with variant ``name``'s edits applied."""
    return _ablate.variant_sources(VARIANTS, name)


def paths_of(name: str) -> tuple:
    """The timed paths a variant changes the time of."""
    if name.startswith("f64_"):
        return F64_PATHS + MIXED_PATHS
    if name.startswith("wave"):
        return F32_PATHS
    if name.startswith("spec_"):
        return ("fused_raw_dit/spec",)
    if name.startswith("mel_"):
        return F32_PATHS + ("fused_raw", "fused_dit")
    if name.startswith("mixed_"):
        return MIXED_PATHS
    if name == "base":
        return F32_PATHS + F64_PATHS + MIXED_PATHS
    return F32_PATHS + F64_PATHS


def _build_one(name: str, src: str):
    d = _ablate.variant_dir("ablate", name)
    lib = _ablate.nvcc(d / f"{src}.cu", d / f"lib{src}.so", name)
    entry, raw, other_types, _, projection = SOURCES[src]
    fn = getattr(lib, entry)
    fn.argtypes = _spectral.entry_argtypes(other_types, raw, projection,
                                           src == "fused_raw")
    fn.restype = ctypes.c_int
    lib.mfcc_error_string.argtypes = [ctypes.c_int]
    lib.mfcc_error_string.restype = ctypes.c_char_p
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of VARIANTS to build and time")
    ap.add_argument("--passes", type=int, default=2,
                    help="timing passes over the variants, in turns")
    args = ap.parse_args(argv)
    variants = args.variants.split(",")
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("ablate_fft_tile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = _ablate.smi()
    jobs = [(n, p) for n in variants for p in paths_of(n)]
    builds = sorted({(n, PATHS[p][0]) for n, p in jobs})
    _ablate.write_variants("ablate", VARIANTS, variants)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        built = dict(zip(builds, pool.map(lambda j: _build_one(*j), builds)))
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    inputs = {}
    for path, (src, cfg, dct, projection) in PATHS.items():
        x = torch.from_numpy((0.3 * rng.standard_normal(SHAPES.get(
            path, (64, 10 * cfg.sample_rate)))).astype(np.float32)).to(dev)
        raw = SOURCES[src][1]
        inputs[path] = (x if raw else framing.preemphasize(x, cfg).contiguous(),
                        cfg.preemph if raw else None)

    def call(lib_of, path, tile=None):
        src, cfg, dct, projection = PATHS[path]
        (x, pre), takes = inputs[path], SOURCES[src][4]
        front = FRONTS.get(path)
        other = (_spectral.direct_tile(projection, front)
                 if takes or front is not None else SOURCES[src][3])
        return lambda: _spectral.launch_spectral(
            lib_of, SOURCES[src][0], src, x, cfg, dct, pre, other=other,
            tile=tile, projection=projection if takes else None,
            front=front, mixed=src == "fused_raw")

    times = {j: [] for j in jobs}
    for i in range(args.passes):
        for name, path in (jobs if i % 2 == 0 else jobs[::-1]):
            lib = built[name, PATHS[path][0]]
            times[name, path].append(_ablate.ms(call(lambda: lib, path), CALLS))
    for (name, path), t in times.items():
        _, cfg, dct, projection = PATHS[path]
        what = "cepstra" if dct else {"mel": "log-mel"}.get(projection,
                                                             projection)
        print(f"{name:22s} {path:20s} {cfg.sample_rate} Hz n_fft {cfg.n_fft} "
              f"{what} " + " / ".join(f"{v:.4f}" for v in t) + f" ms ({smi})")
    modules = {"fused_raw_dit": (fused_raw_dit, "fused_features_raw_dit"),
               "fused_mfcc": (fused_mfcc, "fused_features"),
               "fused_raw": (fused_raw, "fused_features_raw"),
               "fused_dit": (fused_dit, "fused_features_dit")}
    for path, (src, cfg, dct, projection) in PATHS.items():
        module, fn = modules[src]
        x = inputs[path][0]
        kw = {"projection": projection} if SOURCES[src][4] else {}
        if path in FRONTS:
            kw = {"front": FRONTS[path]}
        wrapper = (lambda m=module, f=fn, x=x, cfg=cfg, dct=dct, kw=kw:
                   getattr(m, f)(x, cfg, apply_dct=dct, **kw))
        b2b = _ablate.ms(wrapper, CALLS)
        t0 = time.perf_counter()
        for _ in range(CALLS):
            wrapper()
        enqueue = (time.perf_counter() - t0) / CALLS * 1e3
        torch.cuda.synchronize()
        other = SOURCES[src][3][0]
        other_ms = _ablate.ms(call(module._lib, path, other), 5)
        single = np.median(report.cuda_ms(wrapper, 0, CALLS, 1))
        print(f"{path}: back-to-back {b2b:.4f} ms, one call per event pair "
              f"{single:.4f} ms, host enqueue {enqueue:.4f} ms; "
              f"its {other} tile on the same work {other_ms:.4f} ms ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
