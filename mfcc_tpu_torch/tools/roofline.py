"""The spectral kernels' attainable ceiling on the card: a ladder of rungs,
each a build of the kernel's own sources with part of the work left out,
timed beside the unchanged kernel (the Hopper twin of
``bench/roofline.py``'s ``make_probe``, built for the FFT tile's dataflow
rather than the TPU kernel's GEMMs).

    python -m mfcc_tpu_torch.tools.roofline [--paths fused_raw_dit,...]
                                            [--passes 2] [--out [PATH]]

Each rung is a copy of ``csrc/`` under ``build/roofline/<rung>/`` with the
text edits of :data:`VARIANTS` applied to ``fft_tile.cuh`` (an edit that
no longer matches the sources exactly once raises), built by nvcc with the
port's flags.  No edit touches ``launch_fft``, ``fft_smem_bytes``,
``fft_first_pass`` or a C entry, so a rung runs the kernel's grid, threads,
frame tile, pairs a wave, span and shared memory; each rung's block 0
records the launch it ran, which the tool holds against the host's plan
(:func:`plan`).  The rungs, in order:

- ``stage``: the block's span staged into shared memory and the output
  tile stored from it, ``out[b, t, c]`` = the staged sample ``c`` of frame
  ``t`` (pre-emphasized in f32 on the ``fft`` flavour, raw on ``fft64``, as
  the host gave it to ``fused_mfcc``); no FFT, mel or epilogue.  Equal in
  every bit to a gather of the same samples.
- ``fft``: ``stage`` + window, radix passes, split to |X|^2 and the sparse
  mel, then the DCT (or the mel energies' store) with no floors, no log and
  no frame energy.  Within :data:`FFT_RTOL` of the plain chain's max.
- ``fftlog``: the whole kernel without the frame energy (no path here
  appends it), equal in every bit to the kernel.
- ``kernel``: the unchanged build, through the module's own wrapper.

Every rung computes a defined function, held against its plain twin
(:func:`plain_rung`) on the card before it is timed, so the compiler kept
the work the rung times.  The paths (:data:`PATHS`) are 64 x 10 s of
``0.1 * N(0, 1)`` (numpy seed 0, ``bench/roofline.py``'s signal) at each
config's rate: ``fused_raw_dit`` MFCC-13 at 16 kHz on the f32 tile (TM 16;
the reference probe's config), ``fused_raw`` unbounded log-mel-80 on the
``fft64`` tile (TM 32), ``fused_mfcc`` MFCC-13 at 44.1 kHz, n_fft 2048,
host pre-emphasis, on the f32 tile (TM 8).  Times: CUDA events around 20
back-to-back calls (``_ablate.ms``), ``--passes`` passes over every path
and rung in turns (forward, then backward), the median; beside each, the
host's enqueue time a call (a rung replays its recorded C call, so its
time is the device's when that is smaller).  Prints one JSON line a path;
``--out`` also writes one JSON file (default
``build/roofline/roofline.json``).  Needs one card: without one it exits
1.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import statistics
import sys
import time

import numpy as np
import torch

from .. import FeatureConfig, backend
from ..ops import dct as dct_op, framing, mel as mel_op, spectrum
from ..ops.kernels import _spectral, fused_mfcc, fused_raw, fused_raw_dit
from ..utils.report import launched
from . import _ablate, ablate_fft_tile

TILE = "fft_tile.cuh"
TOOL = "roofline"
# every rung records the launch it ran: block 0 writes (TM, pairs, span,
# dynamic shared-memory bytes, blocks, tiles), read by mfcc_roofline_plan
PLAN_KEYS = ("TM", "pairs", "span", "smem_bytes", "blocks", "tiles")
_PLAN = [
    (TILE, "template <int TM, typename S, bool Spec = false,"
           " bool Guard = false>\n"
           "__device__ __forceinline__ void fft_features(",
     "__device__ int roofline_plan[6];  // the launch a rung ran\n\n"
     "template <typename S>\n"
     "__device__ __forceinline__ void record_plan(int TM,\n"
     "                                            const FftParams<S>& p) {\n"
     "  unsigned smem;\n"
     "  asm volatile(\"mov.u32 %0, %%dynamic_smem_size;\" : \"=r\"(smem));\n"
     "  roofline_plan[0] = TM;\n"
     "  roofline_plan[1] = p.pairs;\n"
     "  roofline_plan[2] = p.span;\n"
     "  roofline_plan[3] = static_cast<int>(smem);\n"
     "  roofline_plan[4] = static_cast<int>(gridDim.x);\n"
     "  roofline_plan[5] = p.tiles;\n"
     "}\n\n"
     "extern \"C\" int mfcc_roofline_plan(int* out) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
     "      out, roofline_plan, sizeof(roofline_plan)));\n"
     "}\n\n"
     "template <int TM, typename S, bool Spec = false,"
     " bool Guard = false>\n"
     "__device__ __forceinline__ void fft_features("),
    (TILE, "  const int tid = threadIdx.x;\n"
           "  const int b = blockIdx.x / p.tiles;\n",
     "  const int tid = threadIdx.x;\n"
     "  if (blockIdx.x == 0 && tid == 0) record_plan(TM, p);\n"
     "  const int b = blockIdx.x / p.tiles;\n")]
_NO_ENERGY = ablate_fft_tile.VARIANTS["no_energy"]
# name -> [(file in csrc/, text, replacement)]
VARIANTS = {
    "stage": _PLAN + [
        (TILE, "    stage_span(xb, p.N, s0, p.span, p.preemph, z);\n"
               "  __syncthreads();\n",
         "    stage_span(xb, p.N, s0, p.span, p.preemph, z);\n"
         "  __syncthreads();\n"
         "  // rung \"stage\": the staged samples stored as the output tile\n"
         "  for (int o = tid; o < TM * p.e.n_out; o += kThreads) {\n"
         "    const int m = o / p.e.n_out, c = o - m * p.e.n_out;\n"
         "    if (t0 + m < p.e.T)\n"
         "      p.e.out[(static_cast<long long>(b) * p.e.T + t0 + m) *\n"
         "                  p.e.n_out + c] = z[m * p.hop + c];\n"
         "  }\n"
         "  return;\n")],
    "fft": _PLAN + _NO_ENERGY + [
        (TILE, "  finish<TM, Guard>(p.e, mel, rowv, en, b, t0);\n}",
         "  // rung \"fft\": the epilogue without floors and log\n"
         "  for (int o = tid; o < TM * p.e.n_out; o += kThreads) {\n"
         "    const int m = o / p.e.n_out, c = o - m * p.e.n_out;\n"
         "    if (t0 + m >= p.e.T) continue;\n"
         "    float v = 0.0f;\n"
         "    if (!p.e.apply_dct) {\n"
         "      v = mel[m * nm + c];\n"
         "    } else {\n"
         "      for (int j = 0; j < nm; ++j)\n"
         "        v = fmaf(mel[m * nm + j], __ldg(p.e.dctm + j * p.e.n_out + c),\n"
         "                 v);\n"
         "    }\n"
         "    p.e.out[(static_cast<long long>(b) * p.e.T + t0 + m) *\n"
         "                p.e.n_out + c] = v;\n"
         "  }\n}")],
    "fftlog": _PLAN + _NO_ENERGY,
}
BUILT = tuple(VARIANTS)
RUNGS = (*BUILT, "kernel")
# source -> (C entry, takes preemph, its wrapper)
SOURCES = {
    "fused_raw_dit": ("mfcc_fused_raw_dit", True,
                      fused_raw_dit.fused_features_raw_dit),
    "fused_raw": ("mfcc_fused_raw", True, fused_raw.fused_features_raw),
    "fused_mfcc": ("mfcc_fused_mfcc", False, fused_mfcc.fused_features),
}
# path -> (source, config, apply_dct)
PATHS = {
    "fused_raw_dit": ("fused_raw_dit", FeatureConfig(), True),
    "fused_raw": ("fused_raw", FeatureConfig(n_mels=80, n_mfcc=80), False),
    "fused_mfcc": ("fused_mfcc", FeatureConfig(sample_rate=44100, n_fft=2048),
                   True),
}
BATCH, SECONDS, CALLS = 64, 10.0, 20
FFT_RTOL = 1e-4        # the fft rung: max |diff| <= FFT_RTOL x max |plain|
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
# each flavour's shared-memory target a block (spectral::fft_smem_target:
# kBlocks blocks share an SM's 228 KB, 1 KB each for the system)
SMEM_TARGET = {"fft": (228 // 4 - 2) * 1024, "fft64": (228 // 3 - 2) * 1024}
DEFAULT_OUT = _ablate.variant_dir(TOOL, "roofline.json")


def variant_sources(rung: str) -> dict:
    """{file name: text} of csrc/ with rung ``rung``'s edits applied."""
    return _ablate.variant_sources(VARIANTS, rung)


def signal(cfg: FeatureConfig, batch: int = BATCH,
           seconds: float = SECONDS) -> np.ndarray:
    """(batch, seconds x rate) float32 ``0.1 * N(0, 1)``, numpy seed 0 (the
    reference probe's signal)."""
    rng = np.random.default_rng(0)
    n = int(seconds * cfg.sample_rate)
    return (0.1 * rng.standard_normal((batch, n))).astype(np.float32)


def kernel_input(path: str, x: torch.Tensor) -> torch.Tensor:
    """The audio the path's kernel takes: raw, or pre-emphasized by the
    host (``fused_mfcc``)."""
    src, cfg, _ = PATHS[path]
    return x if SOURCES[src][1] else framing.preemphasize(x, cfg).contiguous()


def plan(path: str, B: int, N: int) -> dict:
    """The launch ``launch_fft`` picks for the path on a (B, N) batch: the
    largest frame tile TM whose shared memory meets the flavour's target,
    else 8 (``_spectral.fft_frame_tile``); its pairs a wave, span, bytes,
    tiles a row and blocks, and the shape."""
    src, cfg, dct = PATHS[path]
    tile = _spectral.fft_tile(cfg, dct)
    T = cfg.num_frames(N)
    tm = _spectral.fft_frame_tile(cfg, tile)
    if tm is None:
        raise ValueError(f"{path}: no frame tile fits shared memory")
    nbytes = _spectral.fft_smem_bytes(cfg, tile, tm)
    wave = _spectral.FFT_FLAVOURS[tile][1]
    tiles = -(-T // tm)
    return {"tile": tile, "n_fft": cfg.n_fft, "frame_len": cfg.frame_len,
            "hop": cfg.hop_len, "T": T, "TM": tm,
            "pairs": max(1, min(wave // cfg.n_fft, tm // 2)),
            "span": ((tm - 1) * cfg.hop_len + cfg.frame_len + 3) // 4 * 4,
            "smem_bytes": nbytes, "tiles": tiles, "blocks": B * tiles}


def path_bytes(path: str, B: int, N: int) -> int:
    """The audio read once and the features written once (as
    ``chip_smoke._spectral_work`` counts them)."""
    _, cfg, dct = PATHS[path]
    return 4 * B * N + 4 * B * cfg.num_frames(N) * _spectral.n_out(cfg, dct)


def plain_rung(rung: str, x: torch.Tensor, cfg: FeatureConfig,
               apply_dct: bool, source: str = "fused_raw_dit") -> torch.Tensor:
    """What rung ``rung`` of ``source``'s build computes from the kernel's
    input x (raw audio, or the host's pre-emphasized audio for
    ``fused_mfcc``), in plain PyTorch: -> (B, T, n_out)."""
    raw = SOURCES[source][1]
    if rung == "stage":
        z = (framing.preemphasize(x, cfg)
             if raw and _spectral.fft_tile(cfg, apply_dct) == "fft" else x)
        return framing.frames(z, cfg)[..., :_spectral.n_out(cfg, apply_dct)]
    if cfg.append_energy:
        raise ValueError("the rungs cut the frame energy: append_energy "
                         "must be off")
    if rung == "fftlog":
        return (fused_raw_dit.plain_features(x, cfg, apply_dct) if raw
                else fused_mfcc.plain_features(x, cfg, apply_dct))
    if rung != "fft":
        raise ValueError(f"no plain twin of rung {rung!r}")
    y = framing.preemphasize(x, cfg) if raw else x
    power = spectrum.power_spectrum(framing.frames(y, cfg), cfg)
    melw = torch.from_numpy(mel_op.mel_matrix(cfg).astype(np.float32))
    e = backend.matmul(power, melw.to(x.device), cfg.matmul_precision)
    return dct_op.cepstra(e, cfg) if apply_dct else e


def derived(med: dict, nbytes: int) -> dict:
    """The shares of a path's median ms by rung (``bench/roofline.py``'s
    ``derived``, on this ladder)."""
    return {
        "kernel_pct_of_attainable_ceiling": 100.0 * med["fft"] / med["kernel"],
        "log_cost_pct_of_fft_chain": 100.0 * (med["fftlog"] / med["fft"] - 1),
        "fft_cost_pct_of_stage_floor": 100.0 * (med["fft"] / med["stage"] - 1),
        "energy_cost_pct": 100.0 * (med["kernel"] / med["fftlog"] - 1),
        "stage_pct_of_hbm": 100.0 * (nbytes / HBM_BYTES_PER_S * 1e3)
        / med["stage"],
    }


def _build_one(rung: str, src: str) -> ctypes.CDLL:
    d = _ablate.variant_dir(TOOL, rung)
    lib = _ablate.nvcc(d / f"{src}.cu", d / f"lib{src}.so", f"{rung} {src}")
    entry, raw, _ = SOURCES[src]
    getattr(lib, entry).argtypes = _spectral.entry_argtypes(
        _spectral.DIRECT_ARGTYPES, raw, src == "fused_raw_dit",
        src == "fused_raw")
    getattr(lib, entry).restype = ctypes.c_int
    lib.mfcc_error_string.argtypes = [ctypes.c_int]
    lib.mfcc_error_string.restype = ctypes.c_char_p
    lib.mfcc_roofline_plan.argtypes = [ctypes.c_void_p]
    lib.mfcc_roofline_plan.restype = ctypes.c_int
    return lib


def build(paths, rungs=BUILT) -> dict:
    """Write the rungs' sources and build each rung of each path's source,
    all nvcc processes at once: -> {(rung, source): library}."""
    jobs = sorted({(r, PATHS[p][0]) for p in paths for r in rungs})
    _ablate.write_variants(TOOL, VARIANTS, rungs)
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        return dict(zip(jobs, pool.map(lambda j: _build_one(*j), jobs)))


class _Recorder:
    """A library whose C entry calls are kept, to be replayed as they
    were made."""

    def __init__(self, lib):
        self.lib, self.call = lib, None

    def __getattr__(self, name):
        fn = getattr(self.lib, name)

        def call(*args):
            self.call = (fn, args)
            return fn(*args)
        return call


def launch(lib, path: str, x: torch.Tensor, rung: str):
    """One launch of ``rung``'s build ``lib`` on the kernel input x (on the
    card): -> (out, replay), replay() launching the same C call again into
    the same out.  Each launch is recorded in ``utils/report`` as kernel
    ``roofline/<rung>``."""
    src, cfg, dct = PATHS[path]
    entry, raw, _ = SOURCES[src]
    rec, name = _Recorder(lib), f"roofline/{rung}"
    out = _spectral.launch_spectral(
        lambda: rec, entry, name, x, cfg, dct, cfg.preemph if raw else None,
        projection="mel" if src == "fused_raw_dit" else None,
        mixed=src == "fused_raw")
    fn, args = rec.call

    def replay(out=out):   # holds out, which the recorded call writes
        err = fn(*args)
        if err:
            _spectral.raise_on_error(err, lib, name)
        launched(name)
    return out, replay


def launched_plan(lib) -> dict:
    """The launch the library's last rung ran (block 0's record)."""
    torch.cuda.synchronize()
    buf = (ctypes.c_int * len(PLAN_KEYS))()
    err = lib.mfcc_roofline_plan(buf)
    if err:
        _spectral.raise_on_error(err, lib, "mfcc_roofline_plan")
    return dict(zip(PLAN_KEYS, buf))


def kernel(path: str, x: torch.Tensor) -> torch.Tensor:
    """The unchanged kernel through its module's wrapper."""
    src, cfg, dct = PATHS[path]
    return SOURCES[src][2](x, cfg, apply_dct=dct)


def check(libs: dict, path: str, x: torch.Tensor) -> dict:
    """Launch each rung once on x and hold it against its twin: ``stage``
    and ``fftlog`` equal in every bit (``fftlog`` to the kernel), ``fft``
    within FFT_RTOL of the plain chain's max, and every rung's launch equal
    to :func:`plan`.  Raises on a failure; -> the plan and the fft rung's
    errors."""
    src, cfg, dct = PATHS[path]
    want = plan(path, *x.shape)
    outs = {}
    for rung in BUILT:
        lib = libs[rung, src]
        outs[rung] = launch(lib, path, x, rung)[0]
        got = launched_plan(lib)
        if any(got[k] != want[k] for k in PLAN_KEYS):
            raise RuntimeError(f"{path} rung {rung} launched {got}, not the "
                               f"kernel's plan {want}")
    if not torch.equal(outs["stage"], plain_rung("stage", x, cfg, dct, src)):
        raise RuntimeError(f"{path}: rung stage differs from the gather")
    if not torch.equal(outs["fftlog"], kernel(path, x)):
        raise RuntimeError(f"{path}: rung fftlog differs from the kernel")
    plain = plain_rung("fft", x, cfg, dct, src)
    err = float((outs["fft"] - plain).abs().max())
    scale = float(plain.abs().max())
    if not err <= FFT_RTOL * scale:
        raise RuntimeError(f"{path}: rung fft {err:.3e} off the plain chain, "
                           f"over {FFT_RTOL:g} x its max {scale:.4g}")
    return {"plan": want, "fft_max_abs_err": err,
            "fft_rel_err": err / scale}


def ladder(libs: dict, inputs: dict, passes: int = 2) -> dict:
    """Time every rung of every path in ``inputs`` (path -> kernel input):
    ``passes`` passes in turns (forward, then backward), CUDA events around
    CALLS back-to-back calls each; then the host's enqueue time a call.
    -> {path: {rung: {"ms": [...], "median_ms", "host_enqueue_ms"}}}."""
    fns = {}
    for path, x in inputs.items():
        src = PATHS[path][0]
        for rung in BUILT:
            fns[path, rung] = launch(libs[rung, src], path, x, rung)[1]
        fns[path, "kernel"] = lambda p=path, x=x: kernel(p, x)
    jobs = list(fns)
    times = {j: [] for j in jobs}
    for i in range(passes):
        for job in (jobs if i % 2 == 0 else jobs[::-1]):
            times[job].append(_ablate.ms(fns[job], CALLS))
    out = {path: {} for path in inputs}
    for (path, rung), fn in fns.items():
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        host = (time.perf_counter() - t0) / CALLS * 1e3
        torch.cuda.synchronize()
        t = times[path, rung]
        out[path][rung] = {"ms": t, "median_ms": statistics.median(t),
                           "host_enqueue_ms": host}
    return out


def report(results: dict, inputs: dict, smi: str, passes: int,
           checks: dict) -> dict:
    """The JSON document (``bench/roofline.py``'s keys): the card, the
    protocol, each path's shapes, rung times with audio-sec/s, the derived
    shares, and the fft rung's errors (:func:`check`)."""
    doc = {"device": smi, "batch": None, "utt_seconds": None,
           "passes": passes, "calls": CALLS, "protocol": "cuda-events",
           "shapes": {}, "results": {}, "derived": {}, "checks": {}}
    for path, x in inputs.items():
        B, N = x.shape
        cfg = PATHS[path][1]
        audio_s = B * N / cfg.sample_rate
        doc["batch"], doc["utt_seconds"] = B, N / cfg.sample_rate
        doc["shapes"][path] = plan(path, B, N)
        doc["results"][path] = {
            rung: {**r, "audio_sec_per_s": audio_s / (r["median_ms"] / 1e3)}
            for rung, r in results[path].items()}
        doc["derived"][path] = derived(
            {r: v["median_ms"] for r, v in results[path].items()},
            path_bytes(path, B, N))
        doc["checks"][path] = {k: v for k, v in checks[path].items()
                               if k != "plan"}
    return doc


def path_line(doc: dict, path: str) -> dict:
    """One path's JSON line."""
    return {"path": path, "device": doc["device"],
            **{k: doc[k][path] for k in ("shapes", "results", "derived",
                                         "checks")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", default=",".join(PATHS),
                    help="comma-separated names of PATHS to build and time")
    ap.add_argument("--passes", type=int, default=2,
                    help="timing passes over every path and rung, in turns")
    ap.add_argument("--out", nargs="?", const=str(DEFAULT_OUT), default=None,
                    help=f"also write the JSON document (default path "
                         f"{DEFAULT_OUT})")
    args = ap.parse_args(argv)
    paths = args.paths.split(",")
    unknown = set(paths) - set(PATHS)
    if unknown:
        ap.error(f"unknown paths {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("roofline: needs an NVIDIA GPU (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    smi = _ablate.smi()
    t0 = time.perf_counter()
    libs = build(paths)
    print(f"roofline: {len(libs)} rung builds in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    dev = torch.device("cuda", 0)
    inputs = {p: kernel_input(p, torch.from_numpy(signal(PATHS[p][1])).to(dev))
              for p in paths}
    checks = {p: check(libs, p, x) for p, x in inputs.items()}
    doc = report(ladder(libs, inputs, args.passes), inputs, smi, args.passes,
                 checks)
    for p in paths:
        print(json.dumps(path_line(doc, p)), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
