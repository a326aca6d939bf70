"""The pitch kernels' layout A/Bs on the card, and their shared-memory bank
conflicts counted from the lane mapping.

    python -m mfcc_tpu_torch.tools.ablate_pitch [--variants base,...]
                                                [--passes 4]
                                                [--previous-csrc DIR]

Each variant is a copy of ``csrc/fused_viterbi.cu`` or ``csrc/fused_nccf.cu``
under ``build/ablate_pitch/<name>/`` with the text edits of
:data:`VARIANTS` applied, built by nvcc with the port's flags and launched
through its C entry on the main path's batch: ``fused_viterbi`` on (64,
996, 71) seeded scores, ``fused_nccf`` on 64 x 10 s of seeded noise at
the 4 kHz work rate (``PitchConfig()``).  ``viterbi_K<k>`` gives a state
at least k lanes (the shipped kernel takes the fewest whose range fits in
registers: 1 at 71 lags); ``viterbi_lane_scan`` takes each lane's argmin
by a sequential scan instead of a tree; ``viterbi_no_argmin`` keeps only
each lane's first candidate (wrong paths: its time is the step without its
candidate work); ``viterbi_no_walk`` skips the
backtrace's pointer walk (wrong paths: its time says what the walk
costs); ``nccf_R<r>`` caps the lags a thread at r (15; 9 at 71 lags);
``nccf_lag_energy_in_thread`` keeps each thread's lag energies in
registers instead of summing each window position once per tile;
``nccf_direct_stores`` stores each thread's R outputs from registers
instead of staging the tile's outputs in shared memory.  Every
variant but ``viterbi_no_argmin`` and ``viterbi_no_walk`` must give the
unchanged build's outputs bit for bit, which the tool checks (the output
buffers are cleared before each variant's checked launch).  Times are CUDA events around 20
back-to-back launches, ``--passes`` passes in turns (forward, then
backward).  ``--previous-csrc`` names a ``csrc/`` directory of the
previous design of both kernels (its C entries: no tile output from the
NCCF, an int32 (B, T, n) backpointer scratch for the Viterbi): the tool
builds it, holds its outputs against this build's on the same inputs bit
for bit, and times the two in turns.  Needs one card.

:func:`nccf_bank_wavefronts` and :func:`viterbi_bank_wavefronts` count,
on the CPU, the shared-memory wavefronts of every warp-wide load of the
kernels' loops for a given tile (Nsight Compute does not run where the
card is); a load is conflict-free when it takes one wavefront.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from collections import defaultdict

import numpy as np

from . import _ablate

VIT, NCCF = "fused_viterbi.cu", "fused_nccf.cu"
# name -> [(file in csrc/, text, replacement)]
VARIANTS = {
    "base": [],
    **{f"viterbi_K{k}": [(VIT, "constexpr int kMinLanes = 1;",
                          f"constexpr int kMinLanes = {k};")]
       for k in (2, 4, 8)},
    "viterbi_lane_scan": [(VIT, "        lane_argmin<0, (J > 0 ? J : 1)>(cand, best, arg);",
                           "        best = cand[0];\n        arg = 0;\n#pragma unroll\n"
                           "        for (int m = 1; m < (J > 0 ? J : 1); ++m)\n"
                           "          if (cand[m] < best) {\n            best = cand[m];\n"
                           "            arg = m;\n          }")],
    "viterbi_fmin": [(VIT, "    if (v2 < v) {\n      v = v2;\n      a = a2;\n    }\n",
                      "    a = v2 < v ? a2 : a;\n    v = fminf(v, v2);\n")],
    "viterbi_chunk64": [(VIT, "constexpr int kChunk = 32;", "constexpr int kChunk = 64;")],
    "viterbi_no_argmin": [(VIT, "        lane_argmin<0, (J > 0 ? J : 1)>(cand, best, arg);",
                           "        best = cand[0];\n        arg = 0;")],
    "viterbi_no_walk": [(VIT, "      for (int t = hi - 1; t >= lo; --t) {",
                         "      for (int t = hi - 1; t >= hi; --t) {")],
    **{f"nccf_R{r}": [(NCCF, "constexpr int kMaxLagsPerThread = 15;",
                       f"constexpr int kMaxLagsPerThread = {r};")]
       for r in (5, 3, 1)},
    "nccf_lag_energy_in_thread": [
        (NCCF, "  for (int shared_energy = 1; shared_energy >= 0; --shared_energy) {",
         "  for (int shared_energy = 0; shared_energy >= 0; --shared_energy) {"),
        (NCCF, "      if (!shared_energy && TM != 1) continue;\n", "")],
    "nccf_direct_stores": [(NCCF, "      for (int stage_out = 1; stage_out >= 0; --stage_out) {",
                            "      for (int stage_out = 0; stage_out >= 0; --stage_out) {")],
}
CALLS = 20
BANKS = 32


def _wavefronts(addrs, banks: int = BANKS) -> int:
    """Wavefronts of one warp-wide 4-byte shared load: the most distinct
    words any one bank holds among the lanes' addresses (equal addresses
    broadcast).  With ``banks=8`` and 16-byte chunk addresses, the same
    for one quarter warp of a 16-byte load."""
    per_bank = defaultdict(set)
    for a in addrs:
        per_bank[a % banks].add(a)
    return max((len(v) for v in per_bank.values()), default=0)


def nccf_bank_wavefronts(w: int, hop: int, min_lag: int, n_lags: int, *,
                         TM: int, R: int, passes: int,
                         frame_lanes: int = 8) -> dict:
    """(warp-wide loads, wavefronts) of one full tile of
    ``csrc/fused_nccf.cu`` with window energies in shared memory, for
    the loops' loads: the energy pass (R consecutive positions a thread),
    and the numerator pass (per step A[j] and the window's new sample,
    4 frames x 8 lag groups a warp), in word addresses of the staged span.
    The tile shape (TM, R, passes) is the one the C entry planned
    (``fused_nccf.LAST_SHAPE``)."""
    out = {}
    npos = (TM - 1) * hop + min_lag + n_lags
    chunks = -(-npos // R)
    loads = wf = 0
    for c0 in range(0, chunks, 32):
        lanes = range(c0, min(c0 + 32, chunks))
        for q in range(w + R - 1):          # R-1 window loads, then 1 a step
            loads += 1
            wf += _wavefronts([c * R + q for c in lanes])
    out["energy"] = (loads, wf)
    tasks = [(o % frame_lanes, (o // frame_lanes) % TM,
              o // frame_lanes // TM) for o in range(TM * frame_lanes * passes)]
    loads = wf = 0
    for w0 in range(0, len(tasks), 32):
        warp = [(g, m, (c * frame_lanes + g) * R) for g, m, c in
                tasks[w0: w0 + 32] if (c * frame_lanes + g) * R < n_lags]
        if not warp:
            continue
        for q in range(R - 1):
            loads += 1
            wf += _wavefronts([m * hop + min_lag + l0 + q for _, m, l0 in warp])
        for j in range(w):
            loads += 2
            wf += _wavefronts([m * hop + j for _, m, _ in warp])
            wf += _wavefronts([m * hop + min_lag + l0 + j + R - 1
                               for _, m, l0 in warp])
    out["numerator"] = (loads, wf)
    return out


def viterbi_width(n: int, K: int) -> int:
    """J, the register slots of a lane in ``csrc/fused_viterbi.cu``
    (``built_width``): ceil(n / K) rounded up to 4, 12, 20, ..., 68 or 72."""
    j = -(-n // K)
    return j if j > 72 else 72 if j > 68 else (j + 3) // 8 * 8 + 4


def viterbi_bank_wavefronts(n: int, K: int) -> tuple:
    """(quarter-warp requests, wavefronts) of one step's cost loads in
    ``csrc/fused_viterbi.cu``'s register path: lane k of a state reads the
    16-byte cur[k*J + m .. + 3], m = 0, 4, ..., J - 4, J =
    :func:`viterbi_width`; a warp's 16-byte load is served a quarter warp
    (8 lanes) at a time, across 8 groups of 4 banks."""
    J = viterbi_width(n, K)
    threads = -(-n * K // 32) * 32
    loads = wf = 0
    for q0 in range(0, threads, 8):
        for m in range(0, J, 4):
            loads += 1
            wf += _wavefronts([((t % K) * J + m) // 4
                               for t in range(q0, q0 + 8)], banks=8)
    return loads, wf


def variant_sources(name: str) -> dict:
    """{file name: text} of csrc/ with variant ``name``'s edits applied."""
    return _ablate.variant_sources(VARIANTS, name)


def sources_of(name: str) -> tuple:
    if name.startswith("viterbi_"):
        return ("fused_viterbi",)
    if name.startswith("nccf_"):
        return ("fused_nccf",)
    return ("fused_viterbi", "fused_nccf")


def _build_one(name: str, src: str) -> ctypes.CDLL:
    from ..ops.kernels import fused_nccf, fused_viterbi
    d = _ablate.variant_dir("ablate_pitch", name)
    lib = _ablate.nvcc(d / f"{src}.cu", d / f"lib{src}.so", name)
    return (fused_viterbi if src == "fused_viterbi" else fused_nccf).bind(lib)


def _previous(csrc: str):
    """The previous design's two kernels, built from ``csrc``:
    {source: ctypes entry}."""
    d = _ablate.variant_dir("ablate_pitch", "previous")
    d.mkdir(parents=True, exist_ok=True)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    types = {"fused_nccf": [ptr, i64, i64, ptr, ptr, ptr, *[i32] * 6, ptr],
             "fused_viterbi": [ptr, ptr, ptr, ptr, i32, i32, i32, ptr]}
    out = {}
    for src, argtypes in types.items():
        lib = _ablate.nvcc(f"{csrc}/{src}.cu", d / f"lib{src}.so",
                           f"previous {src}")
        fn = getattr(lib, f"mfcc_{src}")
        fn.argtypes, fn.restype = argtypes, i32
        out[src] = fn
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of VARIANTS to build and time")
    ap.add_argument("--passes", type=int, default=4,
                    help="timing passes over the variants, in turns")
    ap.add_argument("--previous-csrc", default=None,
                    help="csrc/ of the previous design to hold against")
    args = ap.parse_args(argv)
    variants = args.variants.split(",")
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    import torch
    if not torch.cuda.is_available():
        print("ablate_pitch: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import concurrent.futures
    from .. import PitchConfig
    from ..ops import pitch as pitch_op
    from ..ops.kernels import fused_nccf, fused_viterbi
    smi = _ablate.smi()
    _ablate.write_variants("ablate_pitch", VARIANTS, variants)
    jobs = [(n, s) for n in variants for s in sources_of(n)]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        built = dict(zip(jobs, pool.map(lambda j: _build_one(*j), jobs)))

    dev = torch.device("cuda", 0)
    pcfg = PitchConfig()
    rng = np.random.default_rng(0)
    B, T, n = 64, pcfg.num_frames(160000), pcfg.n_lags
    scores = torch.from_numpy((0.5 * rng.standard_normal((B, T, n)))
                              .astype(np.float32)).to(dev)
    Nw = 40000
    xw = torch.from_numpy((0.3 * rng.standard_normal((B, Nw)))
                          .astype(np.float32)).to(dev)
    ball = torch.full((B,), 0.5, device=dev)
    trans = torch.from_numpy(pitch_op._trans_matrix(pcfg)).to(dev)
    path = torch.empty((B, T), dtype=torch.int32, device=dev)
    out_b = torch.empty((B, T, n), device=dev)
    out_p = torch.empty_like(out_b)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(name, src):
        lib = built[name, src]
        if src == "fused_viterbi":
            shape = (ctypes.c_int * len(fused_viterbi.SHAPE_KEYS))()
            spill_bytes = lib.mfcc_viterbi_plan(B, T, n, shape)
            assert spill_bytes == 0, spill_bytes
            return (lambda: lib.mfcc_fused_viterbi(
                scores.data_ptr(), trans.data_ptr(), None, path.data_ptr(),
                B, T, n, stream)), list(shape)
        geometry = (pcfg.frame_len_w, pcfg.hop_len_w, pcfg.min_lag, n)
        shape = (ctypes.c_int * len(fused_nccf.SHAPE_KEYS))()
        fn = (lambda: lib.mfcc_fused_nccf(
            xw.data_ptr(), Nw, Nw, ball.data_ptr(), out_b.data_ptr(),
            out_p.data_ptr(), B, T, *geometry, stream, shape))
        assert fn() == 0
        return fn, list(shape)

    outputs, shapes = {}, {}
    for job in jobs:
        fn, shapes[job] = launch(*job)
        for buf in (path, out_b, out_p):
            buf.fill_(-1)
        assert fn() == 0, job
        torch.cuda.synchronize()
        outputs[job] = ([path.clone()] if job[1] == "fused_viterbi"
                        else [out_b.clone(), out_p.clone()])
    times = {j: [] for j in jobs}
    for i in range(args.passes):
        for job in (jobs if i % 2 == 0 else jobs[::-1]):
            times[job].append(_ablate.ms(launch(*job)[0], CALLS))
    if args.previous_csrc:
        prev = _previous(args.previous_csrc)
        bp = torch.empty((B, T, n), dtype=torch.int32, device=dev)
        geometry = (pcfg.frame_len_w, pcfg.hop_len_w, pcfg.min_lag, n)
        prev_fn = {
            "fused_viterbi": lambda: prev["fused_viterbi"](
                scores.data_ptr(), trans.data_ptr(), bp.data_ptr(),
                path.data_ptr(), B, T, n, stream),
            "fused_nccf": lambda: prev["fused_nccf"](
                xw.data_ptr(), Nw, Nw, ball.data_ptr(), out_b.data_ptr(),
                out_p.data_ptr(), B, T, *geometry, stream)}
        for src, fn in prev_fn.items():
            for buf in (path, out_b, out_p):
                buf.fill_(-1)
            assert fn() == 0, src
            torch.cuda.synchronize()
            got = ([path] if src == "fused_viterbi" else [out_b, out_p])
            base = outputs["base", src]
            diff = max(float((a.double() - b.double()).abs().max())
                       for a, b in zip(got, base))
            t_prev, t_base = [], []
            for i in range(args.passes):
                pair = [(t_prev, fn), (t_base, launch("base", src)[0])]
                for acc, f in (pair if i % 2 == 0 else pair[::-1]):
                    acc.append(_ablate.ms(f, CALLS))
            same = all(torch.equal(a, b) for a, b in zip(got, base))
            print(f"previous design {src}: outputs "
                  f"{'identical to' if same else 'DIFFER from'} this build's "
                  f"(max |diff| {diff:g}); previous "
                  + " / ".join(f"{v:.4f}" for v in t_prev) + " ms, this build "
                  + " / ".join(f"{v:.4f}" for v in t_base) + f" ms ({smi})")
    for (name, src), t in times.items():
        base = outputs.get(("base", src))
        same = ("" if base is None else " identical to base" if all(
            torch.equal(a, b) for a, b in zip(outputs[name, src], base))
            else " DIFFERS from base")
        keys = (fused_viterbi.SHAPE_KEYS if src == "fused_viterbi"
                else fused_nccf.SHAPE_KEYS)
        print(f"{name:26s} {src:14s} {dict(zip(keys, shapes[name, src]))} "
              + " / ".join(f"{v:.4f}" for v in t)
              + f" ms (median {np.median(t):.4f}){same} ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
