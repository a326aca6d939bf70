"""The pitch kernels' layout A/Bs on the card, and their shared-memory bank
conflicts counted from the lane mapping.

    python -m mfcc_tpu_torch.tools.ablate_pitch [--variants base,...]
                                                [--passes 4]
                                                [--previous-csrc DIR]
    python -m mfcc_tpu_torch.tools.ablate_pitch --lag-shapes
                                                [--variants nccf_lag_R1,...]

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
``nccf_direct_stores`` stores each thread's R outputs from registers
instead of staging the tile's outputs in shared memory;
``nccf_lag_blocked`` plans the lag-blocked tiling (lag blocks, sample
chunks, the lag energies in each thread's registers) for every config;
``nccf_lag_widest`` plans that tiling at the most lags a thread whatever
the grid, not at the R that spreads a short grid over the SMs;
``nccf_lag_R<r>`` plans it at r lags a thread whatever the grid.
``chip_smoke.py`` phase 22 builds ``nccf_lag_blocked`` and
``nccf_lag_widest`` (:func:`build`) and launches them through
:func:`fused_nccf.launch`.  ``--lag-shapes`` times the shipped build and
the ``nccf_lag_*`` variants (by default every ``nccf_lag_R<r>``) on
:data:`LAG_SHAPES`, where the planner takes the lag-blocked tiling, each
launch checked against the shipped build's bits: the sweep that the
planner's choice of R is held to.  Every
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
# the planner's head: nccf_lag_blocked returns the lag-blocked plan there
_PLAN = ("cudaError_t plan(int w, int hop, int min_lag, int n_lags, int B, "
         "int T,\n                 int max_smem, int sms, Plan* pl) {\n")
# the lag-blocked planner's loop over R
_LAG_R = "  for (int R = widest; R >= 1; R -= 2) {"
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
    "nccf_direct_stores": [(NCCF, "    for (int stage_out = 1; stage_out >= 0; --stage_out) {",
                            "    for (int stage_out = 0; stage_out >= 0; --stage_out) {")],
    "nccf_lag_blocked": [(NCCF, _PLAN, _PLAN + "  return plan_lag_blocked("
                          "w, hop, n_lags, B, T, max_smem, sms, pl);\n")],
    "nccf_lag_widest": [(NCCF, _LAG_R, _LAG_R.replace("1;", "widest;"))],
    **{f"nccf_lag_R{r}": [(NCCF, _LAG_R, f"  for (int R = {r}; R >= {r}; "
                           "R -= 2) {")] for r in range(1, 16, 2)},
}
# the builds chip_smoke.py phase 22 holds against the shipped planner
TILINGS = ("nccf_lag_blocked", "nccf_lag_widest")
CALLS = 20
BANKS = 32
# (name, PitchConfig keywords, B, T): --lag-shapes' NCCF shapes, windows
# where no whole window fits in shared memory, at short and full grids
LAG_SHAPES = (
    ("40,400-sample window", dict(work_rate=16000, min_f0=0.4), 1, 3),
    ("many lags", dict(work_rate=16000, min_f0=0.25), 1, 3),
    ("many lags", dict(work_rate=16000, min_f0=0.25), 1, 64),
    ("wide frame", dict(work_rate=16000, frame_ms=4000.0), 2, 6),
    ("wide frame", dict(work_rate=16000, frame_ms=4000.0), 2, 99),
    ("wide frame", dict(work_rate=16000, frame_ms=4000.0), 2, 199),
    ("wide frame", dict(work_rate=16000, frame_ms=4000.0), 8, 199),
    ("both", dict(work_rate=16000, frame_ms=2000.0, min_f0=0.5), 1, 4),
    ("both", dict(work_rate=16000, frame_ms=2000.0, min_f0=0.5), 1, 40),
)


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
    (``report.last_shape("fused_nccf")``)."""
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


def nccf_lag_bank_wavefronts(w: int, hop: int, min_lag: int, n_lags: int,
                             *, TM: int, R: int, lag_block: int,
                             sample_chunk: int) -> dict:
    """(warp-wide loads or stores, wavefronts) of one block of
    ``csrc/fused_nccf.cu``'s lag-blocked tiling, the first lag block of a
    full frame tile, for its shared-memory accesses: the staging of a
    chunk (``stage``, consecutive words), the numerator loop (per step
    A[j] and the window's new sample; warp k the 32 lag groups of frame
    k % TM in column k // TM), and the staged outputs (``outputs``: each
    thread's R lags, then the coalesced copy), in word addresses.  The
    tile is the one the C entry planned
    (``report.last_shape("fused_nccf")``)."""
    nl = min(lag_block, n_lags)
    jc = min(sample_chunk, w)
    na = (TM - 1) * hop + jc
    ne = na + nl + R - 2
    span_a = (TM - 1) * hop + sample_chunk
    out = {}
    loads = wf = 0
    for n, base in ((na, 0), (ne, span_a)):
        for i0 in range(0, n, 32):
            loads += 1
            wf += _wavefronts([base + i for i in range(i0, min(i0 + 32, n))])
    out["stage"] = (loads, wf)
    loads = wf = 0
    for k in range(8):
        m, c = k % TM, k // TM
        lanes = [(c * 32 + g) * R for g in range(32) if (c * 32 + g) * R < nl]
        if not lanes:
            continue
        for q in range(R - 1):
            loads += 1
            wf += _wavefronts([span_a + m * hop + l0 + q for l0 in lanes])
        for j in range(jc):
            loads += 2
            wf += _wavefronts([m * hop + j] * len(lanes))
            wf += _wavefronts([span_a + m * hop + l0 + j + R - 1
                               for l0 in lanes])
    out["numerator"] = (loads, wf)
    loads = wf = 0
    n_out = TM * nl
    for k in range(8):
        m, c = k % TM, k // TM
        lanes = [(c * 32 + g) * R for g in range(32) if (c * 32 + g) * R < nl]
        for r in range(R):
            addrs = [m * nl + l0 + r for l0 in lanes if l0 + r < nl]
            for half in (0, n_out):
                if addrs:
                    loads += 1
                    wf += _wavefronts([half + a for a in addrs])
    for i0 in range(0, 2 * n_out, 32):
        loads += 1
        wf += _wavefronts(range(i0, min(i0 + 32, 2 * n_out)))
    out["outputs"] = (loads, wf)
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


def build(names) -> dict:
    """The named ``nccf_*`` variants written under
    ``build/ablate_pitch/`` and built, one nvcc each, all at once ->
    {name: bound library} (launch one with :func:`fused_nccf.launch`)."""
    import concurrent.futures
    _ablate.write_variants("ablate_pitch", VARIANTS, names)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(
            lambda n: _build_one(n, "fused_nccf"), names)))


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


def lag_sweep(names, passes: int, smi: str) -> None:
    """Time the shipped ``fused_nccf.cu`` and the ``nccf_lag_*`` variants
    ``names`` on each of :data:`LAG_SHAPES` (seeded noise), in ``passes``
    passes in turns, each variant's outputs held to the shipped build's
    bit for bit; one line a shape."""
    import torch
    from .. import PitchConfig
    from ..ops.kernels import _build, fused_nccf
    libs = {"shipped": fused_nccf.bind(_build.load("fused_nccf")),
            **build(names)}
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    for name, kw, B, T in LAG_SHAPES:
        c = PitchConfig(**kw).validate()
        n = c.frame_len_w + c.max_lag + (T - 1) * c.hop_len_w
        xw = torch.from_numpy((0.3 * rng.standard_normal((B, n)))
                              .astype(np.float32)).to(dev)
        ball = torch.full((B,), 0.5, device=dev)
        runs = {k: fused_nccf.launch(lib, xw, ball, c, T)
                for k, lib in libs.items()}
        torch.cuda.synchronize()
        times = {k: [] for k in libs}
        for i in range(passes):
            for k in (list(libs) if i % 2 == 0 else list(libs)[::-1]):
                times[k].append(_ablate.ms(
                    lambda lib=libs[k]: fused_nccf.launch(lib, xw, ball, c, T),
                    CALLS))
        print(f"{name} (B={B}, T={T}, {c.n_lags} lags, w={c.frame_len_w}): "
              + "; ".join(
                  f"{k} R {r[2]['R']} TM {r[2]['TM']} Lb {r[2]['lag_block']} "
                  f"{np.median(times[k]):.4f} ms" + (
                      "" if all(torch.equal(a, b) for a, b in
                                zip(r[:2], runs["shipped"][:2]))
                      else " DIFFERS from shipped")
                  for k, r in runs.items()) + f" ({smi})", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=None,
                    help="comma-separated names of VARIANTS to build and time "
                    "(default: all but nccf_lag_R<r>; with --lag-shapes every "
                    "nccf_lag_R<r>)")
    ap.add_argument("--passes", type=int, default=4,
                    help="timing passes over the variants, in turns")
    ap.add_argument("--previous-csrc", default=None,
                    help="csrc/ of the previous design to hold against")
    ap.add_argument("--lag-shapes", action="store_true",
                    help="time nccf_lag_* variants on LAG_SHAPES instead")
    args = ap.parse_args(argv)
    variants = (args.variants.split(",") if args.variants else
                [v for v in VARIANTS
                 if v.startswith("nccf_lag_R") == args.lag_shapes])
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    if args.lag_shapes and not all(v.startswith("nccf_lag_")
                                   for v in variants):
        ap.error("--lag-shapes times nccf_lag_* variants only")
    import torch
    if not torch.cuda.is_available():
        print("ablate_pitch: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.lag_shapes:
        lag_sweep(variants, args.passes, _ablate.smi())
        return 0
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
