"""chip_smoke.py rehearsed on the CPU, so that a fault in one of its phases
shows here and not first on the card.

``torch.cuda`` is faked (synchronize, Event, device name and count), nvcc
is not called, ``backend.resolve`` routes "auto" to "cuda", and each kernel
wrapper counts a launch (and, for the four spectral kernels, the tile the
config picks) and runs its plain version on the CPU tensor it is given,
or, where the config picks the float64-front tile, the float64 oracle on
the kernel's own input in the call's projection (both at compute_dtype
float32, which the spectral kernels do not read) (the f32 plain versions
sit at the f32 valley floor, above that tile's oracle bound); a launch on
a named tile (phase 8's yardsticks) runs the plain chain.  Every phase then runs end to end at
a small size: the control flow, shapes, comparisons, launch and tile
accounting and the kernels' JSON record with its bounds.  Imports no jax.
"""

import importlib.util
import json
import os
import time

import torch

import numpy as np

from mfcc_tpu_torch import backend, oracle
from mfcc_tpu_torch.ops import framing
from mfcc_tpu_torch.ops.kernels import (_build, _spectral, fused_dit,
                                        fused_mfcc, fused_nccf, fused_raw,
                                        fused_raw_dit, fused_viterbi, routes)
from mfcc_tpu_torch.tools import roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRAPPERS = ((fused_raw_dit, "fused_features_raw_dit"),
            (fused_raw, "fused_features_raw"),
            (fused_dit, "fused_features_dit"),
            (fused_mfcc, "fused_features"),
            (fused_nccf, "fused_nccf"),
            (fused_viterbi, "fused_viterbi"))


class _Event:
    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


ORACLES = {"mel": oracle.log_mel, "bark": oracle.log_bark,
           "spec": oracle.log_spectrogram}
# the launch shapes the pitch kernels' C entries report at the default
# config (a stand-in: no C entry runs here)
SHAPES = {fused_nccf: {"TM": 32, "R": 9, "passes": 1, "shared_energy": 1,
                       "stage_out": 1},
          fused_viterbi: {"K": 1, "J": 72, "threads": 96, "register_path": 1,
                          "TB": 996, "score_chunk": 32}}


def _counting(mod, name):
    fn = getattr(mod, name)

    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(mod.__name__.split(".")[-1]):
            return launch(*args, **kwargs)

    def launch(*args, **kwargs):
        mod.LAUNCHES += 1
        if mod in SHAPES:
            mod.LAST_SHAPE = SHAPES[mod]
        x, cfg = args[:2]
        if hasattr(mod, "TILE_LAUNCHES"):   # the kernels read no compute_dtype
            cfg = cfg.replace(compute_dtype="float32")
            args = (x, cfg, *args[2:])
        projection = kwargs.get("projection", "mel")
        if hasattr(mod, "TILE_LAUNCHES") and x.shape[0] and \
                cfg.num_frames(x.shape[1]):
            tile = _spectral.fft_tile(cfg, kwargs.get("apply_dct", True),
                                      projection)
            mod.TILE_LAUNCHES[tile if tile in mod.TILE_LAUNCHES
                              else "dit"] += 1
            if hasattr(mod, "PROJECTION_LAUNCHES"):
                mod.PROJECTION_LAUNCHES[projection] += 1
            if tile == "fft64":
                c = cfg.replace(deltas=False)
                if mod in (fused_dit, fused_mfcc):
                    c = c.replace(preemph=0.0)
                return torch.from_numpy(np.stack([
                    ORACLES[projection](r, c) for r in x.double().numpy()
                ]).astype(np.float32))
        return fn(*args, **kwargs)

    return wrapper


def _launch_plain(lib_fn, entry, name, x, cfg, apply_dct, preemph,
                  other=None, tile=None, projection=None):
    """launch_spectral's stand-in: the plain chain, on the tile named."""
    y = framing.preemphasize(x, cfg) if preemph is not None else x
    return _spectral.plain_features(y, cfg, apply_dct,
                                    projection=projection or "mel"), tile


class _Rungs:
    """The roofline rungs' stand-ins: no build; a launch runs the rung's
    plain twin (fftlog: the kernel wrapper, which it equals on the card)
    and records the kernel's plan as the rung's block 0 would."""

    def __init__(self):
        self.plan = None

    def build(self, paths):
        return {(r, roofline.PATHS[p][0]): None for p in paths
                for r in roofline.BUILT}

    def launch(self, lib, path, x, rung):
        src, cfg, dct = roofline.PATHS[path]
        self.plan = roofline.plan(path, *x.shape)

        def run():
            roofline.LAUNCHES[rung] += 1
            return (roofline.kernel(path, x) if rung == "fftlog"
                    else roofline.plain_rung(rung, x, cfg, dct, src))
        return run(), run

    def launched_plan(self, lib):
        return {k: self.plan[k] for k in roofline.PLAN_KEYS}


def test_chip_smoke_phases_rehearsed_on_the_cpu(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name, value in (("BATCH", 8), ("SECONDS", 1.0), ("TIMING_CALLS", 2),
                        ("VITERBI_BATCHES", (1, 3)),
                        ("VITERBI_STEPS", (1, 2, 65)),
                        ("VITERBI_WIDE", 40), ("LONG_SECONDS", 12.0),
                        ("PACK_UTTERANCES", 6), ("PACK_SECONDS", (0.5, 1.5)),
                        ("PACK_BATCH", 2), ("PACK_CHECKS", 3),
                        ("PACK_TIMING", 1), ("POST_CHECKS", 2),
                        ("STREAM_CHUNK_FRAMES", 8), ("STREAM_K", 2),
                        ("STREAM_ORACLE_ROWS", 2),
                        ("RUNNER_UTTERANCES", 6),
                        ("RUNNER_SECONDS", (0.5, 1.5)), ("RUNNER_BATCH", 2),
                        ("RUNNER_PACK_SECONDS", 1.0), ("RUNNER_SUBSET", 4),
                        ("RUNNER_TRACE", 3), ("RUNNER_CHECKS", 2),
                        ("ONLINE_SECONDS", 3.0), ("ONLINE_STEP_CALLS", 3),
                        ("FEED_CHECKS", 1), ("DRYRUN_RANKS", 4),
                        ("PRECISION_CALLS", 2), ("PITCH_LONG_SECONDS", 3.0),
                        ("CHUNK_STREAM_SECONDS", 14.0),
                        ("CHUNK_HOUR_REPEATS", 2),
                        ("CHUNK_VOICED_SECONDS", 4.0), ("CHUNK_CALLS", 2)):
        monkeypatch.setattr(smoke, name, value)
    monkeypatch.setattr(smoke, "_smi", lambda: "Fake GPU, 700.00 W")
    monkeypatch.setattr(smoke, "_sm_clock_mhz", lambda: 1980.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "Fake GPU")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(_build, "load", lambda name: None)
    monkeypatch.setattr(_spectral, "launch_spectral", _launch_plain)
    rungs = _Rungs()
    for name in ("build", "launch", "launched_plan"):
        monkeypatch.setattr(roofline, name, getattr(rungs, name))
    monkeypatch.setattr(roofline, "LAUNCHES", dict(roofline.LAUNCHES))
    resolve = backend.resolve
    monkeypatch.setattr(backend, "resolve", lambda name, x, cfg: (
        "cuda" if name in ("auto", "cuda") and (
            cfg is None or routes.kernel_precision_supported(cfg))
        else resolve(name, x, cfg)))
    for mod, fn in WRAPPERS:
        monkeypatch.setattr(mod, "LAUNCHES", mod.LAUNCHES)   # restored after
        if mod in SHAPES:
            monkeypatch.setattr(mod, "LAST_SHAPE", mod.LAST_SHAPE)
        for counts in ("TILE_LAUNCHES", "PROJECTION_LAUNCHES"):
            if hasattr(mod, counts):
                monkeypatch.setattr(mod, counts, dict(getattr(mod, counts)))
        monkeypatch.setattr(mod, fn, _counting(mod, fn))

    kernels = smoke.run(torch, torch.device("cpu"))

    out = capsys.readouterr().out
    for phase in [*map(str, range(1, 22)), "3b", "3c", "3d", "4b", "4c"]:
        assert f"[{phase} " in out, phase
    # phase 21: each path's rungs held to their twins and the kernel's
    # plan, the ladder timed with its launches counted from 0
    for path, tm in (("fused_raw_dit", 16), ("fused_raw", 32),
                     ("fused_mfcc", 8)):
        assert f"[21 roofline] {path} (" in out and f"(TM {tm}, " in next(
            ln for ln in out.splitlines()
            if ln.startswith(f"[21 roofline] {path} ("))
        for rung in roofline.RUNGS:
            assert f"[21 roofline] {path} {rung}: " in out, (path, rung)
        assert f"[21 roofline] {path}: kernel_pct_of_attainable_ceiling " \
            in out
    assert "[21 roofline] rung launches of the ladder (counted from 0 just " \
        "before): {'stage': 201, 'fft': 201, 'fftlog': 201}" in out
    assert "[21 roofline] fused_raw_dit fft rung: " in out
    # phase 20: nccf_chunk= at each K on the stream and the batch, one
    # launch a call (the phase's own assertion), equal to unchunked
    for what, T in (("1 x 14 s stream", 1396), ("8 x 1 s ragged", 96)):
        for K in (4, 128, 512):
            line = next(ln for ln in out.splitlines() if ln.startswith(
                f"[20 chunked NCCF] {what} (T={T}), K={K}: one fused_nccf "
                "launch, "))
            assert "equal in every bit to nccf_chunk=None: True" in line, line
        assert f"[20 chunked NCCF] {what}: ms a call (CUDA events; host " \
            "ms) unchunked " in out
    assert "[20 chunked NCCF] K=3 refused: ValueError: nccf_chunk=3" in out
    assert "[20 chunked NCCF] 1 x 28 s row (T=2796): chunk rows K=512 " \
        "equal to unchunked in every bit: " in out
    assert "nccf_chunk=128 f0, voicing and mask equal to unchunked in " \
        "every bit: True" in out
    assert "[20 chunked NCCF] pitch_features(nccf_chunk=128) on a voiced " \
        "4 s vibrato (396 frames, launched fused_nccf/fused_viterbi (1, 1))" \
        in out
    assert "[20 chunked NCCF] the plain route on the host CPU (" in out
    # phase 15: the online stream, one fused_nccf launch a chunk (the
    # phase's own assertion), its twin, the kernel vs plain chunk NCCF
    assert "[15 online pitch] 3 s stream fed in 1600-sample pieces, delay " \
        "50, chunk_frames 16: 296 rows of 296 frames in 19 chunks; " \
        "launched fused_nccf 19 times" in out
    assert "[15 online pitch] vs online_pitch_np (float64, " in out
    assert "real-time factor " in out and "ms a chunk of 16 frames" in out
    for route in ("cuda", "torch"):
        assert f"[15 online pitch] online_chunk_step ({route})" in out
    assert "chunk at frame 288, n_valid 8 of 16: " in out
    assert "[15 online pitch] delay 306 >= T against pitch_batch" in out
    # phase 18: every setting of every family on both routes; "high" on
    # the plain chain, the others on the "highest" kernel (the phase's own
    # assertions), the forms alone and the training step
    for fam in ("mfcc_batch", "log_mel_batch", "plp_batch"):
        for setting in ("highest", "high", "default", "bf16"):
            for route in ("auto", "torch"):
                assert f"[18 precision modes] {fam} {setting} {route}: " \
                    "launched " in out, (fam, setting, route)
        assert f"[18 precision modes] {fam}: 'high' on the plain route, " \
            "equal to 'highest' there, within 0.00028 + " in out
        assert f"[18 precision modes] {fam} plain twins " in out
    assert "[18 precision modes] mfcc_batch high auto: launched no " \
        "spectral kernel (plain chain)" in out
    assert "[18 precision modes] log_mel_batch plain twins inside each " \
        "frame's 50 dB window: " in out
    assert "[18 precision modes] a caller's TF32 flags left as they were" \
        in out
    for form in ("highest", "high", "default", "bf16", "3xTF32"):
        assert f"[18 precision forms] {form}: (784, 400) x (400, 514) vs " \
            "float64" in out
    assert "[18 precision forms] train_step at 'default' on (8, 16000)" in out
    # phase 19: both prefix-sum forms on the batch and the long row
    for what in ("8 x 1 s ragged", "1 x 3 s"):
        for form in ("float64 prefix sums", "float32 torch.cumsum"):
            assert f"[19 pitch post stages] {what}, {form}: card vs CPU " \
                "on the same NCCF" in out, (what, form)
    # phase 17: the dry run in 4 CPU processes at the default config on
    # the 8 x 1 s batch (the plain path: no launch), its errors and times
    assert "[17 distributed step] dryrun_multichip(4): mesh dp 1 x sp 2 x " \
        "tp 2, 4 gloo processes on cpu, each 8 rows x 49 frames of the 8 x " \
        "1 s batch and 13 of 26 filterbank columns" in out
    assert "[17 distributed step] rank 0: dryrun_multichip OK: mesh dp=1 " \
        "sp=2 tp=2, feat (8, 98, 13)" in out
    assert "of Adam's first-step bound" in out
    assert "launches of the MFCC step by rank (counters reset just before, " \
        "read just after): [0, 0, 0, 0]" in out
    assert "training step sharded " in out and "Fake GPU, 700.00 W" in out
    # the online CMVN pair on both devices, and the cumsum window sums
    for nv in ("mean only", "variance"):
        assert out.count(f"online_cmvn_step (window 300, {nv}) over the "
                         f"fused mfcc stream of sessions 0-1, one step a "
                         f"dispatch, on the cpu: vs the batch online_cmvn "
                         ) == 2
    assert "[13 streaming] window-45 sums of squares from float32 " \
        "torch.cumsum on the cpu: " in out
    # phase 16: the feed's launches (the phase's own assertion), the
    # masks across devices, speed perturbation, the trainable front end
    for name in ("plain", "cmvn + augment"):
        line = next(ln for ln in out.splitlines() if ln.startswith(
            f"[16 training feed] feature_batches ({name}): "))
        assert ", 6 utterances, " in line and "'fused_raw_dit': 4" in line
    assert "plain batches equal mfcc_batch on the same rows bit for bit" \
        in out
    assert "[16 training feed] spec_augment, one seed: the card's output " \
        "equals the CPU's" in out
    for factor in ("0.9", "1.1"):
        assert f"[16 training feed] speed_perturb {factor} on 8 x 1 s" in out
    assert "[16 trainable] forward at init vs mfcc_batch through " \
        "fused_raw_dit on 8 x 1 s: " in out
    assert "[16 trainable] fit, 200 steps at lr 3e-3" in out
    # phase 14: the corpus runner's seven runs through the CLI, each with
    # its launches as expected (the counters' own assertions), read back
    for run in ("a mfcc npy", "b mfcc --pack", "c ark --cmvn",
                "d logmel-80 deltas", "e mfcc --pitch", "f resume of a",
                "g traced"):
        line = next(ln for ln in out.splitlines()
                    if ln.startswith(f"[14 corpus runner] {run}: exit "))
        assert "audio-sec/s; stages " in line and "Fake GPU, 700.00 W" in line
        assert run.startswith("f") or (
            "stages decode " in line and "fetch+write" in line)
    assert "[14 corpus runner] f resume of a: exit 1, 0 utterances" in out
    assert "'fused_nccf': 3, 'fused_viterbi': 3" in next(
        ln for ln in out.splitlines()
        if ln.startswith("[14 corpus runner] e mfcc --pitch: exit 0"))
    for key in "abde":
        assert f"[14 corpus runner] {key}: 2 utterances read back" in out
    assert "[14 corpus runner] b: " in out and " packed rows of 16000 " \
        "samples, fill " in out
    assert "[14 corpus runner] c: cmvn.npz equals numpy's float64" in out
    assert "[14 corpus runner] g: the Chrome trace holds " in out
    assert "[14 corpus runner] phase 14 passed in " in out
    # the slice-8 phases: packed families through their kernels, the
    # dither bits, the post chain, the fused serving path by variant
    for name, counter in (("mfcc", "'fused_raw_dit/mel': 1"),
                          ("logmel <= 50 dB", "'fused_raw_dit/mel': 1"),
                          ("logmel unbounded", "'fused_raw': 1"),
                          ("plp", "'fused_raw_dit/bark': 1"),
                          ("spec", "'fused_raw_dit/spec': 1")):
        line = next(ln for ln in out.splitlines() if ln.startswith(
            f"[10 packed corpus] {name}: mfcc_batch_packed on "))
        assert counter in line, line
    assert "segments within their bounds" in out
    assert "[10 packed corpus] packed: " in out and "fill " in out
    assert "[10 packed corpus] padded: " in out
    assert "[10 packed corpus] packed: one call of 2 rows, " in out
    assert "0 of 2097152 hash words differ from the uint32 reference" in out
    assert "[11 dither] all-zero row: c0 spread 0.000e+00 undithered" in out
    for name in ("sliding_cmvn", "online_cmvn", "splice", "energy_vad",
                 "cmvn.batch_stats", "cmvn.apply", "cmvn.host_batch_stats"):
        assert f"[12 post chain] {name}: " in out, name
    for v, proj in (("mfcc", "mel"), ("logmel", "mel"), ("plp", "bark"),
                    ("spec", "spec")):
        assert f"[13 streaming] {v}: process_chunks_batch_fused launched" in out
        assert f"'fused_raw_dit/{proj}': 3" in next(
            ln for ln in out.splitlines() if ln.startswith(
                f"[13 streaming] {v}: process_chunks_batch_fused launched"))
        assert f"[13 streaming] fused {v}: " in out and "ATen ops" in out
    assert "[13 streaming] online_cmvn_step" in out
    assert "[3b FFT tile vs plain] fused_mfcc cepstra, n_fft 4096" in out
    assert "fused_raw log-mel, unbounded log-mel, n_fft 4096, T=71: fft64 " \
        "tile" in out
    assert "fused_raw cepstra, n_fft 401 (fused_dit: 400): direct tile" in out
    assert "fused_dit cepstra, n_fft 401 (fused_dit: 400): dit tile" in out
    assert "Hann two-tone valley: fft64 tile" in out
    assert "fused_raw_dit/bark, direct tile, n_fft 401 (spec: 768): " \
        "direct tile" in out
    assert "fused_raw_dit/spec, Hann two-tone valley: fft64 tile" in out
    assert "at 16000 Hz, n_fft 400 (the reference's XLA route): launched " \
        "{'fused_raw_dit': 0, 'fused_raw': 0, 'fused_mfcc': 0, " \
        "'fused_dit': 0}" in out
    assert "[8 timing] PLP tail" in out and " ATen ops, host enqueue" in out
    assert "[8 timing] pitch_batch (cuda): " in out and \
        " back to back; of it fused_nccf " in out
    # the pitch kernels' extended phases: 5's tile and T = 1, 6's ties,
    # byte/uint16 boundary and unblocked stream, 8's per-step chain time
    assert "[5 NCCF kernel vs plain] T=1: tile {'TM': 32, 'R': 9" in out
    for case in ("tie-heavy (penalty=0, scores in {-1, 0, 1}), (B, T, n) "
                 "(64, 40, 71): 0 path entries differ",
                 "256 lags, (B, T, n) (4, 40, 256): 0 path entries differ",
                 "257 lags, (B, T, n) (4, 40, 257): 0 path entries differ",
                 "unblocked B=1 x 12 s, (B, T, n) (1, 1196, 71): 0 path"):
        assert f"[6 Viterbi kernel vs plain] {case}" in out, case
    assert "(the main path's launch shape {'K': 1, 'J': 72, 'threads': 96, " \
        "'register_path': 1" in out
    assert "[8 timing] fused_viterbi per step of its 95-step chain: " in out
    assert "against the chain bound 0.0404 us (80 cycles at 1980 MHz" in out
    assert "[9 summary] fused_nccf: the work the kernel does" in out
    assert "Fake GPU, 700.00 W" in out
    json.dumps({"kernels": kernels})
    assert [k["name"] for k in kernels] == [*smoke.KERNELS,
                                            *smoke.PROJECTIONS,
                                            "roofline_probe"]
    # launches are the main paths' own: one per batch call (fused_raw_dit:
    # two MFCC batches and the 50 dB log-mel batch; its bark and spec
    # projections one plp_batch and one log_spectrogram_batch), no golden
    # or check run
    assert {k["name"]: k["launches"] for k in kernels} == {
        "fused_raw_dit": 3, "fused_raw": 1, "fused_mfcc": 1, "fused_dit": 1,
        "fused_nccf": 1, "fused_viterbi": 1, "fused_raw_dit/bark": 1,
        "fused_raw_dit/spec": 1, "roofline_probe": 603}
    for k in kernels:
        assert k["route"] == "cuda" and k["launches"] > 0, k
        assert os.path.exists(os.path.join(REPO, k["source"])), k
        path, line = k["replaces"].split(":")
        assert os.path.exists(os.path.join(REPO, path)), k
        src = open(os.path.join(REPO, path)).read().splitlines()
        assert src[int(line) - 1].lstrip().startswith("def "), k
        assert k["ms"] > 0 and k["plain_ms"] > 0, k
        assert k["bound_ms"] > 0 and k["library_ms"] is None, k
        assert k["bound_by"] == ("chain" if k["name"] == "fused_viterbi"
                                 else k["bound_by"]), k
        assert k["bound_by"] in ("bytes", "operations", "chain"), k
    tiles = {k["name"]: k["tile"] for k in kernels}
    assert tiles == {"fused_raw_dit": "fft", "fused_mfcc": "fft",
                     "fused_raw": "fft64", "fused_dit": "fft64",
                     "fused_nccf": "direct", "fused_viterbi": None,
                     "fused_raw_dit/bark": "fft64",
                     "fused_raw_dit/spec": "fft64",
                     "roofline_probe": None}
    for k in kernels:
        spectral = k["name"].split("/")[0] in smoke.SPECTRAL
        projection = k["name"] in smoke.PROJECTIONS
        assert (k["direct_tile_ms"] is not None) == spectral, k
        assert (k["f32_tile_ms"] is not None) == (k["tile"] == "fft64"), k
        assert (k["rfft_stage_ms"] is not None) == (
            k["tile"] == "fft" or projection), k
    assert kernels[-2]["source"] == kernels[0]["source"]
    probe = kernels[-1]
    assert probe["replaces"] == "bench/roofline.py:162"
    assert probe["source"] == "mfcc_tpu_torch/tools/roofline.py"
    for key in ("rungs", "kernel_pct_of_attainable_ceiling",
                "stage_pct_of_hbm"):
        assert set(probe[key]) == set(roofline.PATHS), key
    assert all(set(r) == set(roofline.RUNGS) for r in probe["rungs"].values())
    assert probe["max_abs_err"] == 0.0   # on the CPU each rung is its twin
    # on the CPU the wrappers run the plain versions (the oracle where the
    # config picks the fft64 tile): the pitch kernels' differ in nothing,
    # the spectral kernels' by the f32 plain versions' own error
    errs = {k["name"]: k["max_abs_err"] for k in kernels}
    assert errs["fused_nccf"] == 0.0 and errs["fused_viterbi"] == 0
    assert all(errs[k] <= 1e-2 for k in smoke.SPECTRAL), errs
    assert all(errs[k] <= 2e-4 for k in smoke.PROJECTIONS), errs
    assert "0 differ in any bit" in out
