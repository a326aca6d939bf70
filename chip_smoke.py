#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main paths once on one NVIDIA GPU.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases, one status line each; any failure raises and exits non-zero:

1. device: torch / CUDA versions, the card, and its name and power limit
   as nvidia-smi reports them.  No card: exit 1, no CPU fallback.
2. build: compile the six kernel sources (``fused_raw_dit.cu``,
   ``fused_raw.cu``, ``fused_mfcc.cu``, ``fused_dit.cu``, ``fused_nccf.cu``,
   ``fused_viterbi.cu`` in ``mfcc_tpu_torch/ops/kernels/csrc/``) from this
   checkout with nvcc, one process per source, all at once; print ptxas's
   registers and spills.
3. MFCC kernel vs plain: ``fused_raw_dit`` against its plain PyTorch
   version on the card, same inputs, max abs diff <= 2e-5 (cepstra
   compared unliftered, as the repository's kernel tests do).
3b. spectral kernels vs plain: ``fused_raw``, ``fused_dit``,
   ``fused_mfcc`` and ``fused_raw_dit`` with ``apply_dct=False``, each at
   its main-path config (64 x 10 s), at the default config, on a ragged
   batch and at a frame count that is no tile multiple; cepstra <= 2e-5
   unliftered, log-mel within rtol 1e-4 plus atol 2e-5.
3c. accurate log: the kernels' ``acc_log`` on 2^20 floats (positive floats
   over the full exponent range, and floor values) bit-identical to
   ``ops/xmath``.
4. MFCC main path: ``models.mfcc.mfcc_batch`` on ragged int16 and float32
   batches, with the kernel's launch counter reset just before and read
   just after, then on the golden WAV.  Frame counts, masks and zeroed
   padding are exact; features are within 1e-4 of the float64 oracle and of
   the committed goldens.
4b. log-mel and fallback main paths, 64 x 10 s int16 ragged each, every
   spectral launch counter reset just before and read just after each (the
   golden WAV is run and counted apart):
   ``models.logmel.log_mel_batch`` at log-mel-80 + deltas (-> ``fused_raw``,
   and ``speech2s.wav`` vs ``logmel80_deltas.npy``), the same bounded to
   50 dB (-> ``fused_raw_dit``, ``apply_dct=False``), at the 22.05 kHz TTS
   geometry (-> ``fused_dit``), and ``mfcc_batch`` at 44.1 kHz (->
   ``fused_mfcc``).  Frame counts, masks and zero padding exact; features
   vs the float64 oracle within 1e-4, 1e-3 for unbounded log-mel (and the
   golden).
5. NCCF kernel vs plain: ``fused_nccf`` against the correlation-theorem
   ``ops.pitch.nccf`` given the same ballast, <= 2e-5 on valid frames, on
   stationary signals (the bench batch, ragged noise, four other configs,
   a frame count that is no tile multiple).
6. Viterbi kernel vs plain: ``fused_viterbi`` against ``ops.pitch.viterbi``
   on seeded random scores with zero-emission tails, paths exactly equal,
   for B in {1, 3, 64, 200} x T in {1, 2, 64, 65, 150, 996}, and
   ``viterbi_blocked`` on one 6-minute stream.
7. pitch main path: ``models.pitch.pitch_batch`` on the ragged int16
   64 x 10 s batch and on the golden WAV, and the MFCC + pitch composition
   (mfcc_batch, pitch_batch, align_pitch, mask, concatenation), each with
   its kernels' launch counters reset just before and read just after.
   Frame counts, masks and zeroed padding are exact; pitch columns meet the
   per-column contract (pov 1e-4, norm 3e-4, delta 1e-4) against the
   float64 oracle and ``pitch3.npy``, MFCC columns 1e-4.
8. timing (information, not a claim): each kernel and its plain version
   at its main-path config, ``mfcc_batch``, ``log_mel_batch`` and
   ``pitch_batch`` through the kernels and through plain PyTorch, at
   64 x 10 s, CUDA events, median over two passes.
9. the script's elapsed time, one JSON line describing the kernels, then
   the final JSON status line.

Run alone (without the ``mfcc_tpu_torch`` package beside it) or without a
card, it exits 1 and prints no result.

Imports nothing of JAX and nothing of the JAX package ``mfcc_tpu``.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")
KERNEL_TOL = 2e-5     # kernel vs XLA bound of tests/test_kernels.py
LOGMEL_RTOL = 1e-4    # log-mel kernel bound: rtol 1e-4 plus atol 2e-5
ORACLE_TOL = 1e-4     # feature contract vs the float64 oracle
LOGMEL_ORACLE_TOL = 1e-3   # unbounded log-mel vs oracle (test_golden.py)
PITCH_TOL = (1e-4, 3e-4, 1e-4)   # pov, norm, delta (tests/test_pitch.py)
KERNELS = ("fused_raw_dit", "fused_raw", "fused_mfcc", "fused_dit",
           "fused_nccf", "fused_viterbi")
SPECTRAL = ("fused_raw_dit", "fused_raw", "fused_mfcc", "fused_dit")
REPLACES = {"fused_raw_dit": "mfcc_tpu/ops/kernels/fused_raw_dit.py:555",
            "fused_raw": "mfcc_tpu/ops/kernels/fused_raw.py:335",
            "fused_mfcc": "mfcc_tpu/ops/kernels/fused_mfcc.py:200",
            "fused_dit": "mfcc_tpu/ops/kernels/fused_dit.py:246",
            "fused_nccf": "mfcc_tpu/ops/kernels/fused_nccf.py:249",
            "fused_viterbi": "mfcc_tpu/ops/kernels/fused_viterbi.py:149"}

# sizes of the main paths and of the checks
BATCH, SECONDS = 64, 10.0
TIMING_CALLS = 30
VITERBI_BATCHES = (1, 3, 64, 200)
VITERBI_STEPS = (1, 2, 64, 65, 150, 996)
LONG_SECONDS = 360.0


def _log(msg: str) -> None:
    print(msg, flush=True)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _bench_audio(batch: int, seconds: float, sr: int) -> np.ndarray:
    """The bench.py signal: two tones plus noise, numpy seed 0."""
    n = int(seconds * sr)
    rng = np.random.default_rng(0)
    t = np.arange(n) / sr
    base = (0.3 * np.sin(2 * np.pi * 180 * t)
            + 0.1 * np.sin(2 * np.pi * 1200 * t)).astype(np.float32)
    audio = np.tile(base, (batch, 1))
    audio += 0.02 * rng.standard_normal(audio.shape).astype(np.float32)
    return audio


def _int16(audio: np.ndarray) -> np.ndarray:
    return np.round(np.clip(audio, -1.0, 32767 / 32768) * 32768).astype(np.int16)


def _time_ms(torch, fn, warmup: int = 3, calls: int = 30) -> list[float]:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _columns_err(got: np.ndarray, want: np.ndarray, tols) -> list[float]:
    assert got.shape == want.shape, (got.shape, want.shape)
    errs = [float(np.abs(got[..., i] - want[..., i]).max()) if got.size
            else 0.0 for i in range(len(tols))]
    assert all(e <= t for e, t in zip(errs, tols)), (errs, tols)
    return errs


def _fmt(errs) -> str:
    return "/".join(f"{e:.2e}" for e in errs)


def _build_all(_build) -> None:
    """nvcc for every kernel source at once (one process each)."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_build.load, KERNELS))
    _log(f"[2 build] {', '.join(k + '.cu' for k in KERNELS)} built and "
         f"loaded in {time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        log = _build.library_path(name).with_suffix(".log")
        for ln in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in ln or "spill" in ln:
                _log(f"  ptxas {name}: {ln.strip()}")


def _mfcc_kernel_vs_plain(torch, dev, bench) -> float:
    from mfcc_tpu_torch import FeatureConfig, oracle
    from mfcc_tpu_torch.ops.kernels import fused_raw_dit
    cfg = FeatureConfig().validate()
    sr = cfg.sample_rate
    rng = np.random.default_rng(1)
    ragged_lens = (sr, 12345, 4000)
    ragged = np.zeros((3, sr), np.float32)
    for i, n in enumerate(ragged_lens):
        ragged[i, :n] = 0.3 * rng.standard_normal(n)
    cases = [
        (f"bench {bench.shape[0]} x {bench.shape[1] / sr:g} s", cfg, bench),
        ("B=3 ragged (frames inside each length)", cfg, ragged),
        ("N not a tile multiple (T=207)",
         cfg, 0.3 * rng.standard_normal((2, 33360)).astype(np.float32)),
        ("N=399, T=0", cfg, 0.3 * rng.standard_normal((2, 399)).astype(np.float32)),
        ("lifter=22, append_energy=True",
         cfg.replace(lifter=22, append_energy=True), bench[:4, :3 * sr]),
        ("dynamic_range_db=50", cfg.replace(dynamic_range_db=50.0),
         bench[:4, :3 * sr]),
        ("8 kHz, n_fft 256", FeatureConfig(sample_rate=8000, n_fft=256),
         0.3 * rng.standard_normal((2, 8000)).astype(np.float32)),
        ("48 kHz, n_fft 2048", FeatureConfig(sample_rate=48000, n_fft=2048),
         0.3 * rng.standard_normal((2, 48000)).astype(np.float32)),
    ]
    kernel_err = 0.0
    for name, c, audio in cases:
        x = torch.from_numpy(np.ascontiguousarray(audio)).to(dev)
        got = fused_raw_dit.fused_features_raw_dit(x, c)
        torch.cuda.synchronize()
        want = fused_raw_dit.plain_features(x, c)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (x.shape[0], c.num_frames(x.shape[1]),
                                           c.n_mfcc), (name, got.shape)
        lift = torch.from_numpy(oracle.lifter_coeffs(c.n_mfcc, c.lifter)
                                .astype(np.float32)).to(dev)
        diff = (got - want) / lift
        raw = float(diff.abs().max()) if got.numel() else 0.0
        if audio is ragged:
            # the main path zeroes frames past each length; an all-zero
            # frame's c0 is ~-117, where 2e-5 is ~3 f32 ulps, so the
            # summation order alone moves it past the bound
            keep = torch.arange(got.shape[1], device=dev)[None, :] < \
                torch.tensor([c.num_frames(n) for n in ragged_lens],
                             device=dev)[:, None]
            diff = diff[keep]
        err = float(diff.abs().max()) if diff.numel() else 0.0
        assert bool(torch.isfinite(got).all()), name
        _log(f"[3 MFCC kernel vs plain] {name}: shape {tuple(got.shape)}, "
             f"max abs diff {err:.3e} (all frames {raw:.3e})")
        assert err <= KERNEL_TOL, (name, err)
        kernel_err = max(kernel_err, err)
    return kernel_err


def _mfcc_main_path(torch, dev, bench) -> int:
    from mfcc_tpu_torch import FeatureConfig, oracle
    from mfcc_tpu_torch.models import mfcc as mfcc_model
    from mfcc_tpu_torch.ops.kernels import fused_raw_dit
    from mfcc_tpu_torch.utils import wav
    cfg = FeatureConfig().validate()
    sr = cfg.sample_rate
    lens = np.minimum([160000, 151234, 100000, 48000, 16000, 8001, 400, 399],
                      bench.shape[1]).astype(np.int32)
    audio = bench[: len(lens)].copy()
    for i, n in enumerate(lens):
        audio[i, n:] = 0.0
    x16 = _int16(audio)
    speech, speech_sr = wav.read_wav(os.path.join(GOLDEN, "speech2s.wav"))
    assert speech_sr == sr
    goldens = [
        ("mfcc13.npy", cfg, 1.0),
        ("mfcc13_center.npy", cfg.replace(frame_mode="center"), 1.0),
        ("mfcc13_energy_lifter.npy", cfg.replace(lifter=22, append_energy=True),
         oracle.lifter_coeffs(13, 22)),
    ]

    fused_raw_dit.LAUNCHES = 0
    outs = {}
    for tag, arr in (("int16", x16), ("float32", audio)):
        outs[tag] = mfcc_model.mfcc_batch(
            torch.from_numpy(arr).to(dev), torch.from_numpy(lens).to(dev), cfg)
    torch.cuda.synchronize()
    launches = fused_raw_dit.LAUNCHES
    _log(f"[4 MFCC main path] mfcc_batch on the two ragged batches launched "
         f"the kernel {launches} times")
    assert launches > 0, "the MFCC main path did not go through the kernel"
    gold_out = []
    for fname, c, _ in goldens:
        f, _, _ = mfcc_model.mfcc_batch(
            torch.from_numpy(speech[None]).to(dev),
            torch.tensor([len(speech)], dtype=torch.int32, device=dev), c)
        gold_out.append(f)
    torch.cuda.synchronize()

    for tag, (feat, flens, mask) in outs.items():
        T = cfg.num_frames(audio.shape[1])
        want_fl = np.array([cfg.num_frames(int(n)) for n in lens])
        assert feat.shape == (len(lens), T, cfg.n_mfcc), feat.shape
        assert (flens.cpu().numpy() == want_fl).all(), flens
        assert (mask.cpu().numpy() == (np.arange(T)[None] < want_fl[:, None])).all()
        f = feat.cpu().numpy()
        assert np.isfinite(f).all()
        assert (f[~mask.cpu().numpy()] == 0.0).all(), "padded frames not zero"
        src = (x16[0].astype(np.float64) / 32768.0 if tag == "int16"
               else audio[0].astype(np.float64))
        ref = oracle.mfcc(src[: lens[0]], cfg)
        err = float(np.abs(f[0, : ref.shape[0]] - ref).max())
        _log(f"[4 MFCC main path] {tag} ragged batch {tuple(f.shape)}: flens, "
             f"mask, zero padding exact; utterance 0 vs float64 oracle "
             f"{err:.3e}")
        assert err <= ORACLE_TOL, (tag, err)
    for (fname, c, lift), f in zip(goldens, gold_out):
        want = np.load(os.path.join(GOLDEN, fname))
        got = f[0].cpu().numpy()
        assert got.shape == want.shape, (fname, got.shape, want.shape)
        err = float(np.abs(got / lift - want / lift).max())
        _log(f"[4 MFCC main path] speech2s.wav vs {fname}: {err:.3e}")
        assert err <= ORACLE_TOL, (fname, err)
    return launches


def _slice3_configs() -> dict:
    """The main-path config of each spectral kernel of the log-mel slice,
    by the kernel the port's route gives it."""
    from mfcc_tpu_torch import FeatureConfig
    logmel80 = FeatureConfig(n_mels=80, n_mfcc=80, deltas=True)
    return {
        "fused_raw": logmel80,                           # BASELINE config 3
        "fused_raw_dit": logmel80.replace(dynamic_range_db=50.0),
        "fused_dit": FeatureConfig(sample_rate=22050, frame_ms=46.44,
                                   hop_ms=11.61, n_fft=1024, n_mels=80,
                                   n_mfcc=80),          # 22.05 kHz TTS
        "fused_mfcc": FeatureConfig(sample_rate=44100, n_fft=2048),
    }


def _spectral_wrappers():
    """kernel name -> (module, wrapper name, takes raw audio)."""
    from mfcc_tpu_torch.ops.kernels import (fused_dit, fused_mfcc,
                                            fused_raw, fused_raw_dit)
    return {"fused_raw_dit": (fused_raw_dit, "fused_features_raw_dit", True),
            "fused_raw": (fused_raw, "fused_features_raw", True),
            "fused_mfcc": (fused_mfcc, "fused_features", False),
            "fused_dit": (fused_dit, "fused_features_dit", False)}


def _noise(rng, shape) -> np.ndarray:
    return (0.3 * rng.standard_normal(shape)).astype(np.float32)


def _spectral_kernels_vs_plain(torch, dev) -> dict:
    """Phase 3b: -> {kernel: max abs diff over its cases}."""
    from mfcc_tpu_torch import FeatureConfig, oracle
    from mfcc_tpu_torch.ops import framing
    rng = np.random.default_rng(4)
    wrappers = _spectral_wrappers()
    worst = {}
    for name, path_cfg in _slice3_configs().items():
        module, fn, raw = wrappers[name]
        apply_dct = name == "fused_mfcc"
        sr, fl, hop = path_cfg.sample_rate, path_cfg.frame_len, path_cfg.hop_len
        ragged_lens = (sr, sr * 3 // 4 + 123, sr // 4)
        ragged = np.zeros((3, sr), np.float32)
        for i, n in enumerate(ragged_lens):
            ragged[i, :n] = _noise(rng, n)
        cases = [
            (f"bench {BATCH} x {SECONDS:g} s", path_cfg, apply_dct,
             _bench_audio(BATCH, SECONDS, sr), None),
            ("default config", FeatureConfig(), name != "fused_raw_dit",
             _noise(rng, (2, 16000)), None),
            ("B=3 ragged (frames inside each length)", path_cfg, apply_dct,
             ragged, ragged_lens),
            ("T=70, not a tile multiple", path_cfg, apply_dct,
             _noise(rng, (2, 69 * hop + fl)), None),
        ]
        worst[name] = 0.0
        for case, c, dct, audio, lens in cases:
            c = c.validate()
            x = torch.from_numpy(np.ascontiguousarray(audio)).to(dev)
            if not raw:
                x = framing.preemphasize(x, c).contiguous()
            got = getattr(module, fn)(x, c, apply_dct=dct)
            torch.cuda.synchronize()
            want = module.plain_features(x, c, dct)
            torch.cuda.synchronize()
            assert got.shape == want.shape == (
                x.shape[0], c.num_frames(x.shape[1]),
                c.n_mfcc if dct else c.n_mels), (name, case, got.shape)
            assert bool(torch.isfinite(got).all()), (name, case)
            if lens is not None:
                keep = torch.arange(got.shape[1], device=dev)[None, :] < \
                    torch.tensor([c.num_frames(n) for n in lens],
                                 device=dev)[:, None]
                got, want = got[keep], want[keep]
            diff = got - want
            if dct:
                lift = torch.from_numpy(oracle.lifter_coeffs(
                    c.n_mfcc, c.lifter).astype(np.float32)).to(dev)
                diff = diff / lift
                excess = float(diff.abs().max()) - KERNEL_TOL
            else:
                excess = float((diff.abs() - LOGMEL_RTOL * want.abs()).max()
                               ) - KERNEL_TOL
            err = float(diff.abs().max())
            bound = ("2e-5 unliftered" if dct
                     else "rtol 1e-4 + atol 2e-5")
            _log(f"[3b spectral kernels vs plain] {name} "
                 f"{'cepstra' if dct else 'log-mel'}, {case}: shape "
                 f"{tuple(got.shape)}, max abs diff {err:.3e} "
                 f"(bound {bound}, margin {-excess:.3e})")
            assert excess <= 0.0, (name, case, err)
            worst[name] = max(worst[name], err)
    return worst


def _acc_log_bits(torch, dev) -> int:
    """Phase 3c: the kernels' acc_log against ops/xmath, bit for bit."""
    from mfcc_tpu_torch.ops import xmath
    from mfcc_tpu_torch.ops.kernels import fused_mfcc
    rng = np.random.default_rng(5)
    floors = np.float32([1e-10, 1e-12, 1e-5, 1e-7, 1.0, 2.0,
                         np.finfo(np.float32).tiny, np.finfo(np.float32).max])
    bits = rng.integers(1, 0x7F800000, size=(1 << 20) - floors.size,
                        dtype=np.int64).astype(np.uint32)
    x = torch.from_numpy(np.concatenate([bits.view(np.float32), floors]))
    got = fused_mfcc.acc_log(x.to(dev)).cpu()
    want = xmath._acc_log(x)
    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    _log(f"[3c accurate log] CUDA acc_log vs ops/xmath on {x.numel()} "
         f"floats (full exponent range, subnormals and floors): {bad} "
         f"differ in any bit")
    assert bad == 0, bad
    return bad


def _logmel_main_paths(torch, dev) -> dict:
    """Phase 4b: -> {kernel: launches in its main path's run}."""
    from mfcc_tpu_torch import oracle
    from mfcc_tpu_torch.models import logmel as logmel_model
    from mfcc_tpu_torch.models import mfcc as mfcc_model
    from mfcc_tpu_torch.utils import wav
    modules = {k: m for k, (m, _, _) in _spectral_wrappers().items()}
    speech, _ = wav.read_wav(os.path.join(GOLDEN, "speech2s.wav"))
    launches = {}
    for name, cfg in _slice3_configs().items():
        cfg = cfg.validate()
        cepstra = name == "fused_mfcc"
        entry = mfcc_model.mfcc_batch if cepstra else logmel_model.log_mel_batch
        bench = _bench_audio(BATCH, SECONDS, cfg.sample_rate)
        B, N = bench.shape
        lens = np.maximum(N - np.arange(B) * (N // (B + 6)), 0).astype(np.int32)
        lens[-2:] = (cfg.frame_len, cfg.frame_len - 1)   # 1 frame, 0 frames
        audio = bench.copy()
        for i, n in enumerate(lens):
            audio[i, n:] = 0.0
        x16 = _int16(audio)

        for m in modules.values():
            m.LAUNCHES = 0
        feat, flens, mask = entry(torch.from_numpy(x16).to(dev),
                                  torch.from_numpy(lens).to(dev), cfg)
        torch.cuda.synchronize()
        counts = {k: m.LAUNCHES for k, m in modules.items()}
        _log(f"[4b log-mel and fallback main paths] "
             f"{entry.__name__} ({name} route) launched {counts}")
        assert counts[name] > 0 and sum(counts.values()) == counts[name], \
            f"the {name} main path did not go through {name} alone"
        launches[name] = counts[name]
        gold = None
        if name == "fused_raw":      # the golden WAV, counted on its own
            for m in modules.values():
                m.LAUNCHES = 0
            gold = logmel_model.log_mel(torch.from_numpy(speech).to(dev), cfg)
            torch.cuda.synchronize()
            assert modules[name].LAUNCHES > 0, \
                "log_mel on speech2s.wav did not go through fused_raw"

        T = cfg.num_frames(N)
        width = (cfg.n_mfcc if cepstra else cfg.n_mels) * (
            3 if cfg.deltas else 1)
        want_fl = np.array([cfg.num_frames(int(n)) for n in lens])
        f, m = feat.cpu().numpy(), mask.cpu().numpy()
        assert f.shape == (B, T, width), f.shape
        assert (flens.cpu().numpy() == want_fl).all(), flens
        assert (m == (np.arange(T)[None] < want_fl[:, None])).all()
        assert np.isfinite(f).all() and (f[~m] == 0.0).all()
        tol = (LOGMEL_ORACLE_TOL if not cepstra and cfg.dynamic_range_db is None
               else ORACLE_TOL)
        ref = oracle.mfcc if cepstra else oracle.log_mel
        xf = x16.astype(np.float64) / 32768.0
        for i in (0, B // 2, B - 2):
            want = ref(xf[i, : lens[i]], cfg)
            err = float(np.abs(f[i, : want.shape[0]] - want).max())
            _log(f"[4b log-mel and fallback main paths] {name}: int16 ragged "
                 f"batch {f.shape}, row {i} ({want.shape[0]} frames) vs "
                 f"float64 oracle {err:.3e} (bound {tol:g})")
            assert err <= tol, (name, i, err)
        if gold is not None:
            want = np.load(os.path.join(GOLDEN, "logmel80_deltas.npy"))
            got = gold.cpu().numpy()
            assert got.shape == want.shape, (got.shape, want.shape)
            err = float(np.abs(got - want).max())
            _log(f"[4b log-mel and fallback main paths] speech2s.wav vs "
                 f"logmel80_deltas.npy: {err:.3e} (bound "
                 f"{LOGMEL_ORACLE_TOL:g})")
            assert err <= LOGMEL_ORACLE_TOL, err
    return launches


def _nccf_inputs(torch, dev, pcfg, audio, lens):
    """Work-rate rows, valid frame counts and the wrapper-side ballast of a
    (B, N) batch, on the card."""
    from mfcc_tpu_torch.ops import pitch as pitch_op, resample
    x = torch.from_numpy(np.ascontiguousarray(audio)).to(dev)
    xw = resample.resample(x, pcfg.sample_rate, pcfg.work_rate)
    T = pcfg.num_frames(audio.shape[1])
    flens = np.array([pcfg.num_frames(int(n)) for n in lens])
    mask = torch.from_numpy(np.arange(T)[None, :] < flens[:, None]).to(dev)
    mean_e = pitch_op.mean_frame_energy(xw, pcfg, mask)
    return xw, pcfg.ballast * mean_e * mean_e, T, flens


def _nccf_kernel_vs_plain(torch, dev, bench) -> float:
    from mfcc_tpu_torch import PitchConfig
    from mfcc_tpu_torch.ops.kernels import fused_nccf
    pcfg = PitchConfig().validate()
    sr = pcfg.sample_rate
    rng = np.random.default_rng(2)
    ragged_lens = (2 * sr, 23456, 4000)
    ragged = np.zeros((3, 2 * sr), np.float32)
    for i, n in enumerate(ragged_lens):
        ragged[i, :n] = 0.3 * rng.standard_normal(n)
    short = bench[:4, :3 * sr]
    full = [bench.shape[1]] * bench.shape[0]
    cases = [
        (f"bench {bench.shape[0]} x {bench.shape[1] / sr:g} s", pcfg, bench,
         full),
        ("B=3 ragged noise", pcfg, ragged, ragged_lens),
        ("work_rate=2000", pcfg.replace(work_rate=2000), short, [3 * sr] * 4),
        ("min_f0=60, max_f0=300", pcfg.replace(min_f0=60.0, max_f0=300.0),
         short, [3 * sr] * 4),
        ("hop_ms=15.25", pcfg.replace(hop_ms=15.25), short, [3 * sr] * 4),
        ("T=205, not a tile multiple", pcfg,
         0.3 * rng.standard_normal((2, 33360)).astype(np.float32), [33360] * 2),
    ]
    worst = 0.0
    for name, c, audio, lens in cases:
        xw, ball, T, flens = _nccf_inputs(torch, dev, c.validate(), audio, lens)
        got = fused_nccf.fused_nccf(xw, ball, c, T=T)
        torch.cuda.synchronize()
        want = fused_nccf.plain_nccf(xw, ball, c, T)
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got, want):
            assert g.shape == w.shape == (audio.shape[0], T, c.n_lags)
            assert bool(torch.isfinite(g).all()), name
            for i, v in enumerate(flens):
                if v:
                    err = max(err, float((g[i, :v] - w[i, :v]).abs().max()))
        _log(f"[5 NCCF kernel vs plain] {name}: shape "
             f"{tuple(got[0].shape)}, max abs diff {err:.3e} on valid frames")
        assert err <= KERNEL_TOL, (name, err)
        worst = max(worst, err)
    return worst


def _viterbi_kernel_vs_plain(torch, dev) -> int:
    from mfcc_tpu_torch import PitchConfig
    from mfcc_tpu_torch.ops import pitch as pitch_op
    from mfcc_tpu_torch.ops.kernels import fused_viterbi
    pcfg = PitchConfig()
    rng = np.random.default_rng(3)

    def scores(B, T):
        s = (0.5 * rng.standard_normal((B, T, pcfg.n_lags))).astype(np.float32)
        s[1::2, T * 2 // 3:] = 0.0           # zero-emission tails
        return torch.from_numpy(s).to(dev)

    bad = 0
    for B in VITERBI_BATCHES:
        for T in VITERBI_STEPS:
            s = scores(B, T)
            got = fused_viterbi.fused_viterbi(s, pcfg)
            torch.cuda.synchronize()
            want = pitch_op.viterbi(s, pcfg)
            assert got.dtype == want.dtype == torch.int32
            assert got.shape == want.shape == (B, T)
            bad += int((got != want).sum())
    _log(f"[6 Viterbi kernel vs plain] B in {VITERBI_BATCHES} x T in "
         f"{VITERBI_STEPS}: {bad} path entries differ")
    n = int(LONG_SECONDS * pcfg.sample_rate)
    s = scores(1, pcfg.num_frames(n))
    got = pitch_op.viterbi_blocked(s, pcfg, backend="cuda")
    torch.cuda.synchronize()
    want = pitch_op.viterbi_blocked(s, pcfg, backend="torch")
    long_bad = int((got != want).sum())
    _log(f"[6 Viterbi kernel vs plain] viterbi_blocked, B=1 x "
         f"{LONG_SECONDS:g} s (T={s.shape[1]}): {long_bad} path entries "
         f"differ")
    bad += long_bad
    assert bad == 0, bad
    return bad


def _pitch_for(cfg):
    """The PitchConfig the MFCC + pitch composition uses with a
    FeatureConfig: the same frame and hop (align_pitch pastes pitch frame t
    onto main frame t) and a work rate capped at the input rate."""
    from mfcc_tpu_torch import PitchConfig
    return PitchConfig(sample_rate=cfg.sample_rate, frame_ms=cfg.frame_ms,
                       hop_ms=cfg.hop_ms,
                       work_rate=min(4000, cfg.sample_rate)).validate()


def _mfcc_plus_pitch(torch, x, lens, cfg):
    """(B, N), (B,) -> ((B, T, n_mfcc + 3), flens, mask): MFCC with the
    aligned pitch features appended, padded frames zero."""
    from mfcc_tpu_torch.models import mfcc as mfcc_model, pitch as pitch_model
    feat, flens, mask = mfcc_model.mfcc_batch(x, lens, cfg)
    pf, pl, _ = pitch_model.pitch_batch(x, lens, _pitch_for(cfg))
    pf = pitch_model.align_pitch(pf, pl, feat.shape[1])
    pf = torch.where(mask[..., None], pf, 0.0)
    return torch.cat([feat, pf], dim=-1), flens, mask


def _pitch_main_path(torch, dev, bench) -> dict:
    from mfcc_tpu_torch import FeatureConfig, PitchConfig, oracle
    from mfcc_tpu_torch.models import pitch as pitch_model
    from mfcc_tpu_torch.ops.kernels import (fused_nccf, fused_raw_dit,
                                            fused_viterbi)
    from mfcc_tpu_torch.utils import wav
    pcfg = PitchConfig().validate()
    cfg = FeatureConfig().validate()
    B, N = bench.shape
    lens = np.maximum(N - np.arange(B) * (N // (B + 6)), 0).astype(np.int32)
    lens[-2:] = (720, 715)                   # 1 pitch frame, 0 pitch frames
    audio = bench.copy()
    for i, n in enumerate(lens):
        audio[i, n:] = 0.0
    x16 = _int16(audio)
    speech, _ = wav.read_wav(os.path.join(GOLDEN, "speech2s.wav"))
    xd = torch.from_numpy(x16).to(dev)
    ld = torch.from_numpy(lens).to(dev)

    fused_nccf.LAUNCHES = fused_viterbi.LAUNCHES = 0
    feat, flens, mask = pitch_model.pitch_batch(xd, ld, pcfg)
    torch.cuda.synchronize()
    launches = {"fused_nccf": fused_nccf.LAUNCHES,
                "fused_viterbi": fused_viterbi.LAUNCHES}
    _log(f"[7 pitch main path] pitch_batch launched {launches}")
    assert all(v > 0 for v in launches.values()), \
        "the pitch main path did not go through both kernels"

    fused_nccf.LAUNCHES = fused_viterbi.LAUNCHES = fused_raw_dit.LAUNCHES = 0
    comb, cfl, cmask = _mfcc_plus_pitch(torch, xd, ld, cfg)
    torch.cuda.synchronize()
    comb_launches = {"fused_raw_dit": fused_raw_dit.LAUNCHES,
                     "fused_nccf": fused_nccf.LAUNCHES,
                     "fused_viterbi": fused_viterbi.LAUNCHES}
    _log(f"[7 pitch main path] the MFCC + pitch composition launched "
         f"{comb_launches}")
    assert all(v > 0 for v in comb_launches.values()), \
        "the MFCC + pitch composition did not go through all three kernels"
    gold, gold_fl, _ = pitch_model.pitch_batch(
        torch.from_numpy(speech[None]).to(dev),
        torch.tensor([len(speech)], dtype=torch.int32, device=dev), pcfg)
    torch.cuda.synchronize()

    T = pcfg.num_frames(N)
    want_fl = np.array([pcfg.num_frames(int(n)) for n in lens])
    f, m = feat.cpu().numpy(), mask.cpu().numpy()
    assert f.shape == (B, T, 3), f.shape
    assert (flens.cpu().numpy() == want_fl).all(), flens
    assert (m == (np.arange(T)[None] < want_fl[:, None])).all()
    assert np.isfinite(f).all()
    assert (f[~m] == 0.0).all(), "padded frames not zero"
    xf = x16.astype(np.float64) / 32768.0
    for i in (0, B // 2, B - 2):
        want = oracle.pitch(xf[i, : lens[i]], pcfg)
        errs = _columns_err(f[i, : want.shape[0]], want, PITCH_TOL)
        _log(f"[7 pitch main path] int16 ragged batch {f.shape}, row {i} "
             f"({want.shape[0]} frames) vs float64 oracle, pov/norm/delta "
             f"{_fmt(errs)}")
    want = np.load(os.path.join(GOLDEN, "pitch3.npy"))
    assert int(gold_fl[0]) == want.shape[0]
    errs = _columns_err(gold[0].cpu().numpy(), want, PITCH_TOL)
    _log(f"[7 pitch main path] speech2s.wav vs pitch3.npy, pov/norm/delta "
         f"{_fmt(errs)}")

    c, cm = comb.cpu().numpy(), cmask.cpu().numpy()
    Tm = cfg.num_frames(N)
    assert c.shape == (B, Tm, cfg.n_mfcc + 3), c.shape
    assert (cfl.cpu().numpy() == [cfg.num_frames(int(n)) for n in lens]).all()
    assert np.isfinite(c).all() and (c[~cm] == 0.0).all()
    assert (c[B - 1, :, cfg.n_mfcc:] == 0.0).all(), "no pitch frames -> 0"
    for i in (0, B - 2):
        ref = oracle.mfcc(xf[i, : lens[i]], cfg)
        pw = oracle.pitch(xf[i, : lens[i]], _pitch_for(cfg))
        pw = pw[np.minimum(np.arange(ref.shape[0]), pw.shape[0] - 1)]
        got = c[i, : ref.shape[0]]
        merr = float(np.abs(got[:, : cfg.n_mfcc] - ref).max())
        assert merr <= ORACLE_TOL, merr
        errs = _columns_err(got[:, cfg.n_mfcc:], pw, PITCH_TOL)
        _log(f"[7 pitch main path] MFCC + pitch {c.shape}, row {i} vs "
             f"float64 oracles: MFCC {merr:.3e}, pov/norm/delta {_fmt(errs)}")
    return launches


def _timing(torch, dev, bench, smi) -> dict:
    from mfcc_tpu_torch import FeatureConfig, PitchConfig
    from mfcc_tpu_torch.models import logmel as logmel_model
    from mfcc_tpu_torch.models import mfcc as mfcc_model, pitch as pitch_model
    from mfcc_tpu_torch.ops import framing, pitch as pitch_op
    from mfcc_tpu_torch.ops.kernels import (fused_nccf, fused_raw_dit,
                                            fused_viterbi)
    cfg, pcfg = FeatureConfig(), PitchConfig()
    B, N = bench.shape
    xb = torch.from_numpy(bench).to(dev)
    lb = torch.full((B,), N, dtype=torch.int32, device=dev)
    xw, ball, T, _ = _nccf_inputs(torch, dev, pcfg, bench, [N] * B)
    scores = fused_nccf.plain_nccf(xw, ball, pcfg, T)[0]   # every frame valid
    slow = max(2, TIMING_CALLS // 3)     # the plain Viterbi's T-step loop
    runs = {
        "fused_raw_dit": (lambda: fused_raw_dit.fused_features_raw_dit(xb, cfg),
                          TIMING_CALLS),
        "fused_raw_dit plain": (lambda: fused_raw_dit.plain_features(xb, cfg),
                                TIMING_CALLS),
    }
    # the log-mel slice's kernels, each at its main-path config
    configs = _slice3_configs()
    for name, (module, fn, raw) in _spectral_wrappers().items():
        if name == "fused_raw_dit":
            continue
        c, dct = configs[name], name == "fused_mfcc"
        audio = torch.from_numpy(_bench_audio(B, SECONDS, c.sample_rate)).to(dev)
        inp = audio if raw else framing.preemphasize(audio, c).contiguous()
        runs[name] = (functools.partial(getattr(module, fn), inp, c,
                                        apply_dct=dct), TIMING_CALLS)
        runs[f"{name} plain"] = (functools.partial(module.plain_features,
                                                   inp, c, dct), TIMING_CALLS)
    lm_cfg = configs["fused_raw"]
    runs.update({
        "fused_nccf": (lambda: fused_nccf.fused_nccf(xw, ball, pcfg, T=T),
                       TIMING_CALLS),
        "fused_nccf plain": (lambda: fused_nccf.plain_nccf(xw, ball, pcfg, T),
                             TIMING_CALLS),
        "fused_viterbi": (lambda: fused_viterbi.fused_viterbi(scores, pcfg),
                          TIMING_CALLS),
        "fused_viterbi plain": (lambda: pitch_op.viterbi(scores, pcfg), slow),
        "mfcc_batch cuda": (lambda: mfcc_model.mfcc_batch(xb, lb, cfg, "cuda"),
                            TIMING_CALLS),
        "mfcc_batch torch": (lambda: mfcc_model.mfcc_batch(xb, lb, cfg, "torch"),
                             TIMING_CALLS),
        "log_mel_batch cuda": (lambda: logmel_model.log_mel_batch(
            xb, lb, lm_cfg, "cuda"), TIMING_CALLS),
        "log_mel_batch torch": (lambda: logmel_model.log_mel_batch(
            xb, lb, lm_cfg, "torch"), TIMING_CALLS),
        "pitch_batch cuda": (lambda: pitch_model.pitch_batch(xb, lb, pcfg,
                                                             "cuda"),
                             TIMING_CALLS),
        "pitch_batch torch": (lambda: pitch_model.pitch_batch(xb, lb, pcfg,
                                                              "torch"), slow),
    })
    times = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):
        for k in order:
            fn, calls = runs[k]
            times[k] += _time_ms(torch, fn, calls=calls)
    med = {k: statistics.median(v) for k, v in times.items()}
    audio_s = B * SECONDS
    for k, ms in med.items():
        _log(f"[8 timing] {k}: {ms:.4f} ms per {B} x {SECONDS:g} s "
             f"batch = {audio_s / (ms / 1e3):,.0f} audio-sec/s "
             f"(median of {len(times[k])}; {smi})")
    return med


def run(torch, dev) -> list[dict]:
    """Phases 1-8 on device ``dev``; -> the kernels' JSON records."""
    from mfcc_tpu_torch.ops.kernels import _build

    # ---- 1. device ----
    smi = _smi()
    _log(f"[1 device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"{torch.cuda.get_device_name(0)}, "
         f"device_count {torch.cuda.device_count()}")
    print(smi, flush=True)

    _build_all(_build)                                      # 2
    bench = _bench_audio(BATCH, SECONDS, 16000)
    mfcc_err = _mfcc_kernel_vs_plain(torch, dev, bench)     # 3
    spectral_errs = _spectral_kernels_vs_plain(torch, dev)  # 3b
    _acc_log_bits(torch, dev)                               # 3c
    mfcc_launches = _mfcc_main_path(torch, dev, bench)      # 4
    logmel_launches = _logmel_main_paths(torch, dev)        # 4b
    nccf_err = _nccf_kernel_vs_plain(torch, dev, bench)     # 5
    viterbi_bad = _viterbi_kernel_vs_plain(torch, dev)      # 6
    pitch_launches = _pitch_main_path(torch, dev, bench)    # 7
    med = _timing(torch, dev, bench, smi)                   # 8

    src = "mfcc_tpu_torch/ops/kernels/csrc/{}.cu".format
    launches = {**logmel_launches, **pitch_launches}
    launches["fused_raw_dit"] += mfcc_launches
    errs = {**spectral_errs, "fused_nccf": nccf_err,
            "fused_viterbi": viterbi_bad}
    errs["fused_raw_dit"] = max(errs["fused_raw_dit"], mfcc_err)
    return [{"name": k, "route": "cuda", "source": src(k),
             "replaces": REPLACES[k], "launches": launches[k],
             "max_abs_err": errs[k], "ms": med[k],
             "plain_ms": med[f"{k} plain"]} for k in KERNELS]


def main() -> int:
    t0 = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "mfcc_tpu_torch")):
        print(f"chip_smoke: no mfcc_tpu_torch package beside {__file__}; run "
              "it from the repository root", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    kernels = run(torch, torch.device("cuda", 0))
    # ---- 9. summary ----
    assert "jax" not in sys.modules and "mfcc_tpu" not in sys.modules
    _log(f"[9 summary] phases 1-8 passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
