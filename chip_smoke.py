#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path once on one NVIDIA GPU.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases, one status line each; any failure raises and exits non-zero:

1. device: torch / CUDA versions, the card, and its name and power limit
   as nvidia-smi reports them.  No card: exit 1, no CPU fallback.
2. build: compile ``mfcc_tpu_torch/ops/kernels/csrc/fused_raw_dit.cu``
   from this checkout with nvcc.
3. kernel vs plain: the CUDA kernel against its plain PyTorch version on
   the card, same inputs, max abs diff <= 2e-5 (cepstra compared
   unliftered, as the repository's kernel tests do).
4. main path: ``models.mfcc.mfcc_batch`` on ragged int16 and float32
   batches and on the golden WAV, with the kernel's launch counter reset
   just before and read just after.  Frame counts, masks and zeroed padding
   are exact; features are within 1e-4 of the float64 oracle and of the
   committed goldens.
5. timing (information, not a claim): kernel and plain path at 64 x 10 s,
   CUDA events, median of 30 calls after warm-up.
6. one JSON line describing the kernels, then the final JSON status line.

Imports nothing of JAX and nothing of the JAX package ``mfcc_tpu``.
"""

from __future__ import annotations

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
ORACLE_TOL = 1e-4     # feature contract vs the float64 oracle


def _log(msg: str) -> None:
    print(msg, flush=True)


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


def _time_ms(torch, fn, warmup: int = 5, calls: int = 30) -> list[float]:
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from mfcc_tpu_torch import FeatureConfig, oracle
    from mfcc_tpu_torch.models import mfcc as mfcc_model
    from mfcc_tpu_torch.ops.kernels import _build, fused_raw_dit
    from mfcc_tpu_torch.utils import wav

    # ---- 1. device ----
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    _log(f"[1 device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"{kind}, device_count {torch.cuda.device_count()}")
    print(smi, flush=True)

    # ---- 2. build ----
    t0 = time.perf_counter()
    _build.load("fused_raw_dit")
    build_s = time.perf_counter() - t0
    log = _build.library_path("fused_raw_dit").with_suffix(".log")
    ptxas = ([ln.strip() for ln in log.read_text().splitlines()
              if "registers" in ln or "spill" in ln] if log.exists() else [])
    _log(f"[2 build] fused_raw_dit.cu built and loaded in {build_s:.2f} s")
    for ln in ptxas:
        _log(f"  ptxas: {ln}")

    # ---- 3. kernel vs plain ----
    cfg = FeatureConfig().validate()
    sr = cfg.sample_rate
    bench = _bench_audio(64, 10.0, sr)
    rng = np.random.default_rng(1)
    ragged_lens = (sr, 12345, 4000)
    ragged = np.zeros((3, sr), np.float32)
    for i, n in enumerate(ragged_lens):
        ragged[i, :n] = 0.3 * rng.standard_normal(n)
    cases = [
        ("bench 64 x 10 s", cfg, bench),
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
        _log(f"[3 kernel vs plain] {name}: shape {tuple(got.shape)}, "
             f"max abs diff {err:.3e} (all frames {raw:.3e})")
        assert err <= KERNEL_TOL, (name, err)
        kernel_err = max(kernel_err, err)

    # ---- 4. main path ----
    lens = np.array([160000, 151234, 100000, 48000, 16000, 8001, 400, 399],
                    np.int32)
    audio = bench[: len(lens)].copy()
    for i, n in enumerate(lens):
        audio[i, n:] = 0.0
    x16 = np.round(np.clip(audio, -1.0, 32767 / 32768) * 32768).astype(np.int16)
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
    gold_out = []
    for fname, c, _ in goldens:
        f, _, _ = mfcc_model.mfcc_batch(
            torch.from_numpy(speech[None]).to(dev),
            torch.tensor([len(speech)], dtype=torch.int32, device=dev), c)
        gold_out.append(f)
    torch.cuda.synchronize()
    launches = fused_raw_dit.LAUNCHES
    _log(f"[4 main path] mfcc_batch calls launched the kernel {launches} times")
    assert launches > 0, "the main path did not go through the kernel"

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
        _log(f"[4 main path] {tag} ragged batch {tuple(f.shape)}: flens, mask, "
             f"zero padding exact; utterance 0 vs float64 oracle {err:.3e}")
        assert err <= ORACLE_TOL, (tag, err)
    for (fname, c, lift), f in zip(goldens, gold_out):
        want = np.load(os.path.join(GOLDEN, fname))
        got = f[0].cpu().numpy()
        assert got.shape == want.shape, (fname, got.shape, want.shape)
        err = float(np.abs(got / lift - want / lift).max())
        _log(f"[4 main path] speech2s.wav vs {fname}: {err:.3e}")
        assert err <= ORACLE_TOL, (fname, err)

    # ---- 5. timing (information) ----
    xb = torch.from_numpy(bench).to(dev)
    lb = torch.full((bench.shape[0],), bench.shape[1], dtype=torch.int32,
                    device=dev)
    audio_s = bench.shape[0] * bench.shape[1] / sr
    runs = {"kernel": lambda: fused_raw_dit.fused_features_raw_dit(xb, cfg),
            "plain": lambda: fused_raw_dit.plain_features(xb, cfg),
            "mfcc_batch cuda": lambda: mfcc_model.mfcc_batch(xb, lb, cfg, "cuda"),
            "mfcc_batch torch": lambda: mfcc_model.mfcc_batch(xb, lb, cfg, "torch")}
    times = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):
        for k in order:
            times[k] += _time_ms(torch, runs[k])
    med = {k: statistics.median(v) for k, v in times.items()}
    for k, ms in med.items():
        _log(f"[5 timing] {k}: {ms:.4f} ms per 64 x 10 s batch = "
             f"{audio_s / (ms / 1e3):,.0f} audio-sec/s "
             f"(median of {len(times[k])}; {smi})")

    # ---- 6. summary ----
    assert "jax" not in sys.modules and "mfcc_tpu" not in sys.modules
    print(json.dumps({"kernels": [{
        "name": "fused_raw_dit", "route": "cuda",
        "source": "mfcc_tpu_torch/ops/kernels/csrc/fused_raw_dit.cu",
        "replaces": "mfcc_tpu/ops/kernels/fused_raw_dit.py:555",
        "launches": launches, "max_abs_err": kernel_err,
        "ms": med["kernel"], "plain_ms": med["plain"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
