"""Per-band error of the port's plain f32 paths against the float64 oracle
on the bench rows, on one device.

    python -m mfcc_tpu_torch.tools.plain_valley [--device cuda|cpu]

The bench batch of ``chip_smoke.py`` (64 x 10 s of the ``bench.py``
signal: two tones plus noise, numpy seed 0) goes whole through two plain
versions on the device: unbounded log-mel-80 (``fused_raw.plain_features``,
the direct f32 DFT product through ``backend.matmul``, the differential
twin of ``fused_raw``) and the log spectrogram (the plain version of
``fused_raw_dit``'s spec projection, the same DFT product).  Every row is
held against the float64 oracle of the same samples (the rows differ only
in their noise, and the worst valley frame lies in one of them).  Prints
the device (and the card's name and power limit), then one JSON line: per
log-mel band the max abs error over all rows' frames, the row it is worst
in, and the spectrogram's max error inside and below the 50 dB window.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from .. import FeatureConfig, oracle
from ..ops.kernels import fused_raw, fused_raw_dit


def bench_batch(batch: int = 64, seconds: float = 10.0,
                sr: int = 16000) -> np.ndarray:
    """The bench.py signal: two tones plus noise, numpy seed 0 (as
    ``chip_smoke._bench_audio``)."""
    n = int(seconds * sr)
    rng = np.random.default_rng(0)
    t = np.arange(n) / sr
    base = (0.3 * np.sin(2 * np.pi * 180 * t)
            + 0.1 * np.sin(2 * np.pi * 1200 * t)).astype(np.float32)
    audio = np.tile(base, (batch, 1))
    audio += 0.02 * rng.standard_normal(audio.shape).astype(np.float32)
    return audio


def logmel_band_errors(feat: np.ndarray, audio: np.ndarray,
                       cfg: FeatureConfig) -> np.ndarray:
    """(B, n_mels) max abs error of log-mel ``feat`` (B, T, n_mels) against
    the float64 oracle, per row and band over the row's frames."""
    return np.stack([
        np.abs(feat[i] - oracle.log_mel(audio[i].astype(np.float64),
                                        cfg)).max(axis=0)
        for i in range(audio.shape[0])])


def spectrogram_errors(feat: np.ndarray, audio: np.ndarray,
                       cfg: FeatureConfig, db: float = 50.0):
    """Max abs error of a log spectrogram against the float64 oracle over
    every row: (inside the ``db`` window of each frame's peak, below it)."""
    inside = below = 0.0
    for i in range(audio.shape[0]):
        want = oracle.log_spectrogram(audio[i].astype(np.float64), cfg)
        keep = want > want.max(axis=-1, keepdims=True) - np.log(
            10.0 ** (db / 10.0))
        d = np.abs(feat[i] - want)
        inside = max(inside, float(d[keep].max()))
        below = max(below, float(d[~keep].max()) if (~keep).any() else 0.0)
    return inside, below


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("plain_valley: no card (torch.cuda.is_available() is "
                  "False)", file=sys.stderr)
            return 1
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
    dev = torch.device(args.device)
    audio = bench_batch()
    x = torch.from_numpy(audio).to(dev)
    lm_cfg = FeatureConfig(n_mels=80, n_mfcc=80)
    cfg = FeatureConfig()
    logmel = fused_raw.plain_features(x, lm_cfg, False).cpu().numpy()
    spec = fused_raw_dit.plain_features(x, cfg, False, "spec").cpu().numpy()
    per_row = logmel_band_errors(logmel, audio, lm_cfg)
    bands = per_row.max(axis=0)
    inside, below = spectrogram_errors(spec, audio, cfg)
    print(json.dumps({
        "device": (torch.cuda.get_device_name(0) if args.device == "cuda"
                   else "cpu"),
        "rows": audio.shape[0], "logmel80_max": float(bands.max()),
        "logmel80_worst_band": int(bands.argmax()),
        "logmel80_worst_row": int(per_row[:, bands.argmax()].argmax()),
        "logmel80_band_errors": [float(f"{v:.4e}") for v in bands],
        "spectrogram_window_max": inside, "spectrogram_below_max": below}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
