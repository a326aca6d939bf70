"""Log-mel filterbank variant, DCT skipped (twin of
``mfcc_tpu/models/logmel.py``; baseline config 3 is log-mel-80 + deltas).

The same front half as the MFCC pipeline, stopping at the floored log mel
energies, optionally with delta and delta-delta.  On a CUDA tensor
unbounded-range log-mel goes to ``fused_raw`` (its FFT tile with a float64
front) and log-mel bounded to <= 50 dB to ``fused_raw_dit`` (its f32 FFT
tile), as ``ops/kernels/routes.py`` sets out.  The
reference's > 4096-frame blocked route is not ported (``models/mfcc``).
"""

from __future__ import annotations

import torch

from .. import backend as backend_lib
from ..config import FeatureConfig
from ..ops import framing
from .mfcc import (_features_from_audio, features_batch,  # noqa: F401
                   frame_lengths, frame_mask)


def log_mel(x: torch.Tensor, cfg: FeatureConfig,
            backend: str = "auto") -> torch.Tensor:
    """(n_samples,) -> (T, n_mels[*3]) log-mel features."""
    backend_lib.check_config(cfg)
    x, cfg = framing.resolve_frame_mode_static(x, cfg)
    return _features_from_audio(x, cfg, backend=backend, apply_dct=False)


def log_mel_batch(x: torch.Tensor, sample_lengths: torch.Tensor,
                  cfg: FeatureConfig, backend: str = "auto"):
    """(B, N_pad), (B,) -> ((B, T, n_mels[*3]), (B,) int32 frame counts,
    (B, T) bool mask); x int16 PCM or float in [-1, 1]."""
    return features_batch(x, sample_lengths, cfg, backend, apply_dct=False)
