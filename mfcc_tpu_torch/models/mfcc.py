"""The flagship MFCC pipeline (twin of ``mfcc_tpu/models/mfcc.py``).

- :func:`mfcc` — one utterance: (N,) -> (T, n_feats).
- :func:`mfcc_batch` — padded ragged batch plus per-utterance sample
  lengths -> (features, true frame counts, frame validity mask).  Padded
  frames are computed, then zeroed, so masked reductions stay exact.

On a CUDA tensor the spectral chain is one launch of a hand-written kernel,
picked by the reference's route (``ops/kernels/routes.py``): cepstra and
log-mel bounded to <= 50 dB go to ``fused_raw_dit``, other log-mel to
``fused_raw``, and what neither raw kernel takes is pre-emphasized on the
host and goes to ``fused_dit`` or ``fused_mfcc``.  Deltas run after it.
On a CPU tensor the chain is the plain direct form.  The reference's
> 4096-frame blocked route is not ported: it works around a TPU relayout
fault, and a long row goes straight through the kernel.
"""

from __future__ import annotations

import torch

from ..config import FeatureConfig
from .. import backend as backend_lib
from ..ops import deltas as deltas_op, framing
from ..ops.kernels import (fused_dit, fused_mfcc, fused_raw, fused_raw_dit,
                           routes)


def _spectral_features(xb: torch.Tensor, cfg: FeatureConfig,
                       apply_dct: bool, backend: str) -> torch.Tensor:
    """(B, N) valid-mode float32 audio -> (B, T, n_mfcc or n_mels)."""
    if backend_lib.resolve(backend, xb) != "cuda":
        return fused_raw_dit.plain_features(xb, cfg, apply_dct)
    route = routes.spectral_route(cfg, apply_dct)
    if route == "fused_raw_dit":
        return fused_raw_dit.fused_features_raw_dit(xb, cfg,
                                                    apply_dct=apply_dct)
    if route == "fused_raw":
        return fused_raw.fused_features_raw(xb, cfg, apply_dct=apply_dct)
    yb = framing.preemphasize(xb, cfg)
    if route == "fused_dit":
        return fused_dit.fused_features_dit(yb, cfg, apply_dct=apply_dct)
    return fused_mfcc.fused_features(yb, cfg, apply_dct=apply_dct)


def _features_from_audio(x: torch.Tensor, cfg: FeatureConfig,
                         lengths: torch.Tensor | None = None,
                         backend: str = "auto",
                         apply_dct: bool = True) -> torch.Tensor:
    """(B, N) or (N,) valid-mode audio -> features (deltas appended)."""
    squeeze = x.dim() == 1
    xb = (x[None, :] if squeeze else x).to(torch.float32).contiguous()
    feat = _spectral_features(xb, cfg, apply_dct, backend)
    if squeeze:
        feat = feat[0]
    if cfg.deltas:
        feat = deltas_op.append_deltas(feat, cfg, lengths)
    return feat


def mfcc(x: torch.Tensor, cfg: FeatureConfig,
         backend: str = "auto") -> torch.Tensor:
    """(n_samples,) PCM in [-1, 1] -> (T, n_feats) features."""
    backend_lib.check_config(cfg)
    x, cfg = framing.resolve_frame_mode_static(x, cfg)
    return _features_from_audio(x, cfg, backend=backend)


def frame_lengths(sample_lengths: torch.Tensor,
                  cfg: FeatureConfig) -> torch.Tensor:
    """Per-utterance true frame counts (tensor twin of
    FeatureConfig.num_frames), int32."""
    n = sample_lengths.to(torch.int64)
    if cfg.frame_mode == "center":
        t = (n + cfg.hop_len // 2) // cfg.hop_len
        t = torch.where(n >= cfg.center_min_samples, t, torch.zeros_like(t))
        return t.to(torch.int32)
    t = torch.div(n - cfg.frame_len, cfg.hop_len, rounding_mode="floor") + 1
    return torch.clamp(t, min=0).to(torch.int32)


def frame_mask(T: int, flens: torch.Tensor) -> torch.Tensor:
    """(B, T) bool validity mask from (B,) frame counts."""
    t = torch.arange(T, dtype=torch.int32, device=flens.device)
    return t[None, :] < flens[:, None]


def run_batch(x: torch.Tensor, sample_lengths: torch.Tensor,
              cfg: FeatureConfig, features):
    """The batch entry of every model (MFCC, log-mel, PLP, spectrogram):
    int16 cast, centre mode, frame counts, then ``features(x, cfg,
    flens)`` on the valid-mode batch, mask and zeroing."""
    backend_lib.check_config(cfg)
    if x.dtype == torch.int16:
        x = x.to(torch.float32) * (1.0 / 32768.0)
    sample_lengths = torch.as_tensor(sample_lengths, device=x.device)
    x, sample_lengths, cfg = framing.resolve_frame_mode(
        x, sample_lengths, cfg)
    flens = frame_lengths(sample_lengths, cfg)
    feat = features(x, cfg, flens)
    mask = frame_mask(feat.shape[-2], flens)
    feat = torch.where(mask[..., None], feat, torch.zeros((), dtype=feat.dtype,
                                                          device=feat.device))
    return feat, flens, mask


def features_batch(x: torch.Tensor, sample_lengths: torch.Tensor,
                   cfg: FeatureConfig, backend: str = "auto",
                   apply_dct: bool = True):
    """The batch entry of :func:`mfcc_batch` and ``logmel.log_mel_batch``."""
    return run_batch(x, sample_lengths, cfg, lambda xv, c, flens: (
        _features_from_audio(xv, c, lengths=flens if c.deltas else None,
                             backend=backend, apply_dct=apply_dct)))


def mfcc_batch(x: torch.Tensor, sample_lengths: torch.Tensor,
               cfg: FeatureConfig, backend: str = "auto"):
    """(B, N_pad), (B,) -> ((B, T, n_feats), (B,) int32 frame counts,
    (B, T) bool mask).

    x may be int16 PCM (cast to [-1, 1) on the device — half the
    host-to-device bytes) or float in [-1, 1].
    """
    return features_batch(x, sample_lengths, cfg, backend)
