"""Whisper's log-mel front end (openai ``whisper/audio.py``
``log_mel_spectrogram``; Hugging Face ``WhisperFeatureExtractor``), batched.

:func:`whisper_log_mel_batch` takes a padded ragged batch and gives every
row ``cfg.num_frames()`` frames (3,000 for 30 s): the window's padding is
Whisper's input, not the batch's.  The stages, each a span under
``feat.batch``:

- ``feat.cast``: int16 to float32 in [-1, 1) (``models/mfcc``'s cast);
- ``feat.frames``: each row cut or zero-padded to the window and reflect
  padded for the STFT's centring (``framing.stft_center_batch``);
- ``feat.spectral``: |X|^2 of the periodic Hann window's DFT, the Hz
  triangle mel bank, the floored natural log.  On the card one launch of
  ``fused_raw`` on Whisper's window and bank (:func:`front`), whose n_fft
  of 400 = 2^4 5^2 takes the float64-front mixed-radix FFT tile (no
  pre-emphasis, no relative floor), handed the rows' lengths on the
  device so that it skips the frame tiles wholly in the window's zero
  padding (the same bits); on a CPU tensor the same chain in plain torch,
  float32 IEEE products;
- ``feat.whisper_norm``: the row's largest value over all its frames and
  bands, the floor :data:`ROW_FLOOR_DB` under it, and the affine that takes
  the natural log to Whisper's (log10 + 4) / 4, in three passes on the
  device with no host sync;
- ``feat.mask``: the frame counts' mask (every frame is valid).

The constants are built once a config in float64 (:func:`front`) and
kept: for the card as the tile's tables, which ``ops/kernels/_spectral``
builds from :func:`front` and keeps on the device, and on the device for
the plain chain (``_spectral.plain_front_features``, which NeMo's front
end shares); their first build is counted in ``consts_s``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import backend as backend_lib
from ..config import WhisperConfig
from ..ops import framing, mel as mel_op
from ..ops.kernels import _spectral, fused_raw
from ..utils import report
from .mfcc import _to_float, frame_mask

# Whisper's floor under a row's largest value: 8 in log10 (audio.py's
# ``log_spec.max() - 8.0``)
ROW_FLOOR_DB = 80.0


def periodic_hann(n: int) -> np.ndarray:
    """``torch.hann_window(n)`` (periodic) in float64."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n, dtype=np.float64) / n)


@functools.lru_cache(maxsize=8)
@report.timed("consts_s")
def front(cfg: WhisperConfig) -> _spectral.Front:
    """Whisper's window (the periodic Hann) and bank (the (n_bins, n_mels)
    Hz triangles) in float64, as ``fused_raw`` takes them; one a config,
    which the kernels' constant caches key on."""
    return _spectral.Front(periodic_hann(cfg.n_fft),
                           mel_op.hz_triangle_matrix(cfg))


def log_mel(xp: torch.Tensor, cfg: WhisperConfig, backend: str = "auto",
            lengths: torch.Tensor | None = None) -> torch.Tensor:
    """(B, L) padded rows (``framing.stft_center_batch``) -> (B, T, n_mels)
    floored natural log of the mel energies: ``fused_raw`` on Whisper's
    :func:`front` on a CUDA tensor, else the plain chain.  ``lengths``:
    the rows' (B,) sample lengths on xp's device, which let the kernel
    skip the frames wholly in the window's zero padding
    (``_spectral.RowBounds``)."""
    kcfg = cfg.feature_config()
    if backend_lib.resolve(backend, xp, kcfg) == "cuda":
        bounds = None if lengths is None else _spectral.RowBounds(
            lengths.to(torch.int64).contiguous(), cfg.n_fft // 2,
            cfg.chunk_samples)
        return fused_raw.fused_features_raw(
            xp.to(torch.float32).contiguous(), kcfg, apply_dct=False,
            front=front(cfg), bounds=bounds)
    return _spectral.plain_front_features(xp, kcfg, front(cfg))


def normalize(feat: torch.Tensor) -> torch.Tensor:
    """(B, T, n_mels) natural logs -> Whisper's features, in place:
    max(log10 e, row max - ROW_FLOOR_DB / 10), then (x + 4) / 4, computed
    on the natural logs as max(y, m - ROW_FLOOR_DB ln(10) / 10) / (4 ln 10)
    + 1 (m the row's largest y).  The constants go to the kernels as
    arguments: no host value is copied to the device."""
    ln10 = math.log(10.0)
    floor = feat.amax(dim=(1, 2), keepdim=True) - ROW_FLOOR_DB * ln10 / 10.0
    feat.clamp_(min=floor)
    return torch.add(feat.new_ones(()), feat, alpha=1.0 / (4.0 * ln10),
                     out=feat)


def whisper_log_mel_batch(x: torch.Tensor, sample_lengths: torch.Tensor,
                          cfg: WhisperConfig, backend: str = "auto"):
    """(B, N_pad) int16 PCM or float in [-1, 1], (B,) sample lengths ->
    (features (B, T, n_mels) float32, frame counts (B,) int32, mask (B, T)
    bool), T = cfg.num_frames() for every row.  Samples past a row's
    length read as zeros; a row longer than the window is cut to it.
    Whisper's encoder reads the features' transpose, (B, n_mels, T)."""
    with report.span("feat.batch"):
        x = _to_float(x)
        with report.span("feat.frames"):
            lengths = torch.as_tensor(sample_lengths, device=x.device)
            xp = framing.stft_center_batch(x, lengths, cfg)
            T = cfg.num_frames()
            flens = torch.full((x.shape[0],), T, dtype=torch.int32,
                               device=x.device)
        with report.span("feat.spectral"):
            feat = log_mel(xp, cfg, backend, lengths)
            report.count("frames_computed", feat.shape[0] * feat.shape[1])
        with report.span("feat.whisper_norm"):
            feat = normalize(feat)
        with report.span("feat.mask"):
            mask = frame_mask(T, flens)
    return feat, flens, mask
