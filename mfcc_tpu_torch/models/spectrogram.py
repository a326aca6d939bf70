"""Log-power spectrogram features (twin of
``mfcc_tpu/models/spectrogram.py``).

(T, n_bins) floored log power spectra, with the framing, window and DFT
contract of the rest of the pipeline: no mel, no DCT, no deltas.

- :func:`log_spectrogram` — one utterance (N,) -> (T, n_bins), or a
  valid-mode batch (B, N) -> (B, T, n_bins).
- :func:`log_spectrogram_batch` — padded ragged batch plus per-utterance
  sample lengths -> (features, true frame counts, frame validity mask);
  int16 or float input, padded frames zeroed.

On a CUDA tensor, where ``routes.spec_kernel_eligible`` holds (the
reference's kernel route: n_fft 512, 768, 1024 ...), one launch of
``fused_raw_dit`` with ``projection="spec"`` computes it (the FFT tile's
float64 front at a power-of-two n_fft, else the direct tile); elsewhere
(n_fft 400), and under ``matmul_precision="high"``, the plain chain runs
on the card, as the reference runs XLA there.  A CPU tensor takes the
plain chain.  The route is decided from the config alone.  Contract:
2e-4 against the float64 oracle inside the 50 dB window
(``docs/conventions.md``); below it the f32 plain chain is floor-limited,
while the kernel's float64 front holds the oracle.

Dither: the reference model does not dither the spectrogram in valid mode
(``mfcc_tpu/models/spectrogram.py:33-47``), although its oracle
``log_spectrogram`` does; in centre mode its frame-mode resolution dithers
the signal before the reflect pad.  The port matches the model in both
(ROADMAP section 3).
"""

from __future__ import annotations

import torch

from ..config import FeatureConfig
from .. import backend as backend_lib
from ..ops import framing
from ..ops.kernels import fused_raw_dit, routes
from ..utils import report
from .mfcc import frame_lengths, frame_mask, run_batch  # noqa: F401


def _spectrogram(xb: torch.Tensor, cfg: FeatureConfig,
                 backend: str) -> torch.Tensor:
    """(B, N) valid-mode float32 audio -> (B, T, n_bins)."""
    with report.span("feat.spectral"):
        if (backend_lib.resolve(backend, xb, cfg) == "cuda"
                and routes.spec_kernel_eligible(cfg)):
            feat = fused_raw_dit.fused_features_raw_dit(
                xb, cfg, apply_dct=False, projection="spec")
        else:
            feat = fused_raw_dit.plain_features(xb, cfg, False, "spec")
        report.count("frames_computed", feat.shape[0] * feat.shape[1])
    return feat


def log_spectrogram(x: torch.Tensor, cfg: FeatureConfig,
                    backend: str = "auto") -> torch.Tensor:
    """(n_samples,) -> (T, n_bins) floored log power spectrum; a (B, N)
    batch (its frame mode resolved by the caller) -> (B, T, n_bins)."""
    backend_lib.check_config(cfg)
    if x.dim() == 1:
        x, cfg = framing.resolve_frame_mode_static(x, cfg)
    squeeze = x.dim() == 1
    xb = (x[None, :] if squeeze else x).to(torch.float32).contiguous()
    feat = _spectrogram(xb, cfg, backend)
    return feat[0] if squeeze else feat


def log_spectrogram_batch(x: torch.Tensor, sample_lengths: torch.Tensor,
                          cfg: FeatureConfig, backend: str = "auto"):
    """(B, N_pad), (B,) -> ((B, T, n_bins), (B,) int32 frame counts,
    (B, T) bool mask); x int16 PCM or float in [-1, 1]."""
    return run_batch(x, sample_lengths, cfg, lambda xv, c, flens: (
        _spectrogram(xv.to(torch.float32).contiguous(), c, backend)))
