"""Raw audio -> MFCC, log-mel, PLP's log bark energies or the log
spectrogram in one hand-written CUDA kernel (the Hopper twin of
``mfcc_tpu/ops/kernels/fused_raw_dit.py`` in its three projections).

- :func:`plain_features` — the plain PyTorch version of the whole fused
  chain (pre-emphasis, window-folded DFT power, then the projection:
  mel, floors, accurate log, lifter-folded DCT with the optional log energy
  in c0, or the log-mel energies; the floored log of the bark +
  equal-loudness band energies; the floored log of each |X|^2 bin).  The
  CPU path and the kernel's differential twin.
- :func:`fused_features_raw_dit` — the wrapper: checks its input and
  launches ``csrc/fused_raw_dit.cu`` for a CUDA tensor (a build or launch
  failure raises), or runs :func:`plain_features` for a CPU tensor;
  ``utils/report`` records each launch, its tile ("fft", "fft64",
  "direct") and its projection ("mel", "bark", "spec").

The model layer sends this kernel cepstra and log-mel bounded to <= 50 dB
(``routes.spectral_route``), PLP's front half (``projection="bark"``) and
the log spectrogram (``projection="spec"``).  The TPU kernel's radix-2 DIT
layout and its packed spectrogram bin order (``spec_bin_permutation``) are
not carried over: at a power-of-two n_fft from 64 to 4096
(``_spectral.fft_tile``) the Hopper kernel runs the shared-memory FFT tile
of ``csrc/fft_tile.cuh``, whose split gives natural bin order (its
float64-front flavour for unbounded log-mel, PLP's bark bands and the
spectrogram), else
the direct window-folded DFT tile of ``csrc/spectral.cuh``; the config
decides, never a failure.
"""

from __future__ import annotations

import ctypes

import torch

from ...config import FeatureConfig
from .. import framing
from . import _spectral


def plain_features(x: torch.Tensor, cfg: FeatureConfig,
                   apply_dct: bool = True,
                   projection: str = "mel") -> torch.Tensor:
    """(B, N) raw audio -> (B, T, n_mfcc, n_mels, n_bark or n_bins),
    plain PyTorch."""
    return _spectral.plain_features(
        framing.preemphasize(x.to(torch.float32), cfg), cfg, apply_dct,
        projection=projection)


def _lib() -> ctypes.CDLL:
    return _spectral.bind(
        "fused_raw_dit", "mfcc_fused_raw_dit",
        _spectral.entry_argtypes(_spectral.DIRECT_ARGTYPES, preemph=True,
                                 projection=True))


def fused_features_raw_dit(x: torch.Tensor, cfg: FeatureConfig, *,
                           apply_dct: bool = True,
                           projection: str = "mel") -> torch.Tensor:
    """(B, N) raw float32 audio -> (B, T, n_out) features: cepstra or
    log-mel ("mel"), floored-log bark band energies ("bark", with
    apply_dct=False), or the floored log power spectrum in natural bin
    order ("spec", with apply_dct=False).

    A CUDA tensor goes through the kernel (or raises); a CPU tensor goes
    through :func:`plain_features`, both at the float32
    accumulation whatever ``cfg.accum_dtype`` says
    (``_spectral.kernel_config``).  cfg must be in "valid" frame mode
    (the model layer resolves centre mode first).
    """
    _spectral.check_projection(projection, apply_dct)
    cfg = _spectral.check_input(x, cfg)
    if not x.is_cuda:
        return plain_features(x, cfg, apply_dct, projection)
    _spectral.check_cuda_input(x)
    return _spectral.launch_spectral(
        _lib, "mfcc_fused_raw_dit", "fused_raw_dit", x, cfg, apply_dct,
        cfg.preemph, other=_spectral.direct_tile(projection),
        projection=projection)
