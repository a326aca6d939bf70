"""Raw audio -> MFCC or log-mel in one hand-written CUDA kernel (the Hopper
twin of ``mfcc_tpu/ops/kernels/fused_raw_dit.py``, projection="mel").

- :func:`plain_features` — the plain PyTorch version of the whole fused
  chain (pre-emphasis, window-folded DFT power, mel, floors, accurate log,
  lifter-folded DCT with the optional log energy in c0, or the log-mel
  energies).  The CPU path and the kernel's differential twin.
- :func:`fused_features_raw_dit` — the wrapper: checks its input and
  launches ``csrc/fused_raw_dit.cu`` for a CUDA tensor (a build or launch
  failure raises), or runs :func:`plain_features` for a CPU tensor.
- ``LAUNCHES`` — how many times the wrapper launched the kernel, and
  ``TILE_LAUNCHES`` — those launches by tile ("fft", "fft64", "direct").

The model layer sends this kernel cepstra and log-mel bounded to <= 50 dB
(``routes.spectral_route``).  The TPU kernel's radix-2 DIT layout is not
carried over: for those outputs at a power-of-two n_fft from 64 to 4096
(``_spectral.fft_tile``) the Hopper kernel runs the shared-memory FFT tile
of ``csrc/fft_tile.cuh`` (unbounded log-mel, which a direct caller may ask
for, its float64-front flavour), else the direct window-folded DFT tile of
``csrc/spectral.cuh``; the config decides, never a failure.
"""

from __future__ import annotations

import ctypes

import torch

from ...config import FeatureConfig
from .. import framing
from . import _spectral

# kernel launches by fused_features_raw_dit, in all and by tile (reset by
# callers that count)
LAUNCHES = 0
TILE_LAUNCHES = {"fft": 0, "fft64": 0, "direct": 0}


def plain_features(x: torch.Tensor, cfg: FeatureConfig,
                   apply_dct: bool = True) -> torch.Tensor:
    """(B, N) raw audio -> (B, T, n_mfcc or n_mels), plain PyTorch."""
    return _spectral.plain_features(
        framing.preemphasize(x.to(torch.float32), cfg), cfg, apply_dct)


def _lib() -> ctypes.CDLL:
    return _spectral.bind(
        "fused_raw_dit", "mfcc_fused_raw_dit",
        _spectral.entry_argtypes(_spectral.DIRECT_ARGTYPES, preemph=True))


def fused_features_raw_dit(x: torch.Tensor, cfg: FeatureConfig, *,
                           apply_dct: bool = True) -> torch.Tensor:
    """(B, N) raw float32 audio -> (B, T, n_mfcc or n_mels) features.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor goes
    through :func:`plain_features`.  cfg must be in "valid" frame mode
    (models.mfcc resolves centre mode first).
    """
    _spectral.check_input(x, cfg)
    if not x.is_cuda:
        return plain_features(x, cfg, apply_dct)
    _spectral.check_cuda_input(x)
    out, tile = _spectral.launch_spectral(
        _lib, "mfcc_fused_raw_dit", "fused_raw_dit", x, cfg, apply_dct,
        cfg.preemph)
    if tile is not None:
        global LAUNCHES
        LAUNCHES += 1
        TILE_LAUNCHES[tile] += 1
    return out
