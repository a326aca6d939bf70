"""Raw audio -> log-mel or MFCC in one hand-written CUDA kernel, direct
form (the Hopper twin of ``mfcc_tpu/ops/kernels/fused_raw.py``).

- :func:`plain_features` — the plain PyTorch version: the direct chain it
  shares with ``fused_raw_dit`` (pre-emphasis, window-folded DFT power,
  mel, floors, accurate log, DCT or log-mel).
- :func:`_matrices` — the direct tile's float32 constants.
- :func:`fused_features_raw` — the wrapper: launches ``csrc/fused_raw.cu``
  for a CUDA tensor (a build or launch failure raises), or runs
  :func:`plain_features` for a CPU tensor.
- ``LAUNCHES`` — how many times the wrapper launched the kernel.

The model layer sends this kernel unbounded-range log-mel
(``routes.spectral_route``), the route the reference keeps on the direct
form for deep spectral valleys.  On the card it runs the direct
window-folded DFT tile of ``csrc/spectral.cuh`` for every config;
``fused_raw_dit`` runs it only where the FFT tile does not apply
(``_spectral.fft_tile``, ``routes.py``).
"""

from __future__ import annotations

import ctypes

import torch

from ...config import FeatureConfig
from . import _spectral, fused_raw_dit

# kernel launches by fused_features_raw (reset by callers that count)
LAUNCHES = 0

plain_features = fused_raw_dit.plain_features
_matrices = _spectral.direct_matrices


def _lib() -> ctypes.CDLL:
    return _spectral.bind(
        "fused_raw", "mfcc_fused_raw",
        _spectral.DIRECT_ARGTYPES + [ctypes.c_float]
        + _spectral.EPILOGUE_ARGTYPES + [ctypes.c_void_p])


def fused_features_raw(x: torch.Tensor, cfg: FeatureConfig, *,
                       apply_dct: bool = True) -> torch.Tensor:
    """(B, N) raw float32 audio -> (B, T, n_mfcc or n_mels) features.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor goes
    through :func:`plain_features`.  cfg must be in "valid" frame mode.
    """
    _spectral.check_input(x, cfg)
    if not x.is_cuda:
        return plain_features(x, cfg, apply_dct)
    _spectral.check_cuda_input(x)
    out, launched = _spectral.launch_direct(
        _lib, "mfcc_fused_raw", "fused_raw", x, cfg, apply_dct,
        cfg.preemph)
    if launched:
        global LAUNCHES
        LAUNCHES += 1
    return out
