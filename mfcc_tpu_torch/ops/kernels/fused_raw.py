"""Raw audio -> log-mel or MFCC in one hand-written CUDA kernel (the
Hopper twin of ``mfcc_tpu/ops/kernels/fused_raw.py``).

- :func:`plain_features` — the plain PyTorch version: the direct chain it
  shares with ``fused_raw_dit`` (pre-emphasis, window-folded DFT power,
  mel, floors, accurate log, DCT or log-mel).
- :func:`_matrices` — the direct tile's float32 constants.
- :func:`fused_features_raw` — the wrapper: launches ``csrc/fused_raw.cu``
  for a CUDA tensor (a build or launch failure raises), or runs
  :func:`plain_features` for a CPU tensor.
- ``LAUNCHES`` — how many times the wrapper launched the kernel, and
  ``TILE_LAUNCHES`` — those launches by tile ("fft", "fft64", "direct").

The model layer sends this kernel unbounded-range log-mel
(``routes.spectral_route``), the route the reference keeps on the direct
form for deep spectral valleys.  On the card, at a power-of-two n_fft from
64 to 4096, it runs the shared-memory FFT tile of ``csrc/fft_tile.cuh``
with a float64 front (pre-emphasis through |X|^2 in float64, which holds
the float64 oracle in those valleys where an f32 FFT does not), or the
tile's f32 flavour for cepstra and log-mel bounded to <= 50 dB; any other
n_fft runs the direct window-folded DFT tile of ``csrc/spectral.cuh``.
The config decides (``_spectral.fft_tile``), never a failure.
"""

from __future__ import annotations

import ctypes

import torch

from ...config import FeatureConfig
from . import _spectral, fused_raw_dit

# kernel launches by fused_features_raw, in all and by tile (reset by
# callers that count)
LAUNCHES = 0
TILE_LAUNCHES = {"fft": 0, "fft64": 0, "direct": 0}

plain_features = fused_raw_dit.plain_features
_matrices = _spectral.direct_matrices


def _lib() -> ctypes.CDLL:
    return _spectral.bind(
        "fused_raw", "mfcc_fused_raw",
        _spectral.entry_argtypes(_spectral.DIRECT_ARGTYPES, preemph=True))


def fused_features_raw(x: torch.Tensor, cfg: FeatureConfig, *,
                       apply_dct: bool = True, direct=None) -> torch.Tensor:
    """(B, N) raw float32 audio -> (B, T, n_mfcc or n_mels) features.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor goes
    through :func:`plain_features`, both at the float32
    accumulation whatever ``cfg.accum_dtype`` says
    (``_spectral.kernel_config``).  cfg must be in "valid" frame mode.

    ``direct``, a consts(cfg, device) -> ([basis, nbb, last, melw], dctm)
    as ``_spectral.direct_consts`` returns them, runs the direct tile on
    those constants, whatever the n_fft: a front end whose window or
    filterbank the config cannot state (``models/whisper``).  The card
    only: the plain version knows the config's constants alone.
    """
    cfg = _spectral.check_input(x, cfg)
    if not x.is_cuda:
        if direct is not None:
            raise ValueError("direct constants run on a CUDA tensor only")
        return plain_features(x, cfg, apply_dct)
    _spectral.check_cuda_input(x)
    other = _spectral.DIRECT_TILE
    if direct is not None:
        other = ("direct", direct, other[2])
    out, tile = _spectral.launch_spectral(
        _lib, "mfcc_fused_raw", "fused_raw", x, cfg, apply_dct, cfg.preemph,
        other=other, tile="direct" if direct is not None else None)
    if tile is not None:
        global LAUNCHES
        LAUNCHES += 1
        TILE_LAUNCHES[tile] += 1
    return out
