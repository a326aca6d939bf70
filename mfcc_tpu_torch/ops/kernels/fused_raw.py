"""Raw audio -> log-mel or MFCC in one hand-written CUDA kernel (the
Hopper twin of ``mfcc_tpu/ops/kernels/fused_raw.py``).

- :func:`plain_features` — the plain PyTorch version: the direct chain it
  shares with ``fused_raw_dit`` (pre-emphasis, window-folded DFT power,
  mel, floors, accurate log, DCT or log-mel).
- :func:`_matrices` — the direct tile's float32 constants.
- :func:`fused_features_raw` — the wrapper: launches ``csrc/fused_raw.cu``
  for a CUDA tensor (a build or launch failure raises), or runs
  :func:`plain_features` for a CPU tensor; ``utils/report`` records each
  launch and its tile ("fft", "fft64", "fft64_mixed", "direct").

The model layer sends this kernel unbounded-range log-mel
(``routes.spectral_route``), the route the reference keeps on the direct
form for deep spectral valleys.  On the card, at a power-of-two n_fft from
64 to 4096, it runs the shared-memory FFT tile of ``csrc/fft_tile.cuh``
with a float64 front (pre-emphasis through |X|^2 in float64, which holds
the float64 oracle in those valleys where an f32 FFT does not), or the
tile's f32 flavour for cepstra and log-mel bounded to <= 50 dB; at an
n_fft of 2^a 5^b (Whisper's 400) the float64-front flavour runs as the
mixed-radix tile ("fft64_mixed", radix-5 passes beside the radix-2/4/8
ones; this entry alone has it); any other n_fft runs the direct
window-folded DFT tile of ``csrc/spectral.cuh``.  The config and n_fft's
factors decide (``_spectral.fft_tile``), never a failure.  NeMo's front
end takes the "fft64" tile in its epilogue's guard mode
(``raw_fft_kernel<TM>(spectral::FftGuardParams)``: log(e + log_floor) in
place of the floors).
"""

from __future__ import annotations

import ctypes

import torch

from ...config import FeatureConfig
from . import _spectral, fused_raw_dit

plain_features = fused_raw_dit.plain_features
_matrices = _spectral.direct_matrices


def _lib() -> ctypes.CDLL:
    return _spectral.bind(
        "fused_raw", "mfcc_fused_raw",
        _spectral.entry_argtypes(_spectral.DIRECT_ARGTYPES, preemph=True,
                                 mixed=True))


def fused_features_raw(x: torch.Tensor, cfg: FeatureConfig, *,
                       apply_dct: bool = True,
                       front: _spectral.Front | None = None,
                       bounds: _spectral.RowBounds | None = None
                       ) -> torch.Tensor:
    """(B, N) raw float32 audio -> (B, T, n_mfcc or n_mels) features.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor goes
    through :func:`plain_features`, both at the float32
    accumulation whatever ``cfg.accum_dtype`` says
    (``_spectral.kernel_config``).  cfg must be in "valid" frame mode.

    ``front`` (a ``_spectral.Front``: the window and the filterbank of a
    front end whose config cannot state them, ``models/whisper``,
    ``models/nemo``) takes their place in whichever tile the config picks,
    with no DCT (``apply_dct`` must be False); a front with ``guard``
    (NeMo's log(e + log_floor)) runs on the "fft64" tile alone.  The card
    only: the plain version knows the config's constants alone, and
    ``_spectral.plain_front_features`` is a front's plain chain.

    ``bounds`` (a ``_spectral.RowBounds``: x is
    ``framing.stft_center_batch``'s output, ``models/whisper``) lets the
    mixed-radix tile skip the frame tiles wholly in the rows' zero tails,
    with the same bits; no other tile reads it, and the plain version
    computes every frame.
    """
    cfg = _spectral.check_input(x, cfg)
    if front is not None and apply_dct:
        raise ValueError("a front's filterbank has no DCT: apply_dct=False")
    if not x.is_cuda:
        if front is not None:
            raise ValueError("a front's constants run on a CUDA tensor only")
        return plain_features(x, cfg, apply_dct)
    _spectral.check_cuda_input(x)
    return _spectral.launch_spectral(
        _lib, "mfcc_fused_raw", "fused_raw", x, cfg, apply_dct, cfg.preemph,
        other=_spectral.direct_tile("mel", front), front=front, mixed=True,
        bounds=bounds)
