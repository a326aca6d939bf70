"""Pre-emphasized audio -> MFCC or log-mel in one hand-written CUDA kernel
(the Hopper twin of ``mfcc_tpu/ops/kernels/fused_mfcc.py``).

- :func:`plain_features` — the plain PyTorch version: frames, direct DFT
  power over all bins, mel, floors, accurate log, then DCT with the
  optional log energy of the frames in c0, or log-mel.
- :func:`fused_features` — the wrapper: launches ``csrc/fused_mfcc.cu`` for
  a CUDA tensor (a build or launch failure raises), or runs
  :func:`plain_features` for a CPU tensor.
- :func:`acc_log` — the kernels' accurate log (``csrc/spectral.cuh``)
  applied to a buffer on the card, as the reference keeps its in-kernel
  ``_acc_log`` here; for a bit-for-bit check against ``ops/xmath``.

``utils/report`` records each launch of :func:`fused_features` and its
tile ("fft", "fft64", "direct").

The model layer sends this kernel the configs neither raw kernel nor the
DIT kernel takes (``routes.spectral_route``), after pre-emphasizing them on
the host (``ops/framing.preemphasize``).  Like every spectral kernel, it
runs the FFT tile of ``csrc/fft_tile.cuh`` at a power-of-two n_fft from 64
to 4096 (``_spectral.fft_tile``: 44.1 kHz MFCC at n_fft 2048), in f32 for
cepstra and log-mel bounded to <= 50 dB and with a float64 front for
other log-mel, else the direct tile of ``csrc/spectral.cuh``.
"""

from __future__ import annotations

import ctypes

import torch

from ...config import FeatureConfig
from .. import xmath
from . import _spectral


def plain_features(y: torch.Tensor, cfg: FeatureConfig,
                   apply_dct: bool = True) -> torch.Tensor:
    """(B, N) pre-emphasized audio -> (B, T, n_out), plain PyTorch."""
    return _spectral.plain_features(y, cfg, apply_dct)


def _lib() -> ctypes.CDLL:
    return _spectral.bind(
        "fused_mfcc", "mfcc_fused_mfcc",
        _spectral.entry_argtypes(_spectral.DIRECT_ARGTYPES, preemph=False))


def fused_features(y: torch.Tensor, cfg: FeatureConfig, *,
                   apply_dct: bool = True) -> torch.Tensor:
    """(B, N) pre-emphasized float32 audio -> (B, T, n_mfcc or n_mels).

    A CUDA tensor goes through the kernel (or raises); a CPU tensor goes
    through :func:`plain_features`, both at the float32
    accumulation whatever ``cfg.accum_dtype`` says
    (``_spectral.kernel_config``).  cfg must be in "valid" frame mode.
    """
    cfg = _spectral.check_input(y, cfg)
    if not y.is_cuda:
        return plain_features(y, cfg, apply_dct)
    _spectral.check_cuda_input(y)
    return _spectral.launch_spectral(
        _lib, "mfcc_fused_mfcc", "fused_mfcc", y, cfg, apply_dct, None)


def acc_log(x: torch.Tensor) -> torch.Tensor:
    """Elementwise accurate log: the CUDA kernels' ``acc_log`` for a CUDA
    tensor (the shared header's test entry; no launch recorded),
    ``ops/xmath``'s function for a CPU tensor."""
    if not x.is_cuda:
        return xmath._acc_log(x)
    _spectral.check_cuda_input(x)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.mfcc_acc_log(x.data_ptr(), out.data_ptr(), x.numel(),
                               torch.cuda.current_stream(x.device).cuda_stream)
    _spectral.raise_on_error(err, lib, "acc_log")
    return out
