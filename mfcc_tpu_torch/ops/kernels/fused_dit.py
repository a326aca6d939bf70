"""Pre-emphasized audio -> MFCC or log-mel in one hand-written CUDA kernel
(the Hopper twin of ``mfcc_tpu/ops/kernels/fused_dit.py``).

- :func:`plain_features` — the plain PyTorch version: frames, the radix-2
  DIT power spectrum (``ops/spectrum.power_spectrum_dit``: two half-length
  DFTs of the parity streams and the twiddle combine), mel, floors,
  accurate log, then DCT with the optional log energy in c0, or log-mel.
- :func:`_matrices` — the float64 -> float32 constants of the DIT tile.
- :func:`fused_features_dit` — the wrapper: launches ``csrc/fused_dit.cu``
  for a CUDA tensor (a build or launch failure raises), or runs
  :func:`plain_features` for a CPU tensor; ``utils/report`` records each
  launch and its tile ("fft", "fft64", "dit").

The model layer sends this kernel the configs the raw kernels do not take
whose n_fft is a multiple of 4 and whose hop is even
(``routes.spectral_route``: the 22.05 kHz TTS geometry), after
pre-emphasizing them on the host.  On the card, at a power-of-two n_fft
from 64 to 4096, it runs the shared-memory FFT tile of
``csrc/fft_tile.cuh`` (``_spectral.fft_tile``: a float64 front for
unbounded log-mel, f32 for cepstra and log-mel bounded to <= 50 dB);
other configs run the radix-2 DIT tile of ``csrc/fused_dit.cu``, which
takes any hop and needs n_fft % 4 == 0 (the algorithm's own condition, a
real half-DFT bin n_fft/4).  The plain version stays the DIT form, as in
the reference.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...config import FeatureConfig
from .. import dct as dct_op, mel as mel_op, spectrum
from . import _spectral

HALF_BINS_PER_BLOCK = 128   # must match kHalf in csrc/fused_dit.cu
ROWS_PER_CHUNK = 16         # must match spectral::kChunk


def plain_features(y: torch.Tensor, cfg: FeatureConfig,
                   apply_dct: bool = True) -> torch.Tensor:
    """(B, N) pre-emphasized audio -> (B, T, n_out), plain PyTorch."""
    return _spectral.plain_features(y, cfg, apply_dct,
                                    spectrum.power_spectrum_dit)


@functools.lru_cache(maxsize=16)
def _matrices(cfg: FeatureConfig):
    """Float32 kernel constants from the float64 twins.

    basis (nbb, le_pad, 512): block k, row m holds the window-folded
      half-DFT cos and sin of half-bins 128k .. 128k+127 for even sample m
      (cols 0..127, 128..255) and odd sample m (cols 256..383, 384..511);
      zero past half-bin n_fft/4 - 1, past the even stream's ceil(fl/2)
      rows and past the odd stream's floor(fl/2) rows.  le_pad rounds
      ceil(fl/2) up to the kernel's 16-row chunks;
    last (le_pad, 2): the even and odd half-DFT column of bin n_fft/4 (the
      window times (-1)^m);
    tw (2, n_fft/4): cos and sin of 2 pi j / n_fft;
    mel (n_bins, n_mels); dct (n_mels, n_mfcc), lifter folded in.
    """
    (be, bel), (bo, bol), ct, st = spectrum.dit_matrices(cfg)
    nb2, H = cfg.n_fft // 4, HALF_BINS_PER_BLOCK
    le, lo = be.shape[0], bo.shape[0]
    le_pad = -(-le // ROWS_PER_CHUNK) * ROWS_PER_CHUNK
    nbb = -(-nb2 // H)
    basis = np.zeros((nbb, le_pad, 4 * H), np.float32)
    for k in range(nbb):
        j0, j1 = k * H, min(nb2, (k + 1) * H)
        for col, (b, rows) in enumerate(((be[:, :nb2], le), (be[:, nb2:], le),
                                         (bo[:, :nb2], lo), (bo[:, nb2:], lo))):
            basis[k, :rows, col * H: col * H + j1 - j0] = b[:, j0:j1]
    last = np.zeros((le_pad, 2), np.float32)
    last[:le, 0] = bel[:, 0]
    last[:lo, 1] = bol[:, 0]
    tw = np.stack([ct, st]).astype(np.float32)
    return (basis, last, tw, mel_op.mel_matrix(cfg).astype(np.float32),
            dct_op.dct_matrix(cfg).astype(np.float32))


@functools.lru_cache(maxsize=16)
def _pinned_matrices(cfg: FeatureConfig):
    return _spectral.pinned(_matrices(cfg))


def _dit_consts(cfg: FeatureConfig, device: torch.device):
    """The DIT tile's constants as the entry takes them, uploaded from
    pinned memory on the current stream: -> ([basis, nbb, le_pad, last,
    tw, melw], dctm)."""
    basis, last, tw, melw, dctm = (t.to(device, non_blocking=True)
                                   for t in _pinned_matrices(cfg))
    return [basis, basis.shape[0], basis.shape[1], last, tw, melw], dctm


# the entry's other tile: its name, constants and their nulls, and the C
# types of (basis, nbb, le_pad, last, tw, melw)
DIT_TILE = ("dit", _dit_consts, [None, 0, 0, None, None, None])
DIT_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    return _spectral.bind(
        "fused_dit", "mfcc_fused_dit",
        _spectral.entry_argtypes(DIT_ARGTYPES, preemph=False))


def fused_features_dit(y: torch.Tensor, cfg: FeatureConfig, *,
                       apply_dct: bool = True) -> torch.Tensor:
    """(B, N) pre-emphasized float32 audio -> (B, T, n_mfcc or n_mels).

    A CUDA tensor goes through the kernel (or raises); a CPU tensor goes
    through :func:`plain_features`, both at the float32
    accumulation whatever ``cfg.accum_dtype`` says
    (``_spectral.kernel_config``).  cfg must be in "valid" frame mode and
    have n_fft % 4 == 0.
    """
    cfg = _spectral.check_input(y, cfg)
    if not spectrum.dit_supported(cfg):
        raise ValueError("the radix-2 DIT needs n_fft % 4 == 0 and "
                         "frame_len >= 2")
    if not y.is_cuda:
        return plain_features(y, cfg, apply_dct)
    _spectral.check_cuda_input(y)
    return _spectral.launch_spectral(
        _lib, "mfcc_fused_dit", "fused_dit", y, cfg, apply_dct, None,
        other=DIT_TILE)
