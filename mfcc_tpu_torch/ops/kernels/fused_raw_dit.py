"""Raw audio -> MFCC in one hand-written CUDA kernel (the Hopper twin of
``mfcc_tpu/ops/kernels/fused_raw_dit.py``, projection="mel").

- :func:`plain_features` — the plain PyTorch version of the whole fused
  chain (pre-emphasis, window-folded DFT power, mel, floors, accurate log,
  lifter-folded DCT, optional log energy in c0).  The CPU path and the
  kernel's differential twin.
- :func:`_matrices` — the float64 -> float32 constants the kernel reads.
- :func:`fused_features_raw_dit` — the wrapper: checks its input and
  launches ``csrc/fused_raw_dit.cu`` for a CUDA tensor (a build or launch
  failure raises), or runs :func:`plain_features` for a CPU tensor.
- ``LAUNCHES`` — how many times the wrapper launched the kernel.

The kernel's design note (what bounds it, what the design does about it)
heads the CUDA source.  The TPU kernel's radix-2 DIT layout is not carried
over: the Hopper kernel runs the direct window-folded DFT in natural bin
order with the plain mel matrix.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ... import backend
from ...config import FeatureConfig
from .. import dct as dct_op, framing, mel as mel_op, spectrum
from . import _build

# kernel launches by fused_features_raw_dit (reset by callers that count)
LAUNCHES = 0

_BINS_PER_BLOCK = 256   # must match kBins in csrc/fused_raw_dit.cu


def plain_features(x: torch.Tensor, cfg: FeatureConfig,
                   apply_dct: bool = True) -> torch.Tensor:
    """(B, N) raw audio -> (B, T, n_mfcc or n_mels), plain PyTorch."""
    backend.check_config(cfg)
    B, N = x.shape
    T = cfg.num_frames(N)
    n_out = cfg.n_mfcc if apply_dct else cfg.n_mels
    if T == 0:
        return x.new_zeros((B, 0, n_out), dtype=torch.float32)
    y = framing.preemphasize(x.to(torch.float32), cfg)
    power = spectrum.power_spectrum(framing.frames(y, cfg), cfg)
    logmel = mel_op.log_mel_energies(power, cfg)
    if not apply_dct:
        return logmel
    feat = dct_op.cepstra(logmel, cfg)
    if cfg.append_energy:
        e = spectrum.log_energy_blocked(y, cfg)
        feat = torch.cat([e[..., None], feat[..., 1:]], dim=-1)
    return feat


@functools.lru_cache(maxsize=16)
def _matrices(cfg: FeatureConfig):
    """Float32 kernel constants from the float64 builders.

    basis (nbb, frame_len, 512): block k holds the window-folded cos (cols
      0..255) and sin (cols 256..511) of bins 256k .. 256k+255, zero past
      bin n_bins-2;
    last (frame_len, 2): cos and sin of the last bin n_bins-1 (the Nyquist
      for even n_fft), kept out of the blocks so they stay 256 wide;
    mel (n_bins, n_mels); dct (n_mels, n_mfcc), lifter folded in.
    """
    cos_m, sin_m = spectrum.dft_matrices(cfg)
    fl, nb = cfg.frame_len, cfg.n_bins - 1
    nbb = -(-nb // _BINS_PER_BLOCK)
    basis = np.zeros((nbb, fl, 2 * _BINS_PER_BLOCK), np.float32)
    for k in range(nbb):
        lo, hi = k * _BINS_PER_BLOCK, min(nb, (k + 1) * _BINS_PER_BLOCK)
        basis[k, :, : hi - lo] = cos_m[:, lo:hi]
        basis[k, :, _BINS_PER_BLOCK: _BINS_PER_BLOCK + hi - lo] = sin_m[:, lo:hi]
    last = np.stack([cos_m[:, nb], sin_m[:, nb]], axis=1).astype(np.float32)
    return (basis, np.ascontiguousarray(last),
            mel_op.mel_matrix(cfg).astype(np.float32),
            dct_op.dct_matrix(cfg).astype(np.float32))


@functools.lru_cache(maxsize=16)
def _pinned_matrices(cfg: FeatureConfig):
    """:func:`_matrices` in page-locked host memory, so that each call's
    upload is an asynchronous copy on the launch stream instead of a
    pageable copy that blocks the host."""
    return tuple(torch.from_numpy(a).pin_memory() for a in _matrices(cfg))


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_raw_dit")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mfcc_fused_raw_dit.argtypes = [
        ptr, i32, ctypes.c_longlong, i32, ptr, i32, ptr, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, f32, f32, f32, i32, ptr]
    lib.mfcc_fused_raw_dit.restype = i32
    lib.mfcc_error_string.argtypes = [i32]
    lib.mfcc_error_string.restype = ctypes.c_char_p
    return lib


def fused_features_raw_dit(x: torch.Tensor, cfg: FeatureConfig, *,
                           apply_dct: bool = True) -> torch.Tensor:
    """(B, N) raw float32 audio -> (B, T, n_mfcc) features.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor goes
    through :func:`plain_features`.  cfg must be in "valid" frame mode
    (models.mfcc resolves centre mode first).
    """
    backend.check_config(cfg)
    if x.dim() != 2:
        raise ValueError(f"batch input (B, N) expected, got {tuple(x.shape)}")
    if cfg.frame_mode != "valid":
        raise ValueError("resolve frame_mode='center' to 'valid' first "
                         "(ops.framing.resolve_frame_mode)")
    if not x.is_cuda:
        return plain_features(x, cfg, apply_dct)
    if not apply_dct:
        raise NotImplementedError(
            "log-mel output (apply_dct=False) on CUDA is not ported yet "
            "(ROADMAP.md, modules to port, item 2: apply_dct=False on CUDA)")
    if x.dtype != torch.float32:
        raise TypeError(f"float32 audio expected, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("contiguous audio expected")
    B, N = x.shape
    T = cfg.num_frames(N)
    out = torch.empty((B, T, cfg.n_mfcc), dtype=torch.float32,
                      device=x.device)
    if B == 0 or T == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        basis, last, melw, dctm = (t.to(x.device, non_blocking=True)
                                   for t in _pinned_matrices(cfg))
        err = lib.mfcc_fused_raw_dit(
            x.data_ptr(), B, N, T, basis.data_ptr(), basis.shape[0],
            last.data_ptr(), melw.data_ptr(), dctm.data_ptr(), out.data_ptr(),
            cfg.frame_len, cfg.hop_len, cfg.n_bins, cfg.n_mels, cfg.n_mfcc,
            cfg.preemph, cfg.log_floor, mel_op.relative_floor(cfg),
            int(cfg.append_energy),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused_raw_dit kernel launch failed: "
                           f"{lib.mfcc_error_string(err).decode()} ({err})")
    global LAUNCHES
    LAUNCHES += 1
    return out
