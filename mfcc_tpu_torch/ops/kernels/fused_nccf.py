"""Pitch NCCF in one hand-written CUDA kernel (the Hopper twin of
``mfcc_tpu/ops/kernels/fused_nccf.py``).

- :func:`plain_nccf` — the plain PyTorch version: ``ops.pitch.nccf`` (the
  correlation-theorem form) with the given ballast.  The CPU path and the
  kernel's differential twin.
- :func:`fused_nccf` — the wrapper: checks its input and launches
  ``csrc/fused_nccf.cu`` for a CUDA tensor (a build or launch failure
  raises), or runs :func:`plain_nccf` for a CPU tensor.  The kernel takes
  every window the reference takes: where no tile of whole windows fits in
  shared memory, the C entry plans the lag-blocked tiling.
- :func:`launch` — one launch through a build's C entry, unrecorded (the
  wrapper's, and the A/B builds' of ``tools/ablate_pitch.py``).

The wrapper records each launch in ``utils/report`` with the tile the C
entry planned (``report.last_shape("fused_nccf")``, :data:`SHAPE_KEYS`):
frames a tile TM, lags a thread R, lag passes a thread, window energies
shared by the tile, outputs staged in shared memory, and for the
lag-blocked tiling the lags a block and the samples a chunk (0 and 0 for
the tiles that stage whole windows).

The kernel computes the numerators by direct time-domain correlation, not
by the TPU kernel's DFT factorization; its design note heads the CUDA
source.  The TPU eligibility rule (lane phases, K <= 128) is a lane-layout
rule and does not carry over.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...config import PitchConfig
from ...utils import report
from .. import pitch as pitch_op
from . import _build

SHAPE_KEYS = ("TM", "R", "passes", "shared_energy", "stage_out",
              "lag_block", "sample_chunk")


def plain_nccf(xw: torch.Tensor, ball: torch.Tensor, pcfg: PitchConfig,
               T: int):
    """(B, Nw) work-rate rows + (B,) ballast -> the (B, T, n_lags)
    ballasted and plain NCCF, plain PyTorch."""
    mask = torch.ones((xw.shape[0], T), dtype=torch.bool, device=xw.device)
    return pitch_op.nccf(xw, pcfg, mask, ball=ball)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load("fused_nccf"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries' argument and result types on a build of
    ``csrc/fused_nccf.cu``."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mfcc_fused_nccf.argtypes = [ptr, i64, i64, ptr, ptr, ptr,
                                    i32, i32, i32, i32, i32, i32, ptr, ptr]
    lib.mfcc_fused_nccf.restype = i32
    lib.mfcc_error_string.argtypes = [i32]
    lib.mfcc_error_string.restype = ctypes.c_char_p
    return lib


def fused_nccf(xw: torch.Tensor, ball: torch.Tensor, pcfg: PitchConfig, *,
               T: int):
    """(B, Nw) float32 work-rate rows + (B,) ballast (ballast *
    mean_energy^2) -> ((B, T, n_lags) ballasted NCCF, (B, T, n_lags) plain
    NCCF).  Frames whose window runs past a row's end read zeros there;
    they are invalid and every caller masks them."""
    if xw.dim() != 2 or ball.shape != (xw.shape[0],):
        raise ValueError(f"(B, Nw) rows and (B,) ballast expected, got "
                         f"{tuple(xw.shape)} and {tuple(ball.shape)}")
    if not xw.is_cuda:
        return plain_nccf(xw, ball, pcfg, T)
    if xw.dtype != torch.float32 or ball.dtype != torch.float32:
        raise TypeError(f"float32 rows and ballast expected, got {xw.dtype} "
                        f"and {ball.dtype}")
    if xw.stride(1) != 1 or not ball.is_contiguous():
        raise ValueError("rows with unit sample stride and a contiguous "
                         "ballast expected")
    if ball.device != xw.device:
        raise ValueError(f"ballast on {ball.device}, rows on {xw.device}")
    if xw.shape[0] == 0 or T == 0:
        out = torch.empty((xw.shape[0], T, pcfg.n_lags), dtype=torch.float32,
                          device=xw.device)
        return out, torch.empty_like(out)
    out_b, out_p, shape = launch(_lib(), xw, ball, pcfg, T)
    report.launched("fused_nccf", shape=shape)
    return out_b, out_p


def launch(lib: ctypes.CDLL, xw: torch.Tensor, ball: torch.Tensor,
           pcfg: PitchConfig, T: int):
    """One launch of a bound build of ``csrc/fused_nccf.cu`` on checked
    CUDA inputs (float32, unit sample stride, B >= 1, T >= 1), not
    recorded -> (out_b, out_p, the tile it planned).  A launch the card
    refuses raises RuntimeError."""
    B, Nw = xw.shape
    out_b = torch.empty((B, T, pcfg.n_lags), dtype=torch.float32,
                        device=xw.device)
    out_p = torch.empty_like(out_b)
    # one row may carry any stride (a numpy x[None] view has 0)
    ldx = xw.stride(0) if B > 1 else Nw
    shape = (ctypes.c_int * len(SHAPE_KEYS))()
    with torch.cuda.device(xw.device), report.span("fused_nccf"):
        err = lib.mfcc_fused_nccf(
            xw.data_ptr(), ldx, Nw, ball.data_ptr(),
            out_b.data_ptr(), out_p.data_ptr(), B, T, pcfg.frame_len_w,
            pcfg.hop_len_w, pcfg.min_lag, pcfg.n_lags,
            torch.cuda.current_stream(xw.device).cuda_stream, shape)
    if err != 0:
        raise RuntimeError("fused_nccf kernel launch failed: "
                           f"{lib.mfcc_error_string(err).decode()} ({err})")
    return out_b, out_p, dict(zip(SHAPE_KEYS, shape))
