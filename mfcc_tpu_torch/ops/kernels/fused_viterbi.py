"""Pitch Viterbi (forward recursion + backtrace) in one hand-written CUDA
kernel (the Hopper twin of ``mfcc_tpu/ops/kernels/fused_viterbi.py``).

- The plain PyTorch version is ``ops.pitch.viterbi``: the CPU path and the
  kernel's differential twin.  The kernel's paths are bit-identical to it.
- :func:`fused_viterbi` — the wrapper: checks its input and launches
  ``csrc/fused_viterbi.cu`` for a CUDA tensor (a build or launch failure
  raises), or runs ``ops.pitch.viterbi`` for a CPU tensor.  It takes every
  lag-grid size.
- ``LAUNCHES`` — how many times the wrapper launched the kernel.

The kernel's design note heads the CUDA source.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...config import PitchConfig
from .. import pitch as pitch_op
from . import _build

# kernel launches by fused_viterbi (reset by callers that count)
LAUNCHES = 0


@functools.lru_cache(maxsize=16)
def _pinned_trans(pcfg: PitchConfig) -> torch.Tensor:
    """The plain version's float32 transition matrix, page-locked so the
    upload is an asynchronous copy on the launch stream."""
    return torch.from_numpy(pitch_op._trans_matrix(pcfg)).pin_memory()


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_viterbi")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mfcc_fused_viterbi.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.mfcc_fused_viterbi.restype = i32
    lib.mfcc_error_string.argtypes = [i32]
    lib.mfcc_error_string.restype = ctypes.c_char_p
    return lib


def fused_viterbi(nccf_b: torch.Tensor, pcfg: PitchConfig) -> torch.Tensor:
    """(B, T, n_lags) masked ballasted NCCF -> (B, T) int32 lag indices."""
    if nccf_b.dim() != 3 or nccf_b.shape[-1] != pcfg.n_lags:
        raise ValueError(f"(B, T, {pcfg.n_lags}) scores expected, got "
                         f"{tuple(nccf_b.shape)}")
    if not nccf_b.is_cuda:
        return pitch_op.viterbi(nccf_b, pcfg)
    if nccf_b.dtype != torch.float32:
        raise TypeError(f"float32 scores expected, got {nccf_b.dtype}")
    if not nccf_b.is_contiguous():
        raise ValueError("contiguous scores expected")
    B, T, n = nccf_b.shape
    path = torch.empty((B, T), dtype=torch.int32, device=nccf_b.device)
    if B == 0 or T == 0:
        return path
    bp = torch.empty((B, T, n), dtype=torch.int32, device=nccf_b.device)
    lib = _lib()
    with torch.cuda.device(nccf_b.device):
        trans = _pinned_trans(pcfg).to(nccf_b.device, non_blocking=True)
        err = lib.mfcc_fused_viterbi(
            nccf_b.data_ptr(), trans.data_ptr(), bp.data_ptr(),
            path.data_ptr(), B, T, n,
            torch.cuda.current_stream(nccf_b.device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused_viterbi kernel launch failed: "
                           f"{lib.mfcc_error_string(err).decode()} ({err})")
    global LAUNCHES
    LAUNCHES += 1
    return path
