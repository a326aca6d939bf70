"""Pitch Viterbi (forward recursion + backtrace) in one hand-written CUDA
kernel (the Hopper twin of ``mfcc_tpu/ops/kernels/fused_viterbi.py``).

- The plain PyTorch version is ``ops.pitch.viterbi``: the CPU path and the
  kernel's differential twin.  The kernel's paths are bit-identical to it.
- :func:`fused_viterbi` — the wrapper: checks its input and launches
  ``csrc/fused_viterbi.cu`` for a CUDA tensor (a build or launch failure
  raises), or runs ``ops.pitch.viterbi`` for a CPU tensor.  It takes every
  lag-grid size.  It records each launch in ``utils/report`` with the
  launch shape the C entry planned (``report.last_shape("fused_viterbi")``:
  lanes per state K, a lane's range J, threads, register path,
  backpointer steps held in shared memory TB, score chunk).

The kernel's design note heads the CUDA source.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...config import PitchConfig
from ...utils import report
from .. import pitch as pitch_op
from . import _build

SHAPE_KEYS = ("K", "J", "threads", "register_path", "TB", "score_chunk")


@functools.lru_cache(maxsize=16)
def _pinned_trans(pcfg: PitchConfig) -> torch.Tensor:
    """The plain version's float32 transition matrix, page-locked so the
    upload is an asynchronous copy on the launch stream."""
    return torch.from_numpy(pitch_op._trans_matrix(pcfg)).pin_memory()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load("fused_viterbi"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries' argument and result types on a build of
    ``csrc/fused_viterbi.cu``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mfcc_fused_viterbi.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.mfcc_fused_viterbi.restype = i32
    lib.mfcc_viterbi_plan.argtypes = [i32, i32, i32, ptr]
    lib.mfcc_viterbi_plan.restype = ctypes.c_longlong
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
    lib = _lib()
    shape = (ctypes.c_int * len(SHAPE_KEYS))()
    with torch.cuda.device(nccf_b.device), report.span("fused_viterbi"):
        spill_bytes = lib.mfcc_viterbi_plan(B, T, n, shape)
        if spill_bytes < 0:
            err = -spill_bytes
            raise RuntimeError("fused_viterbi kernel plan failed: "
                               f"{lib.mfcc_error_string(err).decode()} ({err})")
        # backpointers of a chain too long for shared memory spill here
        spill = (torch.empty(spill_bytes, dtype=torch.uint8,
                             device=nccf_b.device) if spill_bytes else None)
        trans = _pinned_trans(pcfg).to(nccf_b.device, non_blocking=True)
        err = lib.mfcc_fused_viterbi(
            nccf_b.data_ptr(), trans.data_ptr(),
            None if spill is None else spill.data_ptr(), path.data_ptr(),
            B, T, n, torch.cuda.current_stream(nccf_b.device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused_viterbi kernel launch failed: "
                           f"{lib.mfcc_error_string(err).decode()} ({err})")
    report.launched("fused_viterbi", shape=dict(zip(SHAPE_KEYS, shape)))
    return path
