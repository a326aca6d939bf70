"""[static, delta, delta-delta] in one hand-written CUDA kernel.

Replaces no Pallas kernel: the JAX package's deltas are plain ``jnp``
(``mfcc_tpu/ops/deltas.py``).  The plain PyTorch version is
``ops.deltas.plain_append_deltas``: the CPU route and the kernel's twin,
which the kernel equals in every bit on the card.

- :func:`fused_append_deltas` — the wrapper: checks its input and launches
  ``csrc/fused_deltas.cu`` (a build or launch failure raises).  It takes
  CUDA float32 features only; ``ops.deltas.append_deltas`` sends it what
  ``backend.resolve`` routes to "cuda", and records each launch in
  ``utils/report``.

The kernel's design note heads the CUDA source.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...utils import report
from . import _build


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_deltas")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mfcc_append_deltas.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32,
                                       ctypes.c_float, ptr]
    lib.mfcc_append_deltas.restype = i32
    lib.mfcc_error_string.argtypes = [i32]
    lib.mfcc_error_string.restype = ctypes.c_char_p
    return lib


def denominator(window: int) -> float:
    """The deltas' divisor, 2 sum_{n=1..window} n^2."""
    return 2.0 * sum(n * n for n in range(1, window + 1))


def fused_append_deltas(feat: torch.Tensor, window: int,
                        lengths: torch.Tensor | None = None) -> torch.Tensor:
    """(..., T, F) float32 on the card -> (..., T, 3F): [static, delta,
    delta-delta], as ``ops.deltas.plain_append_deltas``.

    lengths: optional (...,) true frame counts (any integer dtype; cast to
    int32 on the card, which syncs nothing when they are already there);
    forward neighbours are clipped to each row's last valid frame.  Counts
    above T read as T.
    """
    if feat.dim() < 2:
        raise ValueError(f"(..., T, F) features expected, got "
                         f"{tuple(feat.shape)}")
    if not feat.is_cuda:
        raise ValueError(f"features on a CUDA device expected, got "
                         f"{feat.device}")
    if feat.dtype != torch.float32:
        raise TypeError(f"float32 features expected, got {feat.dtype}")
    if not feat.is_contiguous():
        raise ValueError("contiguous features expected")
    *lead, T, F = feat.shape
    out = torch.empty((*lead, T, 3 * F), dtype=torch.float32,
                      device=feat.device)
    if out.numel() == 0:
        return out
    B = out.numel() // (T * 3 * F)
    if lengths is not None:
        lengths = lengths.to(device=feat.device, dtype=torch.int32)
        if lengths.numel() != B:
            raise ValueError(f"{B} frame counts expected, got "
                             f"{tuple(lengths.shape)}")
        lengths = lengths.contiguous()
    lib = _lib()
    with torch.cuda.device(feat.device):
        err = lib.mfcc_append_deltas(
            feat.data_ptr(), None if lengths is None else lengths.data_ptr(),
            out.data_ptr(), B, T, F, window, denominator(window),
            torch.cuda.current_stream(feat.device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused_deltas kernel launch failed: "
                           f"{lib.mfcc_error_string(err).decode()} ({err})")
    report.launched("fused_deltas")
    return out
