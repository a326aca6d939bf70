"""Padding-aware delta / delta-delta features (twin of
``mfcc_tpu/ops/deltas.py``).

    d[t] = sum_{n=1..D} n * (c[t+n] - c[t-n]) / (2 * sum n^2)

with edge replication at the true utterance boundary: for a ragged batch
the forward neighbour is clipped to each utterance's last valid frame, so
padded frames never leak into the derivatives of real frames.

:func:`append_deltas` on the card is one launch of ``kernels/fused_deltas``
(``backend.resolve``, as the spectral kernels are routed); elsewhere, and
under "high" on the card, it is :func:`plain_append_deltas`, the kernel's
twin, equal to it in every bit.  :class:`DeltaStream` is the streaming
twin: it runs on the host in numpy float64, over ``oracle.deltas``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import backend as backend_lib
from ..config import FeatureConfig
from .kernels import fused_deltas


def deltas(feat: torch.Tensor, window: int = 2,
           lengths: torch.Tensor | None = None) -> torch.Tensor:
    """(..., T, F) -> (..., T, F) regression deltas.

    lengths: optional (...,) true frame counts; neighbour indices are
    clipped to length-1.  Without lengths, edges replicate at 0 and T-1.
    """
    T = feat.shape[-2]
    if T == 0:
        return torch.zeros_like(feat)
    t = torch.arange(T, device=feat.device)
    if lengths is not None:
        hi_cap = torch.clamp(lengths.to(feat.device, torch.int64), min=1) - 1
        last = torch.gather(
            feat, -2, hi_cap[..., None, None].expand(
                *feat.shape[:-2], 1, feat.shape[-1]))
    out = torch.zeros_like(feat)
    for n in range(1, window + 1):
        plus = torch.cat(
            [feat[..., n:, :], feat[..., -1:, :].expand(
                *feat.shape[:-2], min(n, T), feat.shape[-1])], dim=-2)[..., :T, :]
        minus = torch.cat(
            [feat[..., :1, :].expand(*feat.shape[:-2], min(n, T),
                                     feat.shape[-1]),
             feat[..., :max(T - n, 0), :]], dim=-2)
        if lengths is not None:
            ragged_edge = (t + n)[:, None] > hi_cap[..., None, None]
            plus = torch.where(ragged_edge, last, plus)
        out = out + n * (plus - minus)
    # a 0-d tensor made on the device: a true division, and no copy from
    # the host (which syncs the stream); a Python float would have ATen's
    # CUDA kernel multiply by its float32 reciprocal instead
    return out / torch.full((), fused_deltas.denominator(window),
                            dtype=feat.dtype, device=feat.device)


def plain_append_deltas(feat: torch.Tensor, window: int = 2,
                        lengths: torch.Tensor | None = None) -> torch.Tensor:
    """(..., T, F) -> (..., T, 3F): [static, delta, delta-delta] in plain
    PyTorch, the twin of ``kernels/fused_deltas``."""
    d1 = deltas(feat, window, lengths)
    d2 = deltas(d1, window, lengths)
    return torch.cat([feat, d1, d2], dim=-1)


def append_deltas(feat: torch.Tensor, cfg: FeatureConfig,
                  lengths: torch.Tensor | None = None,
                  backend: str = "auto") -> torch.Tensor:
    """(..., T, F) -> (..., T, 3F): [static, delta, delta-delta], through
    ``kernels/fused_deltas`` where ``backend`` resolves to "cuda" for
    ``feat`` and ``cfg`` (float32 features; other dtypes raise), else
    through :func:`plain_append_deltas`."""
    if backend_lib.resolve(backend, feat, cfg) == "cuda":
        return fused_deltas.fused_append_deltas(feat, cfg.delta_window,
                                                lengths)
    return plain_append_deltas(feat, cfg.delta_window, lengths)


class DeltaStream:
    """Streaming delta / delta-delta post-processor (host side; twin of
    ``mfcc_tpu.ops.deltas.DeltaStream``).

    Deltas need a +-window halo and delta-deltas a halo of deltas, so exact
    emission lags the static stream by 2 window frames.  This buffers the
    incoming static frames and emits [static, delta, delta-delta] rows equal
    to the batch computation's prefix (start-edge replication included);
    the last 2 window frames of a stream need :meth:`flush` (end-edge
    replication) once the source is done.  Features are tens of floats a
    frame, so this runs in float64 numpy next to the consumer.
    """

    def __init__(self, window: int = 2):
        self.window = window
        self._buf = None          # retained frames (float64, (K, F))
        self._buf_start = 0       # global index of _buf[0]
        self._emitted = 0         # next global row to emit
        self._total = 0           # frames received
        self._at_start = True     # _buf[0] is the true stream start

    def _slice_deltas(self, lo: int, hi: int) -> np.ndarray:
        """Exact [static, delta, delta-delta] for global rows [lo, hi) from
        the retained frames; edge replication happens only at the true
        stream boundaries (interior slice edges have real +-2w context)."""
        from .. import oracle
        w = self.window
        a = max(self._buf_start, lo - 2 * w)
        feat = self._buf[a - self._buf_start:]
        d1 = oracle.deltas(feat, w)
        d2 = oracle.deltas(d1, w)
        return np.concatenate([feat, d1, d2], axis=-1)[lo - a: hi - a]

    def push(self, static_frames) -> np.ndarray:
        """Add (k, F) new static frames (numpy or a tensor); returns every
        newly final [static, delta, delta-delta] row (possibly none)."""
        if isinstance(static_frames, torch.Tensor):
            static_frames = static_frames.detach().cpu().numpy()
        new = np.asarray(static_frames, np.float64).reshape(
            -1, static_frames.shape[-1])
        self._buf = new if self._buf is None else np.concatenate(
            [self._buf, new])
        self._total += new.shape[0]
        w = self.window
        safe = self._total - 2 * w       # rows no future frame can change
        if safe <= self._emitted:
            return np.zeros((0, new.shape[-1] * 3))
        out = self._slice_deltas(self._emitted, safe)
        self._emitted = safe
        # keep only what future rows can still reference: 4w frames back
        keep_from = max(self._buf_start, self._emitted - 4 * w)
        if self._at_start and self._emitted > 4 * w:
            self._at_start = False
        if not self._at_start:
            self._buf = self._buf[keep_from - self._buf_start:]
            self._buf_start = keep_from
        return out

    def flush(self) -> np.ndarray:
        """Emit the trailing 2 window rows (the end edge is now known)."""
        if self._buf is None or self._emitted >= self._total:
            return np.zeros((0, 0))
        out = self._slice_deltas(self._emitted, self._total)
        self._emitted = self._total
        return out
