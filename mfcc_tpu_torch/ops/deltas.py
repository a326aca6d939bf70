"""Padding-aware delta / delta-delta features (twin of
``mfcc_tpu/ops/deltas.py``).

    d[t] = sum_{n=1..D} n * (c[t+n] - c[t-n]) / (2 * sum n^2)

with edge replication at the true utterance boundary: for a ragged batch
the forward neighbour is clipped to each utterance's last valid frame, so
padded frames never leak into the derivatives of real frames.
"""

from __future__ import annotations

import torch

from ..config import FeatureConfig


def deltas(feat: torch.Tensor, window: int = 2,
           lengths: torch.Tensor | None = None) -> torch.Tensor:
    """(..., T, F) -> (..., T, F) regression deltas.

    lengths: optional (...,) true frame counts; neighbour indices are
    clipped to length-1.  Without lengths, edges replicate at 0 and T-1.
    """
    T = feat.shape[-2]
    if T == 0:
        return torch.zeros_like(feat)
    denom = 2.0 * sum(n * n for n in range(1, window + 1))
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
    return out / torch.tensor(denom, dtype=feat.dtype, device=feat.device)


def append_deltas(feat: torch.Tensor, cfg: FeatureConfig,
                  lengths: torch.Tensor | None = None) -> torch.Tensor:
    """(..., T, F) -> (..., T, 3F): [static, delta, delta-delta]."""
    d1 = deltas(feat, cfg.delta_window, lengths)
    d2 = deltas(d1, cfg.delta_window, lengths)
    return torch.cat([feat, d1, d2], dim=-1)
