"""Global cepstral mean and variance normalization (twin of
``mfcc_tpu/parallel/cmvn.py``, its single-process part).

Corpus statistics are the only cross-utterance coupling of the pipeline,
and they are small: a count and two (F,) vectors.

- :class:`Stats` — additive (count, sum, sumsq); ``merge`` accumulates
  across batches.
- :func:`batch_stats` — masked statistics of one padded batch, on the
  features' device in their dtype (float32 on the card).
- :func:`host_batch_stats` — the same in float64 on the host (the corpus
  runner's ``_host_batch_stats``): for cepstra with |mean| >> std (c0 mean
  ~16, std ~0.6) the float32 variance sumsq/n - mean^2 loses ~3 digits (the
  reference measured 5e-4 relative variance error), which breaks the 1e-4
  contract of normalized features; float64 keeps it.
- :func:`apply` — (x - mean) / std with the variance floored.

The corpus runner sums the float64 statistics across processes with
``parallel/dist.all_reduce_sum_f64`` (over gloo); the reference's shard_map
/ psum variant of the on-device statistics waits (ROADMAP modules item 8).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Stats(NamedTuple):
    """Additive CMVN statistics over frames."""
    count: torch.Tensor   # ()     total frames
    sum: torch.Tensor     # (F,)
    sumsq: torch.Tensor   # (F,)

    @staticmethod
    def zero(n_feats: int, device="cuda") -> "Stats":
        return Stats(torch.zeros((), device=device),
                     torch.zeros((n_feats,), device=device),
                     torch.zeros((n_feats,), device=device))

    def merge(self, other: "Stats") -> "Stats":
        return Stats(self.count + other.count, self.sum + other.sum,
                     self.sumsq + other.sumsq)

    def mean_var(self, eps: float = 1e-8):
        c = torch.clamp(self.count, min=1.0)
        mean = self.sum / c
        var = torch.clamp(self.sumsq / c - mean * mean, min=eps)
        return mean, var


def batch_stats(feat: torch.Tensor, mask: torch.Tensor) -> Stats:
    """(B, T, F) features + (B, T) mask -> masked Stats in feat's dtype.

    Float32 statistics bound normalized cepstra at ~5e-4 (cancellation in
    the variance; see :func:`host_batch_stats`): fine for serving and
    training normalization, not for the corpus contract."""
    m = mask.to(feat.dtype)
    fm = feat * m[..., None]
    return Stats(count=m.sum(), sum=fm.sum(dim=(0, 1)),
                 sumsq=(fm * feat).sum(dim=(0, 1)))


def host_batch_stats(feat, flens) -> Stats:
    """Float64 (count, sum, sumsq) of one batch on the host.

    feat: (B, T, F) with padded frames zeroed (the pipeline's mask does
    that), so plain sums are the masked sums; flens: (B,) frame counts.
    numpy arrays or tensors on any device; the Stats are float64 CPU
    tensors."""
    f = np.asarray(torch.as_tensor(feat).detach().cpu(), np.float64)
    n = np.asarray(torch.as_tensor(flens).detach().cpu()).sum()
    return Stats(torch.tensor(float(n), dtype=torch.float64),
                 torch.from_numpy(f.sum(axis=(0, 1))),
                 torch.from_numpy((f * f).sum(axis=(0, 1))))


def apply(feat: torch.Tensor, stats: Stats, eps: float = 1e-8) -> torch.Tensor:
    """Normalize features with global statistics.  Mean and variance are
    taken in the statistics' dtype (float64 for :func:`host_batch_stats`)
    and rounded once to feat's dtype and device."""
    mean, var = stats.mean_var(eps)
    inv_std = torch.rsqrt(var)
    return ((feat - mean.to(feat.device, feat.dtype))
            * inv_std.to(feat.device, feat.dtype))
