"""Feature post-processing: sliding and online CMVN, context splicing,
energy VAD (twin of ``mfcc_tpu/ops/post.py``).

The Kaldi post-processing trio (apply-cmvn-sliding / apply-cmvn-online,
splice-feats, compute-vad) between a front end and an acoustic model.  All
are (B, T, F) batched and padding-aware through the frame-count vector:
padded frames never enter a window and stay zero on output.  Float64 twins
are in ``oracle.py``.

Window statistics are one cumulative sum and two gathers.  The sums run on
data shifted by each utterance's first frame: (feat - mean) and the
variance do not change under a shift, and in float32 the shift keeps
E[x'^2] near the variance instead of variance + mean^2, whose difference
would cancel for short windows when |mean| ~ std.  A cumsum on the card
sums in another order than the CPU's, so hold the card to the oracle, not
to the CPU's bits.
"""

from __future__ import annotations

import numpy as np
import torch


def _gather_t(cs: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """cs[:, idx] for static frame indices."""
    return cs[:, torch.from_numpy(idx).to(cs.device)]


def _cumsum0(v: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) -> (B, T + 1, ...): 0, then the running sums over T."""
    return torch.cat([torch.zeros_like(v[:, :1]), torch.cumsum(v, dim=1)],
                     dim=1)


def _window_sums(v: torch.Tensor, window: int):
    """(B, T, ...) -> per-frame sums over the centred window (edges shrink)
    and the per-frame window counts (T,) as numpy."""
    T = v.shape[1]
    half = window // 2
    hi = np.minimum(np.arange(T) + half + 1, T)
    lo = np.maximum(np.arange(T) - half, 0)
    cs = _cumsum0(v)
    return _gather_t(cs, hi) - _gather_t(cs, lo), hi - lo


def _valid(T: int, flens: torch.Tensor, device) -> torch.Tensor:
    """(B, T) bool: frame t is inside its utterance."""
    t = torch.arange(T, dtype=torch.int64, device=device)
    return t[None, :] < flens.to(device=device, dtype=torch.int64)[:, None]


def _counts(lo: np.ndarray, hi: np.ndarray, flens: torch.Tensor,
            dtype, device) -> torch.Tensor:
    """(B, T) frames of [lo, hi) inside each utterance, at least 1."""
    fl = flens.to(device=device, dtype=torch.int64)[:, None]
    lo_t = torch.from_numpy(lo).to(device)[None, :]
    hi_t = torch.from_numpy(hi).to(device)[None, :]
    cnt = torch.minimum(hi_t, fl) - torch.minimum(lo_t, fl)
    return torch.clamp(cnt.to(dtype), min=1.0)


def _normalize(feat, c, sums, sq, cnt):
    mean_s = sums / cnt[..., None]
    out = (feat - c) - mean_s
    if sq is not None:
        var = torch.clamp(sq / cnt[..., None] - mean_s * mean_s, min=1e-8)
        out = out / torch.sqrt(var)
    return out


def sliding_cmvn(feat: torch.Tensor, flens: torch.Tensor, window: int = 600,
                 normalize_variance: bool = False) -> torch.Tensor:
    """(B, T, F) + (B,) frame counts -> sliding mean (and optionally
    variance) normalization over a centred ``window``.

    The window is centred and shrinks at the utterance's edges (for T <=
    window this is per-utterance CMVN); padded frames are excluded from
    every window and stay zero.  Variance is floored at 1e-8.
    """
    T = feat.shape[1]
    mask = _valid(T, flens, feat.device).to(feat.dtype)
    half = window // 2
    t = np.arange(T)
    cnt = _counts(np.maximum(t - half, 0), np.minimum(t + half + 1, T),
                  flens, feat.dtype, feat.device)
    c = feat[:, :1, :]
    fs = (feat - c) * mask[..., None]
    sums, _ = _window_sums(fs, window)
    sq = _window_sums(fs * fs, window)[0] if normalize_variance else None
    return _normalize(feat, c, sums, sq, cnt) * mask[..., None]


def online_cmvn(feat: torch.Tensor, flens: torch.Tensor, window: int = 600,
                normalize_variance: bool = False,
                prior=None) -> torch.Tensor:
    """(B, T, F) + (B,) frame counts -> causal online CMVN.

    Frame t is normalized by the statistics of frames
    [max(0, t - window + 1), t], zero lookahead (Kaldi apply-cmvn-online;
    the batch twin of ``models/streaming.online_cmvn_step``).  ``prior``:
    optional (count (), sum (F,), sumsq (F,)) global statistics blended in
    with weight min(prior_count, window - cnt) while the window is young.
    The shift is frame 0, which every window sees first, so past outputs
    do not change when future frames do.
    """
    T = feat.shape[1]
    mask = _valid(T, flens, feat.device).to(feat.dtype)
    c = feat[:, :1, :]
    fs = (feat - c) * mask[..., None]
    t = np.arange(T)
    lo, hi = np.maximum(t - window + 1, 0), t + 1
    cs = _cumsum0(fs)
    sums = _gather_t(cs, hi) - _gather_t(cs, lo)
    cnt = _counts(lo, hi, flens, feat.dtype, feat.device)
    sq = None
    if normalize_variance:
        cs2 = _cumsum0(fs * fs)
        sq = _gather_t(cs2, hi) - _gather_t(cs2, lo)
    cnt, sums, sq = _blend_prior(cnt, sums, sq, window, prior, offset=c)
    return _normalize(feat, c, sums, sq, cnt) * mask[..., None]


def _blend_prior(cnt, sums, sq, window, prior, offset=None):
    """Add min(prior_count, window - cnt) worth of the prior statistics.

    ``offset``: where the window sums ran on shifted data x' = x - c, the
    prior's raw (count, sum, sumsq) goes into the same frame: sum' = sum -
    count c, sumsq' = sumsq - 2 c sum + count c^2.  Once the window is full
    (weight 0) every added term is an exact zero, so the with-prior and
    no-prior paths stay bit-identical there.
    """
    if prior is None:
        return cnt, sums, sq
    pc, ps, pss = prior
    dev, dt = cnt.device, cnt.dtype
    pc = torch.as_tensor(pc, dtype=dt, device=dev)
    ps = torch.as_tensor(ps, device=dev).to(dt)
    pss = torch.as_tensor(pss, device=dev).to(dt)
    if offset is not None:
        c = offset
        pss = pss - 2.0 * c * ps + pc * c * c
        ps = ps - pc * c
    w = torch.minimum(torch.clamp(window - cnt, min=0.0), pc)
    scale = torch.where(pc > 0.0, w / torch.clamp(pc, min=1e-30),
                        torch.zeros_like(w))
    cnt = cnt + w
    sums = sums + scale[..., None] * ps
    if sq is not None:
        sq = sq + scale[..., None] * pss
    return cnt, sums, sq


def splice(feat: torch.Tensor, flens: torch.Tensor, left: int = 3,
           right: int = 3) -> torch.Tensor:
    """(B, T, F) -> (B, T, (left+1+right) F) context splicing.

    Frame t's output is [x[t-left], ..., x[t], ..., x[t+right]] with each
    neighbour index clipped to [0, flen-1] of its utterance (edge
    replication at the true ragged boundary, as the delta stage does).
    Padded frames stay zero.
    """
    B, T, F = feat.shape
    t = torch.arange(T, dtype=torch.int64, device=feat.device)
    hi_cap = torch.clamp(flens.to(feat.device, torch.int64), min=1) - 1
    cols = []
    for off in range(-left, right + 1):
        idx = torch.minimum(torch.clamp(t[None, :] + off, min=0),
                            hi_cap[:, None])                     # (B, T)
        cols.append(torch.gather(feat, 1, idx[..., None].expand(B, T, F)))
    out = torch.cat(cols, dim=-1)
    mask = _valid(T, flens, feat.device)
    return torch.where(mask[..., None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def energy_vad(log_energy: torch.Tensor, flens: torch.Tensor,
               threshold: float = 0.0, mean_scale: float = 0.5,
               context: int = 0, proportion: float = 0.6) -> torch.Tensor:
    """(B, T) per-frame log energy + (B,) counts -> (B, T) bool voiced.

    Kaldi compute-vad: a frame's raw decision is log_e > threshold +
    mean_scale * mean(log_e over the utterance) (threshold 0.0 here is
    Kaldi's 5.0 on int16-scaled audio: the [-1, 1] convention's log
    energies sit ~20.8 lower); with context > 0 a frame is voiced iff at
    least ``proportion`` of the in-utterance frames of its +-context window
    pass the raw test.  Padded frames are unvoiced and never vote.
    """
    T = log_energy.shape[1]
    mask = _valid(T, flens, log_energy.device)
    mf = mask.to(log_energy.dtype)
    n = torch.clamp(mf.sum(dim=1), min=1.0)
    mean_e = (log_energy * mf).sum(dim=1) / n
    thr = threshold + mean_scale * mean_e
    raw = (log_energy > thr[:, None]) & mask
    if context <= 0:
        return raw
    votes, _ = _window_sums(raw.to(torch.float32)[..., None], 2 * context + 1)
    in_win, _ = _window_sums(mf[..., None], 2 * context + 1)
    frac = votes[..., 0] / torch.clamp(in_win[..., 0], min=1.0)
    return (frac >= proportion) & mask
