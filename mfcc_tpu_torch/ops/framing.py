"""Pre-emphasis, centred framing and frame energy (twin of
``mfcc_tpu/ops/framing.py``).

Centre mode (Kaldi snip_edges=false) becomes a reflect pad followed by the
exact "valid" pipeline, as in the reference, so every later stage and the
kernel are unchanged by it; a dithered centre-mode signal is dithered
before the pad.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import FeatureConfig
from . import dither as dither_op, xmath


def center_reflect_indices(n: int, cfg: FeatureConfig) -> np.ndarray:
    """(L,) int64 indices into an n-sample signal realizing the centred
    symmetric (edge-duplicating) reflect pad, L = (T-1)*hop + frame_len."""
    T = cfg.num_frames(n)  # center-mode count
    if T == 0:
        return np.zeros((0,), np.int64)
    s = np.arange((T - 1) * cfg.hop_len + cfg.frame_len,
                  dtype=np.int64) - cfg.center_left_pad
    m = np.mod(s, 2 * n)
    return np.minimum(m, 2 * n - 1 - m)


def center_pad_static(x: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(..., N) -> (..., L) centred reflect pad of the whole signal."""
    idx = center_reflect_indices(x.shape[-1], cfg)
    return x[..., torch.from_numpy(idx).to(x.device)]


def center_pad_batch(x: torch.Tensor, lengths: torch.Tensor,
                     cfg: FeatureConfig):
    """Ragged batch centred reflect pad.

    (B, N) rows with true ``lengths`` -> ((B, W) padded rows, (B,) int32
    "valid" lengths L_i whose valid framing emits exactly the centre-mode
    frame count of row i).  Left pad: the first left_pad samples flipped.
    Right pad: the last ceil(frame_len/2) samples of each row flipped and
    written at the row's true end (single-bounce reflection is exact because
    shorter rows emit 0 frames).
    """
    B, N = x.shape
    fl, hop = cfg.frame_len, cfg.hop_len
    P_l, R = cfg.center_left_pad, cfg.center_min_samples
    if N < R:
        # batch narrower than the minimum emitting length: every row has
        # 0 frames, but the tail slice below needs R columns
        x = torch.cat([x, x.new_zeros((B, R - N))], dim=-1)
        N = R
    T_cap = (N + hop // 2) // hop
    W = max((T_cap - 1) * hop + fl, fl, P_l + N + R)
    lengths = lengths.to(device=x.device, dtype=torch.int64)
    left = torch.flip(x[:, :P_l], dims=(-1,))
    padded = torch.cat([left, x, x.new_zeros((B, W - P_l - N))], dim=-1)
    start = torch.clamp(lengths - R, min=0)
    r = torch.arange(R, device=x.device)
    tail = torch.gather(x, 1, start[:, None] + (R - 1 - r)[None, :])
    pos = torch.clamp(P_l + lengths, max=W - R)[:, None] + r[None, :]
    padded = padded.scatter(1, pos, tail)
    T = torch.where(lengths >= R, (lengths + hop // 2) // hop,
                    torch.zeros_like(lengths))
    L = torch.where(T > 0, (T - 1) * hop + fl, torch.zeros_like(T))
    return padded, L.to(torch.int32)


def stft_center_batch(x: torch.Tensor, lengths: torch.Tensor,
                      cfg) -> torch.Tensor:
    """Whisper's input window and STFT centring for a ``WhisperConfig``:
    (B, N) float rows with true ``lengths`` -> (B, L) rows whose "valid"
    frames of n_fft samples at hop_len are ``torch.stft(center=True)``'s
    frames of each row cut or zero-padded to chunk_samples, the last one
    dropped: L = (num_frames - 1) * hop_len + n_fft.

    The pad is n_fft // 2 samples reflected on each side without the edge
    sample (``pad_mode="reflect"``), where Kaldi's centre mode
    (:func:`center_pad_batch`) repeats it and pads frame_len // 2 -
    hop_len // 2; only the first L - n_fft // 2 - chunk_samples samples of
    the right pad are framed.  Samples at or past a row's length read as
    zeros, whatever the caller's padding holds."""
    B, N = x.shape
    P, W = cfg.n_fft // 2, cfg.chunk_samples
    L = (cfg.num_frames() - 1) * cfg.hop_len + cfg.n_fft
    n = min(N, W, L - P)
    out = x.new_empty((B, L))
    t = torch.arange(n, device=x.device)
    lengths = lengths.to(device=x.device)
    torch.where(t < lengths[:, None], x[:, :n], x.new_zeros(()),
                out=out[:, P:P + n])
    out[:, P + n:].zero_()
    out[:, :P] = out[:, P + 1:2 * P + 1].flip(-1)
    R = L - P - W
    if R > 0:
        out[:, P + W:] = out[:, P + W - 1 - R:P + W - 1].flip(-1)
    return out


def nemo_center_batch(x: torch.Tensor, lengths: torch.Tensor,
                      cfg) -> torch.Tensor:
    """NeMo's pre-emphasis and STFT centring for a ``NemoConfig``: (B, N)
    float rows with true ``lengths`` -> (B, W) rows of x's dtype whose
    "valid" frames of frame_len samples at hop_len are the windowed part
    of ``torch.stft(center=True, pad_mode="constant")``'s frames of the
    pre-emphasized rows, W = (T - 1) * hop_len + frame_len, T = 1 + N //
    hop_len (``cfg.num_frames``).

    Row b holds y at [P, P + N) (P = ``cfg.center_offset``) and zeros
    elsewhere: y[0] = x[0], y[n] = x[n] - preemph x[n - 1] in x's dtype
    (float32 from the batch entry, as NeMo and Hugging Face compute it;
    one ``add`` with alpha, which may round once where they round the
    product first), then y[n] = 0 for n >= lengths[b], which also zeroes
    whatever the caller's padding holds.  Frame t of the result starts at
    row sample t hop_len - P, the first sample its window covers.  On x's
    device, with no host sync."""
    B, N = x.shape
    P, T = cfg.center_offset, cfg.num_frames(N)
    W = (T - 1) * cfg.hop_len + cfg.frame_len
    n = min(N, W - P)
    out = x.new_empty((B, W))
    out[:, :P].zero_()
    out[:, P + n:].zero_()
    body = out[:, P:P + n]
    body[:, :1] = x[:, :1]
    if n > 1:
        torch.add(x[:, 1:n], x[:, :n - 1], alpha=-cfg.preemph,
                  out=body[:, 1:])
    t = torch.arange(n, device=x.device)
    body.masked_fill_(t[None, :] >= lengths.to(device=x.device)[:, None], 0.0)
    return out


def resolve_frame_mode(x: torch.Tensor, sample_lengths: torch.Tensor,
                       cfg: FeatureConfig):
    """Batch entry hook: (x', sample_lengths', cfg') with cfg' in "valid"
    mode.  Centre mode dithers the signal first (the reflected samples
    carry reflected noise, the oracle's dither-then-pad order), then
    reflect-pads, and turns dither off in cfg' so that the valid-mode
    pipeline does not add it again."""
    if cfg.frame_mode == "valid":
        return x, sample_lengths, cfg
    x = dither_op.apply(x, cfg)
    xp, L = center_pad_batch(x, sample_lengths, cfg)
    return xp, L, cfg.replace(frame_mode="valid", dither=0.0)


def resolve_frame_mode_static(x: torch.Tensor, cfg: FeatureConfig):
    """Single-utterance twin of resolve_frame_mode."""
    if cfg.frame_mode == "valid":
        return x, cfg
    x = dither_op.apply(x, cfg)
    return center_pad_static(x, cfg), cfg.replace(frame_mode="valid",
                                                  dither=0.0)


def preemphasize(x: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """Whole-signal pre-emphasis y[n] = x[n] - a*x[n-1], y[0] = (1-a)x[0]
    (the HTK x[-1] := x[0] rule, once per row at the signal start)."""
    if cfg.preemph == 0.0:
        return x
    prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    a = torch.tensor(cfg.preemph, dtype=x.dtype, device=x.device)
    return x - a * prev


def frames(y: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(..., N) -> (..., T, frame_len) "valid" frames as a strided view."""
    T = cfg.num_frames(y.shape[-1])
    if T == 0:
        return y.new_zeros((*y.shape[:-1], 0, cfg.frame_len))
    return y.unfold(-1, cfg.frame_len, cfg.hop_len)


def log_energy(fr: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(..., T, frame_len) -> (..., T) floored log frame energy."""
    e = torch.sum(fr * fr, dim=-1)
    return xmath.floored_log(e.to(torch.float32), cfg.log_floor)
