"""Pitch model (twin of ``mfcc_tpu/models/pitch.py``): the NCCF + Viterbi
tracker giving Kaldi-style 3-dim features [pov_feature,
POV-weighted-mean-normalized log pitch, delta log pitch], plus a raw Hz
track.

Batched like ``models/mfcc.py``: padded frames are computed, then zeroed.
On a CUDA tensor the NCCF and the Viterbi pass each run as one launch of a
hand-written kernel (``ops/kernels/fused_nccf``, ``fused_viterbi``).
Pitch frames use "valid" framing at the work rate over the frame+max_lag
NCCF span, so a pitch track runs ~2 frames short of the 25/10 ms MFCC
track of the same signal; :func:`align_pitch` aligns them.
"""

from __future__ import annotations

import torch

from ..config import PitchConfig
from ..ops import pitch as pitch_op


def _to_float(x: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> [-1, 1) float32 on x's device (half the host-to-device
    bytes); float input as it is."""
    if x.dtype == torch.int16:
        return x.to(torch.float32) * (1.0 / 32768.0)
    return x


def pitch(x: torch.Tensor, pcfg: PitchConfig,
          backend: str = "auto") -> torch.Tensor:
    """(n_samples,) PCM in [-1, 1] -> (T, 3) pitch features."""
    feat, _, _ = pitch_op.pitch_features(
        x[None, :], torch.tensor([x.shape[0]], dtype=torch.int32,
                                 device=x.device), pcfg, backend=backend)
    return feat[0]


def pitch_batch(x: torch.Tensor, sample_lengths: torch.Tensor,
                pcfg: PitchConfig, backend: str = "auto"):
    """(B, N_pad), (B,) -> ((B, T, 3), (B,) int32 frame counts, (B, T) bool
    mask).

    x may be int16 PCM (cast on the device) or float in [-1, 1]; it must
    be zero past each utterance's true length (zero padding commutes with
    the resampler's own zero-padded edges, so a padded row matches
    ``oracle.pitch`` of the utterance on the valid region).
    """
    return pitch_op.pitch_features(_to_float(x), sample_lengths, pcfg,
                                   backend=backend)


def pitch_track_batch(x: torch.Tensor, sample_lengths: torch.Tensor,
                      pcfg: PitchConfig, backend: str = "auto"):
    """(B, N_pad), (B,) -> ((B, T) f0 Hz, (B, T) NCCF voicing, mask)."""
    return pitch_op.pitch_track(_to_float(x), sample_lengths, pcfg,
                                backend=backend)


def align_pitch(feat_p: torch.Tensor, flens_p: torch.Tensor,
                T: int) -> torch.Tensor:
    """(B, Tp, F) pitch features + (B,) true pitch frame counts ->
    (B, T, F) aligned to a T-frame main feature track.

    Both tracks share the hop; missing tail frames are edge-replicated
    (out[t] = feat_p[min(t, last valid frame)], Kaldi's paste-feats
    convention).  Utterances with zero pitch frames get zeros.  A gather,
    so every value is copied exactly.
    """
    B, Tp, F = feat_p.shape
    if Tp == 0:
        return feat_p.new_zeros((B, T, F))
    last = torch.clamp(flens_p.to(torch.int64) - 1, min=0)        # (B,)
    t = torch.arange(T, device=feat_p.device)
    idx = torch.minimum(t[None, :], last[:, None])                 # (B, T)
    out = torch.gather(feat_p, 1, idx[..., None].expand(B, T, F))
    return torch.where(flens_p[:, None, None] > 0, out, 0.0)
