"""The flagship MFCC pipeline (twin of ``mfcc_tpu/models/mfcc.py``).

- :func:`mfcc` — one utterance: (N,) -> (T, n_feats).
- :func:`mfcc_batch` — padded ragged batch plus per-utterance sample
  lengths -> (features, true frame counts, frame validity mask).  Padded
  frames are computed, then zeroed, so masked reductions stay exact.
- :func:`mfcc_batch_packed` — several utterances a row at hop-aligned
  offsets (``utils/batch.pack_rows``), for the four feature families.
- :func:`mfcc_long` — one long signal (an API twin; no row blocking here).

On a CUDA tensor the spectral chain is one launch of a hand-written kernel,
picked by the reference's route (``ops/kernels/routes.py``): cepstra and
log-mel bounded to <= 50 dB go to ``fused_raw_dit``, other log-mel to
``fused_raw``, and what neither raw kernel takes is pre-emphasized on the
host and goes to ``fused_dit`` or ``fused_mfcc``.  Deltas run after it.
On a CPU tensor the chain is the plain direct form, and so it is on the
card under ``matmul_precision="high"`` (``backend.resolve``: the
reference's kernels cannot take that mode, so it runs XLA).  The
reference's > 4096-frame blocked route is not ported: it works around a
TPU relayout fault, and a long row goes straight through the kernel.
Dither is position-indexed noise added to the audio once, before the
spectral chain (``ops/dither``).
"""

from __future__ import annotations

import torch

from ..config import FeatureConfig
from .. import backend as backend_lib
from ..ops import deltas as deltas_op, dither as dither_op, framing
from ..ops.kernels import (fused_dit, fused_mfcc, fused_raw, fused_raw_dit,
                           routes)
from ..utils import report


def _spectral_features(xb: torch.Tensor, cfg: FeatureConfig,
                       apply_dct: bool, backend: str) -> torch.Tensor:
    """(B, N) valid-mode float32 audio -> (B, T, n_mfcc or n_mels)."""
    if backend_lib.resolve(backend, xb, cfg) != "cuda":
        return fused_raw_dit.plain_features(xb, cfg, apply_dct)
    route = routes.spectral_route(cfg, apply_dct)
    if route == "fused_raw_dit":
        return fused_raw_dit.fused_features_raw_dit(xb, cfg,
                                                    apply_dct=apply_dct)
    if route == "fused_raw":
        return fused_raw.fused_features_raw(xb, cfg, apply_dct=apply_dct)
    yb = framing.preemphasize(xb, cfg)
    if route == "fused_dit":
        return fused_dit.fused_features_dit(yb, cfg, apply_dct=apply_dct)
    return fused_mfcc.fused_features(yb, cfg, apply_dct=apply_dct)


def _features_from_audio(x: torch.Tensor, cfg: FeatureConfig,
                         lengths: torch.Tensor | None = None,
                         backend: str = "auto",
                         apply_dct: bool = True) -> torch.Tensor:
    """(B, N) or (N,) valid-mode audio -> features (deltas appended).

    Dither (``cfg.dither``) is added here, once, to the valid-mode audio
    the kernels receive (``mfcc_tpu/models/mfcc.py:57-60``).  In centre
    mode ``framing.resolve_frame_mode`` has already dithered the signal
    before its reflect pad and turned dither off, as the reference does
    (``mfcc_tpu/ops/framing.py:106-130``)."""
    squeeze = x.dim() == 1
    with report.span("feat.spectral"):
        xb = (x[None, :] if squeeze else x).to(torch.float32).contiguous()
        xb = dither_op.apply(xb, cfg)
        feat = _spectral_features(xb, cfg, apply_dct, backend)
        report.count("frames_computed", feat.shape[0] * feat.shape[1])
    if squeeze:
        feat = feat[0]
    if cfg.deltas:
        with report.span("feat.deltas"):
            feat = deltas_op.append_deltas(feat, cfg, lengths, backend)
    return feat


def mfcc(x: torch.Tensor, cfg: FeatureConfig,
         backend: str = "auto") -> torch.Tensor:
    """(n_samples,) PCM in [-1, 1] -> (T, n_feats) features."""
    backend_lib.check_config(cfg)
    x, cfg = framing.resolve_frame_mode_static(x, cfg)
    return _features_from_audio(x, cfg, backend=backend)


def frame_lengths(sample_lengths: torch.Tensor,
                  cfg: FeatureConfig) -> torch.Tensor:
    """Per-utterance true frame counts (tensor twin of
    FeatureConfig.num_frames), int32."""
    n = sample_lengths.to(torch.int64)
    if cfg.frame_mode == "center":
        t = (n + cfg.hop_len // 2) // cfg.hop_len
        t = torch.where(n >= cfg.center_min_samples, t, torch.zeros_like(t))
        return t.to(torch.int32)
    t = torch.div(n - cfg.frame_len, cfg.hop_len, rounding_mode="floor") + 1
    return torch.clamp(t, min=0).to(torch.int32)


def frame_mask(T: int, flens: torch.Tensor) -> torch.Tensor:
    """(B, T) bool validity mask from (B,) frame counts."""
    t = torch.arange(T, dtype=torch.int32, device=flens.device)
    return t[None, :] < flens[:, None]


def _to_float(x: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> float32 in [-1, 1) on x's device (span ``feat.cast``);
    float input as it is."""
    if x.dtype != torch.int16:
        return x
    with report.span("feat.cast"):
        return x.to(torch.float32) * (1.0 / 32768.0)


def run_batch(x: torch.Tensor, sample_lengths: torch.Tensor,
              cfg: FeatureConfig, features):
    """The batch entry of every model (MFCC, log-mel, PLP, spectrogram):
    int16 cast, centre mode, frame counts, then ``features(x, cfg,
    flens)`` on the valid-mode batch, mask and zeroing.  Under a profiler
    the call is span ``feat.batch`` over ``feat.cast``, ``feat.frames``,
    the features' own spans (``feat.spectral``, ``feat.deltas``) and
    ``feat.mask``."""
    with report.span("feat.batch"):
        backend_lib.check_config(cfg)
        x = _to_float(x)
        with report.span("feat.frames"):
            sample_lengths = torch.as_tensor(sample_lengths, device=x.device)
            x, sample_lengths, cfg = framing.resolve_frame_mode(
                x, sample_lengths, cfg)
            flens = frame_lengths(sample_lengths, cfg)
        feat = features(x, cfg, flens)
        with report.span("feat.mask"):
            mask = frame_mask(feat.shape[-2], flens)
            feat = torch.where(mask[..., None], feat, torch.zeros(
                (), dtype=feat.dtype, device=feat.device))
    return feat, flens, mask


def features_batch(x: torch.Tensor, sample_lengths: torch.Tensor,
                   cfg: FeatureConfig, backend: str = "auto",
                   apply_dct: bool = True):
    """The batch entry of :func:`mfcc_batch` and ``logmel.log_mel_batch``."""
    return run_batch(x, sample_lengths, cfg, lambda xv, c, flens: (
        _features_from_audio(xv, c, lengths=flens if c.deltas else None,
                             backend=backend, apply_dct=apply_dct)))


def mfcc_batch(x: torch.Tensor, sample_lengths: torch.Tensor,
               cfg: FeatureConfig, backend: str = "auto"):
    """(B, N_pad), (B,) -> ((B, T, n_feats), (B,) int32 frame counts,
    (B, T) bool mask).

    x may be int16 PCM (cast to [-1, 1) on the device — half the
    host-to-device bytes) or float in [-1, 1].
    """
    return features_batch(x, sample_lengths, cfg, backend)


PACKED_FAMILIES = ("mfcc", "logmel", "plp", "spec")


def mfcc_batch_packed(x: torch.Tensor, seg_starts: torch.Tensor,
                      seg_lens: torch.Tensor, cfg: FeatureConfig,
                      backend: str = "auto", apply_dct: bool = True,
                      family: str | None = None):
    """Packed ragged batch (``utils/batch.pack_rows``): several utterances
    a row at hop-aligned offsets, so a row's slack carries audio instead of
    zeros.

    x: (B, C) packed rows, int16 PCM or float in [-1, 1];
    seg_starts / seg_lens: (B, S) each segment's hop-aligned sample offset
    and true length (length 0 = an empty slot).  family: "mfcc" (default
    with apply_dct), "logmel" (default without), "plp" or "spec".
    Returns (feat (B, T, n_out), seg_frame_starts (B, S) int32,
    seg_frame_counts (B, S) int32, mask (B, T) bool): segment j of row b
    owns feature rows [seg_frame_starts[b, j], + seg_frame_counts[b, j]).
    Frames outside every segment (about two at each boundary) are zeroed.

    What a segment equals, by device:

    - on the CPU (the plain chain), the standalone computation of that
      utterance bit for bit: hop alignment gives every frame the same
      samples and the same reductions, and the packer's one-sample gap
      holds the segment's pre-emphasis predecessor;
    - on the card, the standalone kernel result within the kernel-vs-plain
      bounds (cepstra 2e-5; log-mel and log bark energies rtol 1e-4 plus
      atol 2e-5; the spectrogram 2e-4 inside its 50 dB window), and the
      float64 oracle at its tolerances.  Not bit for bit: the FFT tile
      transforms two real frames in one complex FFT, and a segment that
      starts at an odd frame of its row gets other partners than it has
      alone, so its rounding differs.

    Raises, as the reference does: ``cfg.deltas`` (the delta recursion
    would leak across segment boundaries: apply deltas per utterance after
    splitting) and ``frame_mode="center"``.  Dither is positional within
    the packed row, so a dithered packed run draws other noise than a
    dithered standalone run.  The reference's > 4096-frame blocked route
    is not ported (a TPU relayout workaround).
    """
    if family is None:
        family = "mfcc" if apply_dct else "logmel"
    if family not in PACKED_FAMILIES:
        raise ValueError(f"unknown packed family {family!r}")
    if cfg.deltas:
        raise ValueError("packed batches: apply deltas per utterance "
                         "after splitting (the delta recursion would leak "
                         "across segment boundaries)")
    if cfg.frame_mode != "valid":
        raise ValueError("packed batches support frame_mode='valid' only")
    with report.span("feat.batch"):
        backend_lib.check_config(cfg)
        x = _to_float(x)
        if family == "spec":
            from . import spectrogram
            feat = spectrogram.log_spectrogram(x, cfg, backend)
        elif family == "plp":
            from . import plp
            feat = plp._plp_from_audio(x, cfg, backend=backend)
        else:
            feat = _features_from_audio(x, cfg, backend=backend,
                                        apply_dct=family == "mfcc")
        T = feat.shape[-2]
        with report.span("feat.frames"):
            seg_starts = torch.as_tensor(seg_starts, device=x.device)
            seg_lens = torch.as_tensor(seg_lens, device=x.device)
            f0 = torch.div(seg_starts.to(torch.int64), cfg.hop_len,
                           rounding_mode="floor").to(torch.int32)
            fc = frame_lengths(seg_lens, cfg) * (seg_lens > 0)
        with report.span("feat.mask"):
            t = torch.arange(T, dtype=torch.int32, device=x.device)
            inside = ((t >= f0[..., None])
                      & (t < (f0 + fc)[..., None]))  # (B, S, T)
            mask = inside.any(dim=1)
            feat = torch.where(mask[..., None], feat, torch.zeros(
                (), dtype=feat.dtype, device=feat.device))
    return feat, f0, fc, mask


def mfcc_long(x: torch.Tensor, cfg: FeatureConfig, backend: str = "auto",
              row_frames: int = 511, apply_dct: bool = True) -> torch.Tensor:
    """(N,) one long signal, int16 PCM or float -> (T, n_feats).

    The reference re-views a long signal as overlapping rows of
    ``row_frames`` frames because a single long row is its TPU kernel
    wrapper's worst shape.  The H100 path has no such fault and does not
    block rows: this is one straight call of the unblocked path, so it
    equals :func:`mfcc` bit for bit (centre mode resolved first, dither
    over the whole signal, deltas after).  ``row_frames`` is taken and
    checked (a positive int) so that callers of the reference's API run
    unchanged; it has one default, 511 (the reference's ``mfcc_long``
    default; its ``mfcc_long_jit`` defaults to 1024).
    """
    if (not isinstance(row_frames, int) or isinstance(row_frames, bool)
            or row_frames < 1):
        raise ValueError(f"row_frames must be a positive int, got "
                         f"{row_frames!r}")
    if x.dim() != 1:
        raise ValueError(f"one signal (N,) expected, got {tuple(x.shape)}")
    backend_lib.check_config(cfg)
    x, cfg = framing.resolve_frame_mode_static(_to_float(x), cfg)
    return _features_from_audio(x, cfg, backend=backend, apply_dct=apply_dct)
