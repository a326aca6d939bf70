"""NVIDIA NeMo's ASR preprocessor (``AudioToMelSpectrogramPreprocessor``
-> ``FilterbankFeatures`` with ``normalize="per_feature"``; Hugging Face
``ParakeetFeatureExtractor``), the log-mel front end of the Parakeet
(FastConformer) and Canary models, batched.

:func:`nemo_log_mel_batch` takes a padded ragged batch and gives every row
``cfg.num_frames(N)`` frames, 1 + N // hop for a batch padded to N
samples, of which a row of L samples has L // hop valid ones.  The stages,
each a span under ``feat.batch``:

- ``feat.cast``: int16 to float32 in [-1, 1) (``models/mfcc``'s cast);
- ``feat.frames``: NeMo's pre-emphasis, zeros from each row's length on,
  and ``torch.stft``'s constant-pad centring of the frame_len-point window
  in n_fft points, in one step of ATen passes (``framing.nemo_center_batch``),
  and the valid frame counts;
- ``feat.spectral``: |X|^2 of the symmetric Hann window's n_fft-point DFT,
  the Hz triangle mel bank, and the log with NeMo's additive guard,
  log(e + 2^-24).  On the card one launch of ``fused_raw`` on NeMo's
  window and bank (:func:`front`), whose power-of-two n_fft takes the
  float64-front FFT tile "fft64" in the guard's mode of its epilogue; on
  a CPU tensor the same chain in plain torch, float32 IEEE products
  (``_spectral.plain_front_features``, which Whisper's front end shares);
- ``feat.mask``: the valid frames' mask;
- ``feat.feature_norm``: each band of each row less its mean over the
  row's valid frames, over their Bessel-corrected standard deviation plus
  ``norm_eps``, and zeros on the frames past them (:func:`normalize`),
  five ATen passes on the device with no host sync.
"""

from __future__ import annotations

import functools

import torch

from .. import backend as backend_lib, oracle
from ..config import NemoConfig
from ..ops import framing, mel as mel_op
from ..ops.kernels import _spectral, fused_raw
from ..utils import report
from .mfcc import _to_float, frame_mask


@functools.lru_cache(maxsize=8)
@report.timed("consts_s")
def front(cfg: NemoConfig) -> _spectral.Front:
    """NeMo's window (``torch.hann_window(frame_len, periodic=False)``,
    the port's symmetric "hann") and bank (the Hz triangles), in float64
    as ``fused_raw`` takes them, with the additive log guard; one a
    config, which the kernels' constant caches key on."""
    return _spectral.Front(oracle.window_fn("hann", cfg.frame_len),
                           mel_op.hz_triangle_matrix(cfg), guard=True)


def log_mel(xp: torch.Tensor, cfg: NemoConfig,
            backend: str = "auto") -> torch.Tensor:
    """(B, W) centred rows (``framing.nemo_center_batch``) -> (B, T,
    n_mels) natural logs of the mel energies under NeMo's guard:
    ``fused_raw`` on NeMo's :func:`front` on a CUDA tensor, else the plain
    chain."""
    kcfg = cfg.feature_config()
    if backend_lib.resolve(backend, xp, kcfg) == "cuda":
        return fused_raw.fused_features_raw(xp.contiguous(), kcfg,
                                            apply_dct=False, front=front(cfg))
    return _spectral.plain_front_features(xp, kcfg, front(cfg))


def normalize(feat: torch.Tensor, mask: torch.Tensor,
              flens: torch.Tensor, eps: float) -> torch.Tensor:
    """NeMo's ``normalize="per_feature"``, in place on (B, T, n_mels)
    logs: over each row's valid frames (``mask``, (B, T) bool; ``flens``,
    (B,) their counts), each band's mean mu and the square root of its
    Bessel-corrected variance sigma; the valid frames become (x - mu) /
    (sigma + eps), the others zeros.

    A row with fewer than two valid frames, where NeMo raises and Hugging
    Face writes NaN, is written as zeros: the counts are taken as at least
    one for the mean and the variance, so that its one frame less its mean
    is an exact 0.  The constants go to the kernels as arguments: no host
    value is read from the device."""
    valid = mask[..., None]
    feat.masked_fill_(~valid, 0.0)
    n = flens.to(feat.dtype)[:, None]
    mean = feat.sum(dim=1).div_(n.clamp(min=1.0))
    feat.addcmul_(valid.to(feat.dtype), mean[:, None, :], value=-1.0)
    sigma = torch.linalg.vector_norm(feat, dim=1).div_(
        (n - 1.0).clamp_(min=1.0).sqrt_()).add_(eps)
    return feat.div_(sigma[:, None, :])


def nemo_log_mel_batch(x: torch.Tensor, sample_lengths: torch.Tensor,
                       cfg: NemoConfig, backend: str = "auto"):
    """(B, N) int16 PCM or float in [-1, 1], (B,) sample lengths ->
    (features (B, T, n_mels) float32, frame counts (B,) int32, mask (B, T)
    bool), T = 1 + N // hop_len and a row's count its length // hop_len.
    Samples past a row's length read as zeros; frames past its count are
    zeros.  NeMo's encoder reads the features' transpose, (B, n_mels, T)."""
    with report.span("feat.batch"):
        x = _to_float(x)
        with report.span("feat.frames"):
            lengths = torch.as_tensor(sample_lengths, device=x.device)
            xp = framing.nemo_center_batch(x, lengths, cfg)
            flens = (lengths // cfg.hop_len).to(torch.int32)
        with report.span("feat.spectral"):
            feat = log_mel(xp, cfg, backend)
            report.count("frames_computed", feat.shape[0] * feat.shape[1])
        with report.span("feat.mask"):
            mask = frame_mask(feat.shape[1], flens)
        with report.span("feat.feature_norm"):
            feat = normalize(feat, mask, flens, cfg.norm_eps)
    return feat, flens, mask
