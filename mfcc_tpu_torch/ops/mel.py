"""Mel filterbank projection (twin of ``mfcc_tpu/ops/mel.py``).

The (n_bins, n_mels) triangular filterbank is built in float64 by the
oracle and applied at the precision mode (``backend.matmul``) to the power
in the accumulation dtype (:func:`band_energies`: in float32 one product),
then floored (optional per-frame relative floor, then the absolute floor)
and logged with the accurate log.  Every max keeps a NaN's bits, as XLA's
does (``xmath.xla_max``): a float16 power that overflowed reads as the
reference's value.  Whisper's filterbank, whose triangles are linear in
Hz, is :func:`hz_triangle_matrix`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..config import FeatureConfig
from .. import backend, oracle
from . import xmath


@functools.lru_cache(maxsize=32)
def _mel_matrix_cached(key) -> np.ndarray:
    cfg = FeatureConfig(**dict(key))
    return oracle.mel_filterbank(cfg).T.copy()  # (n_bins, n_mels)


def mel_matrix(cfg: FeatureConfig) -> np.ndarray:
    """(n_bins, n_mels) float64 filterbank, cached per config."""
    return _mel_matrix_cached(tuple(sorted(dataclasses.asdict(cfg).items())))


@functools.lru_cache(maxsize=8)
def hz_triangle_matrix(cfg) -> np.ndarray:
    """(n_bins, n_mels) float64 filterbank of a ``WhisperConfig``: edges
    equally spaced on cfg's mel scale from fmin to fmax, triangles linear
    in Hz between them (librosa's and Hugging Face's ``mel_filter_bank``),
    Slaney's area normalisation 2 / (f[m+2] - f[m]).  The oracle's
    triangles are linear in mel instead."""
    hz = oracle.mel_to_hz(np.linspace(
        oracle.hz_to_mel(cfg.fmin, cfg.mel_scale),
        oracle.hz_to_mel(cfg.fmax, cfg.mel_scale), cfg.n_mels + 2),
        cfg.mel_scale)
    bin_hz = np.arange(cfg.n_bins, dtype=np.float64) * cfg.sample_rate / cfg.n_fft
    lo, ctr, hi = hz[None, :-2], hz[None, 1:-1], hz[None, 2:]
    fb = np.maximum(0.0, np.minimum((bin_hz[:, None] - lo) / (ctr - lo),
                                    (hi - bin_hz[:, None]) / (hi - ctr)))
    return fb * (2.0 / (hz[2:] - hz[:-2]))[None, :]


def relative_floor(cfg: FeatureConfig) -> float:
    """10^(-dynamic_range_db/10), or 0.0 when the range is unlimited."""
    if cfg.dynamic_range_db is None:
        return 0.0
    return 10.0 ** (-cfg.dynamic_range_db / 10.0)


def band_energies(power: torch.Tensor, mat: np.ndarray, cfg: FeatureConfig,
                  precision=None, cast: bool = False) -> torch.Tensor:
    """(..., n_bins) power in the accumulation dtype @ a (n_bins, W)
    float64 band matrix (mel, or PLP's bark) -> (..., W) band energies in
    that dtype, or with ``cast`` in float32 as the floored log reads them,
    at ``precision`` (None: the config's mode).

    In float32 one product over every bin.  In bfloat16 and float16 the
    reference's split-bin form (``mfcc_tpu/ops/mel.py:57-79``,
    ``ops/plp.py:58-67``): the matrix rounded to the accumulation dtype,
    the product over the first n_bins - 1 bins in float32 rounded to it
    (XLA computes a bfloat16 or float16 dot in float32 and rounds its
    result), then the top bin's term added as ``xmath.mul_add`` rounds
    it."""
    acc = power.dtype
    precision = precision or cfg.matmul_precision
    w = backend.constant(mat, acc, power.device)
    if acc == torch.float32:
        return backend.matmul(power, w, precision)
    e = backend.matmul(power[..., :-1].to(torch.float32),
                       w[:-1].to(torch.float32), precision).to(acc)
    return xmath.mul_add(power[..., -1:], w[-1], e, cast)


def log_mel_energies(power: torch.Tensor, cfg: FeatureConfig, *,
                     precision=None) -> torch.Tensor:
    """(..., T, n_bins) power (in the accumulation dtype) -> (..., T,
    n_mels) floored log mel energies, float32; ``precision`` None is the
    config's mode.  The relative floor is the frame's maximum times the
    factor rounded to the accumulation dtype, the product in it, as the
    reference's weak Python float keeps it there."""
    rel = cfg.dynamic_range_db is not None
    # without the relative floor the energies go to the float32 floor
    e = band_energies(power, mel_matrix(cfg), cfg, precision, cast=not rel)
    if rel:
        e = xmath.xla_max(e, xmath.xla_amax(e) * backend.constant(
            np.float64(relative_floor(cfg)), e.dtype, e.device))
    return xmath.floored_log(e, cfg.log_floor)
