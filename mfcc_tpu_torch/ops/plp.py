"""PLP compute stages (Hermansky 1990; twin of ``mfcc_tpu/ops/plp.py``).

The spectral stages are float32 products, at the config's precision mode
(or a ``precision`` given), against float64-built constants:
the critical-band energies with the equal-loudness curve folded into the
bark filterbank, and the autocorrelation as an IDFT matrix product with the
edge-band duplication folded in.  The two short recursions (Levinson-Durbin
and LPC -> cepstra) unroll to ``lpc_order`` / ``n_mfcc`` steps of
elementwise ops over every (B, T) frame at once.

- :func:`bark_loudness` — natural-order power (in the accumulation
  dtype) -> cube-root loudness: the band energies as ``mel.band_energies``
  computes them (in float32 one product over all bins; otherwise the
  reference's split-bin form), the rest float32.
- :func:`autocorrelation`, :func:`levinson`, :func:`lpc_to_cepstra`.
- :func:`plp_from_log_bark` — the tail after the kernel's
  ``projection="bark"`` output: loudness as exp(0.33 * log), then
  :func:`_plp_from_loudness` (autocorrelation, Levinson, cepstra, lifter).
- :func:`plp_from_power` — the whole plain chain from |X|^2.

Numerics as in the reference: the cube root is exp(0.33 * accurate_log),
c0 is the accurate log of the residual energy, and Levinson floors the
energy at 1e-20.  The tail is plain PyTorch, as it is XLA (not Pallas) in
the reference: about 300 small ATen ops a call (``PERF.md``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import FeatureConfig
from .. import backend, oracle
from . import mel, xmath

_CUBE_ROOT = 0.33   # Hermansky's intensity-to-loudness power


@functools.lru_cache(maxsize=32)
def _matrices_cached(key):
    (sample_rate, n_fft, fmin, fmax, n_bark, order) = key
    cfg = FeatureConfig(sample_rate=sample_rate, n_fft=n_fft, fmin=fmin,
                        fmax=fmax, n_bark=n_bark, lpc_order=order)
    fb = oracle.bark_filterbank(cfg)                    # (n_bark, n_bins)
    A = oracle.autocorr_idft_matrix(n_bark + 2, order)  # (n_bark+2, p+1)
    # fold the edge-band duplication into the IDFT matrix: phi = [b0, b,
    # b_last] => r = b @ A2 with A2 = A[1:-1] (+ A[0] into column 0, A[-1]
    # into column -1 of the bark rows)
    A2 = A[1:-1].copy()
    A2[0] += A[0]
    A2[-1] += A[-1]
    return fb, A2


def _plp_matrices(cfg: FeatureConfig):
    """(bark filterbank (n_bark, n_bins), folded IDFT (n_bark, p+1)),
    float64, cached per spectral config."""
    return _matrices_cached((cfg.sample_rate, cfg.n_fft, cfg.fmin, cfg.fmax,
                             cfg.n_bark, cfg.lpc_order))


def bark_matrix(cfg: FeatureConfig) -> np.ndarray:
    """(n_bins, n_bark) float64 bark + equal-loudness projection, the
    orientation of ``mel.mel_matrix``, C-contiguous."""
    return np.ascontiguousarray(_plp_matrices(cfg)[0].T)


def _f32(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def bark_loudness(power: torch.Tensor, cfg: FeatureConfig, *,
                  precision=None) -> torch.Tensor:
    """(..., T, n_bins) natural-order power (in the accumulation dtype)
    -> (..., T, n_bark) float32 cube-root loudness."""
    e = mel.band_energies(power, bark_matrix(cfg), cfg, precision, cast=True)
    return _loudness(xmath.floored_log(e, cfg.log_floor))


def _loudness(log_bark: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.tensor(_CUBE_ROOT, dtype=torch.float32,
                                  device=log_bark.device) * log_bark)


def autocorrelation(loudness: torch.Tensor, cfg: FeatureConfig, *,
                    precision=None) -> torch.Tensor:
    """(..., T, n_bark) loudness -> (..., T, lpc_order+1) autocorrelation
    (edge-band duplication folded into the IDFT matrix)."""
    return backend.matmul(loudness, _f32(_plp_matrices(cfg)[1],
                                         loudness.device),
                          precision or cfg.matmul_precision)


def levinson(r: torch.Tensor, order: int):
    """Batched Levinson-Durbin: (..., order+1) autocorrelation ->
    (a (..., order+1), residual energy e (...,)).  Unrolled; every step is
    elementwise over the leading dims."""
    e = torch.clamp(r[..., 0], min=1e-20)
    a = torch.zeros_like(r)
    a[..., 0] = 1.0
    for i in range(1, order + 1):
        acc = torch.sum(a[..., :i] * torch.flip(r[..., 1: i + 1], (-1,)),
                        dim=-1)
        k = -acc / e
        upd = a[..., 1: i + 1] + k[..., None] * torch.flip(a[..., :i], (-1,))
        a = torch.cat([a[..., :1], upd, a[..., i + 1:]], dim=-1)
        e = torch.clamp(e * (1.0 - k * k), min=1e-20)
    return a, e


def lpc_to_cepstra(a: torch.Tensor, e: torch.Tensor,
                   n_ceps: int) -> torch.Tensor:
    """(..., p+1) LPC + (...,) gain -> (..., n_ceps) model cepstra;
    c0 = accurate log of the residual energy."""
    p = a.shape[-1] - 1
    cols = [xmath.accurate_log(e)]
    for m in range(1, n_ceps):
        s = -a[..., m] if m <= p else torch.zeros_like(e)
        for k in range(1, m):
            if m - k <= p:
                s = s - (k / m) * cols[k] * a[..., m - k]
        cols.append(s)
    return torch.stack(cols, dim=-1)


def plp_from_power(power: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(..., T, n_bins) natural-order power -> (..., T, n_mfcc) PLP
    cepstra (liftered; energy and deltas are the model layer's)."""
    return _plp_from_loudness(bark_loudness(power, cfg), cfg)


def plp_from_log_bark(log_bark: torch.Tensor,
                      cfg: FeatureConfig) -> torch.Tensor:
    """(..., T, n_bark) floored-log band energies (``fused_raw_dit``'s
    ``projection="bark"`` output) -> (..., T, n_mfcc) PLP cepstra."""
    return _plp_from_loudness(_loudness(log_bark), cfg)


def _plp_from_loudness(loud: torch.Tensor,
                       cfg: FeatureConfig) -> torch.Tensor:
    r = autocorrelation(loud, cfg)
    a, e = levinson(r, cfg.lpc_order)
    c = lpc_to_cepstra(a, e, cfg.n_mfcc)
    if cfg.lifter > 0:
        c = c * _f32(oracle.lifter_coeffs(cfg.n_mfcc, cfg.lifter), c.device)
    return c
