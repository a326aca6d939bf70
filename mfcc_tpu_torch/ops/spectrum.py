"""Window-folded real-DFT power spectrum (twin of
``mfcc_tpu/ops/spectrum.py``).

The windowed n_fft-point real DFT of a frame_len-sample frame is two dense
(frame_len, n_bins) products against window-folded cos/sin bases.  The
plain path materializes frames with ``Tensor.unfold`` and runs ONE fp32
matmul against the concatenated [cos | sin] basis: the reference's "no
frame materialization" rule was an XLA-on-TPU measurement and does not
bind here.  The float64 bases are the single source of the DFT constants
for the plain path and the CUDA kernel alike.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import FeatureConfig
from .. import backend, oracle
from . import framing


@functools.lru_cache(maxsize=32)
def _dft_matrices_cached(key) -> tuple[np.ndarray, np.ndarray]:
    frame_len, n_fft, window = key
    n = np.arange(frame_len, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    w = oracle.window_fn(window, frame_len)[:, None]
    return w * np.cos(ang), w * np.sin(ang)


def dft_matrices(cfg: FeatureConfig) -> tuple[np.ndarray, np.ndarray]:
    """(frame_len, n_bins) float64 window-folded cos/sin DFT bases."""
    return _dft_matrices_cached((cfg.frame_len, cfg.n_fft, cfg.window))


def power_spectrum(fr: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(..., T, frame_len) pre-emphasized frames -> (..., T, n_bins) |X|^2
    (fp32 products and accumulation)."""
    cos_m, sin_m = dft_matrices(cfg)
    basis = torch.from_numpy(
        np.concatenate([cos_m, sin_m], axis=1).astype(np.float32)).to(fr.device)
    spec = backend.matmul(fr.to(torch.float32), basis)
    re, im = spec[..., :cfg.n_bins], spec[..., cfg.n_bins:]
    return re * re + im * im


def log_energy_blocked(y: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(..., N) pre-emphasized audio -> (..., T) floored log frame energy."""
    return framing.log_energy(framing.frames(y, cfg), cfg)
