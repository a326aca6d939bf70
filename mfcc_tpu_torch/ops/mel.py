"""Mel filterbank projection (twin of ``mfcc_tpu/ops/mel.py``).

The (n_bins, n_mels) triangular filterbank is built in float64 by the
oracle and applied as one float32 product at the precision mode
(``backend.matmul``; float32 operands whatever the compute dtype, as the
reference's ``accum_dtype`` filterbank), then floored (optional per-frame
relative floor, then the absolute floor) and logged with the accurate log.
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


def relative_floor(cfg: FeatureConfig) -> float:
    """10^(-dynamic_range_db/10), or 0.0 when the range is unlimited."""
    if cfg.dynamic_range_db is None:
        return 0.0
    return 10.0 ** (-cfg.dynamic_range_db / 10.0)


def log_mel_energies(power: torch.Tensor, cfg: FeatureConfig, *,
                     precision=None) -> torch.Tensor:
    """(..., T, n_bins) power -> (..., T, n_mels) floored log mel energies;
    ``precision`` None is the config's mode."""
    fb = torch.from_numpy(mel_matrix(cfg).astype(np.float32)).to(power.device)
    e = backend.matmul(power, fb, precision or cfg.matmul_precision)
    if cfg.dynamic_range_db is not None:
        rel = torch.amax(e, dim=-1, keepdim=True) * torch.tensor(
            relative_floor(cfg), dtype=torch.float32, device=e.device)
        e = torch.maximum(e, rel)
    return xmath.floored_log(e, cfg.log_floor)
