"""DCT-II cepstral projection with the lifter folded into the matrix
(twin of ``mfcc_tpu/ops/dct.py``)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import FeatureConfig
from .. import backend, oracle


@functools.lru_cache(maxsize=32)
def _dct_matrix_cached(key) -> np.ndarray:
    n_mfcc, n_mels, lifter = key
    mat = oracle.dct_matrix(n_mfcc, n_mels).T  # (n_mels, n_mfcc)
    return (mat * oracle.lifter_coeffs(n_mfcc, lifter)[None, :]).copy()


def dct_matrix(cfg: FeatureConfig) -> np.ndarray:
    """(n_mels, n_mfcc) float64 lifter-folded DCT-II projection."""
    return _dct_matrix_cached((cfg.n_mfcc, cfg.n_mels, cfg.lifter))


def cepstra(logmel: torch.Tensor, cfg: FeatureConfig, *,
            precision=None) -> torch.Tensor:
    """(..., T, n_mels) float32 log-mel -> (..., T, n_mfcc) liftered
    cepstra, a float32 product at ``precision`` (None: the config's mode)
    with the matrix rounded to the accumulation dtype, as the reference
    builds it (``mfcc_tpu/ops/dct.py:43``) and JAX promotes float32 @
    bfloat16 or float16 to float32."""
    mat = backend.constant(dct_matrix(cfg), backend.accum_dtype(cfg),
                           logmel.device).to(torch.float32)
    return backend.matmul(logmel, mat, precision or cfg.matmul_precision)
