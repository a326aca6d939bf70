"""Rational-ratio polyphase resampling (twin of ``mfcc_tpu/ops/resample.py``).

Upsample by L, Kaiser-windowed-sinc lowpass, downsample by M, laid out as
one GEMM:

    y[b*L + p] = dot(x[b*M + lo : b*M + lo + W], H[:, p])

The float64 filter design and frame bookkeeping are the reference's, copied
as they are (scipy.signal.resample_poly's default filter; len(y) =
ceil(n*L/M)); :func:`resample_poly_numpy` is the float64 oracle.
:func:`resample` is the torch version: frames by ``unfold``, one fp32
product through ``backend.matmul`` (IEEE fp32, no TF32).

For small L (16 kHz -> 4 kHz has L = 1) the bank is super-blocked: R
decimation steps per GEMM row, column r*L + p = H[:, p] shifted r*M rows.
Each output is the same dot product plus exact zero terms, and the frame
tensor shrinks by R*W / ((R-1)*M + W) (17.6x at 16 -> 4 kHz), so the
unfold copy stays small: 0.24 ms against 0.98 ms unfolded for a
64 x 10 s batch on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).  The
streaming resampler is not ported yet (ROADMAP.md, modules to port,
item 7).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import backend

# super-block the polyphase bank to at least this many GEMM columns
_FOLD_COLUMNS = 128


def reduce_ratio(sr_in: int, sr_out: int) -> tuple[int, int]:
    """(L, M) in lowest terms with sr_out = sr_in * L / M."""
    g = math.gcd(int(sr_in), int(sr_out))
    return int(sr_out) // g, int(sr_in) // g


def resampled_length(n: int, sr_in: int, sr_out: int) -> int:
    """Output sample count: ceil(n * L / M) (scipy convention)."""
    L, M = reduce_ratio(sr_in, sr_out)
    return -(-n * L // M)


@functools.lru_cache(maxsize=32)
def _kaiser_sinc(L: int, M: int) -> np.ndarray:
    """Float64 anti-alias/interpolation FIR, scipy-compatible design:
    half length 10*max(L, M), Kaiser beta 5.0, cutoff 1/max(L, M) of the
    upsampled Nyquist, normalized to DC gain 1 then scaled by L."""
    max_lm = max(L, M)
    half = 10 * max_lm
    taps = 2 * half + 1
    m = np.arange(taps, dtype=np.float64) - half
    fc = 1.0 / max_lm
    h = fc * np.sinc(fc * m) * np.kaiser(taps, 5.0)
    return h * (L / h.sum())


@functools.lru_cache(maxsize=32)
def _polyphase_matrix(L: int, M: int) -> tuple[np.ndarray, int]:
    """(H (W, L) float64, lo): y[b*L + p] = dot(x[b*M+lo : b*M+lo+W], H[:, p]).
    The derivation is on the reference function."""
    h = _kaiser_sinc(L, M)
    taps = h.shape[0]
    half = (taps - 1) // 2
    p = np.arange(L)
    rho = (p * M + half) % L
    q = (p * M + half - rho) // L
    K = -(-(taps - rho) // L)
    lo = int((q - (K - 1)).min())
    W = int(q.max()) - lo + 1
    H = np.zeros((W, L), np.float64)
    for pp in range(L):
        t = np.arange(K[pp])
        H[q[pp] - t - lo, pp] = h[t * L + rho[pp]]
    return H, lo


def _frame_geometry(n: int, L: int, M: int, W: int, lo: int):
    """Output/block counts and edge pads (shared by both versions)."""
    n_out = -(-n * L // M)
    nb = -(-n_out // L)                      # output blocks of L samples
    pad_l = max(0, -lo)
    start0 = lo + pad_l                      # first frame offset into xp
    need = (nb - 1) * M + start0 + W         # past-the-end input index
    return n_out, nb, pad_l, start0, need


def resample_poly_numpy(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Float64 host twin (the oracle's resampler).  1-D input."""
    if sr_in == sr_out:
        return np.asarray(x, np.float64).copy()
    L, M = reduce_ratio(sr_in, sr_out)
    H, lo = _polyphase_matrix(L, M)
    W = H.shape[0]
    n = x.shape[-1]
    n_out, nb, pad_l, start0, need = _frame_geometry(n, L, M, W, lo)
    if n_out == 0 or n == 0:
        return np.zeros((0,), np.float64)
    xp = np.pad(np.asarray(x, np.float64), (pad_l, max(0, need - n)))
    idx = (np.arange(nb) * M + start0)[:, None] + np.arange(W)[None, :]
    return (xp[idx] @ H).reshape(-1)[:n_out]


@functools.lru_cache(maxsize=32)
def _bank(L: int, M: int, fold_columns: int):
    """(L', M', W', H' float32, lo): the polyphase bank super-blocked by
    R = ceil(fold_columns / L) decimation steps (R = 1: the bank as is)."""
    H, lo = _polyphase_matrix(L, M)
    W = H.shape[0]
    R = max(1, -(-fold_columns // L))
    if R > 1:
        W2 = (R - 1) * M + W
        H2 = np.zeros((W2, R * L), H.dtype)
        for r in range(R):
            H2[r * M: r * M + W, r * L: (r + 1) * L] = H
        L, M, W, H = R * L, R * M, W2, H2
    return L, M, W, torch.from_numpy(H.astype(np.float32)), lo


def resample(x: torch.Tensor, sr_in: int, sr_out: int) -> torch.Tensor:
    """(..., n) float audio at sr_in -> (..., ceil(n*L/M)) float32 at
    sr_out, on x's device."""
    if sr_in == sr_out:
        return x
    L, M, W, H, lo = _bank(*reduce_ratio(sr_in, sr_out), _FOLD_COLUMNS)
    n = x.shape[-1]
    n_out, nb, pad_l, start0, need = _frame_geometry(n, L, M, W, lo)
    if n_out == 0 or n == 0:
        return x.new_zeros((*x.shape[:-1], 0), dtype=torch.float32)
    xp = F.pad(x.to(torch.float32), (pad_l, max(0, need - n)))[..., start0:]
    frames = xp.unfold(-1, W, M)[..., :nb, :]            # (..., nb, W)
    y = backend.matmul(frames, H.to(x.device))           # (..., nb, L)
    return y.reshape(*x.shape[:-1], nb * L)[..., :n_out]
