"""Rational-ratio polyphase resampling (twin of ``mfcc_tpu/ops/resample.py``).

Upsample by L, Kaiser-windowed-sinc lowpass, downsample by M, laid out as
one GEMM:

    y[b*L + p] = dot(x[b*M + lo : b*M + lo + W], H[:, p])

The float64 filter design and frame bookkeeping are the reference's, copied
as they are (scipy.signal.resample_poly's default filter; len(y) =
ceil(n*L/M)); :func:`resample_poly_numpy` is the float64 oracle.
:func:`resample` is the torch version: frames by ``unfold``, one fp32
product through ``backend.matmul`` (IEEE fp32, no TF32, unless a
``precision`` mode is given).

For small L (16 kHz -> 4 kHz has L = 1) the bank is super-blocked: R
decimation steps per GEMM row, column r*L + p = H[:, p] shifted r*M rows.
Each output is the same dot product plus exact zero terms, and the frame
tensor shrinks by R*W / ((R-1)*M + W) (17.6x at 16 -> 4 kHz), so the
unfold copy stays small: 0.24 ms against 0.98 ms unfolded for a
64 x 10 s batch on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).  Where
L and M are both large (speed perturbation's 0.9 / 1.1 ratios, L = 8,889
and 2,909) the dense bank would be nearly all zeros (71 M entries at 0.9,
~21 taps a column), so :func:`resample` runs its band instead
(:func:`_band`); the reference multiplies the dense bank.
:class:`StreamingResampler` is the host-side chunked twin of
:func:`resample_poly_numpy` that the online pitch tracker
(``models/pitch_online``) feeds, NumPy float64 as in the reference.
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
# a dense bank beyond this many entries (4 MiB of float32) is nearly all
# zeros: resample through its band instead (see _band)
_DENSE_BANK_ENTRIES = 1 << 20


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


@functools.lru_cache(maxsize=32)
def _band(L: int, M: int):
    """(W, lo, off (L, K) int64, G (L, K) float32): the nonzero band of the
    (W, L) polyphase bank, read from the same derivation.  Output phase p
    is the dot of K_p <= K taps G[p, :K_p] with frame rows off[p, :K_p];
    the slots past K_p hold a zero tap on an in-range row.

    At a ratio with L and M both in the thousands (speed perturbation's
    16000 -> 17778 has L = 8,889, M = 8,000) the dense bank is W ~ M + K
    rows by L columns, 71 M entries of which ~21 a column are taps."""
    h = _kaiser_sinc(L, M)
    taps = h.shape[0]
    half = (taps - 1) // 2
    p = np.arange(L)
    rho = (p * M + half) % L
    q = (p * M + half - rho) // L
    Kp = -(-(taps - rho) // L)
    lo = int((q - (Kp - 1)).min())
    W = int(q.max()) - lo + 1
    t = np.arange(int(Kp.max()))[None, :]
    live = t < Kp[:, None]
    off = np.where(live, q[:, None] - t - lo, (q - lo)[:, None])
    G = np.where(live, h[np.minimum(t * L + rho[:, None], taps - 1)], 0.0)
    return (W, lo, torch.from_numpy(off.astype(np.int64)),
            torch.from_numpy(G.astype(np.float32)))


def resample(x: torch.Tensor, sr_in: int, sr_out: int, *,
             precision: str = backend.KEYWORD_PRECISION) -> torch.Tensor:
    """(..., n) float audio at sr_in -> (..., ceil(n*L/M)) float32 at
    sr_out, on x's device.

    One fp32 GEMM against the (super-blocked) dense bank at the mode
    ``precision`` (``backend.matmul``; "highest" by default, as in the
    reference), or, where that bank would exceed ``_DENSE_BANK_ENTRIES``,
    its band: K gathers of the frames, each scaled by one tap a phase and
    summed in tap order (elementwise f32 operations only, so the CPU and
    the card round alike, and no mode applies)."""
    if sr_in == sr_out:
        return x
    L, M = reduce_ratio(sr_in, sr_out)
    W, lo, off, G = _band(L, M)
    band = W * L > _DENSE_BANK_ENTRIES
    if not band:
        L, M, W, H, lo = _bank(L, M, _FOLD_COLUMNS)
    n = x.shape[-1]
    n_out, nb, pad_l, start0, need = _frame_geometry(n, L, M, W, lo)
    if n_out == 0 or n == 0:
        return x.new_zeros((*x.shape[:-1], 0), dtype=torch.float32)
    xp = F.pad(x.to(torch.float32), (pad_l, max(0, need - n)))[..., start0:]
    frames = xp.unfold(-1, W, M)[..., :nb, :]            # (..., nb, W)
    if band:
        off, G = off.to(x.device), G.to(x.device)
        y = frames[..., off[:, 0]] * G[:, 0]             # (..., nb, L)
        for k in range(1, off.shape[1]):
            y = y + frames[..., off[:, k]] * G[:, k]
    else:
        y = backend.matmul(frames, H.to(x.device), precision)
    return y.reshape(*x.shape[:-1], nb * L)[..., :n_out]


class StreamingResampler:
    """Host-side chunked twin of :func:`resample_poly_numpy` (the
    reference's ``StreamingResampler``, copied as it is).

    Output block b (L samples) needs raw samples [b*M + lo, b*M + lo + W),
    so a block is emitted once its whole input window has arrived;
    :meth:`flush` zero-pads the tail (the batch edge convention) and emits
    the rest, so that the concatenation of every output equals
    ``resample_poly_numpy(whole_signal)`` to float64 round-off (the
    product's blocking follows the emitted block count).
    """

    def __init__(self, sr_in: int, sr_out: int):
        if sr_in == sr_out:
            raise ValueError("no-op resampler; stream the samples directly")
        self.L, self.M = reduce_ratio(sr_in, sr_out)
        self.H, lo = _polyphase_matrix(self.L, self.M)
        self.W = self.H.shape[0]
        self.pad_l = max(0, -lo)
        self.start0 = lo + self.pad_l       # first frame offset into xp
        # xp = [pad_l zeros | raw]; keep only the suffix still needed
        self._buf = np.zeros((self.pad_l,), np.float64)
        self._buf_start = 0                 # xp index of _buf[0]
        self._n_raw = 0                     # raw samples received
        self._blocks_done = 0
        self._flushed = False

    def feed(self, chunk: np.ndarray) -> np.ndarray:
        """Raw samples in -> every newly complete output sample out."""
        if self._flushed:
            raise RuntimeError("feed after flush")
        self._buf = np.concatenate(
            [self._buf, np.asarray(chunk, np.float64)])
        self._n_raw += len(chunk)
        xp_len = self.pad_l + self._n_raw
        # blocks b with b*M + start0 + W <= xp_len are complete
        nb_ready = max((xp_len - self.start0 - self.W) // self.M + 1, 0)
        return self._emit(nb_ready)

    def flush(self) -> np.ndarray:
        """Zero-pad the tail and emit the remaining output samples, so that
        the total output length is ceil(n_raw * L / M)."""
        if self._flushed:
            raise RuntimeError("flush after flush")
        self._flushed = True
        n_out, nb, _pad_l, start0, need = _frame_geometry(
            self._n_raw, self.L, self.M, self.W, self.start0 - self.pad_l)
        xp_len = self.pad_l + self._n_raw
        self._buf = np.concatenate(
            [self._buf, np.zeros((max(0, need + self.pad_l - xp_len),))])
        return self._emit(nb)

    def _emit(self, nb_ready: int) -> np.ndarray:
        bs = np.arange(self._blocks_done, nb_ready)
        if bs.size == 0:
            return np.zeros((0,), np.float64)
        idx = (bs * self.M + self.start0 - self._buf_start)[:, None] \
            + np.arange(self.W)[None, :]
        y = (self._buf[idx] @ self.H).reshape(-1)
        self._blocks_done = nb_ready
        if self._flushed:   # trim the last block to the exact length
            n_out = -(-self._n_raw * self.L // self.M)
            y = y[: n_out - (bs[0] * self.L)]
        # drop the buffer prefix no later block can reach
        keep_from = nb_ready * self.M + min(self.start0, 0)
        drop = min(max(keep_from - self._buf_start, 0), self._buf.shape[0])
        self._buf = self._buf[drop:]
        self._buf_start += drop
        return y
