"""Float64 NumPy oracle: the MFCC, log-mel, spectrogram, PLP, pitch,
dither, corpus CMVN and post-processing slices of ``mfcc_tpu.oracle``.

The port's source of every constant matrix (DFT bases, mel and bark
filterbanks, DCT, lifter, autocorrelation IDFT) and its accuracy reference
on the card.  It is a copy, not an import, because the reference module
imports jax through its package; ``tests/test_torch_ops.py`` holds every
function here equal to its reference twin.  Conventions (framing, HTK
pre-emphasis x[-1] := x[0], symmetric windows, |X|^2 without scaling,
continuous mel triangles, orthonormal DCT-II, regression deltas,
Hermansky's PLP, the NCCF + Viterbi pitch, position-indexed dither, the
Kaldi post chain) are documented on the reference; the ``tests/test_torch_*``
file of each slice holds its twins equal to the reference's.
"""

from __future__ import annotations

import numpy as np

from .config import FeatureConfig


# --------------------------------------------------------------------------
# Building blocks (all float64)
# --------------------------------------------------------------------------

def window_fn(kind: str, n: int) -> np.ndarray:
    """Symmetric analysis window of length n, float64."""
    t = np.arange(n, dtype=np.float64)
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2.0 * np.pi * t / (n - 1))
    if kind == "hann":
        return 0.5 - 0.5 * np.cos(2.0 * np.pi * t / (n - 1))
    if kind == "povey":  # Kaldi's default: hann ** 0.85
        return (0.5 - 0.5 * np.cos(2.0 * np.pi * t / (n - 1))) ** 0.85
    if kind == "rect":
        return np.ones(n, dtype=np.float64)
    raise ValueError(f"unknown window {kind!r}")


def hz_to_mel(f, scale: str = "htk"):
    f = np.asarray(f, dtype=np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    if scale == "slaney":
        f_sp = 200.0 / 3.0
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        return np.where(
            f < min_log_hz, f / f_sp,
            min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep)
    raise ValueError(f"unknown mel scale {scale!r}")


def mel_to_hz(m, scale: str = "htk"):
    m = np.asarray(m, dtype=np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    if scale == "slaney":
        f_sp = 200.0 / 3.0
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        return np.where(
            m < min_log_mel, m * f_sp,
            min_log_hz * np.exp(logstep * (m - min_log_mel)))
    raise ValueError(f"unknown mel scale {scale!r}")


def vtln_warp_freq(f, cfg: FeatureConfig) -> np.ndarray:
    """Piecewise-linear VTLN frequency warp W(f), float64 (three segments
    with knees vtln_low*max(1,a) and vtln_high*min(1,a); band edges
    fixed)."""
    f = np.asarray(f, np.float64)
    a = cfg.vtln_warp
    if a == 1.0:
        return f
    lo, hi = cfg.fmin, cfg.fmax_hz
    l = cfg.vtln_low * max(1.0, a)
    h = cfg.vtln_high_hz * min(1.0, a)
    s = 1.0 / a
    scale_left = (s * l - lo) / (l - lo)
    scale_right = (hi - s * h) / (hi - h)
    w = np.where(f < l, lo + scale_left * (f - lo),
                 np.where(f <= h, s * f, hi + scale_right * (f - hi)))
    return np.where((f < lo) | (f > hi), f, w)


def mel_filterbank(cfg: FeatureConfig) -> np.ndarray:
    """(n_mels, n_bins) triangular filterbank, float64, evaluated at the
    FFT-bin centre frequencies; VTLN warps the filter edges."""
    n_bins = cfg.n_bins
    bin_hz = np.arange(n_bins, dtype=np.float64) * cfg.sample_rate / cfg.n_fft
    bin_mel = hz_to_mel(bin_hz, cfg.mel_scale)
    edges = np.linspace(
        hz_to_mel(cfg.fmin, cfg.mel_scale),
        hz_to_mel(cfg.fmax_hz, cfg.mel_scale),
        cfg.n_mels + 2,
    )
    if cfg.vtln_warp != 1.0:
        edges = hz_to_mel(
            vtln_warp_freq(mel_to_hz(edges, cfg.mel_scale), cfg),
            cfg.mel_scale)
    lo, ctr, hi = edges[:-2], edges[1:-1], edges[2:]
    up = (bin_mel[None, :] - lo[:, None]) / (ctr - lo)[:, None]
    down = (hi[:, None] - bin_mel[None, :]) / (hi - ctr)[:, None]
    fb = np.maximum(0.0, np.minimum(up, down))
    if cfg.mel_scale == "slaney":
        hz_edges = mel_to_hz(edges, "slaney")
        enorm = 2.0 / (hz_edges[2:] - hz_edges[:-2])
        fb = fb * enorm[:, None]
    return fb


def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) orthonormal DCT-II matrix, float64."""
    j = np.arange(n_in, dtype=np.float64)
    i = np.arange(n_out, dtype=np.float64)
    mat = np.cos(np.pi * i[:, None] * (2.0 * j[None, :] + 1.0) / (2.0 * n_in))
    mat *= np.sqrt(2.0 / n_in)
    mat[0] *= 1.0 / np.sqrt(2.0)
    return mat


def lifter_coeffs(n_mfcc: int, lifter: int) -> np.ndarray:
    """Sinusoidal cepstral lifter weights (HTK), float64; ones if lifter==0."""
    if lifter <= 0:
        return np.ones(n_mfcc, dtype=np.float64)
    i = np.arange(n_mfcc, dtype=np.float64)
    return 1.0 + (lifter / 2.0) * np.sin(np.pi * i / lifter)


# --------------------------------------------------------------------------
# Stages
# --------------------------------------------------------------------------

def frame_signal(x: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """(T, frame_len) frames with per-frame pre-emphasis, float64.  The
    predecessor comes from the signal (x[-1] := x[0] at the start); center
    mode reflect-pads first and then frames the padded signal."""
    x = np.asarray(x, dtype=np.float64)
    if cfg.frame_mode == "center":
        T = cfg.num_frames(len(x))
        if T == 0:
            x = x[:0]
        else:
            n = len(x)
            s = np.arange((T - 1) * cfg.hop_len + cfg.frame_len,
                          dtype=np.int64) - cfg.center_left_pad
            m = np.mod(s, 2 * n)
            x = x[np.minimum(m, 2 * n - 1 - m)]
        cfg = cfg.replace(frame_mode="valid")
    T = cfg.num_frames(len(x))
    fl, hop = cfg.frame_len, cfg.hop_len
    out = np.empty((T, fl), dtype=np.float64)
    for t in range(T):
        s = t * hop
        fr = x[s:s + fl].copy()
        if cfg.preemph > 0.0:
            prev = x[s - 1] if s > 0 else x[0]
            fr = fr - cfg.preemph * np.concatenate(([prev], x[s:s + fl - 1]))
        out[t] = fr
    return out


def power_spectrum(frames: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """(T, n_bins) power spectrum |rfft(window * frame, n_fft)|^2."""
    w = window_fn(cfg.window, cfg.frame_len)
    spec = np.fft.rfft(frames * w[None, :], n=cfg.n_fft, axis=-1)
    return (spec.real ** 2 + spec.imag ** 2).astype(np.float64)


def log_mel_energies(power: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """(T, n_mels) log mel filterbank energies."""
    fb = mel_filterbank(cfg)
    energies = power @ fb.T
    floor = np.asarray(cfg.log_floor)
    if cfg.dynamic_range_db is not None:
        rel = energies.max(axis=-1, keepdims=True) * (
            10.0 ** (-cfg.dynamic_range_db / 10.0))
        floor = np.maximum(floor, rel)
    return np.log(np.maximum(energies, floor))


def cepstra(logmel: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """(T, n_mfcc) DCT-II cepstra with optional liftering."""
    dct = dct_matrix(cfg.n_mfcc, cfg.n_mels)
    c = logmel @ dct.T
    return c * lifter_coeffs(cfg.n_mfcc, cfg.lifter)[None, :]


def log_energy(frames: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """(T,) log of total (pre-windowing) frame energy, floored."""
    e = np.sum(frames * frames, axis=-1)
    return np.log(np.maximum(e, cfg.log_floor))


def deltas(feat: np.ndarray, window: int = 2) -> np.ndarray:
    """Regression deltas over time axis 0, edge frames replicated."""
    T = feat.shape[0]
    denom = 2.0 * sum(n * n for n in range(1, window + 1))
    padded = np.concatenate(
        [np.repeat(feat[:1], window, axis=0), feat,
         np.repeat(feat[-1:], window, axis=0)], axis=0)
    out = np.zeros_like(feat)
    for n in range(1, window + 1):
        out += n * (padded[window + n: window + n + T]
                    - padded[window - n: window - n + T])
    return out / denom


# --------------------------------------------------------------------------
# End-to-end
# --------------------------------------------------------------------------

def _dither(x: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """x plus cfg.dither times the float64 noise of positions 0.. (the
    reference's ``oracle._dither``)."""
    if cfg.dither == 0.0:
        return x
    from .ops import dither as dither_op
    return dither_op.apply_np(np.asarray(x, np.float64), cfg)


def _frames(x: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    return frame_signal(_dither(x, cfg), cfg)


def mfcc(x: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """Full float64 MFCC pipeline: (n_samples,) -> (T, n_feats)."""
    frames = _frames(x, cfg)
    if frames.shape[0] == 0:
        return np.zeros((0, cfg.n_feats), dtype=np.float64)
    power = power_spectrum(frames, cfg)
    logmel = log_mel_energies(power, cfg)
    feat = cepstra(logmel, cfg)
    if cfg.append_energy:
        feat[:, 0] = log_energy(frames, cfg)
    if cfg.deltas:
        d1 = deltas(feat, cfg.delta_window)
        d2 = deltas(d1, cfg.delta_window)
        feat = np.concatenate([feat, d1, d2], axis=-1)
    return feat


def log_mel(x: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """Log-mel variant (DCT skipped): (n_samples,) -> (T, n_mels[*3])."""
    frames = _frames(x, cfg)
    if frames.shape[0] == 0:
        n = cfg.n_mels * (3 if cfg.deltas else 1)
        return np.zeros((0, n), dtype=np.float64)
    feat = log_mel_energies(power_spectrum(frames, cfg), cfg)
    if cfg.deltas:
        d1 = deltas(feat, cfg.delta_window)
        d2 = deltas(d1, cfg.delta_window)
        feat = np.concatenate([feat, d1, d2], axis=-1)
    return feat


def log_spectrogram(x: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """Log-power-spectrogram twin of models/spectrogram.py:
    (n_samples,) -> (T, n_bins) floored log power spectra."""
    frames = _frames(x, cfg)
    if frames.shape[0] == 0:
        return np.zeros((0, cfg.n_bins), dtype=np.float64)
    return np.log(np.maximum(power_spectrum(frames, cfg), cfg.log_floor))


# --------------------------------------------------------------------------
# PLP (Hermansky 1990) — conventions documented in docs/conventions.md
# --------------------------------------------------------------------------

def hz_to_bark(f):
    """Hermansky's bark warp: 6 * asinh(f / 600)."""
    f = np.asarray(f, np.float64)
    return 6.0 * np.arcsinh(f / 600.0)


def equal_loudness(f):
    """40 dB equal-loudness weight (Hermansky eq. 4; Makhoul & Cosell)."""
    f2 = np.asarray(f, np.float64) ** 2
    return ((f2 + 56.8e6) * f2 * f2) / ((f2 + 6.3e6) ** 2 * (f2 + 0.38e9))


def bark_filterbank(cfg: FeatureConfig) -> np.ndarray:
    """(n_bark, n_bins) critical-band filterbank, float64, with the
    equal-loudness curve folded into each filter.  Hermansky's piecewise
    masking curve around each center c (d = bark(f) - c):

        10^{ 2.5*(d+0.5)}  for -1.3 <= d <= -0.5
        1                  for -0.5 <  d <   0.5
        10^{-(d-0.5)}      for  0.5 <= d <=  2.5

    Centers are n_bark points evenly spaced in bark strictly inside
    (bark(fmin), bark(fmax)) — the same edge convention as the mel bank.
    """
    n_bins = cfg.n_bins
    bin_hz = np.arange(n_bins, dtype=np.float64) * cfg.sample_rate / cfg.n_fft
    z = hz_to_bark(bin_hz)
    centers = np.linspace(hz_to_bark(cfg.fmin), hz_to_bark(cfg.fmax_hz),
                          cfg.n_bark + 2)[1:-1]
    d = z[None, :] - centers[:, None]
    lo = 10.0 ** (2.5 * (d + 0.5))
    hi = 10.0 ** (-(d - 0.5))
    fb = np.where(d < -0.5, lo, np.where(d > 0.5, hi, 1.0))
    fb = np.where((d < -1.3) | (d > 2.5), 0.0, fb)
    return fb * equal_loudness(bin_hz)[None, :]


def autocorr_idft_matrix(n_bands: int, order: int) -> np.ndarray:
    """(n_bands, order+1) matrix A with r = phi @ A: the inverse DFT of a
    real even spectrum sampled at ``n_bands`` points (duplicated edge
    bands included by the caller), giving autocorrelation lags 0..order:

        r[q] = (1/(2(M-1))) * (phi[0] + (-1)^q phi[M-1]
                               + 2 sum_{j=1}^{M-2} phi[j] cos(pi j q/(M-1)))
    """
    M = n_bands
    j = np.arange(M, dtype=np.float64)[:, None]
    q = np.arange(order + 1, dtype=np.float64)[None, :]
    A = 2.0 * np.cos(np.pi * j * q / (M - 1))
    A[0, :] = 1.0
    A[M - 1, :] = np.cos(np.pi * (M - 1) * q[0] / (M - 1))  # (-1)^q
    return A / (2.0 * (M - 1))


def levinson_np(r: np.ndarray, order: int):
    """Levinson-Durbin over the last axis: (..., order+1) autocorrelation
    -> (a (..., order+1) with a[...,0]=1, residual energy e (...,))."""
    r = np.asarray(r, np.float64)
    a = np.zeros(r.shape[:-1] + (order + 1,), np.float64)
    a[..., 0] = 1.0
    e = np.maximum(r[..., 0].copy(), 1e-20)
    for i in range(1, order + 1):
        acc = np.einsum("...j,...j->...", a[..., :i],
                        r[..., 1: i + 1][..., ::-1])
        k = -acc / e
        a[..., 1: i + 1] = (a[..., 1: i + 1]
                            + k[..., None] * a[..., i - 1:: -1][..., :i])
        e = np.maximum(e * (1.0 - k * k), 1e-20)
    return a, e


def lpc_to_cepstra_np(a: np.ndarray, e: np.ndarray, n_ceps: int) -> np.ndarray:
    """LPC -> real cepstrum of the all-pole model (standard recursion);
    c[0] = log(residual energy)."""
    p = a.shape[-1] - 1
    c = np.zeros(a.shape[:-1] + (n_ceps,), np.float64)
    c[..., 0] = np.log(e)
    for m in range(1, n_ceps):
        s = -a[..., m] if m <= p else 0.0
        for k in range(1, m):
            if m - k <= p:
                s = s - (k / m) * c[..., k] * a[..., m - k]
        c[..., m] = s
    return c


def log_bark(x: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """Floored log bark + equal-loudness band energies: (n_samples,) ->
    (T, n_bark), the float64 reference of ``fused_raw_dit``'s
    ``projection="bark"`` output (PLP's front half, which :func:`plp`
    compresses by a cube root instead of a log)."""
    frames = _frames(x, cfg)
    if frames.shape[0] == 0:
        return np.zeros((0, cfg.n_bark), dtype=np.float64)
    bands = power_spectrum(frames, cfg) @ bark_filterbank(cfg).T
    return np.log(np.maximum(bands, cfg.log_floor))


def plp(x: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """Full float64 PLP pipeline: (n_samples,) -> (T, n_feats).

    Stages: framing/window/power spectrum (shared with MFCC) -> bark
    critical-band energies with equal loudness folded in -> cube-root
    intensity->loudness -> duplicate edge bands -> IDFT autocorrelation
    (lags 0..lpc_order) -> Levinson-Durbin -> LPC-to-cepstra (n_mfcc
    coefficients, c0 = log residual energy) -> optional lifter/deltas.
    """
    frames = _frames(x, cfg)
    if frames.shape[0] == 0:
        return np.zeros((0, cfg.n_feats), dtype=np.float64)
    power = power_spectrum(frames, cfg)
    bands = power @ bark_filterbank(cfg).T              # (T, n_bark)
    loud = np.maximum(bands, cfg.log_floor) ** 0.33
    phi = np.concatenate([loud[:, :1], loud, loud[:, -1:]], axis=-1)
    r = phi @ autocorr_idft_matrix(cfg.n_bark + 2, cfg.lpc_order)
    a, e = levinson_np(r, cfg.lpc_order)
    feat = lpc_to_cepstra_np(a, e, cfg.n_mfcc)
    feat = feat * lifter_coeffs(cfg.n_mfcc, cfg.lifter)[None, :]
    if cfg.append_energy:
        feat[:, 0] = log_energy(frames, cfg)
    if cfg.deltas:
        d1 = deltas(feat, cfg.delta_window)
        d2 = deltas(d1, cfg.delta_window)
        feat = np.concatenate([feat, d1, d2], axis=-1)
    return feat


# --------------------------------------------------------------------------
# Pitch (NCCF + Viterbi, Kaldi-style)
# --------------------------------------------------------------------------

def nccf(xw: np.ndarray, pcfg) -> tuple[np.ndarray, np.ndarray]:
    """Work-rate signal -> (nccf_ballasted, nccf_plain), each (T, n_lags).

    Frame t starts at t*hop_w; numerator(t, L) = sum_j w[j] * w[j+L] over
    the frame_len_w-sample window w at that start.  Denominator is
    sqrt(e0 * eL [+ ballast * mean_e^2]) where e0/eL are the energies of
    the two windows and mean_e is the mean frame energy of the utterance.
    """
    w, hop = pcfg.frame_len_w, pcfg.hop_len_w
    lags = np.arange(pcfg.min_lag, pcfg.max_lag + 1)
    T = 0
    need = w + pcfg.max_lag
    if xw.shape[0] >= need:
        T = 1 + (xw.shape[0] - need) // hop
    num = np.zeros((T, lags.size))
    e_lag = np.zeros((T, lags.size))
    e0 = np.zeros((T,))
    for t in range(T):
        a = xw[t * hop: t * hop + w]
        e0[t] = (a * a).sum()
        for i, L in enumerate(lags):
            b = xw[t * hop + L: t * hop + L + w]
            num[t, i] = (a * b).sum()
            e_lag[t, i] = (b * b).sum()
    mean_e = e0.mean() if T else 0.0
    denom_plain = np.sqrt(np.maximum(e0[:, None] * e_lag, 1e-30))
    denom_ball = np.sqrt(np.maximum(
        e0[:, None] * e_lag + pcfg.ballast * mean_e * mean_e, 1e-30))
    return num / denom_ball, num / denom_plain


def pitch_viterbi(nccf_b: np.ndarray, pcfg) -> np.ndarray:
    """(T, n_lags) ballasted NCCF -> (T,) chosen lag indices.
    Min-sum Viterbi: state cost = -nccf, transition cost =
    penalty * (log lag_i - log lag_j)^2."""
    T, n = nccf_b.shape
    lags = np.arange(pcfg.min_lag, pcfg.max_lag + 1, dtype=np.float64)
    dlog = np.log(lags)[:, None] - np.log(lags)[None, :]
    trans = pcfg.penalty * dlog * dlog          # (from j, to i) symmetric
    cost = -nccf_b[0]
    back = np.zeros((T, n), dtype=np.int64)
    for t in range(1, T):
        tot = cost[:, None] + trans             # (j, i)
        back[t] = np.argmin(tot, axis=0)
        cost = tot[back[t], np.arange(n)] - nccf_b[t]
    path = np.zeros((T,), dtype=np.int64)
    path[-1] = int(np.argmin(cost))
    for t in range(T - 1, 0, -1):
        path[t - 1] = back[t, path[t]]
    return path


def _parabolic_lag(nccf_row: np.ndarray, i: int) -> float:
    """Sub-sample lag refinement around integer argmax i (clamped)."""
    n = nccf_row.shape[0]
    if i == 0 or i == n - 1:
        return 0.0
    ym, y0, yp = nccf_row[i - 1], nccf_row[i], nccf_row[i + 1]
    denom = ym - 2.0 * y0 + yp
    if abs(denom) < 1e-12:
        return 0.0
    d = 0.5 * (ym - yp) / denom
    return float(np.clip(d, -0.5, 0.5))


def pov_feature(c: np.ndarray) -> np.ndarray:
    """Kaldi's NCCF -> POV-feature nonlinearity: 2*((1.0001 - c)^0.15 - 1)."""
    return 2.0 * (np.power(1.0001 - np.clip(c, -1.0, 1.0), 0.15) - 1.0)


def weighted_sliding_mean(v: np.ndarray, wgt: np.ndarray,
                          window: int) -> np.ndarray:
    """Centered wgt-weighted sliding mean of v (edges shrink the window)."""
    T = v.shape[0]
    half = window // 2
    out = np.zeros_like(v)
    for t in range(T):
        lo, hi = max(0, t - half), min(T, t + half + 1)
        ww = wgt[lo:hi]
        sw = ww.sum()
        out[t] = (v[lo:hi] * ww).sum() / sw if sw > 1e-12 else v[t]
    return out


def pitch(x: np.ndarray, pcfg) -> np.ndarray:
    """Full float64 pitch pipeline: (n_samples,) at pcfg.sample_rate ->
    (T, 3) features [pov_feature, normalized log pitch, delta log pitch].
    """
    from .ops.resample import resample_poly_numpy
    xw = (resample_poly_numpy(np.asarray(x, np.float64), pcfg.sample_rate,
                              pcfg.work_rate)
          if pcfg.work_rate != pcfg.sample_rate else np.asarray(x, np.float64))
    nccf_b, nccf_p = nccf(xw, pcfg)
    T = nccf_b.shape[0]
    if T == 0:
        return np.zeros((0, pcfg.n_feats))
    path = pitch_viterbi(nccf_b, pcfg)
    idx = np.arange(T)
    c = nccf_p[idx, path]                       # plain NCCF along the path
    dlag = np.array([_parabolic_lag(nccf_p[t], int(path[t]))
                     for t in range(T)])
    lag = pcfg.min_lag + path + dlag
    log_f0 = np.log(pcfg.work_rate / lag)
    pov = pov_feature(c)
    w = np.clip(c, 0.0, 1.0) ** 2               # POV^2 normalization weight
    norm_log_f0 = log_f0 - weighted_sliding_mean(log_f0, w, pcfg.norm_window)
    d = deltas(log_f0[:, None], pcfg.delta_window)[:, 0]
    return np.stack([pov, norm_log_f0, d], axis=-1)


# --------------------------------------------------------------------------
# Corpus CMVN and the post-processing chain (parallel/cmvn.py, ops/post.py)
# --------------------------------------------------------------------------

def cmvn_stats(feats: list[np.ndarray]):
    """Corpus CMVN statistics (count, sum, sumsq) over a list of (T, F)."""
    count = sum(f.shape[0] for f in feats)
    s = sum(f.sum(axis=0) for f in feats)
    sq = sum((f * f).sum(axis=0) for f in feats)
    return count, s, sq


def apply_cmvn(feat: np.ndarray, count, s, sq, eps: float = 1e-8) -> np.ndarray:
    mean = s / count
    var = np.maximum(sq / count - mean * mean, eps)
    return (feat - mean) / np.sqrt(var)


def sliding_cmvn(feat: np.ndarray, window: int = 600,
                 normalize_variance: bool = False) -> np.ndarray:
    """(T, F) per-frame sliding mean/var normalization, centered window,
    edges shrink (ops/post.sliding_cmvn twin for one utterance)."""
    T = feat.shape[0]
    half = window // 2
    out = np.zeros_like(feat)
    for t in range(T):
        lo, hi = max(0, t - half), min(T, t + half + 1)
        seg = feat[lo:hi]
        mean = seg.mean(axis=0)
        out[t] = feat[t] - mean
        if normalize_variance:
            var = np.maximum((seg * seg).mean(axis=0) - mean * mean, 1e-8)
            out[t] /= np.sqrt(var)
    return out


def online_cmvn(feat: np.ndarray, window: int = 600,
                normalize_variance: bool = False,
                prior=None) -> np.ndarray:
    """(T, F) causal online CMVN (Kaldi apply-cmvn-online): frame t is
    normalized by the statistics of frames [max(0, t - window + 1), t].
    ``prior`` is an optional (count, sum (F,), sumsq (F,)) triple blended
    in with weight min(prior_count, window - cnt) while the window is
    young."""
    T, F = feat.shape
    out = np.zeros_like(feat)
    for t in range(T):
        lo = max(0, t - window + 1)
        seg = feat[lo: t + 1]
        cnt = float(seg.shape[0])
        s = seg.sum(axis=0)
        sq = (seg * seg).sum(axis=0)
        if prior is not None:
            pc, ps, pss = prior
            w = min(float(pc), max(0.0, window - cnt))
            if pc > 0.0 and w > 0.0:
                cnt += w
                s = s + (w / pc) * np.asarray(ps)
                sq = sq + (w / pc) * np.asarray(pss)
        mean = s / cnt
        out[t] = feat[t] - mean
        if normalize_variance:
            var = np.maximum(sq / cnt - mean * mean, 1e-8)
            out[t] /= np.sqrt(var)
    return out


def splice(feat: np.ndarray, left: int = 3, right: int = 3) -> np.ndarray:
    """(T, F) -> (T, (left+1+right)*F) context splice, edge replication."""
    T = feat.shape[0]
    cols = []
    for off in range(-left, right + 1):
        idx = np.clip(np.arange(T) + off, 0, T - 1)
        cols.append(feat[idx])
    return np.concatenate(cols, axis=-1)


def energy_vad(log_e: np.ndarray, threshold: float = 0.0,
               mean_scale: float = 0.5, context: int = 0,
               proportion: float = 0.6) -> np.ndarray:
    """(T,) log energies -> (T,) bool voiced (ops/post.energy_vad twin)."""
    thr = threshold + mean_scale * log_e.mean()
    raw = log_e > thr
    if context <= 0:
        return raw
    T = log_e.shape[0]
    out = np.zeros((T,), bool)
    for t in range(T):
        lo, hi = max(0, t - context), min(T, t + context + 1)
        out[t] = raw[lo:hi].sum() >= proportion * (hi - lo)
    return out
