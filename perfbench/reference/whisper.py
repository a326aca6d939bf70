"""Plain reference of Whisper's log-mel front end, batched.

Whisper's published formula (openai ``whisper/audio.py``
``log_mel_spectrogram``; Hugging Face ``WhisperFeatureExtractor``), restated
here, not imported: each row's first ``min(length, chunk)`` samples, zeros
to the 30 s window (``pad_or_trim``), ``torch.stft`` with the periodic
Hann window of n_fft points, ``center=True`` and ``pad_mode="reflect"``
(n_fft // 2 on each side, the edge sample once), the last frame dropped,
|X|^2 of the n_fft // 2 + 1 bins, the Slaney-scale filterbank whose
triangles are linear in Hz with Slaney's area normalisation (built here in
float64 numpy), log10 floored at ``log_floor``, the floor ``FLOOR_DB`` /
10 under the row's largest value over all its frames and bands, then (x
+ 4) / 4.  Every row has chunk // hop frames, all valid.

Departures from the sources:

- the largest value is each row's own, as Hugging Face's batched
  extractor takes it; openai's ``transcribe`` takes it over the whole
  padded recording before cutting it into windows;
- float64, where both sources compute in float32.

Two precisions, as ``features.py``:

- ``"float64"``: the reference, on ``torch.stft``;
- ``"tf32"``: the control, one step below the configuration's IEEE
  float32: the same frames (the reflect pad, then ``unfold``), the DFT as a
  product with the window folded into its basis, every product's operands
  rounded to TF32's 10-bit mantissa with float32 sums, everything else in
  float32.

Rows are processed in blocks to keep memory bounded.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .features import PRECISIONS, round_tf32

# float64 bytes of the (rows, bins, frames) complex STFT a block may take
BLOCK_BYTES = 1 << 29
# the settings that name steps of other front ends, at the values that turn
# them off, and Whisper's own scale: anything else is not Whisper's
FIXED = {"window": "hann", "preemph": 0.0, "dither": 0.0, "vtln_warp": 1.0,
         "mel_scale": "slaney", "dynamic_range_db": None, "lifter": 0,
         "append_energy": False, "deltas": False, "cmvn": False}
# Whisper's floor under a row's largest value (audio.py: max - 8.0 in log10)
FLOOR_DB = 80.0


class Settings:
    """The sizes a configuration file's ``features`` give, as this
    reference reads them; settings it does not compute raise."""

    def __init__(self, f: dict):
        self.sr = int(f["sample_rate"])
        self.n_fft = int(f["n_fft"])
        self.hop = int(round(self.sr * f["hop_ms"] / 1000.0))
        self.n_bins = self.n_fft // 2 + 1
        self.n_mels = int(f["n_mels"])
        self.fmin = float(f["fmin"])
        self.fmax = float(f["fmax"])
        self.log_floor = float(f["log_floor"])
        self.chunk = int(round(self.sr * f["chunk_s"]))
        self.frames = self.chunk // self.hop
        other = {k: f[k] for k, v in FIXED.items() if f[k] != v}
        if int(round(self.sr * f["frame_ms"] / 1000.0)) != self.n_fft:
            other["frame_ms"] = f["frame_ms"]
        if other:
            raise ValueError(f"not Whisper's front end: {other}")


def hz_to_mel(f):
    """Slaney's mel scale: linear below 1 kHz, logarithmic above."""
    f = np.asarray(f, np.float64)
    return np.where(f < 1000.0, 3.0 * f / 200.0,
                    15.0 + np.log(np.maximum(f, 1000.0) / 1000.0)
                    / (np.log(6.4) / 27.0))


def mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m < 15.0, 200.0 * m / 3.0,
                    1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)))


def mel_filters(s: Settings) -> np.ndarray:
    """(n_mels, n_bins) float64 filterbank, triangles linear in Hz."""
    hz = mel_to_hz(np.linspace(hz_to_mel(s.fmin), hz_to_mel(s.fmax),
                               s.n_mels + 2))
    bins = np.arange(s.n_bins, dtype=np.float64) * s.sr / s.n_fft
    lo, ctr, hi = hz[:-2, None], hz[1:-1, None], hz[2:, None]
    fb = np.maximum(0.0, np.minimum((bins - lo) / (ctr - lo),
                                    (hi - bins) / (hi - ctr)))
    return fb * (2.0 / (hz[2:] - hz[:-2]))[:, None]


def periodic_hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def dft_basis(s: Settings) -> np.ndarray:
    """(n_fft, 2 * n_bins): [w cos | -w sin] of the n_fft-point DFT, w the
    periodic Hann window."""
    n = np.arange(s.n_fft, dtype=np.float64)[:, None]
    k = np.arange(s.n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * np.mod(n * k, s.n_fft) / s.n_fft
    w = periodic_hann(s.n_fft)[:, None]
    return np.concatenate([w * np.cos(ang), -w * np.sin(ang)], axis=1)


def _power_float64(xb: torch.Tensor, s: Settings) -> torch.Tensor:
    """(rows, chunk) -> (rows, frames, n_bins) |X|^2 on torch.stft."""
    window = torch.hann_window(s.n_fft, dtype=torch.float64, device=xb.device)
    stft = torch.stft(xb, s.n_fft, s.hop, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    return (stft[..., :-1].abs() ** 2).transpose(1, 2)


def _power_tf32(xb: torch.Tensor, s: Settings, basis) -> torch.Tensor:
    """(rows, chunk) -> (rows, frames, n_bins) |X|^2, the DFT a TF32
    product."""
    P = s.n_fft // 2
    xp = F.pad(xb[:, None], (P, P), mode="reflect")[:, 0]
    fr = xp.unfold(-1, s.n_fft, s.hop)[:, :s.frames]
    spec = round_tf32(fr) @ basis
    return spec[..., :s.n_bins] ** 2 + spec[..., s.n_bins:] ** 2


def features(x: torch.Tensor, lengths, settings: dict, apply_dct: bool,
             precision: str = "float64"):
    """(B, N_pad) int16 audio, (B,) sample lengths -> (feat (B, T, n_mels),
    frame counts (B,) int64, mask (B, T) bool), T = chunk // hop for every
    row.  ``apply_dct`` must be False: Whisper has no cepstra."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    if apply_dct:
        raise ValueError("Whisper's features are log-mel; no DCT")
    s = Settings(settings)
    tf32 = precision == "tf32"
    dtype = torch.float32 if tf32 else torch.float64
    dev = x.device
    B, T = x.shape[0], s.frames
    lengths = [min(int(n), s.chunk, x.shape[1]) for n in lengths]
    fb = torch.from_numpy(mel_filters(s).T.copy()).to(dev, dtype)
    basis = None
    if tf32:
        fb = round_tf32(fb)
        basis = round_tf32(torch.from_numpy(dft_basis(s)).to(dev, dtype))
    out = torch.empty((B, T, s.n_mels), dtype=dtype, device=dev)
    rows = max(1, BLOCK_BYTES // ((T + 1) * s.n_bins * 16))
    for r0 in range(0, B, rows):
        xb = torch.zeros((min(rows, B - r0), s.chunk), dtype=dtype, device=dev)
        for i, n in enumerate(lengths[r0:r0 + rows]):
            xb[i, :n] = x[r0 + i, :n].to(dtype) / 32768.0
        if tf32:
            energies = round_tf32(_power_tf32(xb, s, basis)) @ fb
        else:
            energies = _power_float64(xb, s) @ fb
        spec = torch.clamp(energies, min=s.log_floor).log10()
        top = spec.amax(dim=(1, 2), keepdim=True)
        spec = torch.maximum(spec, top - FLOOR_DB / 10.0)
        out[r0:r0 + rows] = (spec + 4.0) / 4.0
    flens = torch.full((B,), T, dtype=torch.int64, device=dev)
    mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    return out, flens, mask
