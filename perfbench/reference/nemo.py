"""Plain reference of NVIDIA NeMo's ASR preprocessor, batched.

NeMo's ``FilterbankFeatures`` with ``normalize="per_feature"`` (the front
end of the Parakeet and Canary models; Hugging Face's
``ParakeetFeatureExtractor`` states it line for line), restated here, not
imported.  Per row of L samples in a (B, N) batch:

- pre-emphasis y[0] = x[0], y[n] = x[n] - preemph x[n - 1], then y[n] = 0
  for n >= L;
- ``torch.stft`` at n_fft with the symmetric Hann window of frame_len
  points (``torch.hann_window(frame_len, periodic=False)``, centred in
  n_fft), ``center=True`` and ``pad_mode="constant"``: 1 + N // hop frames,
  frame t's window over samples [t hop - frame_len / 2, t hop + frame_len /
  2), zeros outside [0, N);
- |X|^2 of the n_fft // 2 + 1 bins, the Slaney-scale filterbank whose
  triangles are linear in Hz with Slaney's area normalisation
  (``whisper.mel_filters``), the natural log with the additive guard,
  log(e + log_floor);
- the valid frames L // hop; over them, each band's mean and the square
  root of its Bessel-corrected variance sigma, (x - mean) / (sigma +
  norm_eps); the frames past them zeros.

Departures from the sources:

- float64, where NeMo and Hugging Face compute in float32;
- no dither: NeMo adds Gaussian noise of 1e-5 in training mode only,
  Hugging Face none;
- a row with fewer than two valid frames is zeros, where NeMo raises and
  Hugging Face writes NaN (the program's rule, ``models/nemo.normalize``).

Two precisions, as ``features.py``:

- ``"float64"``: the reference, on ``torch.stft``;
- ``"tf32"``: the control, one step below the configuration's IEEE
  float32: the same pre-emphasis and frames in float32 (the constant pad,
  then ``unfold``), the DFT as a product with the window folded into its
  basis, every product's operands rounded to TF32's 10-bit mantissa with
  float32 sums, everything else in float32.

Rows are processed in blocks to keep memory bounded.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .features import PRECISIONS, round_tf32
from .whisper import mel_filters

# float64 bytes of the (rows, bins, frames) complex STFT a block may take
BLOCK_BYTES = 1 << 29
# the settings that name steps of other front ends, at the values that turn
# them off, and NeMo's own scale and steps: anything else is not NeMo's
FIXED = {"frame_mode": "valid", "window": "hann", "dither": 0.0,
         "vtln_warp": 1.0, "mel_scale": "slaney", "dynamic_range_db": None,
         "lifter": 0, "append_energy": False, "deltas": False, "cmvn": False,
         "log_guard": "add", "normalize": "per_feature"}


class Settings:
    """The sizes a configuration file's ``features`` give, as this
    reference reads them; settings it does not compute raise."""

    def __init__(self, f: dict):
        self.sr = int(f["sample_rate"])
        self.n_fft = int(f["n_fft"])
        self.frame_len = int(round(self.sr * f["frame_ms"] / 1000.0))
        self.hop = int(round(self.sr * f["hop_ms"] / 1000.0))
        self.n_bins = self.n_fft // 2 + 1
        self.n_mels = int(f["n_mels"])
        self.fmin = float(f["fmin"])
        self.fmax = float(f["fmax"])
        self.preemph = float(f["preemph"])
        self.log_floor = float(f["log_floor"])
        self.norm_eps = float(f["norm_eps"])
        other = {k: f.get(k) for k, v in FIXED.items() if f.get(k) != v}
        if not 2 <= self.frame_len <= self.n_fft:
            other["frame_ms"] = f["frame_ms"]
        if other:
            raise ValueError(f"not NeMo's front end: {other}")

    def num_frames(self, n_pad: int) -> int:
        """Frames of every row of a batch padded to n_pad samples."""
        return 1 + n_pad // self.hop

    def valid_frames(self, n: int) -> int:
        """The valid frames of a row of n samples."""
        return n // self.hop


def window(s: Settings, dtype=torch.float64, device=None) -> torch.Tensor:
    return torch.hann_window(s.frame_len, periodic=False, dtype=dtype,
                             device=device)


def dft_basis(s: Settings) -> np.ndarray:
    """(frame_len, 2 * n_bins): [w cos | -w sin] of the n_fft-point DFT of
    a frame_len-point frame, w the symmetric Hann window (|X|^2 does not
    see where the window sits inside the n_fft points)."""
    n = np.arange(s.frame_len, dtype=np.float64)[:, None]
    k = np.arange(s.n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * np.mod(n * k, s.n_fft) / s.n_fft
    w = window(s).numpy()[:, None]
    return np.concatenate([w * np.cos(ang), -w * np.sin(ang)], axis=1)


def preemphasize(xb: torch.Tensor, lengths: list, s: Settings):
    """(rows, N) -> NeMo's pre-emphasis, zeros from each row's length."""
    y = torch.cat([xb[:, :1], xb[:, 1:] - s.preemph * xb[:, :-1]], dim=1)
    n = torch.as_tensor(lengths, device=xb.device)
    t = torch.arange(xb.shape[1], device=xb.device)
    return y.masked_fill(t[None, :] >= n[:, None], 0.0)


def _power_float64(y: torch.Tensor, s: Settings) -> torch.Tensor:
    """(rows, N) -> (rows, T, n_bins) |X|^2 on torch.stft."""
    stft = torch.stft(y, s.n_fft, s.hop, win_length=s.frame_len,
                      window=window(s, device=y.device), center=True,
                      pad_mode="constant", return_complex=True)
    return (stft.abs() ** 2).transpose(1, 2)


def _power_tf32(y: torch.Tensor, s: Settings, basis) -> torch.Tensor:
    """(rows, N) -> (rows, T, n_bins) |X|^2, the DFT a TF32 product."""
    half = s.frame_len // 2
    T = s.num_frames(y.shape[1])
    yp = F.pad(y, (half, (T - 1) * s.hop + s.frame_len - half - y.shape[1]))
    spec = round_tf32(yp.unfold(-1, s.frame_len, s.hop)) @ basis
    return spec[..., :s.n_bins] ** 2 + spec[..., s.n_bins:] ** 2


def normalize(logmel: torch.Tensor, flens: torch.Tensor,
              mask: torch.Tensor, eps: float) -> torch.Tensor:
    """NeMo's per-feature normalization over each row's valid frames."""
    m = mask[..., None].to(logmel.dtype)
    n = flens.to(logmel.dtype)[:, None, None]
    mean = (logmel * m).sum(1, keepdim=True) / n.clamp(min=1.0)
    d = (logmel - mean) * m
    var = (d * d).sum(1, keepdim=True) / (n - 1.0).clamp(min=1.0)
    return d / (var.sqrt() + eps)


def features(x: torch.Tensor, lengths, settings: dict, apply_dct: bool,
             precision: str = "float64"):
    """(B, N) int16 audio, (B,) sample lengths -> (feat (B, T, n_mels),
    frame counts (B,) int64, mask (B, T) bool), T = 1 + N // hop.
    ``apply_dct`` must be False: NeMo's features are log-mel."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    if apply_dct:
        raise ValueError("NeMo's features are log-mel; no DCT")
    s = Settings(settings)
    tf32 = precision == "tf32"
    dtype = torch.float32 if tf32 else torch.float64
    dev = x.device
    B, N = x.shape
    T = s.num_frames(N)
    lengths = [min(int(n), N) for n in lengths]
    flens = torch.tensor([s.valid_frames(n) for n in lengths],
                         dtype=torch.int64, device=dev)
    mask = torch.arange(T, device=dev)[None, :] < flens[:, None]
    fb = torch.from_numpy(mel_filters(s).T.copy()).to(dev, dtype)
    basis = None
    if tf32:
        fb = round_tf32(fb)
        basis = round_tf32(torch.from_numpy(dft_basis(s)).to(dev, dtype))
    out = torch.empty((B, T, s.n_mels), dtype=dtype, device=dev)
    rows = max(1, BLOCK_BYTES // ((T + 1) * s.n_bins * 16))
    for r0 in range(0, B, rows):
        sl = slice(r0, r0 + rows)
        y = preemphasize(x[sl].to(dtype) / 32768.0, lengths[sl], s)
        if tf32:
            energies = round_tf32(_power_tf32(y, s, basis)) @ fb
        else:
            energies = _power_float64(y, s) @ fb
        out[sl] = normalize(torch.log(energies + s.log_floor), flens[sl],
                            mask[sl], s.norm_eps)
    return out, flens, mask
