"""Plain reference of the batched MFCC and log-mel front ends.

A frozen restatement of the feature contract (``docs/conventions.md``;
the float64 oracle ``mfcc_tpu_torch/oracle.py`` was its model, copied
here, not imported): valid-mode framing with per-frame HTK pre-emphasis
(the first frame's predecessor is x[0]), a symmetric window, the power
spectrum |DFT|^2 of n_fft points without scaling, continuous triangular
mel filters at the bin centres, a floored natural log (with an optional
floor relative to each frame's largest band), an orthonormal DCT-II with
the HTK lifter, and regression deltas whose edges replicate each
utterance's first and last valid frame.  Padded frames are zero.

Two precisions:

- ``"float64"``: the reference.  Every product in float64.
- ``"tf32"``: the control, the same arithmetic one step below the
  configuration's IEEE float32: float32 values, and each matrix product's
  operands rounded to TF32's 10-bit mantissa with float32 accumulation,
  which is what the tensor cores do with TF32 on (rounded here, so that
  the CPU computes the same numbers as the card).

The DFT is a matrix product (the window folded into its basis), so that
both precisions run the same code.  Rows are processed in blocks to keep
memory bounded.
"""

from __future__ import annotations

import numpy as np
import torch

PRECISIONS = ("float64", "tf32")
# float64 bytes of the (rows, frames, 2 * n_bins) DFT output a block may take
BLOCK_BYTES = 1 << 29


def window_fn(kind: str, n: int) -> np.ndarray:
    t = np.arange(n, dtype=np.float64)
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2.0 * np.pi * t / (n - 1))
    if kind == "hann":
        return 0.5 - 0.5 * np.cos(2.0 * np.pi * t / (n - 1))
    if kind == "povey":
        return (0.5 - 0.5 * np.cos(2.0 * np.pi * t / (n - 1))) ** 0.85
    if kind == "rect":
        return np.ones(n, dtype=np.float64)
    raise ValueError(f"unknown window {kind!r}")


def hz_to_mel(f, scale: str):
    f = np.asarray(f, dtype=np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    if scale == "slaney":
        f_sp, min_log_hz = 200.0 / 3.0, 1000.0
        logstep = np.log(6.4) / 27.0
        return np.where(f < min_log_hz, f / f_sp,
                        min_log_hz / f_sp + np.log(np.maximum(f, min_log_hz)
                                                   / min_log_hz) / logstep)
    raise ValueError(f"unknown mel scale {scale!r}")


def mel_to_hz(m, scale: str):
    m = np.asarray(m, dtype=np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(m < min_log_hz / f_sp, m * f_sp,
                    min_log_hz * np.exp(logstep * (m - min_log_hz / f_sp)))


class Settings:
    """The sizes a configuration file's ``features`` give, as the reference
    reads them.  Settings it does not compute raise."""

    def __init__(self, f: dict):
        self.sr = int(f["sample_rate"])
        self.frame_len = int(round(self.sr * f["frame_ms"] / 1000.0))
        self.hop = int(round(self.sr * f["hop_ms"] / 1000.0))
        self.n_fft = int(f["n_fft"])
        self.n_bins = self.n_fft // 2 + 1
        self.window = f["window"]
        self.preemph = float(f["preemph"])
        self.n_mels = int(f["n_mels"])
        self.fmin = float(f["fmin"])
        self.fmax = self.sr / 2.0 if f["fmax"] is None else float(f["fmax"])
        self.mel_scale = f["mel_scale"]
        self.n_mfcc = int(f["n_mfcc"])
        self.log_floor = float(f["log_floor"])
        self.range_db = f["dynamic_range_db"]
        self.lifter = int(f["lifter"])
        self.deltas = bool(f["deltas"])
        self.delta_window = int(f["delta_window"])
        unsupported = {k: f[k] for k, v in (
            ("frame_mode", "valid"), ("dither", 0.0), ("vtln_warp", 1.0),
            ("append_energy", False), ("cmvn", False)) if f[k] != v}
        if unsupported:
            raise ValueError(f"the reference does not compute {unsupported}")

    def num_frames(self, n: int) -> int:
        return 0 if n < self.frame_len else 1 + (n - self.frame_len) // self.hop


def mel_filterbank(s: Settings) -> np.ndarray:
    """(n_mels, n_bins) triangular filters at the bin centre frequencies."""
    bin_mel = hz_to_mel(np.arange(s.n_bins) * s.sr / s.n_fft, s.mel_scale)
    edges = np.linspace(hz_to_mel(s.fmin, s.mel_scale),
                        hz_to_mel(s.fmax, s.mel_scale), s.n_mels + 2)
    lo, ctr, hi = edges[:-2, None], edges[1:-1, None], edges[2:, None]
    fb = np.maximum(0.0, np.minimum((bin_mel - lo) / (ctr - lo),
                                    (hi - bin_mel) / (hi - ctr)))
    if s.mel_scale == "slaney":
        hz = mel_to_hz(edges, "slaney")
        fb = fb * (2.0 / (hz[2:] - hz[:-2]))[:, None]
    return fb


def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) orthonormal DCT-II."""
    j = np.arange(n_in, dtype=np.float64)
    i = np.arange(n_out, dtype=np.float64)[:, None]
    mat = np.cos(np.pi * i * (2.0 * j + 1.0) / (2.0 * n_in)) * np.sqrt(2.0 / n_in)
    mat[0] /= np.sqrt(2.0)
    return mat


def lifter_coeffs(n: int, lifter: int) -> np.ndarray:
    if lifter <= 0:
        return np.ones(n)
    return 1.0 + (lifter / 2.0) * np.sin(np.pi * np.arange(n) / lifter)


def dft_basis(s: Settings) -> np.ndarray:
    """(frame_len, 2 * n_bins): [w cos | -w sin] of the n_fft-point DFT."""
    n = np.arange(s.frame_len, dtype=np.float64)[:, None]
    k = np.arange(s.n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * np.mod(n * k, s.n_fft) / s.n_fft
    w = window_fn(s.window, s.frame_len)[:, None]
    return np.concatenate([w * np.cos(ang), -w * np.sin(ang)], axis=1)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 explicit mantissa bits, ties
    to even), kept in float32."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


class _Product:
    """Matrix products in one precision, with their constant operands."""

    def __init__(self, precision: str, device):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64
        self.device = device

    def const(self, a: np.ndarray) -> torch.Tensor:
        t = torch.as_tensor(np.ascontiguousarray(a), device=self.device)
        t = t.to(self.dtype)
        return round_tf32(t) if self.tf32 else t

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a = round_tf32(a)
        return a @ b


def _deltas(feat: torch.Tensor, lengths: torch.Tensor, window: int):
    """(b, T, F) regression deltas, edges replicated at frame 0 and at each
    row's last valid frame (index clamping)."""
    T = feat.shape[1]
    t = torch.arange(T, device=feat.device)[None, :]
    last = torch.clamp(lengths, min=1)[:, None] - 1
    out = torch.zeros_like(feat)
    for n in range(1, window + 1):
        up = torch.minimum(t + n, last).clamp(max=T - 1)
        down = torch.clamp(torch.minimum(t - n, last), min=0)
        pick = lambda idx: torch.gather(
            feat, 1, idx[..., None].expand(-1, -1, feat.shape[2]))
        out = out + n * (pick(up.expand(feat.shape[0], -1))
                         - pick(down.expand(feat.shape[0], -1)))
    return out / (2.0 * sum(n * n for n in range(1, window + 1)))


def features(x: torch.Tensor, lengths, settings: dict, apply_dct: bool,
             precision: str = "float64"):
    """(B, N_pad) int16 audio, (B,) sample lengths -> (feat (B, T, F),
    frame counts (B,) int64, mask (B, T) bool), T the padded row's frames
    and F n_mfcc or n_mels, times three with deltas."""
    s = Settings(settings)
    p = _Product(precision, x.device)
    lengths = [int(n) for n in lengths]
    B, N = x.shape
    T = s.num_frames(N)
    flens = torch.tensor([s.num_frames(n) for n in lengths], device=x.device)
    mask = torch.arange(T, device=x.device)[None, :] < flens[:, None]
    basis = p.const(dft_basis(s))
    fb = p.const(mel_filterbank(s).T)
    width = s.n_mfcc if apply_dct else s.n_mels
    dct = p.const((dct_matrix(s.n_mfcc, s.n_mels)
                   * lifter_coeffs(s.n_mfcc, s.lifter)[:, None]).T)
    out = torch.zeros((B, T, width * (3 if s.deltas else 1)), dtype=p.dtype,
                      device=x.device)
    if T == 0:
        return out, flens, mask
    rows = max(1, BLOCK_BYTES // (T * 2 * s.n_bins * 8))
    for r0 in range(0, B, rows):
        xb = x[r0:r0 + rows].to(p.dtype) / 32768.0
        fr = xb[:, :(T - 1) * s.hop + s.frame_len].unfold(1, s.frame_len, s.hop)
        if s.preemph:
            prev = torch.cat([xb[:, :1], xb[:, :-1]], dim=1)
            prev = prev[:, :(T - 1) * s.hop + s.frame_len].unfold(
                1, s.frame_len, s.hop)
            fr = fr - s.preemph * prev
        spec = p(fr, basis)
        power = spec[..., :s.n_bins] ** 2 + spec[..., s.n_bins:] ** 2
        energies = p(power, fb)
        floor = torch.full_like(energies[..., :1], s.log_floor)
        if s.range_db is not None:
            floor = torch.maximum(floor, energies.amax(-1, keepdim=True)
                                  * 10.0 ** (-s.range_db / 10.0))
        feat = torch.log(torch.maximum(energies, floor))
        if apply_dct:
            feat = p(feat, dct)
        if s.deltas:
            fl = flens[r0:r0 + rows]
            d1 = _deltas(feat, fl, s.delta_window)
            feat = torch.cat([feat, d1, _deltas(d1, fl, s.delta_window)], -1)
        out[r0:r0 + rows] = torch.where(mask[r0:r0 + rows, :, None], feat,
                                        torch.zeros((), dtype=p.dtype,
                                                    device=x.device))
    return out, flens, mask


def mel_nonzeros(settings: dict) -> int:
    """Nonzero entries of the configuration's mel filterbank."""
    return int(np.count_nonzero(mel_filterbank(Settings(settings))))

