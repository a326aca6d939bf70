"""Seeded, reproducible dither (twin of ``mfcc_tpu/ops/dither.py``).

Gaussian noise of RMS ``cfg.dither`` is added to the signal once, indexed
by ABSOLUTE sample position, so a streamed chunk at sample offset k draws
exactly the noise a batch run draws there, and one stream is broadcast
over every row of a batch (noise is per position, not per row).  noise[i]
is a pure function of (seed, i): a murmur3-finalizer hash of the
position, then Box-Muller.

The hash is uint32 arithmetic, which torch has no usable multiply for.
Here it is int64 masked to 32 bits after every step, and each product by
a 32-bit constant is split into its 16-bit halves, so that no product
reaches 2^63 (a signed overflow in ATen's C++ is undefined, so nothing
counts on it to wrap); the shifts then act on non-negative values.  The
bits equal ``_mix_np``'s on the CPU and on the card.  The transcendentals
(log, sqrt, cos) run in float64 and round to float32 once, so the noise
is the float32 rounding of :func:`noise_np` to within an ulp; the JAX
twin computes them in float32 (an ulp or two apart, ~1e-11 on the signal
at dither amplitudes).

Units: ``cfg.dither`` is the noise RMS in the [-1, 1] float convention;
Kaldi's ``--dither=1`` (1 LSB of int16) is :data:`KALDI_ONE_LSB`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import FeatureConfig

KALDI_ONE_LSB = 1.0 / 32768.0

_C1 = np.uint32(0x85EBCA6B)   # murmur3 finalizer constants
_C2 = np.uint32(0xC2B2AE35)
_PHI = np.uint32(0x9E3779B9)  # golden-ratio stream separator
_K1, _K2 = 0x6C8E9CF5, 0x94D049BB   # the two Box-Muller streams
_M32 = 0xFFFFFFFF


def _mix_np(h: np.ndarray) -> np.ndarray:
    h = h.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h *= _C1
    h ^= h >> np.uint32(13)
    h *= _C2
    h ^= h >> np.uint32(16)
    return h


def _bits_to_unit_np(h: np.ndarray) -> np.ndarray:
    """uint32 -> float in [2^-25, 1): top 24 bits as a fixed-point fraction,
    floored away from zero for log()."""
    u = (h >> np.uint32(8)).astype(np.float64) * 2.0 ** -24
    return np.maximum(u, 2.0 ** -25)


def _seed_mix(seed: int) -> int:
    return (int(seed) & _M32) * int(_PHI) & _M32


def bits_np(seed: int, start: int, n: int):
    """The two uint32 hash streams (h1, h2) of samples [start, start+n)."""
    idx = (np.arange(start, start + n, dtype=np.int64) & _M32).astype(np.uint32)
    base = _mix_np(idx + np.uint32(_seed_mix(seed)))
    return _mix_np(base ^ np.uint32(_K1)), _mix_np(base ^ np.uint32(_K2))


def noise_np(seed: int, start: int, n: int) -> np.ndarray:
    """Unit-variance Gaussian noise for samples [start, start+n), float64
    (the oracle's draw)."""
    h1, h2 = bits_np(seed, start, n)
    u1, u2 = _bits_to_unit_np(h1), _bits_to_unit_np(h2)
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


def apply_np(x: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """Oracle-side dither: x (float64, 1-D) + cfg.dither * noise."""
    if cfg.dither == 0.0:
        return x
    return x + cfg.dither * noise_np(cfg.dither_seed, 0, x.shape[-1])


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32): c split into 16-bit
    halves, so each product stays below 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _mix(h: torch.Tensor) -> torch.Tensor:
    """Twin of :func:`_mix_np` on int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, int(_C1))
    h = h ^ (h >> 13)
    h = _mul32(h, int(_C2))
    return h ^ (h >> 16)


def bits(seed: int, start, n: int, device=None):
    """The (h1, h2) hash streams as int64 tensors of uint32 values.

    start: an int, or a (B,) int tensor of per-row offsets (then the
    streams are (B, n)); positions wrap modulo 2^32 as in the reference.
    """
    if isinstance(start, torch.Tensor):
        device = start.device if device is None else device
        start = start.to(device=device, dtype=torch.int64)[..., None]
    pos = torch.arange(n, dtype=torch.int64, device=device)
    idx = (start + pos) & _M32
    base = _mix((idx + _seed_mix(seed)) & _M32)
    return _mix(base ^ _K1), _mix(base ^ _K2)


def noise(seed: int, start, n: int, device=None) -> torch.Tensor:
    """Unit-variance Gaussian noise for samples [start, start+n) as float32
    (float64 transcendentals, one rounding); (n,) for an int start, (B, n)
    for a (B,) tensor of starts."""
    h1, h2 = bits(seed, start, n, device)
    u1 = torch.clamp((h1 >> 8).to(torch.float64) * 2.0 ** -24, min=2.0 ** -25)
    u2 = (h2 >> 8).to(torch.float64) * 2.0 ** -24
    return (torch.sqrt(-2.0 * torch.log(u1))
            * torch.cos(2.0 * np.pi * u2)).to(torch.float32)


def apply(x: torch.Tensor, cfg: FeatureConfig, start=0) -> torch.Tensor:
    """x + cfg.dither * noise: one stream over the last axis, broadcast
    over leading batch dims.  ``start`` is the absolute sample index of
    x[..., 0] (streaming), an int or a (B,) tensor of per-row starts."""
    if cfg.dither == 0.0:
        return x
    nz = noise(cfg.dither_seed, start, x.shape[-1], device=x.device)
    return x + torch.tensor(cfg.dither, dtype=x.dtype,
                            device=x.device) * nz.to(x.dtype)
