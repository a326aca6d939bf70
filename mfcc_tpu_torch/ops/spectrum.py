"""Window-folded real-DFT power spectrum (twin of
``mfcc_tpu/ops/spectrum.py``).

The windowed n_fft-point real DFT of a frame_len-sample frame is two dense
(frame_len, n_bins) products against window-folded cos/sin bases.  The
plain path materializes frames with ``Tensor.unfold`` and runs ONE fp32
matmul against the concatenated [cos | sin] basis: the reference's "no
frame materialization" rule was an XLA-on-TPU measurement and does not
bind here.  The product follows the precision mode (``backend.matmul``);
under ``compute_dtype="bfloat16"`` it is the reference's chain of bfloat16
hop-block products (:func:`_dft`).  The power is squared and added in the
accumulation dtype (``backend.accum_dtype``), each op rounded as the
reference's XLA rounds it (``xmath.mul_add``).  The float64 bases are the
single source of the DFT constants for the plain path and the CUDA kernels
alike.

``power_spectrum_dit`` is the radix-2 decimation-in-time form of the same
power spectrum (two half-length DFTs of the parity streams and a twiddle
combine): the plain twin of the DIT kernel, numerically the form the
reference's DIT routes take; ``power_spectrum_dit4`` the two-stage form
of its "dit4c".  :func:`power_form` picks the plain route's form.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import FeatureConfig
from .. import backend, oracle
from . import framing, xmath


def folded_dft(window: np.ndarray, n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """(len(window), n_fft // 2 + 1) float64 cos and sin DFT bases with
    the window folded in."""
    n = np.arange(len(window), dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    w = np.asarray(window, np.float64)[:, None]
    return w * np.cos(ang), w * np.sin(ang)


@functools.lru_cache(maxsize=32)
def _dft_matrices_cached(key) -> tuple[np.ndarray, np.ndarray]:
    frame_len, n_fft, window = key
    return folded_dft(oracle.window_fn(window, frame_len), n_fft)


def dft_matrices(cfg: FeatureConfig) -> tuple[np.ndarray, np.ndarray]:
    """(frame_len, n_bins) float64 window-folded cos/sin DFT bases."""
    return _dft_matrices_cached((cfg.frame_len, cfg.n_fft, cfg.window))


def _dft(fr: torch.Tensor, basis: np.ndarray, block: int,
         cfg: FeatureConfig, precision) -> torch.Tensor:
    """(..., T, K) frames @ the (K, W) float64 basis -> (..., T, W) float32
    at the config's compute dtype and the mode ``precision`` (None: the
    config's).  In float32 one product.  In bfloat16 the reference's
    hop-block chain (``mfcc_tpu/ops/spectrum.py:114-150``): frames and
    basis rounded to bfloat16, one bfloat16 product per ``block`` columns
    of the frame, the partial sums added in bfloat16, the sum cast to
    float32 (``accum_dtype``).  The chain's last add is taken in float32,
    as XLA computes it (its excess precision, on by default, drops the
    rounding between an add and the cast that follows): so the port
    equals JAX's CPU result to ~1e-5 where a last add in bfloat16 would
    put them ~5e-3 apart (``tests/test_torch_precision.py``)."""
    if precision is None:
        precision = cfg.matmul_precision
    dt = backend.COMPUTE_DTYPES[cfg.compute_dtype]
    mat = torch.from_numpy(basis.astype(np.float32)).to(fr.device, dt)
    fr = fr.to(dt)
    if dt == torch.float32:
        return backend.matmul(fr, mat, precision)
    parts = [backend.matmul(fr[..., lo: lo + block], mat[lo: lo + block],
                            precision)
             for lo in range(0, fr.shape[-1], block)]
    acc = parts[0]
    for part in parts[1:-1]:
        acc = acc + part
    if len(parts) == 1:
        return acc.to(torch.float32)
    return acc.to(torch.float32) + parts[-1].to(torch.float32)


def power_spectrum(fr: torch.Tensor, cfg: FeatureConfig, *,
                   precision=None, cast: bool = False) -> torch.Tensor:
    """(..., T, frame_len) pre-emphasized frames -> (..., T, n_bins) |X|^2
    in the accumulation dtype (``backend.accum_dtype``): the product at the
    config's compute dtype and the mode ``precision`` (None: the config's),
    its real and imaginary parts cast to the accumulation dtype, squared
    and added in it, each op rounded as XLA rounds it (the reference's
    ``power_spectrum_blocked_split``, ``mfcc_tpu/ops/spectrum.py:149-155``).
    With ``cast`` the power in float32 as a float32 op that takes it next
    reads it (``xmath.mul_add``: in bfloat16 the last add unrounded).
    The reference leaves the top bin's sine column out at an even n_fft;
    here that column holds float64's sin(pi n) residue, ~1e-14 of the
    frame's scale, whose square no rounding or floor can see."""
    cos_m, sin_m = dft_matrices(cfg)
    spec = _dft(fr, np.concatenate([cos_m, sin_m], axis=1), cfg.hop_len,
                cfg, precision)
    acc = backend.accum_dtype(cfg)
    re, im = spec[..., :cfg.n_bins].to(acc), spec[..., cfg.n_bins:].to(acc)
    return xmath.mul_add(re, re, im * im, cast)


@functools.lru_cache(maxsize=32)
def _dit_matrices_cached(key):
    frame_len, n_fft, window = key
    nb2 = n_fft // 4         # half-DFT bins 0..nb2-1; bin nb2 is rank-1
    w = oracle.window_fn(window, frame_len)
    streams = []
    for s in (0, 1):
        ws = w[s::2]
        m = np.arange(ws.shape[0], dtype=np.float64)[:, None]
        j = np.arange(nb2, dtype=np.float64)[None, :]
        ang = 2.0 * np.pi * m * j / (n_fft // 2)
        basis = np.concatenate(
            [ws[:, None] * np.cos(ang), ws[:, None] * np.sin(ang)], axis=1)
        # bin nb2 of the half DFT: e^{-2 pi i m nb2 / (n_fft/2)} = (-1)^m
        last = (ws * np.cos(np.pi * m[:, 0]))[:, None]
        streams.append((basis, last))
    th = 2.0 * np.pi * np.arange(nb2, dtype=np.float64) / n_fft
    return streams[0], streams[1], np.cos(th), np.sin(th)


def dit_matrices(cfg: FeatureConfig):
    """Radix-2 DIT constants, float64: per sample-parity stream the
    window-folded n_fft/2-point real-DFT basis packed [cos | sin]
    (ceil or floor of frame_len/2 rows, n_fft/2 columns) and its bin
    n_fft/4 column (the window times (-1)^m), then the twiddles
    cos, sin of 2 pi j / n_fft for j < n_fft/4:
    ((even, even_last), (odd, odd_last), cos, sin)."""
    return _dit_matrices_cached((cfg.frame_len, cfg.n_fft, cfg.window))


def dit_supported(cfg: FeatureConfig) -> bool:
    """The radix-2 split needs a half-length DFT with a real bin n_fft/4
    (n_fft % 4 == 0) and a sample in each parity stream."""
    return cfg.n_fft % 4 == 0 and cfg.frame_len >= 2


def _dit_combine(E: torch.Tensor, O: torch.Tensor, cfg: FeatureConfig):
    """The radix-2 twiddle combine of the half-length DFTs of the even and
    odd samples, each (..., T, n_fft/2 + 1) packed [cos | sin | bin
    n_fft/4] in the accumulation dtype, -> (..., T, n_bins) |X|^2 in
    natural bin order, every op in that dtype with the twiddles rounded to
    it (twin of the reference's ``_dit_combine``,
    ``mfcc_tpu/ops/spectrum.py:283-305``)."""
    *_, ct, st = dit_matrices(cfg)
    nb2 = cfg.n_fft // 4
    ctj, stj = (backend.constant(a, E.dtype, E.device) for a in (ct, st))
    e_re, e_im, e_last = E[..., :nb2], E[..., nb2:2 * nb2], E[..., 2 * nb2:]
    o_re, o_im, o_last = O[..., :nb2], O[..., nb2:2 * nb2], O[..., 2 * nb2:]
    # B = W^j O[j] with the products giving (sum x cos, sum x sin) pairs:
    # E[j] = e_re - i e_im, O[j] = o_re - i o_im, W^j = cos - i sin
    b_re = xmath.mul_add(ctj, o_re, -(stj * o_im))
    b_im = xmath.mul_add(ctj, o_im, stj * o_re)
    ar, ai = e_re + b_re, e_im + b_im
    dr, di = e_re - b_re, e_im - b_im
    p_plus = xmath.mul_add(ar, ar, ai * ai)                # bins 0 .. nb2-1
    p_minus = xmath.mul_add(dr, dr, di * di)               # n_fft/2 - j
    mid = xmath.mul_add(e_last, e_last, o_last * o_last)  # bin nb2 (real)
    return torch.cat([p_plus, mid, torch.flip(p_minus, dims=(-1,))], dim=-1)


def power_spectrum_dit(fr: torch.Tensor, cfg: FeatureConfig, *,
                       precision=None) -> torch.Tensor:
    """(..., T, frame_len) pre-emphasized frames -> (..., T, n_bins) |X|^2
    in natural bin order by the radix-2 split: one product per parity
    stream against its packed [cos | sin | bin n_fft/4] half-DFT basis
    (at the config's compute dtype and the mode ``precision``, as
    :func:`power_spectrum`; in bfloat16 chained over half-hop blocks),
    cast to the accumulation dtype, then :func:`_dit_combine` (twin of
    the reference's ``power_spectrum_dit_split``)."""
    if not dit_supported(cfg):
        raise ValueError("the radix-2 DIT needs n_fft % 4 == 0 and "
                         "frame_len >= 2")
    (be, bel), (bo, bol), _, _ = dit_matrices(cfg)
    acc = backend.accum_dtype(cfg)
    E, O = (_dft(fr[..., s::2], np.concatenate([basis, last], axis=1),
                 max(cfg.hop_len // 2, 1), cfg, precision).to(acc)
            for s, basis, last in ((0, be, bel), (1, bo, bol)))
    return _dit_combine(E, O, cfg)


@functools.lru_cache(maxsize=32)
def _dit4_matrices_cached(key):
    frame_len, n_fft, window = key
    nb4 = n_fft // 8         # quarter-DFT bins 0..nb4-1; bin nb4 is rank-1
    w = oracle.window_fn(window, frame_len)
    streams = []
    for s in range(4):
        ws = w[s::4]
        m = np.arange(ws.shape[0], dtype=np.float64)[:, None]
        j = np.arange(nb4, dtype=np.float64)[None, :]
        ang = 2.0 * np.pi * m * j / (n_fft // 4)
        streams.append(np.concatenate(
            [ws[:, None] * np.cos(ang), ws[:, None] * np.sin(ang),
             (ws * np.cos(np.pi * m[:, 0]))[:, None]], axis=1))
    th = 2.0 * np.pi * np.arange(n_fft // 4, dtype=np.float64) / (n_fft // 2)
    return tuple(streams), np.cos(th), np.sin(th)


def dit4_matrices(cfg: FeatureConfig):
    """Two-stage (radix-4) DIT constants, float64: per sample residue mod
    4 the window-folded n_fft/4-point real-DFT basis packed [cos | sin |
    bin n_fft/8] (n_fft/4 + 1 columns), then the level-1 twiddles cos,
    sin of 2 pi j / (n_fft/2) for j < n_fft/4: (streams, cos, sin)."""
    return _dit4_matrices_cached((cfg.frame_len, cfg.n_fft, cfg.window))


def _quarter_to_half(S: torch.Tensor, nb4: int):
    """A quarter DFT packed [cos | sin | bin nb4] -> (re, im) over bins
    0 .. 2 nb4 - 1 by its conjugate symmetry (the stored im negates), as
    the reference's ``_quarter_to_half``."""
    re, im, last = S[..., :nb4], S[..., nb4:2 * nb4], S[..., 2 * nb4:]
    return (torch.cat([re, last, torch.flip(re[..., 1:], (-1,))], dim=-1),
            torch.cat([im, torch.zeros_like(last),
                       -torch.flip(im[..., 1:], (-1,))], dim=-1))


def power_spectrum_dit4(fr: torch.Tensor, cfg: FeatureConfig, *,
                        precision=None) -> torch.Tensor:
    """(..., T, frame_len) pre-emphasized frames -> (..., T, n_bins) |X|^2
    in natural bin order by the two-stage split (twin of the reference's
    ``power_spectrum_dit4_concat``, ``mfcc_tpu/ops/spectrum.py:411-488``):
    one product per sample residue mod 4 against its quarter-DFT basis
    (as :func:`power_spectrum_dit`), cast to the accumulation dtype, the
    level-1 twiddle combine of residues 0, 2 and of 1, 3 into the half
    DFTs of the even and odd samples in that dtype, then
    :func:`_dit_combine`."""
    if not cfg.dit4_eligible:
        raise ValueError("the radix-4 DIT needs n_fft % 8 == 0, hop_len "
                         "% 4 == 0 and frame_len >= 4")
    streams, c2, s2 = dit4_matrices(cfg)
    acc = backend.accum_dtype(cfg)
    nb4 = cfg.n_fft // 8
    S = [_dft(fr[..., s::4], basis, max(cfg.hop_len // 4, 1), cfg,
              precision).to(acc) for s, basis in enumerate(streams)]
    cw, sw = (backend.constant(a, acc, fr.device) for a in (c2, s2))
    (a_re, a_im), (b_re, b_im), (c_re, c_im), (d_re, d_im) = (
        _quarter_to_half(q, nb4) for q in S)
    # (c_re - i c_im)(cw - i sw) in the stored (sum cos, sum sin) form;
    # bin n_fft/4 of each half DFT is S_0[0] - S_2[0] (and S_1 - S_3)
    def level1(x_re, x_im, y_re, y_im):
        # x + W y as the reference writes it, x_re + cw y_re - sw y_im
        # and x_im + sw y_re + cw y_im, each op rounded as XLA rounds it
        return (xmath.mul_add(-sw, y_im, xmath.mul_add(cw, y_re, x_re)),
                xmath.mul_add(cw, y_im, xmath.mul_add(sw, y_re, x_im)))

    E = torch.cat([*level1(a_re, a_im, c_re, c_im),
                   S[0][..., :1] - S[2][..., :1]], dim=-1)
    O = torch.cat([*level1(b_re, b_im, d_re, d_im),
                   S[1][..., :1] - S[3][..., :1]], dim=-1)
    return _dit_combine(E, O, cfg)


def power_form(cfg: FeatureConfig):
    """The plain route's power spectrum for cfg.  In float32 every
    ``dft_algorithm`` is one value within float32 rounding, and the
    direct form (:func:`power_spectrum`) computes them all.  In a
    narrower accumulation dtype each factorization rounds its own
    intermediates to whole ulps (the radix-2 combine cancels in spectral
    valleys: 14.7 off JAX's log-mel-80 at bfloat16 through the direct
    form), so the DIT algorithms take their own form: "dit2" and "dit2c"
    :func:`power_spectrum_dit`, "dit4c" :func:`power_spectrum_dit4`."""
    if backend.accum_dtype(cfg) == torch.float32:
        return power_spectrum
    return {"dit2": power_spectrum_dit, "dit2c": power_spectrum_dit,
            "dit4c": power_spectrum_dit4}.get(cfg.dft_algorithm,
                                              power_spectrum)


def log_energy_blocked(y: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(..., N) pre-emphasized audio -> (..., T) floored log frame energy."""
    return framing.log_energy(framing.frames(y, cfg), cfg)
