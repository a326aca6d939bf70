"""Training-time augmentation: SpecAugment masking and speed perturbation
(twin of ``mfcc_tpu/ops/augment.py``).

- :func:`speed_perturb` — Kaldi-style 0.9 / 1.1 speed perturbation through
  the polyphase resampler (``ops/resample.resample``).
- :func:`spec_augment` — frequency and time stripes (Park et al., 2019),
  in two parts, because JAX's keys cannot be reproduced in torch:
  :func:`draw_masks` takes every stripe's width and start from an explicit
  ``torch.Generator`` on the CPU, so one seed gives the same masks on the
  CPU and on the card; :func:`apply_masks` is the pure applier on the
  features' device (the part held bit-equal to the reference, fed the
  draws its keys give).

A training-time op with no float64 oracle twin.  Ragged batches pass
``num_frames``: time stripes land inside the valid frames, and padding
frames stay exactly zero.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from .. import backend
from .resample import reduce_ratio, resample


def speed_perturb(x: torch.Tensor, lengths: torch.Tensor, factor: float,
                  sample_rate: int = 16_000, *,
                  precision: str = backend.KEYWORD_PRECISION):
    """Time-scale (..., N) padded audio by ``factor``: resample to
    sample_rate / factor and play it at sample_rate.  -> (x' (..., N'),
    lengths' (...,) int32), N' = ceil(N * L / M).  Factor 1.0 returns the
    inputs as they are.  ``precision``: the resampler's mode
    (:func:`resample`)."""
    if factor == 1.0:
        return x, lengths
    sr_out = int(round(sample_rate / factor))
    y = resample(x, sample_rate, sr_out, precision=precision)
    L, M = reduce_ratio(sample_rate, sr_out)
    lengths = torch.as_tensor(lengths, device=x.device)
    new_len = (lengths.to(torch.int64) * L + (M - 1)) // M
    return y, torch.clamp(new_len, max=y.shape[-1]).to(torch.int32)


class Masks(NamedTuple):
    """Stripes of one batch, each (B, n_masks) int64: the stripe covers
    [start, start + width) on its axis."""
    f_starts: torch.Tensor
    f_widths: torch.Tensor
    t_starts: torch.Tensor
    t_widths: torch.Tensor


def _uniform_int(generator: torch.Generator, maxval: torch.Tensor):
    """Uniform ints in [0, maxval] (inclusive), one per entry of maxval:
    floor(u * (maxval + 1)) with u uniform float32 in [0, 1), the
    reference's ``_uniform_int``."""
    u = torch.rand(maxval.shape, generator=generator)
    return torch.floor(u * (maxval.to(torch.float32) + 1.0)).to(torch.int64)


def _stripes(generator, n_masks: int, max_width, limit):
    """(B, n_masks) widths <= min(max_width, limit) and starts with the
    stripe inside [0, limit); max_width and limit are (B,) int64."""
    B = limit.shape[0]
    cap = torch.minimum(max_width, limit)[:, None].expand(B, n_masks)
    widths = _uniform_int(generator, cap)
    starts = _uniform_int(generator, torch.clamp(limit[:, None] - widths,
                                                 min=0))
    return starts, widths


def draw_masks(generator: torch.Generator, B: int, T: int, F: int, *,
               n_freq_masks: int = 2, freq_mask_width: int = 15,
               n_time_masks: int = 2, time_mask_width: int = 70,
               time_mask_frac: float = 1.0,
               num_frames: torch.Tensor | None = None) -> Masks:
    """Every stripe of a (B, T, F) batch from ``generator`` (a CPU
    ``torch.Generator``): ``n_freq_masks`` widths U[0, freq_mask_width]
    on the feature axis, ``n_time_masks`` widths U[0, min(time_mask_width,
    floor(time_mask_frac * valid_frames))] on the time axis (the paper's
    adaptive cap), each start uniform over the positions that keep the
    stripe inside.  ``num_frames`` (B,): valid frames per row (default
    T), read on the host.  The tensors are on the CPU."""
    if generator.device.type != "cpu":
        raise ValueError("draw masks from a CPU generator, so that one "
                         "seed gives the same masks on every device")
    valid = (torch.full((B,), T, dtype=torch.int64) if num_frames is None
             else torch.as_tensor(num_frames).detach().to("cpu",
                                                           torch.int64))
    t_cap = torch.clamp(torch.floor(time_mask_frac * valid.to(
        torch.float32)).to(torch.int64), max=time_mask_width)
    f_starts, f_widths = _stripes(
        generator, n_freq_masks, torch.full((B,), freq_mask_width),
        torch.full((B,), F))
    t_starts, t_widths = _stripes(generator, n_time_masks, t_cap, valid)
    return Masks(f_starts, f_widths, t_starts, t_widths)


def _hit(length: int, starts: torch.Tensor, widths: torch.Tensor,
         device) -> torch.Tensor:
    """(B, length) bool: the union of each row's stripes."""
    pos = torch.arange(length, device=device)[None, :, None]
    s, w = starts.to(device)[:, None, :], widths.to(device)[:, None, :]
    return ((pos >= s) & (pos < s + w)).any(dim=-1)


def apply_masks(feat: torch.Tensor, masks: Masks, *,
                num_frames: torch.Tensor | None = None,
                mask_value: Union[float, str] = 0.0) -> torch.Tensor:
    """(B, T, F) features -> the same with every stripe of ``masks`` set to
    the fill: ``mask_value``, or with "mean" each row's mean over its valid
    frames.  With ``num_frames``, padding frames come out exactly zero.
    Gradients flow through the unmasked entries."""
    B, T, F = feat.shape
    dev = feat.device
    hit = (_hit(T, masks.t_starts, masks.t_widths, dev)[:, :, None]
           | _hit(F, masks.f_starts, masks.f_widths, dev)[:, None, :])
    valid = None
    if num_frames is not None:
        valid = (torch.arange(T, device=dev)[None, :]
                 < torch.as_tensor(num_frames, device=dev)[:, None])
    if mask_value == "mean":
        n = (torch.full((B,), T, device=dev) if valid is None
             else valid.sum(dim=1)).to(feat.dtype)
        kept = feat if valid is None else torch.where(valid[..., None],
                                                      feat, 0.0)
        fill = (kept.sum(dim=(1, 2)) / torch.clamp(n * F, min=1.0))
        out = torch.where(hit, fill[:, None, None], feat)
    else:
        out = torch.where(hit, torch.tensor(float(mask_value),
                                            dtype=feat.dtype, device=dev),
                          feat)
    if valid is not None:   # padding frames stay exactly zero
        out = torch.where(valid[..., None], out, 0.0)
    return out


def spec_augment(feat: torch.Tensor, generator: torch.Generator, *,
                 n_freq_masks: int = 2, freq_mask_width: int = 15,
                 n_time_masks: int = 2, time_mask_width: int = 70,
                 time_mask_frac: float = 1.0,
                 num_frames: torch.Tensor | None = None,
                 mask_value: Union[float, str] = 0.0) -> torch.Tensor:
    """(T, F) or (B, T, F) features -> the same shape with random stripes
    masked (:func:`draw_masks` from ``generator``, then
    :func:`apply_masks`).  Each row of a batch draws its own stripes.
    Defaults are the paper's LibriSpeech "LD" policy at a 10 ms hop."""
    squeeze = feat.dim() == 2
    fb = feat[None] if squeeze else feat
    if num_frames is not None and squeeze:
        num_frames = torch.as_tensor(num_frames).reshape(1)
    B, T, F = fb.shape
    masks = draw_masks(generator, B, T, F, n_freq_masks=n_freq_masks,
                       freq_mask_width=freq_mask_width,
                       n_time_masks=n_time_masks,
                       time_mask_width=time_mask_width,
                       time_mask_frac=time_mask_frac, num_frames=num_frames)
    out = apply_masks(fb, masks, num_frames=num_frames,
                      mask_value=mask_value)
    return out[0] if squeeze else out
