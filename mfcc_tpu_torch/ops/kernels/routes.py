"""Which spectral kernel a config reaches (pure-config twins of the
reference's route in ``mfcc_tpu/models/mfcc.py:78-95``).

The reference picks a Pallas kernel by Mosaic lane-layout rules
(``raw_dit_kernel_eligible``, ``raw_kernel_eligible``,
``dit_kernel_eligible``) plus one accuracy rule (``use_dit``: the DIT
combine adds a rounding stage in deep spectral valleys, so unbounded
log-mel stays on the direct form).  The port copies these TPU rules on
purpose, so that each config reaches the counterpart of the kernel the
reference gives it; they are no property of the Hopper kernels, every one
of which takes every valid-mode config (``fused_dit`` every one with
n_fft % 4 == 0), so each is also checked at the default config.

What the route changes on the card:

- ``fused_raw_dit`` (cepstra and log-mel <= 50 dB, pre-emphasis in the
  kernel) runs the shared-memory FFT tile (``csrc/fft_tile.cuh``) at a
  power-of-two n_fft from 64 to 4096, ``fused_raw`` (unbounded log-mel)
  the direct window-folded DFT tile (``csrc/spectral.cuh``).  So the
  cepstra / <= 50 dB split, and with it ``use_dit``, has the reference's
  meaning on CUDA too: the fast form where the floors bound the valleys,
  the direct form for unbounded log-mel, whose deep valleys an f32 FFT
  rounds worse (``_spectral.fft_tile``).
- ``fused_dit`` is the radix-2 DIT form with pre-emphasis on the host, as
  in the reference.
- ``fused_mfcc`` takes audio the host pre-emphasized and applies the same
  rule as ``fused_raw_dit``: FFT tile for cepstra and bounded log-mel,
  direct tile otherwise.

Routing on the H100's own terms (the direct form, in the kernel, for every
unbounded log-mel) is an A/B left open in ROADMAP.
"""

from __future__ import annotations

import math

from ...config import FeatureConfig

LANE = 128   # the TPU lane width the reference's layout rules count in
Q_PAD = 8    # the reference DIT kernel's roll-lookahead rows


def raw_dit_kernel_eligible(cfg: FeatureConfig) -> bool:
    """Twin of ``mfcc_tpu/ops/kernels/fused_raw_dit.py:106``."""
    if cfg.n_fft % 4 != 0 or cfg.hop_len % 2 != 0 or cfg.frame_len < 2:
        return False
    hop_h = cfg.hop_len // 2
    P = LANE // math.gcd(hop_h, LANE)
    if P > 16:
        return False
    rpp = hop_h * P // LANE
    le = (cfg.frame_len + 1) // 2
    return (P - 1) * hop_h + le - rpp * LANE <= rpp * LANE


def raw_kernel_eligible(cfg: FeatureConfig) -> bool:
    """Twin of ``mfcc_tpu/ops/kernels/fused_raw.py:90``."""
    if cfg.n_fft % 2 != 0 or cfg.frame_len < 1:
        return False
    P = LANE // math.gcd(cfg.hop_len, LANE)
    if P > 8:
        return False
    rpp = cfg.hop_len * P // LANE
    return (P - 1) * cfg.hop_len + cfg.frame_len - rpp * LANE <= rpp * LANE


def dit_kernel_eligible(cfg: FeatureConfig) -> bool:
    """Twin of ``mfcc_tpu/ops/kernels/fused_dit.py:76``."""
    if not (cfg.n_fft % 4 == 0 and cfg.hop_len % 2 == 0
            and cfg.frame_len >= 2):
        return False
    hop2 = cfg.hop_len // 2
    le = (cfg.frame_len + 1) // 2
    return -(-le // hop2) - 1 <= Q_PAD


def use_dit(cfg: FeatureConfig, apply_dct: bool) -> bool:
    """The reference's accuracy rule (``models/mfcc.py:78-79``): the raw
    DIT route for cepstra and for log-mel bounded to <= 50 dB."""
    return apply_dct or (cfg.dynamic_range_db is not None
                         and cfg.dynamic_range_db <= 50.0)


def spectral_route(cfg: FeatureConfig, apply_dct: bool) -> str:
    """The kernel module a valid-mode config reaches on the card:
    "fused_raw_dit", "fused_raw", "fused_dit" or "fused_mfcc" (the last two
    take audio the host pre-emphasized)."""
    if use_dit(cfg, apply_dct) and raw_dit_kernel_eligible(cfg):
        return "fused_raw_dit"
    if raw_kernel_eligible(cfg):
        return "fused_raw"
    if dit_kernel_eligible(cfg):
        return "fused_dit"
    return "fused_mfcc"
