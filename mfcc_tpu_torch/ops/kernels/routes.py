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

What the route changes on the card: the kernel, not the tile.  Every
spectral kernel picks its tile from the config alone (``_spectral.fft_tile``):
at a power-of-two n_fft from 64 to 4096, the shared-memory FFT tile of
``csrc/fft_tile.cuh``, in f32 for cepstra and log-mel bounded to <= 50 dB
(``use_dit``: the floors bound the valleys) and with a float64 front for
other log-mel (in valleys ~120-140 dB deep an f32 FFT rounds worse than the
direct form; float64 through |X|^2 holds the float64 oracle there); in
``fused_raw`` also at an n_fft of 2^a 5^b (Whisper's 400), that float64
flavour as a mixed-radix tile; at any other n_fft the direct window-folded
DFT tile (``csrc/spectral.cuh``), or in ``fused_dit`` its radix-2 DIT
tile.  So on the card:

- ``fused_raw_dit`` (cepstra and log-mel <= 50 dB, pre-emphasis in the
  kernel) runs the f32 FFT tile, ``fused_raw`` (unbounded log-mel) the
  float64-front tile, with pre-emphasis in float64;
- ``fused_dit`` and ``fused_mfcc`` take audio the host pre-emphasized (in
  f32, as the reference does) and apply the same rule: the TTS geometry's
  unbounded log-mel runs the float64-front tile on that audio, whose f32
  rounding it keeps (the DIT form's extra valley rounding it does not).

PLP and the log spectrogram reach ``fused_raw_dit`` alone, with
``projection="bark"`` where ``raw_dit_kernel_eligible`` holds and
``projection="spec"`` where ``spec_kernel_eligible`` holds; otherwise
they run the plain chain on the card, as the reference runs XLA.

Routing on the H100's own terms (pre-emphasis in the kernel, in float64,
for every unbounded log-mel) is an A/B left open in ROADMAP.

The precision mode is routed as the reference routes it
(:func:`kernel_precision_supported`): "high" runs the plain chain on the
card, whose products are IEEE fp32 (``backend.matmul``), because Mosaic
has no in-kernel HIGH dot.  The Hopper kernels have no matrix product and
would take "high" as they take every mode; sending it through them is
ROADMAP's A/B 3, to be measured once fidelity to the reference's route is
no longer the goal.
"""

from __future__ import annotations

import math

from ...config import FeatureConfig

LANE = 128   # the TPU lane width the reference's layout rules count in
Q_PAD = 8    # the reference DIT kernel's roll-lookahead rows


def kernel_precision_supported(cfg) -> bool:
    """Twin of ``mfcc_tpu/backend.py:29-35``: the kernel route takes
    "default" and "highest" but not "high" (Mosaic cannot lower a HIGH
    dot), which ``backend.resolve`` sends to the plain path."""
    return getattr(cfg, "matmul_precision", "highest") != "high"


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


def spec_kernel_eligible(cfg: FeatureConfig) -> bool:
    """Twin of ``mfcc_tpu/ops/kernels/fused_raw_dit.py:125``: the
    spectrogram's kernel route also needs n_fft / 2 lane-aligned (n_fft
    512, 768, 1024 yes; 400 no).  PLP's needs ``raw_dit_kernel_eligible``
    alone."""
    return raw_dit_kernel_eligible(cfg) and (cfg.n_fft // 2) % LANE == 0


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
