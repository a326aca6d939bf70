"""PLP pipeline (Hermansky 1990; twin of ``mfcc_tpu/models/plp.py``).

The framing, window and DFT front half of the MFCC pipeline, then
critical-band (bark) analysis with equal loudness, cube-root compression
and an all-pole (LPC) cepstral model (``ops/plp.py``).

- :func:`plp` — one utterance: (N,) -> (T, n_feats).
- :func:`plp_batch` — padded ragged batch plus per-utterance sample
  lengths -> (features, true frame counts, frame validity mask); int16 or
  float input, padded frames zeroed.

On a CUDA tensor, where ``routes.raw_dit_kernel_eligible`` holds, the
spectral front half (pre-emphasis, window, DFT power, bark + equal-loudness
band energies, floored log) is one launch of ``fused_raw_dit`` with
``projection="bark"`` (its float64-front FFT tile at a power-of-two
n_fft, ``_spectral.fft_tile`` says why), and the
tail (loudness, autocorrelation, Levinson, cepstra, lifter) runs on its
small (B, T, n_bark) output in plain PyTorch, as it runs in XLA in the
reference.  Otherwise (and under ``matmul_precision="high"``,
``backend.resolve``) the plain chain runs on the card; a CPU tensor takes
the plain chain.  ``append_energy`` takes c0 from the host-pre-emphasized
audio in both routes, as the reference does; deltas see the frame counts.
Dither is added to the audio once, before either route
(``mfcc_tpu/models/plp.py:38-41``).
"""

from __future__ import annotations

import torch

from ..config import FeatureConfig
from .. import backend as backend_lib
from ..ops import (deltas as deltas_op, dither as dither_op, framing,
                   plp as plp_op, spectrum)
from ..ops.kernels import fused_raw_dit, routes
from ..utils import report
from .mfcc import frame_lengths, frame_mask, run_batch  # noqa: F401


def _plp_from_audio(x: torch.Tensor, cfg: FeatureConfig,
                    lengths: torch.Tensor | None = None,
                    backend: str = "auto") -> torch.Tensor:
    """(B, N) or (N,) valid-mode audio -> PLP features (deltas
    appended)."""
    squeeze = x.dim() == 1
    with report.span("feat.spectral"):
        xb = (x[None, :] if squeeze else x).to(torch.float32).contiguous()
        xb = dither_op.apply(xb, cfg)
        use_kernel = (backend_lib.resolve(backend, xb, cfg) == "cuda"
                      and routes.raw_dit_kernel_eligible(cfg))
        y = (framing.preemphasize(xb, cfg)
             if cfg.append_energy or not use_kernel else None)
        if use_kernel:
            log_bark = fused_raw_dit.fused_features_raw_dit(
                xb, cfg, apply_dct=False, projection="bark")
            feat = plp_op.plp_from_log_bark(log_bark, cfg)
        else:
            fr = framing.frames(y, cfg)
            feat = plp_op.plp_from_power(
                spectrum.power_form(cfg)(fr, cfg), cfg)
        if cfg.append_energy:
            e = spectrum.log_energy_blocked(y, cfg)
            feat = torch.cat([e[..., None], feat[..., 1:]], dim=-1)
        report.count("frames_computed", feat.shape[0] * feat.shape[1])
    if squeeze:
        feat = feat[0]
    if cfg.deltas:
        with report.span("feat.deltas"):
            feat = deltas_op.append_deltas(feat, cfg, lengths, backend)
    return feat


def plp(x: torch.Tensor, cfg: FeatureConfig,
        backend: str = "auto") -> torch.Tensor:
    """(n_samples,) PCM in [-1, 1] -> (T, n_feats) PLP cepstra."""
    backend_lib.check_config(cfg)
    x, cfg = framing.resolve_frame_mode_static(x, cfg)
    return _plp_from_audio(x, cfg, backend=backend)


def plp_batch(x: torch.Tensor, sample_lengths: torch.Tensor,
              cfg: FeatureConfig, backend: str = "auto"):
    """(B, N_pad), (B,) -> ((B, T, n_feats), (B,) int32 frame counts,
    (B, T) bool mask); x int16 PCM or float in [-1, 1]."""
    return run_batch(x, sample_lengths, cfg, lambda xv, c, flens: (
        _plp_from_audio(xv, c, lengths=flens if c.deltas else None,
                        backend=backend)))
