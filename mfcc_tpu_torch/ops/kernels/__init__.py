"""Hand-written Hopper kernels, one module per Pallas kernel of
mfcc_tpu.ops.kernels (same file name), and one of the port's own.  CUDA
sources live in ``csrc/`` and are built at first use (``_build.py``);
importing a module builds nothing.

- :mod:`fused_raw_dit` — raw audio -> MFCC, or log-mel bounded to <= 50 dB.
- :mod:`fused_raw` — raw audio -> unbounded-range log-mel.
- :mod:`fused_dit` — pre-emphasized audio -> features (the TTS geometry;
  the radix-2 DIT tile where the FFT tile does not apply).
- :mod:`fused_mfcc` — pre-emphasized audio -> features (the last route,
  e.g. an odd hop).
- :mod:`routes` — which of those four a config reaches (the reference's
  route, ``mfcc_tpu/models/mfcc.py:78-95``).
- :mod:`fused_nccf` — work-rate audio -> ballasted and plain NCCF (pitch).
- :mod:`fused_viterbi` — NCCF scores -> Viterbi lag path (pitch).
- :mod:`fused_deltas` — features -> [static, delta, delta-delta] in one
  pass; no Pallas twin (the reference's deltas are plain ``jnp``).

The four spectral kernels share ``csrc/spectral.cuh`` (accurate log,
direct DFT tile, epilogue), the shared-memory FFT tile of
``csrc/fft_tile.cuh`` (power-of-two n_fft from 64 to 4096: f32 for cepstra
and log-mel bounded to <= 50 dB, a float64 front for other log-mel) and
``_spectral.py`` (plain chain, constants, tile rule, launch).
"""

from . import (fused_deltas, fused_dit, fused_mfcc,  # noqa: F401
               fused_nccf, fused_raw, fused_raw_dit, fused_viterbi, routes)
