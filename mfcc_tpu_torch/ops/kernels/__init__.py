"""Hand-written Hopper kernels, one module per Pallas kernel of
mfcc_tpu.ops.kernels (same file name).  CUDA sources live in ``csrc/`` and
are built at first use (``_build.py``); importing a module builds nothing.

- :mod:`fused_raw_dit` — raw audio -> MFCC (the main path).
- :mod:`fused_nccf` — work-rate audio -> ballasted and plain NCCF (pitch).
- :mod:`fused_viterbi` — NCCF scores -> Viterbi lag path (pitch).
"""

from . import fused_nccf, fused_raw_dit, fused_viterbi  # noqa: F401
