"""Hand-written Hopper kernels, one module per Pallas kernel of
mfcc_tpu.ops.kernels (same file name).  CUDA sources live in ``csrc/`` and
are built at first use (``_build.py``); importing a module builds nothing.

- :mod:`fused_raw_dit` — raw audio -> MFCC (the main path).
"""

from . import fused_raw_dit  # noqa: F401
