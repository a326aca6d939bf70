"""mfcc_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of mfcc_tpu.

The JAX package ``mfcc_tpu`` stays the reference; this package imports
torch and numpy only.  Slice 1 is batched MFCC through one hand-written
CUDA kernel (``ops/kernels/fused_raw_dit.py``); slice 2 is batched
Kaldi-style pitch through two more (``ops/kernels/fused_nccf.py``,
``ops/kernels/fused_viterbi.py``).
"""

from .config import FeatureConfig, PitchConfig, from_jax  # noqa: F401
from . import oracle  # noqa: F401

__version__ = "0.1.0"
