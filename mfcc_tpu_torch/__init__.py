"""mfcc_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of mfcc_tpu.

The JAX package ``mfcc_tpu`` stays the reference; this package imports
torch and numpy only.  It computes batched MFCC (``models/mfcc``),
log-mel (``models/logmel``), PLP (``models/plp``), the log spectrogram
(``models/spectrogram``) and Kaldi-style pitch (``models/pitch``) on the
card through six hand-written CUDA kernels, one per Pallas kernel of the
reference (``ops/kernels``), with a plain PyTorch path beside each.
"""

from .config import FeatureConfig, PitchConfig, from_jax  # noqa: F401
from . import oracle  # noqa: F401
from .models import plp, spectrogram  # noqa: F401

__version__ = "0.1.0"
