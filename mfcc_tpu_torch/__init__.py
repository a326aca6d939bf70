"""mfcc_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of mfcc_tpu.

The JAX package ``mfcc_tpu`` stays the reference; this package imports
torch and numpy only.  It computes batched MFCC (``models/mfcc``: padded,
packed and long), log-mel (``models/logmel``), PLP (``models/plp``), the
log spectrogram (``models/spectrogram``), Kaldi-style pitch
(``models/pitch``) and streamed features (``models/streaming``) on the card
through six hand-written CUDA kernels, one per Pallas kernel of the
reference (``ops/kernels``), with a plain PyTorch path beside each; dither
(``ops/dither``), the post chain (``ops/post``) and corpus CMVN
(``parallel/cmvn``) around them.  ``python -m mfcc_tpu_torch`` runs the
corpus runner (``runner.py``, ``cli.py``): WAV files in, feature files out.

Serving and training: the online pitch tracker (``models/pitch_online``,
``OnlinePitch``: the chunk NCCF through ``fused_nccf``, its streaming
resampler in ``ops/resample``), SpecAugment and speed perturbation
(``ops/augment``), the trainable front end (``models/trainable``) and
``dataset.feature_batches``, the corpus as device batches for a training
loop.

Several processes: ``parallel/dist`` joins them over gloo (one process a
GPU), ``parallel/mesh`` lays their ranks out as data x time x feat, and
``parallel/dryrun`` (``python -m mfcc_tpu_torch.parallel.dryrun N``) runs
the reference's distributed step across N of them: CMVN statistics
summed over the mesh, the trainable front end's filterbank columns split
over "feat".  Entry points run on the card unless given ``device="cpu"``.
"""

from .config import (FeatureConfig, PitchConfig, MFCC13,  # noqa: F401
                     LOGMEL80, from_jax, logmel_config)
from . import oracle  # noqa: F401
from .models import plp, spectrogram, streaming  # noqa: F401
from .models.mfcc import (mfcc, mfcc_batch, mfcc_batch_packed,  # noqa: F401
                          mfcc_long)
from .models.streaming import (init_online_cmvn, init_state,  # noqa: F401
                               init_state_batch, online_cmvn_step,
                               process_chunk, process_chunk_batch,
                               process_chunks, process_chunks_batch,
                               process_chunks_batch_fused, state_from_jax,
                               stream_signal)
from .ops import dither, post  # noqa: F401
from .parallel import cmvn  # noqa: F401

__version__ = "0.1.0"
