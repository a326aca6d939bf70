"""The least work of NeMo's front end (``reference/nemo.py``), counted over
its valid frames.

NeMo defines 1 + N // hop frames a row of a batch padded to N samples,
but only the row's L // hop valid ones carry features: the frames past
them are zeros, known without a transform.  So only the valid frames
count operations and bytes written.  A valid frame is counted as the
algorithm's work, whatever implements it:

- the real FFT of n_fft points at 2.5 n log2 n (n = 512: 11,520), the
  window's frame_len products, |X|^2 at three operations a bin;
- two operations a nonzero of the mel filterbank (counted from the
  reference's own bank: 504 at 128 bands);
- a value (n_mels a frame): the additive guard (1) and the accurate log
  (``work.ACC_LOG_OPS``).

The pre-emphasis and the per-feature normalization are not counted: they
lie outside ``fused_raw``, whose share of this roofline the metric reads.
The bytes are each row's L int16 samples read once and the float32
features of its valid frames written once.
"""

from __future__ import annotations

import math

import numpy as np

from . import work
from .reference import nemo as ref
from .reference.whisper import mel_filters

# operations a feature value after the filterbank: the guard and the log
VALUE_OPS = 1 + work.ACC_LOG_OPS


def per_frame(settings: dict) -> float:
    s = ref.Settings(settings)
    n = s.n_fft
    return (2.5 * n * math.log2(n) + s.frame_len + 3 * s.n_bins
            + 2 * int(np.count_nonzero(mel_filters(s)))
            + s.n_mels * VALUE_OPS)


def valid_frames(settings: dict, lengths: np.ndarray) -> int:
    s = ref.Settings(settings)
    return int((np.ravel(lengths).astype(np.int64) // s.hop).sum())


def nemo_work(settings: dict, lengths: np.ndarray) -> tuple:
    """(operations, bytes) of the features of rows of ``lengths``
    samples."""
    s = ref.Settings(settings)
    frames = valid_frames(settings, lengths)
    return (frames * per_frame(settings),
            2 * int(np.sum(lengths)) + 4 * frames * s.n_mels)
