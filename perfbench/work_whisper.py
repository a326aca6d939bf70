"""The least work of Whisper's front end (``reference/whisper.py``).

``work.spectral_work`` counts the frames of each utterance's own samples;
Whisper defines every frame of its window, so a row is ``chunk // hop``
frames (3,000 for 30 s) whatever its length, and all are written.  A
frame that reads none of the row's samples (it lies wholly in the window's
zero padding) is known without a transform: its every value is the row's
floor.  So only the frames that overlap the row's first min(length, chunk)
samples count operations; the others count their bytes written and
nothing else.  A frame that overlaps is counted as the algorithm's work,
whatever implements it:

- the real FFT of n_fft points at 2.5 n log2 n (n = 400: 8,643.9), the
  window's n products, |X|^2 at three operations a bin;
- two operations a nonzero of the mel filterbank (counted from the
  reference's own bank);
- a value (n_mels a frame): the floor and the accurate log
  (``work.ACC_LOG_OPS`` + 1), its part in the row's maximum (1), the row
  floor (1) and the affine (x + 4) / 4 (2).

The bytes are the valid int16 samples read once (each row's first
min(length, chunk) samples) and the float32 features of every frame
written once.
"""

from __future__ import annotations

import math

import numpy as np

from . import work
from .reference import whisper as ref

# operations a feature value after the filterbank: floor and log, its part
# in the row's maximum, the row floor, the affine
VALUE_OPS = work.ACC_LOG_OPS + 1 + 1 + 1 + 2


def per_frame(settings: dict) -> float:
    s = ref.Settings(settings)
    n = s.n_fft
    return (2.5 * n * math.log2(n) + n + 3 * s.n_bins
            + 2 * int(np.count_nonzero(ref.mel_filters(s)))
            + s.n_mels * VALUE_OPS)


def sample_frames(settings: dict, lengths: np.ndarray) -> np.ndarray:
    """The frames of each row that read one of its samples: frame t of the
    centred STFT starts at sample t hop - n_fft / 2, so it overlaps a row
    of n >= 1 samples while t hop - n_fft / 2 <= n - 1."""
    s = ref.Settings(settings)
    n = np.minimum(np.ravel(lengths).astype(np.int64), s.chunk)
    t = (n - 1 + s.n_fft // 2) // s.hop + 1
    return np.where(n > 0, np.minimum(t, s.frames), 0)


def whisper_work(settings: dict, lengths: np.ndarray) -> tuple:
    """(operations, bytes) of the features of rows of ``lengths``
    samples."""
    s = ref.Settings(settings)
    lengths = np.ravel(lengths)
    frames = len(lengths) * s.frames
    valid = int(np.minimum(lengths, s.chunk).sum())
    computed = int(sample_frames(settings, lengths).sum())
    return computed * per_frame(settings), 2 * valid + 4 * frames * s.n_mels
