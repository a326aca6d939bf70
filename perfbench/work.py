"""The least work of the spectral function, and the card's peaks.

Frozen copy of ``chip_smoke._spectral_work`` (the port's bring-up smoke),
with two changes: the frames are those each utterance needs (its valid
frames, not the padded row's), and the bytes are the int16 audio read
once and the float32 features written once.  The count is the
algorithm's, whatever implements it: a real FFT of n_fft points at
2.5 n log2 n, the window and the pre-emphasis, |X|^2, two operations a
nonzero of the mel matrix (counted from the reference's own filterbank),
the floors and an accurate log per band, and the DCT.
"""

from __future__ import annotations

import math

import numpy as np

from .reference import features as ref

# The accurate log's operations a value (``chip_smoke.ACC_LOG_OPS``).
ACC_LOG_OPS = 17

# Published peaks (NVIDIA's data sheet, SXM part, dense, at 700 W), by a
# substring of the card's name: float32 outside the tensor cores, HBM3.
PEAKS = {"H100": {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}}


def peaks(kind: str) -> dict | None:
    for key, value in PEAKS.items():
        if key in kind:
            return value
    return None


def spectral_work(settings: dict, apply_dct: bool,
                  lengths: np.ndarray) -> tuple:
    """(operations, bytes) of the features of utterances of ``lengths``
    samples, pre-emphasis inside the kernel."""
    s = ref.Settings(settings)
    n, fl = s.n_fft, s.frame_len
    rel = s.range_db is not None
    per_frame = (2.5 * n * math.log2(n) + fl + (2 * fl if s.preemph else 0)
                 + 3 * s.n_bins + 2 * ref.mel_nonzeros(settings)
                 + s.n_mels * (ACC_LOG_OPS + 1 + (2 if rel else 0)))
    if apply_dct:
        per_frame += 2 * s.n_mels * s.n_mfcc
    frames = sum(s.num_frames(int(m)) for m in np.ravel(lengths))
    width = s.n_mfcc if apply_dct else s.n_mels
    return (frames * per_frame,
            2 * int(np.sum(lengths)) + 4 * frames * width)


def roofline_seconds(ops: float, nbytes: float, kind: str):
    """(least seconds, "operations" or "bytes"), or None off the table."""
    pk = peaks(kind)
    if pk is None:
        return None
    t_ops, t_bytes = ops / pk["fp32_flops"], nbytes / pk["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
