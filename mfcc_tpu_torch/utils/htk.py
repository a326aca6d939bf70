"""HTK parameter-file reader/writer (one .htk per utterance).

A copy of ``mfcc_tpu/utils/htk.py``, which imports numpy only; the port
keeps its own so that nothing here imports the JAX package.  On the same
float32 arrays both write the same bytes (``tests/test_torch_utils.py``).

The classic HTK feature container (HTKBook §5.10): a 12-byte big-endian
header — nSamples (i32), samplePeriod (i32, 100 ns units), sampleSize
(i16, bytes/frame), parmKind (i16) — followed by big-endian float32
frames.  This is the third archive interop next to Kaldi ark/scp and
TFRecord (utils/kaldi.py, utils/tfrecord.py); HTK's HList/HCopy and
Kaldi's copy-feats-to-htk both read it.

parmKind base codes (HTKBook table 5.1): MFCC=6, FBANK=7, USER=9; the
writer sets MFCC|_O|_? nothing fancy — callers pick the code, default
USER (9), because this framework's feature vectors (appended pitch,
splice, deltas) are not constrained to HTK's qualifier algebra.  The
_E/_D/_A qualifier bits can be OR'd in by the caller when the layout
matches HTK's expectations.
"""

from __future__ import annotations

import struct

import numpy as np

PARM_MFCC = 6
PARM_FBANK = 7
PARM_USER = 9
QUAL_E = 0o100      # log energy appended
QUAL_D = 0o400      # delta coefficients appended
QUAL_A = 0o1000     # acceleration (delta-delta) appended


def write_htk(path: str, feat: np.ndarray, frame_period_s: float = 0.01,
              parm_kind: int = PARM_USER) -> None:
    """(T, F) float features -> HTK parameter file (big-endian f32)."""
    feat = np.ascontiguousarray(feat, dtype=">f4")
    T, F = feat.shape
    period_100ns = int(round(frame_period_s * 1e7))
    with open(path, "wb") as f:
        f.write(struct.pack(">iihh", T, period_100ns, 4 * F, parm_kind))
        f.write(feat.tobytes())


def read_htk(path: str):
    """HTK parameter file -> ((T, F) float32 features, period_s, kind)."""
    with open(path, "rb") as f:
        hdr = f.read(12)
        if len(hdr) != 12:
            raise ValueError(f"{path}: truncated HTK header")
        T, period, ssize, kind = struct.unpack(">iihh", hdr)
        if ssize <= 0 or ssize % 4:
            raise ValueError(f"{path}: bad HTK sampleSize {ssize}")
        F = ssize // 4
        data = np.frombuffer(f.read(T * ssize), dtype=">f4")
        if data.size != T * F:
            raise ValueError(f"{path}: truncated HTK data "
                             f"({data.size} of {T * F} floats)")
    return data.reshape(T, F).astype(np.float32), period * 1e-7, kind
