"""PCM16 mono WAV reader (the MFCC slice of ``mfcc_tpu/utils/wav.py``).

Decodes to float32 in [-1, 1) as ``int16 / 32768``, the reference's
contract.  Other formats raise ``WavError``; the reference's wider reader
(8/24/32-bit, float, multi-channel, native decoder) comes with the corpus
runner slice.
"""

from __future__ import annotations

import os
import struct

import numpy as np


class WavError(ValueError):
    pass


_HDR = struct.Struct("<4sI4s")
_FMT = struct.Struct("<HHIIHH")


def read_wav(path: str | os.PathLike):
    """Read a PCM16 mono RIFF WAV -> (float32 signal in [-1, 1), rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12:
        raise WavError("file too short for RIFF header")
    riff, _size, wave = _HDR.unpack_from(data, 0)
    if riff != b"RIFF" or wave != b"WAVE":
        raise WavError("not a RIFF/WAVE file")
    pos, fmt, payload = 12, None, None
    while pos + 8 <= len(data):
        cid, csz = struct.unpack_from("<4sI", data, pos)
        pos += 8
        if cid == b"fmt ":
            if csz < 16:
                raise WavError("fmt chunk too small")
            fmt = _FMT.unpack_from(data, pos)
        elif cid == b"data":
            payload = data[pos: pos + csz]
        pos += csz + (csz & 1)  # chunks are word-aligned
    if fmt is None or payload is None:
        raise WavError("missing fmt or data chunk")
    audio_format, n_ch, sr, _brate, _balign, bits = fmt
    if audio_format not in (1, 0xFFFE) or bits != 16 or n_ch != 1:
        raise WavError(f"only PCM16 mono is supported, got format "
                       f"{audio_format}, {bits} bit, {n_ch} channels")
    x = np.frombuffer(payload[: len(payload) // 2 * 2], "<i2")
    return np.ascontiguousarray(x.astype(np.float32) / 32768.0), sr
