"""The native batch WAV decoder: ``native/wavio.cpp`` through ctypes (the
port's own loader; the twin of ``mfcc_tpu/native/__init__.py``).

The library is built with g++ at first use, never at import, into
``build/mfcc_tpu_torch/`` under the checkout (where ``ops/kernels/_build``
puts the kernels), named by a hash of the source and the flags, so a
changed source is rebuilt.  ``native/Makefile`` is not used: it writes
into the JAX package.  A build or load failure raises; nothing falls back
to the pure-Python parser (``utils/wav``), which the tests hold this
decoder equal to.

Per-file status codes (:data:`ERRORS`), as the reference reports them: 0
decoded, -1 io error, -2 not a RIFF/WAVE file, -3 missing fmt or data
chunk, -4 unsupported encoding, -5 out of memory, -6 not mono PCM16 (the
int16 decoder only).  A header of fewer than 8 bits a sample must not
reach it (the decoder divides by the bytes a sample): ``utils/wav.probe``,
the runner's probe, quarantines such files first.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "wavio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mfcc_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

ERRORS = {
    -1: "io error",
    -2: "not a RIFF/WAVE file",
    -3: "missing fmt or data chunk",
    -4: "unsupported encoding",
    -5: "out of memory",
    -6: "not mono PCM16",   # the int16 decoder only; the float one takes it
}

_P = ctypes.POINTER


def library_path() -> Path:
    """Where the build of the current ``native/wavio.cpp`` lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libwavio-{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> None:
    names = [os.environ["CXX"]] if os.environ.get("CXX") else ["g++", "c++"]
    cxx = next(filter(None, map(shutil.which, names)), None)
    if cxx is None:
        raise RuntimeError(f"no C++ compiler ({' or '.join(names)}) on "
                           "PATH: the native WAV decoder needs one")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building the WAV decoder failed with code "
                           f"{proc.returncode}:\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build the library if it is missing, load it, declare its entries."""
    lib_path = library_path()
    if not lib_path.exists():
        _build(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    common = [_P(i64), _P(i32), _P(i32), ctypes.c_int]
    lib.mfcc_read_wavs.restype = None
    lib.mfcc_read_wavs.argtypes = [
        _P(ctypes.c_char_p), i64, ctypes.c_int, _P(ctypes.c_float), i64,
        *common]
    lib.mfcc_read_wavs_i16.restype = None
    lib.mfcc_read_wavs_i16.argtypes = [
        _P(ctypes.c_char_p), i64, _P(ctypes.c_int16), i64, *common]
    return lib


def _outputs(n: int, max_len: int, dtype):
    if max_len < 0:
        raise ValueError(f"max_len must be >= 0, got {max_len}")
    return (np.zeros((n, max_len), dtype), np.zeros((n,), np.int64),
            np.zeros((n,), np.int32), np.zeros((n,), np.int32))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(_P(ctype))


def read_wavs_padded(paths: list, max_len: int, channel: int = -1,
                     n_threads: int = 0):
    """Thread-pooled batch decode into a zero-padded (B, max_len) float32
    matrix.  -> (audio, lengths (B,) int64, rates (B,) int32, errors (B,)
    int32).  A file that fails has errors[i] != 0 (:data:`ERRORS`) and a
    zeroed row: the batch survives it.  channel=-1 averages channels,
    k >= 0 selects one; files longer than max_len are cut."""
    lib = load()
    audio, lengths, rates, errors = _outputs(len(paths), max_len, np.float32)
    if paths:
        arr = (ctypes.c_char_p * len(paths))(*map(os.fsencode, paths))
        lib.mfcc_read_wavs(arr, len(paths), channel,
                           _ptr(audio, ctypes.c_float), max_len,
                           _ptr(lengths, ctypes.c_int64),
                           _ptr(rates, ctypes.c_int32),
                           _ptr(errors, ctypes.c_int32), n_threads)
    return audio, lengths, rates, errors


def read_wavs_padded_i16(paths: list, max_len: int, n_threads: int = 0):
    """PCM16 passthrough batch decode -> (B, max_len) int16 raw samples
    (half the bytes of the float path; the models cast on the device), with
    the same lengths, rates and errors.  A file that is not mono 16-bit PCM
    gets error -6: decode it with :func:`read_wavs_padded`."""
    lib = load()
    audio, lengths, rates, errors = _outputs(len(paths), max_len, np.int16)
    if paths:
        arr = (ctypes.c_char_p * len(paths))(*map(os.fsencode, paths))
        lib.mfcc_read_wavs_i16(arr, len(paths), _ptr(audio, ctypes.c_int16),
                               max_len, _ptr(lengths, ctypes.c_int64),
                               _ptr(rates, ctypes.c_int32),
                               _ptr(errors, ctypes.c_int32), n_threads)
    return audio, lengths, rates, errors
