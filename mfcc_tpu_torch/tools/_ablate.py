"""What the kernel measurement tools (``ablate_fft_tile``,
``ablate_pitch``, ``roofline``) share: copies of ``csrc/`` with text edits
applied, their nvcc builds, and CUDA-event timing of back-to-back calls."""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

from ..ops.kernels import _build


def variant_sources(variants: dict, name: str) -> dict:
    """{file name: text} of csrc/ with ``variants[name]``'s edits, a list
    of (file in csrc/, text, replacement), applied; raises if an edit no
    longer matches the sources exactly once."""
    files = {p.name: p.read_text() for p in _build.CSRC.iterdir()}
    for fname, old, new in variants[name]:
        if files[fname].count(old) != 1:
            raise ValueError(f"variant {name}: edit does not match {fname}")
        files[fname] = files[fname].replace(old, new)
    return files


def variant_dir(tool: str, name: str) -> Path:
    """``build/<tool>/<name>/``, beside the port's own build directory."""
    return _build.BUILD_DIR.parent / tool / name


def write_variants(tool: str, variants: dict, names) -> None:
    """Write each named variant's sources into a fresh variant_dir."""
    for name in names:
        d = variant_dir(tool, name)
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for fname, text in variant_sources(variants, name).items():
            (d / fname).write_text(text)


def nvcc(source: Path, so: Path, what: str) -> ctypes.CDLL:
    """Build ``source`` into the shared library ``so`` with the port's nvcc
    flags and load it; raises with nvcc's errors."""
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(source)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{what}: nvcc failed\n{proc.stderr}")
    return ctypes.CDLL(str(so))


def ms(fn, calls: int) -> float:
    """Milliseconds a call of ``fn``: CUDA events around ``calls``
    back-to-back calls, after three warm-up calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
