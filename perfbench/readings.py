"""What the metric readers (``metrics/<name>.py``) share: device
operations of the traced window by name, and a spectral kernel's share of
its roofline.

A reader takes the run (``harness.run``'s namespace: ``window``, the
measured window; ``traced`` and ``trace``, the traced window and its
device operations; ``corpus``, ``cell``, ``kind``) and returns a number,
or None where it finds nothing to read.
"""

from __future__ import annotations

import re

import numpy as np

from . import work

# The __global__ functions of the program's spectral kernels, both tiles
# each (``mfcc_tpu_torch/ops/kernels/csrc/fused_*.cu``).
SPECTRAL = {
    "fused_raw_dit": r"raw_dit_(fft_)?kernel",
    "fused_raw": r"raw_(fft_)?kernel",
    "fused_mfcc": r"mfcc_(fft_)?kernel",
    "fused_dit": r"dit_(fft_)?kernel",
}


def matcher(pattern: str):
    """A test of a demangled kernel name against a whole identifier."""
    rx = re.compile(rf"(?<![A-Za-z0-9_]){pattern}(?![A-Za-z0-9_])")
    return lambda name: rx.search(name) is not None


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def device_seconds(run, test=lambda name: True) -> float:
    """Seconds of device operations in the traced window that pass test."""
    return sum(e - s for n, s, e in run.trace["dev_ops"] if test(n)) * 1e-6


def roofline_pct(run, kernel: str):
    """The kernel's least time (``work.spectral_work`` over the valid frames
    of the traced batches) over its device time, in %; None where it did
    not run or the card has no entry in ``work.PEAKS``."""
    secs = device_seconds(run, matcher(SPECTRAL[kernel]))
    if secs <= 0:
        return None
    config = run.cell.config
    ops, nbytes = work.spectral_work(
        config["features"], config["output"] == "cepstra",
        np.concatenate(run.traced.lengths))
    least = work.roofline_seconds(ops, nbytes, run.kind)
    return None if least is None else 100.0 * least[0] / secs
