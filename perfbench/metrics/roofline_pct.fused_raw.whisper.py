"""fused_raw's share of its roofline in Whisper's front end: the least time
of the window's work (``work_whisper.whisper_work``: the transform of each
frame that reads a sample of its row, the writes of every frame of the
30 s window) at the card's peaks over the kernel's device time.
Matches the __global__ functions ``raw_kernel`` (the direct tile, which
Whisper's n_fft of 400 runs) and ``raw_fft_kernel``; None where neither
ran or the card has no entry in ``work.PEAKS``."""

import numpy as np

from perfbench import readings, work, work_whisper


def read(run):
    secs = readings.device_seconds(
        run, readings.matcher(readings.SPECTRAL["fused_raw"]))
    if secs <= 0:
        return None
    ops, nbytes = work_whisper.whisper_work(
        run.cell.config["features"], np.concatenate(run.traced.lengths))
    least = work.roofline_seconds(ops, nbytes, run.kind)
    return None if least is None else 100.0 * least[0] / secs
