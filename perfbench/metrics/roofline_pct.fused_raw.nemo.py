"""fused_raw's share of its roofline in NeMo's front end: the least time
of the valid frames' work (``work_nemo.nemo_work``: the transform, bank
and guarded log of each row's L // hop valid frames, the int16 read and
the features written once) at the card's peaks over the kernel's device
time.  Matches the __global__ functions ``raw_kernel`` and
``raw_fft_kernel`` (NeMo's n_fft of 512 runs the latter); None where
neither ran or the card has no entry in ``work.PEAKS``."""

import numpy as np

from perfbench import readings, work, work_nemo


def read(run):
    secs = readings.device_seconds(
        run, readings.matcher(readings.SPECTRAL["fused_raw"]))
    if secs <= 0:
        return None
    ops, nbytes = work_nemo.nemo_work(
        run.cell.config["features"], np.concatenate(run.traced.lengths))
    least = work.roofline_seconds(ops, nbytes, run.kind)
    return None if least is None else 100.0 * least[0] / secs
