"""Device ms a batch of every operation outside the spectral kernels
(``readings.SPECTRAL``): the int16 cast, frame counts, deltas, mask and
zeroing."""

from perfbench import readings


def read(run):
    spectral = [readings.matcher(p) for p in readings.SPECTRAL.values()]
    secs = readings.device_seconds(
        run, lambda name: not any(m(name) for m in spectral))
    return 1e3 * secs / run.traced.batches if run.trace["dev_ops"] else None
