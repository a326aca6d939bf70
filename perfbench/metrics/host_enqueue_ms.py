"""The median, over the measured window's batches, of the host's time
inside the entry's call (no synchronize): what it takes to enqueue a
batch.  It paces the loop only where it exceeds the device's time."""

import numpy as np


def read(run):
    return float(np.median(run.window.host_ms))
