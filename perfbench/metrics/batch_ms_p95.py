"""The 95th percentile, over every batch of the window, of the device time
between the CUDA events recorded before and after the batch's call."""

import numpy as np


def read(run):
    return float(np.percentile(run.window.spans_ms, 95))
