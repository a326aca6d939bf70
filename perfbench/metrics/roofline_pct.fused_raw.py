"""fused_raw's share of its roofline: the least time of the valid frames'
work (``work.spectral_work``) at the card's peaks over the kernel's device
time.  Matches the __global__ functions ``raw_fft_kernel`` (the FFT tiles)
and ``raw_kernel`` (direct)."""

from perfbench import readings


def read(run):
    return readings.roofline_pct(run, "fused_raw")
