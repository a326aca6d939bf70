"""Device kernels (copies and fills excluded) a batch call, counted in the
traced window's profile."""

from perfbench import readings


def read(run):
    n = sum(1 for name, _, _ in run.trace["dev_ops"]
            if not readings.is_copy(name))
    return n / run.traced.batches if n else None
