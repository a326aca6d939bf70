"""The share of the traced window in which no operation runs on the
device, in %."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t["dev_ops"] else None
