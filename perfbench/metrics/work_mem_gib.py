"""The device memory the window allocated beyond what was allocated at
its start (the resident corpus): max_memory_allocated less that, in GiB."""


def read(run):
    return (run.window_peak - run.base) / float(1 << 30)
