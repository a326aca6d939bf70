"""Seconds from the process's start to the first timed batch: imports,
the CUDA context, the kernels' build or load, the corpus, the warm pass."""


def read(run):
    return run.setup_s
