"""The program's own set-up, host seconds it counts once a process
(``mfcc_tpu_torch/utils/report.counters``): its import, the kernels'
nvcc builds and library loads, and the spectral constants built and
uploaded.  None where the traced window saw no device operation (the CPU
stand-in builds no kernel) or the program keeps no such counters."""

from perfbench import spans


def read(run):
    rep = spans.program_report()
    if rep is None or not run.trace["dev_ops"]:
        return None
    c = rep.counters()
    return c["import_s"] + c["build_s"] + c["consts_s"]
