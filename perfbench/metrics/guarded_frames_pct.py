"""The share of the spectral frames whose call took NeMo's additive log
guard, log(e + guard), in the kernel's epilogue: the program's per-batch
counter ``frames_guarded`` (B x T of each such call) over
``frames_computed`` (B x T of every call), in the program spans' traced
pass, in %.  None where the program keeps no ``frames_guarded`` counter or
computed no frame."""

from perfbench import spans


def read(run):
    t = spans.trace(run)
    if t is None or "frames_guarded" not in t["counters"] or \
            not t["counters"].get("frames_computed"):
        return None
    c = t["counters"]
    return 100.0 * c["frames_guarded"] / c["frames_computed"]
