"""The share of the spectral frames that a direct DFT tile computed: the
program's per-batch counter ``frames_direct`` (B x T of each spectral call
that ran a direct tile, in any entry) over ``frames_computed`` (B x T of
every call), in the program spans' traced pass, in %.  None where the
program keeps no ``frames_direct`` counter or computed no frame."""

from perfbench import spans


def read(run):
    t = spans.trace(run)
    if t is None or "frames_direct" not in t["counters"] or \
            not t["counters"].get("frames_computed"):
        return None
    c = t["counters"]
    return 100.0 * c["frames_direct"] / c["frames_computed"]
