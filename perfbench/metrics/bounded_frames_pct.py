"""The share of the spectral frames whose call handed the mixed-radix tile
the rows' lengths, so that it skips the frames wholly in the rows' zero
padding: the program's per-batch counter ``frames_bounded`` (B x T of each
such call) over ``frames_computed`` (B x T of every call), in the program
spans' traced pass, in %.  None where the program keeps no
``frames_bounded`` counter or computed no frame."""

from perfbench import spans


def read(run):
    t = spans.trace(run)
    if t is None or "frames_bounded" not in t["counters"] or \
            not t["counters"].get("frames_computed"):
        return None
    c = t["counters"]
    return 100.0 * c["frames_bounded"] / c["frames_computed"]
