"""Valid frames of the batches of the program spans' traced pass (the
configuration's frame count of each sample length, held on the host) over
the frames the program's spectral stage computed there (its counter
``frames_computed``: B x T of every call, padding included), in %."""

from perfbench import spans
from perfbench.reference import features as ref


def read(run):
    t = spans.trace(run)
    if t is None or not t["counters"].get("frames_computed"):
        return None
    s = ref.Settings(run.cell.config["features"])
    valid = sum(s.num_frames(int(n)) for b in t["lengths"] for n in b)
    return 100.0 * valid / t["counters"]["frames_computed"]
