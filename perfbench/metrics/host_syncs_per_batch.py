"""Runtime calls that block the host (``spans.is_sync``: a synchronize,
or a copy without ``Async``) inside the program's ``feat.batch`` span, a
batch, in the program spans' traced pass (``perfbench/spans.py``); the
harness's own waits lie outside the span."""

from perfbench import spans


def read(run):
    t = spans.trace(run)
    if t is None:
        return None
    n = sum(1 for _, chain in t["syncs"] if "feat.batch" in chain)
    return n / t["batches"]
