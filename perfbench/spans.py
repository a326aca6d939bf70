"""The program's own spans and counters, read in a traced pass of their
own.

The program (``mfcc_tpu_torch/utils/report``) names its stages with
spans, host ranges in the trace while a profiler records (``feat.batch``
over ``feat.cast``, ``feat.frames``, ``feat.spectral``, ``feat.deltas``,
``feat.mask``; each kernel wrapper's span inside; their names in
``span_names()``) and keeps counters (``counters()``).  :func:`trace` runs, once a run and after the harness's
traced window, one further pass over every batch under ``torch.profiler``
with the program's per-batch counters reset before it, and ties each
device operation to the innermost program span whose host range launched
it: the operation's launch is the runtime call that shares its
correlation id, on the profiler's one clock.  Host runtime calls are tied
to their spans the same way, by their start.

A program without ``report.counters`` (before the spans existed) and a
run whose traced window saw no device operation (the CPU stand-in) read
None: there is nothing of the program's to read.
"""

from __future__ import annotations

import collections
import sys

from . import harness

REPORT = "mfcc_tpu_torch.utils.report"
# Runtime calls that block the host until the device has caught up.
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
UNTIED = "(no program span)"


def program_report():
    """The program's report module, where it keeps counters; else None."""
    mod = sys.modules.get(REPORT)
    return mod if hasattr(mod, "counters") else None


def is_sync(name: str) -> bool:
    """A runtime call that blocks the host: a synchronize, or a copy
    without ``Async`` (``cudaMemcpy``, ``cudaMemcpy2D``, ...)."""
    return name in SYNCS or (name.startswith("cudaMemcpy")
                             and "Async" not in name)


def is_program_span(name: str) -> bool:
    return not name.startswith("perfbench.")


def enclosing(spans, times) -> list:
    """For each time, the chain of spans (outermost first) whose range
    holds it: spans [(name, start, end)] nest as one thread's ranges do.
    A sweep over both sorted: O((spans + times) log)."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    out = [()] * len(times)
    stack, j = [], 0
    for i in order:
        t = times[i]
        while j < len(spans) and spans[j][1] <= t:
            while stack and stack[-1][2] < spans[j][1]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out[i] = tuple(s[0] for s in stack)
    return out


def tie(host_ops, dev_ops) -> dict:
    """Tie the device's operations and the host's runtime calls to the
    program's spans.

    host_ops: [(name, start_us, end_us, correlation id, is a span)];
    dev_ops: [(name, start_us, end_us, correlation id)], annotations left
    out.  -> {"span_device_s": {innermost program span: device seconds},
    "syncs": [(runtime call, its chain of program spans)], "untied_s":
    device seconds whose launch was not found}."""
    spans = [(n, s, e) for n, s, e, _, ann in host_ops
             if ann and is_program_span(n)]
    launches = {c: s for n, s, _, c, ann in host_ops
                if not ann and n.startswith("cu")}
    tied = [(o, launches[o[3]]) for o in dev_ops if o[3] in launches]
    chains = enclosing(spans, [t for _, t in tied])
    by_span = collections.Counter()
    for ((_, s, e, _), _), chain in zip(tied, chains):
        by_span[chain[-1] if chain else UNTIED] += (e - s) * 1e-6
    syncs = [(n, s) for n, s, _, _, ann in host_ops if not ann and is_sync(n)]
    sync_chains = enclosing(spans, [s for _, s in syncs])
    return {"span_device_s": dict(by_span),
            "syncs": [(n, c) for (n, _), c in zip(syncs, sync_chains)],
            "untied_s": sum(e - s for n, s, e, c in dev_ops
                            if c not in launches) * 1e-6}


def events(prof, names=frozenset()):
    """(host ops, device ops) of a profiler run in :func:`tie`'s form; a
    host op is a program span where its name is one of ``names`` (the
    program's ``report.span_names()``) or it is a user annotation; the
    device-side copies of annotations are left out, as
    ``harness.device_trace`` leaves them out."""
    from torch.autograd import DeviceType
    evs = list(prof.events())
    ranges = {e.name for e in evs if e.device_type != DeviceType.CUDA
              and getattr(e, "is_user_annotation", False)}
    host, dev = [], []
    for e in evs:
        r = e.time_range
        ann = bool(getattr(e, "is_user_annotation", False))
        if e.device_type != DeviceType.CUDA:
            host.append((e.name, r.start, r.end, e.id, ann or e.name in names))
        elif not (ann or e.name in ranges):
            dev.append((e.name, r.start, r.end, e.id))
    return host, dev


def collect(corpus, call, dev, queue_depth: int) -> dict:
    """One traced pass over every batch (``harness.run_window``) with the
    program's per-batch counters reset before it: {"batches", "lengths"
    (the pass's sample lengths, host), "counters", and :func:`tie`'s
    keys}.  One pass weighs each batch shape once, as the harness's whole
    passes do, and keeps the trace small."""
    from torch.profiler import profile, record_function
    rep = program_report()
    rep.reset()
    with profile(activities=dev.activities()) as prof:
        with record_function("perfbench.spans"):
            w = harness.run_window(corpus, call, dev, 0.0, queue_depth,
                                   min_batches=len(corpus.batches))
    out = {"batches": w.batches, "lengths": w.lengths,
           "counters": rep.counters()}
    out.update(tie(*events(prof, rep.span_names())))
    return out


def trace(run):
    """:func:`collect` over the run's corpus and program, once a run (kept
    as ``run.spans``); None where there is nothing of the program's to
    read (see the module's note)."""
    if "spans" not in vars(run):
        run.spans = None
        if program_report() is not None and run.trace["dev_ops"]:
            import torch
            x = run.corpus.batches[0].x
            run.spans = collect(
                run.corpus, harness.program_entry(run.cell.config),
                harness.Cuda(torch, x.device.index),
                int(run.cell.traffic["queue_depth"]))
    return run.spans


def span_ms(run, name: str):
    """Device ms a batch of the operations launched inside span ``name``
    (innermost), or None where the span launched none."""
    t = trace(run)
    if t is None or not t["span_device_s"].get(name):
        return None
    return 1e3 * t["span_device_s"][name] / t["batches"]
