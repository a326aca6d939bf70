"""Structured run reports and the profiling hook (twin of
``mfcc_tpu/utils/report.py``).

Every corpus run emits a machine-readable JSON report: audio-seconds
processed, wall time, audio-seconds per second (and per device), accuracy
against the oracle where measured, per-stage timings, device and host
counts.  ``n_devices`` is the one device this process computes on (the
port runs one process per GPU); ``n_hosts`` is the ``torch.distributed``
world size, or 1.

The program's tracing lives here too.  :func:`span` names a stage of the
program in a ``torch.profiler`` trace, on the clock the profiler gives
the card's operations, and costs one flag read when no profiler records.
:func:`counters` holds what the program counts where the work happens:
per batch (kept only while a profiler records) the frames the spectral
stage computed, those a direct DFT tile computed, those of the calls
that handed the mixed-radix tile the rows' lengths, and those of the calls
whose log took the additive guard; once per process
(always kept) the host seconds of the package's import, the kernels'
builds and loads, and the constants built.  :func:`launched` records every kernel launch, always, apart from
the counters: :func:`launches` reads the counts by kernel and by tile and
projection, :func:`last_shape` the launch shape a C entry planned.
:func:`cuda_ms` times a call on the card with CUDA events.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from dataclasses import dataclass, field, asdict

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

# Counted only while a profiler records: spectral frames computed (B x T of
# every call, padded frames included), and those of the calls that ran a
# direct DFT tile, the mixed-radix tile with the rows' lengths, or the
# additive log guard (``ops/kernels/_spectral.launch_spectral``).
PER_BATCH = ("frames_computed", "frames_direct", "frames_bounded",
             "frames_guarded")
# Counted once per process, always: host seconds of importing the package's
# modules (torch excluded); of the kernels' nvcc builds and loads
# (``ops/kernels/_build.load``); of the spectral constants built and
# uploaded (the misses of the launch path's constant caches).
SETUP = ("import_s", "build_s", "consts_s")
_COUNTERS = dict.fromkeys(PER_BATCH + SETUP, 0)
_OFF = contextlib.nullcontext()
_SPANS = set()   # the names of the spans entered while a profiler recorded
# kernel launches, always kept: (kernel, tile, projection) -> launches, and
# kernel -> the launch shape its C entry last planned
_LAUNCHES = collections.Counter()
_SHAPES = {}


def span(name: str):
    """A context manager: a host range ``name`` in the trace while a
    profiler records (the flag ``torch.profiler.profile`` sets on entry
    and clears on exit), else a shared no-op.  The range is torch's
    ``_RecordFunctionFast``, a ninth of ``record_function``'s host cost:
    an operator range, not a user annotation, so the trace has no copy of
    it on the device's timeline."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    _SPANS.add(name)
    return _RecordFunctionFast(name)


def span_names() -> frozenset:
    """The names of every span entered while a profiler recorded: what
    tells the program's ranges from torch's own operators in a trace."""
    return frozenset(_SPANS)


def count(name: str, n: int) -> None:
    """Add n to a per-batch counter while a profiler records."""
    if _profiler._is_profiler_enabled:
        _COUNTERS[name] += n


@contextlib.contextmanager
def timed(seconds: str):
    """Add the block's host seconds to counter ``seconds``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _COUNTERS[seconds] += time.perf_counter() - t0


def counters() -> dict:
    """A copy of every counter."""
    return dict(_COUNTERS)


def reset() -> None:
    """Zero the per-batch counters (the set-up ones are the process's)."""
    for k in PER_BATCH:
        _COUNTERS[k] = 0


def launched(kernel: str, tile: str | None = None,
             projection: str | None = None, shape: dict | None = None) -> None:
    """Record one launch of ``kernel`` (on ``tile``, with ``projection``;
    ``shape``: the launch shape its C entry planned)."""
    _LAUNCHES[kernel, tile, projection] += 1
    if shape is not None:
        _SHAPES[kernel] = shape


def launches() -> collections.Counter:
    """The launches since :func:`reset_launches`, by kernel, by (kernel,
    tile) and by (kernel, projection); a key never launched reads 0."""
    out = collections.Counter()
    for (kernel, tile, projection), n in _LAUNCHES.items():
        out[kernel] += n
        for k in (tile, projection):
            if k is not None:
                out[kernel, k] += n
    return out


def last_shape(kernel: str) -> dict | None:
    """The launch shape of ``kernel``'s last launch, as its C entry planned
    it (None before one)."""
    return _SHAPES.get(kernel)


def reset_launches() -> None:
    """Forget every launch and launch shape."""
    _LAUNCHES.clear()
    _SHAPES.clear()


def cuda_ms(fn, warmup: int = 3, calls: int = 30,
            group: int = 5) -> list[float]:
    """ms a call of fn on the card: ``calls // group`` samples (at least
    one), each the mean over ``group`` back-to-back calls between two CUDA
    events, so that the host enqueues ahead of the device, after
    ``warmup`` untimed calls and a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(max(1, calls // group)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(group):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / group)
    return out


@dataclass
class RunReport:
    config_hash: str = ""
    n_utterances: int = 0
    audio_seconds: float = 0.0
    wall_seconds: float = 0.0
    n_devices: int = 0
    n_hosts: int = 0
    max_abs_error: float | None = None
    # the appended pitch columns' own contract quantity (norm <= 3e-4),
    # reported apart from the feature tolerance above
    max_abs_error_pitch: float | None = None
    stage_seconds: dict = field(default_factory=dict)

    @property
    def audio_seconds_per_second(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds else 0.0

    @property
    def audio_seconds_per_second_per_chip(self) -> float:
        n = max(self.n_devices, 1)
        return self.audio_seconds_per_second / n

    def finalize(self) -> dict:
        d = asdict(self)
        d["audio_seconds_per_second"] = self.audio_seconds_per_second
        d["audio_seconds_per_second_per_chip"] = (
            self.audio_seconds_per_second_per_chip)
        return d

    def dump(self, path: str | None = None) -> str:
        s = json.dumps(self.finalize(), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s + "\n")
        return s


@contextlib.contextmanager
def stage_timer(report: RunReport, name: str):
    """Add the block's host seconds to ``report.stage_seconds[name]``; a
    :func:`span` of the stage's name covers it."""
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        report.stage_seconds[name] = (
            report.stage_seconds.get(name, 0.0) + time.perf_counter() - t0)


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None, cuda: bool = False,
                  name: str = "trace.0.json"):
    """``torch.profiler`` over the block, its Chrome trace written to
    ``trace_dir/name``; CPU activity, and the card's with ``cuda``.  No-op
    when trace_dir is None."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, name))
