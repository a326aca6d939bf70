"""Structured run reports and the profiling hook (twin of
``mfcc_tpu/utils/report.py``).

Every corpus run emits a machine-readable JSON report: audio-seconds
processed, wall time, audio-seconds per second (and per device), accuracy
against the oracle where measured, per-stage timings, device and host
counts.  ``n_devices`` is the one device this process computes on (the
port runs one process per GPU); ``n_hosts`` is the ``torch.distributed``
world size, or 1.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field, asdict


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
    t0 = time.perf_counter()
    try:
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
