"""A stand-in for the card in CPU tests: host clocks for the CUDA events
and no memory counters.  The harness never falls back to it; the tests
hand it over in place of ``harness.Cuda``."""

import time

import torch

from perfbench import harness


class Event:
    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


class Host:
    platform = "cpu"
    device = torch.device("cpu")

    def sync(self):
        pass

    def event(self):
        return Event()

    def allocated(self):
        return 0

    def reset_peak(self):
        pass

    def peak(self):
        return 1

    def kind(self):
        return "cpu"

    def activities(self):
        from torch.profiler import ProfilerActivity
        return [ProfilerActivity.CPU]

    def power_limit(self):
        return "cpu"


def tiny(traffic: dict, batch: int = 4, utterances: int = 12) -> dict:
    """The traffic at a size a CPU test holds: 1-3 s utterances."""
    return dict(traffic, utterances=utterances, batch=batch,
                lengths_s={"edges": [1, 2, 3], "weights": [1, 2]},
                check_batches=2, trace_seconds=0.01)


def tiny_cell(name: str, **kw):
    cell = harness.load_cell(name)
    cell.traffic = tiny(cell.traffic, **kw)
    return cell
