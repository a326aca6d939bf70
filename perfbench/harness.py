"""One run of one benchmark cell: set-up, the measured window, the traced
window, the comparison, and the result line.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout.  The cell (``BENCHMARK.json``)
names a configuration (``configs/<name>.json``: the program's entry and
settings, the reference and the limits) and a traffic mix
(``traffic/<name>.json``, read by ``corpus.py``).  Each metric is read by
``metrics/<metric name>.py``; with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer ones.

The loop is closed: batches go back to back, cycling over the corpus, with
at most ``queue_depth`` in flight; before a batch is dispatched the host
waits for the one ``queue_depth`` places back.  A CUDA event before and
after each call times the batch on the device; the host clock around the
call times its enqueue.  The window ends at a synchronize.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that no run may load (the JAX reference package
# and JAX itself), compared whole: the port's name begins with the first.
FORBIDDEN = ("jax", "jaxlib", "flax", "mfcc_tpu")


def process_seconds() -> float:
    """Seconds since this process started (Linux's start time, in clock
    ticks), or since this module was loaded where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        ticks = os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start / ticks
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _LOADED


_LOADED = time.perf_counter()


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: dict            # "end_to_end" / "per_layer": [metric entries]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / cfg["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")

    def mine(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    shown = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if mine(m) and m["moves"] in shown]
    return Cell(name, int(w["chips"]), config, traffic,
                {"end_to_end": e2e, "per_layer": per_layer})


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def program_entry(config: dict):
    """call(x, lengths) -> (features, frame counts, mask) through the
    configuration's entry of the program."""
    def resolve(ref):
        mod, fn = ref.split(":")
        return getattr(importlib.import_module(mod), fn)

    cfg = resolve(config["config_class"])(**config["features"]).validate()
    fn = resolve(config["entry"])
    backend = config["backend"]
    return lambda x, n: fn(x, n, cfg, backend=backend)


class Cuda:
    """The card the run measures, and its clocks and memory counters."""

    platform = "gpu"

    def __init__(self, torch, index: int = 0):
        self.torch = torch
        self.device = torch.device("cuda", index)

    def sync(self):
        self.torch.cuda.synchronize(self.device)

    def event(self):
        return self.torch.cuda.Event(enable_timing=True)

    def allocated(self) -> int:
        return self.torch.cuda.memory_allocated(self.device)

    def reset_peak(self):
        self.torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        return self.torch.cuda.max_memory_allocated(self.device)

    def kind(self) -> str:
        return self.torch.cuda.get_device_name(self.device)

    def activities(self):
        from torch.profiler import ProfilerActivity
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def power_limit(self) -> str:
        try:
            return subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader", f"--id={self.device.index}"],
                capture_output=True, text=True, timeout=60).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            return f"not read ({e})"


@dataclasses.dataclass
class Window:
    batches: int = 0
    audio_s: float = 0.0
    seconds: float = 0.0
    spans_ms: list = dataclasses.field(default_factory=list)
    host_ms: list = dataclasses.field(default_factory=list)
    lengths: list = dataclasses.field(default_factory=list)
    started: float = 0.0


def run_window(corpus, call, dev, seconds: float, queue_depth: int,
               min_batches: int = 0, whole_passes: bool = False,
               sink=None) -> Window:
    """Dispatch batches back to back for ``seconds`` (and at least
    ``min_batches``; with ``whole_passes``, to the end of a pass), at most
    ``queue_depth`` in flight.  sink(ordinal, outputs) sees each batch's
    outputs as they are enqueued."""
    from torch.profiler import record_function
    n_b = len(corpus.batches)
    free = [(dev.event(), dev.event()) for _ in range(queue_depth + 1)]
    ring = collections.deque()
    w = Window()

    def retire():
        e0, e1, _ = ring.popleft()
        with record_function("perfbench.wait"):
            e1.synchronize()
        w.spans_ms.append(e0.elapsed_time(e1))
        free.append((e0, e1))

    dev.sync()
    w.started = t0 = time.perf_counter()
    n = 0
    while (n < min_batches or time.perf_counter() - t0 < seconds
           or (whole_passes and n % n_b)):
        if len(ring) >= queue_depth:
            retire()
        b = corpus.batches[n % n_b]
        e0, e1 = free.pop()
        e0.record()
        h0 = time.perf_counter()
        with record_function("perfbench.batch"):
            out = call(b.x, b.lengths)
        w.host_ms.append(1e3 * (time.perf_counter() - h0))
        e1.record()
        if sink is not None:
            sink(n, out)
        ring.append((e0, e1, out))
        w.audio_s += corpus.audio_s(b)
        w.lengths.append(b.lengths_host)
        n += 1
    while ring:
        retire()
    dev.sync()
    w.seconds = time.perf_counter() - t0
    w.batches = n
    return w


def keep_slots(corpus, call, dev, queue_depth: int):
    """Warm every batch shape once (one pass), and allocate the device
    buffers that keep the checked batches' outputs: {ordinal: buffers}."""
    import torch
    n_b = len(corpus.batches)
    shapes = {}

    def note(n, out):
        if n in {o % n_b for o in corpus.check}:
            shapes[n] = [(t.shape, t.dtype) for t in out]

    run_window(corpus, call, dev, 0.0, queue_depth, min_batches=n_b, sink=note)
    return {o: [torch.empty(s, dtype=d, device=dev.device)
                for s, d in shapes[o % n_b]] for o in corpus.check}


def device_trace(prof):
    """(device operations [(name, start_us, end_us)], host operations
    [(name, start_us, end_us, thread)]) of a profiler run.  The device's
    operations are its kernels, copies and fills: the profiler's copies of
    record_function ranges on the device's timeline (user annotations,
    named as on the host) are left out."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    ranges = {e.name for e in events if e.device_type != DeviceType.CUDA
              and getattr(e, "is_user_annotation", False)}
    dev_ops, host_ops = [], []
    for e in events:
        r = e.time_range
        if e.device_type != DeviceType.CUDA:
            host_ops.append((e.name, r.start, r.end, e.thread))
        elif not (getattr(e, "is_user_annotation", False) or e.name in ranges
                  or e.name.startswith("perfbench.")):
            dev_ops.append((e.name, r.start, r.end))
    return dev_ops, host_ops


def busy_intervals(ops, lo: float, hi: float) -> list:
    """The union of the operations' intervals inside [lo, hi], merged."""
    merged = []
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def breakdown(dev_ops, host_ops, span, busy) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the innermost host operation running at their middle."""
    by_name = collections.Counter()
    for name, s, e in dev_ops:
        by_name[name[:160]] += (e - s) * 1e-6
    edges = [span[0]] + [x for iv in busy for x in iv] + [span[1]]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    named = []
    for length, g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inside = [h for h in host_ops if h[1] <= mid <= h[2]
                  and not h[0].startswith("perfbench.trace")]
        name = (max(inside, key=lambda h: h[1])[0] if inside
                else "host outside any recorded operation")
        named.append([name[:160], length * 1e-6])
    return {"device_ops": [[n, s] for n, s in by_name.most_common(10)],
            "idle_gaps": named}


def traced(corpus, call, dev, seconds: float, queue_depth: int):
    """A window under torch.profiler, in whole passes: (window, trace)."""
    from torch.profiler import profile, record_function
    with profile(activities=dev.activities()) as prof:
        with record_function("perfbench.trace"):
            w = run_window(corpus, call, dev, seconds, queue_depth,
                           whole_passes=True)
    dev_ops, host_ops = device_trace(prof)
    spans = [h for h in host_ops if h[0] == "perfbench.trace"]
    lo, hi = spans[0][1], spans[0][2]
    dev_ops = [o for o in dev_ops if o[2] > lo and o[1] < hi]
    busy = busy_intervals(dev_ops, lo, hi)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    return w, {"dev_ops": dev_ops, "busy_s": busy_s, "window_s": w.seconds,
               "breakdown": breakdown(dev_ops, host_ops, (lo, hi), busy)}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def measure(cell: Cell, seed: int, seconds: float, dev, wrap=None,
            started: float | None = None) -> argparse.Namespace:
    """Set-up and the measured window of one run: the corpus, the warm
    pass, the window, and the checked batches' outputs kept on the device.
    wrap, if given, wraps the program's call (a test's planted fault)."""
    from . import corpus as corpus_mod
    if started is None:
        started = time.perf_counter() - process_seconds()
    call = program_entry(cell.config)
    if wrap is not None:
        call = wrap(call)
    depth = int(cell.traffic["queue_depth"])
    corpus = corpus_mod.build(cell.traffic, seed, dev.device)
    slots = keep_slots(corpus, call, dev, depth)
    setup_peak = dev.peak()

    def sink(n, out):
        for dst, src in zip(slots.get(n, ()), out):
            dst.copy_(src)

    dev.sync()
    base = dev.allocated()
    dev.reset_peak()
    w = run_window(corpus, call, dev, seconds, depth,
                   min_batches=max(corpus.check) + 1, sink=sink)
    n_b = len(corpus.batches)
    order = sorted(slots)
    return argparse.Namespace(
        cell=cell, call=call, corpus=corpus, window=w, base=base,
        setup_s=w.started - started, window_peak=dev.peak(),
        setup_peak=setup_peak, kind=dev.kind(),
        checked=[corpus.batches[o % n_b] for o in order],
        kept=[slots[o] for o in order], ordinals=order)


def run(cell: Cell, seed: int, seconds: float, trace: bool, dev,
        wrap=None, started: float | None = None) -> tuple:
    """One run of ``cell`` on ``dev``: -> (result, check lines)."""
    from . import check
    r = measure(cell, seed, seconds, dev, wrap, started)
    w = r.window
    device = {"platform": dev.platform, "kind": r.kind, "count": cell.chips,
              "memory_peak_bytes": int(max(r.setup_peak, r.window_peak))}
    extra = {}
    if trace:
        r.traced, r.trace = traced(r.corpus, r.call, dev,
                                   float(cell.traffic["trace_seconds"]),
                                   int(cell.traffic["queue_depth"]))
        device.update(busy_s=r.trace["busy_s"], window_s=r.trace["window_s"])
        extra["breakdown"] = r.trace["breakdown"]
    del r.call
    values = {}
    for m in cell.metrics["per_layer" if trace else "end_to_end"]:
        v = reader(m["name"])(r)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device["power_limit"] = dev.power_limit()
    numbers, checked, failed = check.compare(cell.config, r.checked, r.kept)
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package loaded: {bad}")
    result = {"correct": check.correct(numbers),
              "attempted": int(sum(len(x) for x in w.lengths)),
              "failed": failed, "metrics": values, "device": device,
              **extra,
              "info": {"batches": w.batches, "window_s": w.seconds,
                       "fill": r.corpus.fill, "checked_utterances": checked,
                       "checked_ordinals": r.ordinals},
              "checks": {n: {"value": v, "limit": lim}
                         for n, (v, lim) in numbers.items()}}
    lines = [f"check {n} {v!r} limit {lim!r}"
             for n, (v, lim) in numbers.items()]
    return result, lines


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv) -> int:
    started = time.perf_counter() - process_seconds()
    args = parse(argv)
    try:
        cell = load_cell(args.workload)
        import torch
        chips = cell.chips
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"perfbench: needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        torch.set_num_threads(min(4, os.cpu_count() or 1))
        result, lines = run(cell, args.seed, args.seconds, bool(args.trace),
                            Cuda(torch), started=started)
    except Exception:   # the run's boundary: report, print no result
        traceback.print_exc()
        return 1
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
