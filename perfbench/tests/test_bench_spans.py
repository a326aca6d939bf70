"""The program's spans and counters as the benchmark reads them
(``perfbench/spans.py`` and the five readers over it), on made-up
traces, and one window of the program's spans traced on the CPU."""

import types

import numpy as np
import pytest

from perfbench import corpus as corpus_mod, harness, spans
from perfbench.reference import features as ref
from perfbench.tests.hostdev import Host, tiny_cell

CAST = "void at::native::vectorized_elementwise_kernel<4, MulFunctor<float>>"
KERNEL = "void (anonymous namespace)::raw_fft_kernel<32, double>(spectral::FftParams<double>)"
DELTA = "void at::native::CatArrayBatchedCopy<float>"


def _host():
    """Two batches of made-up host ranges: (name, start, end, correlation
    id, is annotation); launches carry the ids of their device ops."""
    ops = []
    for b, t in enumerate((0.0, 1000.0)):
        ops += [("feat.batch", t, t + 900, 0, True),
                ("feat.cast", t + 10, t + 100, 0, True),
                ("aten::mul", t + 20, t + 90, 0, False),
                ("cudaLaunchKernel", t + 30, t + 40, 10 * b + 1, False),
                ("feat.spectral", t + 110, t + 400, 0, True),
                ("fused_raw", t + 150, t + 390, 0, True),
                ("cudaLaunchKernel", t + 200, t + 210, 10 * b + 2, False),
                ("feat.deltas", t + 410, t + 800, 0, True),
                ("cudaLaunchKernel", t + 420, t + 430, 10 * b + 3, False),
                ("cudaMemcpyAsync", t + 500, t + 510, 10 * b + 4, False),
                ("cudaStreamSynchronize", t + 510, t + 600, 10 * b + 5,
                 False),
                ("perfbench.wait", t + 905, t + 990, 0, True),
                ("cudaEventSynchronize", t + 910, t + 980, 10 * b + 6,
                 False)]
    return ops


def _dev():
    ops = []
    for b, t in enumerate((0.0, 1000.0)):
        ops += [(CAST, t + 50, t + 150, 10 * b + 1),
                (KERNEL, t + 250, t + 650, 10 * b + 2),
                (DELTA, t + 650, t + 700, 10 * b + 3),
                ("Memcpy HtoD (Pageable -> Device)", t + 700, t + 701,
                 10 * b + 4)]
    return ops


def _run(tied, frames_computed=None, lengths=None, dev_ops=True):
    """A run whose program spans' window is already read."""
    cfg = harness.load_json(harness.HERE / "configs"
                            / "kaldi-fbank80-deltas-16k.json")
    t = None if tied is None else dict(
        tied, batches=2, lengths=lengths or [],
        counters={"frames_computed": frames_computed or 0})
    return types.SimpleNamespace(
        spans=t, trace={"dev_ops": [("k", 0, 1)] if dev_ops else []},
        cell=types.SimpleNamespace(config=cfg))


def test_enclosing_gives_each_time_its_chain():
    s = [("a", 0, 100), ("b", 10, 50), ("c", 20, 30), ("d", 60, 90),
         ("a", 200, 300)]
    got = spans.enclosing(s, [25, 5, 40, 55, 70, 150, 250, 300, 301])
    assert got == [("a", "b", "c"), ("a",), ("a", "b"), ("a",), ("a", "d"),
                   (), ("a",), ("a",), ()]


def test_device_ops_go_to_the_innermost_span_that_launched_them():
    t = spans.tie(_host(), _dev())
    d = t["span_device_s"]
    assert d["feat.cast"] == pytest.approx(200e-6)
    # the kernel's span nests in feat.spectral and takes its time
    assert d["fused_raw"] == pytest.approx(800e-6) and "feat.spectral" not in d
    # the copy launched by the deltas' cudaMemcpyAsync is the deltas'
    assert d["feat.deltas"] == pytest.approx(102e-6)
    assert t["untied_s"] == 0
    r = _run(t)
    assert harness.reader("cast_ms")(r) == pytest.approx(0.1)
    assert harness.reader("deltas_ms")(r) == pytest.approx(0.051)


def test_an_op_whose_launch_is_missing_is_untied():
    t = spans.tie(_host(), _dev() + [("late", 2000.0, 2010.0, 99)])
    assert t["untied_s"] == pytest.approx(10e-6)
    assert spans.UNTIED not in t["span_device_s"]


def test_syncs_count_inside_feat_batch_only():
    t = spans.tie(_host(), _dev())
    names = [n for n, c in t["syncs"]]
    # the harness's own wait (cudaEventSynchronize) lies outside feat.batch
    assert names.count("cudaStreamSynchronize") == 2
    assert names.count("cudaEventSynchronize") == 2
    assert harness.reader("host_syncs_per_batch")(_run(t)) == 1.0


def test_is_sync():
    assert spans.is_sync("cudaStreamSynchronize")
    assert spans.is_sync("cudaMemcpy") and spans.is_sync("cudaMemcpy2D")
    assert not spans.is_sync("cudaMemcpyAsync")
    assert not spans.is_sync("cudaLaunchKernel")


def test_a_span_that_launched_nothing_reads_none():
    host = [h for h in _host() if h[0] != "feat.deltas"]
    dev = [o for o in _dev() if o[0] != DELTA]
    t = spans.tie(host, dev)
    assert harness.reader("deltas_ms")(_run(t)) is None
    assert harness.reader("cast_ms")(_run(t)) == pytest.approx(0.1)


def test_nothing_to_read_reads_none():
    r = _run(None)
    for name in ("cast_ms", "deltas_ms", "host_syncs_per_batch",
                 "spectral_fill_pct"):
        assert harness.reader(name)(r) is None
    assert harness.reader("setup_program_s")(_run(None, dev_ops=False)) is None


def test_spectral_fill_is_valid_over_computed_frames():
    # 25 ms frames, 10 ms hop at 16 kHz: 1 s has 98 frames, 0.5 s 48
    t = spans.tie(_host(), _dev())
    r = _run(t, frames_computed=4 * 98,
             lengths=[np.array([16000, 8000]), np.array([16000, 16000])])
    assert harness.reader("spectral_fill_pct")(r) == pytest.approx(
        100 * (98 + 48 + 98 + 98) / (4 * 98))


def test_setup_program_s_sums_the_programs_setup_counters(monkeypatch):
    import mfcc_tpu_torch.models.mfcc  # noqa: F401  (the program, loaded)
    rep = spans.program_report()
    monkeypatch.setattr(rep, "counters", lambda: {
        "import_s": 0.25, "build_s": 1.5, "consts_s": 0.125,
        "frames_computed": 0})
    assert harness.reader("setup_program_s")(_run(None)) == 1.875


def test_a_window_of_the_programs_spans_on_the_cpu():
    """``spans.collect`` over a tiny corpus with the CPU stand-in: the
    counters of its own window and the program's stage spans around every
    sync-free batch (no device, so nothing to tie)."""
    cell = tiny_cell("fbank80d.libri_sorted")
    corpus = corpus_mod.build(cell.traffic, 7, Host.device)
    t = spans.collect(corpus, harness.program_entry(cell.config), Host(),
                      int(cell.traffic["queue_depth"]))
    assert t["batches"] == len(corpus.batches)    # one pass
    settings = ref.Settings(cell.config["features"])
    assert t["counters"]["frames_computed"] == sum(
        b.x.shape[0] * settings.num_frames(b.x.shape[1])
        for b in corpus.batches)
    assert t["span_device_s"] == {} and t["syncs"] == []
    r = types.SimpleNamespace(spans=t, cell=cell, trace={"dev_ops": [1]})
    fill = harness.reader("spectral_fill_pct")(r)
    assert 100 * corpus.fill - 5 < fill <= 100


def test_breakdown_names_a_gap_by_the_program_stage():
    """An idle gap whose middle falls in the program's own code between
    operations is named by the innermost program span there."""
    import torch
    from torch.profiler import profile
    from mfcc_tpu_torch import LOGMEL80
    from mfcc_tpu_torch.models import logmel
    x = (torch.randn(2, 8000) * 3000).to(torch.int16)
    with profile() as prof:
        logmel.log_mel_batch(x, torch.tensor([8000, 6000]), LOGMEL80)
    _, host_ops = harness.device_trace(prof)
    frames = next(h for h in host_ops if h[0] == "feat.frames")
    inside = harness.busy_intervals(
        [h[:3] for h in host_ops if h is not frames
         and frames[1] <= h[1] and h[2] <= frames[2]], *frames[1:3])
    edges = [frames[1]] + [x for iv in inside for x in iv] + [frames[2]]
    free = max((edges[i + 1] - edges[i], edges[i])
               for i in range(0, len(edges) - 1, 2))
    assert free[0] > 0
    mid = free[1] + free[0] / 2
    lo, hi = min(h[1] for h in host_ops), max(h[2] for h in host_ops)
    busy = [[lo, mid - 1e-3], [mid + 1e-3, hi]]
    b = harness.breakdown([], host_ops, (lo, hi), busy)
    assert b["idle_gaps"][0][0] == "feat.frames"


@pytest.mark.cuda
def test_the_programs_metrics_on_the_card():
    """A short traced run of the deltas cell on the card reads all five."""
    import json
    import subprocess
    import sys
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "fbank80d.libri_sorted", "--seed", "2147483661", "--seconds", "1",
         "--trace", "1"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    m = {k: v["value"] for k, v in
         json.loads(out.stdout.strip().splitlines()[-1])["metrics"].items()}
    assert m["cast_ms"] > 0 and m["deltas_ms"] > m["cast_ms"]
    assert m["host_syncs_per_batch"] >= 0 and m["setup_program_s"] > 0
    assert 90 < m["spectral_fill_pct"] <= 100
    # the cast and the deltas are part of the post ops; the mask is the rest
    assert m["cast_ms"] + m["deltas_ms"] < m["post_ms"]
