"""The port's tracing (``mfcc_tpu_torch/utils/report``): spans that cost a
flag read without a profiler, the batch entry's stage spans under one,
the per-batch counter kept only while a profiler records, and the set-up
counters (import, kernel builds and loads, constants)."""

import time
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import profile

from mfcc_tpu_torch import LOGMEL80, MFCC13
from mfcc_tpu_torch.config import FeatureConfig
from mfcc_tpu_torch.models import logmel, mfcc, plp, spectrogram
from mfcc_tpu_torch.ops.kernels import _build, _spectral
from mfcc_tpu_torch.utils import report

STAGES = {"feat.cast", "feat.frames", "feat.spectral", "feat.mask"}


def _batch(B=3, N=8000, dtype=torch.int16):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(B, N, generator=g) * 0.1
    if dtype == torch.int16:
        x = (x * 32767).to(torch.int16)
    return x, torch.tensor([N, N - 1500, N // 2][:B])


def _spans(prof):
    """[(name, start, end)] of the program's ``feat.*`` host spans."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type != DeviceType.CUDA and e.name.startswith("feat.")]


def _stages_of_each_batch(prof):
    """{feat.batch's start: set of spans inside it}, checking that each
    stage lies inside a feat.batch."""
    spans = _spans(prof)
    batches = [s for s in spans if s[0] == "feat.batch"]
    inside = {b[1]: set() for b in batches}
    for name, s, e in spans:
        if name == "feat.batch":
            continue
        owner = [b for b in batches if b[1] <= s and e <= b[2]]
        assert len(owner) == 1, (name, s, e)
        inside[owner[0][1]].add(name)
    return inside


def test_profiler_flag_is_what_profile_sets():
    """``report.span`` reads this flag: a torch upgrade that moves it must
    fail here, not silently drop every span."""
    from torch.autograd import profiler
    assert profiler._is_profiler_enabled is False
    assert report.span("feat.x") is report.span("feat.y")   # the no-op
    for prof in (profile(), torch.autograd.profiler.profile()):
        with prof:
            assert profiler._is_profiler_enabled is True
            assert isinstance(report.span("feat.x"),
                              torch._C._profiler._RecordFunctionFast)
        assert profiler._is_profiler_enabled is False


def test_a_span_is_a_named_host_range_around_its_operators():
    """The range ``report.span`` enters is in the trace under its name,
    on the host, around the operators inside it, and its name is in
    ``span_names()``; a torch upgrade that changes that fails here."""
    with profile() as prof:
        with report.span("feat.probe"):
            torch.ones(4).sum()
    evs = [e for e in prof.events() if e.device_type != DeviceType.CUDA]
    (probe,) = [e for e in evs if e.name == "feat.probe"]
    (op,) = [e for e in evs if e.name == "aten::sum"]
    assert (probe.time_range.start <= op.time_range.start
            and op.time_range.end <= probe.time_range.end)
    assert "feat.probe" in report.span_names()


@pytest.mark.parametrize("entry,cfg", [
    (mfcc.mfcc_batch, MFCC13), (logmel.log_mel_batch, LOGMEL80),
    (plp.plp_batch, FeatureConfig()),
    (spectrogram.log_spectrogram_batch, FeatureConfig())])
def test_no_profiler_no_range_and_no_counts(monkeypatch, entry, cfg):
    def refuse(*a, **k):
        raise AssertionError("a range entered without a profiler")
    monkeypatch.setattr(report, "_RecordFunctionFast", refuse)
    report.reset()
    x, n = _batch()
    entry(x, n, cfg)
    with report.stage_timer(report.RunReport(), "decode"):
        pass
    assert report.counters()["frames_computed"] == 0


@pytest.mark.parametrize("entry,cfg,want", [
    (mfcc.mfcc_batch, MFCC13, STAGES),
    (logmel.log_mel_batch, LOGMEL80, STAGES | {"feat.deltas"}),
    (plp.plp_batch, FeatureConfig(), STAGES),
    (spectrogram.log_spectrogram_batch, FeatureConfig(), STAGES)])
def test_batch_span_holds_the_stages(entry, cfg, want):
    x, n = _batch()
    with profile() as prof:
        entry(x, n, cfg)
        entry(x, n, cfg)
    inside = _stages_of_each_batch(prof)
    assert len(inside) == 2
    assert all(stages == want for stages in inside.values())


def test_float_input_has_no_cast_span():
    x, n = _batch(dtype=torch.float32)
    with profile() as prof:
        mfcc.mfcc_batch(x, n, MFCC13)
    assert list(_stages_of_each_batch(prof).values()) == [
        STAGES - {"feat.cast"}]


def test_packed_rows_get_the_spans():
    x, _ = _batch(B=2)
    starts = torch.tensor([[0, 4000], [0, 0]])    # hop-aligned offsets
    lens = torch.tensor([[3500, 3900], [7000, 0]])
    with profile() as prof:
        mfcc.mfcc_batch_packed(x, starts, lens, MFCC13)
    (stages,) = _stages_of_each_batch(prof).values()
    assert stages == STAGES


@pytest.mark.parametrize("entry,cfg", [
    (mfcc.mfcc_batch, MFCC13), (logmel.log_mel_batch, LOGMEL80),
    (plp.plp_batch, FeatureConfig())])
def test_frames_computed_counts_while_recording(entry, cfg):
    x, n = _batch()
    report.reset()
    with profile():
        f1, _, _ = entry(x, n, cfg)
        f2, _, _ = entry(x[:2, :6000], n[:2].clamp(max=6000), cfg)
    c = report.counters()
    assert c["frames_computed"] == (f1.shape[0] * f1.shape[1]
                                    + f2.shape[0] * f2.shape[1])
    report.reset()
    assert report.counters()["frames_computed"] == 0
    assert report.counters()["import_s"] == c["import_s"] > 0


def test_stage_timer_fills_stage_seconds_and_opens_a_span():
    rep = report.RunReport(stage_seconds={"decode": 0.5})
    with report.stage_timer(rep, "decode"):
        time.sleep(0.01)
    assert rep.stage_seconds["decode"] >= 0.51
    with profile() as prof:
        with report.stage_timer(rep, "dispatch"):
            torch.ones(3).sum()
    assert set(rep.stage_seconds) == {"decode", "dispatch"}
    assert "dispatch" in {e.name for e in prof.events()}


def test_timed_adds_the_blocks_host_seconds():
    before = report.counters()["consts_s"]
    t0 = time.perf_counter()
    with report.timed("consts_s"):
        time.sleep(0.01)
    wall = time.perf_counter() - t0
    assert 0.01 <= report.counters()["consts_s"] - before <= wall


def test_constant_builders_count_their_cache_misses():
    """A miss of the launch path's FFT constants (the float64 build under
    it included) adds its host seconds to consts_s; a hit adds none."""
    cfg = FeatureConfig(n_mels=27, fmax=7321.0)   # a config no test caches
    before = report.counters()["consts_s"]
    t0 = time.perf_counter()
    _spectral._device_fft_matrices(cfg, "fft", "mel", torch.device("cpu"))
    missed = report.counters()["consts_s"]
    assert 0 < missed - before <= time.perf_counter() - t0
    _spectral._device_fft_matrices(cfg, "fft", "mel", torch.device("cpu"))
    assert report.counters()["consts_s"] == missed


def test_build_s_counts_builds_and_loads(monkeypatch, tmp_path):
    """A build (a stand-in compiler that copies a real shared library) then
    a load of the library it left: build_s takes the host seconds of both,
    and the second call builds nothing."""
    # torch's stub library: loading a second copy of it runs no initializer
    path = Path(torch.__file__).parent / "lib" / "libtorch_global_deps.so"
    if not path.exists():
        pytest.skip("no shared library of torch's to stand in for a build")
    nvcc, runs = tmp_path / "nvcc", tmp_path / "runs"
    nvcc.write_text(f"#!/bin/sh\necho run >> {runs}\n"
                    "while [ \"$1\" != -o ]; do shift; done\n"
                    f"cp {path} \"$2\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "library_path",
                        lambda name: tmp_path / "build" / f"lib{name}.so")
    before = report.counters()["build_s"]
    t0 = time.perf_counter()
    _build.load.__wrapped__("fused_raw")
    built = report.counters()["build_s"]
    assert 0 < built - before <= time.perf_counter() - t0
    _build.load.__wrapped__("fused_raw")
    assert report.counters()["build_s"] > built
    assert runs.read_text().split() == ["run"]
