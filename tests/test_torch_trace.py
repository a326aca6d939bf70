"""The port's tracing (``mfcc_tpu_torch/utils/report``): spans that cost a
flag read without a profiler, the batch entry's stage spans under one,
the per-batch counter kept only while a profiler records, the set-up
counters (import, kernel builds and loads, constants), the record of
kernel launches kept apart from them, and the CUDA-event timer."""

import contextlib
import time
import types
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


@pytest.fixture
def fake_card(monkeypatch):
    """``_spectral.launch_spectral`` on a CPU tensor: no device, no
    constants, a C entry that returns 0 (each launch's host path as it
    runs, up to the C call)."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(_spectral, "_device_fft_matrices",
                        lambda *a: (None,) * 6)

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    def launch(name, cfg, other="direct", apply_dct=False,
               projection=None, N=8000):
        consts = (other, lambda c, dev: ([None, 0, None, None], None),
                  [None, 0, None, None])
        return _spectral.launch_spectral(
            Lib, "entry", name, torch.zeros(2, N), cfg, apply_dct, 0.0,
            other=consts, projection=projection)
    return launch


@pytest.mark.parametrize("name,kw,other,dct,projection,tile", [
    ("fused_raw_dit", {}, "direct", True, "mel", "fft"),
    ("fused_raw_dit", {}, "direct", False, "bark", "fft64"),
    ("fused_raw", dict(n_mels=80, n_mfcc=80), "direct", False, None,
     "fft64"),
    ("fused_mfcc", dict(n_fft=401), "direct", True, None, "direct"),
    ("fused_dit", dict(n_fft=400), "dit", True, None, "dit")])
def test_a_launch_is_recorded_with_no_profiler(fake_card, name, kw, other,
                                              dct, projection, tile):
    """``launch_spectral`` records its launch under the entry's name, the
    tile it ran and the projection it was given, with no profiler; the
    launch returns the features alone."""
    from torch.autograd import profiler
    assert profiler._is_profiler_enabled is False
    before = report.launches()
    out = fake_card(name, FeatureConfig(**kw).validate(), other, dct,
                    projection)
    assert isinstance(out, torch.Tensor) and out.shape[:2] == (2, 48)
    want = {name: 1, (name, tile): 1}
    if projection is not None:
        want[name, projection] = 1
    assert dict(report.launches() - before) == want


def test_an_empty_output_records_no_launch(fake_card):
    before = report.launches()
    out = fake_card("fused_raw_dit", FeatureConfig(), N=399)
    assert out.shape == (2, 0, 26) and report.launches() == before


def test_reset_keeps_the_record_and_reset_launches_clears_it(fake_card):
    """``reset()`` zeroes the per-batch counters and leaves the launches;
    ``reset_launches()`` forgets the launches and the launch shapes."""
    fake_card("fused_raw_dit", FeatureConfig(), apply_dct=True,
              projection="mel")
    report.launched("fused_nccf", shape={"TM": 32})
    kept = report.launches()
    report.reset()
    assert report.launches() == kept and kept["fused_raw_dit"] >= 1
    report.reset_launches()
    assert report.launches() == {}
    assert report.launches()["fused_raw_dit", "fft"] == 0
    assert report.last_shape("fused_nccf") is None


def test_counters_keep_their_five_keys_around_a_launch(fake_card):
    """The launch record is not a counter: ``counters()`` has the same seven
    keys before and after a launch, and ``reset()`` clears the same four."""
    keys = {"frames_computed", "frames_direct", "frames_bounded",
            "frames_guarded", "import_s", "build_s", "consts_s"}
    assert set(report.counters()) == keys
    fake_card("fused_mfcc", FeatureConfig(n_fft=401).validate(),
              apply_dct=True)
    assert set(report.counters()) == keys
    assert report.PER_BATCH == ("frames_computed", "frames_direct",
                                "frames_bounded", "frames_guarded")


def test_last_shape_is_the_shape_last_recorded():
    """``last_shape`` is the shape of the kernel's last recorded launch,
    whatever other kernels recorded since; a launch with no shape leaves
    it."""
    report.reset_launches()
    assert report.last_shape("fused_viterbi") is None
    report.launched("fused_viterbi", shape={"K": 1, "J": 72})
    report.launched("fused_viterbi", shape={"K": 2, "J": 36})
    report.launched("fused_nccf", shape={"TM": 32})
    report.launched("fused_viterbi")
    assert report.last_shape("fused_viterbi") == {"K": 2, "J": 36}
    assert report.last_shape("fused_nccf") == {"TM": 32}
    assert report.launches()["fused_viterbi"] == 3


@pytest.mark.parametrize("warmup,calls,group,samples", [
    (3, 30, 5, 6), (1, 20, 20, 1), (0, 4, 1, 4), (2, 3, 5, 1)])
def test_cuda_ms_times_groups_of_calls(monkeypatch, warmup, calls, group,
                                       samples):
    """``cuda_ms``: ``warmup`` untimed calls, a synchronize, then
    ``calls // group`` samples (at least one), each an event pair around
    ``group`` calls, in ms a call (events on the host clock here)."""
    log = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.t = None

        def record(self):
            log.append("record")
            self.t = time.perf_counter()

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e3

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: log.append("sync"))
    ms = report.cuda_ms(lambda: log.append("call") or time.sleep(1e-3),
                        warmup, calls, group)
    assert len(ms) == samples and all(m >= 1.0 for m in ms)
    assert log == ["call"] * warmup + ["sync"] + (
        ["record"] + ["call"] * group + ["record"]) * samples
