"""The Whisper configuration's benchmark code on the CPU: the reference
against Hugging Face's extractor and against a numpy restatement, the
least work counted by hand, every reader that runs in all cells reading a
number on the configuration, the TF32 control failing the limit, and the
files and entries the benchmark had before the configuration still
there."""

import math
import types

import numpy as np
import pytest
import torch

from perfbench import check, corpus, harness, spans, work, work_whisper
from perfbench.reference import whisper as ref
from perfbench.tests.hostdev import tiny

CONFIG = "whisper-large-v3-logmel128-16k"
CELL = "whisper128.libri_sorted"


def _config():
    return harness.load_json(harness.HERE / "configs" / f"{CONFIG}.json")


def _audio(B, N, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, N, generator=g) * 3000).clamp(
        -32768, 32767).to(torch.int16)


def test_reference_matches_hugging_face():
    """Hugging Face computes Whisper's chain in float32 (its FFT rounds
    ~1e-7 of a frame's peak; ~4e-5 after the log and the /4 in the valleys
    of these frames): 1e-4."""
    fe = pytest.importorskip(
        "transformers.models.whisper.feature_extraction_whisper")
    x, lengths = _audio(3, 400_000), [400_000, 123_457, 0]
    feat, flens, mask = ref.features(x, lengths, _config()["features"], False)
    assert feat.dtype == torch.float64 and feat.shape == (3, 3000, 128)
    assert flens.tolist() == [3000] * 3 and bool(mask.all())
    hf = fe.WhisperFeatureExtractor(feature_size=128)(
        [x[i, :n].double().numpy() / 32768.0 for i, n in enumerate(lengths)],
        sampling_rate=16000, return_tensors="np")["input_features"]
    np.testing.assert_allclose(feat.numpy(), hf.transpose(0, 2, 1), rtol=0,
                               atol=1e-4)


def _numpy_features(x, lengths, chunk):
    """Whisper's formula once more, in numpy float64 on ``np.fft.rfft``:
    each row zero-padded to the window, reflected 200 samples each side
    without the edge, framed at hop 160 with the periodic Hann window, the
    last frame dropped."""
    bank = ref.mel_filters(ref.Settings(_config()["features"]))
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(400) / 400)
    out = []
    for row, n in zip(x.numpy().astype(np.float64) / 32768.0, lengths):
        z = np.zeros(chunk)
        z[:min(n, chunk)] = row[:min(n, chunk)]
        z = np.pad(z, 200, mode="reflect")
        frames = np.stack([z[t * 160:t * 160 + 400]
                           for t in range(chunk // 160)])
        e = np.abs(np.fft.rfft(frames * w)) ** 2 @ bank.T
        spec = np.log10(np.maximum(e, 1e-10))
        spec = np.maximum(spec, spec.max() - 8.0)
        out.append((spec + 4.0) / 4.0)
    return np.stack(out)


def test_reference_equals_a_numpy_restatement():
    """The reference (on ``torch.stft``) and the same formula on numpy's
    FFT, both float64: equal to float64's rounding."""
    f = dict(_config()["features"], chunk_s=1.0)
    x, lengths = _audio(3, 20000, 1), [20000, 7000, 16000]
    feat, _, _ = ref.features(x, lengths, f, False)
    np.testing.assert_allclose(feat.numpy(), _numpy_features(x, lengths, 16000),
                               rtol=0, atol=1e-12)


def test_reference_refuses_what_is_not_whisper():
    f = _config()["features"]
    for bad in (dict(preemph=0.97), dict(window="hamming"),
                dict(dynamic_range_db=80.0), dict(frame_ms=20.0)):
        with pytest.raises(ValueError, match="not Whisper"):
            ref.Settings(dict(f, **bad))
    with pytest.raises(ValueError, match="DCT"):
        ref.features(_audio(1, 1000), [1000], f, True)


def test_least_work_by_hand():
    """Rows of 1 s, of 45 s (cut to 30 s) and of no sample: 9,000 frames
    written.  The transform is counted for the frames that read a sample:
    frame t starts at sample 160 t - 200, so the 1 s row's are frames
    0-101 (frame 101 starts at 15,960, frame 102 at 16,120), the 30 s
    row's all 3,000, the empty row's none."""
    f = _config()["features"]
    nonzeros = 0
    hz = ref.mel_to_hz(np.linspace(0.0, ref.hz_to_mel(8000.0), 130))
    for m in range(128):
        for k in range(201):
            if hz[m] < 40.0 * k < hz[m + 2]:
                nonzeros += 1
    frame = (2.5 * 400 * math.log2(400) + 400 + 3 * 201 + 2 * nonzeros
             + 128 * (17 + 1 + 1 + 1 + 2))
    lengths = np.array([16000, 720000, 0])
    assert work_whisper.sample_frames(f, lengths).tolist() == [102, 3000, 0]
    assert work_whisper.sample_frames(f, np.array([1, 120, 121])).tolist() \
        == [2, 2, 3]
    ops, nbytes = work_whisper.whisper_work(f, lengths)
    assert ops == pytest.approx(3102 * frame, rel=1e-12)
    assert nbytes == 2 * (16000 + 480000) + 4 * 9000 * 128
    assert 13000 < frame < 13500


def _made_up_run(cfg, batches=2, rows=4):
    """A traced run of the Whisper cell on a made-up trace: the kernel,
    the cast and the norm's operations, and the program spans' pass."""
    kernel = "void (anonymous namespace)::raw_kernel<8>(spectral::DirectParams)"
    ops = []
    for b in range(batches):
        t = 1000.0 * b
        ops += [("void at::native::vectorized_elementwise_kernel<4, Mul>",
                 t, t + 50), (kernel, t + 50, t + 850),
                ("void at::native::reduce_kernel<512, 1>", t + 850, t + 900)]
    lengths = [np.array([16000 * (i + 1) for i in range(rows)])] * batches
    busy = harness.busy_intervals(ops, 0.0, 1000.0 * batches)
    return types.SimpleNamespace(
        trace={"dev_ops": ops, "window_s": 1e-3 * batches,
               "busy_s": sum(e - s for s, e in busy) * 1e-6},
        traced=types.SimpleNamespace(batches=batches, lengths=lengths),
        window=types.SimpleNamespace(host_ms=[0.3, 0.2], audio_s=10.0,
                                     seconds=1.0, spans_ms=[1.0, 2.0]),
        cell=types.SimpleNamespace(config=cfg), kind="NVIDIA H100 80GB HBM3",
        setup_s=5.0, window_peak=2 << 30, base=1 << 30,
        spans={"batches": batches, "lengths": lengths,
               "counters": {"frames_computed": batches * rows * 3000},
               "span_device_s": {"feat.cast": 1e-4, "feat.whisper_norm": 2e-4,
                                 "fused_raw": 1.6e-3},
               "syncs": [], "untied_s": 0.0})


def test_every_reader_of_the_cell_reads_a_number(monkeypatch):
    """The readers the cell runs (its end-to-end metrics; the per-layer
    ones, those of every cell among them, spectral_fill_pct's Settings
    too) on the Whisper configuration: a number each, none raises."""
    monkeypatch.setattr(spans, "program_report", lambda: types.SimpleNamespace(
        counters=lambda: {"import_s": 0.1, "build_s": 0.0, "consts_s": 0.01}))
    cell = harness.load_cell(CELL)
    run = _made_up_run(cell.config)
    names = [m["name"] for m in cell.metrics["end_to_end"]
             + cell.metrics["per_layer"]]
    assert {"spectral_fill_pct", "whisper_norm_ms",
            "roofline_pct.fused_raw.whisper"} <= set(names)
    got = {n: harness.reader(n)(run) for n in names}
    assert all(isinstance(v, float) and math.isfinite(v)
               for v in got.values()), got
    # valid-mode frames of 1-4 s over 3,000 a row
    valid = sum(1 + (16000 * (i + 1) - 400) // 160 for i in range(4))
    assert got["spectral_fill_pct"] == pytest.approx(100 * valid / 12000)
    assert got["whisper_norm_ms"] == pytest.approx(0.1)
    ops, nbytes = work_whisper.whisper_work(
        cell.config["features"], np.concatenate(run.traced.lengths))
    least = work.roofline_seconds(ops, nbytes, run.kind)[0]
    assert got["roofline_pct.fused_raw.whisper"] == pytest.approx(
        100 * least / 1.6e-3)


def test_the_tf32_control_fails_the_limit():
    t = tiny(harness.load_json(harness.HERE / "traffic" / "libri_sorted.json"),
             batch=2, utterances=2)
    b = corpus.build(t, 2**31 + 3, "cpu").batches[0]
    numbers, _, failed = check.compare(_config(), [b], [None], "tf32")
    assert numbers["static_err"][0] > 10 * numbers["static_err"][1]
    assert failed == 2 and not check.correct(numbers)


# The files and the entries the benchmark had before the Whisper
# configuration: it adds its own beside them and takes none away.
FILES_BEFORE = (
    "README.md", "__init__.py", "calibrate.py", "check.py",
    "configs/htk-mfcc13-16k.json", "configs/kaldi-fbank80-deltas-16k.json",
    "corpus.py", "faults.py", "harness.py", "metrics/audio_s_per_s.py",
    "metrics/batch_ms_p95.py", "metrics/cast_ms.py", "metrics/deltas_ms.py",
    "metrics/host_enqueue_ms.py", "metrics/host_syncs_per_batch.py",
    "metrics/idle_pct.py", "metrics/launches_per_batch.py",
    "metrics/post_ms.py", "metrics/roofline_pct.fused_raw.py",
    "metrics/roofline_pct.fused_raw_dit.py", "metrics/setup_program_s.py",
    "metrics/setup_s.py", "metrics/spectral_fill_pct.py",
    "metrics/work_mem_gib.py", "readings.py", "reference/__init__.py",
    "reference/features.py", "run.py", "spans.py", "traffic/libri_shuffled.json",
    "traffic/libri_sorted.json", "work.py")
ENTRIES_BEFORE = {
    "configs": ["htk-mfcc13-16k", "kaldi-fbank80-deltas-16k"],
    "workloads": ["mfcc13.libri_sorted", "fbank80d.libri_sorted",
                  "mfcc13.libri_shuffled"],
    "end_to_end": ["audio_s_per_s", "batch_ms_p95", "work_mem_gib",
                   "setup_s"],
    "per_layer": ["host_enqueue_ms", "launches_per_batch",
                  "roofline_pct.fused_raw_dit", "roofline_pct.fused_raw",
                  "post_ms", "idle_pct", "cast_ms", "deltas_ms",
                  "host_syncs_per_batch", "spectral_fill_pct",
                  "setup_program_s"]}


def test_the_benchmark_keeps_what_it_had_first():
    """The configuration's files and entries come after the benchmark's
    own: every file it had is there, and its entries lead each list in
    their order, so a cell that was measured before is measured alike."""
    for name in FILES_BEFORE:
        assert (harness.HERE / name).is_file(), name
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for key, names in ENTRIES_BEFORE.items():
        assert [e["name"] for e in bench[key][:len(names)]] == names, key
    new = [e["name"] for e in bench["workloads"][len(
        ENTRIES_BEFORE["workloads"]):]]
    assert new[:2] == ["fbank80d.libri_shuffled", CELL]
