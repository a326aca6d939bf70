"""The NeMo configuration's benchmark code on the CPU: the reference
against Hugging Face's extractor and against a numpy restatement, the
least work counted by hand, every reader that runs in the cell reading a
number on the configuration, the TF32 control failing the limit, the
short-query mix's lengths and batches, and the benchmark's files and
entries from before the configuration unchanged."""

import hashlib
import json
import math
import types

import numpy as np
import pytest
import torch

from perfbench import check, corpus, harness, spans, work, work_nemo
from perfbench.reference import nemo as ref
from perfbench.reference import whisper as ref_whisper
from perfbench.tests.hostdev import tiny

CONFIG = "nemo-fastconformer-logmel128-16k"
CELL = "nemo128.libri_shuffled"
QUERIES = "mfcc13.queries"


def _config():
    return harness.load_json(harness.HERE / "configs" / f"{CONFIG}.json")


def _audio(B, N, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, N, generator=g) * 3000).clamp(
        -32768, 32767).to(torch.int16)


def _hf_extractor():
    """Hugging Face's ``ParakeetFeatureExtractor`` at 128 features, its
    ``__init__`` (which needs librosa) skipped, the Slaney bank set from
    ``mel_filter_bank``."""
    fe_mod = pytest.importorskip(
        "transformers.models.parakeet.feature_extraction_parakeet")
    from transformers.audio_utils import mel_filter_bank
    from transformers.feature_extraction_sequence_utils import \
        SequenceFeatureExtractor
    P = fe_mod.ParakeetFeatureExtractor
    fe = P.__new__(P)
    SequenceFeatureExtractor.__init__(fe, feature_size=128,
                                      sampling_rate=16000, padding_value=0.0)
    fe.hop_length, fe.n_fft, fe.win_length = 160, 512, 400
    fe.preemphasis = 0.97
    fe.mel_filters = torch.from_numpy(mel_filter_bank(
        num_frequency_bins=257, num_mel_filters=128, min_frequency=0.0,
        max_frequency=8000.0, sampling_rate=16000, norm="slaney",
        mel_scale="slaney").T).to(torch.float32)
    return fe


def test_reference_matches_hugging_face():
    """Hugging Face computes NeMo's chain in float32 (its float32 STFT
    rounds ~1e-7 of a frame's peak, ~1e-5 of a band's log 40-60 dB under
    it, over the band's sigma after the normalization): 2e-4 (1.0e-4
    measured).  Its frame counts are L // 160 and its frames 1 + N //
    160; its row of one valid frame is NaN, which the reference writes as
    zeros."""
    x, lengths = _audio(4, 20000), [20000, 9999, 16000, 300]
    feat, flens, mask = ref.features(x, lengths, _config()["features"], False)
    assert feat.dtype == torch.float64 and feat.shape == (4, 126, 128)
    assert flens.tolist() == [125, 62, 100, 1]
    out = _hf_extractor()([x[i, :n].double().numpy() / 32768.0
                           for i, n in enumerate(lengths)],
                          sampling_rate=16000, return_tensors="pt")
    hf, hmask = out["input_features"], out["attention_mask"]
    assert torch.equal(hmask, mask)
    np.testing.assert_allclose(feat[:3].numpy(), hf[:3].double().numpy(),
                               rtol=0, atol=2e-4)
    assert bool(torch.isnan(hf[3, 0]).all()) and not feat[3].any()


def _numpy_features(x, lengths, f):
    """NeMo's formula once more, in numpy float64 on ``np.fft.rfft``: each
    row pre-emphasized and cut at its length, zero-padded 256 samples a
    side and framed at hop 160 in 512 points, the symmetric Hann window of
    400 points at offset 56, the Slaney bank, log(e + 2^-24), the
    per-feature normalization over the L // 160 valid frames."""
    s = ref.Settings(f)
    bank = ref_whisper.mel_filters(s)
    w = np.zeros(512)
    w[56:456] = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(400) / 399)
    out = []
    for row, n in zip(x.numpy().astype(np.float64) / 32768.0, lengths):
        y = np.concatenate([row[:1], row[1:] - 0.97 * row[:-1]])
        y[n:] = 0.0
        z = np.pad(y, 256)
        T = 1 + len(row) // 160
        frames = np.stack([z[t * 160:t * 160 + 512] for t in range(T)])
        power = np.abs(np.fft.rfft(frames * w)) ** 2
        logs = np.log(power @ bank.T + 2.0 ** -24)
        k = n // 160
        mu, sd = logs[:k].mean(0), logs[:k].std(0, ddof=1)
        res = np.zeros_like(logs)
        res[:k] = (logs[:k] - mu) / (sd + 1e-5)
        out.append(res)
    return np.stack(out)


def test_reference_equals_a_numpy_restatement():
    """The reference (on ``torch.stft``) and the same formula on numpy's
    FFT, both float64: equal to float64's rounding."""
    f = _config()["features"]
    x, lengths = _audio(3, 20000, 1), [20000, 7001, 16000]
    feat, _, _ = ref.features(x, lengths, f, False)
    np.testing.assert_allclose(feat.numpy(), _numpy_features(x, lengths, f),
                               rtol=0, atol=1e-9)


def test_reference_refuses_what_is_not_nemo():
    f = _config()["features"]
    for bad in (dict(window="hamming"), dict(log_guard="clamp"),
                dict(normalize="all_features"), dict(dynamic_range_db=80.0),
                dict(frame_ms=40.0)):
        with pytest.raises(ValueError, match="not NeMo"):
            ref.Settings(dict(f, **bad))
    with pytest.raises(ValueError, match="DCT"):
        ref.features(_audio(1, 1000), [1000], f, True)


def test_least_work_by_hand():
    """Rows of 1 s, of 2.5 s plus 159 samples and of 100 samples: 100 +
    250 + 0 valid frames.  A frame: the 512-point FFT at 2.5 n log2 n
    (11,520), the window's 400 products, |X|^2 at three a bin (771), two
    a nonzero of the bank (504 of them), and 128 values of the guard and
    the accurate log (18 each)."""
    f = _config()["features"]
    nonzeros = 0
    hz = ref_whisper.mel_to_hz(np.linspace(0.0, ref_whisper.hz_to_mel(8000.0),
                                           130))
    for m in range(128):
        for k in range(257):
            if hz[m] < 31.25 * k < hz[m + 2]:
                nonzeros += 1
    assert nonzeros == 504
    frame = 2.5 * 512 * 9 + 400 + 3 * 257 + 2 * 504 + 128 * 18
    assert work_nemo.per_frame(f) == pytest.approx(frame, rel=1e-12)
    lengths = np.array([16000, 40159, 100])
    assert work_nemo.valid_frames(f, lengths) == 350
    ops, nbytes = work_nemo.nemo_work(f, lengths)
    assert ops == pytest.approx(350 * frame, rel=1e-12)
    assert nbytes == 2 * (16000 + 40159 + 100) + 4 * 350 * 128
    assert 16000 < frame < 16100


def _made_up_run(cfg, batches=2, rows=4):
    """A traced run of the NeMo cell on a made-up trace: the cast, the
    kernel and the normalization's operations, and the program spans'
    pass."""
    kernel = ("void (anonymous namespace)::raw_fft_kernel<32>("
              "spectral::FftGuardParams)")
    ops = []
    for b in range(batches):
        t = 1000.0 * b
        ops += [("void at::native::vectorized_elementwise_kernel<4, Mul>",
                 t, t + 50), (kernel, t + 50, t + 850),
                ("void at::native::reduce_kernel<512, 1>", t + 850, t + 900)]
    lengths = [np.array([16000 * (i + 1) for i in range(rows)])] * batches
    T = 1 + 16000 * rows // 160
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
               "counters": {"frames_computed": batches * rows * T,
                            "frames_direct": 0, "frames_bounded": 0,
                            "frames_guarded": batches * rows * T},
               "span_device_s": {"feat.cast": 1e-4, "feat.feature_norm": 5e-4,
                                 "fused_raw": 1.6e-3},
               "syncs": [], "untied_s": 0.0})


def test_every_reader_of_the_cell_reads_a_number(monkeypatch):
    """The readers the cell runs (its end-to-end metrics; the per-layer
    ones, those of every cell among them, spectral_fill_pct's Settings
    too) on the NeMo configuration: a number each, none raises; the three
    of the configuration read what the made-up run holds."""
    monkeypatch.setattr(spans, "program_report", lambda: types.SimpleNamespace(
        counters=lambda: {"import_s": 0.1, "build_s": 0.0, "consts_s": 0.01}))
    cell = harness.load_cell(CELL)
    run = _made_up_run(cell.config)
    names = [m["name"] for m in cell.metrics["end_to_end"]
             + cell.metrics["per_layer"]]
    assert {"spectral_fill_pct", "feature_norm_ms", "guarded_frames_pct",
            "roofline_pct.fused_raw.nemo"} <= set(names)
    assert not {"whisper_norm_ms", "deltas_ms", "roofline_pct.fused_raw",
                "roofline_pct.fused_raw.whisper"} & set(names)
    got = {n: harness.reader(n)(run) for n in names}
    assert all(isinstance(v, float) and math.isfinite(v)
               for v in got.values()), got
    assert got["feature_norm_ms"] == pytest.approx(0.25)
    assert got["guarded_frames_pct"] == 100.0
    ops, nbytes = work_nemo.nemo_work(
        cell.config["features"], np.concatenate(run.traced.lengths))
    least = work.roofline_seconds(ops, nbytes, run.kind)[0]
    assert got["roofline_pct.fused_raw.nemo"] == pytest.approx(
        100 * least / 1.6e-3)


def test_new_readers_read_nothing_where_the_program_has_nothing():
    """On a program without the counter or the span (the parent of the
    configuration), the three readers return None and raise nothing."""
    cfg = _config()
    run = _made_up_run(cfg)
    del run.spans["counters"]["frames_guarded"]
    del run.spans["span_device_s"]["feat.feature_norm"]
    assert harness.reader("guarded_frames_pct")(run) is None
    assert harness.reader("feature_norm_ms")(run) is None
    run.trace["dev_ops"] = [o for o in run.trace["dev_ops"]
                            if "raw_fft_kernel" not in o[0]]
    assert harness.reader("roofline_pct.fused_raw.nemo")(run) is None


def test_the_tf32_control_fails_the_limit():
    t = tiny(harness.load_json(harness.HERE / "traffic" /
                               "libri_shuffled.json"), batch=2, utterances=2)
    b = corpus.build(t, 2**31 + 3, "cpu").batches[0]
    numbers, _, failed = check.compare(_config(), [b], [None], "tf32")
    assert numbers["static_err"][0] > 10 * numbers["static_err"][1]
    assert failed == 2 and not check.correct(numbers)


def test_queries_mix_lengths_and_batches():
    """16,384 utterances of 1-6 s, mean ~3.25 s (14.8 h), sorted into 16
    batches of 1,024 rows, each padded to its longest."""
    traffic = harness.load_json(harness.HERE / "traffic" /
                                "queries_sorted.json")
    n = corpus.lengths(traffic)
    assert n.size == 16384 and n.min() >= 16000 and n.max() <= 96000
    assert 3.2 < n.mean() / 16000 < 3.3
    assert 14.6 < n.sum() / 16000 / 3600 < 15.0
    rows = corpus.batch_rows(traffic, n, 2**31 + 11)
    assert len(rows) == 16 and all(len(r) == 1024 for r in rows)
    pads = [int(n[r].max()) for r in rows]
    assert pads == sorted(pads) and pads[-1] == n.max()
    assert traffic["signal"] == harness.load_json(
        harness.HERE / "traffic" / "libri_sorted.json")["signal"]
    assert (traffic["queue_depth"], traffic["check_batches"],
            traffic["trace_seconds"]) == (2, 4, 2.0)
    cell = harness.load_cell(QUERIES)
    assert cell.config["name"] == "htk-mfcc13-16k" and cell.chips == 1


def _digest(data) -> str:
    if not isinstance(data, bytes):
        data = json.dumps(data, sort_keys=True).encode()
    return hashlib.sha256(data).hexdigest()[:16]


# Every file of the benchmark from before the NeMo configuration (its
# tests aside), by the first 16 hex digits of its sha256: none changes.
FILES_BEFORE = {
    "README.md": "9518ebaee6ee17ae", "__init__.py": "1caef1e62a68755e",
    "calibrate.py": "f7cdfbb102ab5a61", "check.py": "06ec35590c24cdcf",
    "configs/htk-mfcc13-16k.json": "fcfd76cc5aa59c27",
    "configs/kaldi-fbank80-deltas-16k.json": "bc16344a3f0c697a",
    "configs/whisper-large-v3-logmel128-16k.json": "d27d91011eb1aafb",
    "corpus.py": "c0582d6cf391afe0", "faults.py": "1517e1aa6cd12e92",
    "harness.py": "48f3c43f9617c521",
    "metrics/audio_s_per_s.py": "a605e5e5874d4dd2",
    "metrics/batch_ms_p95.py": "2a86b615e44d1080",
    "metrics/bounded_frames_pct.py": "580091e6c36ff17a",
    "metrics/cast_ms.py": "cf10bd5b3e00174d",
    "metrics/deltas_ms.py": "5da6a4461933958d",
    "metrics/direct_frames_pct.py": "1905387d41d4dc42",
    "metrics/host_enqueue_ms.py": "8c266fd626bfff9e",
    "metrics/host_syncs_per_batch.py": "5ace3fcf1ebc19f6",
    "metrics/idle_pct.py": "73cfff471b7cbfff",
    "metrics/launches_per_batch.py": "2b4e88cc413bb266",
    "metrics/post_ms.py": "0812d9fa1d172a32",
    "metrics/roofline_pct.fused_raw.py": "cd5dd2bd023946bd",
    "metrics/roofline_pct.fused_raw.whisper.py": "177a5523e8f37b29",
    "metrics/roofline_pct.fused_raw_dit.py": "3898d6c6aa390bd5",
    "metrics/setup_program_s.py": "2c3b714e93ec1075",
    "metrics/setup_s.py": "de7072c9ca74fe20",
    "metrics/spectral_fill_pct.py": "27616c1a7ca32af2",
    "metrics/whisper_norm_ms.py": "315ef0a5666ef9c3",
    "metrics/work_mem_gib.py": "c0ab549c8e90b418",
    "readings.py": "09499dd4c5135182",
    "reference/__init__.py": "74740ff96e9ff3e4",
    "reference/features.py": "eb987a1bfd75b3f2",
    "reference/whisper.py": "7c395fbf1cf9314c", "run.py": "07b457a613440149",
    "spans.py": "49aa4217c6c0065e",
    "traffic/libri_shuffled.json": "1ecbb331acf9d0be",
    "traffic/libri_sorted.json": "c552777266912261",
    "work.py": "3b45ddb557e91bfb", "work_whisper.py": "867b029d601f7600"}
# Each list of BENCHMARK.json as it was before the configuration: its
# length and the digest of its entries, which lead the list unchanged.
ENTRIES_BEFORE = {"configs": (3, "3f22aef826ee17a4"),
                  "workloads": (5, "74efaed34be9be4d"),
                  "end_to_end": (4, "0050b00049700431"),
                  "per_layer": (15, "fbd6bd3b4ccc58e3")}


def test_no_file_or_entry_of_the_benchmark_changed():
    """The configuration adds files and entries alone: every file the
    benchmark had is there with its bytes, the entries it had lead each
    list of BENCHMARK.json unchanged, and the new ones are this
    configuration's, its two cells' and its three metrics'."""
    for name, digest in FILES_BEFORE.items():
        assert _digest((harness.HERE / name).read_bytes()) == digest, name
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for key, (n, digest) in ENTRIES_BEFORE.items():
        assert _digest(bench[key][:n]) == digest, key
    new = {k: [e["name"] for e in bench[k][n:]]
           for k, (n, _) in ENTRIES_BEFORE.items()}
    assert new["configs"][:1] == [CONFIG]
    assert new["workloads"][:2] == [CELL, QUERIES]
    assert new["end_to_end"] == []
    assert new["per_layer"][:3] == ["feature_norm_ms",
                                    "roofline_pct.fused_raw.nemo",
                                    "guarded_frames_pct"]
    for m in bench["per_layer"][ENTRIES_BEFORE["per_layer"][0]:][:3]:
        assert m["workloads"] == [CELL] and m["moves"] == "audio_s_per_s"
