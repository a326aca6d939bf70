"""Whisper's log-mel front end (``models/whisper``) on the CPU: the entry
against the benchmark's float64 reference (``perfbench/reference/whisper``) with
short windows and one whole 30 s row, the STFT centring frame for frame
against ``torch.stft(center=True)``, the filterbank and the features
against Hugging Face's ``WhisperFeatureExtractor`` where transformers
imports, each row's own floor, the spans and the frame counter under a
profiler, the constants' caches, the route to ``fused_raw``'s mixed-radix
FFT tile and its tables, the direct tile's tables (which other n_fft still
take), the tile rule of every power-of-two config, and the config's
checks.

Tolerances: the port computes Whisper's float32 chain, the reference in
float64.  A float32 DFT rounds ~1e-7 of a frame's largest bin; in a band
60-70 dB under it (the frames at a row's end, the valleys of a frame) that
is ~2e-4 of the band's log10, ~5e-5 after the /4: hence 1e-4 against the
reference (2.6e-5 measured).  Hugging Face computes in float32 too (its
own FFT, 3.7e-5 off the reference here), so against it the two roundings
add: 2e-4 (6.3e-5 measured).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import profile

from mfcc_tpu import config as jax_config
from mfcc_tpu_torch import config as torch_config
from mfcc_tpu_torch.config import WHISPER128, WhisperConfig
from mfcc_tpu_torch.models import whisper
from mfcc_tpu_torch.ops import framing, spectrum
from mfcc_tpu_torch.ops.kernels import _spectral, fused_raw
from mfcc_tpu_torch.utils import report
from perfbench.reference import whisper as ref

REF_TOL = 1e-4   # the port's float32 chain against float64 (module note)
HF_TOL = 2e-4    # two float32 chains (module note)
SHORT = WhisperConfig(chunk_s=1.0).validate()
STAGES = {"feat.cast", "feat.frames", "feat.spectral", "feat.whisper_norm",
          "feat.mask"}


def _audio(B, N, scale=3000.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, N, generator=g) * scale).clamp(
        -32768, 32767).to(torch.int16)


def _reference(x, lengths, cfg):
    """The float64 features of int16 rows, or of float rows in [-1, 1]."""
    if x.dtype != torch.int16:
        x = x.double() * 32768.0
    return ref.features(x, lengths, dataclasses.asdict(cfg), False)[0]


def _hf_extractor(chunk_s):
    fe = pytest.importorskip(
        "transformers.models.whisper.feature_extraction_whisper")
    return fe.WhisperFeatureExtractor(feature_size=128, chunk_length=chunk_s)


@pytest.mark.parametrize("cfg,N,lengths,dtype", [
    (SHORT, 20000, [16000, 9000, 0], torch.int16),      # window, shorter, none
    (SHORT, 20000, [20000, 16001, 400], torch.int16),   # cut to the window
    (SHORT, 12000, [12000, 5000, 11999], torch.float32),  # float input
    # a window that is no whole number of hops: no right reflection framed
    (WhisperConfig(chunk_s=1.003).validate(), 17000, [17000, 3000, 16048],
     torch.int16),
])
def test_entry_matches_the_plain_reference(cfg, N, lengths, dtype):
    x = _audio(len(lengths), N)
    if dtype == torch.float32:
        x = x.to(torch.float32) / 32768.0
    n = torch.tensor(lengths)
    feat, flens, mask = whisper.whisper_log_mel_batch(x, n, cfg)
    T = cfg.num_frames()
    assert feat.shape == (len(lengths), T, cfg.n_mels)
    assert feat.dtype == torch.float32
    assert torch.equal(flens, torch.full((len(lengths),), T, dtype=torch.int32))
    assert bool(mask.all()) and mask.shape == (len(lengths), T)
    want = _reference(x, n, cfg)
    np.testing.assert_allclose(feat.double().numpy(), want.numpy(), rtol=0,
                               atol=REF_TOL)


def test_a_whole_30_second_window():
    x = _audio(2, 500_000, seed=3)
    n = torch.tensor([320_000, 500_000])     # 20 s, and 31.25 s cut to 30
    feat, flens, _ = whisper.whisper_log_mel_batch(x, n, WHISPER128)
    assert feat.shape == (2, 3000, 128) and int(flens[0]) == 3000
    np.testing.assert_allclose(feat.double().numpy(),
                               _reference(x, n, WHISPER128).numpy(),
                               rtol=0, atol=REF_TOL)


@pytest.mark.parametrize("chunk_s,N,lengths", [
    (1.0, 20000, [16000, 7000, 20000]),
    (1.003, 9000, [9000, 1]),
    (0.5, 8000, [8000, 8000]),
])
def test_frames_are_torch_stft_centred_frames(chunk_s, N, lengths):
    """The padded rows' valid frames, transformed, are torch.stft's
    frames of the rows cut or zero-padded to the window, the last one
    dropped: frame for frame, bin for bin, in float64."""
    cfg = WhisperConfig(chunk_s=chunk_s).validate()
    x = torch.randn(len(lengths), N, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    n = torch.tensor(lengths)
    xp = framing.stft_center_batch(x, n, cfg)
    T = cfg.num_frames()
    assert xp.shape == (len(lengths), (T - 1) * cfg.hop_len + cfg.n_fft)
    window = torch.hann_window(cfg.n_fft, dtype=torch.float64)
    got = torch.fft.rfft(xp.unfold(-1, cfg.n_fft, cfg.hop_len) * window)
    W = cfg.chunk_samples
    x30 = torch.zeros(len(lengths), W, dtype=torch.float64)
    for i, m in enumerate(lengths):
        m = min(m, W, N)
        x30[i, :m] = x[i, :m]
    want = torch.stft(x30, cfg.n_fft, cfg.hop_len, window=window, center=True,
                      pad_mode="reflect", return_complex=True)[..., :-1]
    assert got.shape[1] == want.shape[2] == T
    torch.testing.assert_close(got, want.transpose(1, 2), rtol=0, atol=1e-12)


def test_mel_bank_matches_hugging_face():
    fe = _hf_extractor(30)
    np.testing.assert_allclose(whisper.front(WHISPER128).bank,
                               fe.mel_filters, rtol=0, atol=1e-15)
    np.testing.assert_allclose(
        ref.mel_filters(ref.Settings(dataclasses.asdict(WHISPER128))).T,
        fe.mel_filters, rtol=0, atol=1e-15)


@pytest.mark.parametrize("chunk_s,N,lengths", [
    (1, 20000, [20000, 9000, 16000, 0]),
    (30, 400000, [400000, 123457]),
])
def test_features_match_hugging_face(chunk_s, N, lengths):
    fe = _hf_extractor(chunk_s)
    cfg = WhisperConfig(chunk_s=float(chunk_s)).validate()
    x = _audio(len(lengths), N, seed=chunk_s)
    feat, _, _ = whisper.whisper_log_mel_batch(x, torch.tensor(lengths), cfg)
    rows = [x[i, :m].double().numpy() / 32768.0 for i, m in enumerate(lengths)]
    hf = fe(rows, sampling_rate=16000, return_tensors="np")["input_features"]
    np.testing.assert_allclose(feat.numpy(), hf.transpose(0, 2, 1), rtol=0,
                               atol=HF_TOL)


def test_each_row_is_floored_at_its_own_maximum():
    """A silent, a quiet (-60 dBFS) and a loud row in one batch: each
    equals its own row computed alone; the silent row is log10(1e-10)'s
    (-10 + 4) / 4 everywhere (to float32's rounding of the natural log's
    affine); the loud row's zero frames sit on its floor, 2 under its
    maximum (80 dB: 8 in log10, over 4), and the quiet row's lie under
    that floor, at -1.5: the loud row's maximum does not floor them."""
    x = torch.cat([torch.zeros(1, 20000, dtype=torch.int16), _audio(1, 20000, 33),
                   _audio(1, 20000, 20000)])
    n = torch.tensor([20000, 10000, 10000])
    feat, _, _ = whisper.whisper_log_mel_batch(x, n, SHORT)
    assert torch.all(feat[0] == feat[0, 0, 0])
    assert float(feat[0, 0, 0]) == pytest.approx(-1.5, abs=1e-6)
    for i in (1, 2):
        alone, _, _ = whisper.whisper_log_mel_batch(x[i:i + 1], n[i:i + 1],
                                                    SHORT)
        torch.testing.assert_close(feat[i:i + 1], alone, rtol=0, atol=1e-6)
    loud = feat[2]
    assert float(loud.min()) == pytest.approx(float(loud.max()) - 2.0, abs=1e-6)
    assert float(loud[-1].max()) == float(loud.min())      # a zero frame
    assert float(feat[1].min()) == pytest.approx(-1.5, abs=1e-6)
    assert float(feat[1].min()) < float(loud.min())


def _stages_of_each_batch(prof):
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events()
             if e.device_type != DeviceType.CUDA and e.name.startswith("feat.")]
    batches = [s for s in spans if s[0] == "feat.batch"]
    inside = {b[1]: set() for b in batches}
    for name, s, e in spans:
        if name != "feat.batch":
            (owner,) = [b for b in batches if b[1] <= s and e <= b[2]]
            inside[owner[1]].add(name)
    return inside


def test_spans_and_frame_counter_under_a_profiler():
    x, n = _audio(3, 12000), torch.tensor([12000, 5000, 0])
    report.reset()
    with profile() as prof:
        whisper.whisper_log_mel_batch(x, n, SHORT)
        whisper.whisper_log_mel_batch(x[:2], n[:2], SHORT)
    inside = _stages_of_each_batch(prof)
    assert len(inside) == 2 and all(s == STAGES for s in inside.values())
    assert report.counters()["frames_computed"] == 5 * SHORT.num_frames()
    assert "feat.whisper_norm" in report.span_names()


def test_no_profiler_no_range_and_no_count(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a range entered without a profiler")
    monkeypatch.setattr(report, "_RecordFunctionFast", refuse)
    report.reset()
    whisper.whisper_log_mel_batch(_audio(2, 8000), torch.tensor([8000, 10]),
                                  SHORT)
    assert report.counters()["frames_computed"] == 0


def test_frames_direct_counts_the_calls_that_run_a_direct_tile(monkeypatch):
    """``_spectral.launch_spectral`` counts B x T in ``frames_direct`` for a
    call that runs a direct tile (n_fft 401; Whisper's front on the direct
    tile named), and nothing for an FFT tile (Whisper's own pick, the
    mixed-radix tile), for another entry's other tile (the DIT tile) or
    with no profiler recording.  The launch itself is a stand-in here."""
    import contextlib
    import types
    from mfcc_tpu_torch import FeatureConfig

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(_spectral, "_device_fft_matrices",
                        lambda *a: (None,) * 6)
    consts = ("direct", lambda cfg, dev: ([None, 0, None, None], None),
              [None, 0, None, None])
    dit = ("dit",) + consts[1:]
    x = torch.zeros(3, 16000)
    odd = FeatureConfig(n_fft=401, n_mels=80, n_mfcc=80).validate()
    kcfg, front = SHORT.feature_config(), whisper.front(SHORT)
    T = odd.num_frames(16000)

    def launch(cfg, tile=None, other=consts, front=None):
        """-> the tile the one launch recorded ran."""
        before = report.launches()
        _spectral.launch_spectral(
            Lib, "entry", "fused_raw", x, cfg, False, 0.0, other=other,
            tile=tile, front=front, mixed=True)
        ran = report.launches() - before
        assert ran["fused_raw"] == 1, ran
        (tile,) = (k[1] for k in ran if k != "fused_raw")
        return tile

    report.reset()
    assert launch(odd) == "direct"
    assert report.counters()["frames_direct"] == 0      # no profiler
    with profile():
        assert launch(odd) == "direct"
        assert launch(kcfg, front=front) == "fft64_mixed"
        assert launch(kcfg, tile="direct", front=front) == "direct"
        assert launch(odd, other=dit) == "dit"
        assert launch(FeatureConfig(n_mels=80, n_mfcc=80)) == "fft64"
    assert report.counters()["frames_direct"] == 3 * T + 3 * kcfg.num_frames(
        16000)


# Edge lengths of a 30 s row: the left reflect pad (n_fft / 2 = 200), hop
# multiples, a 16-frame tile's edge (frame 160 starts at 25,600 = 200 +
# 25,400), 25 s, the right reflect pad's limit (it reflects samples
# 479,959-479,998 of the row), the window and past it.
EDGE_LENGTHS = [0, 1, 199, 200, 201, 15_999, 16_000, 16_001, 25_399, 25_400,
                25_401, 400_000, 479_959, 479_960, 479_999, 480_000, 496_000]


def _skip_args(cfg, n):
    """(offset, chunk, row samples) of ``framing.stft_center_batch``'s rows
    for a config, as ``models/whisper`` hands them to the kernel."""
    return cfg.n_fft // 2, cfg.chunk_samples, n


@pytest.mark.parametrize("length", EDGE_LENGTHS)
def test_skip_rule_reads_only_the_zeros_the_centring_wrote(length):
    """The mixed tile's skip rule (``_spectral.zero_tail``, the twin of
    ``spectral::zero_tail``, and ``first_skipped_frame``) against
    ``framing.stft_center_batch``'s output: every sample from the zero tail
    on is exactly zero, the one before it is the row's last sample, and
    every frame of a skipped tile of any width reads (its predecessor
    included) exact zeros alone; a row whose right reflect pad reflects a
    sample of its own skips nothing."""
    cfg = WHISPER128
    x = torch.randn(1, 496_000, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(length))
    xp = framing.stft_center_batch(x, torch.tensor([length]), cfg)[0]
    L, hop, T = xp.shape[0], cfg.hop_len, cfg.num_frames()
    offset, chunk, n = _skip_args(cfg, L)
    z = _spectral.zero_tail(length, offset, chunk, n)
    assert not xp[z:].any()
    pad = n - offset - chunk
    if length > chunk - 1 - pad:                 # the reflect limit, or past
        assert z == n and length >= 479_960
    else:
        assert z == offset + length
        if length:
            assert xp[z - 1] == x[0, length - 1] != 0
    for tm in (8, 16, 32, 64):
        first = _spectral.first_skipped_frame(length, offset, chunk, n, hop,
                                              tm)
        assert first % tm == 0 and first * hop > z
        assert first - tm < 0 or (first - tm) * hop <= z   # the first one
        for t in range(first, T):
            assert not xp[t * hop - 1:t * hop + cfg.n_fft].any(), (tm, t)
        if z == n:
            assert first >= T


@pytest.fixture(scope="module")
def kernel_zero_tail(tmp_path_factory):
    """``spectral::zero_tail`` from ``csrc/fft_tile.cuh``, built for the host
    with g++: zero_tail(length, offset, chunk, n) -> int."""
    import re
    import shutil
    import subprocess
    from mfcc_tpu_torch.ops.kernels import _build
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    text = (_build.CSRC / "fft_tile.cuh").read_text()
    fn = re.search(r"__host__ __device__ inline long long zero_tail\(.*?\n}\n",
                   text, re.S).group(0)
    d = tmp_path_factory.mktemp("zero_tail")
    (d / "main.cc").write_text(
        "#include <cstdio>\n#include <cstdlib>\n#define __host__\n"
        "#define __device__\n" + fn +
        "int main(int c, char** v) {\n  for (int i = 1; i + 3 < c; i += 4)\n"
        "    std::printf(\"%lld\\n\", zero_tail(std::atoll(v[i]), "
        "std::atoll(v[i + 1]), std::atoll(v[i + 2]), std::atoll(v[i + 3])));"
        "\n}\n")
    subprocess.run(["g++", "-O1", "-o", str(d / "zt"), str(d / "main.cc")],
                   check=True)

    def call(cases):
        out = subprocess.run([str(d / "zt"), *map(str, np.ravel(cases))],
                             check=True, capture_output=True, text=True)
        return [int(v) for v in out.stdout.split()]
    return call, text


def test_host_twin_is_the_kernels_skip_rule(kernel_zero_tail):
    """``_spectral.zero_tail`` gives ``spectral::zero_tail``'s value on every
    edge length, at the 30 s window (a right reflect pad of 40 samples), a
    window of a whole number of hops (1 s) and one that frames no right
    pad (1.003 s); the kernel skips a tile from frame t0 where t0 hop is
    past it, as ``first_skipped_frame`` reads it."""
    call, text = kernel_zero_tail
    assert "s0 > zero_tail(__ldg(q.lengths + b)" in text
    cases = []
    for chunk_s in (30.0, 1.0, 1.003):
        cfg = WhisperConfig(chunk_s=chunk_s).validate()
        n = (cfg.num_frames() - 1) * cfg.hop_len + cfg.n_fft
        W = cfg.chunk_samples
        for length in EDGE_LENGTHS + [-3, W - 41, W - 40, W - 1, W, W + 1]:
            cases.append((length, cfg.n_fft // 2, W, n))
    want = [_spectral.zero_tail(*c) for c in cases]
    assert call(cases) == want
    assert {w == c[3] for w, c in zip(want, cases)} == {True, False}


def test_launch_hands_the_mixed_tile_the_row_bounds(monkeypatch):
    """``_spectral.launch_spectral`` with ``mixed``: the entry's arguments
    after preemph are the lengths' pointer, the offset and the chunk (nulls
    without bounds), as many as ``entry_argtypes(mixed=True)`` declares;
    ``frames_bounded`` counts B x T for a call that runs the mixed tile
    with bounds while a profiler records, and nothing for the direct tile,
    for a call without bounds or with no profiler.  Bounds go only to an
    entry with the mixed tile, as (B,) contiguous int64 on x's device.  The
    launch itself is a stand-in here."""
    import contextlib
    import types

    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append(args) or 0

    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(_spectral, "_device_fft_matrices",
                        lambda *a: (None,) * 6)
    consts = ("direct", lambda cfg, dev: ([None, 0, None, None], None),
              [None, 0, None, None])
    kcfg, front = SHORT.feature_config(), whisper.front(SHORT)
    x = torch.zeros(3, 16000)
    lengths = torch.tensor([16000, 900, 0])
    bounds = _spectral.RowBounds(lengths, 200, SHORT.chunk_samples)
    T = kcfg.num_frames(16000)
    n_args = len(_spectral.entry_argtypes(_spectral.DIRECT_ARGTYPES, True,
                                          mixed=True))

    def launch(tile=None, bounds=bounds, mixed=True):
        _spectral.launch_spectral(
            Lib, "entry", "fused_raw", x, kcfg, False, 0.0, other=consts,
            tile=tile, front=front, mixed=mixed, bounds=bounds)
        args = calls[-1]
        assert len(args) == n_args
        return args[-10:-7]

    report.reset()
    assert launch() == (lengths.data_ptr(), 200, SHORT.chunk_samples)
    assert report.counters()["frames_bounded"] == 0      # no profiler
    with profile():
        launch()
        assert launch(bounds=None) == (None, 0, 0)
        launch(tile="direct")
        launch()
    assert report.counters()["frames_bounded"] == 2 * 3 * T
    with pytest.raises(ValueError, match="mixed tile"):
        launch(mixed=False)
    for bad in (lengths.to(torch.int32), lengths[:2], lengths.repeat(2)[::2]):
        with pytest.raises(ValueError, match="row lengths"):
            launch(bounds=_spectral.RowBounds(bad, 200, 16000))
    with pytest.raises(ValueError, match="offset"):
        launch(bounds=_spectral.RowBounds(lengths, -1, 16000))


def test_constants_are_built_once_and_counted_in_consts_s():
    cfg = WhisperConfig(chunk_s=0.75, n_mels=40, n_mfcc=40).validate()
    before = report.counters()["consts_s"]
    x, n = _audio(1, 8000), torch.tensor([8000])
    whisper.whisper_log_mel_batch(x, n, cfg)
    after = report.counters()["consts_s"]
    misses = _spectral.plain_front_constants.cache_info().misses
    whisper.whisper_log_mel_batch(x, n, cfg)
    assert after > before
    assert report.counters()["consts_s"] == after
    assert _spectral.plain_front_constants.cache_info().misses == misses


def test_direct_tile_tables_hold_whispers_window_and_bank():
    """The direct tile's float32 tables for Whisper: the basis folds the
    periodic Hann window (``torch.hann_window``) into the 400-point DFT,
    bins 0..199 in its one block and the Nyquist bin apart; the projection
    is the Hz triangle bank."""
    basis, last, melw, dctm = _spectral.direct_blocks(
        *spectrum.folded_dft(whisper.periodic_hann(400), 400),
        whisper.front(WHISPER128).bank, None)
    assert basis.shape == (1, 400, 512) and dctm is None
    w = torch.hann_window(400, dtype=torch.float64).numpy()
    t = np.arange(400)[:, None]
    k = np.arange(200)[None, :]
    np.testing.assert_allclose(basis[0, :, :200],
                               w[:, None] * np.cos(2 * np.pi * t * k / 400),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(basis[0, :, 256:456],
                               w[:, None] * np.sin(2 * np.pi * t * k / 400),
                               rtol=0, atol=1e-7)
    assert not basis[0, :, 200:256].any() and not basis[0, :, 456:].any()
    np.testing.assert_allclose(last[:, 0], w * np.cos(np.pi * np.arange(400)),
                               rtol=0, atol=1e-7)
    np.testing.assert_array_equal(
        melw, whisper.front(WHISPER128).bank.astype(np.float32))


def test_auto_on_a_card_reaches_fused_raw_with_whispers_constants(monkeypatch):
    """With a CUDA tensor "auto" resolves to the kernels: the spectral stage
    is one ``fused_raw`` call on the config's sizes (n_fft 400, no
    pre-emphasis, no DCT) with Whisper's front (its window and bank) and
    the rows' lengths as int64 row bounds (offset n_fft / 2, the window's
    samples), which the tile rule sends to the float64-front mixed-radix
    FFT tile (400 = 2^4 5^2; an 80 dB row floor is past the f32 tile's 50
    dB).  That tile's tables: the periodic Hann window, the 400 twiddles
    of n = 400 in float64, and bank chunks that cover every nonzero of the
    bank."""
    calls = []

    def fake(xp, kcfg, *, apply_dct, front, bounds):
        calls.append((kcfg, apply_dct, front, bounds))
        return _spectral.plain_front_features(xp, kcfg, front)

    monkeypatch.setattr(whisper.backend_lib, "resolve", lambda *a: "cuda")
    monkeypatch.setattr(fused_raw, "fused_features_raw", fake)
    got, _, _ = whisper.whisper_log_mel_batch(
        _audio(2, 9000), torch.tensor([9000, 4000], dtype=torch.int32), SHORT)
    ((kcfg, apply_dct, front, bounds),) = calls
    assert (kcfg.n_fft, kcfg.frame_len, kcfg.hop_len, kcfg.preemph,
            kcfg.n_mels, kcfg.dynamic_range_db) == (400, 400, 160, 0.0, 128,
                                                    None)
    assert apply_dct is False and front is whisper.front(SHORT)
    assert torch.equal(bounds.lengths, torch.tensor([9000, 4000]))
    assert bounds.lengths.dtype == torch.int64
    assert (bounds.offset, bounds.chunk) == (200, SHORT.chunk_samples)
    assert _spectral.fft_tile(kcfg, False, mixed=True) == "fft64_mixed"
    assert got.shape == (2, 100, 128)
    win, tw, chunk_w, chunks, band_chunks, dctm = _spectral.fft_tables(
        front.window, kcfg.n_fft, front.bank, None, "fft64_mixed")
    np.testing.assert_allclose(
        win, torch.hann_window(400, dtype=torch.float64).numpy(), rtol=0,
        atol=1e-15)
    ang = 2 * np.pi * np.arange(400) / 400
    assert win.dtype == tw.dtype == np.float64 and tw.shape == (400, 2)
    np.testing.assert_array_equal(tw, np.stack([np.cos(ang), np.sin(ang)], 1))
    bank = whisper.front(SHORT).bank.astype(np.float32)
    assert dctm is None and band_chunks.shape == (128, 2)
    sums = np.zeros_like(bank)
    for j, (c0, c1) in enumerate(band_chunks):
        for c in range(c0, c1):
            k0, k1 = chunks[c]
            assert k1 - k0 <= _spectral.MEL_CHUNK
            sums[k0:k1, j] += chunk_w[c, : k1 - k0]
    np.testing.assert_array_equal(sums, bank)


def test_fused_raw_refuses_direct_constants_on_the_cpu():
    """A front's constants run on the card only, and have no DCT."""
    with pytest.raises(ValueError, match="CUDA"):
        fused_raw.fused_features_raw(
            torch.zeros(1, 1000), SHORT.feature_config(), apply_dct=False,
            front=whisper.front(SHORT))
    with pytest.raises(ValueError, match="DCT"):
        fused_raw.fused_features_raw(
            torch.zeros(1, 1000), SHORT.feature_config(), apply_dct=True,
            front=whisper.front(SHORT))


def _tile_before(cfg, apply_dct, projection):
    """The tile rule as it stood before the mixed-radix tile: a power of
    two from 64 to 4096 that holds the frame and whose 8-frame tile fits,
    the f32 tile under ``routes.use_dit``, else fft64; else direct."""
    from mfcc_tpu_torch.ops.kernels import routes
    n = cfg.n_fft
    if not (64 <= n <= 4096 and n & (n - 1) == 0 and cfg.frame_len <= n):
        return "direct"
    tile = ("fft" if projection == "mel" and routes.use_dit(cfg, apply_dct)
            else "fft64")
    return (tile if _spectral.fft_smem_bytes(cfg, tile, 8, projection)
            <= _spectral.MAX_SMEM else "direct")


@pytest.mark.parametrize("n_fft", [64, 128, 256, 512, 1024, 2048, 4096, 8192])
def test_power_of_two_configs_keep_their_tile(n_fft):
    """Every power-of-two config gets the tile it got before the mixed
    tile, in an entry with it and without, for cepstra and every log-mel
    range and projection: the mixed tile takes only n_fft = 2^a 5^b."""
    from mfcc_tpu_torch import FeatureConfig
    sr, m = n_fft * 125 // 4, min(80, n_fft // 8)   # 25 ms frames fit
    seen = set()
    for kw in (dict(n_mels=min(26, m), n_mfcc=min(13, m)),
               dict(n_mels=m, n_mfcc=m),
               dict(n_mels=m, n_mfcc=m, dynamic_range_db=50.0),
               dict(n_mels=m, n_mfcc=m, frame_ms=n_fft * 1000.0 / sr)):
        cfg = FeatureConfig(sample_rate=sr, n_fft=n_fft, **kw).validate()
        for apply_dct in (True, False):
            for projection in ("mel", "bark", "spec"):
                want = _tile_before(cfg, apply_dct, projection)
                for mixed in (False, True):
                    assert _spectral.fft_tile(cfg, apply_dct, projection,
                                              mixed) == want
                seen.add(want)
    assert seen >= ({"direct"} if n_fft > 4096 else {"fft", "fft64"})


@pytest.mark.parametrize("bad,match", [
    (dict(preemph=0.97), "no such step"),
    (dict(deltas=True), "no such step"),
    (dict(frame_ms=20.0), "n_fft"),
    (dict(n_mfcc=13), "n_mfcc"),
    (dict(chunk_s=0.02), "chunk_s"),
])
def test_validate_refuses(bad, match):
    with pytest.raises(ValueError, match=match):
        WhisperConfig(**bad).validate()


def test_feature_config_is_still_the_jax_twin():
    """Whisper's fields live in a config of their own: FeatureConfig keeps
    the JAX package's fields and defaults, and the Whisper defaults are
    large-v3's (N_FFT 400, HOP_LENGTH 160, 30 s, 128 mels, 3,000 frames)."""
    jf = [(f.name, f.default)
          for f in dataclasses.fields(jax_config.FeatureConfig)]
    tf = [(f.name, f.default)
          for f in dataclasses.fields(torch_config.FeatureConfig)]
    assert tf == jf
    assert not issubclass(WhisperConfig, torch_config.FeatureConfig)
    assert (WHISPER128.n_fft, WHISPER128.hop_len, WHISPER128.chunk_samples,
            WHISPER128.n_mels, WHISPER128.num_frames()) == (
                400, 160, 480_000, 128, 3000)
    assert math.isclose(whisper.ROW_FLOOR_DB, 80.0)
