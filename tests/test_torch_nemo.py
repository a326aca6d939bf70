"""NeMo's ASR preprocessor (``models/nemo``) on the CPU: the entry against
the benchmark's float64 reference (``perfbench/reference/nemo``) on ragged
batches, the pre-emphasis and centring frame for frame against
``torch.stft(center=True, pad_mode="constant")``, the pre-emphasis's first
sample and the zero at a row's length, the additive guard against a
clamp, the per-feature statistics over each row's own valid frames, the
rule for rows of fewer than two valid frames, the features against Hugging
Face's ``ParakeetFeatureExtractor`` where transformers imports, the spans
and the counters under a profiler, the launch's guard argument and the
route to ``fused_raw``'s fft64 tile, and the config's checks.

Tolerances: the port computes NeMo's float32 chain, the reference in
float64.  A float32 DFT rounds ~1e-7 of a frame's largest bin; in a band
40-60 dB under it that is ~1e-5 to 1e-4 of the band's natural log, and
the normalization divides it by the band's sigma over the row (0.3-1.3
on these noise rows: the log of a single-bin band of noise has sigma
pi / sqrt(6)): 2.9e-5 measured on rows of 30 frames or more, and 1.0e-4 on
a row of two valid frames, whose sigma is the two frames' difference alone
and can be small; hence 2e-4 against the reference.  Hugging Face
computes in float32 too (its float32 ``torch.stft`` and bank, 1.0e-4 off
the reference here), so against it the two roundings add: 4e-4 (1.2e-4
measured).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import profile

from mfcc_tpu import config as jax_config
from mfcc_tpu_torch import config as torch_config, oracle
from mfcc_tpu_torch.config import NEMO128, NemoConfig
from mfcc_tpu_torch.models import nemo, whisper
from mfcc_tpu_torch.ops import framing, mel as mel_op
from mfcc_tpu_torch.ops.kernels import _spectral, fused_raw
from mfcc_tpu_torch.utils import report
from perfbench.reference import nemo as ref

REF_TOL = 2e-4   # the port's float32 chain against float64 (module note)
HF_TOL = 4e-4    # two float32 chains (module note)
STAGES = {"feat.cast", "feat.frames", "feat.spectral", "feat.mask",
          "feat.feature_norm"}


def _audio(B, N, scale=3000.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, N, generator=g) * scale).clamp(
        -32768, 32767).to(torch.int16)


def _settings(cfg=NEMO128):
    return dataclasses.asdict(cfg)


def _reference(x, lengths, cfg=NEMO128):
    """The float64 reference of int16 rows, or of float rows in [-1, 1]."""
    if x.dtype != torch.int16:
        x = x.double() * 32768.0
    return ref.features(x, lengths, _settings(cfg), False)


@pytest.mark.parametrize("N,lengths,dtype", [
    (20000, [20000, 16000, 9600, 4800], torch.int16),   # multiples of 160
    (20000, [16001, 9601, 20000, 321], torch.int16),    # one sample more
    (12345, [12345, 12344, 5000], torch.int16),         # N no hop multiple
    (16000, [16000, 7000, 15999], torch.float32),       # float input
])
def test_entry_matches_the_plain_reference(N, lengths, dtype):
    x = _audio(len(lengths), N)
    if dtype == torch.float32:
        x = x.to(torch.float32) / 32768.0
    n = torch.tensor(lengths)
    feat, flens, mask = nemo.nemo_log_mel_batch(x, n, NEMO128)
    T = 1 + N // 160
    assert feat.shape == (len(lengths), T, 128) and feat.dtype == torch.float32
    assert flens.dtype == torch.int32
    assert flens.tolist() == [m // 160 for m in lengths]
    want, wflens, wmask = _reference(x, n)
    assert torch.equal(flens.long(), wflens) and torch.equal(mask, wmask)
    assert not feat[~mask].any()
    np.testing.assert_allclose(feat.double().numpy(), want.numpy(), rtol=0,
                               atol=REF_TOL)


def test_the_padding_of_the_caller_is_not_read():
    """Samples past a row's length do not reach its features: a row
    padded with noise reads as the row padded with zeros."""
    x = _audio(2, 16000, seed=2)
    n = torch.tensor([16000, 8000])
    clean = x.clone()
    clean[1, 8000:] = 0
    got = nemo.nemo_log_mel_batch(x, n, NEMO128)[0]
    want = nemo.nemo_log_mel_batch(clean, n, NEMO128)[0]
    assert torch.equal(got, want)


@pytest.mark.parametrize("N,lengths", [
    (16000, [16000, 7000, 0]),
    (12345, [12345, 1, 161]),
    (400, [400, 399]),
])
def test_frames_are_torch_stft_centred_frames(N, lengths):
    """The centred rows' valid frames of 400 samples, windowed by the
    symmetric Hann window and transformed at 512 points, are
    ``torch.stft(center=True, pad_mode="constant")``'s frames of the
    pre-emphasized rows with the 400-point window centred in 512: frame
    for frame, bin for bin, in float64 (their phase differs by the
    window's offset of 56 points, which |X| does not see)."""
    cfg = NEMO128
    x = torch.randn(len(lengths), N, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    n = torch.tensor(lengths)
    xp = framing.nemo_center_batch(x, n, cfg)
    T = cfg.num_frames(N)
    assert xp.dtype == torch.float64
    assert xp.shape == (len(lengths), (T - 1) * 160 + 400)
    window = torch.hann_window(400, periodic=False, dtype=torch.float64)
    got = torch.fft.rfft(xp.unfold(-1, 400, 160) * window, n=512)
    y = torch.cat([x[:, :1], x[:, 1:] - 0.97 * x[:, :-1]], dim=1)
    y = y.masked_fill(torch.arange(N)[None, :] >= n[:, None], 0.0)
    want = torch.stft(y, 512, 160, win_length=400, window=window,
                      center=True, pad_mode="constant",
                      return_complex=True).transpose(1, 2)
    assert got.shape == want.shape == (len(lengths), T, 257)
    np.testing.assert_allclose(got.abs().numpy(), want.abs().numpy(),
                               rtol=0, atol=1e-12)


def test_preemphasis_first_sample_and_the_zero_at_the_length():
    """y[0] = x[0] (no predecessor), y[n] = x[n] - 0.97 x[n - 1] in
    float32, and y = 0 from the row's length on, whatever the padding
    holds; the 200 samples before a row are zeros."""
    x = torch.randn(2, 1000, generator=torch.Generator().manual_seed(3))
    n = torch.tensor([1000, 600])
    xp = framing.nemo_center_batch(x, n, NEMO128)
    P = NEMO128.center_offset
    assert P == 200 and not xp[:, :P].any()
    assert torch.equal(xp[:, P], x[:, 0])
    x64 = x.double()
    want = x64[:, 1:] - 0.97 * x64[:, :-1]     # within float32's rounding
    torch.testing.assert_close(xp[0, P + 1:P + 1000].double(), want[0],
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(xp[1, P + 1:P + 600].double(), want[1, :599],
                               rtol=0, atol=1e-6)
    assert float(xp[1, P + 599]) != 0.0
    assert not xp[1, P + 600:].any() and not xp[0, P + 1000:].any()


def test_the_additive_guard_is_not_a_clamp():
    """log(e + 2^-24) against log(max(e, 2^-24)) on one spectral stage:
    they differ by log1p(2^-24 / e) in every band, 6e-4 where e = 1e-4,
    which the port computes (not a clamp's 0)."""
    x = torch.randn(1, 8000, generator=torch.Generator().manual_seed(4))
    xp = framing.nemo_center_batch(x * 3e-3, torch.tensor([8000]), NEMO128)
    guard, kcfg = nemo.front(NEMO128), NEMO128.feature_config()
    clamp = _spectral.Front(guard.window, guard.bank)
    added = nemo.log_mel(xp, NEMO128)
    clamped = _spectral.plain_front_features(xp, kcfg, clamp)
    e = torch.exp(clamped.double())
    want = torch.log1p(2.0 ** -24 / e)
    near = (e > 5e-5) & (e < 2e-4)
    assert near.sum() > 100
    got = (added.double() - clamped.double())
    torch.testing.assert_close(got[near], want[near], rtol=0.02, atol=2e-6)
    assert float(got[near].max()) > 3e-4
    assert bool(((added.double() - clamped.double()) > 0).all())


def test_statistics_are_each_rows_own_valid_frames():
    """Two rows of different lengths in one batch: each band of each row
    is normalized over the row's own valid frames only (the mean and the
    Bessel-corrected sigma of ``torch.std``), the padded frames are zeros,
    and a row reads as it does alone."""
    x = _audio(2, 20000, seed=5)
    n = torch.tensor([20000, 9000])
    feat, flens, mask = nemo.nemo_log_mel_batch(x, n, NEMO128)
    logs = nemo.log_mel(framing.nemo_center_batch(
        x.to(torch.float32) / 32768.0, n, NEMO128), NEMO128)
    for b, k in enumerate(flens.tolist()):
        own = logs[b, :k].double()
        want = (own - own.mean(0)) / (own.std(0) + 1e-5)
        np.testing.assert_allclose(feat[b, :k].double().numpy(),
                                   want.numpy(), rtol=0, atol=2e-5)
        assert not feat[b, k:].any()
        assert (feat[b, :k].double().mean(0).abs() < 1e-5).all()
    alone = nemo.nemo_log_mel_batch(x[1:, :9000], n[1:], NEMO128)[0]
    np.testing.assert_allclose(feat[1, :56].numpy(), alone[0, :56].numpy(),
                               rtol=0, atol=2e-5)


def test_rows_of_fewer_than_two_valid_frames_are_zeros():
    """NeMo raises and Hugging Face writes NaN for a row with fewer than
    two valid frames; the port writes zeros there (its count of 0 or 1
    taken as 1), and a row of two valid frames reads +-1 / sqrt(2) less
    the epsilon's share: +-(d / 2) / (d / sqrt(2) + 1e-5), d the two
    frames' difference."""
    x = _audio(5, 2000, seed=6)
    n = torch.tensor([0, 159, 160, 319, 320])
    feat, flens, mask = nemo.nemo_log_mel_batch(x, n, NEMO128)
    assert flens.tolist() == [0, 0, 1, 1, 2]
    assert mask.sum(1).tolist() == [0, 0, 1, 1, 2]
    assert bool(torch.isfinite(feat).all()) and not feat[:4].any()
    two = feat[4, :2].double()
    assert bool((two.abs() <= 0.5 ** 0.5 + 1e-3).all())
    assert float(two.abs().median()) > 0.7
    assert not feat[4, 2:].any()
    want, _, _ = _reference(x, n)
    np.testing.assert_allclose(feat.double().numpy(), want.numpy(), rtol=0,
                               atol=REF_TOL)


def _hf_extractor():
    """Hugging Face's ``ParakeetFeatureExtractor`` at 128 features without
    its ``__init__``, which needs librosa: the bank is
    ``mel_filter_bank``'s Slaney one, as librosa's."""
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


def test_mel_bank_matches_hugging_face():
    """NeMo's bank is the Hz triangle matrix at n_fft 512: 504 nonzeros,
    25 bands of a single bin, none empty."""
    pytest.importorskip("transformers")
    from transformers.audio_utils import mel_filter_bank
    bank = mel_op.hz_triangle_matrix(NEMO128)
    hf = mel_filter_bank(num_frequency_bins=257, num_mel_filters=128,
                         min_frequency=0.0, max_frequency=8000.0,
                         sampling_rate=16000, norm="slaney",
                         mel_scale="slaney")
    np.testing.assert_allclose(bank, hf, rtol=1e-12, atol=1e-15)
    per_band = np.count_nonzero(bank, axis=0)
    assert np.count_nonzero(bank) == 504 and per_band.min() == 1
    assert int((per_band == 1).sum()) == 25


@pytest.mark.parametrize("N,lengths", [
    (20000, [20000, 16001, 9600]),
    (9000, [9000, 321, 8999]),
])
def test_features_match_hugging_face(N, lengths):
    fe = _hf_extractor()
    x = _audio(len(lengths), N, seed=7)
    got, flens, mask = nemo.nemo_log_mel_batch(x, torch.tensor(lengths),
                                               NEMO128)
    out = fe([x[i, :m].numpy().astype(np.float32) / 32768.0
              for i, m in enumerate(lengths)], sampling_rate=16000,
             return_tensors="pt")
    hf, hmask = out["input_features"], out["attention_mask"]
    assert hf.shape == got.shape and torch.equal(hmask, mask)
    np.testing.assert_allclose(got.numpy(), hf.numpy(), rtol=0, atol=HF_TOL)


def _stages_of_each_batch(prof):
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events()
             if e.device_type != DeviceType.CUDA
             and e.name.startswith("feat.")]
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
        nemo.nemo_log_mel_batch(x, n, NEMO128)
        nemo.nemo_log_mel_batch(x[:2], n[:2], NEMO128)
    inside = _stages_of_each_batch(prof)
    assert len(inside) == 2 and all(s == STAGES for s in inside.values())
    assert report.counters()["frames_computed"] == 5 * NEMO128.num_frames(
        12000)
    # the plain chain launches nothing, so it guards no kernel's frames
    assert report.counters()["frames_guarded"] == 0
    assert {"feat.feature_norm", "feat.frames"} <= report.span_names()


def test_launch_hands_the_guard_and_counts_its_frames(monkeypatch):
    """``_spectral.launch_spectral`` on NeMo's front: the entry's argument
    before the row bounds is 1 (0 on Whisper's front and without a front),
    and ``frames_guarded`` counts B x T of each such call while a profiler
    records; a guard front on any tile but "fft64", or on an entry without
    the mixed tile, is refused.  The launch itself is a stand-in here."""
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
    kcfg = NEMO128.feature_config()
    wcfg = torch_config.WhisperConfig(chunk_s=1.0).validate()
    x = torch.zeros(3, 16000)
    n_args = len(_spectral.entry_argtypes(_spectral.DIRECT_ARGTYPES, True,
                                          mixed=True))

    def launch(cfg=kcfg, front=nemo.front(NEMO128), tile=None, mixed=True):
        _spectral.launch_spectral(
            Lib, "entry", "fused_raw", x, cfg, False, 0.0, other=consts,
            tile=tile, front=front, mixed=mixed)
        args = calls[-1]
        assert len(args) == n_args
        return args[-11]

    T = kcfg.num_frames(16000)
    report.reset()
    assert launch() == 1
    assert report.counters()["frames_guarded"] == 0      # no profiler
    with profile():
        assert launch() == 1
        assert launch(front=None) == 0
        assert launch(wcfg.feature_config(), whisper.front(wcfg)) == 0
        assert launch() == 1
    assert report.counters()["frames_guarded"] == 2 * 3 * T
    for bad in (dict(tile="direct"), dict(tile="fft"), dict(mixed=False)):
        with pytest.raises(ValueError, match="guard"):
            launch(**bad)


def test_auto_on_a_card_reaches_fused_raw_with_nemos_constants(monkeypatch):
    """With a CUDA tensor "auto" resolves to the kernels: the spectral stage
    is one ``fused_raw`` call on the config's sizes (n_fft 512, frames of
    400, hop 160, no pre-emphasis, no DCT) with NeMo's front: the
    symmetric Hann window (``torch.hann_window(400, periodic=False)``),
    the Hz triangle bank and the guard, which the tile rule sends to the
    float64-front FFT tile "fft64" (unbounded log-mel at a power of two),
    with no row bounds."""
    calls = []

    def fake(xp, kcfg, *, apply_dct, front):
        calls.append((kcfg, apply_dct, front))
        return _spectral.plain_front_features(xp, kcfg, front)

    monkeypatch.setattr(nemo.backend_lib, "resolve", lambda *a: "cuda")
    monkeypatch.setattr(fused_raw, "fused_features_raw", fake)
    got, _, _ = nemo.nemo_log_mel_batch(
        _audio(2, 9000), torch.tensor([9000, 4000], dtype=torch.int32),
        NEMO128)
    ((kcfg, apply_dct, front),) = calls
    assert (kcfg.n_fft, kcfg.frame_len, kcfg.hop_len, kcfg.preemph,
            kcfg.n_mels, kcfg.dynamic_range_db) == (512, 400, 160, 0.0, 128,
                                                    None)
    assert apply_dct is False and front is nemo.front(NEMO128) and front.guard
    assert kcfg.log_floor == 2.0 ** -24
    assert _spectral.fft_tile(kcfg, False, mixed=True) == "fft64"
    assert got.shape == (2, 57, 128)
    np.testing.assert_allclose(
        front.window, torch.hann_window(400, periodic=False,
                                        dtype=torch.float64).numpy(),
        rtol=0, atol=1e-15)
    np.testing.assert_array_equal(front.bank,
                                  mel_op.hz_triangle_matrix(NEMO128))
    win, tw, chunk_w, chunks, band_chunks, dctm = _spectral.fft_tables(
        front.window, 512, front.bank, None, "fft64")
    assert win.dtype == tw.dtype == np.float64 and tw.shape == (512, 2)
    assert dctm is None and band_chunks.shape == (128, 2)
    assert int((chunks[:, 1] - chunks[:, 0]).sum()) == 504


def test_constants_are_built_once_and_counted_in_consts_s():
    cfg = NemoConfig(n_mels=40, n_mfcc=40).validate()
    before = report.counters()["consts_s"]
    x, n = _audio(1, 8000), torch.tensor([8000])
    nemo.nemo_log_mel_batch(x, n, cfg)
    after = report.counters()["consts_s"]
    misses = _spectral.plain_front_constants.cache_info().misses
    nemo.nemo_log_mel_batch(x, n, cfg)
    assert after > before
    assert report.counters()["consts_s"] == after
    assert _spectral.plain_front_constants.cache_info().misses == misses


def test_a_front_without_the_guard_is_the_configs_own_chain():
    """``plain_front_features`` on a config's own window and mel matrix,
    with no guard, is the plain log-mel chain of that config, bit for bit
    (Whisper's chain moved there without a change of its bits)."""
    cfg = torch_config.FeatureConfig(n_mels=40, n_mfcc=40, preemph=0.0,
                                     window="hann").validate()
    x = torch.randn(2, 8000, generator=torch.Generator().manual_seed(8))
    front = _spectral.Front(oracle.window_fn("hann", cfg.frame_len),
                            mel_op.mel_matrix(cfg))
    got = _spectral.plain_front_features(x, cfg, front)
    want = fused_raw.plain_features(x, cfg, False)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("bad,match", [
    (dict(dither=1.0), "no such step"),
    (dict(cmvn=True), "no such step"),
    (dict(window="hamming"), "no such step"),
    (dict(n_fft=400), "power of two"),
    (dict(frame_ms=40.0), "frame_len"),
    (dict(n_mfcc=13), "n_mfcc"),
    (dict(preemph=1.0), "preemph"),
    (dict(log_guard="clamp"), "log_guard"),
    (dict(normalize="all_features"), "normalize"),
    (dict(norm_eps=0.0), "norm_eps"),
    (dict(fmax=None), "fmax"),
])
def test_validate_refuses(bad, match):
    with pytest.raises(ValueError, match=match):
        NemoConfig(**bad).validate()


def test_feature_config_is_still_the_jax_twin():
    """NeMo's fields live in a config of their own: FeatureConfig keeps the
    JAX package's fields and defaults, and the NeMo defaults are the
    Parakeet / Canary preprocessor's (n_fft 512, 400-sample windows at hop
    160, 128 bands to 8 kHz, pre-emphasis 0.97, guard 2^-24 added, sigma
    plus 1e-5)."""
    jf = [(f.name, f.default)
          for f in dataclasses.fields(jax_config.FeatureConfig)]
    tf = [(f.name, f.default)
          for f in dataclasses.fields(torch_config.FeatureConfig)]
    assert tf == jf
    assert not issubclass(NemoConfig, torch_config.FeatureConfig)
    assert (NEMO128.n_fft, NEMO128.frame_len, NEMO128.hop_len,
            NEMO128.n_mels, NEMO128.fmax, NEMO128.preemph) == (
                512, 400, 160, 128, 8000.0, 0.97)
    assert NEMO128.log_floor == 2.0 ** -24 and NEMO128.log_guard == "add"
    assert NEMO128.normalize == "per_feature"
    assert math.isclose(NEMO128.norm_eps, 1e-5)
    assert NEMO128.num_frames(16000) == 101 and NEMO128.center_offset == 200
