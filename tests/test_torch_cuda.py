"""Cases that need an NVIDIA GPU: each CUDA kernel against its plain
PyTorch version on the card (the FFT tile of the four spectral kernels
over n_fft 64..4096 in both flavours, the float64-front one also against
the float64 oracle, and the direct and DIT tiles where they still run),
the kernels' accurate log bit for bit, the wrappers' checks,
``fused_raw_dit``'s bark and spec projections against their plain versions
and the float64 oracle, the main paths (MFCC, log-mel through each
spectral route, PLP, the log spectrogram, pitch) through the kernels, the
dither hash on the card, packed segments at an odd frame offset against
their standalone kernel result, and the fused serving path against the
streaming scan path; the online pitch tracker's chunk NCCF, SpecAugment's
masks across devices, the trainable front end's forward pass, the online
CMVN pair at window 300, the distributed dry run on two ranks, the
roofline ladder's ``stage`` and ``fftlog`` rungs, and ``fused_nccf``
beyond shared memory (the lag-blocked tiling equal to the planner's
tiles, windows past the old limit against the float64 oracle,
``pitch_batch`` at a 4 s frame), ``accum_dtype`` on both routes
and the float16 reduction flag of ``backend.matmul_form``, and
``fused_deltas`` against its plain chain bit for bit (the cases of
``tests/test_torch_deltas.py``) and through the log-mel main path, and the
mixed-radix tile's skip of the frames in Whisper's 30 s zero padding (the
same bits, the tiles its host twin names, the ``frames_bounded`` count),
and NeMo's additive log guard on the fft64 tile (against the float64
oracle, through the batch entry against the benchmark's reference and the
plain route, the floors' bits with the guard off, the ``frames_guarded``
count).
All are
marked ``cuda`` and skip without a card.

This file imports no jax (the machine with the card has none), so it runs
there without the repository's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

from mfcc_tpu_torch import FeatureConfig, PitchConfig, oracle
from mfcc_tpu_torch.models import (logmel as logmel_model, mfcc as mfcc_model,
                                   pitch as pitch_model, plp as plp_model,
                                   spectrogram as spec_model, streaming)
from mfcc_tpu_torch.ops import (deltas, dither, framing, pitch as pitch_op,
                                resample, xmath)
from mfcc_tpu_torch.ops.kernels import (_spectral, fused_deltas, fused_dit,
                                        fused_mfcc, fused_nccf, fused_raw,
                                        fused_raw_dit, fused_viterbi)
from mfcc_tpu_torch.utils import batch as batch_lib, report, wav
from test_torch_deltas import CASES as DELTA_CASES, case as delta_case

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
TOL = 2e-5   # kernel vs XLA bound of tests/test_kernels.py
TINY = dict(sample_rate=2000, frame_ms=40, hop_ms=16, n_fft=128, n_mels=8,
            n_mfcc=4)
PITCH_TOL = (1e-4, 3e-4, 1e-4)   # pov, norm, delta (tests/test_pitch.py)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.fixture()
def gen():
    return np.random.default_rng(1234)


def _n(*key) -> int:
    """The launches recorded under a kernel, or under (kernel, tile or
    projection)."""
    return report.launches()[key if len(key) > 1 else key[0]]


def _launched(before) -> dict:
    """{key: launches} recorded since ``report.launches()`` was ``before``:
    by kernel and by (kernel, tile) and (kernel, projection)."""
    return dict(report.launches() - before)


def _tiles_ran(ran: dict, name: str) -> list:
    """The tiles kernel ``name`` ran in ``ran`` (of :func:`_launched`)."""
    return [k[1] for k in ran if isinstance(k, tuple) and k[0] == name
            and k[1] not in _spectral.PROJECTION_CODES]


def _unliftered_diff(a, b, cfg):
    lift = torch.from_numpy(oracle.lifter_coeffs(cfg.n_mfcc, cfg.lifter)
                            .astype(np.float32)).to(a.device)
    return float(((a - b) / lift).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("kw,shape", [
    (dict(), (64, 160000)),                 # the bench batch
    (dict(), (2, 33360)),                   # T=207, not a tile multiple
    (dict(lifter=22, append_energy=True), (3, 20000)),
    (dict(dynamic_range_db=50.0), (2, 16000)),
    (dict(preemph=0.0, window="hann"), (2, 16000)),
    (dict(sample_rate=8000, n_fft=256), (2, 8000)),
    (dict(sample_rate=48000, n_fft=2048), (2, 48000)),
    (TINY, (2, 2000)),
])
def test_kernel_matches_plain(cuda, gen, kw, shape):
    cfg = FeatureConfig(**kw).validate()
    x = torch.from_numpy((gen.standard_normal(shape) * 0.3)
                         .astype(np.float32)).to(cuda)
    before = _n("fused_raw_dit")
    got = fused_raw_dit.fused_features_raw_dit(x, cfg)
    torch.cuda.synchronize()
    assert _n("fused_raw_dit") == before + 1
    want = fused_raw_dit.plain_features(x, cfg)
    assert got.shape == want.shape
    assert _unliftered_diff(got, want, cfg) <= TOL


@pytest.mark.cuda
def test_wrapper_checks_and_short_input(cuda):
    cfg = FeatureConfig()
    with pytest.raises(TypeError):
        fused_raw_dit.fused_features_raw_dit(
            torch.zeros((1, 4000), dtype=torch.float64, device=cuda), cfg)
    with pytest.raises(ValueError):
        fused_raw_dit.fused_features_raw_dit(
            torch.zeros((4000, 2), device=cuda).t(), cfg)
    before = _n("fused_raw_dit")
    out = fused_raw_dit.fused_features_raw_dit(
        torch.zeros((1, 4000), device=cuda), cfg, apply_dct=False)
    assert tuple(out.shape) == (1, 23, 26)
    assert _n("fused_raw_dit") == before + 1
    before = _n("fused_raw_dit")
    out = fused_raw_dit.fused_features_raw_dit(
        torch.zeros((2, 399), device=cuda), cfg)
    assert tuple(out.shape) == (2, 0, 13)
    assert _n("fused_raw_dit") == before


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(deltas=True),
                                dict(frame_mode="center")])
def test_mfcc_batch_goes_through_the_kernel(cuda, gen, kw):
    cfg = FeatureConfig(**kw)
    lens = np.asarray([16000, 10666, 399], np.int32)
    x = np.round(gen.standard_normal((3, 16000)) * 8000).astype(np.int16)
    for i, n in enumerate(lens):
        x[i, n:] = 0
    before = _n("fused_raw_dit")
    gf, gfl, gm = mfcc_model.mfcc_batch(torch.from_numpy(x).to(cuda),
                                        torch.from_numpy(lens).to(cuda), cfg)
    torch.cuda.synchronize()
    assert _n("fused_raw_dit") == before + 1
    cf, cfl, cm = mfcc_model.mfcc_batch(torch.from_numpy(x),
                                        torch.from_numpy(lens), cfg)
    assert torch.equal(gfl.cpu(), cfl) and torch.equal(gm.cpu(), cm)
    assert float((gf.cpu() - cf)[cm].abs().max()) <= TOL
    assert bool((gf[~gm] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("fname,kw", [
    ("mfcc13.npy", dict()),
    ("mfcc13_center.npy", dict(frame_mode="center")),
    ("mfcc13_energy_lifter.npy", dict(lifter=22, append_energy=True)),
])
def test_goldens_on_the_card(cuda, fname, kw):
    cfg = FeatureConfig(**kw)
    x, _ = wav.read_wav(os.path.join(GOLDEN, "speech2s.wav"))
    feat = mfcc_model.mfcc(torch.from_numpy(x).to(cuda), cfg)
    want = np.load(os.path.join(GOLDEN, fname))
    lift = oracle.lifter_coeffs(cfg.n_mfcc, cfg.lifter)
    assert np.abs(feat.cpu().numpy() / lift - want / lift).max() <= 1e-4


def _vibrato(gen, n, f0=180.0):
    t = np.arange(n) / 16000
    phase = 2 * np.pi * f0 * (t + 0.1 / (2 * np.pi * 4.0)
                              * np.sin(2 * np.pi * 4.0 * t))
    x = sum(a * np.sin(h * phase) for h, a in ((1, 0.5), (2, 0.25), (3, 0.12)))
    return (x + 0.02 * gen.standard_normal(n)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,shape", [
    (dict(), (64, 160000)),                 # the main path's batch
    (dict(), (2, 33360)),                   # T=205, not a tile multiple
    (dict(work_rate=2000), (3, 32000)),
    (dict(min_f0=60.0, max_f0=300.0), (3, 32000)),
    (dict(hop_ms=15.25), (3, 32000)),
    (dict(sample_rate=8000), (2, 16000)),
    # frame tiles of 8 and of 1 (a 32-frame span exceeds shared memory),
    # 841 lags: 15 a thread in 8 passes
    (dict(sample_rate=48000, work_rate=48000, hop_ms=40.0), (2, 144000)),
    (dict(sample_rate=48000, work_rate=48000, hop_ms=200.0), (2, 144000)),
    (dict(), (3, 720)),                     # T=1
    # 54 lags, 7 a thread: 56 slots, the last lag group short
    (dict(min_f0=60.0, max_f0=300.0, hop_ms=12.5), (2, 32000)),
])
def test_nccf_kernel_matches_plain(cuda, gen, kw, shape):
    pcfg = PitchConfig(**kw).validate()
    x = torch.from_numpy(np.stack([_vibrato(gen, shape[1], 100.0 + 20 * i)
                                   for i in range(shape[0])])).to(cuda)
    xw = resample.resample(x, pcfg.sample_rate, pcfg.work_rate)
    T = pcfg.num_frames(shape[1])
    ball = torch.rand(shape[0], device=cuda)
    before = _n("fused_nccf")
    got = fused_nccf.fused_nccf(xw, ball, pcfg, T=T)
    torch.cuda.synchronize()
    assert _n("fused_nccf") == before + 1
    want = fused_nccf.plain_nccf(xw, ball, pcfg, T)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (shape[0], T, pcfg.n_lags)
        assert float((g - w).abs().max()) <= TOL    # every frame is valid
    shape = report.last_shape("fused_nccf")
    assert shape["R"] % 2 == 1 and 8 * shape["R"] * shape["passes"] >= \
        pcfg.n_lags > 8 * shape["R"] * (shape["passes"] - 1), shape


@pytest.mark.cuda
@pytest.mark.parametrize("K", [4, 128, 512])
def test_nccf_chunk_on_the_card_is_the_unchunked_kernel_route(cuda, gen, K):
    """``nccf_chunk=`` on a CUDA tensor: the bound is checked, then one
    ``fused_nccf`` launch over the unchunked rows, equal in every bit to
    ``nccf_chunk=None``, and within the kernel bound of the chunked plain
    route the CPU takes."""
    pcfg = PitchConfig()
    lens = np.asarray([96000, 70001, 4800], np.int32)
    x = np.zeros((3, 96000), np.float32)
    for i, n in enumerate(lens):
        x[i, :n] = _vibrato(gen, n, 110.0 + 40 * i)
    x, ln = torch.from_numpy(x).to(cuda), torch.from_numpy(lens).to(cuda)
    out = {}
    for k in (K, None):
        before = _n("fused_nccf")
        out[k] = pitch_op._track(x, ln, pcfg, nccf_chunk=k, backend="auto",
                                 precision="highest")
        torch.cuda.synchronize()
        assert _n("fused_nccf") == before + 1
    nb, npl, _, mask, route = out[K]
    assert route == out[None][4] == "cuda"
    assert all(torch.equal(a, b) for a, b in zip(out[K][:4], out[None][:4]))
    xw = resample.resample(x, pcfg.sample_rate, pcfg.work_rate)
    plain = pitch_op._nccf_chunked(xw, pcfg, mask, K, precision="highest")
    for g, p in zip((nb, npl), plain):
        assert float((g - p).abs()[mask].max()) <= TOL
    with pytest.raises(ValueError, match="nccf_chunk=3"):
        pitch_op.pitch_track(x, ln, pcfg, nccf_chunk=3)


@pytest.mark.cuda
def test_nccf_kernel_lag_energies_in_registers(cuda, gen):
    """A window too large for the tile's shared energies (40,399 samples,
    39,960 lags): the lag energies stay in each thread's registers, in the
    lag-blocked tiling the planner takes there (the one-frame register
    tile measured slower on the H100; chip_smoke.py phase 22).  The plain
    version's DFT matrices would be ~6 GB, so the plain NCCF is held to the
    float64 oracle instead, within the kernel bound."""
    pcfg = PitchConfig(sample_rate=16000, work_rate=16000,
                       min_f0=0.4).validate()
    n = pcfg.frame_len_w + pcfg.max_lag + 2 * pcfg.hop_len_w
    x = _vibrato(gen, n, 140.0)
    xw = torch.from_numpy(x[None]).to(cuda)
    T = pcfg.num_frames(n)
    got_b, got_p = fused_nccf.fused_nccf(xw, torch.zeros(1, device=cuda),
                                         pcfg, T=T)
    torch.cuda.synchronize()
    assert report.last_shape("fused_nccf")["shared_energy"] == 0
    assert report.last_shape("fused_nccf")["lag_block"] > 0
    _, want_p = oracle.nccf(x.astype(np.float64), pcfg)
    assert want_p.shape == tuple(got_p.shape[1:]) == (3, pcfg.n_lags)
    assert np.abs(got_p[0].cpu().numpy() - want_p).max() <= TOL
    assert torch.equal(got_b, got_p)        # ballast 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,kw", [
    (1, 1, {}), (3, 2, {}), (3, 65, {}), (64, 996, {}), (200, 150, {}),
    # 1,027 lags: more states than threads, transitions read from global
    (2, 65, dict(work_rate=16000, min_f0=15.0)),
    # tie-heavy: penalty 0 and scores in {-1, 0, 1}
    (64, 996, dict(penalty=0.0)),
    # 256 lags (byte backpointers) and 257 (uint16)
    (4, 996, dict(min_f0=15.09)), (4, 996, dict(min_f0=15.0)),
    # a 6-minute stream unblocked: its backpointers spill in time blocks
    (1, 35996, {}),
])
def test_viterbi_kernel_exactly_equal(cuda, gen, B, T, kw):
    pcfg = PitchConfig(**kw).validate()
    if pcfg.penalty == 0.0:
        s = gen.integers(-1, 2, (B, T, pcfg.n_lags)).astype(np.float32)
    else:
        s = (0.5 * gen.standard_normal((B, T, pcfg.n_lags))).astype(np.float32)
    s[1::2, T * 2 // 3:] = 0.0
    s = torch.from_numpy(s).to(cuda)
    before = _n("fused_viterbi")
    got = fused_viterbi.fused_viterbi(s, pcfg)
    torch.cuda.synchronize()
    assert _n("fused_viterbi") == before + 1
    assert torch.equal(got, pitch_op.viterbi(s, pcfg))
    blocked = pitch_op.viterbi_blocked(s, pcfg, block=32, warm=16)
    assert torch.equal(blocked, pitch_op.viterbi_blocked(
        s, pcfg, block=32, warm=16, backend="torch"))


@pytest.mark.cuda
def test_pitch_wrappers_raise_instead_of_falling_back(cuda):
    pcfg = PitchConfig()
    xw = torch.zeros((1, 4000), device=cuda)
    with pytest.raises(TypeError):
        fused_nccf.fused_nccf(xw.double(), torch.zeros(1, device=cuda),
                              pcfg, T=90)
    with pytest.raises(TypeError):
        fused_viterbi.fused_viterbi(
            torch.zeros((1, 5, pcfg.n_lags), dtype=torch.float64,
                        device=cuda), pcfg)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pitch_model.pitch_batch(torch.zeros((1, 16000)),
                                torch.tensor([16000]), pcfg, "cuda")
    # no window limit: 63,961 lags, one launch on a few frames (not
    # pitch_batch, whose Viterbi transition matrix would be 16 GB here)
    big = PitchConfig(work_rate=16000, min_f0=0.25).validate()
    before = _n("fused_nccf")
    got = fused_nccf.fused_nccf(torch.ones((1, 70000), device=cuda),
                                torch.zeros(1, device=cuda), big, T=3)
    torch.cuda.synchronize()
    assert _n("fused_nccf") == before + 1
    assert report.last_shape("fused_nccf")["lag_block"] > 0
    assert all(g.shape == (1, 3, big.n_lags) and bool(torch.isfinite(g).all())
               for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_pitch_batch_goes_through_the_kernels(cuda, gen, dtype):
    pcfg = PitchConfig()
    lens = np.asarray([32000, 21333, 4800, 715], np.int32)
    x = np.zeros((4, 32000), np.float32)
    for i, n in enumerate(lens):
        x[i, :n] = _vibrato(gen, n, 110.0 + 40 * i)
    if dtype == "int16":
        x = np.round(x * 32767).astype(np.int16)
    before = (_n("fused_nccf"), _n("fused_viterbi"))
    gf, gfl, gm = pitch_model.pitch_batch(torch.from_numpy(x).to(cuda),
                                          torch.from_numpy(lens).to(cuda),
                                          pcfg)
    torch.cuda.synchronize()
    assert (_n("fused_nccf"), _n("fused_viterbi")) == \
        (before[0] + 1, before[1] + 1)
    cf, cfl, cm = pitch_model.pitch_batch(torch.from_numpy(x),
                                          torch.from_numpy(lens), pcfg)
    assert torch.equal(gfl.cpu(), cfl) and torch.equal(gm.cpu(), cm)
    assert bool((gf[~gm] == 0).all())
    xf = x.astype(np.float64) / (32768.0 if dtype == "int16" else 1.0)
    for i, n in enumerate(lens):
        want = oracle.pitch(xf[i, :n], pcfg)
        got = gf[i, : want.shape[0]].cpu().numpy()
        for c, tol in enumerate(PITCH_TOL):
            assert np.abs(got[:, c] - want[:, c]).max(initial=0.0) < tol


@pytest.mark.cuda
def test_pitch_golden_on_the_card(cuda):
    x, _ = wav.read_wav(os.path.join(GOLDEN, "speech2s.wav"))
    feat = pitch_model.pitch(torch.from_numpy(x).to(cuda), PitchConfig())
    want = np.load(os.path.join(GOLDEN, "pitch3.npy"))
    got = feat.cpu().numpy()
    assert got.shape == want.shape
    for c, tol in enumerate(PITCH_TOL):
        assert np.abs(got[:, c] - want[:, c]).max() < tol


# windows beyond what one whole window in shared memory allowed (58,000
# samples), at 16 kHz: the lag-blocked tiling
BEYOND = {"many lags": dict(work_rate=16000, min_f0=0.25),       # 63,961 lags
          "wide frame": dict(work_rate=16000, frame_ms=4000.0)}  # w = 64,000


@pytest.fixture(scope="module")
def tiling_libs():
    """``tools/ablate_pitch.py``'s builds that plan the lag-blocked tiling
    for every config (``nccf_lag_blocked``) and at the widest R whatever
    the grid (``nccf_lag_widest``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from mfcc_tpu_torch.tools import ablate_pitch
    return ablate_pitch.build(ablate_pitch.TILINGS)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,shape", [
    (dict(), (64, 160000)),                          # the main path's batch
    (dict(work_rate=16000, min_f0=15.0), (3, 32000)),   # 1,027 lags
])
def test_nccf_lag_blocked_tiling_equals_the_planner(cuda, gen, tiling_libs,
                                                    kw, shape):
    """The lag-blocked tiling forced on configs the whole-window tiles take:
    both outputs equal in every bit (every sum is the same fmaf chain)."""
    pcfg = PitchConfig(**kw).validate()
    x = torch.from_numpy(np.stack([_vibrato(gen, shape[1], 100.0 + 20 * i)
                                   for i in range(shape[0])])).to(cuda)
    xw = resample.resample(x, pcfg.sample_rate, pcfg.work_rate)
    T = pcfg.num_frames(shape[1])
    ball = torch.rand(shape[0], device=cuda)
    want = fused_nccf.fused_nccf(xw, ball, pcfg, T=T)
    assert report.last_shape("fused_nccf")["lag_block"] == 0
    *got, tile = fused_nccf.launch(tiling_libs["nccf_lag_blocked"], xw,
                                   ball, pcfg, T)
    torch.cuda.synchronize()
    assert tile["lag_block"] > 0 and tile["sample_chunk"] > 0, tile
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("kw,B,T", [
    (dict(work_rate=16000, frame_ms=4000.0), 2, 6),
    (dict(work_rate=16000, frame_ms=2000.0, min_f0=0.5), 1, 4),
])
def test_nccf_short_grid_lags_a_thread_change_no_bit(cuda, gen, tiling_libs,
                                                     kw, B, T):
    """On a grid shorter than the SMs the planner takes fewer lags a
    thread than the widest R: more blocks, the same outputs in every
    bit."""
    pcfg = PitchConfig(**kw).validate()
    n = pcfg.frame_len_w + pcfg.max_lag + (T - 1) * pcfg.hop_len_w
    xw = torch.from_numpy(np.stack([_vibrato(gen, n, 120.0 + 40 * i)
                                    for i in range(B)])).to(cuda)
    ball = torch.rand(B, device=cuda)
    want = fused_nccf.fused_nccf(xw, ball, pcfg, T=T)
    tile = report.last_shape("fused_nccf")
    *got, widest = fused_nccf.launch(tiling_libs["nccf_lag_widest"], xw,
                                     ball, pcfg, T)
    torch.cuda.synchronize()
    assert tile["lag_block"] > 0 and tile["R"] < widest["R"], (tile, widest)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["many lags", "wide frame"])
def test_nccf_beyond_shared_memory_matches_the_oracle(cuda, gen, name):
    """Windows beyond the old 58,000-sample limit, one launch in the
    lag-blocked tiling (the wide frame in sample chunks), on two ragged
    rows: every valid frame within 2e-5 of the float64 oracle at the
    kernel's ballast, ballasted and plain."""
    pcfg = PitchConfig(**BEYOND[name]).validate()
    hop, need = pcfg.hop_len_w, pcfg.frame_len_w + pcfg.max_lag
    lens = [need + 5 * hop, need + 2 * hop]
    x = np.zeros((2, lens[0]), np.float32)
    for i, n in enumerate(lens):
        x[i, :n] = _vibrato(gen, n, 140.0 + 60 * i)
    xw = torch.from_numpy(x).to(cuda)
    ball = torch.tensor([0.5, 0.25], device=cuda)
    before = _n("fused_nccf")
    got = fused_nccf.fused_nccf(xw, ball, pcfg, T=6)
    torch.cuda.synchronize()
    assert _n("fused_nccf") == before + 1
    assert report.last_shape("fused_nccf")["lag_block"] > 0
    for i, n in enumerate(lens):
        x64 = x[i, :n].astype(np.float64)
        T = pcfg.num_frames(n)
        e0 = np.mean([np.square(x64[t * hop: t * hop + pcfg.frame_len_w]).sum()
                      for t in range(T)])
        want = oracle.nccf(x64, pcfg.replace(
            ballast=float(ball[i]) / e0 ** 2))
        for g, w in zip(got, want):
            assert w.shape == (T, pcfg.n_lags)
            assert np.abs(g[i, :T].cpu().numpy() - w).max() <= TOL


@pytest.mark.cuda
def test_pitch_batch_at_a_wide_frame_goes_through_the_kernels(cuda, gen):
    """pitch_batch at a 64,000-sample frame (frame_ms=4000 at 16 kHz), two
    ragged int16 rows: one fused_nccf and one fused_viterbi launch, the
    features within the contract's bounds of the float64 oracle."""
    pcfg = PitchConfig(**BEYOND["wide frame"]).validate()
    lens = np.asarray([72000, 66000], np.int32)
    x = np.zeros((2, 72000), np.float32)
    for i, n in enumerate(lens):
        x[i, :n] = _vibrato(gen, n, 120.0 + 50 * i)
    x = np.round(x * 32767).astype(np.int16)
    before = (_n("fused_nccf"), _n("fused_viterbi"))
    gf, gfl, gm = pitch_model.pitch_batch(torch.from_numpy(x).to(cuda),
                                          torch.from_numpy(lens).to(cuda),
                                          pcfg)
    torch.cuda.synchronize()
    assert (_n("fused_nccf"), _n("fused_viterbi")) == \
        (before[0] + 1, before[1] + 1)
    assert gfl.cpu().tolist() == [pcfg.num_frames(int(n)) for n in lens]
    assert bool((gf[~gm] == 0).all())
    xf = x.astype(np.float64) / 32768.0
    for i, n in enumerate(lens):
        want = oracle.pitch(xf[i, :n], pcfg)
        got = gf[i, : want.shape[0]].cpu().numpy()
        for c, tol in enumerate(PITCH_TOL):
            assert np.abs(got[:, c] - want[:, c]).max() < tol


class _FailingLib:
    """A kernel library whose launches report cudaErrorInvalidValue."""

    def __getattr__(self, name):
        if name == "mfcc_error_string":
            return lambda err: b"invalid argument"
        return lambda *args: 1


@pytest.mark.cuda
def test_pitch_kernel_launch_failure_raises(cuda, monkeypatch):
    pcfg = PitchConfig()
    monkeypatch.setattr(fused_nccf, "_lib", _FailingLib)
    monkeypatch.setattr(fused_viterbi, "_lib", _FailingLib)
    before = (_n("fused_nccf"), _n("fused_viterbi"))
    with pytest.raises(RuntimeError, match="fused_nccf kernel launch failed"):
        fused_nccf.fused_nccf(torch.zeros((1, 4000), device=cuda),
                              torch.zeros(1, device=cuda), pcfg, T=90)
    with pytest.raises(RuntimeError,
                       match="fused_viterbi kernel launch failed"):
        fused_viterbi.fused_viterbi(
            torch.zeros((1, 5, pcfg.n_lags), device=cuda), pcfg)
    with pytest.raises(RuntimeError, match="launch failed"):
        pitch_model.pitch_batch(torch.zeros((1, 16000), device=cuda),
                                torch.tensor([16000], device=cuda), pcfg)
    assert (_n("fused_nccf"), _n("fused_viterbi")) == before


# ---------------------------------------------------------------------------
# the spectral kernels of the log-mel slice
# ---------------------------------------------------------------------------

LOGMEL80 = dict(n_mels=80, n_mfcc=80)
TTS = dict(sample_rate=22050, frame_ms=46.44, hop_ms=11.61, n_fft=1024,
           n_mels=80, n_mfcc=80)
HI_RATE = dict(sample_rate=44100, n_fft=2048)
ODD_FRAME = dict(frame_ms=25.0625, hop_ms=12.5)
SPECTRAL = {"fused_raw_dit": (fused_raw_dit, "fused_features_raw_dit", True),
            "fused_raw": (fused_raw, "fused_features_raw", True),
            "fused_dit": (fused_dit, "fused_features_dit", False),
            "fused_mfcc": (fused_mfcc, "fused_features", False)}


def _features_diff(got, want, cfg, apply_dct):
    """Cepstra: max unliftered abs diff (bound 2e-5).  Log-mel: the largest
    |diff| - 1e-4 |want| (bound 2e-5: rtol 1e-4 plus atol 2e-5)."""
    if apply_dct:
        return _unliftered_diff(got, want, cfg)
    return float(((got - want).abs() - 1e-4 * want.abs()).max())


def _oracle_features(x, cfg, raw, apply_dct=False, lens=None):
    """The float64 oracle's features fed the kernel's own input (the audio
    the host pre-emphasized: pre-emphasis off), (B, T, n_out) float64 on
    x's device, zero past each row's length."""
    c = cfg.replace(deltas=False) if raw else cfg.replace(deltas=False,
                                                           preemph=0.0)
    fn = oracle.mfcc if apply_dct else oracle.log_mel
    xf = x.double().cpu().numpy()
    out = np.zeros((x.shape[0], c.num_frames(x.shape[1]),
                    c.n_mfcc if apply_dct else c.n_mels))
    for i in range(x.shape[0]):
        want = fn(xf[i, : x.shape[1] if lens is None else lens[i]], c)
        out[i, : want.shape[0]] = want
    return torch.from_numpy(out).to(x.device)


def _plain_or_oracle_diff(got, want, x, cfg, raw, apply_dct):
    """_features_diff of the kernel against its plain version, or, where
    the f32 plain version is itself over the bound against the float64
    oracle fed the kernel's input (the DIT form's, or the direct form's,
    valley rounding), against that oracle."""
    diff = _features_diff(got, want, cfg, apply_dct)
    if diff <= TOL:
        return diff
    ref = _oracle_features(x, cfg, raw, apply_dct)
    if _features_diff(want.double(), ref, cfg, apply_dct) > TOL:
        return _features_diff(got.double(), ref, cfg, apply_dct)
    return diff


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,shape,apply_dct", [
    ("fused_raw_dit", LOGMEL80, (2, 33360), False),
    ("fused_raw_dit", dict(LOGMEL80, dynamic_range_db=50.0), (64, 160000),
     False),
    ("fused_raw", LOGMEL80, (64, 160000), False),
    ("fused_raw", LOGMEL80, (2, 33360), False),           # T=207
    ("fused_raw", dict(), (2, 16000), True),
    ("fused_raw", dict(LOGMEL80, append_energy=True), (2, 16000), False),
    ("fused_raw", dict(sample_rate=8000, n_fft=256), (2, 8000), False),
    ("fused_raw", dict(sample_rate=48000, n_fft=2048), (2, 48000), False),
    ("fused_raw", TINY, (2, 2000), True),
    ("fused_dit", TTS, (64, 220500), False),
    ("fused_dit", TTS, (2, 69 * 256 + 1024), False),      # T=70
    ("fused_dit", dict(), (2, 33360), True),
    ("fused_dit", dict(hop_ms=12.5, lifter=22, append_energy=True),
     (3, 20000), True),
    ("fused_dit", dict(ODD_FRAME, n_mels=40, n_mfcc=40), (2, 16000), False),
    ("fused_dit", dict(sample_rate=8000, n_fft=256), (2, 8000), True),
    ("fused_dit", dict(sample_rate=48000, n_fft=2048), (2, 48000), True),
    ("fused_mfcc", HI_RATE, (64, 441000), True),
    ("fused_mfcc", dict(HI_RATE, **LOGMEL80), (2, 44100), False),
    ("fused_mfcc", dict(), (2, 33360), True),
    ("fused_mfcc", dict(lifter=22, append_energy=True,
                        dynamic_range_db=40.0), (3, 20000), True),
    ("fused_mfcc", TINY, (2, 2000), True),
])
def test_spectral_kernel_matches_plain(cuda, gen, name, kw, shape,
                                       apply_dct):
    module, fn, raw = SPECTRAL[name]
    cfg = FeatureConfig(**kw).validate()
    x = torch.from_numpy((gen.standard_normal(shape) * 0.3)
                         .astype(np.float32)).to(cuda)
    if not raw:
        x = framing.preemphasize(x, cfg).contiguous()
    before = _n(name)
    got = getattr(module, fn)(x, cfg, apply_dct=apply_dct)
    torch.cuda.synchronize()
    assert _n(name) == before + 1
    want = module.plain_features(x, cfg, apply_dct)
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert _plain_or_oracle_diff(got, want, x, cfg, raw, apply_dct) <= TOL


@pytest.mark.cuda
def test_accurate_log_bits_on_the_card(cuda, gen):
    """The kernels' acc_log equals ops/xmath bit for bit on 2^20 floats:
    positive floats over the full exponent range (subnormals included) and
    the floors the pipeline applies."""
    bits = gen.integers(1, 0x7F800000, size=(1 << 20) - 8, dtype=np.int64)
    x = np.concatenate([bits.astype(np.uint32).view(np.float32),
                        np.float32([1e-10, 1e-12, 1e-5, 1e-7, 1.0, 2.0,
                                    np.finfo(np.float32).tiny,
                                    np.finfo(np.float32).max])])
    xt = torch.from_numpy(x)
    got = fused_mfcc.acc_log(xt.to(cuda)).cpu()
    want = xmath._acc_log(xt)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kw,entry,route", [
    (dict(LOGMEL80, deltas=True), logmel_model.log_mel_batch, "fused_raw"),
    (dict(LOGMEL80, deltas=True, dynamic_range_db=50.0),
     logmel_model.log_mel_batch, "fused_raw_dit"),
    (dict(TTS, deltas=True), logmel_model.log_mel_batch, "fused_dit"),
    (dict(LOGMEL80, frame_mode="center"), logmel_model.log_mel_batch,
     "fused_raw"),
    (HI_RATE, mfcc_model.mfcc_batch, "fused_mfcc"),
    (dict(hop_ms=12.5, deltas=True), mfcc_model.mfcc_batch, "fused_dit"),
])
def test_spectral_routes_go_through_their_kernel(cuda, gen, kw, entry,
                                                 route):
    cfg = FeatureConfig(**kw).validate()
    sr = cfg.sample_rate
    lens = np.asarray([sr, sr - sr // 3, 399], np.int32)
    x = np.round(gen.standard_normal((3, sr)) * 8000).astype(np.int16)
    for i, n in enumerate(lens):
        x[i, n:] = 0
    before = report.launches()
    gf, gfl, gm = entry(torch.from_numpy(x).to(cuda),
                        torch.from_numpy(lens).to(cuda), cfg)
    torch.cuda.synchronize()
    ran = _launched(before)
    launched = {k: ran.get(k, 0) for k in SPECTRAL}
    assert launched == {k: int(k == route) for k in SPECTRAL}, launched
    tile = _spectral.fft_tile(cfg, entry is mfcc_model.mfcc_batch)
    if tile == "direct":
        tile = "dit" if route == "fused_dit" else "direct"
    assert _tiles_ran(ran, route) == [tile], ran
    cf, cfl, cm = entry(torch.from_numpy(x), torch.from_numpy(lens), cfg)
    assert torch.equal(gfl.cpu(), cfl) and torch.equal(gm.cpu(), cm)
    assert bool((gf[~gm] == 0).all())
    xf = x.astype(np.float64) / 32768.0
    ref = (oracle.mfcc if entry is mfcc_model.mfcc_batch else oracle.log_mel)
    # unbounded log-mel on audio the host pre-emphasized in f32 (fused_dit)
    # keeps that rounding; the fft64 tile on raw audio holds 1e-4
    bound = 1e-3 if (entry is logmel_model.log_mel_batch
                     and cfg.dynamic_range_db is None
                     and route == "fused_dit") else 1e-4
    for i, n in enumerate(lens[:2]):
        want = ref(xf[i, :n], cfg)
        got = gf[i, : want.shape[0]].cpu().numpy()
        assert np.abs(got - want).max() <= bound


@pytest.mark.cuda
def test_logmel_golden_on_the_card(cuda):
    cfg = FeatureConfig(n_mels=80, n_mfcc=80, deltas=True)
    x, _ = wav.read_wav(os.path.join(GOLDEN, "speech2s.wav"))
    before = _n("fused_raw")
    feat = logmel_model.log_mel(torch.from_numpy(x).to(cuda), cfg)
    torch.cuda.synchronize()
    assert _n("fused_raw") == before + 1
    want = np.load(os.path.join(GOLDEN, "logmel80_deltas.npy"))
    assert feat.shape == want.shape
    assert np.abs(feat.cpu().numpy() - want).max() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_raw", "fused_dit", "fused_mfcc",
                                  "fused_raw_dit"])
def test_spectral_launch_failure_raises(cuda, monkeypatch, name):
    module, fn, _ = SPECTRAL[name]
    monkeypatch.setattr(module, "_lib", _FailingLib)
    before = report.launches()
    with pytest.raises(RuntimeError, match=f"{name} kernel launch failed"):
        getattr(module, fn)(torch.zeros((1, 4000), device=cuda),
                            FeatureConfig())
    assert report.launches() == before


# ---------------------------------------------------------------------------
# the FFT tile of the four spectral kernels (csrc/fft_tile.cuh)
# ---------------------------------------------------------------------------

def _fft_grid(n_fft: int) -> dict:
    """25 ms frames at hop 10 ms at the rate that gives n_fft the default
    config's bin spacing (2 kHz at 64 points ... 128 kHz at 4096)."""
    n_mels = min(26, n_fft // 8)
    return dict(sample_rate=n_fft * 125 // 4, n_fft=n_fft, n_mels=n_mels,
                n_mfcc=min(13, n_mels))


def _run_spectral(cuda, gen, name, cfg, shape, apply_dct, lens=None):
    """One call of a spectral wrapper on seeded noise (zero past each
    length), against its plain version inside the lengths; -> (the tile
    that ran, the diff as _features_diff measures it)."""
    module, fn, raw = SPECTRAL[name]
    x = (gen.standard_normal(shape) * 0.3).astype(np.float32)
    for i, n in enumerate(lens or ()):
        x[i, n:] = 0.0
    x = torch.from_numpy(x).to(cuda)
    if not raw:
        x = framing.preemphasize(x, cfg).contiguous()
    before = report.launches()
    got = getattr(module, fn)(x, cfg, apply_dct=apply_dct)
    torch.cuda.synchronize()
    launched = _launched(before)
    ran = _tiles_ran(launched, name)
    assert launched[name] == 1 and len(ran) == 1
    want = module.plain_features(x, cfg, apply_dct)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    keep = torch.arange(got.shape[1], device=cuda)[None, :] < torch.tensor(
        [cfg.num_frames(n) for n in lens or [x.shape[1]] * x.shape[0]],
        device=cuda)[:, None]
    if ran[0] == "fft64":
        ref = _oracle_features(x, cfg, raw, lens=lens)
        assert float((got.double() - ref)[keep].abs().max()) <= 1e-5
    if lens is None:
        return ran[0], _plain_or_oracle_diff(got, want, x, cfg, raw,
                                             apply_dct)
    return ran[0], _features_diff(got[keep][None], want[keep][None], cfg,
                                  apply_dct)


def _oracle_diff(got, x, cfg, raw):
    """Max abs diff of log-mel ``got`` to the float64 oracle fed the
    kernel's own input."""
    return float((got.double() - _oracle_features(x, cfg, raw)).abs().max())


_FFT_CASES = [
    *[(_fft_grid(n), None, True) for n in (64, 128, 256, 512, 1024, 2048,
                                           4096)],
    (dict(), (64, 160000), True),                      # the main path
    (HI_RATE, (64, 441000), True),                     # 44.1 kHz main path
    (dict(), (2, 400), True),                          # T = 1
    (dict(lifter=22, append_energy=True), None, True),
    (dict(dynamic_range_db=50.0), None, True),
    (dict(LOGMEL80, dynamic_range_db=50.0), None, False),
    (dict(HI_RATE, **LOGMEL80, dynamic_range_db=40.0), None, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_raw_dit", "fused_mfcc",
                                  "fused_raw", "fused_dit"])
@pytest.mark.parametrize("kw,shape,apply_dct", _FFT_CASES)
def test_fft_tile_matches_plain(cuda, gen, name, kw, shape, apply_dct):
    """Over n_fft 64..4096 and the options; shape None is 3 rows of 70
    frames (no tile multiple, an odd pair count in the last tile)."""
    cfg = FeatureConfig(**kw).validate()
    shape = shape or (3, 69 * cfg.hop_len + cfg.frame_len)
    tile, diff = _run_spectral(cuda, gen, name, cfg, shape, apply_dct)
    assert tile == "fft"
    assert diff <= TOL


# unbounded log-mel on noise: (config, shape); None is 3 rows of 71 frames
_FFT64_CASES = [
    *[(_fft_grid(n), None) for n in (64, 128, 256, 512, 1024, 2048, 4096)],
    (LOGMEL80, (64, 160000)),                          # fused_raw main path
    (dict(TTS, n_mfcc=80), (64, 220500)),              # fused_dit main path
    (dict(LOGMEL80, window="hann"), None),
    (dict(LOGMEL80, window="povey"), None),
    (dict(LOGMEL80, dynamic_range_db=60.0), None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_raw_dit", "fused_mfcc",
                                  "fused_raw", "fused_dit"])
@pytest.mark.parametrize("kw,shape", _FFT64_CASES)
def test_fft64_tile_matches_plain_and_oracle(cuda, gen, name, kw, shape):
    """The float64-front tile within 1e-5 of the float64 oracle fed its
    input and, on noise, within the log-mel bound of the plain version (of
    the oracle where the plain version's own rounding is over that bound:
    the DIT form at n_fft 4096 and at the TTS geometry)."""
    module, fn, raw = SPECTRAL[name]
    cfg = FeatureConfig(**kw).validate()
    shape = shape or (3, 70 * cfg.hop_len + cfg.frame_len)
    tile, diff = _run_spectral(cuda, gen, name, cfg, shape, False)
    assert tile == "fft64"
    assert diff <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_raw_dit", "fused_mfcc",
                                  "fused_raw", "fused_dit"])
@pytest.mark.parametrize("window", ["hamming", "hann", "povey"])
def test_fft64_tile_holds_the_oracle_in_valleys(cuda, name, window):
    """The two-tone valley signal, unbounded log-mel-80: the f32 plain
    versions are up to ~1e-2 off the oracle with Hann and Povey windows;
    the float64-front tile stays within 1e-5 of it on its own input."""
    module, fn, raw = SPECTRAL[name]
    cfg = FeatureConfig(**LOGMEL80, window=window).validate()
    t = np.arange(16000) / 16000
    x = torch.from_numpy((0.5 * np.sin(2 * np.pi * 180.0 * t)
                          + 0.3 * np.sin(2 * np.pi * 1200.0 * t))
                         .astype(np.float32)[None]).to(cuda)
    if not raw:
        x = framing.preemphasize(x, cfg).contiguous()
    before = _n(name, "fft64")
    got = getattr(module, fn)(x, cfg, apply_dct=False)
    torch.cuda.synchronize()
    assert _n(name, "fft64") == before + 1
    assert _oracle_diff(got, x, cfg, raw) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_raw_dit", "fused_mfcc",
                                  "fused_raw", "fused_dit"])
@pytest.mark.parametrize("apply_dct", [True, False])
def test_fft_tile_on_a_ragged_batch(cuda, gen, name, apply_dct):
    """All-zero frames past each length (c0 ~ -117, where 2e-5 is a few
    ulps of the summation order) are compared inside the lengths only;
    log-mel-80 on the fft64 tile."""
    cfg = FeatureConfig() if apply_dct else FeatureConfig(**LOGMEL80)
    tile, diff = _run_spectral(cuda, gen, name, cfg, (3, 16000), apply_dct,
                               lens=[16000, 12123, 4000])
    assert tile == ("fft" if apply_dct else "fft64") and diff <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_raw_dit", "fused_mfcc",
                                  "fused_raw", "fused_dit"])
@pytest.mark.parametrize("kw,apply_dct", [
    (dict(n_fft=401), True),                  # no power of two
    (dict(ODD_FRAME, n_fft=600), True),
    (dict(LOGMEL80, n_fft=401), False),       # unbounded log-mel
])
def test_direct_tile_where_the_fft_tile_does_not_apply(cuda, gen, name, kw,
                                                       apply_dct):
    """The entry's other tile: the direct tile, or for fused_dit (n_fft %
    4 == 0) the DIT tile at n_fft 400."""
    if name == "fused_dit":
        kw = dict(kw, n_fft=400 if kw["n_fft"] == 401 else kw["n_fft"])
    cfg = FeatureConfig(**kw).validate()
    tile, diff = _run_spectral(cuda, gen, name, cfg,
                               (2, 69 * cfg.hop_len + cfg.frame_len),
                               apply_dct)
    assert tile == ("dit" if name == "fused_dit" else "direct")
    assert diff <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_raw_dit", "fused_mfcc",
                                  "fused_raw", "fused_dit"])
def test_fft_tile_refused_where_the_entry_cannot_take_it(cuda, name):
    """The C entry refuses an FFT tile on a shape it does not take (n_fft
    401) instead of running something else."""
    module, _, raw = SPECTRAL[name]
    cfg = FeatureConfig(n_fft=401 if name != "fused_dit" else 400)
    other = (fused_dit.DIT_TILE if name == "fused_dit"
             else _spectral.DIRECT_TILE)
    for tile in ("fft", "fft64"):
        with pytest.raises(RuntimeError, match="launch failed"):
            _spectral.launch_spectral(
                module._lib, "mfcc_" + name, name,
                torch.zeros((1, 4000), device=cuda), cfg, True,
                cfg.preemph if raw else None, other=other, tile=tile,
                projection="mel" if name == "fused_raw_dit" else None,
                mixed=name == "fused_raw")


# ---------------------------------------------------------------------------
# fused_raw_dit's bark and spec projections, PLP and the log spectrogram
# ---------------------------------------------------------------------------

SPEC_TOL = 2e-4   # spectrogram, inside the 50 dB window (conventions)


def _oracle_projection(x, cfg, projection, rows, lens=None):
    """(len(rows), T, width) float64 oracle of fused_raw_dit's bark or spec
    output for rows of the raw audio x, zero past each row's frames."""
    fn = oracle.log_bark if projection == "bark" else oracle.log_spectrogram
    xf = x.double().cpu().numpy()
    out = np.zeros((len(rows), cfg.num_frames(x.shape[1]),
                    cfg.n_bark if projection == "bark" else cfg.n_bins))
    for k, i in enumerate(rows):
        want = fn(xf[i, : x.shape[1] if lens is None else lens[i]], cfg)
        out[k, : want.shape[0]] = want
    return torch.from_numpy(out).to(x.device)


def _projection_excess(got, want, projection):
    """How far past its bound ``got`` is against ``want`` (<= 0 holds):
    bark log-energies rtol 1e-4 plus atol 2e-5, the spectrogram 2e-4 on
    the bins within 50 dB of their frame's peak in ``want``."""
    diff = (got - want).abs()
    if projection == "bark":
        return float((diff - 1e-4 * want.abs()).max()) - TOL
    window = want > want.amax(dim=-1, keepdim=True) - np.log(1e5)
    return float(diff[window].max()) - SPEC_TOL


def _run_projection(cuda, gen, projection, cfg, shape, lens=None,
                    audio=None):
    """One call of fused_raw_dit in ``projection``; -> (the tile that ran,
    the excess over the bound against the plain version, or, where the
    plain version is over that bound against the float64 oracle, against
    the oracle).  A case on the fft64 tile must also be within 1e-5 of the
    oracle over every band and bin."""
    x = audio if audio is not None else (
        gen.standard_normal(shape) * 0.3).astype(np.float32)
    for i, n in enumerate(lens or ()):
        x[i, n:] = 0.0
    x = torch.from_numpy(x).to(cuda)
    before = report.launches()
    got = fused_raw_dit.fused_features_raw_dit(x, cfg, apply_dct=False,
                                               projection=projection)
    torch.cuda.synchronize()
    launched = _launched(before)
    ran = _tiles_ran(launched, "fused_raw_dit")
    assert launched["fused_raw_dit"] == 1 and len(ran) == 1
    assert launched["fused_raw_dit", projection] == 1
    want = fused_raw_dit.plain_features(x, cfg, False, projection)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    keep = torch.arange(got.shape[1], device=cuda)[None, :] < torch.tensor(
        [cfg.num_frames(n) for n in lens or [x.shape[1]] * x.shape[0]],
        device=cuda)[:, None]
    rows = [0, x.shape[0] - 1]
    ref = _oracle_projection(x, cfg, projection, rows, lens)
    k = keep[rows]
    if ran[0] == "fft64":
        assert float((got[rows].double() - ref)[k].abs().max()) <= 1e-5
    excess = _projection_excess(got[keep], want[keep], projection)
    if excess > 0 and _projection_excess(want[rows].double()[k], ref[k],
                                         projection) > 0:
        excess = _projection_excess(got[rows].double()[k], ref[k], projection)
    return ran[0], excess


_PROJECTION_CASES = [
    (dict(), (64, 160000)),                          # the main path
    (dict(), (3, 69 * 160 + 400)),                   # T = 70
    (dict(), (2, 400)),                              # T = 1
    (dict(sample_rate=8000, n_fft=256), (2, 8000)),
    (dict(n_fft=1024), (2, 16000)),
    (dict(sample_rate=48000, n_fft=2048), (2, 48000)),
    (dict(window="povey", preemph=0.0), (2, 16000)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("projection", ["bark", "spec"])
@pytest.mark.parametrize("kw,shape", _PROJECTION_CASES)
def test_projection_fft64_tile_matches_plain_and_oracle(cuda, gen, projection,
                                                        kw, shape):
    tile, excess = _run_projection(cuda, gen, projection,
                                   FeatureConfig(**kw).validate(), shape)
    assert tile == "fft64" and excess <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("projection", ["bark", "spec"])
def test_projection_on_a_ragged_batch(cuda, gen, projection):
    tile, excess = _run_projection(cuda, gen, projection, FeatureConfig(),
                                   (3, 16000), lens=[16000, 12123, 4000])
    assert tile == "fft64" and excess <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("projection", ["bark", "spec"])
@pytest.mark.parametrize("window", ["hann", "povey"])
def test_projection_holds_the_oracle_in_valleys(cuda, projection, window):
    """The two-tone valley signal: the fft64 tile within 1e-5 of the
    oracle over every band and bin (the f32 plain version is not)."""
    t = np.arange(16000) / 16000
    x = (0.5 * np.sin(2 * np.pi * 180.0 * t)
         + 0.3 * np.sin(2 * np.pi * 1200.0 * t)).astype(np.float32)[None]
    tile, excess = _run_projection(cuda, None, projection,
                                   FeatureConfig(window=window), None,
                                   audio=x)
    assert tile == "fft64" and excess <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("projection,n_fft", [("bark", 401), ("bark", 600),
                                              ("spec", 768), ("spec", 401)])
def test_projection_direct_tile(cuda, gen, projection, n_fft):
    """At an n_fft that is no power of two the direct tile takes both
    projections (the spectrogram logs each bin block as it leaves the
    block: no identity projection); n_fft 768 is the spectrogram route's
    (spec_kernel_eligible)."""
    cfg = FeatureConfig(n_fft=n_fft).validate()
    tile, excess = _run_projection(cuda, gen, projection, cfg,
                                   (2, 69 * cfg.hop_len + cfg.frame_len))
    assert tile == "direct" and excess <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("projection", ["bark", "spec"])
def test_projection_with_dct_refused(cuda, projection):
    """The wrapper raises as the reference asserts, and the C entry refuses
    a projection with apply_dct set on every tile."""
    cfg = FeatureConfig()
    x = torch.zeros((1, 4000), device=cuda)
    with pytest.raises(ValueError, match="DCT"):
        fused_raw_dit.fused_features_raw_dit(x, cfg, projection=projection)
    for tile in ("fft", "fft64", "direct"):
        with pytest.raises(RuntimeError, match="launch failed"):
            _spectral.launch_spectral(
                fused_raw_dit._lib, "mfcc_fused_raw_dit", "fused_raw_dit", x,
                cfg, True, cfg.preemph, other=_spectral.direct_tile(
                    projection), tile=tile, projection=projection)


@pytest.mark.cuda
@pytest.mark.parametrize("entry,projection,kw", [
    (plp_model.plp_batch, "bark", dict()),
    (plp_model.plp_batch, "bark", dict(deltas=True, append_energy=True)),
    (plp_model.plp_batch, "bark", dict(frame_mode="center", lifter=22)),
    (spec_model.log_spectrogram_batch, "spec", dict()),
    (spec_model.log_spectrogram_batch, "spec", dict(n_fft=1024)),
    (spec_model.log_spectrogram_batch, "spec", dict(frame_mode="center")),
])
def test_plp_and_spectrogram_batch_go_through_the_kernel(cuda, gen, entry,
                                                         projection, kw):
    """One fused_raw_dit launch in the projection; frame counts, masks and
    zeroing equal to the CPU path's; PLP within 1e-4 and the spectrogram
    within 2e-4 (50 dB window) of the float64 oracle in each row's
    frames."""
    cfg = FeatureConfig(**kw)
    lens = np.asarray([16000, 10666, 400, 399], np.int32)
    x = np.round(gen.standard_normal((4, 16000)) * 8000).astype(np.int16)
    for i, n in enumerate(lens):
        x[i, n:] = 0
    before = report.launches()
    gf, gfl, gm = entry(torch.from_numpy(x).to(cuda),
                        torch.from_numpy(lens).to(cuda), cfg)
    torch.cuda.synchronize()
    launched = _launched(before)
    assert launched["fused_raw_dit"] == 1
    assert launched["fused_raw_dit", projection] == 1
    cf, cfl, cm = entry(torch.from_numpy(x), torch.from_numpy(lens), cfg)
    assert torch.equal(gfl.cpu(), cfl) and torch.equal(gm.cpu(), cm)
    assert bool((gf[~gm] == 0).all())
    ref = oracle.plp if projection == "bark" else oracle.log_spectrogram
    for i, n in enumerate(lens):
        want = ref(x[i, :n].astype(np.float64) / 32768.0, cfg)
        got = gf[i, : want.shape[0]].cpu().numpy()
        assert int(gfl[i]) == want.shape[0]
        if want.size == 0:
            continue
        if projection == "bark":
            assert np.abs(got - want).max() <= 1e-4
        else:
            keep = want > want.max(axis=-1, keepdims=True) - np.log(1e5)
            assert np.abs(got - want)[keep].max() <= SPEC_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("entry,kw", [
    (spec_model.log_spectrogram_batch, dict(n_fft=400)),
    (plp_model.plp_batch, dict(sample_rate=44100, n_fft=2048)),
])
def test_reference_xla_configs_run_plain_on_the_card(cuda, gen, entry, kw):
    """A config the reference sends to XLA launches no kernel: the plain
    chain runs on the card and agrees with the CPU path's: PLP within 5e-5
    (the bound between two f32 paths, tests/test_plp.py; 1.7e-5 measured
    at 44.1 kHz), the spectrogram 2e-4 in the 50 dB window."""
    cfg = FeatureConfig(**kw)
    x = (gen.standard_normal((2, cfg.sample_rate)) * 0.3).astype(np.float32)
    lens = torch.tensor([cfg.sample_rate, cfg.sample_rate // 2])
    before = _n("fused_raw_dit")
    gf, _, gm = entry(torch.from_numpy(x).to(cuda), lens.to(cuda), cfg)
    torch.cuda.synchronize()
    assert _n("fused_raw_dit") == before
    cf, _, _ = entry(torch.from_numpy(x), lens, cfg)
    m = gm.cpu()
    if entry is plp_model.plp_batch:
        assert float((gf.cpu() - cf)[m].abs().max()) <= 5e-5
    else:
        assert _projection_excess(gf.cpu()[m], cf[m], "spec") <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("projection", ["bark", "spec"])
def test_plp_and_spectrogram_goldens_on_the_card(cuda, projection):
    cfg = FeatureConfig()
    x, _ = wav.read_wav(os.path.join(GOLDEN, "speech2s.wav"))
    fn, fname = ((plp_model.plp, "plp13.npy") if projection == "bark"
                 else (spec_model.log_spectrogram, "spectrogram257.npy"))
    before = _n("fused_raw_dit", projection)
    feat = fn(torch.from_numpy(x).to(cuda), cfg)
    torch.cuda.synchronize()
    assert _n("fused_raw_dit", projection) == before + 1
    want = torch.from_numpy(np.load(os.path.join(GOLDEN, fname)))
    assert feat.shape == want.shape
    if projection == "bark":
        assert float((feat.cpu().double() - want).abs().max()) <= 1e-4
    else:
        assert _projection_excess(feat.cpu().double(), want, "spec") <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed,start,n", [(7, 0, 1 << 20), (3, 2**32 - 100, 300),
                                          (5, 2**33 + 5, 4096)])
def test_dither_bits_on_the_card(cuda, seed, start, n):
    """The int64 hash equals the reference's uint32 bits on the card; the
    noise is the float32 rounding of the float64 draw (1e-6 relative)."""
    h1, h2 = dither.bits(seed, start, n, device=cuda)
    w1, w2 = dither.bits_np(seed, start, n)
    assert torch.equal(h1.cpu(), torch.from_numpy(w1.astype(np.int64)))
    assert torch.equal(h2.cpu(), torch.from_numpy(w2.astype(np.int64)))
    starts = torch.tensor([start, start + 17], device=cuda)
    r1, _ = dither.bits(seed, starts, 64)
    assert torch.equal(r1[1].cpu(), torch.from_numpy(
        dither.bits_np(seed, start + 17, 64)[0].astype(np.int64)))
    z = dither.noise(seed, start, n, device=cuda).cpu().double().numpy()
    np.testing.assert_allclose(z, dither.noise_np(seed, start, n), rtol=1e-6,
                               atol=1e-6)


# the kernel-vs-plain bound each packed family is held to (PERF.md
# section 2): cepstra 2e-5, log-mel as the log bark energies (rtol 1e-4
# plus atol 2e-5), the spectrogram 2e-4 inside its 50 dB window
PACKED_BOUNDS = {"mfcc": "cepstra", "logmel": "bark", "plp": "cepstra",
                 "spec": "spec"}


@pytest.mark.cuda
@pytest.mark.parametrize("family,kw", [
    ("mfcc", dict()),
    ("logmel", dict(n_mels=80, n_mfcc=80, dynamic_range_db=50.0)),
    ("logmel", dict(n_mels=80, n_mfcc=80)), ("plp", dict()), ("spec", dict())])
def test_packed_segment_at_an_odd_frame_against_standalone(cuda, gen, family,
                                                           kw):
    """A segment at an odd frame of its row pairs with other frames in the
    FFT tile than alone: within the kernel-vs-plain bounds of its
    standalone kernel result, not bit for bit."""
    cfg = FeatureConfig(**kw)
    sigs = {i: (gen.standard_normal(n) * 0.3).astype(np.float32)
            for i, n in enumerate((9123, 20000, 15700))}
    rows = list(batch_lib.pack_rows([(i, len(s)) for i, s in sigs.items()],
                                    6 * 16000, cfg.hop_len))
    row = rows[0]
    x, starts, lens = batch_lib.pack_audio(row, sigs.__getitem__)
    assert any((off // cfg.hop_len) % 2 for _, off, _ in row.segments)
    before = _n("fused_raw_dit") + _n("fused_raw")
    feat, f0, fc, _ = mfcc_model.mfcc_batch_packed(
        torch.from_numpy(x[None]).to(cuda),
        torch.from_numpy(starts[None]).to(cuda),
        torch.from_numpy(lens[None]).to(cuda), cfg, family=family)
    torch.cuda.synchronize()
    assert _n("fused_raw_dit") + _n("fused_raw") == before + 1
    for j, (uid, off, n) in enumerate(row.segments):
        xs = torch.from_numpy(sigs[uid][None, :n]).to(cuda)
        ln = torch.tensor([n], device=cuda)
        if family == "plp":
            want = plp_model.plp_batch(xs, ln, cfg)[0][0]
        elif family == "spec":
            want = spec_model.log_spectrogram_batch(xs, ln, cfg)[0][0]
        else:
            want = mfcc_model.features_batch(xs, ln, cfg,
                                             apply_dct=family == "mfcc")[0][0]
        got = feat[0, int(f0[0, j]): int(f0[0, j] + fc[0, j])]
        assert got.shape == want.shape
        if PACKED_BOUNDS[family] == "cepstra":
            assert float((got - want).abs().max()) <= TOL, (j, off)
        else:
            assert _projection_excess(got, want, PACKED_BOUNDS[family]) <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["mfcc", "logmel", "plp", "spec"])
def test_fused_serving_against_the_scan_path_on_the_card(cuda, gen, variant):
    """process_chunks_batch_fused launches fused_raw_dit at preemph 0 on
    the host-pre-emphasized span; within 5e-5 of the scan path on the card
    (the spectrogram 2e-4 inside its 50 dB window), over two dispatches."""
    cfg = FeatureConfig(dynamic_range_db=50.0 if variant == "logmel" else None)
    B, K, C = 4, 3, 16 * cfg.hop_len
    xs = (gen.standard_normal((B, 2 * K * C)) * 0.3).astype(np.float32)
    st_s = streaming.init_state_batch(B, cfg, device=cuda)
    st_f = streaming.init_state_batch(B, cfg, device=cuda)
    projection = {"plp": "bark", "spec": "spec"}.get(variant, "mel")
    for d in range(2):
        chunks = torch.from_numpy(xs[:, d * K * C:(d + 1) * K * C]
                                  .reshape(B, K, C)).to(cuda)
        st_s, fs, nvs = streaming.process_chunks_batch(st_s, chunks, cfg,
                                                       variant)
        before = _n("fused_raw_dit", projection)
        st_f, ff, n_new = streaming.process_chunks_batch_fused(st_f, chunks,
                                                               cfg, variant)
        torch.cuda.synchronize()
        assert _n("fused_raw_dit", projection) == before + 1
        for b in range(B):
            want = torch.cat([fs[b, k, : int(nvs[b, k])] for k in range(K)])
            assert int(n_new[b]) == want.shape[0]
            got = ff[b, : want.shape[0]]
            if variant == "spec":
                assert _projection_excess(got, want, "spec") <= 0
            else:
                assert float((got - want).abs().max()) <= 5e-5
            assert not bool(ff[b, want.shape[0]:].any())
        assert torch.equal(st_f.carry, st_s.carry)


@pytest.mark.cuda
@pytest.mark.parametrize("n_valid", [16, 11, 1])
def test_online_chunk_nccf_kernel_matches_plain(cuda, gen, n_valid):
    """The online tracker's chunk NCCF at B = 1: the kernel within the
    kernel bound of the plain chunk NCCF on the valid frames of a chunk
    whose tail frames read the buffer's zero padding (a stationary
    signal), one launch; the chunk step itself launches it once."""
    from mfcc_tpu_torch.models import pitch_online
    pcfg = PitchConfig().validate()
    F = 16
    span = pitch_online.chunk_span(pcfg, F)
    have = pcfg.frame_len_w + pcfg.max_lag + (n_valid - 1) * pcfg.hop_len_w
    t = np.arange(span) / pcfg.work_rate
    buf = np.zeros(span, np.float32)
    buf[:have] = (0.3 * np.sin(2 * np.pi * 180 * t[:have])
                  + 0.02 * gen.standard_normal(have))
    b = torch.from_numpy(buf).to(cuda)
    e0 = pitch_online.chunk_energies(b, F, pcfg)[:n_valid]
    ball = (pcfg.ballast * e0.mean() ** 2).reshape(1)
    before = _n("fused_nccf")
    kb, kp = pitch_online.chunk_nccf(b, F, pcfg, ball)
    torch.cuda.synchronize()
    assert _n("fused_nccf") == before + 1
    pb, pp = pitch_online.chunk_nccf(b, F, pcfg, ball, backend="torch")
    assert _n("fused_nccf") == before + 1
    for g, w in ((kb, pb), (kp, pp)):
        assert g.shape == w.shape == (F, pcfg.n_lags)
        assert float((g - w)[:n_valid].abs().max()) <= TOL
    state = pitch_online.init_chunk_state(pcfg, cuda)
    state, back, nccf_p = pitch_online.online_chunk_step(state, b, n_valid,
                                                         pcfg, F)
    assert _n("fused_nccf") == before + 2
    assert back.is_cuda and back.dtype == torch.int32
    assert torch.equal(nccf_p, kp)


@pytest.mark.cuda
def test_online_pitch_on_the_card_matches_its_twin(cuda, gen):
    from mfcc_tpu_torch.models import pitch_online
    pcfg = PitchConfig().validate()
    x = _vibrato(gen, 2 * pcfg.sample_rate, 150.0)
    op = pitch_online.OnlinePitch(pcfg)
    rows = [op.feed(x[i: i + 1600]) for i in range(0, x.size, 1600)]
    got = np.concatenate(rows + [op.flush()])
    want = pitch_online.online_pitch_np(x.astype(np.float64), pcfg)
    assert got.shape == want.shape == (pcfg.num_frames(x.size), 3)
    for i, tol in enumerate(PITCH_TOL):
        assert float(np.abs(got[:, i] - want[:, i]).max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("mask_value", [0.0, "mean"])
def test_spec_augment_masks_equal_on_cpu_and_card(cuda, gen, mask_value):
    """One seed draws the same stripes on both devices: the draws come from
    a CPU generator, and the applier is elementwise (fill 0.0: equal bit
    for bit; the mean fill's sum may round otherwise on the card)."""
    from mfcc_tpu_torch.ops import augment
    f = torch.from_numpy(gen.standard_normal((4, 300, 80))
                         .astype(np.float32) + 5.0)
    nf = torch.tensor([300, 211, 17, 0])
    f = torch.where(torch.arange(300)[None, :, None] < nf[:, None, None], f,
                    0.0)
    cpu = augment.spec_augment(f, torch.Generator().manual_seed(9),
                               num_frames=nf, mask_value=mask_value)
    card = augment.spec_augment(f.to(cuda), torch.Generator().manual_seed(9),
                                num_frames=nf.to(cuda),
                                mask_value=mask_value).cpu()
    assert torch.equal(card == f, cpu == f)
    if mask_value == 0.0:
        assert torch.equal(card, cpu)
    else:
        assert float((card - cpu).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_trainable_forward_on_the_card_matches_the_cpu(cuda, gen):
    from mfcc_tpu_torch.models import trainable
    cfg = FeatureConfig()
    audio = torch.from_numpy((0.3 * gen.standard_normal((4, 32000)))
                             .astype(np.float32))
    params = trainable.init_params(cfg, "cpu")
    with torch.no_grad():
        params.mel_w.mul_(1.3)
    want = trainable.forward(params, audio, cfg).detach()
    got = trainable.forward(params.to(cuda), audio.to(cuda), cfg).detach()
    assert float((got.cpu() - want).abs().max()) <= TOL
    # and one step's gradient is finite on the card
    opt = trainable.make_optimizer(params, 1e-3)
    loss = trainable.train_step(params, opt, audio.to(cuda), want.to(cuda),
                                cfg)
    assert torch.isfinite(loss) and torch.isfinite(params.mel_w).all()


@pytest.mark.cuda
def test_online_cmvn_window_300_on_the_card(cuda):
    """The card's float32 cumsum accumulates in float32; the float64 prefix
    sums keep the streaming step and the batch op within 1e-5 of each other
    and of the float64 oracle at window 300 with the variance normalized
    (chip_smoke.py phase 13's case; 3.1e-5 apart with float32 sums)."""
    from mfcc_tpu_torch.ops import post
    from mfcc_tpu_torch.parallel import dryrun
    n, W, S = 960 * 160 + 240, 300, 320
    x = torch.from_numpy(dryrun.bench_signal(2, n, 16000)).to(cuda)
    feats = mfcc_model.mfcc_batch(x, torch.full((2,), n, device=cuda),
                                  FeatureConfig())[0]
    for f in feats:
        st = streaming.init_online_cmvn(W, f.shape[1], device=cuda)
        parts = []
        for k in range(0, f.shape[0], S):
            slots = torch.zeros((S, f.shape[1]), device=cuda)
            rows = f[k: k + S]
            slots[: len(rows)] = rows
            st, out = streaming.online_cmvn_step(st, slots, len(rows), W,
                                                 True)
            parts.append(out[: len(rows)])
        step = torch.cat(parts).cpu().numpy()
        batch = post.online_cmvn(f[None], torch.tensor([f.shape[0]],
                                                       device=cuda), W,
                                 True)[0].cpu().numpy()
        ref = oracle.online_cmvn(f.cpu().numpy().astype(np.float64), W, True)
        assert np.abs(step - batch).max() <= 1e-5
        assert max(np.abs(step - ref).max(), np.abs(batch - ref).max()) \
            <= 1e-5


@pytest.mark.cuda
def test_dryrun_on_the_card(cuda):
    """Two ranks on the card (dp 1 x sp 1 x tp 2) at the tiny config: the
    reference's bounds hold in every rank, and the kernel route launches
    fused_raw_dit once in each."""
    from mfcc_tpu_torch.parallel import dryrun
    res = dryrun.dryrun_multichip(2, device="cuda")
    assert res["device"] == torch.cuda.get_device_name(0)
    assert res["summary"].startswith("dryrun_multichip OK: mesh dp=1 sp=1 "
                                     "tp=2")
    for per_rank in res["launches"]:
        assert per_rank["kernel route"]["fused_raw_dit"] == 1
        assert per_rank["pitch"]["fused_nccf"] == 1


# |form - float64 product| <= (unit + K 2^-23) (|A| @ |B|), as
# tests/test_torch_precision.py emulates the forms on the CPU; "high" is
# the IEEE fp32 form of "highest"
FORM_UNIT = {"highest": 0.0, "high": 0.0, "default": 2.0 ** -9}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["highest", "high", "default"])
def test_matmul_forms_on_the_card_within_their_bounds(cuda, gen, mode):
    """backend.matmul's form for each mode on a DFT product of the plain
    path's shape family, against the float64 product ("high" equal to
    "highest" bit for bit); the caller's flags come back unchanged."""
    from mfcc_tpu_torch import backend
    M, K, N = 4096, 400, 514
    a = (gen.standard_normal((M, K)) * 0.3).astype(np.float32)
    b = np.cos(gen.uniform(0, 2 * np.pi, (K, N))).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    before = backend.matmul_flags()
    ta, tb = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    got = backend.matmul(ta, tb, mode)
    assert backend.matmul_flags() == before
    if mode == "high":
        assert torch.equal(got, backend.matmul(ta, tb, "highest"))
    err = np.abs(got.double().cpu().numpy() - exact)
    assert (err <= (FORM_UNIT[mode] + K * 2.0 ** -23) * scale).all()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["high", "default", "bfloat16"])
def test_precision_modes_route_as_the_reference(cuda, gen, mode):
    """"high" runs the plain chain on the card (no spectral launch), within
    2.8e-4 of the oracle; "default" and bf16 compute take the unchanged
    kernel, within the contract's 1e-4."""
    kw = (dict(compute_dtype="bfloat16") if mode == "bfloat16"
          else dict(matmul_precision=mode))
    cfg = FeatureConfig(**kw).validate()
    x = (gen.standard_normal((2, 16000)) * 0.3).astype(np.float32)
    counters = ("fused_raw_dit", "fused_raw", "fused_dit", "fused_mfcc")
    before = [_n(k) for k in counters]
    feat, _, _ = mfcc_model.mfcc_batch(torch.from_numpy(x).to(cuda),
                                       torch.tensor([16000, 16000],
                                                    device=cuda), cfg)
    torch.cuda.synchronize()
    launched = [_n(k) - b for k, b in zip(counters, before)]
    assert launched == ([0, 0, 0, 0] if mode == "high" else [1, 0, 0, 0])
    want = oracle.mfcc(x[0].astype(np.float64), FeatureConfig())
    err = float(np.abs(feat[0].cpu().numpy() - want).max())
    assert err <= (2.8e-4 if mode == "high" else 1e-4), err


@pytest.mark.cuda
@pytest.mark.parametrize("caller", [True, False])
def test_matmul_form_reduces_float16_in_float32_on_the_card(cuda, gen,
                                                            caller):
    """A float16 product under every form runs with
    allow_fp16_reduced_precision_reduction off (cuBLAS reduces in float32,
    as XLA accumulates a float16 dot), and the caller's flag comes back:
    the product is the float32 product of the same values rounded
    once to float16 (within half a float16 ulp plus the float32 sums'
    K 2^-24 of |a| @ |b|)."""
    from mfcc_tpu_torch import backend
    m = torch.backends.cuda.matmul
    saved = m.allow_fp16_reduced_precision_reduction
    K = 2048
    a = torch.from_numpy(gen.standard_normal((256, K)).astype(
        np.float16)).to(cuda)
    b = torch.from_numpy(gen.standard_normal((K, 64)).astype(
        np.float16)).to(cuda)
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    try:
        m.allow_fp16_reduced_precision_reduction = caller
        for mode in backend.PRECISIONS:
            with backend.matmul_form(mode):
                assert not m.allow_fp16_reduced_precision_reduction
                got = a @ b
            assert m.allow_fp16_reduced_precision_reduction == caller
            err = (got.double() - exact).abs()
            assert bool((err <= 2.0 ** -11 * exact.abs()
                         + K * 2.0 ** -24 * scale).all()), mode
    finally:
        m.allow_fp16_reduced_precision_reduction = saved


ACCUM_FAMILIES = {
    "mfcc": (mfcc_model.mfcc_batch, dict()),
    "logmel": (logmel_model.log_mel_batch, dict(n_mels=80, n_mfcc=80)),
    "logmel50": (logmel_model.log_mel_batch,
                 dict(n_mels=80, n_mfcc=80, dynamic_range_db=50.0)),
    "plp": (plp_model.plp_batch, dict()),
    "spec": (spec_model.log_spectrogram_batch, dict()),
}
# the card's plain route against the CPU's (chip_smoke.py ACCUM_TOL):
# cepstra and PLP max abs; log-mel and the spectrogram ulps of their
# energies in the accumulation dtype
ACCUM_TOL = {"mfcc": 2e-2, "plp": 1e-3, "logmel": 6, "logmel50": 6,
             "spec": 6}


def _energy_ulps(got, want, accum):
    eg, ew = np.exp(got.astype(np.float64)), np.exp(want.astype(np.float64))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(eg, ew)))
                  - (7 if accum == "bfloat16" else 10))
    if accum == "float16":
        ulp = np.maximum(ulp, 2.0 ** -24)
    return np.abs(eg - ew) / ulp


@pytest.mark.cuda
@pytest.mark.parametrize("accum", ["bfloat16", "float16"])
@pytest.mark.parametrize("family", list(ACCUM_FAMILIES))
def test_accum_dtype_on_the_card(cuda, gen, family, accum):
    """chip_smoke.py phase 23 (a) and (b) at a small size: the kernel route
    launches what float32 launches and gives its bits; the plain route on
    the card is within the port-vs-JAX bound of the CPU's plain route
    (log-mel and the spectrogram in ulps of their energies, the
    spectrogram inside each frame's 50 dB window)."""
    entry, kw = ACCUM_FAMILIES[family]
    cfg32 = FeatureConfig(**kw).validate()
    cfg = cfg32.replace(accum_dtype=accum)
    x = np.round(gen.standard_normal((3, 16000)) * 3000).astype(np.int16)
    lens = np.asarray([16000, 12000, 400], np.int32)
    x[1, 12000:] = 0
    x[2, 400:] = 0
    xd, ld = torch.from_numpy(x).to(cuda), torch.from_numpy(lens).to(cuda)
    counters = ("fused_raw_dit", "fused_raw", "fused_dit", "fused_mfcc")
    out = {}
    for c in (cfg32, cfg):
        before = [_n(k) for k in counters]
        feat = entry(xd, ld, c, "auto")[0]
        torch.cuda.synchronize()
        out[c.accum_dtype] = (feat, [_n(k) - b for k, b in
                                     zip(counters, before)])
    assert sum(out["float32"][1]) == 1
    assert out[accum][1] == out["float32"][1]
    assert torch.equal(out[accum][0], out["float32"][0])
    card = entry(xd, ld, cfg, "torch")[0].cpu().numpy()
    host = entry(torch.from_numpy(x), torch.from_numpy(lens), cfg,
                 "torch")[0].numpy()
    assert np.isfinite(card).all()
    keep = (host > host.max(axis=-1, keepdims=True) - np.log(1e5)
            if family == "spec" else np.ones(host.shape, bool))
    d = (np.abs(card - host)[keep] if family in ("mfcc", "plp")
         else _energy_ulps(card[keep], host[keep], accum))
    assert d.max() <= ACCUM_TOL[family], d.max()


@pytest.mark.cuda
def test_roofline_stage_and_fftlog_rungs_on_the_card(cuda):
    """The roofline ladder's ``stage`` and ``fftlog`` rungs of
    ``fused_raw_dit`` (built from edited copies of csrc/ into
    build/roofline/): the kernel's launch plan, and equal in every bit to
    the gather of the staged samples and to the unchanged kernel, on 8 x 3
    s of the reference probe's signal (T = 298, no tile multiple)."""
    from mfcc_tpu_torch.tools import roofline
    path = "fused_raw_dit"
    src, cfg, dct = roofline.PATHS[path]
    libs = roofline.build([path], ("stage", "fftlog"))
    x = torch.from_numpy(roofline.signal(cfg, 8, 3.0)).to(cuda)
    want = {"stage": roofline.plain_rung("stage", x, cfg, dct, src),
            "fftlog": roofline.kernel(path, x)}
    plan = roofline.plan(path, *x.shape)
    assert plan["T"] == 298 and plan["TM"] == 16
    for rung, w in want.items():
        got, _ = roofline.launch(libs[rung, src], path, x, rung)
        launched = roofline.launched_plan(libs[rung, src])
        assert launched == {k: plan[k] for k in roofline.PLAN_KEYS}, rung
        assert torch.equal(got, w), rung


@pytest.mark.cuda
@pytest.mark.parametrize("layout,T,F,W", DELTA_CASES)
def test_fused_deltas_equal_the_plain_chain(cuda, layout, T, F, W):
    """One launch, equal in every bit to ``plain_append_deltas`` on the
    card, which equals the CPU's in every bit."""
    f, lens = delta_case(layout, T, F, W)
    x = torch.from_numpy(f).to(cuda)
    n = None if lens is None else torch.from_numpy(lens).to(cuda)
    before = _n("fused_deltas")
    got = fused_deltas.fused_append_deltas(x, W, n)
    torch.cuda.synchronize()
    assert _n("fused_deltas") == before + 1
    want = deltas.plain_append_deltas(x, W, n)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    host = deltas.plain_append_deltas(
        torch.from_numpy(f), W,
        None if lens is None else torch.from_numpy(lens))
    assert torch.equal(want.cpu().view(torch.int32), host.view(torch.int32))


@pytest.mark.cuda
def test_fused_deltas_wrapper_checks(cuda):
    """float64, a non-contiguous layout and a wrong number of frame counts
    raise; an empty batch launches nothing; int64 frame counts read as
    int32; under "high" ``append_deltas`` takes the plain chain."""
    with pytest.raises(TypeError):
        fused_deltas.fused_append_deltas(
            torch.zeros((2, 5, 3), dtype=torch.float64, device=cuda), 2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_deltas.fused_append_deltas(
            torch.zeros((2, 3, 5), device=cuda).transpose(1, 2), 2)
    with pytest.raises(ValueError, match="frame counts"):
        fused_deltas.fused_append_deltas(
            torch.zeros((2, 5, 3), device=cuda), 2,
            torch.ones(3, dtype=torch.int32, device=cuda))
    before = _n("fused_deltas")
    for shape in ((0, 5, 3), (2, 0, 3)):
        out = fused_deltas.fused_append_deltas(torch.zeros(shape, device=cuda),
                                               2)
        assert tuple(out.shape) == (*shape[:2], 9)
    assert _n("fused_deltas") == before
    f, lens = delta_case("ragged", 70, 80, 2)
    x = torch.from_numpy(f).to(cuda)
    n32 = torch.from_numpy(lens).to(cuda)
    assert torch.equal(fused_deltas.fused_append_deltas(x, 2, n32),
                       fused_deltas.fused_append_deltas(x, 2, n32.long()))
    before = _n("fused_deltas")
    high = deltas.append_deltas(
        x, FeatureConfig(deltas=True, matmul_precision="high"), n32)
    assert _n("fused_deltas") == before
    assert torch.equal(high, fused_deltas.fused_append_deltas(x, 2, n32))


@pytest.mark.cuda
@pytest.mark.parametrize("entry,kw", [
    (logmel_model.log_mel_batch, dict(n_mels=80, n_mfcc=80)),
    (mfcc_model.mfcc_batch, dict(delta_window=3)),
    (plp_model.plp_batch, dict())])
def test_main_paths_append_deltas_through_the_kernel(cuda, gen, monkeypatch,
                                                     entry, kw):
    """A batch with deltas launches ``fused_deltas`` once, and its output
    equals the same batch with the plain chain in the kernel's place."""
    cfg = FeatureConfig(deltas=True, **kw).validate()
    lens = np.array([16000, 9000, 400, 0], np.int32)
    x = torch.from_numpy((gen.standard_normal((4, 16000)) * 0.3)
                         .astype(np.float32)).to(cuda)
    n = torch.from_numpy(lens).to(cuda)
    before = _n("fused_deltas")
    got = entry(x, n, cfg)
    torch.cuda.synchronize()
    assert _n("fused_deltas") == before + 1
    monkeypatch.setattr(fused_deltas, "fused_append_deltas",
                        deltas.plain_append_deltas)
    want = entry(x, n, cfg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_s,N,lens", [
    (30.0, 500_000, [480_000, 320_000, 16_000, 0, 500_000]),
    (1.003, 17_000, [16_048, 9_000, 17_000])])
def test_whisper_through_the_direct_tile(cuda, gen, chunk_s, N, lens):
    """``whisper_log_mel_batch`` with "auto" on the card: one launch of
    ``fused_raw``'s mixed-radix FFT tile ("fft64_mixed", which took over
    Whisper's n_fft of 400 from the direct tile) a batch, no host sync once
    its constants are built, the features within 2e-5 of the float64
    reference (the float64 front) and within 1e-4 of the plain route on
    the host (the float32 chain's bound, ``tests/test_torch_whisper.py``)."""
    import dataclasses
    from mfcc_tpu_torch.config import WhisperConfig
    from mfcc_tpu_torch.models import whisper
    from perfbench.reference import whisper as whisper_ref
    cfg = WhisperConfig(chunk_s=chunk_s).validate()
    x = torch.from_numpy(np.clip(gen.standard_normal((len(lens), N)) * 3000,
                                 -32768, 32767).astype(np.int16))
    n = torch.tensor(lens)
    xd, nd = x.to(cuda), n.to(cuda)
    whisper.whisper_log_mel_batch(xd, nd, cfg)
    before = report.launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        feat, flens, mask = whisper.whisper_log_mel_batch(xd, nd, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert _launched(before) == {"fused_raw": 1,
                                 ("fused_raw", "fft64_mixed"): 1}
    assert feat.shape == (len(lens), cfg.num_frames(), cfg.n_mels)
    assert bool(mask.all()) and int(flens.min()) == cfg.num_frames()
    want, _, _ = whisper_ref.features(x, lens, dataclasses.asdict(cfg), False)
    plain, _, _ = whisper.whisper_log_mel_batch(x, n, cfg)
    assert float((feat.cpu().double() - want).abs().max()) < 2e-5
    assert float((feat.cpu() - plain).abs().max()) < 1e-4


def _front_oracle(xp: np.ndarray, kcfg, front) -> np.ndarray:
    """The floored natural log of a front's band energies, float64: frames
    of the (B, N) rows, the window-folded DFT, |X|^2, the bank."""
    from mfcc_tpu_torch.ops.spectrum import folded_dft
    cos_m, sin_m = folded_dft(front.window, kcfg.n_fft)
    T = kcfg.num_frames(xp.shape[1])
    idx = np.arange(T)[:, None] * kcfg.hop_len + np.arange(kcfg.frame_len)
    fr = xp.astype(np.float64)[:, idx]
    power = (fr @ cos_m) ** 2 + (fr @ sin_m) ** 2
    return np.log(np.maximum(power @ front.bank, kcfg.log_floor))


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,B,N", [
    (400, 3, 400 + 160 * 70),      # Whisper's; T = 71, an odd count
    (200, 2, 200 + 100 * 64),      # 2^3 5^2
    (320, 2, 320 + 160 * 40),      # 2^6 5
    (800, 2, 800 + 320 * 33),      # 2^5 5^2
    (1000, 2, 1000 + 400 * 20),    # 2^3 5^3
    (2000, 1, 2000 + 800 * 9),     # 2^4 5^3
])
def test_mixed_tile_against_the_direct_tile(cuda, gen, n_fft, B, N):
    """``fused_raw``'s mixed-radix tile and its direct tile on the same
    Whisper-style constants (a periodic Hann window of n_fft points, Hz
    triangles) at n_fft = 2^a 5^b, one launch each: the mixed tile within
    1e-5 of the float64 oracle, the two tiles within the log-mel bound
    (rtol 1e-4 + atol 2e-5) of each other; a row that ends early gives the
    floored frames past it."""
    from mfcc_tpu_torch.config import WhisperConfig
    from mfcc_tpu_torch.models import whisper
    cfg = WhisperConfig(n_fft=n_fft, frame_ms=n_fft / 16.0,
                        hop_ms=n_fft / 40.0).validate()
    kcfg, front = cfg.feature_config(), whisper.front(cfg)
    x = (gen.standard_normal((B, N)) * 0.1).astype(np.float32)
    x[-1, N // 2:] = 0.0
    xd = torch.from_numpy(x).to(cuda)
    outs = {}
    for tile in ("fft64_mixed", "direct"):
        before = report.launches()
        outs[tile] = _spectral.launch_spectral(
            fused_raw._lib, "mfcc_fused_raw", "fused_raw", xd, kcfg, False,
            0.0, other=_spectral.direct_tile("mel", front),
            tile=None if tile != "direct" else "direct", front=front,
            mixed=True)
        torch.cuda.synchronize()
        assert _launched(before) == {"fused_raw": 1, ("fused_raw", tile): 1}
    want = _front_oracle(x, kcfg, front)
    mixed, direct = (outs[t].cpu().numpy() for t in ("fft64_mixed", "direct"))
    assert mixed.shape == want.shape
    assert np.abs(mixed - want).max() <= 1e-5
    assert (np.abs(mixed - direct) <= 2e-5 + 1e-4 * np.abs(direct)).all()


# a ragged 30 s Whisper batch at the skip rule's edges (the lengths of
# tests/test_torch_whisper.py::EDGE_LENGTHS): the left reflect pad, hop
# multiples, a 16-frame tile's edge, 25 s, the right reflect pad's limit,
# the window and past it
WHISPER_EDGE_LENGTHS = [0, 1, 199, 200, 201, 15_999, 16_000, 16_001, 25_399,
                        25_400, 25_401, 400_000, 479_959, 479_960, 479_999,
                        480_000, 496_000]


def _whisper_edge_batch(cuda, gen):
    """-> (cfg, int16 rows (B, 496,000), lengths (B,) int64), on the card."""
    from mfcc_tpu_torch.config import WHISPER128
    lens = np.array(WHISPER_EDGE_LENGTHS, np.int64)
    x = np.clip(gen.standard_normal((lens.size, 496_000)) * 3000, -32768,
                32767).astype(np.int16)
    return (WHISPER128, torch.from_numpy(x).to(cuda),
            torch.from_numpy(lens).to(cuda))


@pytest.mark.cuda
def test_mixed_tile_skips_the_zero_tails_with_the_same_bits(cuda, gen):
    """``fused_raw``'s mixed tile handed the rows' lengths (``RowBounds``)
    on the edge batch: the features equal the same call without lengths
    bit for bit; with every sample past each row's zero tail planted
    nonzero, the tiles the host twin skips (``first_skipped_frame``) keep
    the zero frames' bits and every other frame is the planted rows'
    own: the kernel skips exactly those tiles."""
    from mfcc_tpu_torch.models import whisper
    cfg, x, n = _whisper_edge_batch(cuda, gen)
    kcfg, front = cfg.feature_config(), whisper.front(cfg)
    xp = framing.stft_center_batch(x.to(torch.float32) / 32768.0, n, cfg)
    bounds = _spectral.RowBounds(n, cfg.n_fft // 2, cfg.chunk_samples)

    def call(rows, bounds=None):
        return fused_raw.fused_features_raw(rows, kcfg, apply_dct=False,
                                            front=front, bounds=bounds)
    plain, bounded = call(xp), call(xp, bounds)
    assert torch.equal(bounded, plain)
    L, hop, T = xp.shape[1], cfg.hop_len, cfg.num_frames()
    tm = _spectral.fft_frame_tile(kcfg, "fft64_mixed")
    planted = xp.clone()
    firsts = []
    for b, length in enumerate(WHISPER_EDGE_LENGTHS):
        z = _spectral.zero_tail(length, cfg.n_fft // 2, cfg.chunk_samples, L)
        planted[b, z:] = 0.25
        firsts.append(_spectral.first_skipped_frame(
            length, cfg.n_fft // 2, cfg.chunk_samples, L, hop, tm))
    got, own = call(planted, bounds), call(planted)
    torch.cuda.synchronize()
    assert any(f < T for f in firsts) and any(f >= T for f in firsts)
    for b, first in enumerate(firsts):
        assert torch.equal(got[b, first:], plain[b, first:]), b
        assert torch.equal(got[b, :first], own[b, :first]), b
        if first < T:
            assert not torch.equal(own[b, first:], plain[b, first:]), b


@pytest.mark.cuda
def test_whisper_batch_with_lengths_keeps_todays_bits(cuda, gen):
    """``whisper_log_mel_batch`` on the edge batch, which hands the tile the
    rows' lengths: one mixed-tile launch, the same bits as the batch sent
    through the tile without lengths (the path before the skip), and
    ``frames_bounded`` B x 3,000 a call under a profiler, as
    ``frames_computed``."""
    from torch.profiler import profile
    from mfcc_tpu_torch.models import whisper
    cfg, x, n = _whisper_edge_batch(cuda, gen)
    feat, _, _ = whisper.whisper_log_mel_batch(x, n, cfg)
    xp = framing.stft_center_batch(x.to(torch.float32) / 32768.0, n, cfg)
    want = whisper.normalize(whisper.log_mel(xp, cfg))
    assert torch.equal(feat, want)
    report.reset()
    before = report.launches()
    with profile():
        whisper.whisper_log_mel_batch(x, n, cfg)
        torch.cuda.synchronize()
    assert _launched(before) == {"fused_raw": 1,
                                 ("fused_raw", "fft64_mixed"): 1}
    B, T = x.shape[0], cfg.num_frames()
    c = report.counters()
    assert c["frames_bounded"] == c["frames_computed"] == B * T == B * 3000


@pytest.mark.cuda
def test_power_of_two_fused_raw_ignores_row_bounds(cuda, gen):
    """A power-of-two ``fused_raw`` call (unbounded log-mel-80 on the fft64
    tile) given row bounds computes every frame as without them, bit for
    bit, and counts no bounded frame."""
    from torch.profiler import profile
    cfg = FeatureConfig(n_mels=80, n_mfcc=80).validate()
    x = torch.from_numpy((gen.standard_normal((3, 16000)) * 0.1)
                         .astype(np.float32)).to(cuda)
    bounds = _spectral.RowBounds(
        torch.tensor([0, 100, 16000], device=cuda), 0, 16000)
    report.reset()
    before = report.launches()
    with profile():
        got = fused_raw.fused_features_raw(x, cfg, apply_dct=False,
                                           bounds=bounds)
        want = fused_raw.fused_features_raw(x, cfg, apply_dct=False)
        torch.cuda.synchronize()
    assert _launched(before) == {"fused_raw": 2, ("fused_raw", "fft64"): 2}
    assert torch.equal(got, want)
    assert report.counters()["frames_bounded"] == 0


def _guard_oracle(xp: np.ndarray, kcfg, front) -> np.ndarray:
    """The natural log of a front's band energies under NeMo's additive
    guard, float64: log(e + log_floor)."""
    from mfcc_tpu_torch.ops.spectrum import folded_dft
    cos_m, sin_m = folded_dft(front.window, kcfg.n_fft)
    T = kcfg.num_frames(xp.shape[1])
    idx = np.arange(T)[:, None] * kcfg.hop_len + np.arange(kcfg.frame_len)
    fr = xp.astype(np.float64)[:, idx]
    power = (fr @ cos_m) ** 2 + (fr @ sin_m) ** 2
    return np.log(power @ front.bank + kcfg.log_floor)


@pytest.mark.cuda
@pytest.mark.parametrize("frame_ms,n_fft,n_mels", [
    (25.0, 512, 128),     # NeMo's: 400 points in 512
    (25.0, 512, 80),      # parakeet-ctc-1.1b's 80 bands
    (32.0, 512, 64),      # a frame of the whole n_fft
    (12.5, 256, 40),      # 200 points in 256
    (50.0, 1024, 128),    # 800 points in 1024
])
def test_guarded_fft64_tile_against_the_oracle(cuda, gen, frame_ms, n_fft,
                                              n_mels):
    """``fused_raw``'s fft64 tile in the guard's mode on NeMo-style fronts
    (the symmetric Hann window of frame_len points, Hz triangles), one
    launch: within 1e-5 of the float64 oracle of log(e + 2^-24), within
    the log-mel bound (rtol 1e-4 + atol 2e-5) of the plain chain on the
    card, and a row that ends early gives the guard's log(2^-24) on the
    frames past it; ``frames_guarded`` counts the call's B x T."""
    from torch.profiler import profile
    from mfcc_tpu_torch.config import NemoConfig
    from mfcc_tpu_torch.models import nemo
    cfg = NemoConfig(frame_ms=frame_ms, n_fft=n_fft, n_mels=n_mels,
                     n_mfcc=n_mels).validate()
    kcfg, front = cfg.feature_config(), nemo.front(cfg)
    x = (gen.standard_normal((3, 16000)) * 0.05).astype(np.float32)
    x[-1, 8000:] = 0.0
    xd = torch.from_numpy(x).to(cuda)
    report.reset()
    before = report.launches()
    with profile():
        got = fused_raw.fused_features_raw(xd, kcfg, apply_dct=False,
                                           front=front)
        torch.cuda.synchronize()
    assert _launched(before) == {"fused_raw": 1, ("fused_raw", "fft64"): 1}
    assert report.counters()["frames_guarded"] == got.shape[0] * got.shape[1]
    got = got.cpu().numpy()
    want = _guard_oracle(x, kcfg, front)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5
    plain = _spectral.plain_front_features(xd, kcfg, front).cpu().numpy()
    assert (np.abs(got - plain) <= 2e-5 + 1e-4 * np.abs(plain)).all()
    silent = -(-8000 // kcfg.hop_len)    # the first frame past the row
    np.testing.assert_allclose(got[-1, silent:], np.log(2.0 ** -24), rtol=0,
                               atol=1e-6)


@pytest.mark.cuda
def test_nemo_batch_through_the_kernel(cuda, gen):
    """``nemo_log_mel_batch`` on a ragged int16 batch on the card: one
    ``fused_raw`` launch on "fft64" with the guard, the frame counts and
    mask exact, the padded frames zero, the values within 1e-4 of the
    benchmark's float64 reference and of the plain route on the card
    (``backend="torch"``), and no host sync inside the batch."""
    from torch.profiler import ProfilerActivity, profile
    from mfcc_tpu_torch.config import NEMO128
    from mfcc_tpu_torch.models import nemo
    from perfbench.reference import nemo as nemo_ref
    import dataclasses
    lens = np.array([160_000, 96_001, 16_000, 4_321, 320, 159], np.int64)
    x = np.clip(gen.standard_normal((lens.size, 160_000)) * 3000, -32768,
                32767).astype(np.int16)
    for b, m in enumerate(lens):
        x[b, m:] = 0
    xd, nd = torch.from_numpy(x).to(cuda), torch.from_numpy(lens).to(cuda)
    before = report.launches()
    feat, flens, mask = nemo.nemo_log_mel_batch(xd, nd, NEMO128)
    torch.cuda.synchronize()
    assert _launched(before) == {"fused_raw": 1, ("fused_raw", "fft64"): 1}
    plain, pflens, pmask = nemo.nemo_log_mel_batch(xd, nd, NEMO128,
                                                   backend="torch")
    want, wflens, wmask = nemo_ref.features(
        xd, lens.tolist(), dataclasses.asdict(NEMO128), False)
    assert flens.tolist() == (lens // 160).tolist() == wflens.tolist()
    assert torch.equal(mask, wmask) and torch.equal(pmask, mask)
    assert not feat[~mask].any() and bool(torch.isfinite(feat).all())
    assert float((feat.double() - want).abs().max()) <= 1e-4
    assert float((feat - plain).abs().max()) <= 1e-4
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        nemo.nemo_log_mel_batch(xd, nd, NEMO128)
    events = list(prof.events())
    batch = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == "feat.batch"]
    blocking = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D")
    syncs = [e.name for e in events if e.name in blocking
             and any(s <= e.time_range.start <= t for s, t in batch)]
    assert len(batch) == 1 and syncs == []
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_guard_off_keeps_the_floors_bits(cuda, gen):
    """The guard's plumbing at its off value: ``fused_raw`` on log-mel-80
    through a ``Front`` of the config's own window and mel matrix (guard
    False) equals the config's own call bit for bit, as Whisper's front
    equals a copy of it that states guard False; neither counts a guarded
    frame, and a guard front on Whisper's mixed-radix tile is refused."""
    from torch.profiler import profile
    from mfcc_tpu_torch.config import LOGMEL80, WhisperConfig
    from mfcc_tpu_torch.models import whisper
    from mfcc_tpu_torch.ops import mel as mel_op
    cfg = LOGMEL80.replace(deltas=False)
    x = torch.from_numpy((gen.standard_normal((3, 24000)) * 0.1)
                         .astype(np.float32)).to(cuda)
    own = _spectral.Front(oracle.window_fn(cfg.window, cfg.frame_len),
                          mel_op.mel_matrix(cfg), guard=False)
    wcfg = WhisperConfig(chunk_s=1.0).validate()
    wk, wf = wcfg.feature_config(), whisper.front(wcfg)
    copy = _spectral.Front(wf.window.copy(), wf.bank.copy(), guard=False)
    xw = framing.stft_center_batch(x[:, :16000], torch.tensor(
        [16000, 9000, 100], device=cuda), wcfg)
    report.reset()
    with profile():
        assert torch.equal(
            fused_raw.fused_features_raw(x, cfg, apply_dct=False, front=own),
            fused_raw.fused_features_raw(x, cfg, apply_dct=False))
        assert torch.equal(
            fused_raw.fused_features_raw(xw, wk, apply_dct=False, front=copy),
            fused_raw.fused_features_raw(xw, wk, apply_dct=False, front=wf))
        torch.cuda.synchronize()
    assert report.counters()["frames_guarded"] == 0
    guarded = _spectral.Front(wf.window, wf.bank, guard=True)
    with pytest.raises(ValueError, match="guard"):
        fused_raw.fused_features_raw(xw, wk, apply_dct=False, front=guarded)


@pytest.mark.cuda
def test_frames_guarded_counts_nemos_calls_alone(cuda, gen):
    """Under a profiler, NeMo's batch counts its B x T in
    ``frames_guarded``; log-mel-80 and Whisper's batches, run beside it,
    count none."""
    from torch.profiler import profile
    from mfcc_tpu_torch.config import LOGMEL80, NEMO128, WhisperConfig
    from mfcc_tpu_torch.models import logmel, nemo, whisper
    x = torch.from_numpy(np.clip(gen.standard_normal((4, 32000)) * 3000,
                                 -32768, 32767).astype(np.int16)).to(cuda)
    n = torch.tensor([32000, 20000, 9000, 400], device=cuda)
    report.reset()
    with profile():
        logmel.log_mel_batch(x, n, LOGMEL80)
        whisper.whisper_log_mel_batch(x, n, WhisperConfig(chunk_s=2.0)
                                      .validate())
        feat, _, _ = nemo.nemo_log_mel_batch(x, n, NEMO128)
        torch.cuda.synchronize()
    c = report.counters()
    assert c["frames_guarded"] == feat.shape[0] * feat.shape[1] == 4 * 201
    assert c["frames_computed"] > c["frames_guarded"]
