"""The port's spectral kernel modules (fused_raw_dit, fused_raw, fused_dit,
fused_mfcc) against the JAX Pallas kernels (interpret mode on the CPU, as
tests/test_kernels.py runs them), the radix-2 DIT twins and the route
predicates against the reference's, plus the layout of the CUDA kernels'
constants and numpy emulations of their tiling (the direct tile, the DIT
tile and the FFT tile).  The cases that need the
card are in tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mfcc_tpu import FeatureConfig as JaxConfig, oracle as jax_oracle
from mfcc_tpu.ops import spectrum as jax_spectrum
from mfcc_tpu.ops.kernels import (fused_dit as jax_dit,
                                  fused_mfcc as jax_direct,
                                  fused_raw as jax_raw,
                                  fused_raw_dit as jax_kernel)
from mfcc_tpu_torch import FeatureConfig, from_jax, oracle
from mfcc_tpu_torch.ops import framing, mel, spectrum, xmath
from mfcc_tpu_torch.ops.kernels import (_spectral, fused_dit, fused_mfcc,
                                        fused_raw, fused_raw_dit, routes)
from mfcc_tpu_torch.utils import report

TOL = 2e-5   # kernel vs XLA bound of tests/test_kernels.py

# the tiny raw-DIT-eligible config of __graft_entry__.dryrun_multichip
TINY = dict(sample_rate=2000, frame_ms=40, hop_ms=16, n_fft=128, n_mels=8,
            n_mfcc=4)
# log-mel-80 (+ deltas in the model tests), BASELINE config 3
LOGMEL80 = dict(n_mels=80, n_mfcc=80)
# the 22.05 kHz TTS frame geometry: 1024-sample frames, hop 256
TTS = dict(sample_rate=22050, frame_ms=46.44, hop_ms=11.61, n_fft=1024,
           n_mels=80, n_mfcc=13)
HI_RATE = dict(sample_rate=44100, n_fft=2048)      # hop 441, frame 1102
ODD_FRAME = dict(frame_ms=25.0625, hop_ms=12.5)     # frame_len 401, hop 200


@pytest.mark.parametrize("kw,shape", [
    (TINY, (2, 2000)),
    (dict(), (2, 8000)),                          # 16 kHz, B=2 x 0.5 s
    (dict(lifter=22, append_energy=True), (2, 8000)),
    (dict(dynamic_range_db=50.0), (2, 8000)),
])
def test_plain_matches_pallas_kernel(rng, kw, shape):
    jc = JaxConfig(**kw).validate()
    x = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    want = np.asarray(jax_kernel.fused_features_raw_dit(
        jnp.asarray(x), jc, merged=True, interpret=True))
    got = fused_raw_dit.plain_features(torch.from_numpy(x), from_jax(jc))
    assert tuple(got.shape) == want.shape
    lift = jax_oracle.lifter_coeffs(jc.n_mfcc, jc.lifter)
    np.testing.assert_allclose(got.numpy() / lift, want / lift, atol=TOL,
                               rtol=0)


def test_wrapper_on_cpu_runs_the_plain_version(rng):
    cfg = FeatureConfig()
    x = torch.from_numpy((rng.standard_normal((2, 4000)) * 0.3)
                         .astype(np.float32))
    before = report.launches()
    got = fused_raw_dit.fused_features_raw_dit(x, cfg)
    assert torch.equal(got, fused_raw_dit.plain_features(x, cfg))
    assert report.launches() == before      # nothing was launched
    empty = fused_raw_dit.fused_features_raw_dit(x[:, :399], cfg)
    assert tuple(empty.shape) == (2, 0, 13)


def test_wrapper_rejects_bad_input():
    cfg = FeatureConfig()
    with pytest.raises(ValueError):
        fused_raw_dit.fused_features_raw_dit(torch.zeros(4000), cfg)
    with pytest.raises(ValueError, match="center"):
        fused_raw_dit.fused_features_raw_dit(
            torch.zeros((1, 4000)), cfg.replace(frame_mode="center"))
    with pytest.raises(ValueError, match="accum_dtype"):
        fused_raw_dit.fused_features_raw_dit(
            torch.zeros((1, 4000)), cfg.replace(accum_dtype="int32"))
    # every precision mode is taken (the route alone sends "high" away
    # from the kernels); a CPU tensor runs the plain version at the mode
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 4000)).astype(np.float32))
    before = report.launches()
    for kw in (dict(matmul_precision="high"), dict(matmul_precision="default"),
               dict(compute_dtype="bfloat16")):
        c = cfg.replace(**kw)
        assert torch.equal(fused_raw_dit.fused_features_raw_dit(x, c),
                           fused_raw_dit.plain_features(x, c))
    # no kernel reads accum_dtype: the plain version runs at float32
    assert torch.equal(fused_raw_dit.fused_features_raw_dit(
        x, cfg.replace(accum_dtype="bfloat16")),
        fused_raw_dit.plain_features(x, cfg))
    assert report.launches() == before


@pytest.mark.parametrize("kw", [dict(), TINY, dict(n_fft=1024),
                                dict(sample_rate=8000, n_fft=256),
                                dict(n_fft=401, lifter=22)])
def test_kernel_constants_layout(kw):
    """Every basis block holds the float32 window-folded cos | sin columns
    of 256 consecutive bins in natural order; the last bin sits apart."""
    cfg = FeatureConfig(**kw).validate()
    basis, last, melw, dctm = fused_raw._matrices(cfg)
    cos_m, sin_m = jax_spectrum.dft_matrices(JaxConfig(**kw))
    nb = cfg.n_bins - 1
    assert basis.shape == (-(-nb // 256), cfg.frame_len, 512)
    cos_k = np.concatenate([b[:, :256] for b in basis], axis=1)
    sin_k = np.concatenate([b[:, 256:] for b in basis], axis=1)
    np.testing.assert_array_equal(cos_k[:, :nb], cos_m[:, :nb].astype(np.float32))
    np.testing.assert_array_equal(sin_k[:, :nb], sin_m[:, :nb].astype(np.float32))
    assert not cos_k[:, nb:].any() and not sin_k[:, nb:].any()
    np.testing.assert_array_equal(last[:, 0], cos_m[:, nb].astype(np.float32))
    np.testing.assert_array_equal(last[:, 1], sin_m[:, nb].astype(np.float32))
    assert melw.shape == (cfg.n_bins, cfg.n_mels)
    assert dctm.shape == (cfg.n_mels, cfg.n_mfcc)


def _emulate_kernel(x: np.ndarray, cfg: FeatureConfig, tm: int = 64,
                    apply_dct: bool = True):
    """The direct CUDA tile's data flow in numpy (float64 sums): per (row,
    tile of tm frames) the audio span is staged and pre-emphasized with each
    sample's true predecessor (x[0] only at the row start), the bins come
    from the 256-wide basis blocks plus the separate last bin, then mel,
    floors, log, DCT and the energy column (or the log-mel energies)."""
    basis, last, melw, dctm = (a.astype(np.float64)
                               for a in fused_raw._matrices(cfg))
    B, N = x.shape
    T, hop, fl = cfg.num_frames(N), cfg.hop_len, cfg.frame_len
    out = np.zeros((B, T, cfg.n_mfcc if apply_dct else cfg.n_mels))
    rel = mel.relative_floor(cfg)
    for b in range(B):
        for t0 in range(0, T, tm):
            s0 = t0 * hop
            span = (tm - 1) * hop + fl
            g = s0 + np.arange(span)
            cur = np.where(g < N, x[b, np.minimum(g, N - 1)], 0.0)
            prev = np.where(g > 0, x[b, np.clip(g - 1, 0, N - 1)], x[b, 0])
            z = np.where(g < N, cur - np.float32(cfg.preemph) * prev, 0.0)
            fr = np.stack([z[m * hop: m * hop + fl] for m in range(tm)])
            pw = []
            for blk in basis:
                s = fr @ blk
                pw.append(s[:, :256] ** 2 + s[:, 256:] ** 2)
            pw = np.concatenate(pw, axis=1)[:, : cfg.n_bins - 1]
            pl = (fr @ last) ** 2
            e = pw @ melw[:-1] + pl.sum(axis=1, keepdims=True) * melw[-1]
            floor = np.maximum(cfg.log_floor, rel * e.max(axis=1, keepdims=True))
            f = np.log(np.maximum(e, floor))
            if apply_dct:
                f = f @ dctm
            if cfg.append_energy and apply_dct:
                f[:, 0] = np.log(np.maximum((fr * fr).sum(axis=1),
                                            cfg.log_floor))
            n = min(tm, T - t0)
            out[b, t0: t0 + n] = f[:n]
    return out


@pytest.mark.parametrize("kw,N", [
    (dict(), 33360),                        # T=207: 3 full tiles + 15
    (dict(lifter=22, append_energy=True, dynamic_range_db=40.0), 21000),
    (dict(sample_rate=48000, n_fft=2048), 30000),   # four 256-bin blocks
    (TINY, 2000),
])
def test_kernel_tiling_matches_plain(rng, kw, N):
    """Frames that straddle tiles take the true pre-emphasis predecessor: a
    zero predecessor at a tile edge would show as ~1e-3 on those frames."""
    cfg = FeatureConfig(**kw).validate()
    x = (rng.standard_normal((2, N)) * 0.3).astype(np.float32)
    want = fused_raw_dit.plain_features(torch.from_numpy(x), cfg).numpy()
    got = _emulate_kernel(x, cfg)
    lift = jax_oracle.lifter_coeffs(cfg.n_mfcc, cfg.lifter)
    np.testing.assert_allclose(got / lift, want / lift, atol=TOL, rtol=0)


def test_plain_power_spectrum_matches_oracle(rng):
    cfg = FeatureConfig()
    fr = rng.standard_normal((5, cfg.frame_len)) * 0.3
    got = spectrum.power_spectrum(torch.from_numpy(fr.astype(np.float32)),
                                  cfg).numpy()
    want = jax_oracle.power_spectrum(fr, JaxConfig())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["fused_raw_dit", "fused_nccf",
                                  "fused_viterbi", "fused_raw", "fused_dit",
                                  "fused_mfcc", "fused_deltas"])
def test_build_failure_raises(monkeypatch, tmp_path, name):
    """A kernel whose nvcc build fails raises (nothing falls back), and a
    missing toolkit is named."""
    import shutil
    from mfcc_tpu_torch.ops.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load.__wrapped__(name)
    assert not list(tmp_path.glob("*.so"))
    monkeypatch.undo()
    monkeypatch.setattr(shutil, "which", lambda _: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


# ---------------------------------------------------------------------------
# fused_raw, fused_dit, fused_mfcc: plain versions against the Pallas
# kernels in interpret mode, at the reference tests' bounds (cepstra 2e-5
# unliftered; log-mel rtol 1e-4 plus atol 2e-5, tests/test_kernels.py)
# ---------------------------------------------------------------------------

def _assert_features(got, want, cfg, apply_dct):
    assert got.shape == want.shape
    if apply_dct:
        lift = jax_oracle.lifter_coeffs(cfg.n_mfcc, cfg.lifter)
        np.testing.assert_allclose(got / lift, want / lift, atol=TOL, rtol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)


def _preemphasized(x: np.ndarray, cfg) -> np.ndarray:
    return framing.preemphasize(torch.from_numpy(x), from_jax(cfg)).numpy()


@pytest.mark.parametrize("kw,apply_dct", [
    (dict(), True),
    (LOGMEL80, False),
    (dict(lifter=22, append_energy=True), True),
    (dict(LOGMEL80, append_energy=True), False),   # energy is cepstral only
    (dict(sample_rate=8000, n_fft=256), False),
])
def test_fused_raw_plain_matches_pallas(rng, kw, apply_dct):
    jc = JaxConfig(**kw).validate()
    x = (rng.standard_normal((2, 8000)) * 0.3).astype(np.float32)
    want = np.asarray(jax_raw.fused_features_raw(
        jnp.asarray(x), jc, apply_dct=apply_dct, interpret=True))
    got = fused_raw.fused_features_raw(torch.from_numpy(x), from_jax(jc),
                                       apply_dct=apply_dct)
    _assert_features(got.numpy(), want, jc, apply_dct)


@pytest.mark.parametrize("kw,apply_dct,n", [
    (dict(TTS, n_mfcc=80), False, 11025),
    # cepstra at 22.05 kHz, 25/10 ms (frame 551, hop 220, n_fft 1024); at
    # the TTS geometry's 1024-sample frames both DIT forms sit 2-5e-5 off
    # the float64 oracle in c0 (the DIT valley rounding summed by the DCT)
    (dict(sample_rate=22050, n_fft=1024), True, 11025),
    (dict(hop_ms=12.5), True, 8000),
    (dict(hop_ms=12.5, lifter=22, append_energy=True), True, 8000),
    (dict(ODD_FRAME, dynamic_range_db=60.0), True, 8000),
    (dict(ODD_FRAME, n_mels=40, n_mfcc=40), False, 8000),
])
def test_fused_dit_plain_matches_pallas(rng, kw, apply_dct, n):
    jc = JaxConfig(**kw).validate()
    y = _preemphasized((rng.standard_normal((2, n)) * 0.3)
                       .astype(np.float32), jc)
    want = np.asarray(jax_dit.fused_features_dit(
        jnp.asarray(y), jc, apply_dct=apply_dct, interpret=True))
    got = fused_dit.fused_features_dit(torch.from_numpy(y), from_jax(jc),
                                       apply_dct=apply_dct)
    _assert_features(got.numpy(), want, jc, apply_dct)


@pytest.mark.parametrize("kw,apply_dct,n", [
    (HI_RATE, True, 22050),
    (dict(HI_RATE, **LOGMEL80), False, 22050),
    (dict(), True, 8000),
    (dict(lifter=22, append_energy=True, dynamic_range_db=40.0), True, 8000),
])
def test_fused_mfcc_plain_matches_pallas(rng, kw, apply_dct, n):
    jc = JaxConfig(**kw).validate()
    y = _preemphasized((rng.standard_normal((2, n)) * 0.3)
                       .astype(np.float32), jc)
    want = np.asarray(jax_direct.fused_features(
        jnp.asarray(y), jc, apply_dct=apply_dct, interpret=True))
    got = fused_mfcc.fused_features(torch.from_numpy(y), from_jax(jc),
                                    apply_dct=apply_dct)
    _assert_features(got.numpy(), want, jc, apply_dct)


@pytest.mark.parametrize("kw", [dict(), TTS, ODD_FRAME,
                                dict(sample_rate=8000, n_fft=256),
                                dict(sample_rate=48000, n_fft=2048)])
def test_power_spectrum_dit_matches_reference(rng, kw):
    """The port's DIT power (frames -> natural-order |X|^2) against the
    reference's power_spectrum_dit_split (audio -> p_lo, p_hi), within 2e-5
    of the peak; and against the port's direct form."""
    jc = JaxConfig(**kw).validate()
    cfg = from_jax(jc)
    y = (rng.standard_normal((2, 6000)) * 0.3).astype(np.float32)
    p_lo, p_hi = jax_spectrum.power_spectrum_dit_split(jnp.asarray(y), jc)
    want = np.concatenate([np.asarray(p_lo), np.asarray(p_hi)], axis=-1)
    fr = framing.frames(torch.from_numpy(y), cfg)
    got = spectrum.power_spectrum_dit(fr, cfg).numpy()
    assert got.shape == want.shape == (2, cfg.num_frames(6000), cfg.n_bins)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * want.max())
    direct = spectrum.power_spectrum(fr, cfg).numpy()
    np.testing.assert_allclose(got, direct, rtol=0, atol=2e-5 * direct.max())


def _config_grid():
    """8/16/22.05/44.1/48 kHz x hops 80..441 x n_fft 256..2048 x 25 ms and
    odd frame lengths; only configs whose sizes round to those values and
    that validate."""
    out = []
    for sr in (8000, 16000, 22050, 44100, 48000):
        for hop in (80, 110, 160, 161, 200, 220, 256, 441):
            for fl in (int(round(0.025 * sr)), 401, 1023, 1102):
                for n_fft in (256, 400, 512, 1024, 2048):
                    if n_fft < fl:
                        continue
                    jc = JaxConfig(sample_rate=sr, frame_ms=1000.0 * fl / sr,
                                   hop_ms=1000.0 * hop / sr, n_fft=n_fft)
                    if jc.frame_len == fl and jc.hop_len == hop:
                        out.append(jc)
    return out


def _reference_route(jc, apply_dct):
    """The reference's kernel choice, models/mfcc.py:78-95 and
    ops/kernels/__init__.py:66-72."""
    use_dit = apply_dct or (jc.dynamic_range_db is not None
                            and jc.dynamic_range_db <= 50.0)
    if use_dit and jax_kernel.raw_dit_kernel_eligible(jc):
        return "fused_raw_dit"
    if jax_raw.raw_kernel_eligible(jc):
        return "fused_raw"
    return ("fused_dit" if jax_dit.dit_kernel_eligible(jc)
            else "fused_mfcc")


def test_route_predicates_match_reference():
    grid = _config_grid()
    assert len(grid) > 300
    seen = set()
    for jc in grid:
        cfg = from_jax(jc)
        assert routes.raw_dit_kernel_eligible(cfg) == \
            jax_kernel.raw_dit_kernel_eligible(jc), jc
        assert routes.raw_kernel_eligible(cfg) == \
            jax_raw.raw_kernel_eligible(jc), jc
        assert routes.dit_kernel_eligible(cfg) == \
            jax_dit.dit_kernel_eligible(jc), jc
        for db in (None, 40.0, 50.0, 50.5):
            c, j = cfg.replace(dynamic_range_db=db), jc.replace(
                dynamic_range_db=db)
            for apply_dct in (True, False):
                route = routes.spectral_route(c, apply_dct)
                assert route == _reference_route(j, apply_dct), (jc, db)
                seen.add(route)
    assert seen == {"fused_raw_dit", "fused_raw", "fused_dit", "fused_mfcc"}


def test_dit_matrices_match_reference():
    keys = {(jc.frame_len, jc.n_fft) for jc in _config_grid()
            if jc.n_fft % 4 == 0}
    for fl, n_fft in sorted(keys):
        for window in ("hamming", "povey"):
            kw = dict(frame_ms=fl / 16.0, n_fft=n_fft, window=window)
            jc = JaxConfig(**kw)
            assert jc.frame_len == fl
            got = spectrum.dit_matrices(from_jax(jc))
            want = jax_spectrum.dit_matrices(jc)
            for g, w in zip((got[0][0], got[0][1], got[1][0], got[1][1],
                             got[2], got[3]),
                            (want[0][0], want[0][1], want[1][0], want[1][1],
                             want[2], want[3])):
                assert g.dtype == np.float64 and g.shape == w.shape
                np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the CUDA kernels' constants and numpy emulations of their data flow
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [TTS, ODD_FRAME, dict(sample_rate=8000,
                                                     n_fft=256),
                                dict(sample_rate=48000, n_fft=2048)])
def test_dit_kernel_constants_layout(kw):
    """Block k holds half-bins 128k..128k+127 as [E cos | E sin | O cos |
    O sin], zero past n_fft/4 and past each parity stream's rows."""
    cfg = FeatureConfig(**kw).validate()
    basis, last, tw, melw, dctm = fused_dit._matrices(cfg)
    (be, bel), (bo, bol), ct, st = spectrum.dit_matrices(cfg)
    nb2, le, lo = cfg.n_fft // 4, be.shape[0], bo.shape[0]
    le_pad = basis.shape[1]
    assert le_pad % 16 == 0 and le_pad - 16 < le <= le_pad
    assert basis.shape == (-(-nb2 // 128), le_pad, 512)
    cols = [np.concatenate([b[:, q * 128:(q + 1) * 128] for b in basis],
                           axis=1) for q in range(4)]
    f32 = lambda a: a.astype(np.float32)
    np.testing.assert_array_equal(cols[0][:le, :nb2], f32(be[:, :nb2]))
    np.testing.assert_array_equal(cols[1][:le, :nb2], f32(be[:, nb2:]))
    np.testing.assert_array_equal(cols[2][:lo, :nb2], f32(bo[:, :nb2]))
    np.testing.assert_array_equal(cols[3][:lo, :nb2], f32(bo[:, nb2:]))
    for q, rows in enumerate((le, le, lo, lo)):
        assert not cols[q][rows:].any() and not cols[q][:, nb2:].any()
    np.testing.assert_array_equal(last[:le, 0], f32(bel[:, 0]))
    np.testing.assert_array_equal(last[:lo, 1], f32(bol[:, 0]))
    assert not last[le:, 0].any() and not last[lo:, 1].any()
    np.testing.assert_array_equal(tw, f32(np.stack([ct, st])))
    assert melw.shape == (cfg.n_bins, cfg.n_mels)


def _emulate_dit_kernel(y: np.ndarray, cfg: FeatureConfig, apply_dct: bool,
                        tm: int = 64):
    """fused_dit.cu's data flow in numpy (float64 sums): per (row, tile of
    tm frames) the span is staged (zeros past the row), each frame's even
    and odd samples are read at stride 2 over le_pad rows, each 128-bin
    block gives E and O, the twiddle combine puts p_plus[j] at bin j and
    p_minus[j] at bin n_fft/2 - j, the mid bin comes from the last columns,
    then mel, floors, log, DCT and energy."""
    basis, last, tw, melw, dctm = (a.astype(np.float64)
                                   for a in fused_dit._matrices(cfg))
    B, N = y.shape
    T, hop, fl = cfg.num_frames(N), cfg.hop_len, cfg.frame_len
    nb2, half, le_pad = cfg.n_fft // 4, cfg.n_fft // 2, basis.shape[1]
    out = np.zeros((B, T, cfg.n_mfcc if apply_dct else cfg.n_mels))
    rel = mel.relative_floor(cfg)
    for b in range(B):
        for t0 in range(0, T, tm):
            g = t0 * hop + np.arange((tm - 1) * hop + 2 * le_pad)
            z = np.where(g < N, y[b, np.minimum(g, N - 1)], 0.0)
            ze = np.stack([z[m * hop: m * hop + 2 * le_pad: 2]
                           for m in range(tm)])
            zo = np.stack([z[m * hop + 1: m * hop + 2 * le_pad: 2]
                           for m in range(tm)])
            power = np.zeros((tm, cfg.n_bins))
            for k, blk in enumerate(basis):
                er, ei = ze @ blk[:, :128], ze @ blk[:, 128:256]
                o_r, oi = zo @ blk[:, 256:384], zo @ blk[:, 384:]
                j = k * 128 + np.arange(128)
                ok = j < nb2
                c = np.where(ok, tw[0, np.minimum(j, nb2 - 1)], 0.0)
                s = np.where(ok, tw[1, np.minimum(j, nb2 - 1)], 0.0)
                b_re, b_im = c * o_r - s * oi, c * oi + s * o_r
                pp = (er + b_re) ** 2 + (ei + b_im) ** 2
                pm = (er - b_re) ** 2 + (ei - b_im) ** 2
                power[:, j[ok]] = pp[:, ok]
                power[:, half - j[ok]] = pm[:, ok]
            power[:, nb2] = (ze @ last[:, 0]) ** 2 + (zo @ last[:, 1]) ** 2
            e = power @ melw
            floor = np.maximum(cfg.log_floor, rel * e.max(axis=1, keepdims=True))
            f = np.log(np.maximum(e, floor))
            if apply_dct:
                f = f @ dctm
                if cfg.append_energy:
                    fr = np.stack([z[m * hop: m * hop + fl] for m in range(tm)])
                    f[:, 0] = np.log(np.maximum((fr * fr).sum(axis=1),
                                                cfg.log_floor))
            n = min(tm, T - t0)
            out[b, t0: t0 + n] = f[:n]
    return out


@pytest.mark.parametrize("kw,apply_dct,N", [
    (dict(TTS, n_mfcc=80), False, 69 * 256 + 1024),   # T=70: 64 + 6
    (dict(TTS, n_mels=26, lifter=22, append_energy=True), True, 20000),
    (dict(ODD_FRAME, append_energy=True), True, 16000),  # uneven streams
    (dict(sample_rate=8000, n_fft=256), True, 8000),     # 64 of 128 bins
    (dict(sample_rate=48000, n_fft=2048, dynamic_range_db=50.0), False,
     30000),                                              # four blocks
])
def test_dit_kernel_emulation_matches_plain(rng, kw, apply_dct, N):
    cfg = FeatureConfig(**kw).validate()
    y = (rng.standard_normal((2, N)) * 0.3).astype(np.float32)
    want = fused_dit.plain_features(torch.from_numpy(y), cfg,
                                    apply_dct).numpy()
    got = _emulate_dit_kernel(y, cfg, apply_dct)
    _assert_features(got, want, cfg, apply_dct)


@pytest.mark.parametrize("kw,apply_dct", [
    (dict(HI_RATE, append_energy=True), True),
    (dict(HI_RATE, **LOGMEL80), False),
])
def test_direct_kernel_emulation_without_preemphasis(rng, kw, apply_dct):
    """fused_mfcc.cu is the direct tile with pre-emphasis off, on audio the
    host pre-emphasized; 1102-sample frames at hop 441."""
    cfg = FeatureConfig(**kw).validate()
    y = _preemphasized((rng.standard_normal((2, 30000)) * 0.3)
                       .astype(np.float32), cfg)
    want = fused_mfcc.plain_features(torch.from_numpy(y), cfg,
                                     apply_dct).numpy()
    got = _emulate_kernel(y, cfg.replace(preemph=0.0), apply_dct=apply_dct)
    _assert_features(got, want, cfg, apply_dct)


@pytest.mark.parametrize("module,fn", [
    (fused_raw, "fused_features_raw"),
    (fused_dit, "fused_features_dit"),
    (fused_mfcc, "fused_features"),
    (fused_raw_dit, "fused_features_raw_dit"),
])
@pytest.mark.parametrize("apply_dct", [True, False])
def test_new_wrappers_on_cpu_run_the_plain_version(rng, module, fn,
                                                   apply_dct):
    cfg = FeatureConfig(**LOGMEL80, append_energy=True)
    x = torch.from_numpy((rng.standard_normal((2, 4000)) * 0.3)
                         .astype(np.float32))
    before = report.launches()
    got = getattr(module, fn)(x, cfg, apply_dct=apply_dct)
    want = module.plain_features(x, cfg, apply_dct)
    assert torch.equal(got, want) and report.launches() == before
    assert got.shape == (2, 23, 80)
    if not apply_dct:     # no energy column in log-mel output
        assert torch.equal(got, module.plain_features(x, cfg.replace(
            append_energy=False), False))
    empty = getattr(module, fn)(x[:, :399], cfg, apply_dct=apply_dct)
    assert tuple(empty.shape) == (2, 0, 80)
    with pytest.raises(ValueError, match="center"):
        getattr(module, fn)(x, cfg.replace(frame_mode="center"))


def test_dit_wrapper_rejects_what_the_algorithm_cannot_take():
    with pytest.raises(ValueError, match="n_fft % 4"):
        fused_dit.fused_features_dit(torch.zeros((1, 4000)),
                                     FeatureConfig(n_fft=514))


def test_accurate_log_wrapper_on_cpu_is_xmath():
    from mfcc_tpu_torch.ops import xmath
    x = torch.tensor([1e-10, 0.5, 1.0, 3.0, 1e30], dtype=torch.float32)
    assert torch.equal(fused_mfcc.acc_log(x), xmath.accurate_log(x))


# ---------------------------------------------------------------------------
# the FFT tile of fused_raw_dit.cu and fused_mfcc.cu (csrc/fft_tile.cuh):
# its constants, its shape rule and a numpy emulation of its data flow
# ---------------------------------------------------------------------------

def _fft_grid_config(n_fft: int, **kw) -> FeatureConfig:
    """25 ms frames at hop 10 ms at the rate that gives n_fft the default
    config's bin spacing (2 kHz at 64 points ... 128 kHz at 4096)."""
    n_mels = min(26, n_fft // 8)
    return FeatureConfig(sample_rate=n_fft * 125 // 4, n_fft=n_fft,
                         n_mels=n_mels, n_mfcc=min(13, n_mels),
                         **kw).validate()


@pytest.mark.parametrize("tile", ["fft", "fft64"])
@pytest.mark.parametrize("kw", [dict(), TINY, HI_RATE, TTS,
                                dict(window="povey", n_fft=1024),
                                dict(sample_rate=8000, n_fft=256)])
def test_fft_constants_layout(kw, tile):
    """The window and the twiddles are the float64 builders, rounded to
    float32 for the f32 tile and kept in float64 for the fft64 tile; the
    chunks tile each band's nonzero range of the direct tile's mel matrix
    in order, with its weights; the DCT is the direct tile's."""
    cfg = FeatureConfig(**kw).validate()
    win, tw, chunk_w, chunks, band_chunks, dctm = _spectral.fft_matrices(
        cfg, tile)
    cos_m, _ = jax_spectrum.dft_matrices(JaxConfig(**kw))
    wt = np.float32 if tile == "fft" else np.float64
    assert win.dtype == tw.dtype == wt and chunk_w.dtype == np.float32
    assert chunks.dtype == band_chunks.dtype == np.int32
    np.testing.assert_array_equal(win.astype(np.float32),
                                  cos_m[:, 0].astype(np.float32))
    np.testing.assert_array_equal(
        win, jax_oracle.window_fn(cfg.window, cfg.frame_len).astype(wt))
    ang = 2.0 * np.pi * np.arange(cfg.n_fft) / cfg.n_fft
    assert tw.shape == (cfg.n_fft, 2)
    np.testing.assert_array_equal(tw[:, 0], np.cos(ang).astype(wt))
    np.testing.assert_array_equal(tw[:, 1], np.sin(ang).astype(wt))
    _, _, dmel, ddct = fused_raw._matrices(cfg)
    np.testing.assert_array_equal(dctm, ddct)
    assert chunk_w.shape == (chunks.shape[0], _spectral.MEL_CHUNK)
    bands = _spectral.mel_bands(dmel)
    for j, (c0, c1) in enumerate(band_chunks):
        ch = chunks[c0:c1]
        assert (ch[:, 1] - ch[:, 0] <= _spectral.MEL_CHUNK).all()
        covered = np.concatenate([np.arange(a, b) for a, b in ch]
                                 ) if c1 > c0 else np.zeros(0, int)
        np.testing.assert_array_equal(covered, np.arange(*bands[j]))
        for c, (k0, k1) in zip(range(c0, c1), ch):
            np.testing.assert_array_equal(chunk_w[c, : k1 - k0],
                                          dmel[k0:k1, j])
            assert not chunk_w[c, k1 - k0:].any()
    assert band_chunks[-1, 1] == chunks.shape[0]
    assert chunks.shape[0] <= cfg.n_fft + cfg.n_fft // 32   # fits a buffer


@pytest.mark.parametrize("cfg", [FeatureConfig(), FeatureConfig(**LOGMEL80),
                                 FeatureConfig(**HI_RATE),
                                 FeatureConfig(**TINY), _fft_grid_config(64),
                                 _fft_grid_config(4096)])
def test_fft_mel_bands_cover_every_nonzero(cfg):
    """Band j's range [lo, hi) holds every nonzero of mel column j and
    starts and ends on one, so the sparse sum skips only exact zeros."""
    melw = fused_raw._matrices(cfg)[2]
    bands = _spectral.mel_bands(melw)
    assert bands.shape == (cfg.n_mels, 2)
    rows = np.arange(melw.shape[0])[:, None]
    inside = (rows >= bands[:, 0]) & (rows < bands[:, 1])
    assert not melw[~inside].any()
    for j, (lo, hi) in enumerate(bands):
        assert (lo, hi) == (0, 0) or (melw[lo, j] and melw[hi - 1, j])


# a hop whose 8-frame span overflows a block's shared memory
HUGE_HOP = dict(sample_rate=16000, frame_ms=256.0, hop_ms=2000.0, n_fft=4096)


@pytest.mark.parametrize("kw,apply_dct,tile", [
    (dict(), True, "fft"), (HI_RATE, True, "fft"), (TTS, True, "fft"),
    (TINY, True, "fft"), (dict(n_fft=4096), True, "fft"),
    (dict(sample_rate=2000, n_fft=64), True, "fft"),
    (dict(LOGMEL80, dynamic_range_db=50.0), False, "fft"),
    (dict(HI_RATE, dynamic_range_db=40.0), False, "fft"),
    (dict(n_fft=8192), True, "direct"),        # past the tile's 4096
    (dict(n_fft=401), True, "direct"),         # odd
    (dict(n_fft=768), True, "direct"),         # no power of two
    (dict(sample_rate=4000, frame_ms=25, n_fft=100), True, "direct"),
    (LOGMEL80, False, "fft64"),                # unbounded log-mel
    (dict(HI_RATE, dynamic_range_db=50.5), False, "fft64"),
    (dict(TTS, n_mfcc=80), False, "fft64"),
    (dict(sample_rate=2000, n_fft=64), False, "fft64"),
    (dict(LOGMEL80, n_fft=4096), False, "fft64"),
    (dict(LOGMEL80, n_fft=401), False, "direct"),
    (dict(LOGMEL80, n_fft=8192), False, "direct"),
    (HUGE_HOP, True, "direct"),                # shared memory
    (HUGE_HOP, False, "direct"),
])
def test_fft_tile_rule(kw, apply_dct, tile):
    """The config picks the tile: at a power-of-two n_fft from 64 to 4096
    whose 8-frame tile fits a block's shared memory, the f32 FFT tile for
    cepstra and log-mel bounded to <= 50 dB (the route's use_dit rule) and
    the float64-front tile for other log-mel; every other config keeps the
    entry's other tile."""
    cfg = FeatureConfig(**kw).validate()
    assert _spectral.fft_tile(cfg, apply_dct) == tile
    if tile != "direct":
        assert (tile == "fft") == routes.use_dit(cfg, apply_dct)
        assert _spectral.fft_smem_bytes(cfg, tile, 8) <= _spectral.MAX_SMEM


@pytest.mark.parametrize("kw,apply_dct,projection,tile", [
    (dict(LOGMEL80, frame_ms=25.0, n_fft=400), False, "mel", "fft64_mixed"),
    (dict(LOGMEL80, n_fft=800), False, "mel", "fft64_mixed"),
    (dict(LOGMEL80, sample_rate=4000, n_fft=100), False, "mel",
     "fft64_mixed"),
    (dict(LOGMEL80, sample_rate=8000, n_fft=2000), False, "bark",
     "fft64_mixed"),
    (dict(n_fft=400), True, "mel", "direct"),        # the f32 flavour
    (dict(LOGMEL80, dynamic_range_db=50.0, n_fft=400), False, "mel",
     "direct"),
    (dict(LOGMEL80, n_fft=400), False, "spec", "direct"),
    (dict(LOGMEL80, n_fft=768), False, "mel", "direct"),   # a factor 3
    (dict(LOGMEL80, n_fft=401), False, "mel", "direct"),
    (dict(LOGMEL80, n_fft=5000), False, "mel", "direct"),  # past 4096
    (LOGMEL80, False, "mel", "fft64"),                     # power of two
])
def test_mixed_tile_rule(kw, apply_dct, projection, tile):
    """In the entry that has it, the mixed-radix tile takes the float64
    flavour's configs at an n_fft of 2^a 5^b from 64 to 4096 (band
    projections); everywhere else the rule is as before, and an entry
    without it keeps its other tile there."""
    cfg = FeatureConfig(**kw).validate()
    assert _spectral.fft_tile(cfg, apply_dct, projection, mixed=True) == tile
    without = _spectral.fft_tile(cfg, apply_dct, projection)
    assert without == ("direct" if tile == "fft64_mixed" else tile)


@pytest.mark.parametrize("kw,tile,tm,want", [
    # the flavours' frame tiles at the main paths (spectral::launch_fft
    # picks the largest within 55 KB for fft, 74 KB for fft64)
    (dict(), "fft", 16, 46784), (dict(), "fft", 32, 58816),
    (LOGMEL80, "fft64", 32, 66756), (LOGMEL80, "fft64", 64, 97732),
    (dict(TTS, n_mfcc=80), "fft64", 16, 59524),
    (dict(TTS, n_mfcc=80), "fft64", 32, 81156),
    # pairs 1 (a 4096-point FFT is past the 1024-point wave), span 1520
    (dict(n_fft=4096), "fft64", 8, 4 * 8 * (4096 + 256)
     + 4 * (1520 + 1 + 8 * 26 + 16)),
    # the mixed tile at Whisper's 400 points, 128 mels: four FFTs of its
    # 2048-point wave, TM 16 within 74 KB (TM 32: 92,484)
    (dict(n_fft=400, n_mels=128, n_mfcc=128), "fft64_mixed", 16, 73924),
    # 1000 points: 2 would fit the wave, and are taken; 320: 6 would, 4
    # (a power of two) are taken
    (dict(n_fft=1000, n_mels=128, n_mfcc=128), "fft64_mixed", 8,
     4 * 8 * 2 * (1000 + 62) + 4 * (7 * 160 + 400 + 1 + 8 * 128 + 16)),
    (dict(sample_rate=12800, n_fft=320), "fft64_mixed", 16,
     4 * 8 * 4 * (320 + 20) + 4 * (15 * 128 + 320 + 1 + 16 * 26 + 32)),
])
def test_fft_smem_bytes(kw, tile, tm, want):
    """The host's mirror of spectral::fft_smem_bytes: four exchange planes
    of pairs x (n_fft + pad) elements (4 or 8 bytes; a pad per 32 or 16),
    then floats: the span (with the fft64 tile's lead sample), the mel
    energies and two per-frame vectors."""
    assert _spectral.fft_smem_bytes(FeatureConfig(**kw).validate(), tile,
                                    tm) == want


@pytest.mark.parametrize("kw,tile,tm", [
    (dict(), "fft", 16), (LOGMEL80, "fft64", 32),
    (dict(TTS, n_mfcc=80), "fft64", 16), (dict(n_fft=4096), "fft64", 8),
    (dict(n_fft=400, n_mels=128, n_mfcc=128), "fft64_mixed", 16),
    (dict(n_fft=1000, n_mels=128, n_mfcc=128), "fft64_mixed", 8),
])
def test_fft_frame_tile(kw, tile, tm):
    """The host's twin of spectral::launch_fft's frame tile: the largest
    whose shared memory meets the flavour's target (55 KB for four blocks
    an SM, 74 KB for three), else 8 (the rows of test_fft_smem_bytes)."""
    assert _spectral.fft_frame_tile(FeatureConfig(**kw).validate(),
                                    tile) == tm


# cos and sin of 2 pi / 5 and 4 pi / 5 as fft_tile.cuh rounds them
COS5 = (float.fromhex("0x1.3c6ef372fe950p-2"),
        float.fromhex("-0x1.9e3779b97f4a8p-1"))
SIN5 = (float.fromhex("0x1.e6f0e134454ffp-1"),
        float.fromhex("0x1.2cf2304755a5ep-1"))


def _dft_small(vr, vi, R, h):
    """The kernel's 2-, 4-, 5- and 8-point DFTs (fft_tile.cuh), lists of
    arrays in natural order; the 5-point DFT's constants in h's type."""
    def dft4(r, i):
        t0r, t0i, t1r, t1i = r[0] + r[2], i[0] + i[2], r[0] - r[2], i[0] - i[2]
        t2r, t2i, t3r, t3i = r[1] + r[3], i[1] + i[3], r[1] - r[3], i[1] - i[3]
        return ([t0r + t2r, t1r + t3i, t0r - t2r, t1r - t3i],
                [t0i + t2i, t1i - t3r, t0i - t2i, t1i + t3r])
    if R == 2:
        return [vr[0] + vr[1], vr[0] - vr[1]], [vi[0] + vi[1], vi[0] - vi[1]]
    if R == 4:
        return dft4(vr, vi)
    if R == 5:
        t = type(h)
        c1, c2, s1, s2 = t(COS5[0]), t(COS5[1]), t(SIN5[0]), t(SIN5[1])
        a1r, a1i, b1r, b1i = (vr[1] + vr[4], vi[1] + vi[4], vr[1] - vr[4],
                              vi[1] - vi[4])
        a2r, a2i, b2r, b2i = (vr[2] + vr[3], vi[2] + vi[3], vr[2] - vr[3],
                              vi[2] - vi[3])
        m1r, m1i = vr[0] + c1 * a1r + c2 * a2r, vi[0] + c1 * a1i + c2 * a2i
        m2r, m2i = vr[0] + c2 * a1r + c1 * a2r, vi[0] + c2 * a1i + c1 * a2i
        t1r, t1i = s1 * b1r + s2 * b2r, s1 * b1i + s2 * b2i
        t2r, t2i = s2 * b1r - s1 * b2r, s2 * b1i - s1 * b2i
        return ([vr[0] + a1r + a2r, m1r + t1i, m2r + t2i, m2r - t2i,
                 m1r - t1i],
                [vi[0] + a1i + a2i, m1i - t1r, m2i - t2r, m2i + t2r,
                 m1i + t1r])
    er, ei = dft4(vr[0::2], vi[0::2])
    o_r, oi = dft4(vr[1::2], vi[1::2])
    o_r, oi = ([o_r[0], h * (o_r[1] + oi[1]), oi[2], h * (oi[3] - o_r[3])],
               [oi[0], h * (oi[1] - o_r[1]), -o_r[2], -h * (o_r[3] + oi[3])])
    return ([er[q] + o_r[q] for q in range(4)] + [er[q] - o_r[q] for q in range(4)],
            [ei[q] + oi[q] for q in range(4)] + [ei[q] - oi[q] for q in range(4)])


def _fft_pass(sr, si, tw, n, ns, R, h):
    """One Stockham radix-R pass of the kernel over (pairs, n) arrays, ns
    the length of the sub-transforms done: butterfly j reads points j + r
    n/R, twiddles point r by table entry k r n/(ns R) (k = j mod ns), and
    writes point q to (j-k) R + k + q ns."""
    nq = n // R
    j = np.arange(nq)
    k = j % ns
    vr = [sr[:, j + r * nq] for r in range(R)]
    vi = [si[:, j + r * nq] for r in range(R)]
    for r in range(1, R):
        m = k * r * (n // (ns * R))
        c, s = tw[m, 0], tw[m, 1]
        vr[r], vi[r] = vr[r] * c + vi[r] * s, vi[r] * c - vr[r] * s
    vr, vi = _dft_small(vr, vi, R, h)
    dr, di = np.empty_like(sr), np.empty_like(si)
    base = (j - k) * R + k
    for q in range(R):
        dr[:, base + q * ns], di[:, base + q * ns] = vr[q], vi[q]
    return dr, di


def _fft_power(re, im, tw, n, h, f):
    """The tile's FFT of the (pairs, n) windowed inputs re + i im (frames 2q
    and 2q+1 of a pair): the radix passes in the kernel's order
    (``_spectral.fft_radices``) with the table's twiddles, then the split
    into both frames' |X|^2 at bins 0..n/2 (bin k's partner n - k, bin 0's
    itself), rounded to f -> (2 pairs, n/2 + 1)."""
    ns = 1
    for R in _spectral.fft_radices(n):
        re, im = _fft_pass(re, im, tw, n, ns, R, h)
        ns *= R
    half = type(h)(0.5)
    k = np.arange(n // 2 + 1)
    k2 = np.where(k == 0, 0, n - k)
    a, bi, c, d = re[:, k], im[:, k], re[:, k2], im[:, k2]
    xr, xi = half * (a + c), half * (bi - d)
    yr, yi = half * (bi + d), half * (c - a)
    power = np.empty((2 * re.shape[0], n // 2 + 1), f)
    power[0::2], power[1::2] = xr * xr + xi * xi, yr * yr + yi * yi
    return power


def _emulate_fft_tile(x: np.ndarray, cfg: FeatureConfig, apply_dct: bool,
                      tm: int = 32, dtype=np.float64, front=None,
                      projection: str = "mel", tables=None):
    """The FFT tile's data flow in numpy, in ``dtype``: per (row, tile of
    tm frames) the span is staged and pre-emphasized with each sample's
    true predecessor (cfg.preemph 0: audio the host pre-emphasized),
    frames 2q and 2q+1 go windowed into the real and imaginary parts of one
    n_fft-point input, the radix passes run in the kernel's order (radix 8,
    then radix 2 or 4 where log2 n_fft % 3 != 0) with the table's
    twiddles, the split gives both frames' |X|^2 at bins 0..n_fft/2, each
    mel chunk sums its bins in ascending order and each band its chunks in
    order, then floors, log, DCT and the energy column.

    ``front`` (default ``dtype``) is the type of everything up to |X|^2
    and the frame energy, which are then rounded to ``dtype``: float64
    with dtype float32 is the float64-front tile ("fft64": the float64
    window and twiddle tables of ``fft_matrices(cfg, "fft64")``, float32
    mel, floors and accurate log).

    ``projection`` "bark" sums the chunks of the bark matrix with no
    relative floor (PLP's log band energies); "spec" floors and logs each
    bin's |X|^2 (n_bins columns).  ``tables`` (default: the config's
    ``_spectral.fft_matrices``) are the tile's constants, e.g. a front
    end's (``_spectral.fft_tables``)."""
    f, g = dtype, front or dtype
    win, tw, chunk_w, chunks, band_chunks, dctm = tables or \
        _spectral.fft_matrices(
            cfg, "fft64" if g is np.float64 and f is np.float32 else "fft",
            projection)
    win, tw = win.astype(g), tw.astype(g)
    if projection != "spec":
        chunk_w = chunk_w.astype(f)
    if dctm is not None:
        dctm = dctm.astype(f)
    B, N = x.shape
    T, hop, fl, n = cfg.num_frames(N), cfg.hop_len, cfg.frame_len, cfg.n_fft
    h = g(np.sqrt(0.5) if g is np.float64 and f is np.float32
          else np.float32(np.sqrt(0.5)))
    rel = mel.relative_floor(cfg) if projection == "mel" else 0.0
    log = (np.log if f is np.float64 else
           lambda v: xmath.accurate_log(torch.from_numpy(v)).numpy())
    out = np.zeros((B, T, _spectral.n_out(cfg, apply_dct, projection)), f)
    for b in range(B):
        xb = x[b].astype(g)
        for t0 in range(0, T, tm):
            i = t0 * hop + np.arange((tm - 1) * hop + fl)
            cur = np.where(i < N, xb[np.minimum(i, N - 1)], g(0))
            prev = np.where(i > 0, xb[np.clip(i - 1, 0, N - 1)], xb[0])
            z = np.where(i < N, cur - g(cfg.preemph) * prev, g(0)).astype(g)
            fr = np.stack([z[m * hop: m * hop + fl] for m in range(tm)])
            zin = np.zeros((tm, n), g)
            zin[:, :fl] = win * fr
            power = _fft_power(zin[0::2], zin[1::2], tw, n, h, f)
            m = min(tm, T - t0)
            if projection == "spec":
                out[b, t0: t0 + m] = log(np.maximum(
                    power, f(cfg.log_floor)).astype(f))[:m]
                continue
            energy = (fr * fr).sum(axis=1).astype(f)
            part = np.zeros((tm, chunks.shape[0]), f)
            for c, (k0, k1) in enumerate(chunks):
                for i in range(k1 - k0):
                    part[:, c] += power[:, k0 + i] * chunk_w[c, i]
            e = np.zeros((tm, band_chunks.shape[0]), f)
            for j, (c0, c1) in enumerate(band_chunks):
                for c in range(c0, c1):
                    e[:, j] += part[:, c]
            floor = np.maximum(f(cfg.log_floor),
                               f(rel) * e.max(axis=1, keepdims=True))
            feat = log(np.maximum(e, floor).astype(f))
            if apply_dct:
                feat = feat @ dctm
                if cfg.append_energy:
                    feat[:, 0] = log(np.maximum(energy, f(cfg.log_floor)))
            out[b, t0: t0 + m] = feat[:m]
    return out


@pytest.mark.parametrize("kw,raw,apply_dct,N,tm", [
    # n_fft 128: the tiny raw-DIT config, T=61 over tiles of 16
    (TINY, True, True, 2000, 16),
    (dict(TINY, dynamic_range_db=50.0), True, False, 2000, 16),
    # n_fft 512: the main path's config, T=48 over tiles of 32
    (dict(), True, True, 8000, 32),
    (dict(lifter=22, append_energy=True), True, True, 8000, 32),
    (dict(LOGMEL80, dynamic_range_db=50.0), True, False, 8000, 32),
    # n_fft 2048: 44.1 kHz, odd hop 441, host pre-emphasis, T=48 over 16s
    (HI_RATE, False, True, 22050, 16),
    (dict(HI_RATE, **LOGMEL80), False, False, 22050, 16),
])
def test_fft_tile_emulation_matches_pallas_and_plain(rng, kw, raw, apply_dct,
                                                      N, tm):
    """The FFT tile's data flow against the Pallas kernel it replaces
    (interpret mode: fused_raw_dit on raw audio, fused_mfcc on audio the
    host pre-emphasized) and against the plain version, with tiles that
    frames straddle (a zero pre-emphasis predecessor at a tile edge would
    show as ~1e-3)."""
    jc = JaxConfig(**kw).validate()
    cfg = from_jax(jc)
    x = (rng.standard_normal((2, N)) * 0.3).astype(np.float32)
    if raw:
        want = np.asarray(jax_kernel.fused_features_raw_dit(
            jnp.asarray(x), jc, merged=True, apply_dct=apply_dct,
            interpret=True))
        plain = fused_raw_dit.plain_features(torch.from_numpy(x), cfg,
                                             apply_dct).numpy()
        got = _emulate_fft_tile(x, cfg, apply_dct, tm)
    else:
        y = _preemphasized(x, jc)
        want = np.asarray(jax_direct.fused_features(
            jnp.asarray(y), jc, apply_dct=apply_dct, interpret=True))
        plain = fused_mfcc.plain_features(torch.from_numpy(y), cfg,
                                          apply_dct).numpy()
        got = _emulate_fft_tile(y, cfg.replace(preemph=0.0), apply_dct, tm)
    _assert_features(got, want, jc, apply_dct)
    _assert_features(got, plain, jc, apply_dct)


@pytest.mark.parametrize("n_fft", [64, 256, 1024, 4096])
def test_fft_tile_emulation_over_the_n_fft_grid(rng, n_fft):
    """Every pass schedule (radix 2, 4 or none after the radix-8 passes)
    against the plain version, with an odd frame count (the last frame's
    partner lies past the row) and an all-zero tail."""
    cfg = _fft_grid_config(n_fft, append_energy=True)
    N = 12 * cfg.hop_len + cfg.frame_len            # T = 13
    x = (rng.standard_normal((2, N)) * 0.3).astype(np.float32)
    want = fused_raw_dit.plain_features(torch.from_numpy(x), cfg).numpy()
    got = _emulate_fft_tile(x, cfg, True, tm=8)
    _assert_features(got, want, cfg, True)


def _two_tones(sr: int) -> np.ndarray:
    """1 s of the two-tone valley signal of tests/test_accuracy_floor.py."""
    t = np.arange(sr) / sr
    return (0.5 * np.sin(2 * np.pi * 180.0 * t)
            + 0.3 * np.sin(2 * np.pi * 1200.0 * t)).astype(np.float32)


def _fft64_valley_errors(kw):
    """Unbounded log-mel of the two-tone signal against the float64 oracle
    of the raw audio: -> (the fft64 tile on raw audio, the fft64 tile on
    audio the host pre-emphasized in f32 (the fused_dit route), the direct
    form (the port's plain f32 version), the DIT form)."""
    cfg = FeatureConfig(**kw).validate()
    x = _two_tones(cfg.sample_rate)[None]
    y = framing.preemphasize(torch.from_numpy(x), cfg).numpy()
    want = jax_oracle.log_mel(x[0].astype(np.float64), JaxConfig(**kw))
    raw64 = _emulate_fft_tile(x, cfg, False, dtype=np.float32,
                              front=np.float64)[0]
    host64 = _emulate_fft_tile(y, cfg.replace(preemph=0.0), False,
                               dtype=np.float32, front=np.float64)[0]
    direct = fused_raw.plain_features(torch.from_numpy(x), cfg,
                                      False)[0].numpy()
    dit = fused_dit.plain_features(torch.from_numpy(y), cfg, False)[0].numpy()
    return tuple(float(np.abs(a - want).max())
                 for a in (raw64, host64, direct, dit))


@pytest.mark.parametrize("kw,apply_dct", [
    (dict(), True), (dict(hop_ms=12.5, lifter=22, append_energy=True), True),
    (dict(sample_rate=8000, n_fft=256), True),
    (dict(sample_rate=48000, n_fft=2048), True),
    (dict(TTS, n_mels=26), True),
    (dict(TTS, n_mfcc=80, dynamic_range_db=50.0), False),
])
def test_fft_tile_emulation_matches_dit_plain(rng, kw, apply_dct):
    """fused_dit on its f32 FFT tile (cepstra, log-mel <= 50 dB) against
    its plain version, the DIT form, on audio the host pre-emphasized."""
    cfg = FeatureConfig(**kw).validate()
    assert _spectral.fft_tile(cfg, apply_dct) == "fft"
    N = 12 * cfg.hop_len + cfg.frame_len
    y = _preemphasized((rng.standard_normal((2, N)) * 0.3)
                       .astype(np.float32), cfg)
    want = fused_dit.plain_features(torch.from_numpy(y), cfg,
                                    apply_dct).numpy()
    got = _emulate_fft_tile(y, cfg.replace(preemph=0.0), apply_dct, tm=8,
                            dtype=np.float32)
    _assert_features(got, want, cfg, apply_dct)


@pytest.mark.parametrize("window,ratio", [("hamming", 1.0), ("hann", 4.0),
                                           ("povey", 8.0)])
def test_fft_tile_valley_error_against_direct(window, ratio):
    """Unbounded 80-mel log-mel on the two-tone valley signal of
    tests/test_accuracy_floor.py against the float64 oracle.  Every stage
    in float32: with the configs' Hamming window (valleys ~60 dB deep) the
    f32 FFT tile is no less accurate than the direct form (the port's plain
    f32 version, the direct tile's arithmetic); with Hann or Povey windows
    the valleys reach ~120-140 dB and both forms sit at the f32 floor
    (> 1e-3), the FFT 2.7x and 5.9x above the direct form as measured.  So
    unbounded log-mel takes the float64-front tile ("fft64"), which on raw
    audio stays within 1e-5 of the oracle in all three, and on audio the
    host pre-emphasized in f32 is no worse than the direct or DIT form."""
    kw = dict(n_mels=80, n_mfcc=80, window=window)
    cfg = FeatureConfig(**kw).validate()
    x = _two_tones(16000)
    want = jax_oracle.log_mel(x.astype(np.float64), JaxConfig(**kw))
    got = _emulate_fft_tile(x[None], cfg, False, dtype=np.float32)[0]
    direct = fused_raw.plain_features(torch.from_numpy(x[None]), cfg,
                                      False)[0].numpy()
    err_fft = np.abs(got - want).max()
    err_direct = np.abs(direct - want).max()
    assert err_fft <= ratio * err_direct, (err_fft, err_direct)
    if window != "hamming":
        assert min(err_fft, err_direct) > 1e-3       # the f32 valley floor
    assert _spectral.fft_tile(cfg, False) == "fft64"
    raw64, host64, err_direct, err_dit = _fft64_valley_errors(kw)
    assert raw64 <= 1e-5, raw64
    assert host64 <= min(err_direct, err_dit), (host64, err_direct, err_dit)


@pytest.mark.parametrize("window", ["hamming", "hann", "povey"])
def test_fft64_valley_error_at_the_tts_geometry(window):
    """The same at the 22.05 kHz TTS geometry (1024-sample frames, hop
    256), the fused_dit route's main path: within 1e-5 of the oracle on raw
    audio; on audio the host pre-emphasized, no worse than the direct form
    or the DIT form the route ran before."""
    kw = dict(TTS, n_mfcc=80, window=window)
    assert _spectral.fft_tile(FeatureConfig(**kw).validate(), False) == \
        "fft64"
    raw64, host64, err_direct, err_dit = _fft64_valley_errors(kw)
    assert raw64 <= 1e-5, raw64
    assert host64 <= min(err_direct, err_dit), (host64, err_direct, err_dit)


@pytest.mark.parametrize("kw,raw,N", [
    (LOGMEL80, True, 8000),                                 # fused_raw
    (dict(LOGMEL80, sample_rate=8000, n_fft=256), True, 4000),
    (dict(TTS, n_mfcc=80), False, 11025),                   # fused_dit
    (dict(TTS, n_mels=40, n_mfcc=40, window="hann"), False, 11025),
])
def test_fft64_emulation_matches_pallas(rng, kw, raw, N):
    """The float64-front tile against the Pallas kernel its route replaces,
    in interpret mode, on noise (where that kernel sits within its oracle
    bound): fused_features_raw on raw audio, fused_features_dit on audio
    the host pre-emphasized; log-mel within rtol 1e-4 plus atol 2e-5, and
    the tile within 1e-5 of the oracle fed its own input."""
    jc = JaxConfig(**kw).validate()
    cfg = from_jax(jc)
    x = (rng.standard_normal((2, N)) * 0.3).astype(np.float32)
    if raw:
        want = np.asarray(jax_raw.fused_features_raw(
            jnp.asarray(x), jc, apply_dct=False, interpret=True))
        inp, c = x, cfg
    else:
        inp, c = _preemphasized(x, jc), cfg.replace(preemph=0.0)
        want = np.asarray(jax_dit.fused_features_dit(
            jnp.asarray(inp), jc, apply_dct=False, interpret=True))
    got = _emulate_fft_tile(inp, c, False, tm=16, dtype=np.float32,
                            front=np.float64)
    _assert_features(got, want, jc, False)
    for i in range(2):
        ref = jax_oracle.log_mel(inp[i].astype(np.float64),
                                 jc.replace(preemph=0.0) if not raw else jc)
        assert np.abs(got[i] - ref).max() <= 1e-5


@pytest.mark.parametrize("module", [fused_raw_dit, fused_raw, fused_mfcc,
                                    fused_dit])
@pytest.mark.parametrize("cfg", [FeatureConfig(**LOGMEL80),
                                 FeatureConfig(**TTS).replace(n_mfcc=80),
                                 _fft_grid_config(64),
                                 _fft_grid_config(4096)])
def test_fft64_emulation_matches_plain(rng, module, cfg):
    """Each spectral kernel's fft64 tile against its plain version (the
    direct form; the DIT form for fused_dit) on noise, at the log-mel bound
    the card holds them to, over an odd frame count (T = 13)."""
    N = 12 * cfg.hop_len + cfg.frame_len
    x = (rng.standard_normal((2, N)) * 0.3).astype(np.float32)
    raw = module in (fused_raw_dit, fused_raw)
    inp = x if raw else _preemphasized(x, cfg)
    c = cfg if raw else cfg.replace(preemph=0.0)
    want = module.plain_features(torch.from_numpy(inp), cfg, False).numpy()
    got = _emulate_fft_tile(inp, c, False, tm=8, dtype=np.float32,
                            front=np.float64)
    _assert_features(got, want, cfg, False)


# n_fft = 2^a 5^b: Whisper's 400 and its neighbours
MIXED_N = [80, 200, 320, 400, 640, 800, 1000, 1600, 2000]


@pytest.mark.parametrize("n", MIXED_N)
def test_mixed_fft_twin_matches_rfft(rng, n):
    """The mixed-radix tile's data flow (radix-5 passes beside radix 2/4,
    the split's partner n - k) in float64 against numpy's real FFT, for
    two frames a complex FFT, one of them with a zero tail."""
    radices = _spectral.fft_radices(n)
    assert 5 in radices and int(np.prod(radices)) == n
    fr = rng.standard_normal((4, n))
    fr[3, n // 3:] = 0.0
    ang = 2.0 * np.pi * np.arange(n) / n
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    got = _fft_power(fr[0::2], fr[1::2], tw, n, np.sqrt(0.5), np.float64)
    want = np.abs(np.fft.rfft(fr, axis=1)) ** 2
    assert np.abs(got - want).max() <= 1e-12 * want.max()


def _mixed_planner(tmp_path):
    """spectral::mixed_plan, from csrc/fft_tile.cuh's text, built for the
    host with g++: n -> the radices of its passes, or None where refused."""
    import re
    import shutil
    import subprocess
    from mfcc_tpu_torch.ops.kernels import _build
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a C++ compiler (the port's native WAV decoder needs one)"
    src = (_build.CSRC / "fft_tile.cuh").read_text()
    head = "__host__ __device__ constexpr int log2_radix(int R) {"
    plan = src[src.index(head):src.index("\n}\n", src.index(
        "inline bool mixed_plan(")) + 3]
    cap = re.search(r"constexpr int kMixedMaxPasses = \d+;", src).group(0)
    prog = ("#include <cstdio>\n#include <cstdlib>\n#define __host__\n"
            "#define __device__\n" + cap + "\nstruct FftMixedParams { int n, "
            "passes; int radix[kMixedMaxPasses]; };\n" + plan +
            "int main(int argc, char** argv) {\n  for (int i = 1; i < argc; "
            "++i) {\n    FftMixedParams q{};\n    if (!mixed_plan(atoi(argv[i]"
            "), q)) { printf(\"-\\n\"); continue; }\n    for (int s = 0; s < "
            "q.passes; ++s) printf(\"%d \", q.radix[s]);\n    printf(\"\\n\");"
            "\n  }\n}\n")
    (tmp_path / "plan.cpp").write_text(prog)
    subprocess.run([cxx, "-std=c++17", "-o", str(tmp_path / "plan"),
                    str(tmp_path / "plan.cpp")], check=True)

    def run(ns):
        out = subprocess.run([str(tmp_path / "plan"), *map(str, ns)],
                             check=True, capture_output=True, text=True)
        return [None if ln.strip() == "-" else list(map(int, ln.split()))
                for ln in out.stdout.splitlines()]
    return run


def test_mixed_plan_is_the_kernels(tmp_path):
    """``_spectral.fft_radices`` mirrors the C planner ``mixed_plan`` on
    every n = 2^a 5^b (b >= 1) of the tile's range, and both refuse a
    power of two, a factor 3 (768) and an odd prime (401)."""
    ns = sorted({2 ** a * 5 ** b for a in range(13) for b in range(1, 6)
                 if _spectral.FFT_MIN <= 2 ** a * 5 ** b <= _spectral.FFT_MAX})
    got = _mixed_planner(tmp_path)(ns + [512, 768, 401])
    assert got[:len(ns)] == [_spectral.fft_radices(n) for n in ns]
    assert got[len(ns):] == [None] * 3
    assert _spectral.fft_radices(400) == [4, 4, 5, 5]


def _speech_rows(B, seconds, seed):
    """B rows of the benchmark's speech-like int16 audio (``perfbench/
    corpus.py``, the libri traffic's signal) of seconds[i] each, padded."""
    import json
    from pathlib import Path
    from perfbench import corpus
    sig = json.loads((Path(corpus.__file__).parent / "traffic" /
                      "libri_sorted.json").read_text())["signal"]
    gen = torch.Generator().manual_seed(seed)
    n = torch.tensor([int(s * sig["sample_rate"]) for s in seconds])
    return corpus.synth(corpus._params(B, sig, gen, "cpu"), n,
                        int(n.max()), sig, gen), n


def test_mixed_tile_twin_at_whispers_geometry():
    """Whisper's front end (400 points, periodic Hann, 128 Hz-triangle
    mels, the 80 dB row floor) through the fft64 twin of the mixed tile,
    on the speech-like rows of the benchmark's traffic, against the
    float64 reference (``perfbench/reference/whisper.py``): within 2e-5
    (its float64 front through |X|^2; the direct tile's f32 sums read
    1.1-2.7e-4 on the card).  The f32 twin's figure is printed beside it:
    the flavour rule gives Whisper fft64 (an 80 dB floor is past the 50
    dB that ``routes.use_dit`` allows the f32 tile), whatever it reads."""
    import dataclasses
    from mfcc_tpu_torch.config import WhisperConfig
    from mfcc_tpu_torch.models import whisper
    from perfbench.reference import whisper as ref
    cfg = WhisperConfig(chunk_s=2.0).validate()
    kcfg = cfg.feature_config()
    assert _spectral.fft_tile(kcfg, False, mixed=True) == "fft64_mixed"
    x, n = _speech_rows(3, [2.0, 1.3, 0.6], seed=24)
    xp = framing.stft_center_batch(x.to(torch.float32) / 32768.0, n, cfg)
    want = ref.features(x, n.tolist(), dataclasses.asdict(cfg), False)[0]
    front = whisper.front(cfg)
    errs = {}
    for name, g in (("fft64", np.float64), ("f32", np.float32)):
        tables = _spectral.fft_tables(
            front.window, cfg.n_fft, front.bank, None,
            "fft64_mixed" if g is np.float64 else "fft")
        logs = _emulate_fft_tile(xp.numpy(), kcfg, False, dtype=np.float32,
                                 front=g, tables=tables)
        feat = whisper.normalize(torch.from_numpy(logs))
        assert feat.shape == want.shape
        errs[name] = float((feat.double() - want).abs().max())
    print(f"Whisper's geometry against the float64 reference: fft64 twin "
          f"{errs['fft64']:.3e}, f32 twin {errs['f32']:.3e}")
    assert errs["fft64"] <= 2e-5, errs


def test_fft_tile_ablation_edits_still_apply():
    """mfcc_tpu_torch/tools/ablate_fft_tile.py cuts stages out of the
    sources by exact text edits: each must still match once."""
    from mfcc_tpu_torch.tools import ablate_fft_tile
    for name in ablate_fft_tile.VARIANTS:
        files = ablate_fft_tile.variant_sources(name)
        assert set(files) >= {"fft_tile.cuh", "fused_raw_dit.cu",
                              "fused_mfcc.cu"}


# ---------------------------------------------------------------------------
# fused_raw_dit's bark and spec projections: constants and route against the
# reference's, the emulated FFT tile against the Pallas kernel, and the
# valley check that picks each projection's FFT flavour
# ---------------------------------------------------------------------------

def test_spec_kernel_eligible_matches_reference():
    grid = _config_grid()
    seen = set()
    for jc in grid:
        got = routes.spec_kernel_eligible(from_jax(jc))
        assert got == jax_kernel.spec_kernel_eligible(jc), jc
        seen.add(got)
    assert seen == {True, False}


@pytest.mark.parametrize("kw", [dict(), dict(n_fft=1024, n_bark=17),
                                dict(sample_rate=8000, n_fft=256),
                                dict(n_fft=768)])
def test_projection_constants_match_reference(kw):
    """The bark constants are the reference kernel's bark matrix in natural
    bin order (its packed mcat rows and its Nyquist row unpacked), as the
    direct tile takes it and as the FFT tile's chunks cut it; the spec
    projection has none, and natural order is the reference's packed
    output depermuted by spec_bin_permutation."""
    jc = JaxConfig(**kw).validate()
    cfg = from_jax(jc)
    H, Hh = jc.n_fft // 2, jc.n_fft // 4
    pad = -(-jc.n_bark // 128) * 128
    _, _, _, mcat, mny, _ = jax_kernel._matrices(jc, pad, pad, False, "bark")
    natural = np.zeros((jc.n_bins, pad), np.float32)
    natural[: Hh + 1] = mcat[: Hh + 1]
    for j in range(1, Hh):
        natural[H - j] = mcat[Hh + j]
    natural[H] = mny[0]
    bark = _spectral.direct_matrices(cfg, "bark")[2]
    np.testing.assert_array_equal(bark, natural[:, : jc.n_bark])
    assert bark.flags.c_contiguous and bark.dtype == np.float32
    for tile in ("fft", "fft64"):
        _, _, chunk_w, chunks, band_chunks, dctm = _spectral.fft_matrices(
            cfg, tile, "bark")
        assert dctm is None and band_chunks.shape == (jc.n_bark, 2)
        for j, (c0, c1) in enumerate(band_chunks):
            for c in range(c0, c1):
                k0, k1 = chunks[c]
                np.testing.assert_array_equal(chunk_w[c, : k1 - k0],
                                              bark[k0:k1, j])
        covered = sum(int(k1 - k0) for k0, k1 in chunks)
        assert covered == sum(int(hi - lo)
                              for lo, hi in _spectral.mel_bands(bark))
        assert _spectral.fft_matrices(cfg, tile, "spec")[2:] == (None,) * 4
    assert _spectral.direct_matrices(cfg, "spec")[2:] == (None, None)
    # lane L of the reference's packed spectrogram holds bin
    # packed_bin[L]; its wrapper's permutation puts bin b in column b
    packed_bin = np.concatenate([np.arange(Hh + 1), H - np.arange(1, Hh),
                                 [H]])
    perm = jax_kernel.spec_bin_permutation(jc)
    np.testing.assert_array_equal(packed_bin[perm], np.arange(jc.n_bins))


@pytest.mark.parametrize("projection,width", [("bark", 21), ("spec", 257)])
def test_projection_epilogue_and_widths(projection, width):
    """No relative floor, no energy column, no DCT; the width in n_mels and
    n_out; the spectrogram stages nothing per frame."""
    cfg = FeatureConfig(dynamic_range_db=50.0, append_energy=True,
                        lifter=22)
    assert _spectral.n_out(cfg, False, projection) == width
    assert _spectral.epilogue_args(cfg, False, projection) == (
        width, width, cfg.log_floor, 0.0, 0, 0)
    # apply_dct goes through, for the C entry to refuse
    assert _spectral.epilogue_args(cfg, True, projection)[-1] == 1
    assert _spectral.staged_width(cfg, projection) == \
        (0 if projection == "spec" else width)
    assert _spectral.staged_width(cfg) == cfg.n_mels


@pytest.mark.parametrize("kw,projection,tile", [
    (dict(), "bark", "fft64"), (dict(), "spec", "fft64"),
    (dict(dynamic_range_db=50.0), "bark", "fft64"),
    (dict(n_fft=1024), "spec", "fft64"), (dict(n_fft=4096), "spec", "fft64"),
    (dict(sample_rate=8000, n_fft=256), "bark", "fft64"),
    (dict(n_fft=768), "spec", "direct"), (dict(n_fft=401), "bark", "direct"),
    (dict(n_fft=8192), "spec", "direct"), (HUGE_HOP, "spec", "direct"),
])
def test_projection_tile_rule(kw, projection, tile):
    cfg = FeatureConfig(**kw).validate()
    assert _spectral.fft_tile(cfg, False, projection) == tile


@pytest.mark.parametrize("kw,tile,tm,projection,want", [
    # 16 kHz default: 8 x 2 x 544 doubles, span 5360 / 10480 + lead 1
    (dict(), "fft64", 32, "spec", 34816 + 4 * (5360 + 1 + 64)),
    (dict(), "fft64", 64, "spec", 34816 + 4 * (10480 + 1 + 128)),
    (dict(), "fft64", 32, "bark", 34816 + 4 * (5360 + 1 + 32 * 21 + 64)),
    (dict(), "fft", 32, "bark", 4 * 4 * 4 * 528 + 4 * (5360 + 32 * 21 + 64)),
])
def test_projection_smem_bytes(kw, tile, tm, projection, want):
    assert _spectral.fft_smem_bytes(FeatureConfig(**kw).validate(), tile, tm,
                                    projection) == want


def test_projection_wrapper_checks_and_cpu_path(rng):
    cfg = FeatureConfig()
    x = torch.from_numpy((rng.standard_normal((2, 4000)) * 0.3)
                         .astype(np.float32))
    for projection in ("bark", "spec"):
        with pytest.raises(ValueError, match="DCT"):
            fused_raw_dit.fused_features_raw_dit(x, cfg, projection=projection)
        before = report.launches()
        got = fused_raw_dit.fused_features_raw_dit(x, cfg, apply_dct=False,
                                                   projection=projection)
        assert torch.equal(got, fused_raw_dit.plain_features(x, cfg, False,
                                                             projection))
        assert report.launches() == before
        assert fused_raw_dit.fused_features_raw_dit(
            x[:, :399], cfg, apply_dct=False, projection=projection
        ).shape == (2, 0, _spectral.n_out(cfg, False, projection))
    with pytest.raises(ValueError, match="projection"):
        fused_raw_dit.fused_features_raw_dit(x, cfg, apply_dct=False,
                                             projection="cqt")


def _spec_window_err(got, want, db=50.0):
    keep = want > want.max(axis=-1, keepdims=True) - np.log(10.0 ** (db / 10))
    return float(np.abs(got - want)[keep].max())


@pytest.mark.parametrize("kw,projection,N", [
    (dict(), "bark", 8000), (dict(), "spec", 8000),
    (dict(n_fft=1024, window="hann"), "spec", 8000),
    (dict(sample_rate=8000, n_fft=256, n_bark=15), "bark", 4000),
    (dict(lifter=22, dynamic_range_db=50.0), "bark", 8000),
])
def test_projection_emulation_matches_pallas(rng, kw, projection, N):
    """The float64-front FFT tile's data flow in each projection against the
    Pallas kernel it replaces (fused_features_raw_dit in interpret mode,
    the spectrogram depermuted by its wrapper) and the plain version, on
    noise, over tiles of 16 frames that frames straddle: bark at the
    log-mel bound (rtol 1e-4 plus atol 2e-5), the spectrogram within 2e-4
    in the 50 dB window; and within 1e-5 of the float64 oracle over every
    band and bin."""
    jc = JaxConfig(**kw).validate()
    cfg = from_jax(jc)
    x = (rng.standard_normal((2, N)) * 0.3).astype(np.float32)
    want = np.asarray(jax_kernel.fused_features_raw_dit(
        jnp.asarray(x), jc, merged=True, apply_dct=False,
        projection=projection, interpret=True))
    plain = fused_raw_dit.plain_features(torch.from_numpy(x), cfg, False,
                                         projection).numpy()
    got = _emulate_fft_tile(x, cfg, False, tm=16, dtype=np.float32,
                            front=np.float64, projection=projection)
    assert got.shape == want.shape == plain.shape
    for ref in (want, plain):
        if projection == "bark":
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-5)
        else:
            assert _spec_window_err(got, ref) < 2e-4
    for i in range(2):
        ref = _oracle_projection(x[i], cfg, projection)
        assert np.abs(got[i] - ref).max() <= 1e-5


def _oracle_projection(x: np.ndarray, cfg, projection: str) -> np.ndarray:
    """The float64 oracle of fused_raw_dit's bark or spec output (the
    port's twins, held equal to the reference's in test_torch_plp.py)."""
    fn = oracle.log_bark if projection == "bark" else oracle.log_spectrogram
    return fn(x.astype(np.float64), cfg)


def _bench_like(sr: int = 16000) -> np.ndarray:
    """1 s of the bench.py signal: two tones plus noise, numpy seed 0."""
    t = np.arange(sr) / sr
    noise = np.random.default_rng(0).standard_normal(sr)
    return (0.3 * np.sin(2 * np.pi * 180 * t) + 0.1 * np.sin(2 * np.pi * 1200 * t)
            + 0.02 * noise).astype(np.float32)


def _projection_valley_errors(signal: str, window: str) -> dict:
    """Each projection through the f32 FFT tile, its float64 front and the
    direct f32 form (the plain version) against the float64 oracle of the
    raw audio: the spectrogram inside and below the 50 dB window, PLP-13
    after the port's f32 tail."""
    from mfcc_tpu_torch.ops import plp as plp_op
    cfg = FeatureConfig(window=window).validate()
    x = (_two_tones(16000) if signal == "two tones" else _bench_like())[None]
    forms = {
        "f32": lambda p: _emulate_fft_tile(x, cfg, False, dtype=np.float32,
                                           projection=p),
        "fft64": lambda p: _emulate_fft_tile(x, cfg, False, dtype=np.float32,
                                             front=np.float64, projection=p),
        "direct": lambda p: fused_raw_dit.plain_features(
            torch.from_numpy(x), cfg, False, p).numpy()}
    spec_ref = _oracle_projection(x[0], cfg, "spec")
    keep = spec_ref > spec_ref.max(axis=-1, keepdims=True) - np.log(1e5)
    plp_ref = oracle.plp(x[0].astype(np.float64), cfg)
    out = {}
    for name, form in forms.items():
        d = np.abs(form("spec")[0] - spec_ref)
        out[name] = (float(d[keep].max()), float(d[~keep].max()),
                     float(np.abs(plp_op.plp_from_log_bark(
                         torch.from_numpy(np.asarray(form("bark"),
                                                     np.float32)), cfg
                     )[0].numpy() - plp_ref).max()))
    return out


@pytest.mark.parametrize("signal", ["two tones", "bench-like"])
@pytest.mark.parametrize("window", ["hamming", "hann", "povey"])
def test_projection_valley_choice(signal, window):
    """Why both projections take the float64 front (``_spectral.fft_tile``,
    numbers in PERF.md's valley table).  The f32 tile was to serve the
    spectrogram only if within 2e-4 of the oracle inside the 50 dB window
    with margin and no worse than the direct form below it, and PLP only if
    PLP-13 through it stayed within 2e-5: in the Hann and Povey two-tone
    valleys PLP-13 through the f32 tile is past 1e-4 (PLP's contract; the
    direct form is not), and below the window the f32 spectrogram is worse
    than the direct form.  The float64 front holds the spectrogram within
    1e-5 over every bin and PLP-13 within 2.5e-5 (the f32 tail's own
    error), never worse than the direct form."""
    errs = _projection_valley_errors(signal, window)
    f32_in, f32_below, f32_plp = errs["f32"]
    d_in, d_below, d_plp = errs["direct"]
    f64_in, f64_below, f64_plp = errs["fft64"]
    assert f32_in < 5e-5                   # the window alone would allow f32
    assert max(f64_in, f64_below) <= 1e-5
    assert f64_plp <= min(2.5e-5, d_plp + 2e-6)
    assert d_plp <= 1e-4
    if window != "hamming" and signal == "two tones":
        assert f32_plp > 1e-4 > d_plp, (f32_plp, d_plp)
        assert f32_below > d_below, (f32_below, d_below)
    for projection in ("bark", "spec"):
        assert _spectral.fft_tile(FeatureConfig(window=window), False,
                                  projection) == "fft64"
