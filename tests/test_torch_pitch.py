"""The port's pitch slice against the JAX package on the same inputs: the
PitchConfig twin, the resampler, the pitch stages and their constants, the
NCCF and Viterbi kernels' plain versions (and numpy emulations of the CUDA
kernels' arithmetic), the pitch model, the golden and the float64 oracle.
The cases that need the card are in tests/test_torch_cuda.py.

Per-column contract of the pitch features (docs/conventions.md,
tests/test_pitch.py): pov 1e-4, normalized log pitch 3e-4, delta 1e-4.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfcc_tpu import config as jax_config, oracle as jax_oracle
from mfcc_tpu.models import pitch as jax_pitch_model
from mfcc_tpu.ops import pitch as jax_pitch, resample as jax_resample
from mfcc_tpu.ops.kernels import fused_nccf as jax_nccf_kernel
from mfcc_tpu.ops.kernels import fused_viterbi as jax_viterbi_kernel
from mfcc_tpu_torch import PitchConfig, from_jax, oracle
from mfcc_tpu_torch.models import pitch as pitch_model
from mfcc_tpu_torch.ops import pitch as pitch_op, resample
from mfcc_tpu_torch.ops.kernels import fused_nccf, fused_viterbi
from mfcc_tpu_torch.tools import ablate_pitch
from mfcc_tpu_torch.utils import wav

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
SR = 16000
KERNEL_TOL = 2e-5     # NCCF kernel vs XLA bound of tests/test_pitch.py
ATOL = (1e-4, 3e-4, 1e-4)   # pov, norm, delta

CONFIGS = [
    dict(),
    dict(work_rate=2000),
    dict(min_f0=60.0, max_f0=300.0),
    dict(hop_ms=15.25),
    dict(sample_rate=8000),
]


def _tone_silence(rng, seconds=1):
    n = seconds * SR
    t = np.arange(n) / SR
    voiced = (0.4 * np.sin(2 * np.pi * 220 * t)
              + 0.2 * np.sin(2 * np.pi * 440 * t)
              + 0.01 * rng.standard_normal(n))
    sil = 0.001 * rng.standard_normal(n)
    return np.concatenate([voiced, sil]).astype(np.float32)


def _vibrato(rng, n=SR, f0=180.0, depth=0.1, rate=4.0):
    t = np.arange(n) / SR
    phase = 2 * np.pi * f0 * (t + depth / (2 * np.pi * rate)
                              * np.sin(2 * np.pi * rate * t))
    x = np.zeros(n)
    for h, a in ((1, 0.5), (2, 0.25), (3, 0.12)):
        x += a * np.sin(h * phase)
    return (x + 0.02 * rng.standard_normal(n)).astype(np.float32)


def _ragged(rng):
    """(3, 2 s) zero-padded batch: tone+silence, vibrato 1.5 s, 0.3 s."""
    x = np.zeros((3, 2 * SR), np.float32)
    lens = np.asarray([2 * SR, 24000, 4800], np.int32)
    x[0] = _tone_silence(rng)
    x[1, :24000] = _vibrato(rng, n=24000)
    x[2, :4800] = _vibrato(rng, n=4800, f0=120.0)
    return x, lens


def _check_columns(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    for i, tol in enumerate(ATOL):
        err = float(np.abs(got[..., i] - want[..., i]).max()) \
            if got.size else 0.0
        assert err < tol, (i, err)


def _jcfg(kw):
    return jax_config.PitchConfig(**kw).validate()


def _flens_mask(lens, pcfg, T):
    flens = np.minimum(np.asarray(jax_pitch.pitch_frame_counts(
        jnp.asarray(lens), pcfg)), T)
    return flens, np.arange(T)[None, :] < flens[:, None]


# --------------------------------------------------------------- config --

def test_pitch_config_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jax_config.PitchConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(PitchConfig)]
    assert tf == jf


@pytest.mark.parametrize("kw", CONFIGS)
def test_pitch_config_twin(kw):
    j = _jcfg(kw)
    t = PitchConfig(**kw).validate()
    assert t.to_json() == j.to_json()
    assert t.config_hash() == j.config_hash()
    for name in ("frame_len_w", "hop_len_w", "min_lag", "max_lag", "n_lags",
                 "n_feats"):
        assert getattr(t, name) == getattr(j, name), name
    for n in (0, 1, 719, 720, 721, 723, 1000, 16000, 16001, 160000):
        assert t.num_frames(n) == j.num_frames(n), n
    assert from_jax(j) == t
    assert from_jax(dataclasses.asdict(j)) == t
    assert from_jax(dataclasses.asdict(j)).config_hash() == j.config_hash()


def test_from_jax_rejects_unknown_pitch_fields():
    d = dataclasses.asdict(jax_config.PitchConfig())
    with pytest.raises(ValueError, match="PitchConfig"):
        from_jax({**d, "new_field": 1})
    d.pop("penalty")
    with pytest.raises(ValueError, match="PitchConfig"):
        from_jax(d)


@pytest.mark.parametrize("bad", [
    dict(work_rate=32000),
    dict(min_f0=500.0, max_f0=400.0),
    dict(max_f0=3000.0),
    dict(work_rate=200, min_f0=80.0, max_f0=100.0),
    dict(norm_window=150),
])
def test_pitch_validate_errors_match(bad):
    with pytest.raises(ValueError) as je:
        jax_config.PitchConfig(**bad).validate()
    with pytest.raises(ValueError) as te:
        PitchConfig(**bad).validate()
    assert str(te.value) == str(je.value)


# ------------------------------------------------------------- resample --

@pytest.mark.parametrize("sr_in,sr_out,n", [
    (16000, 4000, 3001), (8000, 4000, 1200), (44100, 16000, 4410),
    (16000, 2000, 999), (4000, 16000, 50), (16000, 4000, 3)])
def test_resample_poly_numpy_equal(rng, sr_in, sr_out, n):
    x = rng.standard_normal(n)
    np.testing.assert_array_equal(
        resample.resample_poly_numpy(x, sr_in, sr_out),
        jax_resample.resample_poly_numpy(x, sr_in, sr_out))
    assert resample.resampled_length(n, sr_in, sr_out) == \
        jax_resample.resampled_length(n, sr_in, sr_out)


@pytest.mark.parametrize("fold", [resample._FOLD_COLUMNS, 1])
@pytest.mark.parametrize("sr_in,sr_out", [(16000, 4000), (8000, 4000),
                                          (44100, 16000)])
def test_resample_matches_jax(rng, monkeypatch, fold, sr_in, sr_out):
    """Within 1e-6 of the JAX resampler, with the bank super-blocked (the
    shipped layout) and as it is (R = 1)."""
    monkeypatch.setattr(resample, "_FOLD_COLUMNS", fold)
    x = (0.5 * rng.standard_normal((2, sr_in // 4 + 7))).astype(np.float32)
    want = np.asarray(jax_resample.resample(jnp.asarray(x), sr_in, sr_out))
    got = resample.resample(torch.from_numpy(x), sr_in, sr_out)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    f64 = resample.resample_poly_numpy(x[0].astype(np.float64), sr_in, sr_out)
    np.testing.assert_allclose(got[0].numpy(), f64, atol=1e-6, rtol=0)
    assert tuple(resample.resample(torch.zeros((2, 0)), sr_in,
                                   sr_out).shape) == (2, 0)


# ------------------------------------------------------------ constants --

@pytest.mark.parametrize("kw", CONFIGS)
def test_pitch_constants_equal(kw):
    j, t = _jcfg(kw), PitchConfig(**kw).validate()
    for a, b in zip(pitch_op._corr_matrices(t), jax_pitch._corr_matrices(j)):
        np.testing.assert_array_equal(a, b)
    want = jax_pitch._trans_matrix(j)
    np.testing.assert_array_equal(pitch_op._trans_matrix(t), want)
    # the Viterbi kernels' matrices: the CUDA kernel uploads this one
    # (page-locked); the Pallas kernel reads it as transition columns
    n = t.n_lags
    np.testing.assert_array_equal(
        jax_viterbi_kernel._trans_cols(j, -(-n // 8) * 8)[:, :n, 0], want.T)


# ----------------------------------------------------------------- NCCF --

def _work_rate_rows(rng, pcfg, seconds=2):
    x = np.stack([_vibrato(rng, n=seconds * SR),
                  np.pad(_tone_silence(rng), (0, SR))[: seconds * SR]])
    x = x[:, : seconds * pcfg.sample_rate]
    xw = np.array(jax_resample.resample(jnp.asarray(x), pcfg.sample_rate,
                                        pcfg.work_rate))
    lens = np.asarray([x.shape[1], x.shape[1] * 3 // 4], np.int32)
    return x, xw, lens


@pytest.mark.parametrize("kw", CONFIGS[:3])
def test_plain_nccf_matches_jax_and_pallas(rng, kw):
    """Plain nccf against the JAX XLA nccf and against the Pallas kernel in
    interpret mode given the same ballast, on valid frames, as
    tests/test_pitch.py runs the kernel: the ballasted NCCF on every row,
    the plain NCCF on the voiced row.  (Row 1 steps from a tone into
    near-silence; there the correlation-theorem form's rounding, which
    scales with the whole extended window, is divided by a small lag-window
    energy, and the plain NCCF of both packages is up to ~2e-3 off the
    float64 oracle; see test_nccf_kernel_arithmetic_matches_plain.)"""
    j, t = _jcfg(kw), PitchConfig(**kw).validate()
    x, xw, lens = _work_rate_rows(rng, j)
    T = j.num_frames(x.shape[1])
    flens, mask = _flens_mask(lens, j, T)
    want_b, want_p = jax_pitch.nccf(jnp.asarray(xw), j, jnp.asarray(mask))
    got_b, got_p = pitch_op.nccf(torch.from_numpy(xw), t,
                                 torch.from_numpy(mask))
    jball = j.ballast * jax_pitch.mean_frame_energy(
        jnp.asarray(xw), j, jnp.asarray(mask)) ** 2
    ball = t.ballast * pitch_op.mean_frame_energy(
        torch.from_numpy(xw), t, torch.from_numpy(mask)) ** 2
    np.testing.assert_allclose(ball.numpy(), np.asarray(jball), rtol=1e-5)
    kb, kp = jax_nccf_kernel.fused_nccf(jnp.asarray(xw), jball, j, T=T,
                                        interpret=True)
    pb, pp = fused_nccf.plain_nccf(torch.from_numpy(xw),
                                   torch.from_numpy(np.array(jball)), t, T)
    pairs = [(got_b, want_b, (0, 1)), (pb, kb, (0, 1)),
             (got_p, want_p, (0,)), (pp, kp, (0,))]
    for got, want, rows in pairs:
        for i in rows:
            v = flens[i]
            np.testing.assert_allclose(got.numpy()[i, :v],
                                       np.asarray(want)[i, :v],
                                       atol=KERNEL_TOL, rtol=0)


def _emulate_nccf_kernel(xw, ball, pcfg, T):
    """The CUDA kernel's arithmetic in float32 numpy: direct correlation,
    samples past each row's end read 0 (tiling does not change a value)."""
    w, hop, lo, nl = pcfg.frame_len_w, pcfg.hop_len_w, pcfg.min_lag, pcfg.n_lags
    n = w + pcfg.max_lag
    z = np.zeros((xw.shape[0], (T - 1) * hop + n), np.float32)
    m = min(z.shape[1], xw.shape[1])
    z[:, :m] = xw[:, :m]
    E = z[:, (np.arange(T) * hop)[:, None] + np.arange(n)[None, :]]
    A = E[..., :w]
    e0 = (A * A).sum(-1, dtype=np.float32)
    num = np.empty(E.shape[:2] + (nl,), np.float32)
    el = np.empty_like(num)
    for k in range(nl):
        Ek = E[..., lo + k: lo + k + w]
        num[..., k] = (A * Ek).sum(-1, dtype=np.float32)
        el[..., k] = (Ek * Ek).sum(-1, dtype=np.float32)
    prod = np.maximum(e0[..., None] * el, np.float32(1e-30))
    ball = ball.astype(np.float32)[:, None, None]
    return num / np.sqrt(prod + ball), num / np.sqrt(prod)


@pytest.mark.parametrize("kw", CONFIGS)
def test_nccf_kernel_arithmetic_matches_plain(rng, kw):
    """The kernel's direct correlation against the plain correlation-
    theorem version, within the 2e-5 kernel bound on valid frames (the
    ballasted NCCF on every row, the plain NCCF on the voiced row), and
    its plain NCCF within the same bound of the float64 oracle on every
    valid frame, the tone-to-silence step included.  Every config runs,
    hop_ms=15.25 too, which the Pallas kernel could not take."""
    t = PitchConfig(**kw).validate()
    x, xw, lens = _work_rate_rows(rng, t)
    T = t.num_frames(x.shape[1])
    flens, mask = _flens_mask(lens, t, T)
    ball = t.ballast * pitch_op.mean_frame_energy(
        torch.from_numpy(xw), t, torch.from_numpy(mask)) ** 2
    pb, pp = fused_nccf.plain_nccf(torch.from_numpy(xw), ball, t, T)
    kb, kp = _emulate_nccf_kernel(xw, ball.numpy(), t, T)
    assert np.isfinite(kb).all() and np.isfinite(kp).all()
    n = t.frame_len_w + t.max_lag
    for i, v in enumerate(flens):
        np.testing.assert_allclose(kb[i, :v], pb.numpy()[i, :v],
                                   atol=KERNEL_TOL, rtol=0)
        if i == 0:
            np.testing.assert_allclose(kp[i, :v], pp.numpy()[i, :v],
                                       atol=KERNEL_TOL, rtol=0)
        _, want_p = oracle.nccf(
            xw[i, : (v - 1) * t.hop_len_w + n].astype(np.float64), t)
        np.testing.assert_allclose(kp[i, :v], want_p, atol=KERNEL_TOL,
                                   rtol=0)


def test_nccf_wrapper_on_cpu_runs_the_plain_version(rng):
    t = PitchConfig()
    xw = torch.from_numpy((0.3 * rng.standard_normal((2, 4000)))
                          .astype(np.float32))
    ball = torch.tensor([0.5, 0.25])
    before = fused_nccf.LAUNCHES
    got = fused_nccf.fused_nccf(xw, ball, t, T=90)
    want = fused_nccf.plain_nccf(xw, ball, t, 90)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fused_nccf.LAUNCHES == before
    with pytest.raises(ValueError):
        fused_nccf.fused_nccf(xw, ball[:1], t, T=90)
    assert fused_nccf.kernel_supports(t)
    assert not fused_nccf.kernel_supports(
        PitchConfig(work_rate=16000, min_f0=0.25).validate())


# ---------------------------------------------------------- chunked NCCF --
# nccf_chunk=: the port chunks on the CPU only (on the card the kernel's
# frames would be the same bits, so it runs unchunked; tests/test_torch_cuda.py)

HI = jax.lax.Precision.HIGHEST
CHUNK_SECONDS = 6           # 596 frames: K = 512 makes two chunks
CHUNKS = (4, 128, 512)


def _chunk_inputs(rng, kw=None):
    """The (3, 6 s) zero-padded batch at the work rate: vibrato 6 s
    (voiced), tone + silence repeated, vibrato 0.3 s (voiced)."""
    j, t = _jcfg(kw or {}), PitchConfig(**(kw or {})).validate()
    n = CHUNK_SECONDS * SR
    x = np.zeros((3, n), np.float32)
    lens = np.asarray([n, n * 3 // 4, 4800], np.int32)
    x[0] = _vibrato(rng, n=n)
    x[1, : lens[1]] = np.tile(_tone_silence(rng), CHUNK_SECONDS)[: lens[1]]
    x[2, :4800] = _vibrato(rng, n=4800, f0=120.0)
    xw = np.array(jax_resample.resample(jnp.asarray(x), j.sample_rate,
                                        j.work_rate))
    flens, mask = _flens_mask(lens, j, j.num_frames(n))
    return j, t, xw, flens, mask


def _close_on_valid(got, want, flens, voiced=(0, 2)):
    """The ballasted NCCF on every row, the plain one on the voiced rows,
    valid frames only, within the kernel bound."""
    (gb, gp), (wb, wp) = got, want
    for i, v in enumerate(flens):
        np.testing.assert_allclose(np.asarray(gb)[i, :v],
                                   np.asarray(wb)[i, :v], atol=KERNEL_TOL,
                                   rtol=0)
        if i in voiced:
            np.testing.assert_allclose(np.asarray(gp)[i, :v],
                                       np.asarray(wp)[i, :v],
                                       atol=KERNEL_TOL, rtol=0)


@pytest.mark.parametrize("K", CHUNKS)
@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_chunked_nccf_matches_jax(rng, K, route):
    """The port's chunked NCCF against JAX's ``_nccf_chunked`` on its XLA
    route and through its Pallas kernel in interpret mode, on a ragged
    B = 3 batch."""
    j, t, xw, flens, mask = _chunk_inputs(rng)
    want = jax_pitch._nccf_chunked(jnp.asarray(xw), j, jnp.asarray(mask), K,
                                   precision=HI, backend=route)
    got = pitch_op._nccf_chunked(torch.from_numpy(xw), t,
                                 torch.from_numpy(mask), K,
                                 precision="highest")
    assert tuple(got[0].shape) == want[0].shape == (3, mask.shape[1],
                                                    t.n_lags)
    _close_on_valid(got, want, flens)


@pytest.mark.parametrize("kw", CONFIGS[1:4])
def test_chunked_nccf_matches_jax_other_configs(rng, kw):
    j, t, xw, flens, mask = _chunk_inputs(rng, kw)
    want = jax_pitch._nccf_chunked(jnp.asarray(xw), j, jnp.asarray(mask), 64,
                                   precision=HI, backend="xla")
    got = pitch_op._nccf_chunked(torch.from_numpy(xw), t,
                                 torch.from_numpy(mask), 64,
                                 precision="highest")
    _close_on_valid(got, want, flens)


@pytest.mark.parametrize("K", CHUNKS)
def test_chunked_equals_unchunked(rng, K):
    """Every frame reads the samples it reads unchunked, so the plain NCCF
    is equal in every bit; the ballasted one differs by the ballast's
    summation order (the global mean from hop-block sums here, from the
    frame tensor in the unchunked ``nccf``), within the reference's 2e-6
    (``tests/test_pitch.py``)."""
    _, t, xw, flens, mask = _chunk_inputs(rng)
    xw, mask = torch.from_numpy(xw), torch.from_numpy(mask)
    want_b, want_p = pitch_op.nccf(xw, t, mask)
    got_b, got_p = pitch_op._nccf_chunked(xw, t, mask, K, precision="highest")
    assert torch.equal(got_p, want_p)
    np.testing.assert_allclose(got_b.numpy(), want_b.numpy(), atol=2e-6,
                               rtol=0)


@pytest.mark.parametrize("kw", CONFIGS)
def test_chunk_bound(rng, kw):
    """``_nccf_chunked`` raises ValueError exactly when (K+1)*hop_len_w <
    frame_len_w + max_lag, or K < 1; at the smallest K it takes it agrees
    with JAX's.  Below it the reference fails inside its reshape, with a
    TypeError (a deliberate deviation; at the default config K = 3)."""
    j, t, xw, flens, mask = _chunk_inputs(rng, kw)
    k_min = max(1, -(-(t.frame_len_w + t.max_lag) // t.hop_len_w) - 1)
    assert (k_min + 1) * t.hop_len_w >= t.frame_len_w + t.max_lag
    txw, tmask = torch.from_numpy(xw), torch.from_numpy(mask)
    for K in (0, -1, k_min - 1):
        if K >= 1:
            assert (K + 1) * t.hop_len_w < t.frame_len_w + t.max_lag
            with pytest.raises(TypeError, match="reshape"):
                jax_pitch._nccf_chunked(jnp.asarray(xw), j,
                                        jnp.asarray(mask), K, precision=HI,
                                        backend="xla")
        with pytest.raises(ValueError, match=f"nccf_chunk={K}"):
            pitch_op._nccf_chunked(txw, t, tmask, K, precision="highest")
    got = pitch_op._nccf_chunked(txw, t, tmask, k_min, precision="highest")
    want = jax_pitch._nccf_chunked(jnp.asarray(xw), j, jnp.asarray(mask),
                                   k_min, precision=HI, backend="xla")
    _close_on_valid(got, want, flens)
    if not kw:
        assert k_min == 4


def test_pitch_features_chunked_on_voiced_audio(rng):
    """``pitch_features(nccf_chunk=128)`` on a voiced 4 s vibrato: within
    the oracle's bounds, and JAX's with the same arguments; with the
    blocked Viterbi too, within 3e-4 of the unchunked blocked pipeline
    (the reference's bound)."""
    j, t = _jcfg({}), PitchConfig()
    xv = torch.from_numpy(_vibrato(rng, n=4 * SR)[None, :])
    lens = torch.tensor([xv.shape[1]], dtype=torch.int32)
    want = oracle.pitch(xv[0].numpy().astype(np.float64), t)
    feat, flens, _ = pitch_op.pitch_features(xv, lens, t, nccf_chunk=128)
    _check_columns(feat[0, : int(flens[0])].numpy(), want)
    jfeat, jflens, _ = jax_pitch.pitch_features(
        jnp.asarray(xv.numpy()), jnp.asarray(lens.numpy()), j, nccf_chunk=128)
    assert int(jflens[0]) == int(flens[0])
    _check_columns(feat.numpy(), np.asarray(jfeat))
    blocked = dict(viterbi_block=256, viterbi_warm=128)
    f2 = pitch_op.pitch_features(xv, lens, t, nccf_chunk=128, **blocked)[0]
    f3 = pitch_op.pitch_features(xv, lens, t, **blocked)[0]
    np.testing.assert_allclose(f2.numpy(), f3.numpy(), atol=3e-4, rtol=0)


# -------------------------------------------------------------- Viterbi --

def _scores(rng, B, T, n):
    s = (0.5 * rng.standard_normal((B, T, n))).astype(np.float32)
    s[min(1, B - 1), T * 2 // 3:] = 0.0      # zero-emission tail
    return s


def _lane_argmin(cand, lo, hi):
    """(value, index) of the first minimum of cand[:, lo:hi] over axis 1 as
    the kernel's tree of contiguous pairs: the higher half wins only if
    strictly smaller."""
    if hi - lo == 1:
        return cand[:, lo], np.full(cand[:, lo].shape, lo, np.int32)
    mid = lo + (hi - lo + 1) // 2
    v, a = _lane_argmin(cand, lo, mid)
    v2, a2 = _lane_argmin(cand, mid, hi)
    upd = v2 < v
    return np.where(upd, v2, v), np.where(upd, a2, a)


def _emulate_viterbi_kernel(s, trans, K=1, TB=None):
    """The CUDA kernel's arithmetic in float32 numpy, vectorized over the
    destination states: lane k of a state takes the first argmin of j in
    [k*J, (k+1)*J) (J = ceil(n/K) rounded up to a built register width,
    the slots past the grid at +inf) by a tree of contiguous pairs (strict <
    for the higher half), the K partials merge as the kernel's warp
    shuffles do (rounds off = 1, 2, 4, ..., the lower range keeping ties),
    and the backpointers go through a TB-step byte buffer (uint16 above
    256 states) whose full blocks spill and are read back, last first, for
    the backtrace."""
    B, T, n = s.shape
    J = ablate_pitch.viterbi_width(n, K)
    bpt = np.uint8 if n <= 256 else np.uint16
    TB = T if TB is None else TB
    blocks = (T - 1) // TB + 1
    # transitions of each lane's range, 0 past the grid (cost +inf there)
    tv = np.zeros((K * J, n), np.float32)
    tv[:n] = trans
    path = np.zeros((B, T), np.int32)
    for b in range(B):
        cur = np.full(K * J, np.inf, np.float32)
        cur[:n] = -s[b, 0]
        buf = np.zeros((TB, n), bpt)
        spill = np.zeros((blocks, TB, n), bpt)
        for t in range(1, T):
            cand = (cur[:, None] + tv).reshape(K, J, n)   # (lane, m, state)
            best, arg = _lane_argmin(cand, 0, J)
            arg = arg + (np.arange(K) * J)[:, None]
            off = 1
            while off < K:
                for k in range(0, K, 2 * off):
                    upd = best[k + off] < best[k]
                    best[k] = np.where(upd, best[k + off], best[k])
                    arg[k] = np.where(upd, arg[k + off], arg[k])
                off *= 2
            nxt = np.full(K * J, np.inf, np.float32)
            nxt[:n] = best[0] - s[b, t]
            cur = nxt
            buf[t % TB] = arg[0]
            if t % TB == TB - 1 and t // TB < blocks - 1:
                spill[t // TB] = buf
        k = int(np.argmin(cur[:n]))
        for q in range(blocks - 1, -1, -1):
            if q < blocks - 1:
                buf = spill[q]
            for t in range(min((q + 1) * TB, T) - 1, q * TB - 1, -1):
                path[b, t] = k
                if t > 0:
                    k = int(buf[t - q * TB, k])
    return path


@pytest.mark.parametrize("T", [1, 2, 64, 65, 150])
def test_viterbi_exactly_equal(rng, T):
    """Plain viterbi, the Pallas kernel (interpret mode), the JAX scan and
    an emulation of the CUDA kernel's loop give the same paths, exactly."""
    j = jax_config.PitchConfig().validate()
    t = PitchConfig()
    s = _scores(rng, 3, T, t.n_lags)
    got = pitch_op.viterbi(torch.from_numpy(s), t)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, T)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_pitch.viterbi(jnp.asarray(s), j)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_viterbi_kernel.viterbi_pallas(jnp.asarray(s), j, interpret=True)))
    np.testing.assert_array_equal(
        got.numpy(), _emulate_viterbi_kernel(s, pitch_op._trans_matrix(t)))
    np.testing.assert_array_equal(
        got.numpy(), _emulate_viterbi_kernel(s, pitch_op._trans_matrix(t),
                                             TB=16))
    np.testing.assert_array_equal(
        fused_viterbi.fused_viterbi(torch.from_numpy(s), t).numpy(),
        got.numpy())


# lag-grid sizes of the lane-merge cases: 2 and 33 states (lanes with
# empty ranges at K = 16), the default 71, and 257 (uint16 backpointers)
VITERBI_GRIDS = {2: dict(min_f0=363.0), 33: dict(min_f0=95.0), 71: {},
                 257: dict(min_f0=15.0)}


@functools.lru_cache(maxsize=None)
def _viterbi_reference(n, kind):
    """(scores, path) of a (3, 40, n) case: Gaussian scores, or a tie-heavy
    case (penalty 0, scores in {-1, 0, 1}, so nearly every argmin is a tie
    and only the first index is right), with a zero-emission tail.  The
    plain version's path, held equal to the JAX scan and to the Pallas
    kernel in interpret mode."""
    kw = dict(VITERBI_GRIDS[n], **({"penalty": 0.0} if kind == "ties" else {}))
    j, t = _jcfg(kw), PitchConfig(**kw).validate()
    assert t.n_lags == n
    rng = np.random.default_rng(n)
    if kind == "ties":
        s = rng.integers(-1, 2, (3, 40, n)).astype(np.float32)
        s[1, 26:] = 0.0
    else:
        s = _scores(rng, 3, 40, n)
    got = pitch_op.viterbi(torch.from_numpy(s), t).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_pitch.viterbi(jnp.asarray(s), j)))
    np.testing.assert_array_equal(got, np.asarray(
        jax_viterbi_kernel.viterbi_pallas(jnp.asarray(s), j, interpret=True)))
    return s, got, pitch_op._trans_matrix(t)


@pytest.mark.parametrize("kind", ["gauss", "ties"])
@pytest.mark.parametrize("n", list(VITERBI_GRIDS))
@pytest.mark.parametrize("K", [1, 2, 4, 8, 16])
def test_viterbi_lane_merge_exactly_equal(K, n, kind):
    """The kernel's reduction order (K lanes a state, an argmin tree in each
    lane, shuffle merge, spilled byte backpointers) gives the first-index argmin path exactly,
    for every K, on Gaussian and on tie-heavy scores."""
    s, want, trans = _viterbi_reference(n, kind)
    if kind == "ties":
        assert (trans == 0).all()
    for TB in (None, 16):
        np.testing.assert_array_equal(
            _emulate_viterbi_kernel(s, trans, K=K, TB=TB), want)


@pytest.mark.parametrize("T,block,warm", [(150, 32, 16), (100, 256, 128),
                                          (900, 256, 128)])
def test_viterbi_blocked_exactly_equal(rng, T, block, warm):
    j = jax_config.PitchConfig().validate()
    t = PitchConfig()
    s = _scores(rng, 2, T, t.n_lags)
    got = pitch_op.viterbi_blocked(torch.from_numpy(s), t, block=block,
                                   warm=warm)
    want = np.asarray(jax_pitch.viterbi_blocked(jnp.asarray(s), j,
                                                block=block, warm=warm))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pitch_op.viterbi_blocked(torch.from_numpy(s), t, block=block,
                                 warm=warm, backend="cuda")


def test_viterbi_wrapper_on_cpu_runs_the_plain_version(rng):
    t = PitchConfig(min_f0=60.0, max_f0=300.0)
    s = torch.from_numpy(_scores(rng, 2, 40, t.n_lags))
    before = fused_viterbi.LAUNCHES
    assert torch.equal(fused_viterbi.fused_viterbi(s, t),
                       pitch_op.viterbi(s, t))
    assert fused_viterbi.LAUNCHES == before
    with pytest.raises(ValueError):
        fused_viterbi.fused_viterbi(s[..., :-1], t)
    assert tuple(fused_viterbi.fused_viterbi(s[:, :0], t).shape) == (2, 0)


def test_pitch_kernels_shared_loads_conflict_free():
    """The lane mappings of both kernels at the default config take one
    shared-memory wavefront for every warp-wide load: the NCCF tile the C
    entry plans there (32 frames, R = 9 lags a thread, one pass; the card
    reports it in chip_smoke.py phase 5) and the Viterbi cost loads at
    every lane count a state may get.  A 61-sample hop (hop_ms=15.25)
    breaks the frame stagger, which the count shows."""
    t = PitchConfig()
    geometry = (t.frame_len_w, t.hop_len_w, t.min_lag, t.n_lags)
    counts = ablate_pitch.nccf_bank_wavefronts(*geometry, TM=32, R=9,
                                               passes=1)
    for loads, wavefronts in counts.values():
        assert loads == wavefronts > 0, counts
    for K in (1, 2, 4, 8):
        loads, wavefronts = ablate_pitch.viterbi_bank_wavefronts(t.n_lags, K)
        assert loads == wavefronts > 0, K
    loads, wavefronts = ablate_pitch.nccf_bank_wavefronts(
        100, 61, 10, 71, TM=32, R=9, passes=1)["numerator"]
    assert wavefronts > loads


def test_pitch_ablation_edits_still_apply():
    """Every A/B variant of tools/ablate_pitch.py edits the current
    sources (each edit matches exactly once)."""
    for name in ablate_pitch.VARIANTS:
        files = ablate_pitch.variant_sources(name)
        for src in ablate_pitch.sources_of(name):
            assert f"{src}.cu" in files


# ---------------------------------------------------------------- model --

@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("kw", [dict(), dict(work_rate=2000),
                                dict(hop_ms=15.25)])
def test_pitch_batch_matches_jax_and_oracle(rng, dtype, kw):
    j, t = _jcfg(kw), PitchConfig(**kw).validate()
    x, lens = _ragged(rng)
    if dtype == "int16":
        x = np.round(np.clip(x, -1, 32767 / 32768) * 32768).astype(np.int16)
    jf, jfl, jm = jax_pitch_model.pitch_batch_jit(
        jnp.asarray(x), jnp.asarray(lens), j, "xla")
    tf, tfl, tm = pitch_model.pitch_batch(torch.from_numpy(x),
                                          torch.from_numpy(lens), t)
    assert tf.dtype == torch.float32 and tfl.dtype == torch.int32
    assert tm.dtype == torch.bool
    np.testing.assert_array_equal(tfl.numpy(), np.asarray(jfl))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # against the JAX pipeline on the rows without a tone-to-silence step:
    # at that step each f32 pipeline is up to ~2.4e-4 off the oracle in
    # the norm column (its correlation-theorem NCCF), in opposite
    # directions, so row 0 is held to the oracle alone (below)
    _check_columns(tf.numpy()[1:], np.asarray(jf)[1:])
    assert (tf.numpy()[~tm.numpy()] == 0.0).all()
    xf = x.astype(np.float64) / (32768.0 if dtype == "int16" else 1.0)
    for i in range(len(lens)):
        want = oracle.pitch(xf[i, : lens[i]], t)
        assert want.shape[0] == int(tfl[i])
        _check_columns(tf.numpy()[i, : want.shape[0]], want)


@pytest.mark.parametrize("nccf_chunk", [None, 4, 64, 196, 296])
def test_pitch_track_matches_jax(rng, nccf_chunk):
    """The model's track, and with ``nccf_chunk`` ``pitch_track`` chunked in
    both packages; at K >= T (196 frames) neither chunks, and the port's
    track equals ``nccf_chunk=None``'s in every bit."""
    j, t = _jcfg({}), PitchConfig()
    x, lens = _ragged(rng)
    if nccf_chunk is None:
        jf0, jv, jm = jax_pitch_model.pitch_track_batch_jit(
            jnp.asarray(x), jnp.asarray(lens), j)
        f0, v, m = pitch_model.pitch_track_batch(torch.from_numpy(x),
                                                 torch.from_numpy(lens), t)
    else:
        jf0, jv, jm = jax_pitch.pitch_track(
            jnp.asarray(x), jnp.asarray(lens), j, nccf_chunk=nccf_chunk)
        f0, v, m = pitch_op.pitch_track(torch.from_numpy(x),
                                        torch.from_numpy(lens), t,
                                        nccf_chunk=nccf_chunk)
        if nccf_chunk >= t.num_frames(x.shape[1]):
            want = pitch_op.pitch_track(torch.from_numpy(x),
                                        torch.from_numpy(lens), t)
            assert all(torch.equal(a, b) for a, b in zip((f0, v, m), want))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    # f0 = work_rate / lag: 1e-4 of log pitch is ~1e-4 relative
    np.testing.assert_allclose(f0.numpy(), np.asarray(jf0), rtol=1e-4,
                               atol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=KERNEL_TOL)


def test_pitch_golden_and_oracle_twin():
    x, sr = wav.read_wav(os.path.join(GOLDEN, "speech2s.wav"))
    assert sr == SR
    t = PitchConfig()
    want = np.load(os.path.join(GOLDEN, "pitch3.npy"))
    np.testing.assert_allclose(oracle.pitch(x.astype(np.float64), t), want,
                               atol=1e-12, rtol=0)
    np.testing.assert_array_equal(
        oracle.pitch(x.astype(np.float64), t),
        jax_oracle.pitch(x.astype(np.float64), jax_config.PitchConfig()))
    _check_columns(pitch_model.pitch(torch.from_numpy(x), t).numpy(), want)
    feat, flens, _ = pitch_model.pitch_batch(
        torch.from_numpy(x[None]), torch.tensor([len(x)]), t)
    assert int(flens[0]) == want.shape[0]
    _check_columns(feat[0].numpy(), want)


@pytest.mark.parametrize("n", [0, 500, 715])
def test_pitch_batch_no_frames(n):
    j, t = _jcfg({}), PitchConfig()
    x = np.zeros((2, n), np.float32)
    lens = np.asarray([n, n // 2], np.int32)
    jf, jfl, jm = jax_pitch_model.pitch_batch(jnp.asarray(x),
                                              jnp.asarray(lens), j)
    tf, tfl, tm = pitch_model.pitch_batch(torch.from_numpy(x),
                                          torch.from_numpy(lens), t)
    assert tuple(tf.shape) == jf.shape == (2, 0, 3)
    assert tuple(tm.shape) == jm.shape == (2, 0)
    np.testing.assert_array_equal(tfl.numpy(), np.asarray(jfl))
    f0, v, m = pitch_model.pitch_track_batch(torch.from_numpy(x),
                                             torch.from_numpy(lens), t)
    assert tuple(f0.shape) == tuple(m.shape) == (2, 0)


@pytest.mark.parametrize("flens,T", [([4, 2], 6), ([0, 1], 3), ([4, 3], 2),
                                     ([4, 4], 4)])
def test_align_pitch_exactly_equal(rng, flens, T):
    fp = rng.standard_normal((2, 4, 3)).astype(np.float32)
    want = np.asarray(jax_pitch_model.align_pitch(
        jnp.asarray(fp), jnp.asarray(flens, jnp.int32), T))
    got = pitch_model.align_pitch(torch.from_numpy(fp),
                                  torch.tensor(flens, dtype=torch.int32), T)
    np.testing.assert_array_equal(got.numpy(), want)
    empty = pitch_model.align_pitch(torch.zeros((2, 0, 3)),
                                    torch.zeros(2, dtype=torch.int32), T)
    assert tuple(empty.shape) == (2, T, 3) and not empty.any()


def test_pitch_backend_resolution_and_unported_options(rng):
    t = PitchConfig()
    x = torch.from_numpy(_tone_silence(rng)[None])
    lens = torch.tensor([x.shape[1]])
    with pytest.raises(ValueError, match="CUDA tensor"):
        pitch_model.pitch_batch(x, lens, t, "cuda")
    with pytest.raises(ValueError, match="backend"):
        pitch_model.pitch_batch(x, lens, t, "pallas")
    with pytest.raises(ValueError, match="nccf_chunk=3"):
        pitch_op.pitch_features(x, lens, t, nccf_chunk=3)
    counts = (fused_nccf.LAUNCHES, fused_viterbi.LAUNCHES)
    a = pitch_model.pitch_batch(x, lens, t, "auto")[0]
    b = pitch_model.pitch_batch(x, lens, t, "torch")[0]
    assert torch.equal(a, b)
    assert (fused_nccf.LAUNCHES, fused_viterbi.LAUNCHES) == counts
    # the opt-in blocked Viterbi stays inside the contract on voiced audio
    xv = _vibrato(rng, n=5 * SR)
    want = oracle.pitch(xv.astype(np.float64), t)
    got, _, _ = pitch_op.pitch_features(
        torch.from_numpy(xv[None]), torch.tensor([xv.size]), t,
        viterbi_block=128, viterbi_warm=64)
    _check_columns(got[0].numpy(), want)


def _cumsum_in_own_dtype(v, dim, dtype=None):
    """torch.cumsum as CUDA runs it: the running sum kept in the result's
    dtype (the CPU's cumsum of float32 accumulates in float64)."""
    a = torch.movedim(v.to(dtype or v.dtype), dim, 0)
    out, acc = torch.empty_like(a), torch.zeros_like(a[0])
    for i in range(a.shape[0]):
        acc = acc + a[i]
        out[i] = acc
    return torch.movedim(out, 0, dim)


def test_pitch_two_minutes_under_cuda_cumsum(monkeypatch):
    """The card's float32 running cumsum emulated on the CPU, over a
    2-minute row of the bench signal (two tones plus noise, 11,996
    frames): the POV^2-weighted sliding mean and the NCCF window energies
    take float64 prefix sums, so every column stays within its bound of
    the float64 oracle whatever the cumsum's accumulator.  With float32
    prefix sums the normalized log pitch was 3.4e-4 off (bound 3e-4)."""
    n = 120 * SR
    t = np.arange(n) / SR
    x = (0.3 * np.sin(2 * np.pi * 180 * t) + 0.1 * np.sin(2 * np.pi * 1200 * t)
         + 0.02 * np.random.default_rng(0).standard_normal(n)
         ).astype(np.float32)
    pcfg = PitchConfig()
    want = oracle.pitch(x.astype(np.float64), pcfg)
    monkeypatch.setattr(torch, "cumsum", _cumsum_in_own_dtype)
    got = pitch_model.pitch_batch(torch.from_numpy(x[None]),
                                  torch.tensor([n]), pcfg, "torch")[0][0]
    _check_columns(got.numpy()[: want.shape[0]], want)
