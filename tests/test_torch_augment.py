"""The port's SpecAugment and speed perturbation against the JAX package:
case for case the twins of tests/test_augment.py (with a seeded CPU
``torch.Generator`` in place of a JAX key), the mask applier fed the
draws JAX's own keys give, bit for bit, and speed perturbation against
the JAX function on the same inputs.  The CPU-vs-card mask case is in
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfcc_tpu.ops import augment as jax_augment
from mfcc_tpu_torch.ops import augment, resample


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _feat(rng, T=100, F=80):
    return torch.from_numpy(rng.standard_normal((T, F)).astype(np.float32)
                            + 5.0)


def test_deterministic_per_seed(rng):
    f = _feat(rng)
    a = augment.spec_augment(f, _gen(0))
    b = augment.spec_augment(f, _gen(0))
    c = augment.spec_augment(f, _gen(1))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert np.any(a.numpy() != c.numpy())


def test_masks_are_stripes_within_bounds(rng):
    f = _feat(rng)
    for seed in range(10):
        out = augment.spec_augment(
            f, _gen(seed), n_freq_masks=1, freq_mask_width=10,
            n_time_masks=1, time_mask_width=20).numpy()
        zero_rows = np.where((out == 0).all(axis=1))[0]
        zero_cols = np.where((out == 0).all(axis=0))[0]
        if len(zero_rows):
            assert len(zero_rows) <= 20
            assert np.all(np.diff(zero_rows) == 1)
        if len(zero_cols):
            assert len(zero_cols) <= 10
            assert np.all(np.diff(zero_cols) == 1)
        keep = out != 0
        np.testing.assert_array_equal(out[keep], f.numpy()[keep])


def test_width_zero_possible_and_masking_happens_on_average(rng):
    f = _feat(rng)
    frac = [(augment.spec_augment(f, _gen(s)).numpy() == 0).mean()
            for s in range(20)]
    assert max(frac) > 0.05
    assert np.mean(frac) < 0.9
    widths = [int(augment.draw_masks(_gen(s), 1, 100, 80).f_widths.min())
              for s in range(200)]
    assert min(widths) == 0


def test_ragged_batch_keeps_padding_zero(rng):
    B, T, F = 3, 50, 26
    f = torch.from_numpy(rng.standard_normal((B, T, F)).astype(np.float32)
                         + 5.0)
    nf = torch.tensor([50, 20, 0], dtype=torch.int32)
    f = torch.where(torch.arange(T)[None, :, None] < nf[:, None, None], f,
                    0.0)
    out = augment.spec_augment(f, _gen(0), num_frames=nf).numpy()
    assert out.shape == (B, T, F)
    np.testing.assert_array_equal(out[1, 20:], 0.0)
    np.testing.assert_array_equal(out[2], 0.0)
    m = augment.draw_masks(_gen(0), B, T, F, num_frames=nf)
    assert ((m.t_starts + m.t_widths) <= nf[:, None].long()).all()
    assert (m.t_widths[2] == 0).all()


def test_mean_fill(rng):
    f = _feat(rng)
    out = augment.spec_augment(f, _gen(5), mask_value="mean").numpy()
    fill = float(f.numpy().mean())
    changed = out != f.numpy()
    assert changed.any()
    np.testing.assert_allclose(out[changed], fill, rtol=1e-6)


def test_gradients_flow_through_unmasked(rng):
    f = _feat(rng, T=30, F=13).requires_grad_(True)
    out = augment.spec_augment(f, _gen(2))
    (out ** 2).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), 2.0 * out.detach().numpy(),
                               atol=1e-5)


def test_speed_perturb_duration_and_pitch():
    """Duration scales by 1/factor and a tone's frequency by factor (zero
    crossings); factor 1.0 is the identity."""
    sr = n = 16000
    x = torch.from_numpy(np.sin(2 * np.pi * 220.0 * np.arange(n) / sr)
                         .astype(np.float32))[None, :]
    lens = torch.tensor([n], dtype=torch.int32)
    y0, l0 = augment.speed_perturb(x, lens, 1.0, sr)
    assert y0 is x and int(l0[0]) == n
    for factor in (0.9, 1.1):
        y, l = augment.speed_perturb(x, lens, factor, sr)
        got_n = int(l[0])
        assert abs(got_n - n / factor) <= 0.01 * n / factor
        yy = y[0].numpy()[:got_n]
        zc = np.sum(np.abs(np.diff(np.signbit(yy[100:-100]))))
        f_meas = zc * sr / (2.0 * (got_n - 200))
        assert abs(f_meas - 220.0 * factor) < 6.0, (factor, f_meas)


def test_speed_perturb_ragged_lengths(rng):
    sr = 16000
    x = (0.3 * rng.standard_normal((2, sr))).astype(np.float32)
    x[1, sr // 2:] = 0.0
    lens = torch.tensor([sr, sr // 2], dtype=torch.int32)
    y, l = augment.speed_perturb(torch.from_numpy(x), lens, 1.1, sr)
    assert int(l[0]) > int(l[1])
    assert abs(int(l[1]) - (sr // 2) / 1.1) <= 200


# ---- against the JAX package ------------------------------------------------

def _jax_draws(key, B, T, F, nf=None, n_freq_masks=2, freq_mask_width=15,
               n_time_masks=2, time_mask_width=70, time_mask_frac=1.0):
    """The stripes JAX's spec_augment draws from ``key`` for a (B, T, F)
    batch, by its own split order (augment.py: per row, kf then kt, each
    mask's width then start)."""
    rows = []
    for b, k in enumerate(jax.random.split(key, B)):
        kf, kt = jax.random.split(k)
        valid = T if nf is None else int(nf[b])
        t_cap = min(time_mask_width, int(np.floor(np.float32(
            time_mask_frac) * np.float32(valid))))
        row = []
        for kk, n, cap, limit in ((kf, n_freq_masks, freq_mask_width, F),
                                  (kt, n_time_masks, t_cap, valid)):
            st, wd = [], []
            for km in jax.random.split(kk, n):
                kw, ks = jax.random.split(km)
                w = int(jax_augment._uniform_int(
                    kw, jnp.minimum(cap, jnp.asarray(limit, jnp.int32))))
                s = int(jax_augment._uniform_int(
                    ks, jnp.maximum(jnp.asarray(limit - w, jnp.int32), 0)))
                st.append(s)
                wd.append(w)
            row.append((st, wd))
        rows.append(row)
    t = lambda ax, i: torch.tensor([r[ax][i] for r in rows])
    return augment.Masks(t(0, 0), t(0, 1), t(1, 0), t(1, 1))


@pytest.mark.parametrize("kw", [
    dict(), dict(n_freq_masks=1, freq_mask_width=27, n_time_masks=3,
                 time_mask_width=40, time_mask_frac=0.2)])
@pytest.mark.parametrize("ragged", [False, True])
def test_applier_fed_jax_draws_is_bit_equal(rng, kw, ragged):
    B, T, F = 4, 120, 26
    f = rng.standard_normal((B, T, F)).astype(np.float32) + 5.0
    nf = np.array([120, 64, 7, 0], np.int32) if ragged else None
    if ragged:
        f = np.where(np.arange(T)[None, :, None] < nf[:, None, None], f, 0.0)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_augment.spec_augment_jit(
        jnp.asarray(f), key, num_frames=None if nf is None
        else jnp.asarray(nf), **kw))
    masks = _jax_draws(key, B, T, F, nf, **kw)
    got = augment.apply_masks(
        torch.from_numpy(f), masks,
        num_frames=None if nf is None else torch.from_numpy(nf)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).mean() > (f == 0).mean()   # the stripes landed


@pytest.mark.parametrize("ragged", [False, True])
def test_applier_mean_fill_matches_jax(rng, ragged):
    """Mean fill fed JAX's draws: the fill is an f32 sum whose order
    differs between the two packages, so it agrees to rounding."""
    B, T, F = 3, 80, 13
    f = rng.standard_normal((B, T, F)).astype(np.float32) + 5.0
    nf = np.array([80, 33, 1], np.int32) if ragged else None
    if ragged:
        f = np.where(np.arange(T)[None, :, None] < nf[:, None, None], f, 0.0)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax_augment.spec_augment_jit(
        jnp.asarray(f), key, mask_value="mean",
        num_frames=None if nf is None else jnp.asarray(nf)))
    got = augment.apply_masks(
        torch.from_numpy(f), _jax_draws(key, B, T, F, nf), mask_value="mean",
        num_frames=None if nf is None else torch.from_numpy(nf)).numpy()
    np.testing.assert_array_equal(got == f, want == f)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_draws_stay_in_bounds_and_need_a_cpu_generator(rng):
    nf = torch.tensor([300, 90, 5, 0])
    m = augment.draw_masks(_gen(3), 4, 300, 80, n_freq_masks=3,
                           time_mask_frac=0.3, num_frames=nf)
    assert m.f_starts.shape == (4, 3) and m.t_starts.shape == (4, 2)
    assert ((m.f_starts + m.f_widths) <= 80).all() and (m.f_widths <= 15).all()
    cap = torch.clamp(torch.floor(0.3 * nf.float()).long(), max=70)
    assert (m.t_widths <= cap[:, None]).all()
    assert ((m.t_starts + m.t_widths) <= nf[:, None]).all()
    class CardGenerator:          # a generator's device is all it reads
        device = torch.device("cuda")
    with pytest.raises(ValueError, match="CPU generator"):
        augment.draw_masks(CardGenerator(), 1, 10, 10)


@pytest.mark.parametrize("factor", [0.9, 1.1])
def test_speed_perturb_matches_jax(rng, factor):
    """The port's resampler path against the JAX function on the same
    ragged batch: lengths equal, samples to f32 GEMM rounding."""
    sr = 16000
    x = (0.3 * rng.standard_normal((3, 12_000))).astype(np.float32)
    lens = np.array([12_000, 9_001, 1], np.int32)
    x[1, 9_001:] = 0.0
    x[2, 1:] = 0.0
    y, l = augment.speed_perturb(torch.from_numpy(x), torch.from_numpy(lens),
                                 factor, sr)
    jy, jl = jax_augment.speed_perturb(jnp.asarray(x), jnp.asarray(lens),
                                       factor, sr)
    np.testing.assert_array_equal(l.numpy(), np.asarray(jl))
    assert y.shape == jy.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6)


@pytest.mark.parametrize("factor,L,M", [(0.9, 8889, 8000),
                                        (1.1, 2909, 3200)])
def test_speed_perturb_runs_the_band_not_the_dense_bank(rng, factor, L, M):
    """At 0.9 / 1.1 the ratios have L >= 128 (R = 1: no super-blocking),
    and the dense (W, L) bank would hold W ~ M + 21 rows by L columns,
    71 M entries at 0.9, nearly all zero; the port resamples through the
    band of ~21 taps a phase, whose tables stay small, and agrees with
    the float64 resampler."""
    sr_out = int(round(16000 / factor))
    assert resample.reduce_ratio(16000, sr_out) == (L, M)
    W, lo, off, G = resample._band(L, M)
    assert -(-resample._FOLD_COLUMNS // L) == 1
    assert M < W <= M + 24 and W * L > resample._DENSE_BANK_ENTRIES
    assert off.shape == G.shape == (L, off.shape[1]) and off.shape[1] <= 24
    assert int(off.min()) >= 0 and int(off.max()) < W
    assert off.numel() * 12 < 4 << 20          # < 4 MiB of tables
    x = (0.3 * rng.standard_normal((2, 4001))).astype(np.float32)
    got = resample.resample(torch.from_numpy(x), 16000, sr_out).numpy()
    for r in range(2):
        want = resample.resample_poly_numpy(x[r].astype(np.float64), 16000,
                                            sr_out)
        np.testing.assert_allclose(got[r], want, atol=1e-6, rtol=0)


def test_band_equals_the_dense_bank():
    """The band holds exactly the dense bank's nonzero taps: scattered
    back, it is the (W, L) polyphase matrix (at a ratio small enough to
    build that matrix)."""
    L, M = resample.reduce_ratio(44100, 16000)
    H, lo = resample._polyphase_matrix(L, M)
    W, lo2, off, G = resample._band(L, M)
    assert (W, lo2) == (H.shape[0], lo)
    dense = np.zeros((W, L))
    for p in range(L):
        for k in range(off.shape[1]):
            dense[off[p, k], p] += G[p, k].item()
    np.testing.assert_allclose(dense, H.astype(np.float32), rtol=0, atol=0)
