"""The port's dither (``ops/dither``) against the JAX package's on the same
inputs: the counter hash bit for bit against the reference's ``_mix_np``
(start offsets that wrap past 2^32, per-row starts), the noise against
``noise_np`` (the float32 rounding of its float64 draw, 1e-6 relative
plus 1e-6 absolute) and ``noise_jax`` (the reference's own 2e-5 twin
bound), indexing by position, broadcast over rows; the oracle's dither
twin (1e-12); and the dithered MFCC, log-mel and PLP models against the
reference's XLA path (2e-5 cepstra, 5e-5 PLP, 1e-4 plus rtol 1e-4 log-mel)
and against the dithered float64 oracle (1e-4).  The spectrogram model is
not dithered, as the reference's is not."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mfcc_tpu import FeatureConfig as JaxConfig, oracle as jax_oracle
from mfcc_tpu.models import logmel as jax_logmel, mfcc as jax_mfcc
from mfcc_tpu.models import plp as jax_plp, spectrogram as jax_spec
from mfcc_tpu.ops import dither as jax_dither
from mfcc_tpu_torch import from_jax, oracle
from mfcc_tpu_torch.models import logmel as logmel_model, mfcc as mfcc_model
from mfcc_tpu_torch.models import plp as plp_model
from mfcc_tpu_torch.models import spectrogram as spec_model
from mfcc_tpu_torch.ops import dither

ONE_LSB = dither.KALDI_ONE_LSB
JC = JaxConfig(dither=ONE_LSB, dither_seed=7).validate()
ORACLE_TOL = 1e-4
CEPSTRA_TOL = 2e-5     # port vs the reference's XLA path, cepstra
PLP_TOL = 5e-5         # tests/test_torch_plp.py PATHS_TOL
# (seed, start, n): zero, mid-stream, starts that wrap past 2^32, a start
# beyond 2^33 and a seed beyond 32 bits (both reduced modulo 2^32)
BIT_CASES = [(7, 0, 4096), (0, 123_456_789, 1000), (3, 2**32 - 100, 300),
             (11, 2**32 - 1, 2), (5, 2**33 + 5, 64), (2**40 + 3, 17, 500)]


def _reference_bits(seed, start, n):
    """The reference's hash, written out from its ``_mix_np``."""
    idx = (np.arange(start, start + n, dtype=np.int64)
           & 0xFFFFFFFF).astype(np.uint32)
    seed_mix = (int(seed) & 0xFFFFFFFF) * int(jax_dither._PHI) & 0xFFFFFFFF
    base = jax_dither._mix_np(idx + np.uint32(seed_mix))
    return (jax_dither._mix_np(base ^ np.uint32(0x6C8E9CF5)),
            jax_dither._mix_np(base ^ np.uint32(0x94D049BB)))


@pytest.mark.parametrize("seed,start,n", BIT_CASES)
def test_hash_bits_match_mix_np(seed, start, n):
    want = _reference_bits(seed, start, n)
    got = dither.bits(seed, start, n)
    for g, w, gn in zip(got, want, dither.bits_np(seed, start, n)):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))
        np.testing.assert_array_equal(gn, w)


def test_hash_bits_per_row_starts():
    starts = [0, 400, 2**32 - 10, 2**31 + 7]
    h1, h2 = dither.bits(3, torch.tensor(starts), 600)
    assert h1.shape == (4, 600)
    for b, s in enumerate(starts):
        w1, w2 = _reference_bits(3, s, 600)
        np.testing.assert_array_equal(h1[b].numpy(), w1.astype(np.int64))
        np.testing.assert_array_equal(h2[b].numpy(), w2.astype(np.int64))


def test_products_stay_below_2_63():
    """Each split product of the hash is below 2^49 for every uint32 value,
    so no int64 multiply can overflow."""
    h = torch.tensor([0, 1, 0xFFFF, 0x10000, 0xFFFFFFFF], dtype=torch.int64)
    for c in (int(dither._C1), int(dither._C2)):
        assert int((h * (c & 0xFFFF)).max()) < 2**49
        assert int((h * (c >> 16)).max()) < 2**49
        want = [(int(v) * c) % 2**32 for v in h]
        assert dither._mul32(h, c).tolist() == want


@pytest.mark.parametrize("seed,start,n", BIT_CASES)
def test_noise_matches_numpy_and_jax(seed, start, n):
    got = dither.noise(seed, start, n)
    assert got.dtype == torch.float32 and got.shape == (n,)
    want = jax_dither.noise_np(seed, start, n)
    np.testing.assert_array_equal(dither.noise_np(seed, start, n), want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if start < 2**32:   # noise_jax takes a uint32 start
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jax_dither.noise_jax(seed, start, n)),
            rtol=2e-5, atol=2e-5)


def test_noise_is_position_indexed():
    """noise(start=k)[j] == noise(start=0)[k + j], and one (B,) tensor of
    starts gives each row its own offset into the same stream."""
    whole = dither.noise(3, 0, 1000)
    assert torch.equal(dither.noise(3, 400, 600), whole[400:])
    rows = dither.noise(3, torch.tensor([0, 250, 400]), 600)
    for b, s in enumerate((0, 250, 400)):
        assert torch.equal(rows[b], whole[s: s + 600])


def test_noise_statistics():
    z = dither.noise(0, 0, 1 << 18).double()
    assert abs(float(z.mean())) < 0.01
    assert abs(float(z.std()) - 1.0) < 0.01
    z2 = dither.noise(1, 0, 1 << 18).double()
    assert abs(float(torch.corrcoef(torch.stack([z, z2]))[0, 1])) < 0.01


@pytest.mark.parametrize("start", [0, 1234])
def test_apply_broadcasts_one_stream_over_rows(rng, start):
    cfg = from_jax(JC)
    x = (rng.standard_normal((3, 2000)) * 0.3).astype(np.float32)
    got = dither.apply(torch.from_numpy(x), cfg, start=start)
    want = np.asarray(jax_dither.apply_jax(jnp.asarray(x), JC, start=start))
    # the draws differ by an ulp or two (x dither ~1e-11); the sum rounds
    # to an ulp of the sample (6e-8 at 0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    noise = dither.apply(torch.zeros((3, 2000)), cfg, start=start)
    assert torch.equal(noise[0], noise[2])
    assert torch.equal(noise[0], cfg.dither * dither.noise(7, start, 2000))
    np.testing.assert_array_equal(
        dither.apply(torch.from_numpy(x), cfg.replace(dither=0.0)).numpy(), x)


def test_oracle_dither_twin(rng):
    x = rng.standard_normal(3000)
    np.testing.assert_array_equal(oracle._dither(x, from_jax(JC)),
                                  jax_oracle._dither(x, JC))
    for name in ("mfcc", "log_mel", "plp", "log_spectrogram"):
        np.testing.assert_allclose(getattr(oracle, name)(x, from_jax(JC)),
                                   getattr(jax_oracle, name)(x, JC),
                                   rtol=0, atol=1e-12, err_msg=name)


def _ragged(rng, dtype):
    lens = np.asarray([16000, 11000, 5000], np.int32)
    x = (rng.standard_normal((3, 16000)) * 0.3).astype(np.float32)
    for i, n in enumerate(lens):
        x[i, n:] = 0.0
    if dtype == "int16":
        x = np.round(x * 8000).astype(np.int16)
    return x, lens


def _oracle_rows(fn, x, lens, cfg):
    xf = (x.astype(np.float64) / 32768.0 if x.dtype == np.int16
          else x.astype(np.float64))
    return [fn(xf[i, :n], cfg) for i, n in enumerate(lens)]


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("kw", [dict(), dict(frame_mode="center"),
                                dict(append_energy=True, lifter=22)])
def test_dithered_mfcc_matches_jax_and_oracle(rng, dtype, kw):
    jc = JC.replace(**kw).validate()
    cfg = from_jax(jc)
    x, lens = _ragged(rng, dtype)
    want, wl, wm = jax_mfcc.mfcc_batch_jit(jnp.asarray(x), jnp.asarray(lens),
                                           jc, "xla")
    got, gl, gm = mfcc_model.mfcc_batch(torch.from_numpy(x),
                                        torch.from_numpy(lens), cfg)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    lift = oracle.lifter_coeffs(cfg.n_mfcc, cfg.lifter)
    np.testing.assert_allclose(got.numpy() / lift, np.asarray(want) / lift,
                               rtol=0, atol=CEPSTRA_TOL)
    refs = _oracle_rows(oracle.mfcc, x, lens, cfg)
    for i, ref in enumerate(refs):
        np.testing.assert_allclose(got.numpy()[i, : ref.shape[0]] / lift,
                                   ref / lift, rtol=0, atol=ORACLE_TOL)


def test_dithered_logmel_matches_jax_and_oracle(rng):
    jc = JC.replace(n_mels=40, n_mfcc=40).validate()
    cfg = from_jax(jc)
    x, lens = _ragged(rng, "float32")
    want = jax_logmel.log_mel_batch_jit(jnp.asarray(x), jnp.asarray(lens),
                                        jc, "xla")[0]
    got = logmel_model.log_mel_batch(torch.from_numpy(x),
                                     torch.from_numpy(lens), cfg)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    for i, ref in enumerate(_oracle_rows(oracle.log_mel, x, lens, cfg)):
        np.testing.assert_allclose(got.numpy()[i, : ref.shape[0]], ref,
                                   rtol=0, atol=1e-3)


def test_dithered_plp_matches_jax_and_oracle(rng):
    cfg = from_jax(JC)
    x, lens = _ragged(rng, "float32")
    want = jax_plp.plp_batch_jit(jnp.asarray(x), jnp.asarray(lens), JC,
                                 "xla")[0]
    got = plp_model.plp_batch(torch.from_numpy(x), torch.from_numpy(lens),
                              cfg)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=PLP_TOL)
    for i, ref in enumerate(_oracle_rows(oracle.plp, x, lens, cfg)):
        np.testing.assert_allclose(got.numpy()[i, : ref.shape[0]], ref,
                                   rtol=0, atol=ORACLE_TOL)
    single = plp_model.plp(torch.from_numpy(x[0]), cfg)
    np.testing.assert_allclose(single.numpy(), got.numpy()[0], rtol=0,
                               atol=1e-6)


def test_dither_breaks_the_silence_floor():
    """Why dither exists: digital silence no longer sits at the log floor."""
    cfg = from_jax(JC)
    x = torch.zeros(16000)
    plain = mfcc_model.mfcc(x, cfg.replace(dither=0.0))
    got = mfcc_model.mfcc(x, cfg)
    assert float(plain[:, 0].max() - plain[:, 0].min()) == 0.0
    assert float(got[:, 0].max() - got[:, 0].min()) > 0.0
    np.testing.assert_allclose(got.numpy(), oracle.mfcc(np.zeros(16000), cfg),
                               rtol=0, atol=ORACLE_TOL)


def test_spectrogram_model_is_not_dithered(rng):
    """The reference model never dithers the spectrogram (its oracle does);
    the port follows the model."""
    cfg = from_jax(JC)
    x, lens = _ragged(rng, "float32")
    got = spec_model.log_spectrogram_batch(torch.from_numpy(x),
                                           torch.from_numpy(lens), cfg)[0]
    plain = spec_model.log_spectrogram_batch(
        torch.from_numpy(x), torch.from_numpy(lens), cfg.replace(dither=0.0))[0]
    assert torch.equal(got, plain)
    want = np.asarray(jax_spec.log_spectrogram_batch_jit(
        jnp.asarray(x), jnp.asarray(lens), JC, "xla")[0])
    keep = want > want.max(axis=-1, keepdims=True) - np.log(1e5)
    assert np.abs(got.numpy() - want)[keep].max() < 2e-4


def test_dither_is_position_indexed_in_the_batch(rng):
    """One stream over the batch: two equal rows stay equal."""
    cfg = from_jax(JC)
    x = np.tile((rng.standard_normal(8000) * 0.3).astype(np.float32), (2, 1))
    got = mfcc_model.mfcc_batch(torch.from_numpy(x), torch.tensor([8000, 8000]),
                                cfg)[0]
    assert torch.equal(got[0], got[1])


def test_spectrogram_centre_mode_dithers_before_the_pad(rng):
    """In centre mode the reference's frame-mode resolution dithers the
    signal before its reflect pad, so its spectrogram is dithered there;
    the port's too."""
    jc = JC.replace(frame_mode="center").validate()
    x, lens = _ragged(rng, "float32")
    want = np.asarray(jax_spec.log_spectrogram_batch_jit(
        jnp.asarray(x), jnp.asarray(lens), jc, "xla")[0])
    got = spec_model.log_spectrogram_batch(
        torch.from_numpy(x), torch.from_numpy(lens), from_jax(jc))[0].numpy()
    undithered = spec_model.log_spectrogram_batch(
        torch.from_numpy(x), torch.from_numpy(lens),
        from_jax(jc).replace(dither=0.0))[0].numpy()
    keep = want > want.max(axis=-1, keepdims=True) - np.log(1e5)
    assert np.abs(got - want)[keep].max() < 2e-4
    assert np.abs(got - undithered).max() > 0.0
    one = spec_model.log_spectrogram(torch.from_numpy(x[0]), from_jax(jc))
    np.testing.assert_allclose(one.numpy(), got[0], rtol=0, atol=1e-5)
