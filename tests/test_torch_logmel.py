"""The port's log-mel model against the JAX package's on the same inputs,
the committed golden, the float64 oracle twin, and the spectral route:
which kernel wrapper each config reaches when the tensor is on the card
(``backend.resolve`` patched to "cuda"; on the CPU each wrapper then runs
its plain version)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mfcc_tpu import FeatureConfig as JaxConfig, oracle as jax_oracle
from mfcc_tpu.models import logmel as jax_logmel
from mfcc_tpu_torch import FeatureConfig, backend, from_jax, oracle
from mfcc_tpu_torch.models import logmel as logmel_model, mfcc as mfcc_model
from mfcc_tpu_torch.ops import deltas as deltas_op
from mfcc_tpu_torch.ops.kernels import (fused_deltas, fused_dit, fused_mfcc,
                                        fused_raw, fused_raw_dit, routes)
from mfcc_tpu_torch.utils import wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
LOGMEL80 = dict(n_mels=80, n_mfcc=80)
TTS = dict(sample_rate=22050, frame_ms=46.44, hop_ms=11.61, n_fft=1024,
           n_mels=80, n_mfcc=80)
HI_RATE = dict(sample_rate=44100, n_fft=2048)
WRAPPERS = {"fused_raw_dit": (fused_raw_dit, "fused_features_raw_dit"),
            "fused_raw": (fused_raw, "fused_features_raw"),
            "fused_dit": (fused_dit, "fused_features_dit"),
            "fused_mfcc": (fused_mfcc, "fused_features")}


def _ragged(rng, cfg, dtype, seconds=1.0):
    n = int(cfg.sample_rate * seconds)
    lens = np.asarray([n, n - n // 3, cfg.frame_len - 1], np.int32)
    x = (rng.standard_normal((3, n)) * 0.3).astype(np.float32)
    for i, l in enumerate(lens):
        x[i, l:] = 0.0
    if dtype == "int16":
        x = np.round(x * 8000).astype(np.int16)
    return x, lens


@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("kw", [
    dict(LOGMEL80, deltas=True),
    dict(LOGMEL80, deltas=True, dynamic_range_db=50.0),
    dict(LOGMEL80, deltas=True, frame_mode="center"),
    dict(TTS, deltas=True),
    dict(n_mels=40, n_mfcc=13, append_energy=True),   # energy: cepstra only
])
def test_log_mel_batch_matches_jax(rng, dtype, kw):
    jc = JaxConfig(**kw).validate()
    x, lens = _ragged(rng, jc, dtype)
    jf, jfl, jm = jax_logmel.log_mel_batch_jit(
        jnp.asarray(x), jnp.asarray(lens), jc, "xla")
    tf, tfl, tm = logmel_model.log_mel_batch(
        torch.from_numpy(x), torch.from_numpy(lens), from_jax(jc))
    assert tf.dtype == torch.float32 and tuple(tf.shape) == jf.shape
    assert tf.shape[-1] == jc.n_mels * (3 if jc.deltas else 1)
    np.testing.assert_array_equal(tfl.numpy(), np.asarray(jfl))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # unbounded-range log-mel is f32-limited in relative terms in deep
    # spectral valleys (values near -15 differ by ~1e-5 relative between
    # two exact-f32 pipelines; tests/test_kernels.py bounds log-mel the
    # same way); a bounded range is held to 1e-4 absolute
    rtol = 0.0 if jc.dynamic_range_db is not None else 1e-4
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-4,
                               rtol=rtol)
    assert (tf.numpy()[~tm.numpy()] == 0.0).all()


@pytest.mark.parametrize("backend_name", ["auto", "torch"])
def test_log_mel_single_matches_jax_and_oracle(rng, backend_name):
    jc = JaxConfig(**LOGMEL80, deltas=True)
    x = (rng.standard_normal(7000) * 0.3).astype(np.float32)
    want = np.asarray(jax_logmel.log_mel_jit(jnp.asarray(x), jc, "xla"))
    got = logmel_model.log_mel(torch.from_numpy(x), from_jax(jc),
                               backend_name).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        got, oracle.log_mel(x.astype(np.float64), from_jax(jc)),
        atol=1e-3, rtol=0)
    assert logmel_model.log_mel(torch.zeros(300), from_jax(jc)).shape == \
        (0, 240)


def test_log_mel_golden():
    """speech2s.wav against logmel80_deltas.npy at the 1e-3 bound of
    tests/test_golden.py for unbounded-range 80-mel log-mel."""
    cfg = FeatureConfig(**LOGMEL80, deltas=True)
    x, _ = wav.read_wav(os.path.join(GOLDEN, "speech2s.wav"))
    want = np.load(os.path.join(GOLDEN, "logmel80_deltas.npy"))
    single = logmel_model.log_mel(torch.from_numpy(x), cfg).numpy()
    batch, flens, _ = logmel_model.log_mel_batch(
        torch.from_numpy(x[None]), torch.tensor([len(x)]), cfg)
    assert single.shape == want.shape and int(flens[0]) == want.shape[0]
    np.testing.assert_allclose(single, want, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(batch[0].numpy(), single)


@pytest.mark.parametrize("kw", [
    dict(), dict(LOGMEL80, deltas=True), dict(TTS, deltas=True),
    dict(LOGMEL80, dynamic_range_db=50.0, frame_mode="center"),
])
def test_oracle_log_mel_matches_reference(rng, kw):
    jc = JaxConfig(**kw)
    x = rng.standard_normal(6000) * 0.3
    got = oracle.log_mel(x, from_jax(jc))
    want = jax_oracle.log_mel(x, jc)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert oracle.log_mel(x[:10], from_jax(jc)).shape == \
        (0, jc.n_mels * (3 if jc.deltas else 1))


# ---------------------------------------------------------------------------
# the route on the card: which wrapper each config reaches
# ---------------------------------------------------------------------------

@pytest.fixture()
def on_card(monkeypatch):
    """backend "auto" resolves to "cuda" (CPU tensors), every spectral
    wrapper records its name and input before running its plain version,
    and the deltas kernel its name and window before running its plain
    twin."""
    resolve = backend.resolve
    monkeypatch.setattr(backend, "resolve", lambda name, x, cfg: (
        "cuda" if name in ("auto", "cuda") and (
            cfg is None or routes.kernel_precision_supported(cfg))
        else resolve(name, x, cfg)))
    calls = []
    for name, (module, fn) in WRAPPERS.items():
        wrapped = getattr(module, fn)

        def record(x, cfg, *, apply_dct=True, _name=name, _fn=wrapped):
            calls.append((_name, x.clone(), apply_dct))
            return _fn(x, cfg, apply_dct=apply_dct)

        monkeypatch.setattr(module, fn, record)

    def deltas_kernel(feat, window, lengths=None):
        calls.append(("fused_deltas", feat.clone(), window))
        return deltas_op.plain_append_deltas(feat, window, lengths)

    monkeypatch.setattr(fused_deltas, "fused_append_deltas", deltas_kernel)
    return calls


@pytest.mark.parametrize("kw,cepstra,route", [
    (dict(), True, "fused_raw_dit"),                       # MFCC-13
    (dict(LOGMEL80, deltas=True), False, "fused_raw"),     # unbounded
    (dict(LOGMEL80, dynamic_range_db=50.0), False, "fused_raw_dit"),
    (dict(LOGMEL80, dynamic_range_db=60.0), False, "fused_raw"),
    (dict(TTS, deltas=True), False, "fused_dit"),
    (dict(TTS, n_mels=26, n_mfcc=13), True, "fused_dit"),
    (dict(hop_ms=12.5), True, "fused_dit"),
    (dict(sample_rate=8000, n_fft=256), True, "fused_raw_dit"),
    (HI_RATE, True, "fused_mfcc"),
    (dict(HI_RATE, **LOGMEL80), False, "fused_mfcc"),
    (dict(sample_rate=44100, n_fft=2048, frame_mode="center"), True,
     "fused_mfcc"),
])
def test_route_reaches_the_kernel_the_reference_gives(on_card, rng, kw,
                                                      cepstra, route):
    cfg = FeatureConfig(**kw).validate()
    x, lens = _ragged(rng, cfg, "int16", seconds=0.5)
    entry = mfcc_model.mfcc_batch if cepstra else logmel_model.log_mel_batch
    got, flens, mask = entry(torch.from_numpy(x), torch.from_numpy(lens), cfg)
    assert [(c[0], c[2]) for c in on_card] == [(route, cepstra)] + (
        [("fused_deltas", cfg.delta_window)] if cfg.deltas else [])
    # raw kernels take the audio; the others audio pre-emphasized on the host
    xin = on_card[0][1]
    xf = torch.from_numpy(x).to(torch.float32) / 32768.0
    if cfg.frame_mode == "valid":
        pre = torch.cat([xf[:, :1], xf[:, :-1]], dim=-1) * cfg.preemph
        want_in = xf if route in ("fused_raw_dit", "fused_raw") else xf - pre
        torch.testing.assert_close(xin, want_in, rtol=0, atol=1e-7)
    # the route's numerical form agrees with the plain direct path
    plain, pfl, pm = entry(torch.from_numpy(x), torch.from_numpy(lens), cfg,
                           "torch")
    assert torch.equal(flens, pfl) and torch.equal(mask, pm)
    if cepstra:
        lift = torch.from_numpy(oracle.lifter_coeffs(cfg.n_mfcc, cfg.lifter)
                                .astype(np.float32))
        width = cfg.n_mfcc
        d = ((got - plain)[..., :width] / lift).abs().max()
        assert float(d) <= 2e-5
    else:
        torch.testing.assert_close(got, plain, rtol=1e-4, atol=2e-5)
    assert (got[~mask] == 0).all()


@pytest.mark.parametrize("kw,cepstra,route,tile", [
    (dict(), True, "fused_raw_dit", "fft"),                 # MFCC-13
    (LOGMEL80, False, "fused_raw", "fft64"),                # unbounded
    (dict(LOGMEL80, dynamic_range_db=50.0), False, "fused_raw_dit", "fft"),
    (dict(LOGMEL80, dynamic_range_db=60.0), False, "fused_raw", "fft64"),
    (dict(LOGMEL80, n_fft=600), False, "fused_raw", "direct"),
    (TTS, False, "fused_dit", "fft64"),
    (dict(TTS, n_mels=26, n_mfcc=13), True, "fused_dit", "fft"),
    (dict(hop_ms=12.5), True, "fused_dit", "fft"),
    (dict(hop_ms=12.5, n_fft=400), True, "fused_dit", "dit"),
    (dict(sample_rate=8000, n_fft=256), True, "fused_raw_dit", "fft"),
    (HI_RATE, True, "fused_mfcc", "fft"),
    (dict(HI_RATE, **LOGMEL80), False, "fused_mfcc", "fft64"),
    (dict(HI_RATE, n_fft=1200), True, "fused_mfcc", "direct"),
])
def test_route_and_tile_per_config(kw, cepstra, route, tile):
    """The tile rule does not touch the route: each config reaches the
    kernel the reference's route gives it (``routes.spectral_route``, as
    before the FFT tile took the unbounded log-mel routes), and inside that
    kernel the tile the config picks: the f32 FFT tile for cepstra and
    log-mel <= 50 dB, the float64-front tile for other log-mel, the direct
    or DIT tile at an n_fft the FFT tile does not take."""
    from mfcc_tpu.ops.kernels import (fused_dit as jax_dit,
                                      fused_raw as jax_raw,
                                      fused_raw_dit as jax_raw_dit)
    from mfcc_tpu_torch.ops.kernels import _spectral, routes
    jc = JaxConfig(**kw).validate()
    cfg = from_jax(jc)
    use_dit = cepstra or (jc.dynamic_range_db is not None
                          and jc.dynamic_range_db <= 50.0)
    if use_dit and jax_raw_dit.raw_dit_kernel_eligible(jc):
        reference = "fused_raw_dit"
    elif jax_raw.raw_kernel_eligible(jc):
        reference = "fused_raw"
    else:
        reference = ("fused_dit" if jax_dit.dit_kernel_eligible(jc)
                     else "fused_mfcc")
    assert routes.spectral_route(cfg, cepstra) == reference == route
    picked = _spectral.fft_tile(cfg, cepstra)
    assert (picked if picked != "direct" or route != "fused_dit"
            else "dit") == tile


def test_cpu_tensors_stay_on_the_plain_direct_path(rng, monkeypatch):
    """Without a card no wrapper is called: the CPU path is the plain
    direct form whatever the config's route."""
    for name, (module, fn) in WRAPPERS.items():
        monkeypatch.setattr(module, fn, lambda *a, _n=name, **k: (
            pytest.fail(f"{_n} reached on the CPU")))
    for kw in (dict(TTS), HI_RATE, LOGMEL80):
        cfg = FeatureConfig(**kw)
        x, lens = _ragged(rng, cfg, "float32", seconds=0.25)
        logmel_model.log_mel_batch(torch.from_numpy(x),
                                   torch.from_numpy(lens), cfg)
        mfcc_model.mfcc_batch(torch.from_numpy(x), torch.from_numpy(lens),
                              cfg.replace(n_mfcc=13))


def test_plain_valley_bands_against_jax():
    """Unbounded log-mel-80 on the bench batch (64 x 10 s,
    ``mfcc_tpu_torch/tools/plain_valley.py``), per band against the
    float64 oracle over every row: the reference's XLA path and the port's
    plain path, both on the CPU, sit at the same f32 valley floor in the
    same bands (0-3, near DC after pre-emphasis), the port within 1.5x of
    the reference there and over the other bands.  Prints both per band
    (run with -s)."""
    from mfcc_tpu_torch.tools import plain_valley
    audio = plain_valley.bench_batch()
    jc = JaxConfig(**LOGMEL80).validate()
    cfg = from_jax(jc)
    jf = np.asarray(jax_logmel.log_mel_batch_jit(
        jnp.asarray(audio), jnp.full((audio.shape[0],), audio.shape[1],
                                     jnp.int32), jc, "xla")[0])
    pf = fused_raw.plain_features(torch.from_numpy(audio), cfg, False).numpy()
    jax_bands = plain_valley.logmel_band_errors(jf, audio, cfg).max(axis=0)
    port_bands = plain_valley.logmel_band_errors(pf, audio, cfg).max(axis=0)
    print("band  jax-xla-cpu  port-plain-cpu")
    for j in range(cfg.n_mels):
        print(f"{j:4d}  {jax_bands[j]:.4e}  {port_bands[j]:.4e}")
    assert set(np.argsort(jax_bands)[-2:]) <= {0, 1, 2, 3}
    assert set(np.argsort(port_bands)[-2:]) <= {0, 1, 2, 3}
    assert port_bands.max() <= 1.5 * jax_bands.max()
    assert port_bands[4:].max() <= 1.5 * jax_bands[4:].max()
