"""The port's log spectrogram against the JAX package's on the same inputs:
the float64 oracle twin (1e-12, and the committed golden), the reference's
XLA path and its Pallas kernel route in interpret mode, ``spectrogram257``
and the oracle, all within 2e-4 inside the 50 dB window (the family's
contract, ``docs/conventions.md``, held so by ``tests/test_golden.py``:
below the window an f32 spectrogram is floor-limited); batch frame counts,
masks and zeroing exactly as the reference's; and the route on the card
(the kernel wrapper with ``projection="spec"`` where the reference's
``spec_kernel_eligible`` holds, else the plain chain)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mfcc_tpu import FeatureConfig as JaxConfig, oracle as jax_oracle
from mfcc_tpu.models import spectrogram as jax_spec
from mfcc_tpu.ops.kernels import fused_raw_dit as jax_raw_dit
from mfcc_tpu_torch import FeatureConfig, backend, from_jax, oracle
from mfcc_tpu_torch.models import spectrogram as spec_model
from mfcc_tpu_torch.ops.kernels import fused_raw_dit, routes
from mfcc_tpu_torch.utils import wav

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
WINDOW_TOL = 2e-4     # inside the 50 dB window of each frame's peak
TWIN_TOL = 1e-12


def _window_err(got, want, db=50.0):
    """Max abs error over the bins within ``db`` of their frame's peak in
    ``want`` (the reference's 50 dB window, tests/test_golden.py:67-73)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.size == 0:
        return 0.0
    keep = want > want.max(axis=-1, keepdims=True) - np.log(10.0 ** (db / 10))
    return float(np.abs(got - want)[keep].max())


@pytest.mark.parametrize("kw", [dict(), dict(n_fft=1024, window="hann"),
                                dict(sample_rate=8000, n_fft=256),
                                dict(frame_mode="center", preemph=0.0)])
def test_oracle_log_spectrogram_matches_reference(rng, kw):
    jc = JaxConfig(**kw).validate()
    x = rng.standard_normal(7000) * 0.3
    got = oracle.log_spectrogram(x, from_jax(jc))
    np.testing.assert_allclose(got, jax_oracle.log_spectrogram(x, jc),
                               rtol=0, atol=TWIN_TOL)
    assert oracle.log_spectrogram(x[:10], from_jax(jc)).shape == \
        (0, jc.n_bins)


def test_oracle_and_port_golden():
    """The oracle twin equals spectrogram257.npy (1e-12); the port's plain
    f32 chain holds it within 2e-4 in the 50 dB window."""
    x, _ = wav.read_wav(os.path.join(GOLDEN, "speech2s.wav"))
    want = np.load(os.path.join(GOLDEN, "spectrogram257.npy"))
    np.testing.assert_allclose(
        oracle.log_spectrogram(x.astype(np.float64), FeatureConfig()), want,
        rtol=0, atol=TWIN_TOL)
    got = spec_model.log_spectrogram(torch.from_numpy(x),
                                     FeatureConfig()).numpy()
    assert _window_err(got, want) < WINDOW_TOL
    batch, flens, _ = spec_model.log_spectrogram_batch(
        torch.from_numpy(x[None]), torch.tensor([len(x)]), FeatureConfig())
    assert int(flens[0]) == want.shape[0]
    np.testing.assert_array_equal(batch[0].numpy(), got)


@pytest.mark.parametrize("kw", [dict(), dict(n_fft=1024), dict(n_fft=400),
                                dict(window="hann", preemph=0.0),
                                dict(sample_rate=8000, n_fft=256)])
def test_log_spectrogram_matches_jax_paths_and_oracle(rng, kw):
    """One utterance on a CPU tensor against the reference's XLA path, its
    Pallas spec route in interpret mode (where spec_kernel_eligible holds;
    XLA elsewhere, as the reference routes it) and the oracle."""
    jc = JaxConfig(**kw).validate()
    x = (0.3 * rng.standard_normal(jc.sample_rate // 2)).astype(np.float32)
    got = spec_model.log_spectrogram(torch.from_numpy(x), from_jax(jc)).numpy()
    assert got.shape == (jc.num_frames(len(x)), jc.n_bins)
    for path in ("xla", "pallas"):
        want = np.asarray(jax_spec.log_spectrogram_jit(jnp.asarray(x), jc,
                                                       path))
        assert _window_err(got, want) < WINDOW_TOL, path
    assert _window_err(got, oracle.log_spectrogram(x.astype(np.float64),
                                                   from_jax(jc))) < WINDOW_TOL


@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("kw", [dict(), dict(frame_mode="center"),
                                dict(n_fft=1024)])
def test_log_spectrogram_batch_matches_jax(rng, dtype, kw):
    jc = JaxConfig(**kw).validate()
    n = jc.sample_rate // 2
    lens = np.asarray([n, n - n // 3, jc.frame_len, jc.frame_len - 1],
                      np.int32)
    x = (rng.standard_normal((4, n)) * 0.3).astype(np.float32)
    for i, l in enumerate(lens):
        x[i, l:] = 0.0
    if dtype == "int16":
        x = np.round(x * 8000).astype(np.int16)
    jf, jfl, jm = jax_spec.log_spectrogram_batch_jit(
        jnp.asarray(x), jnp.asarray(lens), jc, "xla")
    tf, tfl, tm = spec_model.log_spectrogram_batch(
        torch.from_numpy(x), torch.from_numpy(lens), from_jax(jc))
    assert tf.dtype == torch.float32 and tuple(tf.shape) == jf.shape
    np.testing.assert_array_equal(tfl.numpy(), np.asarray(jfl))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    m = tm.numpy()
    assert (tf.numpy()[~m] == 0.0).all()
    assert _window_err(tf.numpy()[m], np.asarray(jf)[m]) < WINDOW_TOL
    xf = x.astype(np.float64) / (32768.0 if dtype == "int16" else 1.0)
    for i, l in enumerate(lens):
        want = oracle.log_spectrogram(xf[i, :l], from_jax(jc))
        assert _window_err(tf[i, : want.shape[0]].numpy(), want) < WINDOW_TOL


@pytest.fixture()
def on_card(monkeypatch):
    """backend "auto" resolves to "cuda" (CPU tensors), and the
    fused_raw_dit wrapper records each call before running its plain
    version."""
    resolve = backend.resolve
    monkeypatch.setattr(backend, "resolve", lambda name, x, cfg: (
        "cuda" if name in ("auto", "cuda") and (
            cfg is None or routes.kernel_precision_supported(cfg))
        else resolve(name, x, cfg)))
    calls = []
    wrapped = fused_raw_dit.fused_features_raw_dit

    def record(x, cfg, *, apply_dct=True, projection="mel"):
        calls.append((apply_dct, projection))
        return wrapped(x, cfg, apply_dct=apply_dct, projection=projection)

    monkeypatch.setattr(fused_raw_dit, "fused_features_raw_dit", record)
    return calls


@pytest.mark.parametrize("kw,kernel", [
    (dict(), True), (dict(n_fft=1024), True),
    (dict(n_fft=768), True),                        # the direct tile
    (dict(sample_rate=8000, n_fft=256), True),
    (dict(n_fft=400), False),                       # n_fft / 2 = 200
    (dict(sample_rate=44100, n_fft=2048), False),   # odd hop 441
    (dict(frame_mode="center"), True),
])
def test_spectrogram_route_per_config(on_card, rng, kw, kernel):
    """On the card the spectrogram reaches fused_raw_dit with the spec
    projection exactly where the reference's spec_kernel_eligible holds
    (n_fft 512 and 1024 yes, 400 no), else the plain chain; either way the
    features equal the plain CPU path's."""
    cfg = FeatureConfig(**kw).validate()
    assert routes.spec_kernel_eligible(cfg) == kernel == \
        jax_raw_dit.spec_kernel_eligible(JaxConfig(**kw).validate())
    n = cfg.sample_rate // 4
    x = (0.3 * rng.standard_normal((2, n))).astype(np.float32)
    lens = torch.tensor([n, n // 2])
    got, flens, mask = spec_model.log_spectrogram_batch(torch.from_numpy(x),
                                                        lens, cfg)
    assert on_card == ([(False, "spec")] if kernel else [])
    plain, pfl, pm = spec_model.log_spectrogram_batch(torch.from_numpy(x),
                                                      lens, cfg, "torch")
    assert torch.equal(flens, pfl) and torch.equal(mask, pm)
    assert torch.equal(got, plain)


def test_spectrogram_unported_options_raise(rng):
    """Only an accum_dtype JAX could not name raises; the precision modes,
    bf16 compute and bf16 accumulation (ROADMAP modules item 2.4) compute,
    equal to the reference's XLA path inside the 50 dB window."""
    with pytest.raises(ValueError, match="accum_dtype"):
        spec_model.log_spectrogram(torch.zeros(4000),
                                   FeatureConfig(accum_dtype="int32"))
    with pytest.raises(ValueError, match="accum_dtype"):
        spec_model.log_spectrogram_batch(torch.zeros((1, 4000)),
                                         torch.tensor([4000]),
                                         FeatureConfig(accum_dtype="int32"))
    sig = (rng.standard_normal(8000) * 0.3).astype(np.float32)
    for kw in (dict(matmul_precision="high"), dict(compute_dtype="bfloat16"),
               dict(accum_dtype="bfloat16")):
        jc = JaxConfig(**kw).validate()
        # bf16 accumulation: the spectrogram's bound there, a flipped
        # bfloat16 rounding of one bin (tests/test_torch_accum.py)
        tol = 3.1e-2 if "accum_dtype" in kw else WINDOW_TOL
        want = np.asarray(jax_spec.log_spectrogram_jit(jnp.asarray(sig), jc))
        got = spec_model.log_spectrogram(torch.from_numpy(sig), from_jax(jc))
        assert _window_err(got.numpy(), want) < tol
        got, _, _ = spec_model.log_spectrogram_batch(
            torch.from_numpy(sig)[None], torch.tensor([8000]), from_jax(jc))
        assert _window_err(got[0].numpy(), want) < tol
