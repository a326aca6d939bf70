"""The port's oracle, constant builders and plain ops against the JAX
package's, on the same numpy-seeded inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mfcc_tpu import FeatureConfig as JaxConfig, oracle as jax_oracle
from mfcc_tpu.ops import (dct as jax_dct, deltas as jax_deltas,
                          framing as jax_framing, mel as jax_mel,
                          spectrum as jax_spectrum, xmath as jax_xmath)
from mfcc_tpu_torch import from_jax, oracle
from mfcc_tpu_torch.ops import (dct, deltas, framing, mel, spectrum,
                                xmath)

MEL_CONFIGS = [
    dict(),                                          # HTK
    dict(mel_scale="slaney", n_mels=40),             # Slaney
    dict(vtln_warp=1.1),                             # VTLN
    dict(vtln_warp=0.9, fmin=20.0, fmax=7600.0),
    dict(sample_rate=8000, n_fft=256, n_mels=20, lifter=22, n_mfcc=12),
]


@pytest.mark.parametrize("kw", MEL_CONFIGS)
def test_constants_equal_reference_builders(kw):
    jc = JaxConfig(**kw).validate()
    tc = from_jax(jc)
    np.testing.assert_array_equal(oracle.mel_filterbank(tc),
                                  jax_oracle.mel_filterbank(jc))
    np.testing.assert_array_equal(mel.mel_matrix(tc), jax_mel.mel_matrix(jc))
    np.testing.assert_array_equal(dct.dct_matrix(tc), jax_dct.dct_matrix(jc))
    for a, b in zip(spectrum.dft_matrices(tc), jax_spectrum.dft_matrices(jc)):
        np.testing.assert_array_equal(a, b)
    f = np.linspace(0.0, jc.fmax_hz, 97)
    np.testing.assert_array_equal(oracle.vtln_warp_freq(f, tc),
                                  jax_oracle.vtln_warp_freq(f, jc))
    for scale in ("htk", "slaney"):
        np.testing.assert_array_equal(oracle.hz_to_mel(f, scale),
                                      jax_oracle.hz_to_mel(f, scale))
        m = oracle.hz_to_mel(f, scale)
        np.testing.assert_array_equal(oracle.mel_to_hz(m, scale),
                                      jax_oracle.mel_to_hz(m, scale))


@pytest.mark.parametrize("kind", ["hamming", "hann", "povey", "rect"])
def test_window_dct_lifter_equal(kind):
    np.testing.assert_array_equal(oracle.window_fn(kind, 400),
                                  jax_oracle.window_fn(kind, 400))
    np.testing.assert_array_equal(oracle.dct_matrix(13, 26),
                                  jax_oracle.dct_matrix(13, 26))
    for lifter in (0, 22):
        np.testing.assert_array_equal(oracle.lifter_coeffs(13, lifter),
                                      jax_oracle.lifter_coeffs(13, lifter))


@pytest.mark.parametrize("kw", [
    dict(), dict(lifter=22, append_energy=True), dict(deltas=True),
    dict(frame_mode="center"), dict(dynamic_range_db=60.0),
    dict(mel_scale="slaney", vtln_warp=1.1, preemph=0.0, window="povey"),
])
def test_oracle_mfcc_equals_reference(rng, kw):
    jc = JaxConfig(**kw).validate()
    x = rng.standard_normal(4321) * 0.3
    np.testing.assert_array_equal(oracle.mfcc(x, from_jax(jc)),
                                  jax_oracle.mfcc(x, jc))
    np.testing.assert_array_equal(oracle.frame_signal(x, from_jax(jc)),
                                  jax_oracle.frame_signal(x, jc))
    assert oracle.mfcc(x[:100], from_jax(jc)).shape == (0, jc.n_feats)


def test_oracle_dither_not_ported():
    """Dither is ported now: the oracle adds the reference's float64 noise
    (tests/test_torch_dither.py holds the rest)."""
    jc = JaxConfig(dither=1e-4)
    np.testing.assert_array_equal(oracle.mfcc(np.zeros(1000), from_jax(jc)),
                                  jax_oracle.mfcc(np.zeros(1000), jc))


def _log_inputs():
    rng = np.random.default_rng(5)
    x = np.float32(10.0) ** rng.uniform(-30, 30, 20000).astype(np.float32)
    s = np.float32(np.sqrt(2.0))
    p2 = np.float32(2.0) ** np.arange(-40, 41, dtype=np.float32)
    edges = np.concatenate([np.nextafter(s, np.float32(0)) * p2, s * p2,
                            np.nextafter(s, np.float32(2)) * p2, p2,
                            np.float32([1e-30, 1e30])])
    return np.concatenate([x, edges.astype(np.float32)])


def test_accurate_log_bit_identical():
    """Bit-identical to the reference's op-by-op function over 1e-30..1e30,
    both sides of sqrt(2) included."""
    x = _log_inputs()
    want = np.asarray(jax_xmath.accurate_log(jnp.asarray(x)))
    got = xmath.accurate_log(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_allclose(got, np.log(x.astype(np.float64)),
                               rtol=3e-7, atol=1e-6)


def test_accurate_log_within_one_ulp_of_jitted_reference():
    """Under jit, XLA's CPU compiler contracts the Horner steps into FMAs,
    so the jitted reference differs from the op-by-op definition (and
    from the port, which rounds every step) by at most one ulp."""
    x = _log_inputs()
    want = np.asarray(jax.jit(jax_xmath.accurate_log)(jnp.asarray(x)))
    got = xmath.accurate_log(torch.from_numpy(x)).numpy()
    ulp = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulp.max() <= 1


def test_accurate_log_gradient_and_floor():
    x = torch.tensor([1e-20, 1e-3, 0.5, 1.0, 1.4142135, 7.0, 3e8],
                     requires_grad=True)
    xmath.accurate_log(x).sum().backward()
    torch.testing.assert_close(x.grad, 1.0 / x.detach(), rtol=0, atol=0)
    y = torch.tensor([0.0, 1e-12, 1.0])
    want = np.asarray(jax_xmath.floored_log(jnp.asarray(y.numpy()), 1e-10))
    np.testing.assert_array_equal(xmath.floored_log(y, 1e-10).numpy(), want)


@pytest.mark.parametrize("preemph", [0.97, 0.0])
def test_preemphasize(rng, preemph):
    cfg = JaxConfig(preemph=preemph)
    x = (rng.standard_normal((3, 1001)) * 0.3).astype(np.float32)
    want = np.asarray(jax_framing.preemphasize(jnp.asarray(x), cfg))
    got = framing.preemphasize(torch.from_numpy(x), from_jax(cfg)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("N,lengths", [
    (16000, [16000, 12345, 4000, 150]),   # one row below center_min_samples
    (150, [150, 100, 0]),                 # N < center_min_samples: narrow pad
    (1000, [1000, 999, 200]),
])
def test_center_pad_batch(rng, N, lengths):
    cfg = JaxConfig(frame_mode="center")
    x = (rng.standard_normal((len(lengths), N)) * 0.3).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    jp, jl = jax_framing.center_pad_batch(jnp.asarray(x), jnp.asarray(lens),
                                          cfg)
    tp, tl = framing.center_pad_batch(torch.from_numpy(x),
                                      torch.from_numpy(lens), from_jax(cfg))
    assert tuple(tp.shape) == jp.shape
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    sp = framing.center_pad_static(torch.from_numpy(x[0]), from_jax(cfg))
    np.testing.assert_array_equal(
        sp.numpy(), np.asarray(jax_framing.center_pad_static(
            jnp.asarray(x[0]), cfg)))


@pytest.mark.parametrize("window", [1, 2, 3])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_deltas_padding_aware(rng, window, with_lengths):
    feat = rng.standard_normal((3, 40, 5)).astype(np.float32)
    lens = np.asarray([40, 23, 1], np.int32) if with_lengths else None
    want = np.asarray(jax_deltas.deltas(
        jnp.asarray(feat), window,
        None if lens is None else jnp.asarray(lens)))
    got = deltas.deltas(torch.from_numpy(feat), window,
                        None if lens is None else torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    cfg = JaxConfig(deltas=True, delta_window=window)
    want3 = np.asarray(jax_deltas.append_deltas(
        jnp.asarray(feat), cfg, None if lens is None else jnp.asarray(lens)))
    got3 = deltas.append_deltas(torch.from_numpy(feat), from_jax(cfg),
                                None if lens is None else torch.from_numpy(lens))
    np.testing.assert_allclose(got3.numpy(), want3, atol=1e-6, rtol=0)


@pytest.mark.parametrize("on_card,precision", [
    (False, "highest"), (False, "high"), (True, "high")])
@pytest.mark.parametrize("window", [1, 2, 3])
def test_append_deltas_plain_route_matches_jax(monkeypatch, rng, on_card,
                                               precision, window):
    """On a CPU tensor, and under "high" on a card (``backend.resolve``
    faked as it routes there), ``append_deltas`` takes the plain chain,
    never the kernel, and matches the JAX reference."""
    from mfcc_tpu_torch import backend
    from mfcc_tpu_torch.ops.kernels import fused_deltas, routes

    def kernel(*args, **kwargs):
        raise AssertionError("the kernel route was taken")
    monkeypatch.setattr(fused_deltas, "fused_append_deltas", kernel)
    if on_card:
        monkeypatch.setattr(backend, "resolve", lambda name, x, cfg: (
            "cuda" if name != "torch" and routes.kernel_precision_supported(
                cfg) else "torch"))
    feat = rng.standard_normal((3, 40, 5)).astype(np.float32)
    lens = np.asarray([40, 23, 1], np.int32)
    cfg = JaxConfig(deltas=True, delta_window=window,
                    matmul_precision=precision)
    want = np.asarray(jax_deltas.append_deltas(
        jnp.asarray(feat), cfg, jnp.asarray(lens)))
    got = deltas.append_deltas(torch.from_numpy(feat), from_jax(cfg),
                               torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_stages_match_reference(rng):
    """Power spectrum, log-mel (with the relative floor), cepstra and frame
    energy of the plain path against the JAX stages, same frames."""
    jc = JaxConfig(dynamic_range_db=60.0, lifter=22).validate()
    tc = from_jax(jc)
    x = (rng.standard_normal((2, 4000)) * 0.3).astype(np.float32)
    jfr = jax_framing.frame(jnp.asarray(x), jc)
    tfr = framing.frames(framing.preemphasize(torch.from_numpy(x), tc), tc)
    np.testing.assert_allclose(tfr.numpy(), np.asarray(jfr), atol=1e-6, rtol=0)
    jp = jax_spectrum.power_spectrum(jfr, jc)
    tp = spectrum.power_spectrum(tfr, tc)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=2e-5,
                               atol=2e-5)
    jl = jax_mel.log_mel_energies(jp, jc)
    tl = mel.log_mel_energies(torch.from_numpy(np.array(jp)), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5, rtol=0)
    np.testing.assert_allclose(
        dct.cepstra(torch.from_numpy(np.array(jl)), tc).numpy(),
        np.asarray(jax_dct.cepstra(jl, jc)), atol=2e-5, rtol=0)
    np.testing.assert_allclose(
        framing.log_energy(tfr, tc).numpy(),
        np.asarray(jax_framing.log_energy(jfr, jc)), atol=1e-6, rtol=0)
