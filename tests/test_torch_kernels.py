"""The port's fused_raw_dit kernel module against the JAX Pallas kernel
(interpret mode on the CPU, as tests/test_kernels.py runs it), plus the
layout of the CUDA kernel's constants and its tiling.  The cases that need
the card are in tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mfcc_tpu import FeatureConfig as JaxConfig, oracle as jax_oracle
from mfcc_tpu.ops import spectrum as jax_spectrum
from mfcc_tpu.ops.kernels import fused_raw_dit as jax_kernel
from mfcc_tpu_torch import FeatureConfig, from_jax
from mfcc_tpu_torch.ops import mel, spectrum
from mfcc_tpu_torch.ops.kernels import fused_raw_dit

TOL = 2e-5   # kernel vs XLA bound of tests/test_kernels.py

# the tiny raw-DIT-eligible config of __graft_entry__.dryrun_multichip
TINY = dict(sample_rate=2000, frame_ms=40, hop_ms=16, n_fft=128, n_mels=8,
            n_mfcc=4)


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
    before = fused_raw_dit.LAUNCHES
    got = fused_raw_dit.fused_features_raw_dit(x, cfg)
    assert torch.equal(got, fused_raw_dit.plain_features(x, cfg))
    assert fused_raw_dit.LAUNCHES == before      # nothing was launched
    empty = fused_raw_dit.fused_features_raw_dit(x[:, :399], cfg)
    assert tuple(empty.shape) == (2, 0, 13)


def test_wrapper_rejects_bad_input():
    cfg = FeatureConfig()
    with pytest.raises(ValueError):
        fused_raw_dit.fused_features_raw_dit(torch.zeros(4000), cfg)
    with pytest.raises(ValueError, match="center"):
        fused_raw_dit.fused_features_raw_dit(
            torch.zeros((1, 4000)), cfg.replace(frame_mode="center"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_raw_dit.fused_features_raw_dit(torch.zeros((1, 4000)),
                                             cfg.replace(dither=1e-4))


@pytest.mark.parametrize("kw", [dict(), TINY, dict(n_fft=1024),
                                dict(sample_rate=8000, n_fft=256),
                                dict(n_fft=401, lifter=22)])
def test_kernel_constants_layout(kw):
    """Every basis block holds the float32 window-folded cos | sin columns
    of 256 consecutive bins in natural order; the last bin sits apart."""
    cfg = FeatureConfig(**kw).validate()
    basis, last, melw, dctm = fused_raw_dit._matrices(cfg)
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


def _emulate_kernel(x: np.ndarray, cfg: FeatureConfig, tm: int = 64):
    """The CUDA kernel's data flow in numpy (float64 sums): per (row, tile
    of tm frames) the audio span is staged and pre-emphasized with each
    sample's true predecessor (x[0] only at the row start), the bins come
    from the 256-wide basis blocks plus the separate last bin, then mel,
    floors, log, DCT and the energy column."""
    basis, last, melw, dctm = (a.astype(np.float64)
                               for a in fused_raw_dit._matrices(cfg))
    B, N = x.shape
    T, hop, fl = cfg.num_frames(N), cfg.hop_len, cfg.frame_len
    out = np.zeros((B, T, cfg.n_mfcc))
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
            f = np.log(np.maximum(e, floor)) @ dctm
            if cfg.append_energy:
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
                                  "fused_viterbi"])
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
