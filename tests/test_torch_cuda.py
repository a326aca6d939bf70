"""Cases that need an NVIDIA GPU: the CUDA kernel against its plain PyTorch
version on the card, the wrapper's checks, and the main path through the
kernel.  All are marked ``cuda`` and skip without a card.

This file imports no jax (the machine with the card has none), so it runs
there without the repository's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

from mfcc_tpu_torch import FeatureConfig, oracle
from mfcc_tpu_torch.models import mfcc as mfcc_model
from mfcc_tpu_torch.ops.kernels import fused_raw_dit
from mfcc_tpu_torch.utils import wav

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
TOL = 2e-5   # kernel vs XLA bound of tests/test_kernels.py
TINY = dict(sample_rate=2000, frame_ms=40, hop_ms=16, n_fft=128, n_mels=8,
            n_mfcc=4)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.fixture()
def gen():
    return np.random.default_rng(1234)


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
    before = fused_raw_dit.LAUNCHES
    got = fused_raw_dit.fused_features_raw_dit(x, cfg)
    torch.cuda.synchronize()
    assert fused_raw_dit.LAUNCHES == before + 1
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_raw_dit.fused_features_raw_dit(
            torch.zeros((1, 4000), device=cuda), cfg, apply_dct=False)
    before = fused_raw_dit.LAUNCHES
    out = fused_raw_dit.fused_features_raw_dit(
        torch.zeros((2, 399), device=cuda), cfg)
    assert tuple(out.shape) == (2, 0, 13)
    assert fused_raw_dit.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(deltas=True),
                                dict(frame_mode="center")])
def test_mfcc_batch_goes_through_the_kernel(cuda, gen, kw):
    cfg = FeatureConfig(**kw)
    lens = np.asarray([16000, 10666, 399], np.int32)
    x = np.round(gen.standard_normal((3, 16000)) * 8000).astype(np.int16)
    for i, n in enumerate(lens):
        x[i, n:] = 0
    before = fused_raw_dit.LAUNCHES
    gf, gfl, gm = mfcc_model.mfcc_batch(torch.from_numpy(x).to(cuda),
                                        torch.from_numpy(lens).to(cuda), cfg)
    torch.cuda.synchronize()
    assert fused_raw_dit.LAUNCHES == before + 1
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
