"""The port's FeatureConfig against the JAX package's: same fields in the
same order, same defaults, same derived sizes, same config_hash, and
validate() errors on the same inputs."""

import dataclasses

import pytest

from mfcc_tpu import config as jax_config
from mfcc_tpu_torch import config as torch_config

CONFIGS = [
    dict(),
    dict(lifter=22, append_energy=True),
    dict(n_mels=80, n_mfcc=80, deltas=True),
    dict(frame_mode="center"),
    dict(sample_rate=8000, n_fft=256),
]


def test_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jax_config.FeatureConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(torch_config.FeatureConfig)]
    assert tf == jf
    assert torch_config.WINDOWS == jax_config.WINDOWS
    assert torch_config.FRAME_MODES == jax_config.FRAME_MODES
    assert torch_config.MEL_SCALES == jax_config.MEL_SCALES
    assert torch_config.DFT_ALGORITHMS == jax_config.DFT_ALGORITHMS


@pytest.mark.parametrize("kw", CONFIGS)
def test_hash_and_derived_sizes_match(kw):
    j = jax_config.FeatureConfig(**kw).validate()
    t = torch_config.FeatureConfig(**kw).validate()
    assert t.to_json() == j.to_json()
    assert t.config_hash() == j.config_hash()
    for name in ("frame_len", "hop_len", "n_bins", "n_feats", "fmax_hz",
                 "center_left_pad", "center_min_samples", "dit2_eligible",
                 "dit4_eligible", "vtln_high_hz"):
        assert getattr(t, name) == getattr(j, name), name
    for n in (0, 1, 199, 200, 399, 400, 401, 560, 16000, 16001, 160000):
        assert t.num_frames(n) == j.num_frames(n), n


@pytest.mark.parametrize("kw", CONFIGS)
def test_from_jax(kw):
    j = jax_config.FeatureConfig(**kw)
    assert torch_config.from_jax(j) == torch_config.FeatureConfig(**kw)
    assert torch_config.from_jax(dataclasses.asdict(j)).config_hash() == \
        j.config_hash()


def test_from_jax_rejects_unknown_fields():
    d = dataclasses.asdict(jax_config.FeatureConfig())
    with pytest.raises(ValueError):
        torch_config.from_jax({**d, "new_field": 1})
    d.pop("lifter")
    with pytest.raises(ValueError):
        torch_config.from_jax(d)


@pytest.mark.parametrize("bad", [
    dict(window="kaiser"),
    dict(frame_mode="same"),
    dict(frame_mode="center", frame_ms=10.0, hop_ms=25.0),
    dict(mel_scale="bark"),
    dict(n_fft=256),
    dict(n_mfcc=30),
    dict(preemph=1.0),
    dict(dither=-1.0),
    dict(fmin=4000.0, fmax=3000.0),
    dict(vtln_warp=0.0),
    dict(vtln_warp=1.1, vtln_low=7000.0),
    dict(vtln_warp=1.1, vtln_high=9000.0),
    dict(n_bark=1),
    dict(lpc_order=30),
    dict(dft_algorithm="fft"),
    dict(dft_algorithm="dit2", hop_ms=10.0625),
    dict(dft_algorithm="dit4c", hop_ms=10.125),
])
def test_validate_errors_match(bad):
    with pytest.raises(ValueError) as je:
        jax_config.FeatureConfig(**bad).validate()
    with pytest.raises(ValueError) as te:
        torch_config.FeatureConfig(**bad).validate()
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("name", ["MFCC13", "LOGMEL80"])
def test_presets_match(name):
    import mfcc_tpu
    import mfcc_tpu_torch
    j, t = getattr(mfcc_tpu, name), getattr(mfcc_tpu_torch, name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.config_hash() == j.config_hash()
    assert t is getattr(torch_config, name)


@pytest.mark.parametrize("kw", [dict(), dict(n_mels=40, deltas=False),
                                dict(n_mels=128)])
def test_logmel_config_matches(kw):
    j = jax_config.logmel_config(**kw)
    t = torch_config.logmel_config(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.config_hash() == j.config_hash()
