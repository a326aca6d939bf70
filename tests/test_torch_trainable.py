"""The port's trainable front end against the JAX package: case for case
the twins of tests/test_trainable.py (all but the graft-entry case), plus
the forward pass, five fit steps, the clip and cosine schedule, and the
checkpoint hand-over against the JAX functions on the same inputs.  The
card-vs-CPU forward case is in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mfcc_tpu import config as jax_config
from mfcc_tpu.models import trainable as jax_trainable
from mfcc_tpu_torch import FeatureConfig, from_jax
from mfcc_tpu_torch.models import mfcc as mfcc_model, trainable

# tiny config keeps the CPU fast (the reference test's)
CFG = FeatureConfig(sample_rate=2000, frame_ms=25, hop_ms=10, n_fft=64,
                    n_mels=8, n_mfcc=4).validate()
JCFG = jax_config.FeatureConfig(**{k: getattr(CFG, k)
                                   for k in CFG.__dataclass_fields__})


def _data(rng, B=4, N=2000):
    audio = (rng.standard_normal((B, N)) * 0.3).astype(np.float32)
    return audio, np.full((B,), N, np.int32)


def _target(audio, scale=1.5):
    tgt = trainable.init_params(CFG, "cpu")
    with torch.no_grad():
        tgt.mel_w.mul_(scale)
    return trainable.forward(tgt, torch.from_numpy(audio), CFG).detach()


def test_forward_at_init_matches_classic(rng):
    audio, lens = _data(rng)
    params = trainable.init_params(CFG, "cpu")
    got = params(torch.from_numpy(audio), CFG).detach().numpy()
    want = mfcc_model.mfcc_batch(torch.from_numpy(audio),
                                 torch.from_numpy(lens), CFG)[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_training_recovers_perturbed_filterbank(rng):
    """The target comes from the same model with a 1.5x filterbank, so the
    optimum is reachable and the landscape benign."""
    audio, _ = _data(rng)
    params, losses = trainable.fit(audio, _target(audio).numpy(), CFG,
                                   steps=200, lr=3e-3, device="cpu")
    assert losses[-1] < 0.1 * losses[0], losses[::50]
    assert torch.isfinite(params.mel_w).all()
    assert (params.mel_w >= 0).all()           # the projection held


def test_gradients_nonzero(rng):
    audio, _ = _data(rng, B=2)
    params = trainable.init_params(CFG, "cpu")
    target = torch.zeros((2, CFG.num_frames(2000), CFG.n_mfcc))
    trainable.loss_fn(params, torch.from_numpy(audio), target, CFG).backward()
    assert float(params.mel_w.grad.abs().max()) > 0
    assert float(params.log_floor.grad.abs().max()) >= 0


def test_checkpoint_roundtrip(tmp_path):
    params = trainable.init_params(CFG, "cpu")
    with torch.no_grad():
        params.mel_w.mul_(1.23)
    p = str(tmp_path / "frontend.npz")
    trainable.save_params(p, params, CFG)
    back = trainable.load_params(p, CFG, device="cpu")
    np.testing.assert_array_equal(back.mel_w.detach().numpy(),
                                  params.mel_w.detach().numpy())
    with pytest.raises(ValueError):
        trainable.load_params(p, CFG.replace(n_mels=16, n_mfcc=8),
                              device="cpu")


# ---- against the JAX package ------------------------------------------------

def test_init_and_forward_match_jax(rng):
    audio, _ = _data(rng)
    jp = jax_trainable.init_params(JCFG)
    params = trainable.init_params(CFG, "cpu")
    np.testing.assert_array_equal(params.mel_w.detach().numpy(),
                                  np.asarray(jp.mel_w))
    np.testing.assert_array_equal(params.log_floor.detach().numpy(),
                                  np.asarray(jp.log_floor))
    jp = jp._replace(mel_w=jp.mel_w * 1.3)
    got = trainable.forward(trainable.params_from_jax(jp, "cpu"),
                            torch.from_numpy(audio), CFG).detach().numpy()
    want = np.asarray(jax_trainable.forward(jp, jnp.asarray(audio), JCFG))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_five_fit_steps_match_jax(rng):
    """Five steps from the same init on the same data: losses within rtol
    1e-4 and parameters within 2e-6 of JAX's (a step moves an entry by at
    most lr = 1e-3)."""
    audio, _ = _data(rng)
    target = _target(audio).numpy()
    jparams, jlosses = jax_trainable.fit(audio, target, JCFG, steps=5,
                                         lr=1e-3)
    params, losses = trainable.fit(audio, target, CFG, steps=5, lr=1e-3,
                                   device="cpu")
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    np.testing.assert_allclose(params.mel_w.detach().numpy(),
                               np.asarray(jparams.mel_w), rtol=0, atol=2e-6)
    np.testing.assert_allclose(params.log_floor.detach().numpy(),
                               np.asarray(jparams.log_floor), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("scale", [0.3, 1.0, 40.0])
def test_clip_and_cosine_schedule_match_optax(rng, scale):
    """A hand-made gradient through the port's clip, Adam and LambdaLR
    against optax's chain on the same parameters, step by step over a
    decay that ends inside the run; below the clip norm the gradient
    passes unchanged."""
    D, steps, lr = 4, 6, 1e-2
    w0 = rng.standard_normal((5, 3)).astype(np.float32)
    f0 = rng.standard_normal(3).astype(np.float32)
    grads = [(scale * rng.standard_normal((5, 3)).astype(np.float32),
              scale * rng.standard_normal(3).astype(np.float32))
             for _ in range(steps)]
    params = trainable.FrontendParams(torch.from_numpy(w0),
                                      torch.from_numpy(f0))
    opt = trainable.make_optimizer(params, lr, decay_steps=D)
    jopt = jax_trainable.make_optimizer(lr, decay_steps=D)
    jp = jax_trainable.FrontendParams(jnp.asarray(w0), jnp.asarray(f0))
    state = jopt.init(jp)
    for s, (gw, gf) in enumerate(grads):
        gs = [torch.from_numpy(gw.copy()), torch.from_numpy(gf.copy())]
        trainable.clip_by_global_norm_(gs, 1.0)
        norm = float(np.sqrt((gw.astype(np.float64) ** 2).sum()
                             + (gf.astype(np.float64) ** 2).sum()))
        if norm < 1.0:
            np.testing.assert_array_equal(gs[0].numpy(), gw)
        else:
            np.testing.assert_allclose(gs[0].numpy(), gw / norm, rtol=1e-6)
        assert opt.adam.param_groups[0]["lr"] == pytest.approx(
            lr * trainable.cosine_decay(s, D), rel=1e-12)
        assert trainable.cosine_decay(s, D) == pytest.approx(float(
            optax.cosine_decay_schedule(1.0, D)(s)), rel=1e-6)
        params.mel_w.grad, params.log_floor.grad = gs
        opt.adam.step()
        opt.schedule.step()
        upd, state = jopt.update(
            jax_trainable.FrontendParams(jnp.asarray(gw), jnp.asarray(gf)),
            state, jp)
        jp = optax.apply_updates(jp, upd)
        np.testing.assert_allclose(params.mel_w.detach().numpy(),
                                   np.asarray(jp.mel_w), rtol=0, atol=1e-6)
        np.testing.assert_allclose(params.log_floor.detach().numpy(),
                                   np.asarray(jp.log_floor), rtol=0,
                                   atol=1e-6)
    assert opt.adam.param_groups[0]["lr"] == 0.0   # decayed to 0 at D


def test_checkpoints_cross_packages(tmp_path):
    """A checkpoint written by JAX loads in the port and one written by the
    port loads in JAX: the same keys and the same config hash."""
    jp = jax_trainable.init_params(JCFG)
    jp = jp._replace(mel_w=jp.mel_w * 0.77, log_floor=jp.log_floor + 1.5)
    a = str(tmp_path / "jax.npz")
    jax_trainable.save_params(a, jp, JCFG)
    got = trainable.load_params(a, from_jax(JCFG), device="cpu")
    np.testing.assert_array_equal(got.mel_w.detach().numpy(),
                                  np.asarray(jp.mel_w))
    np.testing.assert_array_equal(got.log_floor.detach().numpy(),
                                  np.asarray(jp.log_floor))
    with torch.no_grad():
        got.mel_w.mul_(2.0)
    b = str(tmp_path / "port.npz")
    trainable.save_params(b, got, CFG)
    back = jax_trainable.load_params(b, JCFG)
    np.testing.assert_array_equal(np.asarray(back.mel_w),
                                  got.mel_w.detach().numpy())
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        assert str(za["config_hash"]) == str(zb["config_hash"])


def test_cuda_device_needs_a_card(monkeypatch, rng):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainable.init_params(CFG)
    audio, _ = _data(rng, B=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainable.fit(audio, np.zeros((1, 1, 4), np.float32), CFG, steps=1)
