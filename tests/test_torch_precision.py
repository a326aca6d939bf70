"""The precision modes (``matmul_precision`` "highest" / "high" / "default",
``compute_dtype="bfloat16"``, the ``precision=`` keywords) of the port
against the JAX package on the CPU, the card's TF32 form emulated, the
scoping of the matmul flags, and the route each mode takes.

On the CPU, JAX computes its three modes alike (IEEE fp32), and so does
the port: every feature family under "high" and "default" equals JAX at
that family's port-vs-JAX tolerance of its own test file, and the port's
"highest" bit for bit.  Under bf16 compute both round the DFT's operands
and chain bfloat16 hop-block products; the port equals JAX within
BF16_JAX_MEAN / BF16_JAX_MAX (measured: mean 2e-7, max 4.8e-6 at 26 mels
and 4.9e-4 at 40, where a rare one-ulp flip of a partial sum lands in a
spectral valley), and the oracle within the reference's own gates
(``tests/test_numerics.py:27-42``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfcc_tpu import FeatureConfig as JaxConfig, PitchConfig as JaxPitch
from mfcc_tpu import backend as jax_backend
from mfcc_tpu.models import logmel as jax_logmel, mfcc as jax_mfcc
from mfcc_tpu.models import pitch_online as jax_pitch_online
from mfcc_tpu.models import plp as jax_plp, spectrogram as jax_spec
from mfcc_tpu.models import streaming as jax_streaming
from mfcc_tpu.models import trainable as jax_trainable
from mfcc_tpu.ops import augment as jax_augment, pitch as jax_pitch
from mfcc_tpu.ops import resample as jax_resample
from mfcc_tpu_torch import backend, from_jax, oracle
from mfcc_tpu_torch.models import logmel, mfcc as mfcc_model, pitch_online
from mfcc_tpu_torch.models import plp, spectrogram, streaming, trainable
from mfcc_tpu_torch.ops import augment, pitch as pitch_op, resample
from mfcc_tpu_torch.ops.kernels import routes

MODES = ("high", "default")
JAX_PRECISION = {"highest": jax.lax.Precision.HIGHEST,
                 "high": jax.lax.Precision.HIGH,
                 "default": jax.lax.Precision.DEFAULT}
# bf16 compute, port vs JAX (measured on the CPU; module docstring)
BF16_JAX_MEAN = 1e-5
BF16_JAX_MAX = 2e-3
# the reference's bf16 gates against the oracle (tests/test_numerics.py)
BF16_ORACLE_MEAN, BF16_ORACLE_MAX = 0.05, 0.3
# |card form - float64 product| <= (FORM_UNIT + K 2^-23) (|A| @ |B|):
# "highest" and "high" are IEEE fp32; "default" rounds both operands to
# TF32 (<= 2^-10 each, truncated); K 2^-23 covers the float32 sums of K
# products
FORM_UNIT = {"highest": 0.0, "high": 0.0, "default": 2.0 ** -9}


def _ragged(rng, n=8000, B=3, frame_len=400):
    lens = np.asarray([n, n - n // 3, frame_len][:B], np.int32)
    x = (rng.standard_normal((B, n)) * 0.3).astype(np.float32)
    for i, l in enumerate(lens):
        x[i, l:] = 0.0
    return x, lens


def _window_err(got, want, db=50.0):
    keep = want > want.max(axis=-1, keepdims=True) - np.log(10.0 ** (db / 10))
    return float(np.abs(got - want)[keep].max())


def _check_spectrogram(got, want):
    """The spectrogram's bound: 2e-4 inside each frame's 50 dB window."""
    assert _window_err(got, want) < 2e-4, _window_err(got, want)


FAMILIES = {
    # name: (port batch entry, JAX batch entry, check(got, want))
    "mfcc": (mfcc_model.mfcc_batch, jax_mfcc.mfcc_batch_jit,
             lambda g, w: np.testing.assert_allclose(g, w, rtol=0,
                                                     atol=2e-5)),
    "logmel": (logmel.log_mel_batch, jax_logmel.log_mel_batch_jit,
               lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-4,
                                                       atol=1e-4)),
    "plp": (plp.plp_batch, jax_plp.plp_batch_jit,
            lambda g, w: np.testing.assert_allclose(g, w, rtol=0, atol=5e-5)),
    "spec": (spectrogram.log_spectrogram_batch,
             jax_spec.log_spectrogram_batch_jit, _check_spectrogram),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_batch_families_match_jax_under_each_mode(rng, family, mode):
    """Each family under "high" and "default": equal to JAX's XLA path at
    the family's port-vs-JAX tolerance, and to the port's "highest" bit
    for bit (the CPU computes every mode in IEEE fp32)."""
    port, jax_fn, check = FAMILIES[family]
    jc = JaxConfig(matmul_precision=mode).validate()
    x, lens = _ragged(rng)
    want = np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(lens), jc, "xla")[0])
    got, _, mask = port(torch.from_numpy(x), torch.from_numpy(lens),
                        from_jax(jc))
    m = mask.numpy()
    check(got.numpy()[m], want[m])
    ieee, _, _ = port(torch.from_numpy(x), torch.from_numpy(lens),
                      from_jax(jc).replace(matmul_precision="highest"))
    assert torch.equal(got, ieee)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", ["mfcc", "logmel", "plp", "spec"])
def test_packed_families_match_jax_under_each_mode(rng, family, mode):
    jc = JaxConfig(matmul_precision=mode).validate()
    x = (rng.standard_normal((2, 12000)) * 0.3).astype(np.float32)
    starts = np.asarray([[0, 6400], [0, 0]], np.int32)
    lens = np.asarray([[6000, 5600], [11000, 0]], np.int32)
    want = jax_mfcc.mfcc_batch_packed_jit(
        jnp.asarray(x), jnp.asarray(starts), jnp.asarray(lens), jc, "xla",
        family != "logmel", family)
    got = mfcc_model.mfcc_batch_packed(
        torch.from_numpy(x), torch.from_numpy(starts), torch.from_numpy(lens),
        from_jax(jc), family=family)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    m = got[3].numpy()
    FAMILIES[family][2](got[0].numpy()[m], np.asarray(want[0])[m])


@pytest.mark.parametrize("mode", MODES)
def test_streaming_scan_path_matches_jax_under_each_mode(speechlike, mode):
    jc = JaxConfig(matmul_precision=mode).validate()
    cfg = from_jax(jc)
    B, K, C = 2, 3, 8 * jc.hop_len
    xs = np.stack([np.roll(speechlike, 100 * b)[: K * C] for b in range(B)])
    chunks = xs.reshape(B, K, C)
    _, feats, nvs = streaming.process_chunks_batch(
        streaming.init_state_batch(B, cfg, device="cpu"),
        torch.from_numpy(chunks), cfg)
    _, jfeats, jnvs = jax_streaming.process_chunks_batch_jit(
        jax_streaming.init_state_batch(B, jc), jnp.asarray(chunks), jc)
    np.testing.assert_array_equal(nvs.numpy(), np.asarray(jnvs))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=0,
                               atol=1e-5)


def test_fused_serving_refuses_high_and_the_scan_path_computes_it():
    cfg = from_jax(JaxConfig(matmul_precision="high"))
    st = streaming.init_state_batch(1, cfg, device="cpu")
    chunks = torch.zeros((1, 2, 4 * cfg.hop_len))
    with pytest.raises(ValueError, match="high"):
        streaming.process_chunks_batch_fused(st, chunks, cfg)
    with pytest.raises(ValueError, match="high"):
        jax_streaming.process_chunks_batch_fused(
            jax_streaming.init_state_batch(1, JaxConfig(
                matmul_precision="high")), jnp.zeros((1, 2, 640)),
            JaxConfig(matmul_precision="high"))
    _, feats, _ = streaming.process_chunks_batch(st, chunks, cfg)
    assert bool(torch.isfinite(feats).all())


@pytest.mark.parametrize("mode", [*MODES, "bfloat16"])
def test_trainable_forward_and_gradient_match_jax(rng, mode):
    """The front end's spectrum and DCT follow the config (the mel product
    stays HIGHEST on both sides); its loss and gradient equal JAX's, jitted
    as its ``train_step`` runs them (under bf16 compute an eager JAX
    rounds the last add of the hop-block chain to bfloat16, a jitted one
    does not: ``ops/spectrum._dft``)."""
    kw = (dict(compute_dtype="bfloat16") if mode == "bfloat16"
          else dict(matmul_precision=mode))
    jc = JaxConfig(**kw).validate()
    cfg = from_jax(jc)
    audio = (rng.standard_normal((2, 4000)) * 0.3).astype(np.float32)
    jp = jax_trainable.init_params(jc)
    jp = jp._replace(mel_w=jp.mel_w * 1.3)
    jforward = jax.jit(jax_trainable.forward, static_argnames="cfg")
    target = np.array(jforward(jax_trainable.init_params(jc),
                               jnp.asarray(audio), cfg=jc))
    jloss, jgrad = jax.jit(jax.value_and_grad(jax_trainable.loss_fn),
                           static_argnames="cfg")(
        jp, jnp.asarray(audio), jnp.asarray(target), cfg=jc)
    params = trainable.params_from_jax(jp, "cpu")
    got = trainable.forward(params, torch.from_numpy(audio), cfg)
    want = np.asarray(jforward(jp, jnp.asarray(audio), cfg=jc))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    loss = trainable.loss_and_grad(params, torch.from_numpy(audio),
                                   torch.from_numpy(target), cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    for g, jg in ((params.mel_w.grad, jgrad.mel_w),
                  (params.log_floor.grad, jgrad.log_floor)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=1e-4 * np.abs(jg).max())


@pytest.mark.parametrize("kw", [dict(), dict(n_mels=40, n_mfcc=40)])
@pytest.mark.parametrize("family", ["mfcc", "logmel", "plp", "spec"])
def test_bfloat16_compute_matches_jax_and_the_oracle(rng, family, kw):
    """bf16 DFT operands, bfloat16 hop-block products: the port equals
    JAX's XLA path within BF16_JAX_MEAN / BF16_JAX_MAX; MFCC meets the
    reference's gates against the oracle, and every family stays within
    JAX's own error there plus BF16_JAX_MAX."""
    port, jax_fn, _ = FAMILIES[family]
    jc = JaxConfig(compute_dtype="bfloat16", **kw).validate()
    x = (rng.standard_normal((2, 16000)) * 0.3).astype(np.float32)
    lens = np.asarray([16000, 12000], np.int32)
    x[1, 12000:] = 0.0
    want = np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(lens), jc, "xla")[0])
    got, _, mask = port(torch.from_numpy(x), torch.from_numpy(lens),
                        from_jax(jc))
    got, m = got.numpy(), mask.numpy()
    diff = np.abs(got[m] - want[m])
    assert diff.mean() < BF16_JAX_MEAN and diff.max() < BF16_JAX_MAX, (
        diff.mean(), diff.max())
    ref_fn = {"mfcc": oracle.mfcc, "logmel": oracle.log_mel,
              "plp": oracle.plp, "spec": oracle.log_spectrogram}[family]
    c32 = from_jax(jc).replace(compute_dtype="float32")
    ref = ref_fn(x[0].astype(np.float64), c32)
    err = np.abs(got[0, : ref.shape[0]] - ref)
    jerr = np.abs(want[0, : ref.shape[0]] - ref)
    assert err.max() <= jerr.max() + BF16_JAX_MAX
    if family == "mfcc":
        assert err.mean() < BF16_ORACLE_MEAN and err.max() < BF16_ORACLE_MAX
    # the mode of the products does not change a bfloat16 product
    ieee, _, _ = port(torch.from_numpy(x), torch.from_numpy(lens),
                      from_jax(jc).replace(matmul_precision="default"))
    assert np.array_equal(ieee.numpy(), got)


def test_bfloat16_single_utterance_entries(rng):
    """mfcc and log_mel (one utterance) under bf16 compute against JAX."""
    jc = JaxConfig(compute_dtype="bfloat16").validate()
    x = (rng.standard_normal(16000) * 0.3).astype(np.float32)
    for port, ref in ((mfcc_model.mfcc, jax_mfcc.mfcc_jit),
                      (logmel.log_mel, jax_logmel.log_mel_jit)):
        got = port(torch.from_numpy(x), from_jax(jc)).numpy()
        diff = np.abs(got - np.asarray(ref(jnp.asarray(x), jc)))
        assert diff.mean() < BF16_JAX_MEAN and diff.max() < BF16_JAX_MAX


def _tf32(a: np.ndarray) -> np.ndarray:
    """float32 -> the nearest TF32 value (10 mantissa bits), as float64."""
    bits = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~np.uint64(0x1FFF)
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


@pytest.mark.parametrize("shape", [(64, 400, 514), (33, 2000, 40)])
def test_card_forms_emulated_within_their_bounds(rng, shape):
    """The card's forms on a DFT-like product within their bounds of the
    float64 product: "default" (one TF32 product) emulated in float64 over
    TF32-rounded operands, "high" and "highest" (IEEE fp32) as
    ``backend.matmul`` computes them, equal bit for bit."""
    M, K, N = shape
    a = (rng.standard_normal((M, K)) * 0.3).astype(np.float32)
    b = np.cos(rng.uniform(0, 2 * np.pi, (K, N))).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    forms = {"default": _tf32(a) @ _tf32(b),
             **{m: backend.matmul(ta, tb, m).numpy().astype(np.float64)
                for m in ("highest", "high")}}
    assert np.array_equal(forms["high"], forms["highest"])
    for form, got in forms.items():
        err = np.abs(got - exact)
        assert (err <= (FORM_UNIT[form] + K * 2.0 ** -23) * scale).all(), form
    assert np.abs(forms["default"] - exact).max() > 2 ** 8 * np.abs(
        forms["highest"] - exact).max()


@pytest.mark.parametrize("caller", [("highest", False), ("high", True)])
def test_flags_restored_after_every_form(caller):
    """Each form sets the flags for its call and restores the caller's,
    also when the call raises; a CPU tensor computes IEEE fp32 in every
    mode."""
    torch.set_float32_matmul_precision(caller[0])
    try:
        before = backend.matmul_flags()
        assert before[:2] == caller
        a = torch.eye(3)
        for mode in backend.PRECISIONS:
            with backend.matmul_form(mode):
                assert backend.matmul_flags() == (
                    "high" if mode == "default" else "highest",
                    mode == "default", False, False)
            assert backend.matmul_flags() == before
            assert torch.equal(backend.matmul(a, a, mode), a)
            assert backend.matmul_flags() == before
            with pytest.raises(RuntimeError, match="inside"):
                with backend.matmul_form(mode):
                    raise RuntimeError("inside")
            assert backend.matmul_flags() == before
        with pytest.raises(ValueError, match="precision"):
            backend.matmul(a, a, "fastest")
        assert backend.matmul_flags() == before
    finally:
        torch.set_float32_matmul_precision("highest")


class _OnCard:
    """A stand-in for a CUDA tensor: all ``backend.resolve`` reads."""
    is_cuda = True
    device = torch.device("cuda", 0)


@pytest.mark.parametrize("mode", ["highest", "high", "default"])
def test_route_follows_the_reference(mode):
    """The kernel-route predicate and backend resolution against the
    reference's ``kernel_precision_supported`` and ``resolve``."""
    jc = JaxConfig(matmul_precision=mode)
    cfg = from_jax(jc)
    ok = jax_backend.kernel_precision_supported(jc)
    assert routes.kernel_precision_supported(cfg) == ok
    assert (jax_backend.resolve("pallas", jc) == "pallas") == ok
    for name in ("auto", "cuda"):
        assert backend.resolve(name, _OnCard(), cfg) == (
            "cuda" if ok else "torch")
        assert backend.resolve(name, _OnCard(), None) == "cuda"
    assert backend.resolve("torch", _OnCard(), cfg) == "torch"
    assert backend.resolve("auto", torch.zeros(1), cfg) == "torch"


def test_resolve_needs_the_config():
    """No feature entry can drop the precision rule by leaving the config
    out: ``resolve`` takes it (None only on the pitch path, whose
    PitchConfig has no mode)."""
    with pytest.raises(TypeError):
        backend.resolve("auto", _OnCard())


@pytest.mark.parametrize("kw,err", [
    (dict(accum_dtype="int32"), ValueError),
    (dict(matmul_precision="fast"), ValueError),
    (dict(compute_dtype="float16"), ValueError)])
def test_check_config_refuses_only_what_is_not_computed(kw, err):
    cfg = from_jax(JaxConfig())
    for mode in backend.PRECISIONS:
        for dt in backend.COMPUTE_DTYPES:
            for acc in ("float32", "bfloat16", "float16"):
                backend.check_config(cfg.replace(
                    matmul_precision=mode, compute_dtype=dt, accum_dtype=acc))
    with pytest.warns(UserWarning, match="float64"):
        backend.check_config(cfg.replace(accum_dtype="float64"))
    with pytest.raises(err, match="must be one of"):
        backend.check_config(cfg.replace(**kw))


def test_from_jax_carries_the_numerics_fields():
    jc = JaxConfig(compute_dtype="bfloat16", accum_dtype="bfloat16",
                   matmul_precision="default")
    cfg = from_jax(jc)
    assert (cfg.compute_dtype, cfg.accum_dtype, cfg.matmul_precision) == (
        "bfloat16", "bfloat16", "default")
    assert cfg.config_hash() == from_jax(
        {f: getattr(jc, f) for f in jc.__dataclass_fields__}).config_hash()


@pytest.mark.parametrize("mode", ["highest", *MODES])
def test_pitch_features_and_resample_match_jax_under_each_mode(rng, mode):
    pcfg = JaxPitch()
    n = 8000
    t = np.arange(n) / 16000
    x = (0.4 * np.sin(2 * np.pi * 150 * t)
         + 0.01 * rng.standard_normal(n)).astype(np.float32)[None]
    lens = np.asarray([n], np.int32)
    want = np.asarray(jax_pitch.pitch_features(
        jnp.asarray(x), jnp.asarray(lens), pcfg,
        precision=JAX_PRECISION[mode], backend="xla")[0])
    got = pitch_op.pitch_features(torch.from_numpy(x), torch.from_numpy(lens),
                                  from_jax(pcfg), precision=mode)[0].numpy()
    for col, tol in enumerate((1e-4, 3e-4, 1e-4)):
        np.testing.assert_allclose(got[..., col], want[..., col], rtol=0,
                                   atol=tol)
    y = resample.resample(torch.from_numpy(x), 16000, 4000, precision=mode)
    jy = jax_resample.resample(jnp.asarray(x), 16000, 4000,
                               precision=JAX_PRECISION[mode])
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-6)
    y, yl = augment.speed_perturb(torch.from_numpy(x), torch.from_numpy(lens),
                                  0.9, precision=mode)
    jy, jyl = jax_augment.speed_perturb(jnp.asarray(x), jnp.asarray(lens),
                                        0.9, precision=JAX_PRECISION[mode])
    np.testing.assert_array_equal(yl.numpy(), np.asarray(jyl))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["highest", *MODES])
def test_chunk_nccf_matches_jax_under_each_mode(rng, mode):
    """The online chunk NCCF (plain route) at a mode against the
    reference's ``_chunk_nccf`` at that precision."""
    pcfg = JaxPitch()
    F = 16
    buf = (rng.standard_normal(pitch_online.chunk_span(from_jax(pcfg), F))
           * 0.3).astype(np.float32)
    mean_e = np.float32(3.0)
    jb, jp, _ = jax_pitch_online._chunk_nccf(
        jnp.asarray(buf), F, pcfg, jnp.asarray(mean_e), JAX_PRECISION[mode])
    ball = torch.tensor([pcfg.ballast * mean_e * mean_e])
    nb, npl = pitch_online.chunk_nccf(torch.from_numpy(buf), F,
                                      from_jax(pcfg), ball, "torch",
                                      precision=mode)
    np.testing.assert_allclose(nb.numpy(), np.asarray(jb), rtol=0, atol=2e-5)
    np.testing.assert_allclose(npl.numpy(), np.asarray(jp), rtol=0, atol=2e-5)
