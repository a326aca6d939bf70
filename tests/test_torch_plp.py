"""The port's PLP against the JAX package's on the same inputs: the float64
oracle twins (1e-12, and the committed golden), the constant builders
(bit for bit), ``ops/plp`` stage by stage (levinson and lpc_to_cepstra
within 1e-6 on random smooth spectra, the rest within 1e-6 of the
reference's XLA stages), ``plp`` / ``plp_batch`` against the reference's
XLA path and its Pallas kernel route in interpret mode (5e-5, the bound
``tests/test_plp.py`` holds those two to each other) and against the
oracle (1e-4, the PLP contract), and the route on the card (the kernel
wrapper with ``projection="bark"``, or the plain chain)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mfcc_tpu import FeatureConfig as JaxConfig, oracle as jax_oracle
from mfcc_tpu.models import plp as jax_plp
from mfcc_tpu.ops import plp as jax_plp_op
from mfcc_tpu.ops.kernels import fused_raw_dit as jax_raw_dit
from mfcc_tpu_torch import FeatureConfig, backend, from_jax, oracle
from mfcc_tpu_torch.models import plp as plp_model
from mfcc_tpu_torch.ops import deltas as deltas_op, plp as plp_op
from mfcc_tpu_torch.ops.kernels import fused_deltas, fused_raw_dit, routes
from mfcc_tpu_torch.utils import wav

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
ORACLE_TOL = 1e-4      # PLP contract vs the float64 oracle
PATHS_TOL = 5e-5       # port vs the reference's XLA / Pallas paths
STAGE_TOL = 1e-6       # stages on the same f32 inputs
# the whole tail on the same f32 input: exp and the autocorrelation product
# round in another order than XLA's, and the recursions carry it (2.7e-6
# measured)
TAIL_TOL = 1e-5
TWIN_TOL = 1e-12       # float64 twins
# tests/test_plp.py:118-123
VARIANTS = [dict(), dict(n_bark=17, lifter=22), dict(deltas=True),
            dict(append_energy=True)]


def _config_grid():
    """Seed-made spectral configs for the constant builders."""
    g = np.random.default_rng(61)
    out = [dict(), dict(n_bark=17, lpc_order=8),
           dict(sample_rate=8000, n_fft=256, n_bark=15)]
    for _ in range(5):
        sr = int(g.choice([8000, 16000, 22050, 44100]))
        n_fft = int(g.choice([256, 512, 1024, 2048]))
        n_bark = int(g.integers(8, 30))
        out.append(dict(sample_rate=sr, n_fft=n_fft, n_bark=n_bark,
                        lpc_order=int(g.integers(4, n_bark + 2)),
                        fmin=float(g.choice([0.0, 20.0, 64.0])),
                        fmax=[None, sr / 2 - 500.0][int(g.integers(2))]))
    return out


@pytest.mark.parametrize("kw", _config_grid())
def test_oracle_twins_match_reference(rng, kw):
    jc = JaxConfig(**kw).validate()
    cfg = from_jax(jc)
    f = rng.uniform(0, jc.sample_rate / 2, 50)
    np.testing.assert_allclose(oracle.hz_to_bark(f), jax_oracle.hz_to_bark(f),
                               rtol=0, atol=TWIN_TOL)
    np.testing.assert_allclose(oracle.equal_loudness(f),
                               jax_oracle.equal_loudness(f), rtol=0,
                               atol=TWIN_TOL)
    np.testing.assert_array_equal(oracle.bark_filterbank(cfg),
                                  jax_oracle.bark_filterbank(jc))
    M, p = jc.n_bark + 2, jc.lpc_order
    np.testing.assert_array_equal(oracle.autocorr_idft_matrix(M, p),
                                  jax_oracle.autocorr_idft_matrix(M, p))
    r = np.abs(rng.standard_normal((4, 7, M))) + 0.1
    r = r @ jax_oracle.autocorr_idft_matrix(M, p)
    a, e = oracle.levinson_np(r, p)
    ja, je = jax_oracle.levinson_np(r, p)
    np.testing.assert_allclose(a, ja, rtol=0, atol=TWIN_TOL)
    np.testing.assert_allclose(e, je, rtol=0, atol=TWIN_TOL)
    np.testing.assert_allclose(oracle.lpc_to_cepstra_np(a, e, 13),
                               jax_oracle.lpc_to_cepstra_np(ja, je, 13),
                               rtol=0, atol=TWIN_TOL)
    x = rng.standard_normal(jc.sample_rate // 2) * 0.3
    np.testing.assert_allclose(oracle.plp(x, cfg), jax_oracle.plp(x, jc),
                               rtol=0, atol=TWIN_TOL)


@pytest.mark.parametrize("kw", [dict(), dict(deltas=True, append_energy=True),
                                dict(frame_mode="center", lifter=22)])
def test_oracle_plp_matches_reference_variants(rng, kw):
    jc = JaxConfig(**kw).validate()
    x = rng.standard_normal(9000) * 0.3
    got = oracle.plp(x, from_jax(jc))
    np.testing.assert_allclose(got, jax_oracle.plp(x, jc), rtol=0,
                               atol=TWIN_TOL)
    assert oracle.plp(x[:100], from_jax(jc)).shape == (0, jc.n_feats)


def test_oracle_log_bark_is_plp_front_half(rng):
    """oracle.log_bark, the reference of the kernel's bark output, is the
    floored log of the reference's PLP band energies."""
    jc = JaxConfig().validate()
    x = rng.standard_normal(6000) * 0.3
    power = jax_oracle.power_spectrum(jax_oracle.frame_signal(x, jc), jc)
    want = np.log(np.maximum(power @ jax_oracle.bark_filterbank(jc).T,
                             jc.log_floor))
    np.testing.assert_allclose(oracle.log_bark(x, from_jax(jc)), want,
                               rtol=0, atol=TWIN_TOL)
    assert oracle.log_bark(x[:100], from_jax(jc)).shape == (0, jc.n_bark)


def test_oracle_plp_golden():
    x, _ = wav.read_wav(os.path.join(GOLDEN, "speech2s.wav"))
    np.testing.assert_allclose(
        oracle.plp(x.astype(np.float64), FeatureConfig()),
        np.load(os.path.join(GOLDEN, "plp13.npy")), rtol=0, atol=TWIN_TOL)


@pytest.mark.parametrize("kw", _config_grid())
def test_plp_matrices_match_reference(kw):
    jc = JaxConfig(**kw).validate()
    fb, A2 = plp_op._plp_matrices(from_jax(jc))
    jfb, jA2 = jax_plp_op._plp_matrices(jc)
    np.testing.assert_array_equal(fb, jfb)
    np.testing.assert_array_equal(A2, jA2)
    np.testing.assert_array_equal(plp_op.bark_matrix(from_jax(jc)), jfb.T)


def _smooth_power(rng, cfg, shape=(2, 9)):
    """Random smooth |X|^2: three broad random resonances over a floor
    (~20 dB of range)."""
    k = np.arange(cfg.n_bins) / cfg.n_bins
    p = np.full(shape + (cfg.n_bins,), 0.1)
    for _ in range(3):
        c = rng.uniform(0.05, 0.9, shape + (1,))
        w = rng.uniform(0.05, 0.2, shape + (1,))
        p = p + rng.uniform(0.5, 10.0, shape + (1,)) * np.exp(
            -0.5 * ((k - c) / w) ** 2)
    return p.astype(np.float32)


@pytest.mark.parametrize("kw", [dict(), dict(n_bark=17, lpc_order=8, lifter=22),
                                dict(sample_rate=8000, n_fft=256)])
def test_stages_match_reference(rng, kw):
    jc = JaxConfig(**kw).validate()
    cfg = from_jax(jc)
    power = _smooth_power(rng, cfg)
    loud = plp_op.bark_loudness(torch.from_numpy(power), cfg)
    jloud = jax_plp_op.bark_loudness_split(jnp.asarray(power[..., :-1]),
                                           jnp.asarray(power[..., -1:]), jc)
    np.testing.assert_allclose(loud.numpy(), np.asarray(jloud), rtol=1e-6,
                               atol=STAGE_TOL)
    r = plp_op.autocorrelation(loud, cfg)
    jr = jax_plp_op.autocorrelation(jnp.asarray(loud.numpy()), jc)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6,
                               atol=STAGE_TOL)
    # the recursions on the same f32 autocorrelation against the JAX
    # stages, and the cepstra also against the float64 oracle's recursions
    a, e = plp_op.levinson(r, cfg.lpc_order)
    ja, je = jax_plp_op.levinson(jnp.asarray(r.numpy()), jc.lpc_order)
    oa, oe = oracle.levinson_np(r.numpy().astype(np.float64), cfg.lpc_order)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0,
                               atol=STAGE_TOL)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-6, atol=0)
    c = plp_op.lpc_to_cepstra(a, e, cfg.n_mfcc)
    jcep = jax_plp_op.lpc_to_cepstra(ja, je, jc.n_mfcc)
    ocep = oracle.lpc_to_cepstra_np(oa, oe, cfg.n_mfcc)
    for want in (np.asarray(jcep), ocep):
        np.testing.assert_allclose(c.numpy(), want, rtol=0, atol=STAGE_TOL)
    lb = np.log(np.maximum(power @ plp_op.bark_matrix(cfg), 1e-10)
                ).astype(np.float32)
    got = plp_op.plp_from_log_bark(torch.from_numpy(lb), cfg).numpy()
    want = np.asarray(jax_plp_op.plp_from_log_bark(jnp.asarray(lb), jc))
    np.testing.assert_allclose(got, want, rtol=0, atol=TAIL_TOL)
    got = plp_op.plp_from_power(torch.from_numpy(power), cfg).numpy()
    want = np.asarray(jax_plp_op.plp_from_power_split(
        jnp.asarray(power[..., :-1]), jnp.asarray(power[..., -1:]), jc))
    np.testing.assert_allclose(got, want, rtol=0, atol=TAIL_TOL)


@pytest.mark.parametrize("variant", VARIANTS)
def test_plp_matches_jax_paths_and_oracle(rng, variant):
    """The port's plp on a CPU tensor against the reference's XLA path and
    its Pallas route (the bark projection of fused_raw_dit, interpret
    mode), and against the oracle."""
    jc = JaxConfig(**variant).validate()
    cfg = from_jax(jc)
    x = (0.3 * rng.standard_normal(jc.sample_rate)).astype(np.float32)
    got = plp_model.plp(torch.from_numpy(x), cfg).numpy()
    assert got.shape == (jc.num_frames(len(x)), jc.n_feats)
    for path in ("xla", "pallas"):
        want = np.asarray(jax_plp.plp_jit(jnp.asarray(x), jc, path))
        np.testing.assert_allclose(got, want, rtol=0, atol=PATHS_TOL,
                                   err_msg=path)
    np.testing.assert_allclose(got, jax_oracle.plp(x.astype(np.float64), jc),
                               rtol=0, atol=ORACLE_TOL)


def _ragged(rng, cfg, dtype):
    n = cfg.sample_rate
    lens = np.asarray([n, n - n // 3, cfg.frame_len, cfg.frame_len - 1],
                      np.int32)
    x = (rng.standard_normal((4, n)) * 0.3).astype(np.float32)
    for i, l in enumerate(lens):
        x[i, l:] = 0.0
    if dtype == "int16":
        x = np.round(x * 8000).astype(np.int16)
    return x, lens


@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("kw", [dict(deltas=True), dict(append_energy=True),
                                dict(frame_mode="center", lifter=22)])
def test_plp_batch_matches_jax(rng, dtype, kw):
    """Frame counts, masks and zeroing exactly as the reference's, features
    within 5e-5 of its XLA batch path, each row within 1e-4 of the oracle
    inside its frames."""
    jc = JaxConfig(**kw).validate()
    x, lens = _ragged(rng, jc, dtype)
    jf, jfl, jm = jax_plp.plp_batch_jit(jnp.asarray(x), jnp.asarray(lens), jc,
                                        "xla")
    tf, tfl, tm = plp_model.plp_batch(torch.from_numpy(x),
                                      torch.from_numpy(lens), from_jax(jc))
    assert tf.dtype == torch.float32 and tuple(tf.shape) == jf.shape
    np.testing.assert_array_equal(tfl.numpy(), np.asarray(jfl))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0,
                               atol=PATHS_TOL)
    assert (tf.numpy()[~tm.numpy()] == 0.0).all()
    xf = x.astype(np.float64) / (32768.0 if dtype == "int16" else 1.0)
    for i, n in enumerate(lens):
        want = oracle.plp(xf[i, :n], from_jax(jc))
        assert int(tfl[i]) == want.shape[0]
        np.testing.assert_allclose(tf[i, : want.shape[0]].numpy(), want,
                                   rtol=0, atol=ORACLE_TOL)


def test_plp_golden():
    """speech2s.wav against plp13.npy at the PLP contract (1e-4), one
    utterance and as a batch of one."""
    cfg = FeatureConfig()
    x, _ = wav.read_wav(os.path.join(GOLDEN, "speech2s.wav"))
    want = np.load(os.path.join(GOLDEN, "plp13.npy"))
    single = plp_model.plp(torch.from_numpy(x), cfg).numpy()
    batch, flens, _ = plp_model.plp_batch(torch.from_numpy(x[None]),
                                          torch.tensor([len(x)]), cfg)
    assert single.shape == want.shape and int(flens[0]) == want.shape[0]
    np.testing.assert_allclose(single, want, rtol=0, atol=ORACLE_TOL)
    np.testing.assert_array_equal(batch[0].numpy(), single)


@pytest.fixture()
def on_card(monkeypatch):
    """backend "auto" resolves to "cuda" (CPU tensors), and the
    fused_raw_dit wrapper records each call before running its plain
    version, the deltas kernel its window before running its plain
    twin."""
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

    def deltas_kernel(feat, window, lengths=None):
        calls.append(("fused_deltas", window))
        return deltas_op.plain_append_deltas(feat, window, lengths)

    monkeypatch.setattr(fused_deltas, "fused_append_deltas", deltas_kernel)
    return calls


@pytest.mark.parametrize("kw,kernel", [
    (dict(), True), (dict(deltas=True, append_energy=True), True),
    (dict(sample_rate=8000, n_fft=256), True),
    (dict(n_fft=400), True),          # raw_dit eligible: n_fft % 4 == 0
    (dict(n_fft=402), False),         # n_fft % 4 != 0
    (dict(sample_rate=44100, n_fft=2048), False),   # odd hop 441
])
def test_plp_route_per_config(on_card, rng, kw, kernel):
    """On the card PLP reaches fused_raw_dit with the bark projection
    exactly where the reference's raw-DIT rule holds, else the plain chain;
    either way the features agree with the plain CPU path."""
    cfg = FeatureConfig(**kw).validate()
    assert routes.raw_dit_kernel_eligible(cfg) == kernel == \
        jax_raw_dit.raw_dit_kernel_eligible(JaxConfig(**kw).validate())
    x, lens = _ragged(rng, cfg, "float32")
    got, flens, mask = plp_model.plp_batch(torch.from_numpy(x),
                                           torch.from_numpy(lens), cfg)
    assert on_card == ([(False, "bark")] if kernel else []) + (
        [("fused_deltas", cfg.delta_window)] if cfg.deltas else [])
    plain, pfl, pm = plp_model.plp_batch(torch.from_numpy(x),
                                         torch.from_numpy(lens), cfg, "torch")
    assert torch.equal(flens, pfl) and torch.equal(mask, pm)
    torch.testing.assert_close(got, plain, rtol=0, atol=TAIL_TOL)


def test_plp_unported_options_raise(rng):
    """Only an accum_dtype JAX could not name raises; bf16 compute, the
    precision modes and bf16 accumulation (ROADMAP modules item 2.4)
    compute, equal to the reference's XLA path
    (``tests/test_torch_precision.py``, ``tests/test_torch_accum.py``)."""
    x = torch.zeros(4000)
    with pytest.raises(ValueError, match="accum_dtype"):
        plp_model.plp(x, FeatureConfig(accum_dtype="int32"))
    with pytest.raises(ValueError, match="accum_dtype"):
        plp_model.plp_batch(x[None], torch.tensor([4000]),
                            FeatureConfig(accum_dtype="int32"))
    sig = (rng.standard_normal(8000) * 0.3).astype(np.float32)
    for kw in (dict(compute_dtype="bfloat16"), dict(matmul_precision="high"),
               dict(accum_dtype="bfloat16")):
        jc = JaxConfig(**kw).validate()
        # bf16 accumulation: PLP's bound there (tests/test_torch_accum.py)
        tol = 1e-3 if "accum_dtype" in kw else PATHS_TOL
        want = np.asarray(jax_plp.plp_jit(jnp.asarray(sig), jc))
        got = plp_model.plp(torch.from_numpy(sig), from_jax(jc)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        got, _, _ = plp_model.plp_batch(torch.from_numpy(sig)[None],
                                        torch.tensor([8000]), from_jax(jc))
        np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=tol)
