"""The port's MFCC model against the JAX package's on the same inputs, the
committed goldens, the WAV reader, backend resolution, the configs the
slice does not cover, and the rule that the port imports no jax."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mfcc_tpu import FeatureConfig as JaxConfig
from mfcc_tpu.models import mfcc as jax_mfcc
from mfcc_tpu.utils import wav as jax_wav
from mfcc_tpu_torch import FeatureConfig, from_jax, oracle
from mfcc_tpu_torch.models import mfcc as mfcc_model
from mfcc_tpu_torch.utils import report, wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
TOL = 2e-5


def _speech():
    x, sr = wav.read_wav(os.path.join(GOLDEN, "speech2s.wav"))
    assert sr == 16000
    return x


def _ragged(rng, cfg, dtype):
    n = cfg.sample_rate
    lens = np.asarray([n, n - n // 3, 399], np.int32)
    x = (rng.standard_normal((3, n)) * 0.3).astype(np.float32)
    for i, l in enumerate(lens):
        x[i, l:] = 0.0
    if dtype == "int16":
        x = np.round(x * 8000).astype(np.int16)
    return x, lens


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(lifter=22, append_energy=True),
    dict(frame_mode="center"),
    dict(deltas=True),
    dict(dynamic_range_db=60.0, n_mels=40, n_mfcc=20),
])
def test_mfcc_batch_matches_jax(rng, dtype, kw):
    jc = JaxConfig(**kw).validate()
    x, lens = _ragged(rng, jc, dtype)
    jf, jfl, jm = jax_mfcc.mfcc_batch_jit(jnp.asarray(x), jnp.asarray(lens),
                                          jc, "xla")
    tf, tfl, tm = mfcc_model.mfcc_batch(torch.from_numpy(x),
                                        torch.from_numpy(lens), from_jax(jc))
    assert tf.dtype == torch.float32 and tfl.dtype == torch.int32
    assert tm.dtype == torch.bool
    np.testing.assert_array_equal(tfl.numpy(), np.asarray(jfl))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    lift = np.tile(oracle.lifter_coeffs(jc.n_mfcc, jc.lifter),
                   3 if jc.deltas else 1)
    np.testing.assert_allclose(tf.numpy() / lift, np.asarray(jf) / lift,
                               atol=TOL, rtol=0)
    assert (tf.numpy()[~tm.numpy()] == 0.0).all()


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_mfcc_single_matches_jax(rng, backend):
    cfg = JaxConfig()
    x = (rng.standard_normal(7000) * 0.3).astype(np.float32)
    want = np.asarray(jax_mfcc.mfcc_jit(jnp.asarray(x), cfg, "xla"))
    got = mfcc_model.mfcc(torch.from_numpy(x), from_jax(cfg), backend)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    assert tuple(mfcc_model.mfcc(torch.zeros(300), from_jax(cfg)).shape) \
        == (0, 13)


@pytest.mark.parametrize("fname,kw", [
    ("mfcc13.npy", dict()),
    ("mfcc13_center.npy", dict(frame_mode="center")),
    ("mfcc13_energy_lifter.npy", dict(lifter=22, append_energy=True)),
])
def test_goldens(fname, kw):
    cfg = FeatureConfig(**kw)
    x = _speech()
    feat, flens, _ = mfcc_model.mfcc_batch(
        torch.from_numpy(x[None]), torch.tensor([len(x)]), cfg)
    want = np.load(os.path.join(GOLDEN, fname))
    assert tuple(feat.shape[1:]) == want.shape
    assert int(flens[0]) == want.shape[0]
    lift = oracle.lifter_coeffs(cfg.n_mfcc, cfg.lifter)
    np.testing.assert_allclose(feat[0].numpy() / lift, want / lift,
                               atol=1e-4, rtol=0)


def test_wav_reader_matches_reference():
    got, sr = wav.read_wav(os.path.join(GOLDEN, "speech2s.wav"))
    want, jsr = jax_wav.read_wav(os.path.join(GOLDEN, "speech2s.wav"))
    assert sr == jsr and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_wav_reader_rejects_other_formats(tmp_path):
    # the reader takes what the reference's takes (multi-channel files are
    # averaged, tests/test_torch_utils.py) and rejects what it rejects
    p = tmp_path / "stereo.wav"
    jax_wav.write_wav(p, np.arange(100, dtype=np.int16), 16000)
    data = bytearray(p.read_bytes())
    data[22] = 2                                  # channel count
    p.write_bytes(bytes(data))
    got, sr = wav.read_wav(p)
    want, _ = jax_wav._parse(bytes(data), None)
    assert got.shape == (50,) and sr == 16000
    np.testing.assert_array_equal(got, want)
    data[34] = 12                                 # 12-bit PCM
    p.write_bytes(bytes(data))
    with pytest.raises(wav.WavError):
        wav.read_wav(p)
    (tmp_path / "junk.wav").write_bytes(b"RIFF0000WAVX")
    with pytest.raises(wav.WavError):
        wav.read_wav(tmp_path / "junk.wav")


def test_frame_lengths_and_mask():
    for kw in (dict(), dict(frame_mode="center")):
        jc = JaxConfig(**kw)
        n = np.asarray([0, 1, 199, 200, 399, 400, 401, 16000], np.int32)
        want = np.asarray(jax_mfcc.frame_lengths(jnp.asarray(n), jc))
        got = mfcc_model.frame_lengths(torch.from_numpy(n), from_jax(jc))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            mfcc_model.frame_mask(7, got).numpy(),
            np.asarray(jax_mfcc.frame_mask(7, jnp.asarray(want))))


def test_backend_resolution():
    x = torch.zeros((1, 4000))
    with pytest.raises(ValueError, match="CUDA tensor"):
        mfcc_model.mfcc_batch(x, torch.tensor([4000]), FeatureConfig(),
                              "cuda")
    with pytest.raises(ValueError, match="backend"):
        mfcc_model.mfcc_batch(x, torch.tensor([4000]), FeatureConfig(),
                              "xla")
    before = report.launches()
    a = mfcc_model.mfcc_batch(x, torch.tensor([4000]), FeatureConfig(),
                              "auto")[0]
    b = mfcc_model.mfcc_batch(x, torch.tensor([4000]), FeatureConfig(),
                              "torch")[0]
    assert torch.equal(a, b) and report.launches() == before


@pytest.mark.parametrize("kw", [
    dict(accum_dtype="bfloat16"),
    dict(matmul_precision="high"),
    dict(matmul_precision="default"),
    dict(compute_dtype="bfloat16"),
])
def test_unported_configs_raise(rng, kw):
    """The numerics fields that were once unported all compute now: the
    precision modes and bf16 compute (ROADMAP modules item 2.2) and
    accum_dtype other than float32 (item 2.4) equal JAX's XLA path
    (``tests/test_torch_precision.py`` and ``tests/test_torch_accum.py``
    hold every family); only an accum_dtype JAX could not name raises."""
    if "accum_dtype" in kw:
        with pytest.raises(ValueError, match="accum_dtype"):
            mfcc_model.mfcc_batch(torch.zeros((1, 4000)),
                                  torch.tensor([4000]),
                                  FeatureConfig(accum_dtype="int32"))
    jc = JaxConfig(**kw).validate()
    x, lens = _ragged(rng, jc, "float32")
    jf = np.asarray(jax_mfcc.mfcc_batch_jit(jnp.asarray(x), jnp.asarray(lens),
                                            jc, "xla")[0])
    tf, _, tm = mfcc_model.mfcc_batch(torch.from_numpy(x),
                                      torch.from_numpy(lens), from_jax(jc))
    m = tm.numpy()
    # bf16 compute: a rare bfloat16 rounding flip moves an entry (module
    # docstring of tests/test_torch_precision.py), so its bound is wider;
    # bf16 accumulation: its cepstra bound (tests/test_torch_accum.py)
    tol = (2e-3 if "compute_dtype" in kw
           else 2e-2 if "accum_dtype" in kw else TOL)
    np.testing.assert_allclose(tf.numpy()[m], jf[m], rtol=0, atol=tol)
    single = mfcc_model.mfcc(torch.from_numpy(x[0]), from_jax(jc))
    np.testing.assert_allclose(single.numpy(), tf.numpy()[0], rtol=0,
                               atol=tol)


def test_plain_matmul_runs_in_ieee_fp32():
    from mfcc_tpu_torch import backend
    torch.set_float32_matmul_precision("high")     # TF32 allowed
    try:
        a = torch.eye(3)
        assert torch.equal(backend.matmul(a, a), a)
        # the caller's setting is restored after the call
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision("highest")
    assert not torch.backends.cuda.matmul.allow_tf32


def test_port_imports_no_jax():
    code = ("import sys; import mfcc_tpu_torch.models.mfcc, "
            "mfcc_tpu_torch.models.pitch, mfcc_tpu_torch.models.logmel, "
            "mfcc_tpu_torch.models.plp, mfcc_tpu_torch.models.spectrogram, "
            "mfcc_tpu_torch.tools.plain_valley, mfcc_tpu_torch.utils.wav, "
            "mfcc_tpu_torch.tools.roofline, "
            "mfcc_tpu_torch.ops.kernels._build, mfcc_tpu_torch.ops.dither, "
            "mfcc_tpu_torch.ops.post, mfcc_tpu_torch.ops.deltas, "
            "mfcc_tpu_torch.parallel.cmvn, mfcc_tpu_torch.utils.batch, "
            "mfcc_tpu_torch.models.streaming, mfcc_tpu_torch.runner, "
            "mfcc_tpu_torch.cli, mfcc_tpu_torch.native, "
            "mfcc_tpu_torch.utils.manifest, mfcc_tpu_torch.utils.report, "
            "mfcc_tpu_torch.utils.htk, mfcc_tpu_torch.utils.kaldi, "
            "mfcc_tpu_torch.utils.tfrecord, mfcc_tpu_torch.parallel.dist, "
            "mfcc_tpu_torch.models.pitch_online, mfcc_tpu_torch.ops.augment, "
            "mfcc_tpu_torch.models.trainable, mfcc_tpu_torch.dataset, "
            "mfcc_tpu_torch.parallel.mesh, mfcc_tpu_torch.parallel.dryrun; "
            "from mfcc_tpu_torch import (mfcc_batch_packed, mfcc_long, "
            "process_chunks_batch_fused, online_cmvn_step, state_from_jax, "
            "MFCC13, LOGMEL80, logmel_config); "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'mfcc_tpu.')) or m == 'mfcc_tpu']; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                   check=True, timeout=120)
    for root, _, files in os.walk(os.path.join(REPO, "mfcc_tpu_torch")):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                src = open(os.path.join(root, f)).read()
                assert "import jax" not in src and "from jax" not in src, f
                assert "import mfcc_tpu\n" not in src, f
                assert "from mfcc_tpu " not in src and \
                    "from mfcc_tpu." not in src, f
    smoke = open(os.path.join(REPO, "chip_smoke.py")).read()
    assert "import jax" not in smoke and "from mfcc_tpu." not in smoke


def test_chip_smoke_refuses_without_a_card():
    """No card: exit non-zero and print no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
