"""The port's online pitch tracker and streaming resampler against the JAX
package on the same inputs: case for case the twins of
tests/test_pitch_online.py and the streaming cases of
tests/test_resample.py, plus the port against the JAX tracker and the
chunk step's pieces against the reference's ``_chunk_nccf``.  The chunk
NCCF kernel's case is in tests/test_torch_cuda.py.

Per-column contract (tests/test_pitch_online.py): pov 1e-4, normalized log
pitch 3e-4, delta 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfcc_tpu import config as jax_config
from mfcc_tpu.models import pitch_online as jax_online
from mfcc_tpu.ops import resample as jax_resample
from mfcc_tpu_torch import PitchConfig
from mfcc_tpu_torch.models import pitch as pitch_model
from mfcc_tpu_torch.models import pitch_online
from mfcc_tpu_torch.models.pitch_online import OnlinePitch, online_pitch_np
from mfcc_tpu_torch.ops import resample
from mfcc_tpu_torch.ops.kernels import fused_nccf
from mfcc_tpu_torch.utils import report

PCFG = PitchConfig().validate()
SR = 16000
ATOL = {"pov": 1e-4, "norm": 3e-4, "delta": 1e-4}


def _signal(rng, n=2 * SR):
    t = np.arange(n) / SR
    half = n // 2
    x = np.zeros(n)
    phase = 2 * np.pi * 200 * (t[:half]
                               + 0.02 * np.sin(2 * np.pi * 3 * t[:half]))
    x[:half] = 0.4 * np.sin(phase) + 0.2 * np.sin(2 * phase)
    x += 0.01 * rng.standard_normal(n)
    return x.astype(np.float32)


def _feed_all(op, x, feed):
    rows, i = [], 0
    while i < x.size:
        rows.append(op.feed(x[i: i + feed]))
        i += feed
    rows.append(op.flush())
    return np.concatenate(rows)


def _run_online(x, delay=50, chunk_frames=16, feed=4096):
    return _feed_all(OnlinePitch(PCFG, delay=delay, chunk_frames=chunk_frames,
                                 device="cpu"), x, feed)


def _assert_columns(got, want):
    for i, nm in enumerate(("pov", "norm", "delta")):
        err = float(np.abs(got[:, i] - want[:, i]).max())
        assert err < ATOL[nm], (nm, err)


# ---- the streaming resampler (tests/test_resample.py) ---------------------

@pytest.mark.parametrize("sr_in,sr_out,n", [
    (16000, 4000, 32000), (16000, 2000, 16013), (44100, 16000, 20000),
    (8000, 16000, 8005)])
@pytest.mark.parametrize("chunk", [160, 1001, 7])
def test_streaming_resampler_matches_batch_and_jax(rng, sr_in, sr_out, n,
                                                   chunk):
    """The concatenation of every feed plus flush equals the float64 batch
    resampler to round-off, and the JAX StreamingResampler on the same
    feeds to 1e-12."""
    x = rng.standard_normal(n)
    want = resample.resample_poly_numpy(x, sr_in, sr_out)
    ours = resample.StreamingResampler(sr_in, sr_out)
    ref = jax_resample.StreamingResampler(sr_in, sr_out)
    got, theirs, i = [], [], 0
    while i < n:
        got.append(ours.feed(x[i: i + chunk]))
        theirs.append(ref.feed(x[i: i + chunk]))
        i += chunk
    got = np.concatenate(got + [ours.flush()])
    theirs = np.concatenate(theirs + [ref.flush()])
    assert got.shape == want.shape == theirs.shape
    np.testing.assert_allclose(got, want, atol=1e-13)
    np.testing.assert_allclose(got, theirs, rtol=0, atol=1e-12)


def test_streaming_resampler_rejects_noop_and_feed_after_flush():
    with pytest.raises(ValueError):
        resample.StreamingResampler(16000, 16000)
    rs = resample.StreamingResampler(16000, 4000)
    rs.feed(np.zeros(100))
    rs.flush()
    with pytest.raises(RuntimeError):
        rs.feed(np.zeros(10))
    with pytest.raises(RuntimeError):
        rs.flush()


# ---- the tracker (tests/test_pitch_online.py, case for case) ---------------

def test_online_matches_float64_twin(rng):
    x = _signal(rng)
    got = _run_online(x)
    want = online_pitch_np(x.astype(np.float64), PCFG, delay=50,
                           chunk_frames=16)
    assert got.shape == want.shape == (PCFG.num_frames(x.size), 3)
    _assert_columns(got, want)


def test_feed_size_invariance(rng):
    """The emission schedule depends only on chunk_frames and delay."""
    x = _signal(rng, n=SR)
    a = _run_online(x, feed=x.size)          # everything at once
    b = _run_online(x, feed=333)             # odd small feeds
    np.testing.assert_array_equal(a, b)


def test_bounded_latency(rng):
    """After enough audio, rows lag by at most delay + one chunk."""
    x = _signal(rng)
    delay, F = 30, 16
    op = OnlinePitch(PCFG, delay=delay, chunk_frames=F, device="cpu")
    fed = out_rows = 0
    for i in range(0, x.size, 1600):          # 100 ms feeds
        out_rows += op.feed(x[i: i + 1600]).shape[0]
        fed += min(1600, x.size - i)
        assert PCFG.num_frames(fed) - out_rows <= delay + F + 2
    out_rows += op.flush().shape[0]
    assert out_rows == PCFG.num_frames(x.size)
    assert op.chunks == -(-PCFG.num_frames(x.size) // F)


def test_full_delay_path_equals_batch_viterbi(rng):
    """With delay >= T every decision comes from the final cost; against
    the port's batch tracker only the causal ballast differs, which on
    clearly voiced frames leaves the integer path (and the pov column)
    identical on >= 95 % of them."""
    x = _signal(rng, n=SR)
    T = PCFG.num_frames(x.size)
    got = _run_online(x, delay=T + 10)
    batch = pitch_model.pitch(torch.from_numpy(x), PCFG).numpy()
    voiced = slice(2, T // 2 - 4)
    d = np.abs(got[voiced, 0] - batch[voiced, 0])
    assert (d < 2e-4).mean() >= 0.95, d.max()
    assert got[voiced, 0].mean() < -0.5
    assert got[T // 2 + 4: T - 2, 0].mean() > -0.2


def test_host_buffers_stay_bounded(rng):
    """Ring-buffer pruning: a long stream does not grow host memory."""
    op = OnlinePitch(PCFG, delay=50, chunk_frames=16, device="cpu")
    for _ in range(20):                       # 20 s of audio
        op.feed((0.1 * rng.standard_normal(SR)).astype(np.float32))
    assert len(op._back) <= 50 + 16 + 4       # delay + one chunk
    assert len(op._nccf) == len(op._back)
    assert len(op._logf0) <= PCFG.norm_window + PCFG.delta_window + 16


def test_runner_pitch_config_derives_from_cfg():
    """The runner's pitch config shares the main frame and hop and caps
    the work rate at the input rate (the port's runner, as the
    reference's)."""
    from mfcc_tpu_torch import FeatureConfig
    from mfcc_tpu_torch.runner import _pitch_config
    p = _pitch_config(FeatureConfig(hop_ms=20.0, frame_ms=30.0))
    assert p.hop_ms == 20.0 and p.frame_ms == 30.0 and p.work_rate == 4000
    p2 = _pitch_config(FeatureConfig(sample_rate=2000, n_fft=64, n_mels=8,
                                     n_mfcc=4))
    assert p2.work_rate == 2000 and p2.sample_rate == 2000


def test_short_and_empty_stream():
    op = OnlinePitch(PCFG, device="cpu")
    assert op.feed(np.zeros(100, np.float32)).shape == (0, 3)
    assert op.flush().shape == (0, 3)
    op2 = OnlinePitch(PCFG, device="cpu")    # shorter than one frame
    op2.feed(np.zeros(500, np.float32))
    assert op2.flush().shape == (0, 3)
    with pytest.raises(RuntimeError):
        op2.feed(np.zeros(10, np.float32))    # feed after flush
    assert op2.chunks == 0


# ---- the port against the JAX package ---------------------------------------

@pytest.mark.parametrize("kw", [dict(delay=50, chunk_frames=16),
                                dict(delay=7, chunk_frames=5)])
def test_online_matches_jax_online_pitch(rng, kw):
    """The port on the CPU against the JAX OnlinePitch on the same feeds,
    the JAX tracker's configuration carried across by from_jax."""
    x = _signal(rng)
    ref = jax_online.OnlinePitch(jax_config.PitchConfig(), **kw)
    op = OnlinePitch.from_jax(ref, device="cpu")
    assert (op.pcfg, op.delay, op.F) == (PCFG, kw["delay"],
                                         kw["chunk_frames"])
    got = _feed_all(op, x, 1600)
    want = _feed_all(ref, x, 1600)
    assert got.shape == want.shape
    _assert_columns(got, want)


def test_online_pitch_np_is_the_reference_twin(rng):
    x = _signal(rng, n=SR).astype(np.float64)
    got = online_pitch_np(x, PCFG, delay=20, chunk_frames=8)
    want = jax_online.online_pitch_np(x, jax_config.PitchConfig(), delay=20,
                                      chunk_frames=8)
    np.testing.assert_array_equal(got, want)


def _chunk_buf(rng, pcfg, F):
    span = pitch_online.chunk_span(pcfg, F)
    return (0.3 * np.sin(2 * np.pi * 180 * np.arange(span) / pcfg.work_rate)
            + 0.02 * rng.standard_normal(span)).astype(np.float32)


@pytest.mark.parametrize("n_valid", [16, 11, 1, 0])
def test_chunk_step_matches_jax(rng, n_valid):
    """One chunk step from a carried state: the causal statistics, the
    Viterbi cost, the backpointers and the plain NCCF against the JAX
    step; frames past n_valid leave the state untouched."""
    F = 16
    buf = _chunk_buf(rng, PCFG, F)
    buf[: 50] *= 0.1
    cost0 = rng.standard_normal(PCFG.n_lags).astype(np.float32)
    jstate = jax_online.OnlineChunkState(
        cost=jnp.asarray(cost0), e_sum=jnp.asarray(np.float32(3.5)),
        e_cnt=jnp.asarray(np.float32(40.0)), started=jnp.asarray(1, jnp.int32))
    jstate2, jback, jnp_ = jax_online.online_chunk_step(
        jstate, jnp.asarray(buf), jnp.asarray(n_valid),
        jax_config.PitchConfig(), F)
    state = pitch_online.OnlineChunkState(
        cost=torch.from_numpy(cost0), e_sum=torch.tensor(3.5),
        e_cnt=torch.tensor(40.0), started=torch.tensor(1, dtype=torch.int32))
    state2, back, nccf_p = pitch_online.online_chunk_step(
        state, torch.from_numpy(buf), n_valid, PCFG, F)
    np.testing.assert_allclose(float(state2.e_sum), float(jstate2.e_sum),
                               rtol=1e-6)
    assert float(state2.e_cnt) == float(jstate2.e_cnt) == 40.0 + n_valid
    assert int(state2.started) == int(jstate2.started) == 1
    np.testing.assert_allclose(state2.cost.numpy(), np.asarray(jstate2.cost),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nccf_p.numpy()[:n_valid],
                               np.asarray(jnp_)[:n_valid], atol=2e-5)
    # the integer decisions agree wherever the JAX step's margin is clear
    np.testing.assert_array_equal(back.numpy()[:n_valid],
                                  np.asarray(jback)[:n_valid])
    ident = np.arange(PCFG.n_lags)
    assert (back.numpy()[n_valid:] == ident).all()
    if n_valid == 0:
        np.testing.assert_array_equal(state2.cost.numpy(), cost0)


def test_chunk_step_first_frame_starts_fresh(rng):
    """From the initial state the first valid frame's cost is -s_0 and its
    backpointers are the identity, as in the reference."""
    F = 4
    buf = torch.from_numpy(_chunk_buf(rng, PCFG, F))
    state = pitch_online.init_chunk_state(PCFG, device="cpu")
    state2, back, _ = pitch_online.online_chunk_step(state, buf, 1, PCFG, F)
    e0 = pitch_online.chunk_energies(buf, F, PCFG)
    ball = (PCFG.ballast * e0[0] ** 2).reshape(1)
    nb, _ = pitch_online.chunk_nccf(buf, F, PCFG, ball, backend="torch")
    np.testing.assert_array_equal(state2.cost.numpy(), -nb[0].numpy())
    assert (back.numpy() == np.arange(PCFG.n_lags)).all()
    assert int(state2.started) == 1


def test_chunk_energies_match_the_reference(rng):
    F = 16
    buf = _chunk_buf(rng, PCFG, F)
    jcfg = jax_config.PitchConfig()
    want = np.asarray(jax_online._chunk_nccf(
        jnp.asarray(buf), F, jcfg, jnp.zeros((), jnp.float32),
        None)[2])
    got = pitch_online.chunk_energies(torch.from_numpy(buf), F, PCFG).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_chunk_nccf_on_cpu_is_the_plain_nccf(rng):
    """On a CPU tensor the chunk NCCF is the plain correlation-theorem
    form, never the kernel: no launch is recorded."""
    F = 16
    buf = torch.from_numpy(_chunk_buf(rng, PCFG, F))
    ball = torch.tensor([0.37])
    before = report.launches()
    got = pitch_online.chunk_nccf(buf, F, PCFG, ball)
    want = fused_nccf.plain_nccf(buf[None], ball, PCFG, F)
    assert report.launches() == before
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w[0].numpy())
    with pytest.raises(ValueError):
        pitch_online.chunk_nccf(buf, F, PCFG, ball, backend="cuda")


def test_cuda_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OnlinePitch(PCFG)
