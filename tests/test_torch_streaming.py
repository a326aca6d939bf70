"""The port's streaming (``models/streaming``) against the JAX package on the
same seeded inputs and against the float64 oracle, with the bounds of
``tests/test_streaming.py``: the scan path within 1e-5 of the reference's
``process_chunk`` and of the port's batch plain path (the spectrogram 2e-4
inside its 50 dB window), within 1e-4 of the oracle; K chunks a call
exactly K single steps; B sessions a call the per-session loop; the fused
serving path on the CPU within 5e-5 of the scan path across dispatches
(its dither drawn at the same absolute positions); the reference's
refusals; and a JAX stream's state carried across mid-stream."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mfcc_tpu import FeatureConfig as JaxConfig, oracle as jax_oracle
from mfcc_tpu.models import streaming as jax_streaming
from mfcc_tpu.parallel import cmvn as jax_cmvn
from mfcc_tpu_torch import from_jax, oracle
from mfcc_tpu_torch.models import logmel as logmel_model, mfcc as mfcc_model
from mfcc_tpu_torch.models import plp as plp_model
from mfcc_tpu_torch.models import spectrogram as spec_model, streaming
from mfcc_tpu_torch.ops import post
from mfcc_tpu_torch.parallel import cmvn

VARIANTS = ("mfcc", "logmel", "plp", "spec")
STREAM_TOL = 1e-5     # scan path vs batch and vs the reference's step
FUSED_TOL = 5e-5      # fused serving path vs the scan path
SPEC_TOL = 2e-4       # the spectrogram, inside the 50 dB window
ORACLE_TOL = 1e-4
SPEC_WINDOW = np.log(10.0 ** 5)


def _cfg(variant, **kw):
    jc = JaxConfig(**({"dynamic_range_db": 50.0} if variant == "logmel"
                      else {}), **kw).validate()
    return jc, from_jax(jc)


def _close(variant, got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if variant == "spec" and want.size:
        keep = want > want.max(axis=-1, keepdims=True) - SPEC_WINDOW
        assert np.abs(got - want)[keep].max() <= SPEC_TOL
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _stream(x, cfg, chunk_frames, variant="mfcc"):
    """Feed x chunk by chunk through process_chunk, keep the valid slots."""
    C = chunk_frames * cfg.hop_len
    st = streaming.init_state(cfg, device="cpu")
    out = []
    for k in range(len(x) // C):
        st, feat, nv = streaming.process_chunk(
            st, torch.from_numpy(x[k * C:(k + 1) * C]), cfg, variant)
        out.append(feat[: int(nv)])
    return torch.cat(out).numpy(), st


def _batch_plain(x, cfg, variant):
    """The port's batch model of the variant on the CPU."""
    xs, n = torch.from_numpy(x)[None], torch.tensor([x.size])
    if variant == "plp":
        return plp_model.plp_batch(xs, n, cfg)[0][0].numpy()
    if variant == "spec":
        return spec_model.log_spectrogram_batch(xs, n, cfg)[0][0].numpy()
    if variant == "logmel":
        return logmel_model.log_mel_batch(xs, n, cfg)[0][0].numpy()
    return mfcc_model.mfcc_batch(xs, n, cfg)[0][0].numpy()


@pytest.mark.parametrize("variant", VARIANTS)
def test_process_chunk_matches_jax(speechlike, variant):
    jc, cfg = _cfg(variant)
    C = 10 * cfg.hop_len
    st = streaming.init_state(cfg, device="cpu")
    jst = jax_streaming.init_state(jc)
    for k in range(4):
        chunk = speechlike[k * C:(k + 1) * C]
        st, f, nv = streaming.process_chunk(st, torch.from_numpy(chunk), cfg,
                                            variant)
        jst, jf, jnv = jax_streaming.process_chunk_jit(
            jst, jnp.asarray(chunk), jc, variant)
        assert int(nv) == int(jnv) and f.shape == jf.shape
        _close(variant, f.numpy(), np.asarray(jf), STREAM_TOL)
        np.testing.assert_array_equal(st.carry.numpy(), np.asarray(jst.carry))
        assert int(st.samples_seen) == int(jst.samples_seen)
        assert int(st.frames_done) == int(jst.frames_done)


@pytest.mark.parametrize("variant", VARIANTS)
def test_streaming_matches_batch_and_oracle(speechlike, variant):
    jc, cfg = _cfg(variant)
    x = speechlike[: 16000 - 16000 % (10 * cfg.hop_len)]
    got, st = _stream(x, cfg, 10, variant)
    assert got.shape[0] == cfg.num_frames(x.size) == int(st.frames_done)
    _close(variant, got, _batch_plain(x, cfg, variant), STREAM_TOL)
    ref = {"mfcc": oracle.mfcc, "logmel": oracle.log_mel, "plp": oracle.plp,
           "spec": oracle.log_spectrogram}[variant](x.astype(np.float64), cfg)
    _close(variant, got, ref, ORACLE_TOL)


@pytest.mark.parametrize("chunk_frames", [1, 4, 25])
def test_streaming_chunk_sizes_and_preemph_continuity(rng, chunk_frames):
    """The chunk-boundary predecessor comes from the previous chunk; the
    frames do not depend on how the stream is cut."""
    _, cfg = _cfg("mfcc")
    x = rng.standard_normal(8000).astype(np.float32)
    got, _ = _stream(x, cfg, chunk_frames)
    np.testing.assert_allclose(got, oracle.mfcc(x.astype(np.float64), cfg)
                               [: got.shape[0]], rtol=0, atol=ORACLE_TOL)
    np.testing.assert_allclose(got, _batch_plain(x, cfg, "mfcc")
                               [: got.shape[0]], rtol=0, atol=STREAM_TOL)


def test_first_chunks_shorter_than_a_frame():
    _, cfg = _cfg("mfcc")
    st = streaming.init_state(cfg, device="cpu")
    chunk = torch.zeros(cfg.hop_len)
    for want in (0, 0, 1):       # 160, 320, 480 samples; the frame is 400
        st, feat, nv = streaming.process_chunk(st, chunk, cfg)
        assert int(nv) == want and feat.shape == (1, cfg.n_mfcc)


def test_int16_chunks(rng):
    _, cfg = _cfg("mfcc")
    pcm = (rng.standard_normal(3200) * 8000).astype(np.int16)
    a = streaming.process_chunk(streaming.init_state(cfg, device="cpu"),
                                torch.from_numpy(pcm), cfg)
    b = streaming.process_chunk(streaming.init_state(cfg, device="cpu"),
                                torch.from_numpy(pcm.astype(np.float32)
                                                 / 32768.0), cfg)
    assert int(a[2]) == int(b[2])
    assert torch.equal(a[1], b[1])


def test_k_chunks_equal_k_steps_exactly(speechlike):
    _, cfg = _cfg("mfcc")
    K, C = 5, 10 * cfg.hop_len
    chunks = torch.from_numpy(speechlike[: K * C].reshape(K, C))
    st0 = streaming.init_state(cfg, device="cpu")
    st_k, feats, nvs = streaming.process_chunks(st0, chunks, cfg)
    st = st0
    for k in range(K):
        st, f, nv = streaming.process_chunk(st, chunks[k], cfg)
        assert torch.equal(feats[k], f) and int(nvs[k]) == int(nv)
    for a, b in zip(st_k, st):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant", ["mfcc", "plp"])
def test_batched_sessions_equal_single_sessions(rng, variant):
    """B sessions advanced together equal the per-session loop."""
    _, cfg = _cfg(variant)
    B, n_chunks, cf = 3, 6, 10
    C = cf * cfg.hop_len
    xs = (rng.standard_normal((B, n_chunks * C)) * 0.4).astype(np.float32)
    st = streaming.init_state_batch(B, cfg, device="cpu")
    outs = [[] for _ in range(B)]
    for k in range(n_chunks):
        st, feat, nv = streaming.process_chunk_batch(
            st, torch.from_numpy(xs[:, k * C:(k + 1) * C]), cfg, variant)
        for b in range(B):
            outs[b].append(feat[b, : int(nv[b])])
    for b in range(B):
        want, _ = _stream(xs[b], cfg, cf, variant)
        np.testing.assert_allclose(torch.cat(outs[b]).numpy(), want, rtol=0,
                                   atol=STREAM_TOL)


def test_sessions_at_different_offsets(rng):
    """Sessions whose samples_seen and frames_done differ in one call."""
    _, cfg = _cfg("mfcc", dither=1 / 32768)
    C = 8 * cfg.hop_len
    a = (rng.standard_normal(4 * C) * 0.3).astype(np.float32)
    b = (rng.standard_normal(4 * C) * 0.3).astype(np.float32)
    single = [streaming.init_state(cfg, device="cpu") for _ in range(2)]
    # session a runs one chunk ahead of session b
    single[0], _, _ = streaming.process_chunk(single[0],
                                              torch.from_numpy(a[:C]), cfg)
    st = streaming.StreamState(*(torch.stack([s0, s1]) for s0, s1
                                 in zip(single[0], single[1])))
    for k in range(3):
        chunks = torch.from_numpy(np.stack([a[(k + 1) * C:(k + 2) * C],
                                            b[k * C:(k + 1) * C]]))
        st, feat, nv = streaming.process_chunk_batch(st, chunks, cfg)
        for i in range(2):
            single[i], f, n = streaming.process_chunk(single[i], chunks[i],
                                                      cfg)
            assert int(nv[i]) == int(n)
            np.testing.assert_allclose(feat[i].numpy(), f.numpy(), rtol=0,
                                       atol=STREAM_TOL)
    assert st.samples_seen.tolist() == [4 * C, 3 * C]


def test_multichunk_multisession_matches_jax(speechlike):
    jc, cfg = _cfg("mfcc")
    B, K, cf = 3, 4, 8
    C = cf * cfg.hop_len
    xs = np.stack([np.roll(speechlike, 100 * b)[: K * C] for b in range(B)])
    chunks = xs.reshape(B, K, C)
    st, feats, nvs = streaming.process_chunks_batch(
        streaming.init_state_batch(B, cfg, device="cpu"),
        torch.from_numpy(chunks), cfg)
    jst, jfeats, jnvs = jax_streaming.process_chunks_batch_jit(
        jax_streaming.init_state_batch(B, jc), jnp.asarray(chunks), jc)
    assert feats.shape == (B, K, cf, cfg.n_mfcc)
    np.testing.assert_array_equal(nvs.numpy(), np.asarray(jnvs))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=0,
                               atol=STREAM_TOL)
    np.testing.assert_array_equal(st.carry.numpy(), np.asarray(jst.carry))


@pytest.mark.parametrize("variant", VARIANTS)
def test_fused_serving_matches_scan_path(speechlike, variant):
    """The fused serving path on the CPU (the kernel's plain version at
    preemph 0 on the host-pre-emphasized span) emits the scan path's frames
    contiguously, across two dispatches (start-up shift and carry)."""
    _, cfg = _cfg(variant)
    B, K, cf = 2, 3, 8
    C = cf * cfg.hop_len
    xs = np.stack([speechlike[: 2 * K * C],
                   np.roll(speechlike, 777)[: 2 * K * C]])
    st_s = streaming.init_state_batch(B, cfg, device="cpu")
    st_f = streaming.init_state_batch(B, cfg, device="cpu")
    for d in range(2):
        chunks = torch.from_numpy(xs[:, d * K * C:(d + 1) * K * C]
                                  .reshape(B, K, C))
        st_s, feats_s, nvs = streaming.process_chunks_batch(st_s, chunks, cfg,
                                                            variant)
        st_f, feats_f, n_new = streaming.process_chunks_batch_fused(
            st_f, chunks, cfg, variant)
        assert feats_f.shape == (B, K * cf, feats_s.shape[-1])
        for b in range(B):
            want = torch.cat([feats_s[b, k, : int(nvs[b, k])]
                              for k in range(K)]).numpy()
            assert int(n_new[b]) == want.shape[0]
            _close(variant, feats_f[b, : want.shape[0]].numpy(), want,
                   FUSED_TOL)
            assert not feats_f[b, want.shape[0]:].any()
        assert torch.equal(st_f.carry, st_s.carry)
        assert torch.equal(st_f.frames_done, st_s.frames_done)
        assert torch.equal(st_f.samples_seen, st_s.samples_seen)


def test_fused_serving_matches_jax_fused(speechlike):
    """Against the reference's fused path (its Pallas kernel in interpret
    mode on the CPU): the kernel-vs-XLA envelope, 5e-5."""
    jc, cfg = _cfg("mfcc")
    B, K, cf = 2, 2, 8
    C = cf * cfg.hop_len
    chunks = np.stack([speechlike[: K * C],
                       np.roll(speechlike, 333)[: K * C]]).reshape(B, K, C)
    st, feats, n_new = streaming.process_chunks_batch_fused(
        streaming.init_state_batch(B, cfg, device="cpu"),
        torch.from_numpy(chunks), cfg)
    jst, jfeats, jn = jax_streaming.process_chunks_batch_fused_jit(
        jax_streaming.init_state_batch(B, jc), jnp.asarray(chunks), jc)
    np.testing.assert_array_equal(n_new.numpy(), np.asarray(jn))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=0,
                               atol=FUSED_TOL)
    np.testing.assert_array_equal(st.carry.numpy(), np.asarray(jst.carry))


@pytest.mark.parametrize("path", ["fused", "scan"])
def test_dither_positions_consistent_across_dispatches(speechlike, path):
    """Noise is indexed by absolute position: the fused path's per-session
    starts reproduce the scan path's stream across dispatch boundaries, and
    the scan path reproduces the batch pipeline dithering the whole
    signal."""
    _, cfg = _cfg("mfcc", dither=1 / 32768)
    B, K, cf = 2, 3, 8
    C = cf * cfg.hop_len
    xs = np.stack([speechlike[: 2 * K * C],
                   np.roll(speechlike, 777)[: 2 * K * C]])
    st_s = streaming.init_state_batch(B, cfg, device="cpu")
    st_f = streaming.init_state_batch(B, cfg, device="cpu")
    rows = [[] for _ in range(B)]
    for d in range(2):
        chunks = torch.from_numpy(xs[:, d * K * C:(d + 1) * K * C]
                                  .reshape(B, K, C))
        st_s, feats_s, nvs = streaming.process_chunks_batch(st_s, chunks, cfg)
        st_f, feats_f, _ = streaming.process_chunks_batch_fused(st_f, chunks,
                                                                cfg)
        for b in range(B):
            want = torch.cat([feats_s[b, k, : int(nvs[b, k])]
                              for k in range(K)])
            got = feats_f[b, : want.shape[0]] if path == "fused" else want
            rows[b].append(got)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=FUSED_TOL)
    for b in range(B):
        got = torch.cat(rows[b]).numpy()
        batch = _batch_plain(xs[b], cfg, "mfcc")[: got.shape[0]]
        np.testing.assert_allclose(got, batch, rtol=0,
                                   atol=STREAM_TOL if path == "scan"
                                   else FUSED_TOL)
        assert np.abs(got - _batch_plain(xs[b], cfg.replace(dither=0.0),
                                         "mfcc")[: got.shape[0]]).max() > 0


def test_fused_serving_refuses_unbounded_logmel(speechlike):
    _, cfg = _cfg("mfcc")
    C = 8 * cfg.hop_len
    chunks = torch.from_numpy(speechlike[: 2 * C].reshape(1, 2, C))
    st = streaming.init_state_batch(1, cfg, device="cpu")
    with pytest.raises(ValueError, match="dynamic_range_db"):
        streaming.process_chunks_batch_fused(st, chunks, cfg, "logmel")
    with pytest.raises(ValueError, match="dynamic_range_db"):
        streaming.process_chunks_batch_fused(
            st, chunks, cfg.replace(dynamic_range_db=60.0), "logmel")


@pytest.mark.parametrize("kw,variant", [
    (dict(sample_rate=44100, n_fft=2048), "mfcc"),   # hop 441: odd
    (dict(n_fft=400), "spec"),               # n_fft / 2 not lane-aligned
])
def test_fused_serving_refuses_ineligible_configs(kw, variant):
    cfg = from_jax(JaxConfig(**kw).validate())
    C = 4 * cfg.hop_len
    st = streaming.init_state_batch(1, cfg, device="cpu")
    assert not streaming.fused_eligible(cfg, variant)
    with pytest.raises(ValueError, match="not eligible"):
        streaming.process_chunks_batch_fused(st, torch.zeros((1, 2, C)), cfg,
                                             variant)
    # the scan path takes them
    streaming.process_chunks_batch(st, torch.zeros((1, 2, C)), cfg, variant)


@pytest.mark.parametrize("call", ["chunk", "fused"])
def test_streaming_refusals(call):
    cfg = from_jax(JaxConfig())
    st = streaming.init_state_batch(1, cfg, device="cpu")
    fn = (streaming.process_chunk_batch if call == "chunk"
          else lambda s, x, c, v="mfcc": streaming.process_chunks_batch_fused(
              s, x[:, None], c, v))
    with pytest.raises(ValueError, match="variant"):
        fn(st, torch.zeros((1, 160)), cfg, "nope")
    with pytest.raises(ValueError, match="multiple of hop"):
        fn(st, torch.zeros((1, 100)), cfg)
    with pytest.raises(ValueError, match="valid"):
        fn(st, torch.zeros((1, 160)), cfg.replace(frame_mode="center"))
    # "high" has no kernel route: the fused path refuses it as the
    # reference does (models/streaming.py:264-267), the scan path
    # computes it; accum_dtype bfloat16 computes on both (the fused path
    # at float32, as the reference's kernel), an unknown one raises
    high = cfg.replace(matmul_precision="high")
    if call == "fused":
        with pytest.raises(ValueError, match="high"):
            fn(st, torch.zeros((1, 160)), high)
    else:
        _, got, _ = fn(st, torch.zeros((1, 160)), high)
        _, want, _ = fn(st, torch.zeros((1, 160)), cfg)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="accum_dtype"):
        fn(st, torch.zeros((1, 160)), cfg.replace(accum_dtype="int32"))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 1600)).astype(np.float32))
    _, got, _ = fn(st, x, cfg.replace(accum_dtype="bfloat16"))
    _, want, _ = fn(st, x, cfg)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want) == (call == "fused")


def test_stream_signal_matches_stepwise(speechlike):
    _, cfg = _cfg("mfcc")
    x = speechlike[: 16000 - 16000 % (8 * cfg.hop_len)]
    feats, total = streaming.stream_signal(torch.from_numpy(x), cfg,
                                           chunk_frames=8)
    stepwise, _ = _stream(x, cfg, 8)
    assert int(total) == stepwise.shape[0]
    nz = np.where(np.any(feats.numpy() != 0.0, axis=1))[0]
    np.testing.assert_array_equal(feats.numpy()[nz], stepwise)


def test_state_constructors_take_a_device():
    _, cfg = _cfg("mfcc")
    st = streaming.init_state_batch(4, cfg, device="cpu")
    assert st.carry.shape == (4, cfg.frame_len)
    assert st.samples_seen.dtype == st.frames_done.dtype == torch.int64
    cst = streaming.init_online_cmvn(9, 13, device="cpu")
    assert cst.buf.shape == (8, 13) and cst.offset.shape == (13,)


def _to_numpy(state):
    return jax.tree.map(np.asarray, state)


@pytest.mark.parametrize("variant", ["mfcc", "spec"])
def test_jax_stream_state_carried_across(speechlike, variant):
    """A JAX stream runs three chunks; its state, carried into the port,
    finishes the stream to the same frames as the JAX stream itself."""
    jc, cfg = _cfg(variant, dither=1 / 32768)
    C = 10 * cfg.hop_len
    jst = jax_streaming.init_state(jc)
    for k in range(3):
        jst, _, _ = jax_streaming.process_chunk_jit(
            jst, jnp.asarray(speechlike[k * C:(k + 1) * C]), jc, variant)
    st = streaming.state_from_jax(_to_numpy(jst), device="cpu")
    assert isinstance(st, streaming.StreamState)
    assert st.samples_seen.dtype == torch.int64 and int(st.samples_seen) == 3 * C
    for k in range(3, 6):
        chunk = speechlike[k * C:(k + 1) * C]
        st, f, nv = streaming.process_chunk(st, torch.from_numpy(chunk), cfg,
                                            variant)
        jst, jf, jnv = jax_streaming.process_chunk_jit(
            jst, jnp.asarray(chunk), jc, variant)
        assert int(nv) == int(jnv)
        _close(variant, f.numpy(), np.asarray(jf), STREAM_TOL)


def test_jax_batch_state_carried_into_the_fused_path(speechlike):
    jc, cfg = _cfg("mfcc")
    B, K, C = 2, 2, 8 * cfg.hop_len
    xs = np.stack([speechlike[: 2 * K * C],
                   np.roll(speechlike, 555)[: 2 * K * C]])
    first = jnp.asarray(xs[:, : K * C].reshape(B, K, C))
    jst, _, _ = jax_streaming.process_chunks_batch_jit(
        jax_streaming.init_state_batch(B, jc), first, jc)
    st = streaming.state_from_jax(dict(_to_numpy(jst)._asdict()),
                                  device="cpu")
    second = xs[:, K * C:].reshape(B, K, C)
    st, feats, n_new = streaming.process_chunks_batch_fused(
        st, torch.from_numpy(second), cfg)
    jst, jfeats, jnvs = jax_streaming.process_chunks_batch_jit(
        jst, jnp.asarray(second), jc)
    for b in range(B):
        want = np.concatenate([np.asarray(jfeats[b, k])[: int(jnvs[b, k])]
                               for k in range(K)])
        assert int(n_new[b]) == want.shape[0]
        np.testing.assert_allclose(feats[b, : want.shape[0]].numpy(), want,
                                   rtol=0, atol=FUSED_TOL)


def test_jax_online_cmvn_state_carried_across(rng):
    T, F, window, S = 40, 13, 15, 8
    feat = (rng.standard_normal((T, F)) * 2 + 0.7).astype(np.float32)
    jst = jax_streaming.init_online_cmvn(window, F)
    for k in range(2):
        jst, _ = jax_streaming.online_cmvn_step(
            jst, jnp.asarray(feat[k * S:(k + 1) * S]), jnp.asarray(S), window,
            normalize_variance=True)
    st = streaming.state_from_jax(_to_numpy(jst), device="cpu")
    assert isinstance(st, streaming.OnlineCmvnState)
    got = []
    for k in range(2, T // S):
        st, out = streaming.online_cmvn_step(
            st, torch.from_numpy(feat[k * S:(k + 1) * S]), S, window,
            normalize_variance=True)
        got.append(out.numpy())
    want = post.online_cmvn(torch.from_numpy(feat)[None], torch.tensor([T]),
                            window, normalize_variance=True)[0].numpy()
    np.testing.assert_allclose(np.concatenate(got), want[2 * S:], rtol=0,
                               atol=STREAM_TOL)


def test_jax_cmvn_stats_carried_across(rng):
    feat = (rng.standard_normal((2, 30, 13)) * 2 + 5).astype(np.float32)
    mask = np.ones((2, 30), bool)
    jstats = jax_cmvn.batch_stats(jnp.asarray(feat), jnp.asarray(mask))
    stats = streaming.state_from_jax(_to_numpy(jstats), device="cpu")
    assert isinstance(stats, cmvn.Stats) and stats.sum.dtype == torch.float32
    merged = stats.merge(cmvn.batch_stats(torch.from_numpy(feat),
                                          torch.from_numpy(mask)))
    assert float(merged.count) == 120.0
    host = dict(count=np.float64(60.0), sum=feat.sum((0, 1)).astype(np.float64),
                sumsq=(feat.astype(np.float64) ** 2).sum((0, 1)))
    h = streaming.state_from_jax(host, device="cpu")
    assert h.sum.dtype == torch.float64
    normed = cmvn.apply(torch.from_numpy(feat), h).numpy()
    want = jax_oracle.apply_cmvn(feat.astype(np.float64), 60.0, host["sum"],
                                 host["sumsq"])
    np.testing.assert_allclose(normed, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="fields"):
        streaming.state_from_jax(dict(carry=0, samples_seen=0), device="cpu")


def test_streaming_online_cmvn_end_to_end(speechlike):
    """Streamed MFCC into streamed online CMVN == the batch pipeline and
    the batch online_cmvn on the same signal."""
    _, cfg = _cfg("mfcc")
    window = 30
    x = speechlike[:9600]
    batch = mfcc_model.mfcc(torch.from_numpy(x), cfg)
    want = post.online_cmvn(batch[None], torch.tensor([batch.shape[0]]),
                            window)[0].numpy()
    st = streaming.init_state(cfg, device="cpu")
    cst = streaming.init_online_cmvn(window, cfg.n_mfcc, device="cpu")
    C = 10 * cfg.hop_len
    got = []
    for i in range(x.size // C):
        st, feat, nv = streaming.process_chunk(
            st, torch.from_numpy(x[i * C:(i + 1) * C]), cfg)
        cst, out = streaming.online_cmvn_step(cst, feat, nv, window)
        got.append(out[: int(nv)].numpy())
    got = np.concatenate(got)
    np.testing.assert_allclose(got, want[: got.shape[0]], rtol=0,
                               atol=STREAM_TOL)
