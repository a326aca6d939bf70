"""The port's post chain (``ops/post``), corpus CMVN (``parallel/cmvn``),
``ops/deltas.DeltaStream`` and the streaming online CMVN step against the
JAX package on the same seeded inputs, and against the float64 oracle,
with the tolerances of ``tests/test_post.py``, ``tests/test_parallel.py``
and ``tests/test_streaming.py``: sliding and online CMVN 2e-5 (2e-4 with
the variance normalized, sliding), splice and VAD exact, the streaming
step 1e-5 of the batch op, the oracle twins 1e-12, ``DeltaStream``
1e-12 of the batch deltas."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mfcc_tpu import FeatureConfig as JaxConfig, oracle as jax_oracle
from mfcc_tpu.models import streaming as jax_streaming
from mfcc_tpu.ops import post as jax_post
from mfcc_tpu.ops.deltas import DeltaStream as JaxDeltaStream
from mfcc_tpu.parallel import cmvn as jax_cmvn
from mfcc_tpu_torch import from_jax, oracle
from mfcc_tpu_torch.models import mfcc as mfcc_model, streaming
from mfcc_tpu_torch.ops import post
from mfcc_tpu_torch.ops.deltas import DeltaStream
from mfcc_tpu_torch.parallel import cmvn

MEAN_TOL = 2e-5      # tests/test_post.py, mean-normalized
VAR_TOL = 2e-4       # tests/test_post.py, sliding with variance
STEP_TOL = 1e-5      # streaming step vs the batch op


def _ragged_feats(rng, B=3, T=50, F=8):
    feat = rng.standard_normal((B, T, F)).astype(np.float32) * 3 + 1.5
    pattern = [T, max(T - 17, 1), min(5, T)]
    flens = np.asarray((pattern * (B // 3 + 1))[:B], np.int32)
    for b, n in enumerate(flens):
        feat[b, n:] = 0.0
    return feat, flens


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("window,nv", [(9, False), (21, False), (600, False),
                                       (15, True), (600, True)])
def test_sliding_cmvn_matches_jax_and_oracle(rng, window, nv):
    feat, flens = _ragged_feats(rng)
    got = post.sliding_cmvn(*_t(feat, flens), window,
                            normalize_variance=nv).numpy()
    want = np.asarray(jax_post.sliding_cmvn(jnp.asarray(feat),
                                            jnp.asarray(flens), window,
                                            normalize_variance=nv))
    tol = VAR_TOL if nv else MEAN_TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    for b, n in enumerate(flens):
        ref = oracle.sliding_cmvn(feat[b, :n].astype(np.float64), window,
                                  normalize_variance=nv)
        np.testing.assert_allclose(got[b, :n], ref, rtol=0, atol=tol)
        assert (got[b, n:] == 0).all()


@pytest.mark.parametrize("window,nv", [(7, False), (20, True), (600, True)])
def test_online_cmvn_matches_jax_and_oracle(rng, window, nv):
    feat, flens = _ragged_feats(rng)
    got = post.online_cmvn(*_t(feat, flens), window,
                           normalize_variance=nv).numpy()
    want = np.asarray(jax_post.online_cmvn(jnp.asarray(feat),
                                           jnp.asarray(flens), window,
                                           normalize_variance=nv))
    np.testing.assert_allclose(got, want, rtol=0, atol=MEAN_TOL)
    for b, n in enumerate(flens):
        ref = oracle.online_cmvn(feat[b, :n].astype(np.float64), window,
                                 normalize_variance=nv)
        np.testing.assert_allclose(got[b, :n], ref, rtol=0, atol=MEAN_TOL)
        assert not got[b, n:].any()


def test_online_cmvn_is_causal(rng):
    feat, _ = _ragged_feats(rng, B=1, T=40)
    flens = torch.tensor([40])
    a = post.online_cmvn(torch.from_numpy(feat), flens, 11)
    feat2 = feat.copy()
    feat2[0, 25:] += 100.0
    b = post.online_cmvn(torch.from_numpy(feat2), flens, 11)
    assert torch.equal(a[0, :25], b[0, :25])
    assert float((a[0, 25:] - b[0, 25:]).abs().max()) > 1.0


@pytest.mark.parametrize("nv", [False, True])
def test_online_cmvn_prior(rng, nv):
    feat, _ = _ragged_feats(rng, B=1, T=60)
    window, pc = 12, 100.0
    ps = np.full((8,), 5.0 * pc, np.float32)
    pss = (np.full((8,), 25.0, np.float32) + 4.0) * pc
    flens = np.asarray([60], np.int32)
    got = post.online_cmvn(*_t(feat, flens), window, normalize_variance=nv,
                           prior=(pc, torch.from_numpy(ps),
                                  torch.from_numpy(pss))).numpy()
    want = np.asarray(jax_post.online_cmvn(
        jnp.asarray(feat), jnp.asarray(flens), window, normalize_variance=nv,
        prior=(pc, ps, pss)))
    np.testing.assert_allclose(got, want, rtol=0, atol=MEAN_TOL)
    ref = oracle.online_cmvn(feat[0].astype(np.float64), window,
                             normalize_variance=nv,
                             prior=(pc, ps.astype(np.float64),
                                    pss.astype(np.float64)))
    np.testing.assert_allclose(got[0], ref, rtol=0, atol=MEAN_TOL)
    nopri = post.online_cmvn(*_t(feat, flens), window,
                             normalize_variance=nv).numpy()
    np.testing.assert_array_equal(got[0, window - 1:], nopri[0, window - 1:])


@pytest.mark.parametrize("left,right", [(3, 2), (0, 4), (5, 0)])
def test_splice_matches_jax_and_oracle(rng, left, right):
    feat, flens = _ragged_feats(rng)
    got = post.splice(*_t(feat, flens), left=left, right=right).numpy()
    want = np.asarray(jax_post.splice(jnp.asarray(feat), jnp.asarray(flens),
                                      left=left, right=right))
    assert got.shape == (3, 50, (left + 1 + right) * 8)
    np.testing.assert_array_equal(got, want)
    for b, n in enumerate(flens):
        np.testing.assert_array_equal(
            got[b, :n], oracle.splice(feat[b, :n].astype(np.float64), left,
                                      right))
        assert (got[b, n:] == 0).all()


@pytest.mark.parametrize("ctx", [0, 3])
def test_vad_matches_jax_and_oracle(rng, ctx):
    le = rng.standard_normal((2, 80)).astype(np.float32) * 2 - 10
    le[:, 20:40] += 8.0
    flens = np.asarray([80, 55], np.int32)
    got = post.energy_vad(*_t(le, flens), context=ctx).numpy()
    want = np.asarray(jax_post.energy_vad(jnp.asarray(le), jnp.asarray(flens),
                                          context=ctx))
    np.testing.assert_array_equal(got, want)
    for b, n in enumerate(flens):
        np.testing.assert_array_equal(
            got[b, :n], oracle.energy_vad(le[b, :n].astype(np.float64),
                                          context=ctx))
        assert not got[b, n:].any()


def test_vad_on_pipeline_energies(rng):
    cfg = from_jax(JaxConfig(append_energy=True))
    t = np.arange(16000) / 16000
    x = np.concatenate([0.5 * np.sin(2 * np.pi * 300 * t),
                        1e-4 * rng.standard_normal(16000)]).astype(np.float32)
    feat, flens, _ = mfcc_model.mfcc_batch(torch.from_numpy(x)[None],
                                           torch.tensor([x.size]), cfg)
    vad = post.energy_vad(feat[..., 0], flens, context=2)[0].numpy()
    T = int(flens[0])
    assert vad[5: T // 2 - 5].all() and not vad[T // 2 + 5: T - 5].any()


@pytest.mark.parametrize("name,args", [
    ("sliding_cmvn", (21, True)), ("online_cmvn", (13, True)),
    ("splice", (2, 3)), ("energy_vad", ()),
])
def test_oracle_post_twins(rng, name, args):
    x = rng.standard_normal((40, 6)) * 2 + 1
    if name == "energy_vad":
        x = x[:, 0]
    np.testing.assert_allclose(getattr(oracle, name)(x, *args),
                               getattr(jax_oracle, name)(x, *args),
                               rtol=0, atol=1e-12)


def test_oracle_cmvn_twins(rng):
    feats = [rng.standard_normal((n, 5)) + 3 for n in (7, 30, 12)]
    got, want = oracle.cmvn_stats(feats), jax_oracle.cmvn_stats(feats)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-15)
    np.testing.assert_allclose(oracle.apply_cmvn(feats[1], *got),
                               jax_oracle.apply_cmvn(feats[1], *want),
                               rtol=0, atol=1e-12)


def _mfcc_batch(rng):
    cfg = from_jax(JaxConfig())
    lens = np.asarray([16000, 12000, 7000, 3000], np.int32)
    x = (rng.standard_normal((4, 16000)) * 0.3).astype(np.float32)
    for i, n in enumerate(lens):
        x[i, n:] = 0.0
    feat, flens, mask = mfcc_model.mfcc_batch(*_t(x, lens), cfg)
    rows = [oracle.mfcc(x[i, :n].astype(np.float64), cfg)
            for i, n in enumerate(lens)]
    return feat, flens, mask, rows


def test_cmvn_stats_match_jax_and_oracle(rng):
    feat, flens, mask, rows = _mfcc_batch(rng)
    stats = cmvn.batch_stats(feat, mask)
    want = jax_cmvn.batch_stats(jnp.asarray(feat.numpy()),
                                jnp.asarray(mask.numpy()))
    c, s, sq = oracle.cmvn_stats(rows)
    assert int(stats.count) == int(want.count) == c
    for g, w, o in ((stats.sum, want.sum, s), (stats.sumsq, want.sumsq, sq)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), o, rtol=1e-4, atol=1e-2)
    host = cmvn.host_batch_stats(feat, flens)
    assert host.sum.dtype == torch.float64 and float(host.count) == c
    want_f64 = np.asarray(feat.numpy(), np.float64)
    np.testing.assert_allclose(host.sum.numpy(), want_f64.sum(axis=(0, 1)),
                               rtol=1e-15)
    np.testing.assert_allclose(host.sumsq.numpy(), sq, rtol=1e-6)


def test_cmvn_apply_matches_jax_and_oracle(rng):
    """Float32 statistics normalize within the reference's own envelope;
    float64 host statistics hold the oracle's apply_cmvn within 1e-4."""
    feat, flens, mask, rows = _mfcc_batch(rng)
    stats = cmvn.batch_stats(feat, mask)
    got = cmvn.apply(feat, stats).numpy()
    # the same statistics through the reference's apply (the two batch_stats
    # sum in other orders, and float32 variance cancellation turns that into
    # ~5e-4 of normalized cepstra, the reference's documented envelope)
    jstats = jax_cmvn.Stats(*(jnp.asarray(t.numpy()) for t in stats))
    want = np.asarray(jax_cmvn.apply(jnp.asarray(feat.numpy()), jstats))
    m = mask.numpy()
    np.testing.assert_allclose(got[m], want[m], rtol=0, atol=2e-6)
    sel = got[m]
    np.testing.assert_allclose(sel.mean(axis=0), 0.0, atol=1e-4)
    np.testing.assert_allclose(sel.std(axis=0), 1.0, atol=1e-3)
    host = cmvn.host_batch_stats(feat, flens)
    exact = cmvn.apply(feat, host).numpy()
    o = oracle.cmvn_stats(rows)
    for i, ref in enumerate(rows):
        np.testing.assert_allclose(exact[i, : ref.shape[0]],
                                   oracle.apply_cmvn(ref, *o), rtol=0,
                                   atol=1e-4)


def test_stats_zero_merge_mean_var():
    a = cmvn.Stats(torch.tensor(3.0), torch.ones(13), torch.ones(13))
    b = cmvn.Stats(torch.tensor(5.0), 2 * torch.ones(13), 3 * torch.ones(13))
    z = cmvn.Stats.zero(13, device="cpu")
    ab = a.merge(b).merge(z)
    assert float(ab.count) == 8.0
    np.testing.assert_allclose(ab.sum.numpy(), 3.0)
    np.testing.assert_allclose(ab.sumsq.numpy(), 4.0)
    mean, var = ab.mean_var()
    jm, jv = jax_cmvn.Stats(jnp.asarray(8.0), 3 * jnp.ones(13),
                            4 * jnp.ones(13)).mean_var()
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm), rtol=1e-7)
    np.testing.assert_allclose(var.numpy(), np.asarray(jv), rtol=1e-6)
    assert z.count.device.type == "cpu" and z.sum.shape == (13,)


@pytest.mark.parametrize("chunks", [[57], [1] * 57, [5, 20, 3, 29], [10, 47]])
def test_delta_stream_matches_batch_and_jax(rng, chunks):
    feat = rng.standard_normal((57, 13))
    d1 = oracle.deltas(feat, 2)
    want = np.concatenate([feat, d1, oracle.deltas(d1, 2)], axis=-1)
    ds, jds = DeltaStream(window=2), JaxDeltaStream(window=2)
    parts, off = [], 0
    for c in chunks:
        got = ds.push(torch.from_numpy(feat[off: off + c]))
        np.testing.assert_array_equal(got, jds.push(feat[off: off + c]))
        parts.append(got)
        off += c
    parts.append(ds.flush())
    got = np.concatenate([p for p in parts if p.size], axis=0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_delta_stream_memory_bounded(rng):
    ds = DeltaStream(window=2)
    total = sum(ds.push(rng.standard_normal((20, 13))).shape[0]
                for _ in range(50))
    assert ds._buf.shape[0] <= 20 + 8 + 8
    assert total + ds.flush().shape[0] == 1000


def _stream_cmvn(feat, S, window, nv, valids=None, prior=None):
    T, F = feat.shape
    st = streaming.init_online_cmvn(window, F, device="cpu")
    got, done, k = [], 0, 0
    while done < T:
        nv_k = min(S if valids is None else valids[k], T - done)
        k += 1
        chunk = np.zeros((S, F), np.float32)
        chunk[:nv_k] = feat[done: done + nv_k]
        st, out = streaming.online_cmvn_step(st, torch.from_numpy(chunk), nv_k,
                                             window, normalize_variance=nv,
                                             prior=prior)
        assert not out[nv_k:].any()
        got.append(out[:nv_k].numpy())
        done += nv_k
    return np.concatenate(got), st


@pytest.mark.parametrize("S,valids", [
    (8, None), (5, [0, 3, 5, 5, 1, 5, 5, 5, 5, 5, 5, 5]), (1, None),
    (47, None)])
@pytest.mark.parametrize("nv", [False, True])
def test_online_cmvn_step_matches_batch(rng, S, valids, nv):
    """Carried-state normalization == the batch online_cmvn on the same
    frames, whatever the chunking (chunks with no or some valid slots)."""
    T, F, window = 47, 13, 15
    feat = (rng.standard_normal((T, F)) * 2 + 0.7).astype(np.float32)
    want = post.online_cmvn(torch.from_numpy(feat)[None], torch.tensor([T]),
                            window, normalize_variance=nv)[0].numpy()
    got, st = _stream_cmvn(feat, S, window, nv, valids)
    np.testing.assert_allclose(got, want, rtol=0, atol=STEP_TOL)
    assert int(st.frames_seen) == T
    ref = oracle.online_cmvn(feat.astype(np.float64), window,
                             normalize_variance=nv)
    np.testing.assert_allclose(got, ref, rtol=0, atol=MEAN_TOL)


def test_online_cmvn_step_matches_jax_step_with_prior(rng):
    T, F, window, S = 30, 6, 12, 7
    feat = (rng.standard_normal((T, F)) * 2 + 3).astype(np.float32)
    prior = (50.0, np.full((F,), 150.0, np.float32),
             np.full((F,), 500.0, np.float32))
    got, _ = _stream_cmvn(feat, S, window, True,
                          prior=(prior[0], *map(torch.from_numpy, prior[1:])))
    jst = jax_streaming.init_online_cmvn(window, F)
    want, done = [], 0
    while done < T:
        nv_k = min(S, T - done)
        chunk = np.zeros((S, F), np.float32)
        chunk[:nv_k] = feat[done: done + nv_k]
        jst, out = jax_streaming.online_cmvn_step(
            jst, jnp.asarray(chunk), jnp.asarray(nv_k, jnp.int32), window,
            normalize_variance=True, prior=prior)
        want.append(np.asarray(out)[:nv_k])
        done += nv_k
    np.testing.assert_allclose(got, np.concatenate(want), rtol=0,
                               atol=STEP_TOL)
    batch = post.online_cmvn(torch.from_numpy(feat)[None], torch.tensor([T]),
                             window, normalize_variance=True,
                             prior=(prior[0], *map(torch.from_numpy,
                                                   prior[1:])))[0]
    np.testing.assert_allclose(got, batch.numpy(), rtol=0, atol=STEP_TOL)
