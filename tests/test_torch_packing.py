"""Packed ragged batches and the long-signal API against the JAX package.

- ``utils/batch`` is a copy of the reference's numpy module: every packer,
  padder and ladder gives the same output on the same input.
- ``mfcc_batch_packed``, all four families, on the CPU's plain chain: each
  segment equals the standalone computation of its utterance bit for bit
  (hop-aligned rows, the predecessor in the gap sample), also for split
  packing and int16 input; against the reference's XLA
  ``mfcc_batch_packed`` (cepstra 2e-5, log-mel rtol 1e-4 plus atol 1e-4,
  PLP 5e-5, the spectrogram 2e-4 inside its 50 dB window) and the float64
  oracle (1e-4; unbounded log-mel 1e-3; the spectrogram 2e-4 in the
  window); the reference's guards.
- ``mfcc_long`` against the reference's ``mfcc_long`` (2e-5, its blocked
  rows included) and bit for bit against the port's ``mfcc``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mfcc_tpu import FeatureConfig as JaxConfig
from mfcc_tpu.models import mfcc as jax_mfcc
from mfcc_tpu.utils import batch as jax_batch
from mfcc_tpu_torch import from_jax, oracle
from mfcc_tpu_torch.models import mfcc as mfcc_model, plp as plp_model
from mfcc_tpu_torch.models import spectrogram as spec_model
from mfcc_tpu_torch.utils import batch

HOP = 160
# family -> (config, oracle twin, tolerance vs the reference's XLA path,
# tolerance vs the oracle)
FAMILIES = {
    "mfcc": (dict(), oracle.mfcc, 2e-5, 1e-4),
    "logmel": (dict(n_mels=40, n_mfcc=40), oracle.log_mel, 1e-4, 1e-3),
    "plp": (dict(), oracle.plp, 5e-5, 1e-4),
    "spec": (dict(), oracle.log_spectrogram, 2e-4, 2e-4),
}
SPEC_WINDOW = np.log(10.0 ** 5)    # 50 dB below each frame's peak


def _ragged(rng, n_utts=6, lo=8000, hi=16000):
    return [(f"u{i}", (rng.standard_normal(int(rng.integers(lo, hi)))
                       * 0.3).astype(np.float32)) for i in range(n_utts)]


def _packed(sigs, capacity=5 * 16000, split=False, frame_len=400):
    """-> (x (B, C), starts (B, S), lens (B, S), rows or pieces)."""
    by_id = dict(sigs)
    infos = [(k, len(v)) for k, v in sigs]
    rows = list(batch.pack_rows_split(infos, capacity, HOP, frame_len)
                if split else batch.pack_rows(infos, capacity, HOP, 16))
    S = max(len(r.segments) for r in rows)
    x = np.zeros((len(rows), capacity), np.float32)
    starts = np.zeros((len(rows), S), np.int32)
    lens = np.zeros((len(rows), S), np.int32)
    segs = []
    for b, row in enumerate(rows):
        if split:
            sig, st, ln, pcs = batch.pack_audio_split(row, by_id.__getitem__)
            segs.append(pcs)
        else:
            sig, st, ln = batch.pack_audio(row, by_id.__getitem__)
            segs.append(row.segments)
        x[b] = sig
        starts[b, : len(st)], lens[b, : len(ln)] = st, ln
    return x, starts, lens, segs


def _standalone(family, x, cfg):
    """The standalone batch model of the family on one utterance (1, n)."""
    xs, n = torch.from_numpy(x[None]), torch.tensor([x.shape[0]])
    if family == "plp":
        return plp_model.plp_batch(xs, n, cfg)[0][0]
    if family == "spec":
        return spec_model.log_spectrogram_batch(xs, n, cfg)[0][0]
    return mfcc_model.features_batch(xs, n, cfg,
                                     apply_dct=family == "mfcc")[0][0]


def _close(family, got, want, tol):
    if family == "spec":
        keep = want > want.max(axis=-1, keepdims=True) - SPEC_WINDOW
        assert np.abs(got - want)[keep].max() <= tol
    elif family == "logmel":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=tol)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("name,args", [
    ("bucket_ladder", (16000, 480000)),
    ("bucket_ladder", (1000, 9000, 1.5)),
    ("pick_bucket", (17000, [16000, 32000, 64000])),
    ("pick_bucket", (99999, [16000, 32000])),
])
def test_batch_helpers_match_reference(name, args):
    assert getattr(batch, name)(*args) == getattr(jax_batch, name)(*args)


@pytest.mark.parametrize("split", [False, True])
def test_packers_match_reference(rng, split):
    sigs = _ragged(rng, n_utts=9, lo=3000, hi=30000)
    by_id = dict(sigs)
    infos = [(k, len(v)) for k, v in sigs]
    C = 2 * 16000
    if split:
        rows = list(batch.pack_rows_split(infos, C, HOP, 400))
        want = list(jax_batch.pack_rows_split(infos, C, HOP, 400))
    else:
        rows = list(batch.pack_rows(infos, C, HOP, lookahead=4))
        want = list(jax_batch.pack_rows(infos, C, HOP, lookahead=4))
    assert [(r.capacity, [tuple(vars(s).values()) if split else s
                          for s in r.segments]) for r in rows] == \
        [(r.capacity, [tuple(vars(s).values()) if split else s
                       for s in r.segments]) for r in want]
    pack = batch.pack_audio_split if split else batch.pack_audio
    jpack = jax_batch.pack_audio_split if split else jax_batch.pack_audio
    for r, w in zip(rows, want):
        for a, b in zip(pack(r, by_id.__getitem__)[:3],
                        jpack(w, by_id.__getitem__)[:3]):
            np.testing.assert_array_equal(a, b)


def test_make_batches_and_path_batches_match_reference(rng):
    sigs = _ragged(rng, n_utts=11, lo=3000, hi=40000)
    got = list(batch.make_batches(sigs, 4, min_bucket=8000,
                                  max_bucket=32000))
    want = list(jax_batch.make_batches(sigs, 4, min_bucket=8000,
                                       max_bucket=32000))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.audio, w.audio)
        np.testing.assert_array_equal(g.lengths, w.lengths)
        assert g.ids == w.ids
    infos = [(k, len(v)) for k, v in sigs]
    ladder = batch.bucket_ladder(8000, 40000)
    assert [vars(b) for b in batch.make_path_batches(infos, 3, ladder)] == \
        [vars(b) for b in jax_batch.make_path_batches(infos, 3, ladder)]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_packed_segments_equal_standalone_bitwise(rng, family):
    """On the CPU's plain chain a packed segment is its standalone
    utterance bit for bit; frames outside every segment are zero."""
    sigs = _ragged(rng)
    by_id = dict(sigs)
    cfg = from_jax(JaxConfig(**FAMILIES[family][0]).validate())
    x, starts, lens, rows = _packed(sigs)
    feat, f0, fc, mask = mfcc_model.mfcc_batch_packed(
        torch.from_numpy(x), torch.from_numpy(starts), torch.from_numpy(lens),
        cfg, family=family)
    assert f0.dtype == fc.dtype == torch.int32 and mask.dtype == torch.bool
    odd = 0
    for b, segs in enumerate(rows):
        for j, (uid, off, n) in enumerate(segs):
            assert int(fc[b, j]) == cfg.num_frames(n)
            odd += int(f0[b, j]) % 2
            got = feat[b, f0[b, j]: f0[b, j] + fc[b, j]]
            assert torch.equal(got, _standalone(family, by_id[uid][:n], cfg))
    assert odd > 0, "no segment at an odd frame offset"
    assert bool((feat[~mask] == 0).all())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_packed_matches_reference_and_oracle(rng, family):
    kw, oracle_fn, tol, oracle_tol = FAMILIES[family]
    jc = JaxConfig(**kw).validate()
    cfg = from_jax(jc)
    sigs = _ragged(rng, n_utts=4)
    by_id = dict(sigs)
    x, starts, lens, rows = _packed(sigs, capacity=3 * 16000)
    got = mfcc_model.mfcc_batch_packed(
        torch.from_numpy(x), torch.from_numpy(starts), torch.from_numpy(lens),
        cfg, family=family)
    want = jax_mfcc.mfcc_batch_packed_jit(
        jnp.asarray(x), jnp.asarray(starts), jnp.asarray(lens), jc, "xla",
        family=family)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _close(family, got[0].numpy(), np.asarray(want[0]), tol)
    f0, fc = got[1].numpy(), got[2].numpy()
    for b, segs in enumerate(rows):
        for j, (uid, off, n) in enumerate(segs):
            ref = oracle_fn(by_id[uid][:n].astype(np.float64), cfg)
            _close(family, got[0].numpy()[b, f0[b, j]: f0[b, j] + fc[b, j]],
                   ref, oracle_tol)


def test_split_packed_pieces_equal_standalone_bitwise(rng):
    """Split packing: pieces continue across rows at frame boundaries and
    reassemble to the standalone features bit for bit (the continuation's
    gap holds its true preceding sample)."""
    cfg = from_jax(JaxConfig())
    sigs = _ragged(rng, n_utts=7, lo=9000, hi=30000)
    x, starts, lens, pieces = _packed(sigs, capacity=2 * 16000, split=True)
    feat, f0, fc, _ = mfcc_model.mfcc_batch_packed(
        torch.from_numpy(x), torch.from_numpy(starts), torch.from_numpy(lens),
        cfg)
    for uid, sig in sigs:
        rebuilt = torch.zeros((cfg.num_frames(len(sig)), cfg.n_mfcc))
        covered = np.zeros(rebuilt.shape[0], bool)
        for b, pcs in enumerate(pieces):
            for j, pc in enumerate(pcs):
                if pc.uid == uid:
                    assert int(fc[b, j]) == pc.n_frames
                    rebuilt[pc.frame_start: pc.frame_start + pc.n_frames] = \
                        feat[b, f0[b, j]: f0[b, j] + fc[b, j]]
                    covered[pc.frame_start: pc.frame_start + pc.n_frames] = True
        assert covered.all()
        assert torch.equal(rebuilt, _standalone("mfcc", sig, cfg))


def test_packed_int16_and_empty_slots(rng):
    cfg = from_jax(JaxConfig())
    sigs = _ragged(rng, n_utts=3)
    x, starts, lens, _ = _packed(sigs)
    x16 = np.round(x * 8000).astype(np.int16)
    starts = np.concatenate([starts, np.zeros_like(starts[:, :1])], axis=1)
    lens = np.concatenate([lens, np.zeros_like(lens[:, :1])], axis=1)
    got = mfcc_model.mfcc_batch_packed(torch.from_numpy(x16),
                                       torch.from_numpy(starts),
                                       torch.from_numpy(lens), cfg)
    want = jax_mfcc.mfcc_batch_packed_jit(
        jnp.asarray(x16), jnp.asarray(starts), jnp.asarray(lens),
        JaxConfig(), "xla")
    assert int(got[2][:, -1].abs().sum()) == 0          # empty slot
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("kw,match", [
    (dict(cfg=dict(deltas=True)), "deltas"),
    (dict(cfg=dict(frame_mode="center")), "valid"),
    (dict(family="pitch"), "family"),
    (dict(cfg=dict(accum_dtype="int32")), "accum_dtype"),
])
def test_packed_guards(kw, match):
    x = torch.zeros((1, 16000))
    s = torch.zeros((1, 1), dtype=torch.int32)
    n = torch.full((1, 1), 16000, dtype=torch.int32)
    cfg = from_jax(JaxConfig(**kw.get("cfg", {})))
    with pytest.raises(ValueError, match=match):
        mfcc_model.mfcc_batch_packed(x, s, n, cfg,
                                     family=kw.get("family", "mfcc"))


def test_packed_family_defaults_follow_apply_dct(rng):
    cfg = from_jax(JaxConfig(n_mels=40, n_mfcc=40))
    sigs = _ragged(rng, n_utts=2)
    x, starts, lens, _ = _packed(sigs)
    args = (torch.from_numpy(x), torch.from_numpy(starts),
            torch.from_numpy(lens), cfg)
    assert torch.equal(mfcc_model.mfcc_batch_packed(*args, apply_dct=False)[0],
                       mfcc_model.mfcc_batch_packed(*args, family="logmel")[0])
    assert torch.equal(mfcc_model.mfcc_batch_packed(*args)[0],
                       mfcc_model.mfcc_batch_packed(*args, family="mfcc")[0])


@pytest.mark.parametrize("row_frames", [128, 511])
@pytest.mark.parametrize("kw", [dict(), dict(deltas=True, dither=1 / 32768),
                                dict(frame_mode="center")])
def test_mfcc_long_matches_reference_and_mfcc(rng, row_frames, kw):
    """The reference blocks rows past row_frames; the port never does, and
    equals its own mfcc bit for bit."""
    jc = JaxConfig(**kw).validate()
    cfg = from_jax(jc)
    x = (rng.standard_normal(3 * 16000 + 1234) * 0.3).astype(np.float32)
    got = mfcc_model.mfcc_long(torch.from_numpy(x), cfg, row_frames=row_frames)
    assert torch.equal(got, mfcc_model.mfcc(torch.from_numpy(x), cfg))
    want = np.asarray(jax_mfcc.mfcc_long(jnp.asarray(x), jc, "xla",
                                         row_frames))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_mfcc_long_int16_and_log_mel(rng):
    jc = JaxConfig(n_mels=40, n_mfcc=40).validate()
    x = np.round(rng.standard_normal(20000) * 3000).astype(np.int16)
    got = mfcc_model.mfcc_long(torch.from_numpy(x), from_jax(jc),
                               apply_dct=False)
    want = np.asarray(jax_mfcc.mfcc_long(jnp.asarray(x), jc, "xla", 64,
                                         apply_dct=False))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("row_frames", [0, -3, 1.5, True, "511"])
def test_mfcc_long_checks_row_frames(row_frames):
    with pytest.raises(ValueError, match="row_frames"):
        mfcc_model.mfcc_long(torch.zeros(16000), from_jax(JaxConfig()),
                             row_frames=row_frames)
    with pytest.raises(ValueError, match="one signal"):
        mfcc_model.mfcc_long(torch.zeros((2, 16000)), from_jax(JaxConfig()))
