"""The port's training feed against the JAX package: case for case the
twins of tests/test_dataset.py, plus ``feature_batches`` against the JAX
iterator on the same corpus (batches, order, frame counts, features at
the kernel-vs-plain tolerance of tests/test_torch_mfcc.py), CMVN from a
runner-written cmvn.npz, and augmentation on top of CMVN."""

import os

import numpy as np
import pytest
import torch

from mfcc_tpu import FeatureConfig as JaxConfig, dataset as jax_dataset
from mfcc_tpu_torch import FeatureConfig, dataset, oracle
from mfcc_tpu_torch.models import mfcc as mfcc_model
from mfcc_tpu_torch.ops import augment
from mfcc_tpu_torch.parallel import cmvn as cmvn_lib
from mfcc_tpu_torch.utils import manifest, wav

CFG = FeatureConfig().validate()
TOL = 2e-5      # tests/test_torch_mfcc.py: mfcc_batch against the JAX one


@pytest.fixture
def corpus(tmp_path, rng):
    sigs = {}
    for i, n in enumerate([16_000, 12_000, 20_000, 8_000, 16_000]):
        x = (0.3 * rng.standard_normal(n)).astype(np.float32)
        p = tmp_path / f"u{i}.wav"
        wav.write_wav(p, x, 16_000)
        # PCM16 round trip: the decoded signal is the quantized one
        sigs[str(p)], _ = wav.read_wav(p)
    return tmp_path, sigs


def _batches(root, **kw):
    return list(dataset.feature_batches(str(root), CFG, device="cpu", **kw))


def test_batches_match_oracle(corpus):
    root, sigs = corpus
    seen = {}
    for b in _batches(root, batch_size=2):
        assert b.features.dim() == 3 and b.features.shape[2] == CFG.n_mfcc
        for i, uid in enumerate(b.uids):
            if uid is None:
                continue
            n = int(b.frame_counts[i])
            seen[uid] = b.features[i, :n].numpy()
            assert (b.features[i, n:] == 0.0).all()
    assert set(seen) == set(sigs)
    for uid, got in seen.items():
        want = oracle.mfcc(sigs[uid].astype(np.float64), CFG)
        np.testing.assert_allclose(got, want[: got.shape[0]], atol=1e-4)


def _epoch_orders(root, epochs, seed):
    out, cur = [], []
    for b in _batches(root, batch_size=2, epochs=epochs, shuffle_seed=seed):
        cur += [u for u in b.uids if u is not None]
        if len(cur) == 5:
            out.append(cur)
            cur = []
    return out


def test_epochs_and_shuffle(corpus):
    root, sigs = corpus
    orders = _epoch_orders(root, epochs=2, seed=0)
    assert sorted(orders[0]) == sorted(orders[1]) == sorted(sigs)
    assert orders == _epoch_orders(root, epochs=2, seed=0)
    assert orders[0] != orders[1]


def test_cmvn_stats_applied(corpus):
    root, _ = corpus
    stats = cmvn_lib.Stats(*(torch.zeros(s, dtype=torch.float64)
                             for s in ((), CFG.n_mfcc, CFG.n_mfcc)))
    for b in _batches(root, batch_size=2):
        stats = stats.merge(cmvn_lib.host_batch_stats(b.features,
                                                      b.frame_counts))
    z = np.concatenate([b.features.numpy()[b.mask.numpy()] for b in
                        _batches(root, batch_size=2, cmvn_stats=stats)])
    np.testing.assert_allclose(z.mean(0), 0.0, atol=1e-4)
    np.testing.assert_allclose(z.std(0), 1.0, atol=1e-3)


def test_augment_reproducible_and_fresh_per_epoch(corpus):
    root, _ = corpus

    def run():
        return [b.features.numpy() for b in _batches(
            root, batch_size=2, epochs=2, augment_seed=7)]
    a, b = run(), run()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    n = len(a) // 2
    assert any(not np.array_equal(a[i], a[i + n]) for i in range(n))


def test_drop_padded_rows(corpus):
    root, _ = corpus
    for b in _batches(root, batch_size=3, drop_padded_rows=True):
        assert all(u is not None for u in b.uids)
        assert b.features.shape[0] == len(b.uids) == b.mask.shape[0]


# ---- against the JAX package and the runner --------------------------------

@pytest.mark.parametrize("logmel", [False, True])
def test_feature_batches_match_jax(corpus, logmel):
    """Without augmentation: the same batches in the same order, the same
    buckets, frame counts and masks, features within the tolerance
    test_torch_mfcc.py holds mfcc_batch to (log-mel relative to its
    magnitude as well)."""
    root, _ = corpus
    kw = dict(batch_size=2, epochs=2, shuffle_seed=3, logmel=logmel)
    ours = _batches(root, **kw)
    theirs = list(jax_dataset.feature_batches(str(root), JaxConfig(), **kw))
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert a.uids == b.uids and a.bucket == b.bucket
        np.testing.assert_array_equal(a.frame_counts.numpy(),
                                      np.asarray(b.frame_counts))
        np.testing.assert_array_equal(a.mask.numpy(), np.asarray(b.mask))
        want = np.asarray(b.features)
        np.testing.assert_allclose(a.features.numpy(), want, atol=TOL,
                                   rtol=1e-4 if logmel else 0)


def test_runner_cmvn_npz_loads_in_both_packages(corpus, tmp_path):
    """A cmvn.npz as the runner writes it gives the same normalization in
    the port's and in JAX's feature_batches."""
    root, _ = corpus
    stats = cmvn_lib.Stats(torch.tensor(321.0, dtype=torch.float64),
                           torch.linspace(-40.0, 900.0, CFG.n_mfcc,
                                          dtype=torch.float64),
                           torch.linspace(9e3, 8e4, CFG.n_mfcc,
                                          dtype=torch.float64))
    p = str(tmp_path / "cmvn.npz")
    manifest.save_cmvn(p, stats, CFG.config_hash())
    got = dataset.load_cmvn_stats(p)
    for g, w in zip(got, stats):
        assert g.dtype == torch.float64
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    ours = _batches(root, batch_size=2, cmvn_stats=p)
    theirs = list(jax_dataset.feature_batches(str(root), JaxConfig(),
                                              batch_size=2, cmvn_stats=p))
    _, var = stats.mean_var()
    inv_std = (1.0 / np.sqrt(var.numpy())).astype(np.float32)
    for a, b in zip(ours, theirs):
        # the features' tolerance, carried through the scaling
        d = np.abs(a.features.numpy() - np.asarray(b.features))
        assert (d <= TOL * inv_std * (1 + 1e-6) + 1e-6).all(), d.max()
        assert (a.features.numpy()[~a.mask.numpy()] == 0.0).all()


def test_augment_masks_normalized_features(corpus):
    """With CMVN and augmentation the batch is the normalized batch with
    the stripes the (augment_seed, epoch, batch) generator draws: every
    entry either equals the normalized feature or is masked, padding
    frames zero."""
    root, _ = corpus
    stats = cmvn_lib.Stats(*(torch.zeros(s, dtype=torch.float64)
                             for s in ((), CFG.n_mfcc, CFG.n_mfcc)))
    for b in _batches(root, batch_size=2):
        stats = stats.merge(cmvn_lib.host_batch_stats(b.features,
                                                      b.frame_counts))
    plain = _batches(root, batch_size=2, cmvn_stats=stats)
    aug = _batches(root, batch_size=2, cmvn_stats=stats, augment_seed=5,
                   augment_kwargs=dict(time_mask_width=20))
    hit_any = False
    for bi, (p, a) in enumerate(zip(plain, aug)):
        B, T, F = p.features.shape
        masks = augment.draw_masks(dataset.augment_generator(5, 0, bi), B, T,
                                   F, time_mask_width=20,
                                   num_frames=p.frame_counts)
        want = augment.apply_masks(p.features, masks,
                                   num_frames=p.frame_counts)
        np.testing.assert_array_equal(a.features.numpy(), want.numpy())
        hit_any |= bool((a.features != p.features).any())
    assert hit_any


def test_feature_batches_need_a_card_unless_asked(corpus, monkeypatch):
    root, _ = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        dataset.feature_batches(str(root), CFG)


def test_augment_generator_folds_its_three_seeds():
    draws = {(s, e, b): torch.rand(4, generator=dataset.augment_generator(
        s, e, b)).tolist() for s in (0, 1) for e in (0, 1) for b in (0, 1)}
    assert len({tuple(v) for v in draws.values()}) == 8
    assert draws[(0, 1, 0)] == torch.rand(
        4, generator=dataset.augment_generator(0, 1, 0)).tolist()


def test_plain_batches_equal_mfcc_batch_on_the_decoded_audio(corpus):
    """Each batch is mfcc_batch of its rows, decoded by the port's pure
    reader to int16 and padded to the batch's bucket."""
    root, _ = corpus
    for b in _batches(root, batch_size=2):
        x = np.zeros((len(b.uids), b.bucket), np.int16)
        n = np.zeros(len(b.uids), np.int32)
        for r, uid in enumerate(b.uids):
            if uid is not None:
                s, _ = wav.read_wav(uid)
                row = np.round(s * 32768.0).astype(np.int16)
                x[r, : len(row)], n[r] = row, len(row)
        feat, fl, _ = mfcc_model.mfcc_batch(torch.from_numpy(x),
                                            torch.from_numpy(n), CFG)
        np.testing.assert_array_equal(b.frame_counts.numpy(), fl.numpy())
        np.testing.assert_array_equal(b.features.numpy(), feat.numpy())
        assert os.path.basename(b.uids[0]).startswith("u")
