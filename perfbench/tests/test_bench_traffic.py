"""The traffic generator: deterministic for a seed, the stated length
histogram and fills, speech-like rows that are never all zero."""

import numpy as np
import torch

from perfbench import corpus, harness
from perfbench.tests.hostdev import tiny

BIG_SEED = 2 ** 33 + 12345


def _traffic(name):
    return harness.load_json(harness.HERE / "traffic" / f"{name}.json")


def _fill(traffic, seed):
    n = corpus.lengths(traffic)
    rows = corpus.batch_rows(traffic, n, seed)
    return n[np.concatenate(rows)].sum() / sum(len(r) * n[r].max() for r in rows)


def test_same_seed_same_inputs_other_seed_other_inputs():
    t = tiny(_traffic("libri_shuffled"))
    a = corpus.build(t, BIG_SEED, "cpu")
    b = corpus.build(t, BIG_SEED, "cpu")
    c = corpus.build(t, BIG_SEED + 1, "cpu")
    assert [x.x.shape for x in a.batches] == [x.x.shape for x in b.batches]
    assert all(torch.equal(x.x, y.x) for x, y in zip(a.batches, b.batches))
    assert a.check == b.check
    assert not all(x.x.shape == y.x.shape and torch.equal(x.x, y.x)
                   for x, y in zip(a.batches, c.batches))


def test_every_seed_has_the_same_batch_shapes_in_another_order():
    for name in ("libri_sorted", "libri_shuffled"):
        t = _traffic(name)
        n = corpus.lengths(t)
        a = corpus.batch_rows(t, n, 1)
        b = corpus.batch_rows(t, n, BIG_SEED)
        assert sorted(n[r].max() for r in a) == sorted(n[r].max() for r in b)
        assert sorted(map(len, a)) == sorted(map(len, b))
        if name == "libri_shuffled":
            assert [n[r].max() for r in a] != [n[r].max() for r in b]
            assert sorted(map(sorted, map(list, a))) == sorted(
                map(sorted, map(list, b)))


def test_lengths_have_librispeech_mean_and_range():
    for name in ("libri_sorted", "libri_shuffled"):
        t = _traffic(name)
        s = corpus.lengths(t) / t["signal"]["sample_rate"]
        h = t["lengths_s"]
        e, w = np.asarray(h["edges"], float), np.asarray(h["weights"], float)
        hist_mean = ((e[:-1] + e[1:]) / 2 * w).sum() / w.sum()
        assert abs(s.mean() - hist_mean) < 1e-3
        assert 12.6 < s.mean() < 12.8           # train-clean-100: 12.7 s
        assert 1.0 <= s.min() and s.max() <= 25.0
        assert len(s) == 4096 and 14.3 < s.sum() / 3600 < 14.6


def test_fill_of_sorted_and_shuffled_batches():
    sorted_t, shuffled_t = _traffic("libri_sorted"), _traffic("libri_shuffled")
    assert abs(_fill(sorted_t, 1) - 0.94) < 0.01
    fill = _fill(shuffled_t, 1)
    assert fill == _fill(shuffled_t, BIG_SEED)
    # the layout's fill against the draw's spread over other layouts
    others = [_fill(dict(shuffled_t, layout_seed=s), 1) for s in range(20)]
    assert abs(np.mean(others) - 0.54) < 0.01 and np.std(others) < 0.004
    assert abs(fill - np.mean(others)) < 2 * np.std(others)


def test_rows_are_speech_like_and_zero_past_their_length():
    t = tiny(_traffic("libri_sorted"))
    c = corpus.build(t, 7, "cpu")
    for b in c.batches:
        for row, n in zip(b.x, b.lengths_host):
            assert torch.count_nonzero(row[:n]) > 0.9 * n
            assert torch.count_nonzero(row[n:]) == 0
            rms = row[:n].double().pow(2).mean().sqrt() / 32768
            assert -38 < 20 * np.log10(float(rms)) < -18


def test_check_ordinals_hold_the_longest_batch():
    t = tiny(_traffic("libri_sorted"), utterances=24)
    c = corpus.build(t, 3, "cpu")
    n = len(c.batches)
    assert len(c.check) == t["check_batches"]
    longest = int(np.argmax([b.padded for b in c.batches]))
    assert longest in {o % n for o in c.check}
    assert all(0 <= o < 2 * n for o in c.check)
