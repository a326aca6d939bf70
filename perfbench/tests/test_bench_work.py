"""work.py's least-work count against a count made by hand."""

import math

import numpy as np

from perfbench import harness, work


def _features(name):
    return harness.load_json(
        harness.HERE / "configs" / f"{name}.json")["features"]


def _mel_nonzeros_by_hand(n_mels, n_fft=512, sr=16000):
    """Bins strictly inside each HTK triangle over 0..sr/2."""
    mel = lambda f: 2595.0 * math.log10(1.0 + f / 700.0)
    edges = [mel(sr / 2) * i / (n_mels + 1) for i in range(n_mels + 2)]
    count = 0
    for m in range(n_mels):
        for k in range(n_fft // 2 + 1):
            if edges[m] < mel(k * sr / n_fft) < edges[m + 2]:
                count += 1
    return count


def test_mfcc_work_at_a_small_shape():
    lengths = np.array([399, 400, 560, 721])       # 0, 1, 2 and 3 frames
    ops, nbytes = work.spectral_work(_features("htk-mfcc13-16k"), True, lengths)
    per_frame = (2.5 * 512 * 9 + 400 + 2 * 400 + 3 * 257
                 + 2 * _mel_nonzeros_by_hand(26) + 26 * (17 + 1)
                 + 2 * 26 * 13)
    assert ops == 6 * per_frame
    assert nbytes == 2 * lengths.sum() + 4 * 6 * 13


def test_log_mel_work_at_a_small_shape():
    lengths = np.array([560, 560])
    ops, nbytes = work.spectral_work(
        _features("kaldi-fbank80-deltas-16k"), False, lengths)
    per_frame = (2.5 * 512 * 9 + 400 + 2 * 400 + 3 * 257
                 + 2 * _mel_nonzeros_by_hand(80) + 80 * (17 + 1))
    assert ops == 4 * per_frame
    assert nbytes == 2 * 1120 + 4 * 4 * 80


def test_roofline_takes_the_larger_bound_and_only_known_cards():
    assert work.roofline_seconds(67e12, 1.0, "NVIDIA H100 80GB HBM3") == (
        1.0, "operations")
    assert work.roofline_seconds(1.0, 3.35e12 * 2, "NVIDIA H100 PCIe") == (
        2.0, "bytes")
    assert work.roofline_seconds(1.0, 1.0, "cpu") is None
