"""Faults planted under the timed path: each wraps the program's call and
breaks what it returns.  The CPU tests run a cell with each and see
``correct`` come out false; ``calibrate.py --faults`` reads them on the
card."""

from __future__ import annotations


def _wrap(breaks):
    def wrap(call):
        def broken(x, lengths):
            feat, flens, mask = call(x, lengths)
            return breaks(feat, flens, mask)
        return broken
    return wrap


def _answer(feat, flens, mask):
    """One value of the first utterance altered by 1e-3."""
    feat = feat.clone()
    feat[0, 0, 0] += 1e-3
    return feat, flens, mask


def _half_batch(feat, flens, mask):
    """The second half of the batch's rows left out (zeros)."""
    feat = feat.clone()
    feat[feat.shape[0] // 2:] = 0
    return feat, flens, mask


def _frame_count(feat, flens, mask):
    """The first utterance's frame count one too many."""
    flens = flens.clone()
    flens[0] += 1
    return feat, flens, mask


def _unmasked_pad(feat, flens, mask):
    """Padded frames left unzeroed."""
    return feat.masked_fill(~mask[..., None], 1.0), flens, mask


FAULTS = {"answer": _wrap(_answer), "half_batch": _wrap(_half_batch),
          "frame_count": _wrap(_frame_count),
          "unmasked_pad": _wrap(_unmasked_pad)}
