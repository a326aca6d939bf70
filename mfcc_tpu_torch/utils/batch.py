"""Ragged-length bucketing, padding and packing (host side): a copy of
``mfcc_tpu/utils/batch.py``, which imports numpy only; the port keeps its
own so that nothing here imports the JAX package.

Utterances are grouped into a small fixed ladder of padded lengths
(geometric buckets) and fixed batch sizes, so the number of distinct
batch shapes is bounded by ``len(buckets)``; or several are packed into
one row at hop-aligned offsets (``pack_rows``, ``pack_rows_split``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, Sequence

import numpy as np


def bucket_ladder(min_samples: int, max_samples: int,
                  growth: float = 2.0) -> list[int]:
    """Geometric ladder of padded sample lengths covering [min, max]."""
    out = [int(min_samples)]
    while out[-1] < max_samples:
        out.append(int(np.ceil(out[-1] * growth)))
    return out


def pick_bucket(n: int, ladder: Sequence[int]) -> int:
    """Smallest ladder entry >= n (last entry if none)."""
    for b in ladder:
        if n <= b:
            return b
    return ladder[-1]


@dataclass
class PaddedBatch:
    """One host-side padded batch ready for device transfer."""
    audio: np.ndarray       # (B, L_bucket) float32
    lengths: np.ndarray     # (B,) int32 true sample counts
    ids: list               # opaque per-utterance keys (paths, indices)

    @property
    def batch_size(self) -> int:
        return self.audio.shape[0]


@dataclass
class PathBatch:
    """A batch of file paths grouped by bucket (decode deferred).

    ``paths`` always has exactly ``batch_size`` entries; trailing Nones
    pad remainder batches so the device sees ONE (batch, bucket) shape
    per bucket — a variable remainder batch would be a fresh XLA compile
    (minutes each through a remote-compile relay).
    """
    bucket: int
    paths: list  # of str | None

    @property
    def batch_size(self) -> int:
        return len(self.paths)


def make_path_batches(infos: Iterable[tuple[str, int]],
                      batch_size: int,
                      ladder: Sequence[int]) -> Iterator[PathBatch]:
    """Group (path, n_samples) pairs into bucketed path batches.

    The production ingestion path: lengths come from a header-only probe
    (utils/wav.wav_info), so bucketing costs no decoding; the native
    threaded loader then decodes each batch straight into its padded
    matrix (native.read_wavs_padded).
    """
    pending: dict[int, list[str]] = {b: [] for b in ladder}
    for path, n in infos:
        b = pick_bucket(min(n, ladder[-1]), ladder)
        pending[b].append(path)
        if len(pending[b]) == batch_size:
            yield PathBatch(bucket=b, paths=pending[b])
            pending[b] = []
    for b, items in pending.items():
        if items:
            items = items + [None] * (batch_size - len(items))
            yield PathBatch(bucket=b, paths=items)


@dataclass
class PackedRow:
    """One packed row: several utterances in a single (capacity,) signal.

    ``segments`` is a list of (id, offset, n_samples); offsets are
    hop-aligned so every segment's frames sit on the row's frame grid
    (frame t of the row starts at t*hop; segment frames are rows
    [offset//hop, offset//hop + num_frames(n)) — bit-identical to the
    standalone computation, tests/test_packing.py).
    """
    capacity: int
    segments: list  # of (id, offset, n)


def pack_rows(infos: Iterable[tuple[object, int]], capacity: int,
              hop: int, lookahead: int = 256) -> Iterator[PackedRow]:
    """First-fit-decreasing packing of (id, n_samples) into rows.

    The hot-path utilization lever (VERDICT r4 #1): with geometric
    buckets, a ragged corpus at mean fill f runs the padded program at
    utilization == f; packing multiple utterances per row recovers the
    (1-f) padded slack.  Placement rule: each segment starts at the
    smallest hop multiple >= previous end + 1 — the one-sample gap
    carries the HTK pre-emphasis predecessor (the decoder writes the
    segment's first sample there, see pack_audio/runner), and the
    hop alignment makes packed frames bit-identical to standalone.

    FFD runs over a bounded ``lookahead`` window so the corpus streams;
    rows are emitted as soon as no pending utterance fits.  Segments
    longer than capacity are truncated (same policy as the top bucket).
    """
    if capacity % hop:
        raise ValueError(f"capacity {capacity} must be a hop multiple")

    def fit_at(used: int) -> int:
        """Next hop-aligned start leaving a predecessor sample."""
        return ((used + 1 + hop - 1) // hop) * hop if used else 0

    window: list[tuple[object, int]] = []

    def emit_best() -> PackedRow:
        # FFD: repeatedly place the longest pending item that fits
        window.sort(key=lambda kv: -kv[1])
        segs, used = [], 0
        i = 0
        while i < len(window):
            uid, n = window[i]
            start = fit_at(used)
            if start + n <= capacity:
                segs.append((uid, start, n))
                used = start + n
                window.pop(i)
            else:
                i += 1
        return PackedRow(capacity=capacity, segments=segs)

    for uid, n in infos:
        window.append((uid, min(int(n), capacity)))
        if len(window) >= lookahead:
            yield emit_best()
    while window:
        yield emit_best()


@dataclass
class PackedPiece:
    """One piece of one utterance inside a packed row (splittable
    packing): frames [frame_start, frame_start + n_frames) of utterance
    ``uid``, whose samples [samp_start, samp_start + span) sit at
    ``row_off`` (hop-aligned) in the row.  span = (n_frames-1)*hop +
    frame_len exactly."""
    uid: object
    row_off: int
    samp_start: int     # frame-aligned offset into the utterance
    frame_start: int    # = samp_start // hop
    n_frames: int
    span: int


def pack_rows_split(infos: Iterable[tuple[object, int]], capacity: int,
                    hop: int, frame_len: int) -> Iterator[PackedRow]:
    """Splittable next-fit packing: rows fill to ~100% regardless of the
    length distribution, because an utterance that does not fit is SPLIT
    at a frame boundary and continues in the next row (the streaming-
    chunk construction applied to packing).  The continuation re-carries
    frame_len - hop + 1 duplicated samples (its first frame's lookback
    plus the pre-emphasis predecessor) — ~1.5% of a row at the default
    geometry — so utilization is 1 - O(splits)/capacity instead of the
    bin-packing fill.  Pieces are bit-identical to the standalone frames
    (hop-aligned placement; true-predecessor gap sample).

    Yields PackedRow whose ``segments`` are PackedPiece entries.
    """
    if capacity % hop:
        raise ValueError(f"capacity {capacity} must be a hop multiple")
    if capacity < hop + frame_len:
        # a CONTINUATION piece starts at row offset hop (its predecessor
        # slot); anything smaller would emit empty rows forever
        raise ValueError(f"capacity {capacity} must hold a continuation "
                         f"piece (>= hop + frame_len = "
                         f"{hop + frame_len})")

    def fit_at(used: int) -> int:
        return ((used + 1 + hop - 1) // hop) * hop if used else 0

    row: list[PackedPiece] = []
    used = 0

    def num_frames(n):
        return 0 if n < frame_len else 1 + (n - frame_len) // hop

    for uid, n in infos:
        T_u = num_frames(int(n))
        f0 = 0
        while f0 < T_u:
            start = fit_at(used)
            if start == 0 and f0 > 0:
                # a CONTINUATION at row offset 0 would have no slot for
                # its true predecessor sample (utterance starts are fine
                # there: prev := x[0] is the HTK convention and
                # preemphasize() applies it at buffer position 0)
                start = hop
            avail = capacity - start
            if avail < frame_len:
                yield PackedRow(capacity=capacity, segments=row)
                row, used = [], 0
                continue
            fit_frames = min((avail - frame_len) // hop + 1, T_u - f0)
            span = (fit_frames - 1) * hop + frame_len
            row.append(PackedPiece(uid=uid, row_off=start,
                                   samp_start=f0 * hop, frame_start=f0,
                                   n_frames=fit_frames, span=span))
            used = start + span
            f0 += fit_frames
    if row:
        yield PackedRow(capacity=capacity, segments=row)


def pack_audio_split(row: PackedRow, fetch: "callable"):
    """Materialize a splittable-packed row: (signal (capacity,),
    starts (S,), lens (S,), pieces).  ``fetch(uid) -> float32 signal``.
    Each piece's predecessor slot gets the TRUE preceding sample of the
    utterance (continuations) or the first sample (utterance start, HTK
    convention) — so pre-emphasis is bit-identical to standalone."""
    sig = np.zeros((row.capacity,), np.float32)
    S = len(row.segments)
    starts = np.zeros((S,), np.int32)
    lens = np.zeros((S,), np.int32)
    for j, pc in enumerate(row.segments):
        x = np.asarray(fetch(pc.uid), np.float32)
        piece = x[pc.samp_start: pc.samp_start + pc.span]
        sig[pc.row_off: pc.row_off + len(piece)] = piece
        if pc.row_off > 0 and len(piece):
            prev = (x[pc.samp_start - 1] if pc.samp_start > 0
                    else piece[0])
            sig[pc.row_off - 1] = prev
        starts[j], lens[j] = pc.row_off, pc.span
    return sig, starts, lens, row.segments


def pack_audio(row: PackedRow,
               fetch: "callable") -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Materialize one packed row: (signal (capacity,), starts (S,),
    lens (S,)).  ``fetch(id) -> float32 signal``.  Writes each segment's
    first sample into the preceding gap position so signal-convention
    pre-emphasis sees the HTK predecessor (x[-1] := x[0]) exactly as a
    standalone utterance would."""
    sig = np.zeros((row.capacity,), np.float32)
    starts = np.zeros((len(row.segments),), np.int32)
    lens = np.zeros((len(row.segments),), np.int32)
    for j, (uid, off, n) in enumerate(row.segments):
        x = np.asarray(fetch(uid), np.float32)[:n]
        sig[off: off + len(x)] = x
        if off > 0 and len(x):
            sig[off - 1] = x[0]
        starts[j], lens[j] = off, len(x)
    return sig, starts, lens


def make_batches(utterances: Iterable[tuple[object, np.ndarray]],
                 batch_size: int,
                 ladder: Sequence[int] | None = None,
                 min_bucket: int = 16_000,
                 max_bucket: int = 16_000 * 30,
                 drop_overlong: bool = False) -> Iterator[PaddedBatch]:
    """Group (id, float32 signal) pairs into shape-bucketed padded batches.

    Utterances accumulate per bucket; a batch is emitted whenever a bucket
    fills.  Remainders are flushed at the end *padded to full batch_size*
    (with zero-length rows) so batch shape is constant too.  Overlong
    signals are truncated to the top bucket unless drop_overlong.
    """
    if ladder is None:
        ladder = bucket_ladder(min_bucket, max_bucket)
    pending: dict[int, list[tuple[object, np.ndarray]]] = {b: [] for b in ladder}

    def emit(bucket: int, items: list) -> PaddedBatch:
        B = batch_size
        audio = np.zeros((B, bucket), np.float32)
        lengths = np.zeros((B,), np.int32)
        ids = []
        for i, (uid, sig) in enumerate(items):
            audio[i, : len(sig)] = sig
            lengths[i] = len(sig)
            ids.append(uid)
        return PaddedBatch(audio=audio, lengths=lengths, ids=ids)

    for uid, sig in utterances:
        if len(sig) > ladder[-1]:
            if drop_overlong:
                continue
            sig = sig[: ladder[-1]]
        b = pick_bucket(len(sig), ladder)
        pending[b].append((uid, sig))
        if len(pending[b]) == batch_size:
            yield emit(b, pending[b])
            pending[b] = []
    for b, items in pending.items():
        if items:
            yield emit(b, items)
