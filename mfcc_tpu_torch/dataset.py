"""Training batches straight from a WAV corpus: corpus in, device tensors
out (twin of ``mfcc_tpu/dataset.py``).

The corpus runner (``runner.py``) writes features to disk; a training job
wants an iterator of ready ``(features, frame_counts, mask)`` batches on
its device, with no file round trip:

    for b in dataset.feature_batches(corpus, cfg, batch_size=32,
                                     augment_seed=0):
        loss = step(b.features, b.mask)

It is built from the runner's pieces: the header probe and bucket ladder
(``runner._probe``, ``utils/batch``), the native decoder with PCM16
passthrough and the resample policy (``runner._decode_batch``), pinned
host-to-device copies, and the batch models, which on the card launch
``fused_raw_dit`` (MFCC, log-mel <= 50 dB) or ``fused_raw`` (unbounded
log-mel).  Then on the device: CMVN from precomputed statistics (padding
rows and frames stay zero), then SpecAugment (``ops/augment``) whose
stripes come from a CPU generator seeded by (augment_seed, epoch,
batch index), so a run reproduces and every epoch draws fresh masks.

A depth-2 pipeline, as in the runner: batch N + 1 is decoded and enqueued
on the device before batch N is handed to the caller.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from .config import FeatureConfig
from .models import logmel as logmel_model, mfcc as mfcc_model
from .ops import augment
from .parallel import cmvn as cmvn_lib
from .utils import batch as batch_lib
from . import runner as runner_lib


@dataclasses.dataclass
class FeatureBatch:
    """One training batch.  ``features`` is (B, T, F) float32 on the
    device, zero on padded frames and padded rows; ``uids[i]`` is None for
    a padded row."""
    features: torch.Tensor
    frame_counts: torch.Tensor     # (B,) int32
    mask: torch.Tensor             # (B, T) bool
    uids: list
    bucket: int


def load_cmvn_stats(path: str) -> cmvn_lib.Stats:
    """A runner-written cmvn.npz -> float64 Stats on the CPU."""
    with np.load(path) as z:
        return cmvn_lib.Stats(*(torch.from_numpy(np.asarray(z[k], np.float64))
                                for k in ("count", "sum", "sumsq")))


def augment_generator(augment_seed: int, epoch: int,
                      batch_index: int) -> torch.Generator:
    """The CPU generator of one batch's SpecAugment draws, seeded from
    (augment_seed, epoch, batch_index) through numpy's SeedSequence."""
    seed = np.random.SeedSequence([augment_seed, epoch, batch_index])
    return torch.Generator().manual_seed(
        int(seed.generate_state(1, np.uint64)[0]))


def feature_batches(
    corpus: str,
    cfg: FeatureConfig,
    *,
    batch_size: int = 32,
    logmel: bool = False,
    backend: str = "auto",
    resample: bool = False,
    min_bucket: int = 16_000,
    max_bucket: int = 16_000 * 30,
    ladder: list | None = None,
    epochs: int = 1,
    shuffle_seed: int | None = None,
    augment_seed: int | None = None,
    augment_kwargs: dict | None = None,
    cmvn_stats: "cmvn_lib.Stats | str | None" = None,
    drop_padded_rows: bool = False,
    device: str = "cuda",
) -> Iterator[FeatureBatch]:
    """Stream ``FeatureBatch`` es off a WAV corpus (a file, a directory or
    a .txt listing).

    - ``shuffle_seed``: reshuffle the corpus each epoch (numpy's
      ``default_rng((shuffle_seed, epoch))``, the reference's order).
    - ``augment_seed``: SpecAugment on the device with a per-(epoch,
      batch) CPU generator; ``augment_kwargs`` go to ``spec_augment``.
    - ``cmvn_stats``: Stats, or the path of a runner-written cmvn.npz;
      applied on the device before augmentation.
    - ``drop_padded_rows``: trim a remainder batch's padded rows instead
      of emitting them (a varying batch size).
    - ``device``: "cuda" by default; without a card the call raises, and
      only "cpu" computes on the host.
    """
    cfg.validate()
    dev = runner_lib.resolve_device(device)
    fn = logmel_model.log_mel_batch if logmel else mfcc_model.mfcc_batch
    ladder = ladder or batch_lib.bucket_ladder(min_bucket, max_bucket)
    paths = runner_lib.collect_wavs(corpus)
    if isinstance(cmvn_stats, str):
        cmvn_stats = load_cmvn_stats(cmvn_stats)
    mean = inv_std = None
    if cmvn_stats is not None:
        m, v = cmvn_stats.mean_var()
        # float64 statistics, rounded once to float32 on the device
        mean = m.to(dev, torch.float32)
        inv_std = (1.0 / torch.sqrt(v)).to(dev, torch.float32)
    akw = dict(augment_kwargs or {})

    def batches():
        for epoch in range(epochs):
            epoch_paths = list(paths)
            if shuffle_seed is not None:
                np.random.default_rng((shuffle_seed, epoch)).shuffle(
                    epoch_paths)
            infos = runner_lib._probe(epoch_paths, cfg, None, resample)
            for bi, pb in enumerate(batch_lib.make_path_batches(
                    infos, batch_size, ladder)):
                yield epoch, bi, pb

    def enqueue(epoch, bi, pb) -> FeatureBatch:
        audio, lengths = runner_lib._decode_batch(pb, cfg, resample)
        a_dev, l_dev = runner_lib._to_device((audio, lengths), dev)
        feat, flens, mask = fn(a_dev, l_dev, cfg, backend)
        if mean is not None:
            feat = torch.where(mask[..., None], (feat - mean) * inv_std, 0.0)
        if augment_seed is not None:
            # the frame counts from the host's lengths: no device wait
            nf = mfcc_model.frame_lengths(torch.from_numpy(lengths), cfg)
            feat = augment.spec_augment(
                feat, augment_generator(augment_seed, epoch, bi),
                num_frames=nf, **akw)
        uids = list(pb.paths)
        if drop_padded_rows:
            n_real = sum(u is not None for u in uids)
            feat, flens, mask = feat[:n_real], flens[:n_real], mask[:n_real]
            uids = uids[:n_real]
        return FeatureBatch(features=feat, frame_counts=flens, mask=mask,
                            uids=uids, bucket=pb.bucket)

    def pipeline():
        in_flight = None   # depth 2: enqueue N + 1, then hand N over
        for item in batches():
            ready = enqueue(*item)
            if in_flight is not None:
                yield in_flight
            in_flight = ready
        if in_flight is not None:
            yield in_flight

    return pipeline()
