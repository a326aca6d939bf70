"""The traffic generator: a seeded corpus of speech-like int16 utterances,
made on the device and cut into the batches that a traffic file describes.

A traffic file (``traffic/<name>.json``) gives:

- ``utterances`` and ``lengths_s``: how many utterances, and the histogram
  of their durations (bin ``edges`` in seconds and a ``weight`` a bin).
  The lengths are the histogram's quantiles at (i + 1/2) / n, so every
  seed has the same set of lengths; the seed decides their order and the
  signals.
- ``signal``: the synthetic speech (below).
- ``order``: ``"sorted"`` (by length, as a corpus extractor buckets) or
  ``"shuffled"`` (a new permutation an epoch, as a training feed draws);
  ``batch`` rows a batch, each padded to its longest row; ``epochs`` the
  permutations held.  The shuffled batches' make-up comes from
  ``layout_seed``, the same for every run, so that every seed has the
  same set of batch shapes (the fill moves the rate); the run's seed
  orders the batches and the rows inside each.
- ``queue_depth``: batches in flight at once (the harness's closed loop).
- ``check_batches``: batches of the window whose outputs are compared
  with the reference, the longest among them.
- ``trace_seconds``: the traced window's length, rounded up to whole passes.

The signal of an utterance: a sawtooth (every harmonic, falling 6 dB an
octave) on an f0 that drifts sinusoidally, times a 4 Hz syllable envelope
and a gate that opens and closes a few times a utterance (the pauses), plus
white noise ``noise_db`` below the voice, at ``level_dbfs`` give or take
``level_spread_db``.  The noise keeps every utterance off zero.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# rows synthesized at once: ~100 MB a float32 temporary at 25 s
SYNTH_ROWS = 64


@dataclasses.dataclass
class Batch:
    x: torch.Tensor          # (B, N_pad) int16 on the device
    lengths: torch.Tensor    # (B,) int64 sample lengths on the device
    lengths_host: np.ndarray  # the same on the host

    @property
    def padded(self) -> int:
        return int(self.x.shape[1])


@dataclasses.dataclass
class Corpus:
    batches: list            # one pass, in dispatch order
    sample_rate: int
    check: list              # window ordinals whose outputs are compared

    def audio_s(self, b: Batch) -> float:
        return float(b.lengths_host.sum()) / self.sample_rate

    @property
    def fill(self) -> float:
        valid = sum(int(b.lengths_host.sum()) for b in self.batches)
        return valid / sum(b.x.numel() for b in self.batches)


def lengths(traffic: dict) -> np.ndarray:
    """(utterances,) sample lengths: the histogram's quantiles."""
    h = traffic["lengths_s"]
    edges = np.asarray(h["edges"], np.float64)
    w = np.asarray(h["weights"], np.float64)
    cdf = np.concatenate([[0.0], np.cumsum(w / w.sum())])
    n = int(traffic["utterances"])
    q = (np.arange(n) + 0.5) / n
    sr = traffic["signal"]["sample_rate"]
    return np.rint(np.interp(q, cdf, edges) * sr).astype(np.int64)


def batch_rows(traffic: dict, n_samples: np.ndarray, seed: int) -> list:
    """Row indices of each batch of one pass, in dispatch order."""
    B = int(traffic["batch"])
    order = traffic["order"]
    if order == "sorted":
        p = np.argsort(n_samples, kind="stable")
        return [p[i:i + B] for i in range(0, len(p), B)]
    if order != "shuffled":
        raise ValueError(f"unknown order {order!r}")
    layout = np.random.default_rng(int(traffic["layout_seed"]))
    rows = [p[i:i + B]
            for p in (layout.permutation(len(n_samples))
                      for _ in range(int(traffic["epochs"])))
            for i in range(0, len(p), B)]
    rng = np.random.default_rng([seed, 0])
    return [rng.permutation(rows[i]) for i in rng.permutation(len(rows))]


def _params(n: int, sig: dict, gen: torch.Generator, device) -> torch.Tensor:
    """(n, 8) per-utterance parameters: f0, drift depth, drift rate, three
    phases, linear gain and pause rate."""
    u = torch.rand((n, 8), generator=gen, device=device, dtype=torch.float64)
    f0 = sig["f0_hz"][0] + u[:, 0] * (sig["f0_hz"][1] - sig["f0_hz"][0])
    rate = sig["f0_drift_hz"][0] + u[:, 2] * (sig["f0_drift_hz"][1]
                                              - sig["f0_drift_hz"][0])
    db = sig["level_dbfs"] + sig["level_spread_db"] * (2.0 * u[:, 6] - 1.0)
    pause = sig["pause_hz"] * (0.75 + 0.5 * u[:, 7])
    return torch.stack([f0, sig["f0_drift"] * u[:, 1], rate,
                        2 * math.pi * u[:, 3], 2 * math.pi * u[:, 4],
                        2 * math.pi * u[:, 5], 10.0 ** (db / 20.0), pause], 1)


def synth(p: torch.Tensor, n_samples: torch.Tensor, n_pad: int, sig: dict,
          gen: torch.Generator) -> torch.Tensor:
    """(rows, 8) parameters, (rows,) lengths -> (rows, n_pad) int16, zero
    past each length."""
    dev = p.device
    t = (torch.arange(n_pad, device=dev, dtype=torch.float32)
         / sig["sample_rate"])[None, :]
    f0, depth, rate, ph1, ph2, ph3, gain, pause = (
        c[:, None].to(torch.float32) for c in p.unbind(1))
    two_pi = 2.0 * math.pi
    cyc = f0 * (t + depth / (two_pi * rate) * torch.sin(two_pi * rate * t + ph1))
    voice = 2.0 * (cyc - torch.floor(cyc)) - 1.0
    voice = voice * (0.55 - 0.45 * torch.cos(two_pi * sig["syllable_hz"] * t + ph2))
    c = math.sin(math.pi * (sig["pause_share"] - 0.5))
    voice = voice * torch.clamp((torch.sin(two_pi * pause * t + ph3) - c) * 4.0,
                                0.0, 1.0)
    noise = torch.randn(voice.shape, generator=gen, device=dev)
    # 1 / (rms of the sawtooth times rms of the syllable envelope)
    amp = gain / (math.sqrt(1.0 / 3.0) * math.sqrt(0.55 ** 2 + 0.45 ** 2 / 2))
    x = amp * (voice + 10.0 ** (sig["noise_db"] / 20.0) * noise)
    x = torch.clamp(torch.round(x * 32768.0), -32768.0, 32767.0)
    inside = torch.arange(n_pad, device=dev)[None, :] < n_samples[:, None]
    return torch.where(inside, x, 0.0).to(torch.int16)


def build(traffic: dict, seed: int, device) -> Corpus:
    """The corpus and its batches for ``seed``, made on ``device``."""
    sig = traffic["signal"]
    n_samples = lengths(traffic)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    params = _params(len(n_samples), sig, gen, device)
    lens = torch.as_tensor(n_samples, device=device)
    batches = []
    for rows in batch_rows(traffic, n_samples, seed):
        idx = torch.as_tensor(rows, device=device)
        n_pad = int(n_samples[rows].max())
        x = torch.empty((len(rows), n_pad), dtype=torch.int16, device=device)
        for r0 in range(0, len(rows), SYNTH_ROWS):
            sl = slice(r0, r0 + SYNTH_ROWS)
            x[sl] = synth(params[idx[sl]], lens[idx[sl]], n_pad, sig, gen)
        batches.append(Batch(x, lens[idx].clone(), n_samples[rows].copy()))
    return Corpus(batches, sig["sample_rate"],
                  check_ordinals(batches, int(traffic["check_batches"]), seed))


def check_ordinals(batches: list, k: int, seed: int) -> list:
    """Window ordinals of the batches to compare: the longest batch and
    k - 1 others, drawn from the seed, each in the first or second pass."""
    rng = np.random.default_rng([seed, 1])
    n = len(batches)
    longest = int(np.argmax([b.padded for b in batches]))
    others = [i for i in range(n) if i != longest]
    pos = [longest] + [int(i) for i in rng.choice(
        others, size=min(k, n) - 1, replace=False)]
    return sorted(p + n * int(rng.integers(0, 2)) for p in pos)
