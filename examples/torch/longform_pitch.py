"""Long-form single-stream pitch tracking with the blocked Viterbi, on the
PyTorch port (the twin of ``examples/longform_pitch.py``).

    python examples/torch/longform_pitch.py [wav] [--minutes 2]
        [--block 320 --warm 64] [--nccf-chunk 0] [--device cpu]

The exact Viterbi is a T-step sequential chain; a single long stream has
no batch to spread it over.  ``--block`` solves time chunks of the stream
side by side with zero-emission warm-up context (``viterbi_block=``):
the blocked path may deviate from the exact one only on frames with no
voicing evidence (``docs/conventions.md``).  On the card the chunks go to
``fused_viterbi`` as its batch.  ``--nccf-chunk K`` folds time chunks of K
frames into the plain NCCF's batch axis (``nccf_chunk=``); the frames are
those of the unchunked NCCF, so the track is the same.  On the card the
kernel runs unchunked, which gives the same bits in less time.  0, the
default, is off.
"""

import argparse

import numpy as np
import torch

from mfcc_tpu_torch import PitchConfig
from mfcc_tpu_torch.ops import pitch as pitch_op
from mfcc_tpu_torch.utils import wav


def synth_longform(minutes: float, sr: int = 16000) -> np.ndarray:
    """Speech-like stand-in: alternating voiced vibrato / noise /
    near-silence, one second per segment."""
    rng = np.random.default_rng(0)
    segs = []
    f0s = [120.0, 220.0, 90.0, 300.0, 180.0]
    for i in range(int(minutes * 60)):
        t = np.arange(sr) / sr
        if i % 3 == 0:
            f0 = f0s[i % len(f0s)]
            ph = 2 * np.pi * f0 * (t + 0.02 * np.sin(2 * np.pi * 3 * t))
            x = (0.5 * np.sin(ph) + 0.2 * np.sin(2 * ph)
                 + 0.02 * rng.standard_normal(sr))
        elif i % 3 == 1:
            x = 0.1 * rng.standard_normal(sr)
        else:
            x = 0.002 * rng.standard_normal(sr)
        segs.append(x)
    return np.concatenate(segs).astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("wav", nargs="?", help="input WAV (else synthetic)")
    ap.add_argument("--minutes", type=float, default=2.0)
    ap.add_argument("--block", type=int, default=320,
                    help="blocked-Viterbi chunk frames (0: the exact chain)")
    ap.add_argument("--warm", type=int, default=64)
    ap.add_argument("--nccf-chunk", type=int, default=0,
                    help="chunked NCCF: frames a chunk folded into the "
                         "batch axis (0: off)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    if args.wav:
        x, sr = wav.read_wav(args.wav)
        pcfg = PitchConfig(sample_rate=sr).validate()
    else:
        x = synth_longform(args.minutes)
        pcfg = PitchConfig().validate()

    xb = torch.from_numpy(x)[None, :].to(args.device)
    lens = torch.tensor([x.shape[-1]], device=args.device)
    f0, voicing, mask = pitch_op.pitch_track(
        xb, lens, pcfg, viterbi_block=args.block or None,
        viterbi_warm=args.warm, nccf_chunk=args.nccf_chunk or None)
    f0, voicing = f0[0].cpu().numpy(), voicing[0].cpu().numpy()
    valid = mask[0].cpu().numpy()

    voiced = valid & (voicing > 0.5)
    dur = x.shape[-1] / pcfg.sample_rate
    print(f"{dur:.0f} s of audio -> {int(valid.sum())} pitch frames "
          f"({voiced.mean():.0%} voiced)")
    if voiced.any():
        print(f"voiced f0: median {np.median(f0[voiced]):.1f} Hz, "
              f"p10-p90 {np.percentile(f0[voiced], 10):.1f}-"
              f"{np.percentile(f0[voiced], 90):.1f} Hz")


if __name__ == "__main__":
    main()
