"""Streaming pitch tracking with the PyTorch port: feed a WAV in 100 ms
pieces, print the finalized [pov, normalized log pitch, delta] rows as
they emit, at most ``delay`` frames behind the audio (the twin of
``examples/online_pitch.py``).  On the card each chunk's NCCF is one
``fused_nccf`` launch.

    python examples/torch/online_pitch.py input.wav [delay_frames]
        [--device cpu]
"""

import argparse

from mfcc_tpu_torch import PitchConfig
from mfcc_tpu_torch.models.pitch_online import OnlinePitch
from mfcc_tpu_torch.utils import wav


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("wav")
    ap.add_argument("delay", nargs="?", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    x, sr = wav.read_wav(args.wav)
    pcfg = PitchConfig(sample_rate=sr).validate()
    op = OnlinePitch(pcfg, delay=args.delay, device=args.device)

    feed = sr // 10                        # 100 ms
    emitted = 0
    for i in range(0, x.size, feed):
        for r in op.feed(x[i: i + feed]):
            print(f"frame {emitted:5d}  pov {r[0]:+.3f}  "
                  f"norm_log_f0 {r[1]:+.4f}  delta {r[2]:+.5f}")
            emitted += 1
    for r in op.flush():
        print(f"frame {emitted:5d}  pov {r[0]:+.3f}  "
              f"norm_log_f0 {r[1]:+.4f}  delta {r[2]:+.5f}  (flush)")
        emitted += 1
    print(f"total {emitted} frames "
          f"({emitted * pcfg.hop_ms / 1000.0:.2f} s of audio)")


if __name__ == "__main__":
    main()
