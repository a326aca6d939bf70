"""Online low-latency feature emission with the PyTorch port: simulate a
live audio session (the twin of ``examples/streaming_session.py``).

Chunks of 10 frames (100 ms) stream through the carry-state STFT; each
step emits completed frames at once.  Streamed features equal batch
features over the same samples.

    python examples/torch/streaming_session.py input.wav [--device cpu]
"""

import argparse

import numpy as np
import torch

from mfcc_tpu_torch import FeatureConfig, mfcc
from mfcc_tpu_torch.models import streaming
from mfcc_tpu_torch.utils import wav


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("wav")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    x, sr = wav.read_wav(args.wav)
    cfg = FeatureConfig(sample_rate=sr).validate()
    chunk = 10 * cfg.hop_len          # 100 ms per step
    xt = torch.from_numpy(x).to(args.device)

    state = streaming.init_state(cfg, device=args.device)
    emitted = []
    for k in range(len(x) // chunk):
        state, feat, n_valid = streaming.process_chunk(
            state, xt[k * chunk: (k + 1) * chunk], cfg)
        emitted.append(feat[: int(n_valid)].cpu().numpy())
        print(f"t={100*(k+1):5d} ms  +{int(n_valid)} frames")

    streamed = np.concatenate(emitted)
    batch = mfcc(xt, cfg).cpu().numpy()
    err = np.abs(streamed - batch[: len(streamed)]).max()
    print(f"{len(streamed)} frames streamed; max |stream - batch| = {err:.2e}")


if __name__ == "__main__":
    main()
