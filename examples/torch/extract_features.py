"""Minimal library use of the PyTorch port: WAV in, MFCC out (the twin of
``examples/extract_features.py``).

    python examples/torch/extract_features.py input.wav [output.npy]
        [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from mfcc_tpu_torch import FeatureConfig, mfcc
from mfcc_tpu_torch.utils import wav


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("wav")
    ap.add_argument("out", nargs="?", help="where to save the features")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    x, sr = wav.read_wav(args.wav)
    cfg = FeatureConfig(sample_rate=sr).validate()
    feats = mfcc(torch.from_numpy(x).to(args.device), cfg).cpu().numpy()
    print(f"{args.wav}: {len(x)/sr:.2f} s -> {feats.shape} features "
          f"(config {cfg.config_hash()}, {args.device})")
    if args.out:
        np.save(args.out, feats)


if __name__ == "__main__":
    main()
