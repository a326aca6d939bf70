"""Fine-tune the learnable filterbank front end with the PyTorch port (a
distillation demo; the twin of ``examples/train_frontend.py``).

Starts at the classic HTK filterbank, perturbs a 'teacher', and recovers
it by gradient descent through the whole pipeline (DFT power, learnable
mel, accurate log, DCT).  The checkpoint is the NPZ both packages load
(``trainable.load_params`` in either).

    python examples/torch/train_frontend.py [--out frontend.npz]
        [--steps 200] [--device cpu]
"""

import argparse

import numpy as np
import torch

from mfcc_tpu_torch import FeatureConfig
from mfcc_tpu_torch.models import trainable


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="frontend.npz")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = FeatureConfig(sample_rate=2000, n_fft=64, n_mels=8,
                        n_mfcc=4).validate()   # tiny for a fast demo
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((8, 2000)) * 0.3).astype(np.float32)

    teacher = trainable.init_params(cfg, args.device)
    with torch.no_grad():
        teacher.mel_w.mul_(1.5)
    target = trainable.forward(
        teacher, torch.from_numpy(audio).to(args.device), cfg).detach()

    params, losses = trainable.fit(audio, target, cfg, steps=args.steps,
                                   lr=3e-3, device=args.device)
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({losses[0]/max(losses[-1],1e-9):.0f}x)")
    trainable.save_params(args.out, params, cfg)
    print(f"checkpoint written to {args.out}")


if __name__ == "__main__":
    main()
