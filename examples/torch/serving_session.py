"""Serving with the PyTorch port: B concurrent live sessions through one
device call a step, streamed MFCC + causal online CMVN + online pitch (the
twin of ``examples/serving_session.py``).

- B sessions' chunks advance together through the carry-state STFT
  (``process_chunk_batch``: one call a step for all sessions);
- each session's cepstra are normalized causally (zero lookahead) by
  ``online_cmvn_step``, one call a session;
- each session runs a bounded-latency pitch tracker (``OnlinePitch``,
  delayed Viterbi; on the card its chunk NCCF is one ``fused_nccf``
  launch) on the same raw audio.

MFCC + CMVN rows finalize as soon as their last sample arrives (one chunk
and one call); pitch rows trail by ``delay`` frames (default 50 = 500 ms)
plus the resampler's buffering.

    python examples/torch/serving_session.py a.wav b.wav [...]
        [--fused K] [--device cpu]

``--fused K`` steps every session K chunks at a time through the fused
serving path (``process_chunks_batch_fused``: one ``fused_raw_dit`` launch
over each session's carry-prefixed K-chunk span on the card) at the cost
of K - 1 more chunks of latency.  Its contiguous valid-prefix frames feed
the causal CMVN unchanged.
"""

import argparse

import numpy as np
import torch

from mfcc_tpu_torch import FeatureConfig, PitchConfig
from mfcc_tpu_torch.models import streaming
from mfcc_tpu_torch.models.pitch_online import OnlinePitch
from mfcc_tpu_torch.utils import wav


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("wavs", nargs="+")
    ap.add_argument("--fused", type=int, default=1, metavar="K")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    K, dev = args.fused, torch.device(args.device)
    sigs, sr = [], None
    for p in args.wavs:
        x, r = wav.read_wav(p)
        if sr is not None and r != sr:
            raise SystemExit("all sessions must share a sample rate")
        sr = r
        sigs.append(x)
    B = len(sigs)
    cfg = FeatureConfig(sample_rate=sr).validate()
    pcfg = PitchConfig(sample_rate=sr).validate()
    window = 100                        # 1 s causal CMVN window
    chunk_frames = 10                   # 100 ms per step
    C = chunk_frames * cfg.hop_len
    n_steps = min(len(s) for s in sigs) // C

    st = streaming.init_state_batch(B, cfg, device=dev)
    cst = [streaming.init_online_cmvn(window, cfg.n_mfcc, device=dev)
           for _ in range(B)]
    trackers = [OnlinePitch(pcfg, device=dev) for _ in range(B)]

    feats_out = [[] for _ in range(B)]
    pitch_out = [[] for _ in range(B)]
    # fused steps advance K chunks at a time; the trailing n_steps % K
    # chunks take single-chunk steps so no audio is dropped
    schedule = ([(k, K) for k in range(0, n_steps - n_steps % K, K)]
                + [(k, 1) for k in range(n_steps - n_steps % K, n_steps)])
    for k, kk in schedule:
        flat = np.stack([s[k * C:(k + kk) * C] for s in sigs])
        if kk == 1:
            st, feats, nv = streaming.process_chunk_batch(
                st, torch.from_numpy(flat).to(dev), cfg)  # one call, B sessions
        else:
            st, feats, nv = streaming.process_chunks_batch_fused(
                st, torch.from_numpy(flat.reshape(B, kk, C)).to(dev), cfg)
        nv_np = nv.cpu().numpy()
        for b in range(B):
            cst[b], normed = streaming.online_cmvn_step(
                cst[b], feats[b], int(nv_np[b]), window)
            feats_out[b].append(normed[: nv_np[b]].cpu().numpy())
            pitch_out[b].append(trackers[b].feed(flat[b]))
        done = sum(len(f[-1]) for f in feats_out)
        lag = [sum(len(r) for r in feats_out[b])
               - sum(len(r) for r in pitch_out[b]) for b in range(B)]
        print(f"t={100 * (k + kk):6d} ms  +{done} cepstral rows this step; "
              f"pitch trails by {lag} frames (delayed Viterbi)")
    for b in range(B):
        pitch_out[b].append(trackers[b].flush())

    for b in range(B):
        f = np.concatenate(feats_out[b])
        p = np.concatenate([r for r in pitch_out[b] if len(r)])
        print(f"session {b}: {f.shape[0]} normalized cepstral frames, "
              f"{p.shape[0]} pitch frames "
              f"(mean pov {p[:, 0].mean():+.3f})")


if __name__ == "__main__":
    main()
