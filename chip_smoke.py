#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main paths once on one NVIDIA GPU.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases, one status line each; any failure raises and exits non-zero:

1. device: torch / CUDA versions, the card, and its name and power limit
   as nvidia-smi reports them.  No card: exit 1, no CPU fallback.
2. build: compile the six kernel sources (``fused_raw_dit.cu``,
   ``fused_raw.cu``, ``fused_mfcc.cu``, ``fused_dit.cu``, ``fused_nccf.cu``,
   ``fused_viterbi.cu`` in ``mfcc_tpu_torch/ops/kernels/csrc/``) from this
   checkout with nvcc, the roofline ladder's rungs (phase 21: three edited
   copies of ``fft_tile.cuh`` x ``fused_raw_dit.cu``, ``fused_raw.cu``,
   ``fused_mfcc.cu``, under ``build/roofline/``), and the WAV decoder
   ``native/wavio.cpp`` with g++, one process per source, all at once;
   print ptxas's registers, shared memory and spills per kernel.
3. MFCC kernel vs plain: ``fused_raw_dit`` against its plain PyTorch
   version on the card, same inputs, max abs diff <= 2e-5 (cepstra
   compared unliftered, as the repository's kernel tests do); each case
   names the tile that ran (``fft``, ``fft64`` or ``direct``).
3b. spectral kernels vs plain: ``fused_raw``, ``fused_dit``,
   ``fused_mfcc`` and ``fused_raw_dit`` with ``apply_dct=False``, each at
   its main-path config (64 x 10 s), at the default config, on a ragged
   batch and at a frame count that is no tile multiple; then the FFT tile
   of all four over n_fft 64..4096 (cepstra on the f32 flavour ``fft``,
   unbounded log-mel at an odd frame count on the float64-front flavour
   ``fft64``), a ragged batch, a frame count that is no tile multiple,
   T = 1, ``append_energy`` with ``lifter=22``, ``dynamic_range_db=50``,
   ``apply_dct=False``, unbounded log-mel-80 (ragged, and at the 22.05 kHz
   TTS geometry), a Hann two-tone valley, and the tile each kernel keeps
   where the FFT tile does not apply (n_fft 401: the direct tile; 400 for
   ``fused_dit``: the DIT tile), each case's tile checked.  Bounds: cepstra
   <= 2e-5 unliftered, log-mel within rtol 1e-4 plus atol 2e-5 of the plain
   version; every ``fft64`` case also within 1e-5 of the float64 oracle
   fed the kernel's own input (the raw audio, or the audio the host
   pre-emphasized, with pre-emphasis off).  Where the f32 plain version is
   itself over the kernel-vs-plain bound against that oracle (spectral
   valleys: ~1e-2 in the Hann two-tone case) and the kernel is not, the
   oracle is the yardstick, and both oracle errors are printed.
3c. accurate log: the kernels' ``acc_log`` on 2^20 floats (positive floats
   over the full exponent range, and floor values) bit-identical to
   ``ops/xmath``.
3d. ``fused_raw_dit``'s bark and spec projections vs plain: at the main
   path's config (64 x 10 s), a ragged batch, T = 70, T = 1, n_fft 256 /
   1024 / 2048, and the direct tile (n_fft 401 for bark, 768 for spec),
   each case's tile asserted (``fft64`` at a power-of-two n_fft).  Bounds:
   bark log-energies rtol 1e-4 plus atol 2e-5, the spectrogram 2e-4 inside
   the 50 dB window; every ``fft64`` case within 1e-5 of the float64
   oracle over every band and bin; where the plain version is over its
   bound against that oracle and the kernel is not, the oracle judges.
4. MFCC main path: ``models.mfcc.mfcc_batch`` on ragged int16 and float32
   batches, with the kernel's launch counter reset just before and read
   just after, then on the golden WAV.  Frame counts, masks and zeroed
   padding are exact; features are within 1e-4 of the float64 oracle and of
   the committed goldens.
4b. log-mel and fallback main paths, 64 x 10 s int16 ragged each, every
   spectral launch counter reset just before and read just after each (the
   golden WAV is run and counted apart):
   ``models.logmel.log_mel_batch`` at log-mel-80 + deltas (-> ``fused_raw``
   on the ``fft64`` tile, and ``speech2s.wav`` vs ``logmel80_deltas.npy``),
   the same bounded to 50 dB (-> ``fused_raw_dit``, ``apply_dct=False``,
   ``fft``), at the 22.05 kHz TTS geometry (-> ``fused_dit``, ``fft64``),
   and ``mfcc_batch`` at 44.1 kHz (-> ``fused_mfcc``, ``fft``), each tile
   asserted.  Frame counts, masks and zero padding exact; features vs the
   float64 oracle within 1e-4, 1e-3 for unbounded log-mel on host
   pre-emphasized audio (``fused_dit``: the host's f32 pre-emphasis rounds
   before the kernel) and for the golden.
4c. PLP and spectrogram main paths: ``models.plp.plp_batch`` and
   ``models.spectrogram.log_spectrogram_batch`` at the default config on
   the 64 x 10 s int16 ragged batch, each with every spectral launch
   counter reset just before and read just after (one ``fused_raw_dit``
   launch, in the bark or spec projection, on the ``fft64`` tile), then on
   ``speech2s.wav`` (counted apart), and at a config the reference sends to
   XLA (spectrogram at n_fft 400, PLP at 44.1 kHz): no kernel launch, the
   plain chain on the card.  Frame counts, masks and zero padding exact;
   PLP within 1e-4 of the float64 oracle and ``plp13.npy``, the
   spectrogram within 2e-4 of its oracle and ``spectrogram257.npy`` in the
   50 dB window.
5. NCCF kernel vs plain: ``fused_nccf`` against the correlation-theorem
   ``ops.pitch.nccf`` given the same ballast, <= 2e-5 on valid frames, on
   stationary signals (the bench batch, ragged noise, four other configs,
   a frame count that is no tile multiple, T = 1), each case with the tile
   the kernel chose (frames a tile, lags a thread, lag passes, window
   energies shared by the tile).
6. Viterbi kernel vs plain: ``fused_viterbi`` against ``ops.pitch.viterbi``
   on seeded random scores with zero-emission tails, paths exactly equal,
   for B in {1, 3, 64, 200} x T in {1, 2, 64, 65, 150, 996}; a tie-heavy
   case (``penalty=0``, scores in {-1, 0, 1}: nearly every argmin a tie,
   only the first index right); 256 and 257 lags (byte and uint16
   backpointers); one 6-minute stream unblocked (~36,000 steps: the
   backpointers spill to global memory in time blocks) and through
   ``viterbi_blocked``; each case with the launch shape the kernel chose.
7. pitch main path: ``models.pitch.pitch_batch`` on the ragged int16
   64 x 10 s batch and on the golden WAV, and the MFCC + pitch composition
   (mfcc_batch, pitch_batch, align_pitch, mask, concatenation), each with
   its kernels' launch counters reset just before and read just after.
   Frame counts, masks and zeroed padding are exact; pitch columns meet the
   per-column contract (pov 1e-4, norm 3e-4, delta 1e-4) against the
   float64 oracle and ``pitch3.npy``, MFCC columns 1e-4.
8. timing (information, not a claim): each kernel and its plain version
   at its main-path config, ``mfcc_batch``, ``log_mel_batch`` and
   ``pitch_batch`` through the kernels and through plain PyTorch, at
   64 x 10 s, CUDA events around groups of five back-to-back calls,
   median over two passes in turns; beside each FFT-tile kernel the tile
   it replaced on the same work, launched through the same C entry (the
   direct tile; the DIT tile for ``fused_dit``), beside the two
   ``fft64`` kernels the f32 FFT tile on the same work, and beside the two
   ``fft`` kernels, as a yardstick of the DFT stage alone,
   ``torch.fft.rfft`` (cuFFT) of the windowed frames, materialized before
   the timed window.  The same for ``fused_raw_dit``'s bark and spec
   projections (the f32 tile and cuFFT beside them), ``plp_batch`` and
   ``log_spectrogram_batch`` through the kernel and through plain PyTorch,
   and the PLP tail alone (its ATen ops counted, its host enqueue time).
   ``fused_viterbi``'s time per step of its chain beside the chain bound;
   ``pitch_batch``'s ATen ops and host enqueue time beside its own.
9. the script's elapsed time (phases 1-8 and 10-21), one JSON line
   describing the kernels of phases 1-8 and row 7, the roofline probe, of
   phase 21 (with
   each one's bound: the larger of its input and output bytes over 3.35
   TB/s and its operations over 67 TFLOP/s fp32, from this run's shapes,
   and for ``fused_viterbi`` also its dependent chain at the card's SM
   clock, whichever is largest;
   ``fused_raw_dit/bark`` and ``fused_raw_dit/spec`` are kernel 1's two
   other projections, recorded apart), then the final JSON status line.

10. packed corpus: 256 utterances of 2-16 s (lengths uniform, numpy seed
   0, the bench signal), packed by ``utils/batch.pack_rows`` into 16 s rows
   and run through ``models.mfcc.mfcc_batch_packed`` in all four families
   (MFCC-13, log-mel-80 bounded to 50 dB and unbounded, PLP-13, the
   spectrogram), each with the spectral counters reset just before and read
   just after (one launch: ``fused_raw_dit`` in the mel, bark or spec
   projection, ``fused_raw`` for unbounded log-mel); 8 segments a family,
   at odd and even frame offsets, against the family's standalone kernel
   result (the kernel-vs-plain bounds: packing changes the FFT tile's frame
   pairs) and the float64 oracle; then packed ``mfcc_batch_packed`` against
   padded ``mfcc_batch`` (64 utterances a batch in input order, each padded
   to its longest) on the same corpus, timed, with each side's fill and
   audio-seconds per second.
11. dither: the hash's uint32 bits on the card against the reference's
   (2^20 samples, from 0 and across 2^32), the noise within 1e-6 relative
   of the float64 draw; MFCC-13 at dither 1/32768 on the bench batch
   through ``fused_raw_dit`` within 1e-4 of the dithered oracle; an all-zero
   row off the log floor.
12. post chain and CMVN on the bench batch's kernel features (ragged):
   ``ops.post`` sliding and online CMVN (window 300, variance), splice,
   energy VAD, ``parallel.cmvn`` float32 statistics, float64 host
   statistics and apply, each against its float64 oracle twin, and timed.
13. streaming: 64 sessions of the bench signal, 64-frame chunks, 5 chunks a
   dispatch, 3 dispatches; ``process_chunks_batch_fused`` in all four
   variants (``fused_raw_dit`` at preemph 0, its launches read per
   variant) against the scan path on the card (5e-5; the spectrogram 2e-4
   in the 50 dB window) and the float64 oracle; ``online_cmvn_step`` against
   ``online_cmvn`` at window 300, on the card and on the CPU (1e-5, with and
   without the variance; both within 2e-4 of the float64 oracle), and the
   window sums float32 ``torch.cumsum`` gives on each device against
   float64 ones; one dispatch timed with its ATen ops and host enqueue, and
   audio-seconds per second.
14. corpus runner: 1,024 WAVs of phase 10's signal, 2-16 s (uniform,
   numpy seed 0), written into a temporary directory (removed at the end):
   one process's shard of a corpus run.  ``cli.main`` in-process on the
   card, batch size 64: (a) MFCC-13 to ``.npy``, padded; (b) the same with
   ``--pack --pack-seconds 16`` (its fill ratio printed); (c) ``--format
   ark --cmvn``; (d) ``--logmel --n-mels 80 --deltas`` and (e) ``--pitch``
   on the first 256; (f) (a) again into its directory, a resume that
   processes nothing and launches nothing; (g) (a) on the first 64 with
   ``--trace-dir``, whose Chrome trace must name the ``fused_raw_dit``
   launch.  Every launch counter is reset just before a run and read just
   after it: one spectral launch a batch (``fused_raw`` for (d)), and in
   (e) one ``fused_nccf`` and one ``fused_viterbi`` a batch.  The report's
   self-check ``max_abs_error`` <= 1e-4 and ``max_abs_error_pitch`` <=
   3e-4; 8 utterances a run read back from its files within the oracle's
   contract bounds and within the kernel bounds of a direct model call on
   the same rows (``mfcc_batch_packed`` on the packed rows for (b)); in
   (c) ``cmvn.npz`` equal to numpy's float64 statistics of (a)'s files and
   the archive equal to (a)'s files normalized by them.  Each run prints
   its wall time, audio-seconds per second, stage seconds (decode,
   dispatch, fetch+write), launches and the card's name and power limit.
15. online pitch: one 60 s stream of the bench signal through
   ``models.pitch_online.OnlinePitch`` at the default PitchConfig (16 kHz
   in, the streaming resampler to 4 kHz), fed in 100 ms pieces, delay 50,
   16-frame chunks, with ``fused_nccf``'s counter reset just before and
   read just after: one launch a chunk.  The rows within pov 1e-4, norm
   3e-4, delta 1e-4 of the float64 twin ``online_pitch_np``; with delay >=
   T the pov column within 2e-4 of ``pitch_batch`` on >= 95 % of the
   frames (the causal ballast the one difference); the chunk NCCF kernel
   within 2e-5 of the plain chunk NCCF on the card for an interior chunk
   and the stream's last (n_valid < 16).  ms a chunk, the real-time
   factor, and one chunk step alone through the kernel and the plain NCCF.
16. training feed and front end: ``dataset.feature_batches`` over phase
   14's corpus (batch 64), plain and with run (c)'s ``cmvn.npz`` and
   SpecAugment, each with every spectral counter reset just before and read
   just after (one ``fused_raw_dit`` launch a batch); plain batches equal
   ``mfcc_batch`` on the same rows bit for bit, augmented ones equal the
   plain batch normalized with that seed's stripes; one seed's masks equal
   on the CPU and the card; ``ops.augment.speed_perturb`` at 0.9 / 1.1 on
   the bench batch, card against CPU (1e-6), timed; the trainable front
   end on the bench batch: ``forward`` at init within 2e-5 of
   ``mfcc_batch`` through the kernel, then ``fit`` for 200 steps (lr 3e-3)
   recovering a 1.5x filterbank below 0.1x its first loss, ms a step.
17. distributed step: ``parallel/dryrun.dryrun_multichip(8)``, eight
   processes joined by gloo, every one on this card, laid out as dp 2 x sp
   2 x tp 2: MFCC-13 + CMVN (statistics summed over data x time) and the
   trainable front end's step (filterbank columns split over feat) at the
   default config on the 64 x 10 s bench batch (32 rows and 499 frames a
   rank), the kernel route, a split-packed batch, centre mode, pitch, PLP,
   streaming and the post trio at the reference's tiny sizes.  Every rank
   asserts the reference's bounds against one process on the whole batch
   (raw 3e-5, CMVN 1e-4, kernel route and packed 3e-5), the training
   step's (loss rtol 1e-5, clipped gradients 1e-4 of their largest, the
   parameters within Adam's first-step bound) and that no jax was
   imported; a failed rank fails the phase.  Each rank's ``fused_raw_dit``
   launches of the MFCC step (counters reset just before, read just after:
   one), and rank 0's ``batch_stats_psum`` (also on host copies of its
   shard), feat all-gather and training step (sharded, and one process on
   the whole batch) on CUDA events.

18. precision modes: ``mfcc_batch``, ``log_mel_batch`` (80 mels) and
   ``plp_batch`` on the 64 x 10 s int16 ragged batch under
   ``matmul_precision`` "highest", "high", "default" and
   ``compute_dtype="bfloat16"``, each on its route ("auto") and on the
   plain route ("torch"), every spectral counter reset just before and
   read just after: "high" launches no spectral kernel (the reference's
   route), "default" and bf16 launch the "highest" kernel and equal its
   output bit for bit (the kernels have no product a mode changes; PLP's
   plain LPC tail after the kernel follows the mode, so its "default"
   is held to 5.33e-2); "high" (IEEE fp32 on the card) equal to the
   "highest" plain twin bit for bit; each within the reference's error
   for its mode against the float64 oracle (1e-4, 2.8e-4, 5.33e-2; on the
   plain route plus the f32 plain chain's own error at "highest").  The
   plain twins of "default" and bf16 against the oracle: MFCC and PLP
   whole, log-mel inside each frame's 50 dB window (outside it the
   valleys amplify any product's error), "default" within 5.33e-2, bf16
   within the reference's gates (mean 0.05, max 0.3; log-mel its mean:
   the reference's own bf16 chain, which the CPU computes, is 0.40 off
   at the window's edge), and bf16 against that chain on the CPU, the
   reference's form, on the same rows (mean 1e-5, max 0.3).  The
   caller's TF32 flags unchanged after every call, and a caller's TF32
   setting without effect on "highest"; CUDA-event ms of each.  Then
   ``backend.matmul``'s forms alone on the plain path's DFT product of
   the bench batch, (63,872, 400) x (400, 514): IEEE fp32 ("highest",
   "high"), one TF32 product ("default") and bf16, each against the
   float64 product (the first two within their bounds) and timed, beside
   the 3xTF32 split the port does not take for "high" (why:
   ``backend.py``); one ``train_step`` at "default".
19. pitch post stages (``ops/pitch.post_stages``) on the card and on the
   CPU over the card's NCCF of the bench batch and of one 120 s row, with
   the port's float64 prefix sums and with float32 ``torch.cumsum``:
   their gap, the CPU's margin to the per-column bounds, and each against
   the float64 oracle (the float64 form within pov 1e-4, norm 3e-4, delta
   1e-4).
20. ``nccf_chunk=`` on the card, where the port does not chunk: the NCCF
   stage (``ops/pitch._track``) on one 6-minute stream of the bench signal
   (T = 35,996 at 4 kHz) and on the ragged 64 x 10 s batch at K = 4, 128
   and 512, ``fused_nccf``'s counter reset just before and read just
   after each call: one launch, equal in every bit to ``nccf_chunk=None``,
   within 2e-5 of the chunked plain route (``_nccf_chunked``, the CPU's);
   K = 3 refused (ValueError); ``pitch_track`` with ``viterbi_block=320,
   viterbi_warm=64`` on the stream, ``nccf_chunk=128``, equal to
   unchunked; ``pitch_features(nccf_chunk=128)`` on a voiced 60 s vibrato
   within pov 1e-4, norm 3e-4, delta 1e-4 of the float64 oracle.  Times
   (information: why the card does not chunk): CUDA events, the unchunked
   kernel route against the chunk rows (``_chunk_rows``) through one
   ``fused_nccf`` launch at each K, on the stream, the batch and a
   60-minute row (T = 359,996) at K = 512; the plain route on the host CPU
   chunked against unchunked on the stream (host clock).
21. the roofline ladder (``tools/roofline.py``, the twin of
   ``bench/roofline.py``'s ``make_probe``), on 64 x 10 s of ``0.1 N(0, 1)``
   (numpy seed 0) for each of ``fused_raw_dit`` (MFCC-13, 16 kHz),
   ``fused_raw`` (unbounded log-mel-80) and ``fused_mfcc`` (MFCC-13, 44.1
   kHz): each rung built in phase 2 run once and held to its twin, ``stage``
   (the staged span stored as the output) equal in every bit to the gather
   of the same samples, ``fft`` (no floors, log or frame energy) within
   1e-4 of the plain chain's max, ``fftlog`` (no frame energy) equal in
   every bit to the kernel, and every rung's launch (TM, pairs, span,
   shared memory, blocks, recorded by its block 0) the kernel's plan; then
   the ladder with the kernel timed in two passes in turns (CUDA events
   around 20 calls), its rung launches counted from 0 just before and read
   just after: ms, audio-sec/s, host enqueue and the five derived shares
   (the kernel's share of its ``fft`` ceiling, the log's, the FFT chain's
   over the ``stage`` floor, the energy's, and ``stage``'s share of the
   data-sheet HBM rate).  Row 7's JSON record: path 1's ``fft`` rung beside
   its plain twin and its bound, with every path's rung times, ceiling
   share and ``stage_pct_of_hbm``.

Run alone (without the ``mfcc_tpu_torch`` package beside it) or without a
card, it exits 1 and prints no result.

Imports nothing of JAX and nothing of the JAX package ``mfcc_tpu``.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")
KERNEL_TOL = 2e-5     # kernel vs XLA bound of tests/test_kernels.py
LOGMEL_RTOL = 1e-4    # log-mel kernel bound: rtol 1e-4 plus atol 2e-5
ORACLE_TOL = 1e-4     # feature contract vs the float64 oracle
LOGMEL_ORACLE_TOL = 1e-3   # unbounded log-mel vs oracle (test_golden.py)
FFT64_ORACLE_TOL = 1e-5    # the fft64 tile vs the oracle on its own input
SPEC_TOL = 2e-4       # spectrogram, inside the 50 dB window (conventions)
SPEC_WINDOW_DB = 50.0
PITCH_TOL = (1e-4, 3e-4, 1e-4)   # pov, norm, delta (tests/test_pitch.py)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12           # H100 SXM fp32 outside the tensor cores
# The Viterbi chain's floor per step: ceil(log2 n) dependent compare-select
# pairs (a min tree over n candidates) at the dependent-issue latency of an
# fp32 instruction, then one block barrier.  Both are cycle counts that
# published microbenchmarks of Volta to Hopper report (~4 cycles a
# dependent fp32 op, ~20-30 a bar.sync of a block), not measured here.
FP32_DEP_CYCLES = 4
BARRIER_CYCLES = 24
ACC_LOG_OPS = 17             # the accurate log's operations per value
FFT_GRID = (64, 128, 256, 512, 1024, 2048, 4096)
KERNELS = ("fused_raw_dit", "fused_raw", "fused_mfcc", "fused_dit",
           "fused_nccf", "fused_viterbi")
SPECTRAL = ("fused_raw_dit", "fused_raw", "fused_mfcc", "fused_dit")
# the tile each spectral kernel's main path runs (phase 4b)
MAIN_TILES = {"fused_raw_dit": "fft", "fused_raw": "fft64",
              "fused_mfcc": "fft", "fused_dit": "fft64"}
# fused_raw_dit's other projections: record name -> projection (phase 4c)
PROJECTIONS = {"fused_raw_dit/bark": "bark", "fused_raw_dit/spec": "spec"}
REPLACES = {"fused_raw_dit": "mfcc_tpu/ops/kernels/fused_raw_dit.py:555",
            "fused_raw": "mfcc_tpu/ops/kernels/fused_raw.py:335",
            "fused_mfcc": "mfcc_tpu/ops/kernels/fused_mfcc.py:200",
            "fused_dit": "mfcc_tpu/ops/kernels/fused_dit.py:246",
            "fused_nccf": "mfcc_tpu/ops/kernels/fused_nccf.py:249",
            "fused_viterbi": "mfcc_tpu/ops/kernels/fused_viterbi.py:149",
            "fused_raw_dit/bark": "mfcc_tpu/ops/kernels/fused_raw_dit.py:555",
            "fused_raw_dit/spec": "mfcc_tpu/ops/kernels/fused_raw_dit.py:555",
            "roofline_probe": "bench/roofline.py:162"}

# sizes of the main paths and of the checks
BATCH, SECONDS = 64, 10.0
TIMING_CALLS = 30
VITERBI_BATCHES = (1, 3, 64, 200)
VITERBI_STEPS = (1, 2, 64, 65, 150, 996)
VITERBI_WIDE = 996           # steps of the 256- and 257-lag cases
LONG_SECONDS = 360.0
# phase 10: a ragged corpus, packed by pack_rows at the longest length
PACK_UTTERANCES = 256
PACK_SECONDS = (2.0, 16.0)   # lengths drawn uniformly; the row capacity
PACK_BATCH = 64              # rows (packed) or utterances (padded) a call
PACK_CHECKS = 8              # segments a family held to standalone and oracle
PACK_TIMING = 6              # timed corpus passes a side and order
# phase 12: the post chain on the bench batch's features
POST_WINDOW = 300
POST_CHECKS = 8              # rows held to the oracle
POST_VAR_TOL = 2e-4          # variance-normalized CMVN (tests/test_post.py)
CMVN_F32_TOL = 1e-3          # float32 statistics: cancellation in the variance
# phase 13: streaming sessions of the bench signal
STREAM_CHUNK_FRAMES = 64
STREAM_K = 5                 # chunks a dispatch
STREAM_DISPATCHES = 3
STREAM_ORACLE_ROWS = 4       # sessions held to the oracle
STREAM_FUSED_TOL = 5e-5      # fused serving path vs the scan path
STREAM_CMVN_WINDOW = 300
STREAM_CMVN_TOL = 1e-5       # online_cmvn_step vs online_cmvn
# phase 14: the corpus runner through its CLI on one process's shard
RUNNER_UTTERANCES = 1024
RUNNER_SECONDS = (2.0, 16.0)  # lengths drawn uniformly, numpy seed 0
RUNNER_BATCH = 64
RUNNER_PACK_SECONDS = 16.0
RUNNER_SUBSET = 256          # utterances of the log-mel and pitch runs
RUNNER_TRACE = 64            # utterances of the traced run
RUNNER_CHECKS = 8            # utterances a run read back and checked
# phase 15: one online pitch stream of the bench signal
ONLINE_SECONDS = 60.0
ONLINE_FEED = 1600           # 100 ms pieces at 16 kHz
ONLINE_DELAY = 50
ONLINE_CHUNK = 16
ONLINE_STEP_CALLS = 100      # chunk steps timed alone
# phase 16: the training feed over phase 14's corpus, the front end
FEED_CHECKS = 2              # plain batches held to mfcc_batch (+ the last)
TRAIN_STEPS = 200
# phase 17: the distributed step, every rank a process on the one card
DRYRUN_RANKS = 8             # dp 2 x sp 2 x tp 2, the reference's mesh
# phase 18: the precision modes on the bench batch
PRECISION_CALLS = 10         # timed calls a (family, setting, route)
PRECISION_ROWS = 3           # rows held to the float64 oracle
PRECISION_SETTINGS = {"highest": {}, "high": dict(matmul_precision="high"),
                      "default": dict(matmul_precision="default"),
                      "bf16": dict(compute_dtype="bfloat16")}
# the reference's error against the oracle for each mode (MFCC-13 on its
# bench batch, TPU: mfcc_tpu/config.py:117-132, bench/ab_precision.json),
# the bound each mode is held to; on the plain route the f32 plain
# chain's own error at "highest" (this run) comes on top
MODE_ERR = {"highest": ORACLE_TOL, "high": 2.8e-4, "default": 5.33e-2}
BF16_GATES = (0.05, 0.3)     # mean, max vs the oracle (tests/test_numerics.py)
# bf16 plain twin on the card vs the CPU's (the reference's form): mean
# (tests/test_torch_precision.py's port-vs-JAX mean), max (the gate's)
BF16_FORM_GATES = (1e-5, 0.3)
# |form - float64 product| <= (unit + K 2^-23) |A| @ |B|; "high" is the
# "highest" form (tests/test_torch_precision.py emulates "default")
FORM_UNIT = {"highest": 0.0, "default": 2.0 ** -9}
# phase 19: the pitch post stages on the card and the CPU, one NCCF
PITCH_LONG_SECONDS = 120.0
# phase 20: the chunked NCCF (nccf_chunk=) on one long stream
CHUNK_KS = (4, 128, 512)     # frames a chunk; 4 is the least at the default
CHUNK_STREAM_SECONDS = 360.0
CHUNK_HOUR_REPEATS = 10      # the stream's work-rate row 10 times: 60 min
CHUNK_VOICED_SECONDS = 60.0
CHUNK_CALLS = 10             # timed calls on the card; 2 on the host CPU


def _log(msg: str) -> None:
    print(msg, flush=True)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _bench_audio(batch: int, seconds: float, sr: int) -> np.ndarray:
    """The bench.py signal: two tones plus noise, numpy seed 0."""
    n = int(seconds * sr)
    rng = np.random.default_rng(0)
    t = np.arange(n) / sr
    base = (0.3 * np.sin(2 * np.pi * 180 * t)
            + 0.1 * np.sin(2 * np.pi * 1200 * t)).astype(np.float32)
    audio = np.tile(base, (batch, 1))
    audio += 0.02 * rng.standard_normal(audio.shape).astype(np.float32)
    return audio


def _sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.split()[0])


def _chain_ms(T: int, n: int, sm_mhz: float) -> float:
    """The least time of a T-step Viterbi chain over n states: each step
    after the first waits for a min over n candidates (ceil(log2 n)
    dependent compare-select pairs) and one barrier."""
    return max(T - 1, 0) * _chain_cycles(n) / (sm_mhz * 1e3)


def _chain_cycles(n: int) -> int:
    return math.ceil(math.log2(n)) * 2 * FP32_DEP_CYCLES + BARRIER_CYCLES


def _int16(audio: np.ndarray) -> np.ndarray:
    return np.round(np.clip(audio, -1.0, 32767 / 32768) * 32768).astype(np.int16)


def _time_ms(torch, fn, warmup: int = 3, calls: int = 30,
             group: int = 5) -> list[float]:
    """ms per call: calls // group samples, each the mean over ``group``
    back-to-back calls between two CUDA events, so that the host enqueues
    ahead of the device as a corpus run does."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(max(1, calls // group)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(group):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / group)
    return out


def _columns_err(got: np.ndarray, want: np.ndarray, tols) -> list[float]:
    assert got.shape == want.shape, (got.shape, want.shape)
    errs = [float(np.abs(got[..., i] - want[..., i]).max()) if got.size
            else 0.0 for i in range(len(tols))]
    assert all(e <= t for e, t in zip(errs, tols)), (errs, tols)
    return errs


def _fmt(errs) -> str:
    return "/".join(f"{e:.2e}" for e in errs)


def _tile_ran(module, before: dict) -> str:
    """The tile a spectral wrapper's last call launched, as "<tile> tile, "
    ("" for a kernel with one tile or a call that launched nothing)."""
    ran = [k for k, v in getattr(module, "TILE_LAUNCHES", {}).items()
           if v != before.get(k)]
    return f"{ran[0]} tile, " if len(ran) == 1 else ""


def _tiles(module) -> dict:
    return dict(getattr(module, "TILE_LAUNCHES", {}))


def _reset_counts(modules) -> None:
    for m in modules:
        m.LAUNCHES = 0
        for counts in (getattr(m, "TILE_LAUNCHES", {}),
                       getattr(m, "PROJECTION_LAUNCHES", {})):
            for k in counts:
                counts[k] = 0


def _build_all(_build) -> dict:
    """nvcc for every kernel source and for the roofline ladder's rungs
    (phase 21), g++ for the WAV decoder (``native/wavio.cpp``), all at once
    (one process each); -> the rungs' libraries."""
    from mfcc_tpu_torch import native
    from mfcc_tpu_torch.tools import roofline
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS) + 2) as pool:
        wavio = pool.submit(native.load)
        rungs = pool.submit(roofline.build, roofline.PATHS)
        list(pool.map(_build.load, KERNELS))
        wavio.result()
        libs = rungs.result()
    _log(f"[2 build] {', '.join(k + '.cu' for k in KERNELS)}, "
         f"native/wavio.cpp and the roofline rungs "
         f"{', '.join(f'{r}/{s}.cu' for r, s in sorted(libs))} built and "
         f"loaded in {time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        log = _build.library_path(name).with_suffix(".log")
        for ln in (log.read_text().splitlines() if log.exists() else []):
            if "Compiling entry" in ln:
                _log(f"  ptxas {name}: {ln.split(chr(39))[1]}")
            elif "registers" in ln or "spill" in ln:
                _log(f"  ptxas {name}:   {ln.strip()}")
    return libs


def _mfcc_kernel_vs_plain(torch, dev, bench) -> float:
    from mfcc_tpu_torch import FeatureConfig, oracle
    from mfcc_tpu_torch.ops.kernels import fused_raw_dit
    cfg = FeatureConfig().validate()
    sr = cfg.sample_rate
    rng = np.random.default_rng(1)
    ragged_lens = (sr, 12345, 4000)
    ragged = np.zeros((3, sr), np.float32)
    for i, n in enumerate(ragged_lens):
        ragged[i, :n] = 0.3 * rng.standard_normal(n)
    cases = [
        (f"bench {bench.shape[0]} x {bench.shape[1] / sr:g} s", cfg, bench),
        ("B=3 ragged (frames inside each length)", cfg, ragged),
        ("N not a tile multiple (T=207)",
         cfg, 0.3 * rng.standard_normal((2, 33360)).astype(np.float32)),
        ("N=399, T=0", cfg, 0.3 * rng.standard_normal((2, 399)).astype(np.float32)),
        ("lifter=22, append_energy=True",
         cfg.replace(lifter=22, append_energy=True), bench[:4, :3 * sr]),
        ("dynamic_range_db=50", cfg.replace(dynamic_range_db=50.0),
         bench[:4, :3 * sr]),
        ("8 kHz, n_fft 256", FeatureConfig(sample_rate=8000, n_fft=256),
         0.3 * rng.standard_normal((2, 8000)).astype(np.float32)),
        ("48 kHz, n_fft 2048", FeatureConfig(sample_rate=48000, n_fft=2048),
         0.3 * rng.standard_normal((2, 48000)).astype(np.float32)),
    ]
    kernel_err = 0.0
    for name, c, audio in cases:
        x = torch.from_numpy(np.ascontiguousarray(audio)).to(dev)
        before = _tiles(fused_raw_dit)
        got = fused_raw_dit.fused_features_raw_dit(x, c)
        torch.cuda.synchronize()
        tile = _tile_ran(fused_raw_dit, before)
        want = fused_raw_dit.plain_features(x, c)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (x.shape[0], c.num_frames(x.shape[1]),
                                           c.n_mfcc), (name, got.shape)
        lift = torch.from_numpy(oracle.lifter_coeffs(c.n_mfcc, c.lifter)
                                .astype(np.float32)).to(dev)
        diff = (got - want) / lift
        raw = float(diff.abs().max()) if got.numel() else 0.0
        if audio is ragged:
            # the main path zeroes frames past each length; an all-zero
            # frame's c0 is ~-117, where 2e-5 is ~3 f32 ulps, so the
            # summation order alone moves it past the bound
            keep = torch.arange(got.shape[1], device=dev)[None, :] < \
                torch.tensor([c.num_frames(n) for n in ragged_lens],
                             device=dev)[:, None]
            diff = diff[keep]
        err = float(diff.abs().max()) if diff.numel() else 0.0
        assert bool(torch.isfinite(got).all()), name
        _log(f"[3 MFCC kernel vs plain] {name}: {tile}shape "
             f"{tuple(got.shape)}, max abs diff {err:.3e} (all frames "
             f"{raw:.3e})")
        assert err <= KERNEL_TOL, (name, err)
        kernel_err = max(kernel_err, err)
    return kernel_err


def _mfcc_main_path(torch, dev, bench) -> int:
    from mfcc_tpu_torch import FeatureConfig, oracle
    from mfcc_tpu_torch.models import mfcc as mfcc_model
    from mfcc_tpu_torch.ops.kernels import fused_raw_dit
    from mfcc_tpu_torch.utils import wav
    cfg = FeatureConfig().validate()
    sr = cfg.sample_rate
    lens = np.minimum([160000, 151234, 100000, 48000, 16000, 8001, 400, 399],
                      bench.shape[1]).astype(np.int32)
    audio = bench[: len(lens)].copy()
    for i, n in enumerate(lens):
        audio[i, n:] = 0.0
    x16 = _int16(audio)
    speech, speech_sr = wav.read_wav(os.path.join(GOLDEN, "speech2s.wav"))
    assert speech_sr == sr
    goldens = [
        ("mfcc13.npy", cfg, 1.0),
        ("mfcc13_center.npy", cfg.replace(frame_mode="center"), 1.0),
        ("mfcc13_energy_lifter.npy", cfg.replace(lifter=22, append_energy=True),
         oracle.lifter_coeffs(13, 22)),
    ]

    _reset_counts([fused_raw_dit])
    outs = {}
    for tag, arr in (("int16", x16), ("float32", audio)):
        outs[tag] = mfcc_model.mfcc_batch(
            torch.from_numpy(arr).to(dev), torch.from_numpy(lens).to(dev), cfg)
    torch.cuda.synchronize()
    launches = fused_raw_dit.LAUNCHES
    tiles = _tiles(fused_raw_dit)
    _log(f"[4 MFCC main path] mfcc_batch on the two ragged batches launched "
         f"the kernel {launches} times, by tile {tiles}")
    assert launches > 0, "the MFCC main path did not go through the kernel"
    gold_out = []
    for fname, c, _ in goldens:
        f, _, _ = mfcc_model.mfcc_batch(
            torch.from_numpy(speech[None]).to(dev),
            torch.tensor([len(speech)], dtype=torch.int32, device=dev), c)
        gold_out.append(f)
    torch.cuda.synchronize()

    for tag, (feat, flens, mask) in outs.items():
        T = cfg.num_frames(audio.shape[1])
        want_fl = np.array([cfg.num_frames(int(n)) for n in lens])
        assert feat.shape == (len(lens), T, cfg.n_mfcc), feat.shape
        assert (flens.cpu().numpy() == want_fl).all(), flens
        assert (mask.cpu().numpy() == (np.arange(T)[None] < want_fl[:, None])).all()
        f = feat.cpu().numpy()
        assert np.isfinite(f).all()
        assert (f[~mask.cpu().numpy()] == 0.0).all(), "padded frames not zero"
        src = (x16[0].astype(np.float64) / 32768.0 if tag == "int16"
               else audio[0].astype(np.float64))
        ref = oracle.mfcc(src[: lens[0]], cfg)
        err = float(np.abs(f[0, : ref.shape[0]] - ref).max())
        _log(f"[4 MFCC main path] {tag} ragged batch {tuple(f.shape)}: flens, "
             f"mask, zero padding exact; utterance 0 vs float64 oracle "
             f"{err:.3e}")
        assert err <= ORACLE_TOL, (tag, err)
    for (fname, c, lift), f in zip(goldens, gold_out):
        want = np.load(os.path.join(GOLDEN, fname))
        got = f[0].cpu().numpy()
        assert got.shape == want.shape, (fname, got.shape, want.shape)
        err = float(np.abs(got / lift - want / lift).max())
        _log(f"[4 MFCC main path] speech2s.wav vs {fname}: {err:.3e}")
        assert err <= ORACLE_TOL, (fname, err)
    return launches, tiles


def _slice3_configs() -> dict:
    """The main-path config of each spectral kernel of the log-mel slice,
    by the kernel the port's route gives it."""
    from mfcc_tpu_torch import FeatureConfig
    logmel80 = FeatureConfig(n_mels=80, n_mfcc=80, deltas=True)
    return {
        "fused_raw": logmel80,                           # BASELINE config 3
        "fused_raw_dit": logmel80.replace(dynamic_range_db=50.0),
        "fused_dit": FeatureConfig(sample_rate=22050, frame_ms=46.44,
                                   hop_ms=11.61, n_fft=1024, n_mels=80,
                                   n_mfcc=80),          # 22.05 kHz TTS
        "fused_mfcc": FeatureConfig(sample_rate=44100, n_fft=2048),
    }


def _spectral_wrappers():
    """kernel name -> (module, wrapper name, takes raw audio)."""
    from mfcc_tpu_torch.ops.kernels import (fused_dit, fused_mfcc,
                                            fused_raw, fused_raw_dit)
    return {"fused_raw_dit": (fused_raw_dit, "fused_features_raw_dit", True),
            "fused_raw": (fused_raw, "fused_features_raw", True),
            "fused_mfcc": (fused_mfcc, "fused_features", False),
            "fused_dit": (fused_dit, "fused_features_dit", False)}


def _other_tile(name: str) -> str:
    """The tile a spectral kernel runs where the FFT tile does not apply."""
    return "dit" if name == "fused_dit" else "direct"


def _on_tile(name: str, x, c, dct: bool, tile: str, projection: str = "mel"):
    """A call of kernel ``name``'s C entry on ``tile`` (the tile it
    replaced, or the f32 FFT tile, on the same work), outside its
    wrapper's launch counts; -> (out, tile)."""
    from mfcc_tpu_torch.ops.kernels import _spectral, fused_dit
    module, _, raw = _spectral_wrappers()[name]
    return _spectral.launch_spectral(
        module._lib, "mfcc_" + name, name, x, c, dct,
        c.preemph if raw else None,
        other=fused_dit.DIT_TILE if name == "fused_dit"
        else _spectral.direct_tile(projection), tile=tile,
        projection=projection if name == "fused_raw_dit" else None)


def _oracle_out(torch, x, c, dct: bool, raw: bool, rows, lens,
                projection: str = "mel"):
    """The float64 oracle fed the kernel's own input (the raw audio, or the
    audio the host pre-emphasized with pre-emphasis off) for ``rows`` of
    x, in the projection: (len(rows), T, n_out) float64, zero past each
    row's frames."""
    from mfcc_tpu_torch import oracle
    from mfcc_tpu_torch.ops.kernels import _spectral
    c = c.replace(deltas=False) if raw else c.replace(deltas=False,
                                                       preemph=0.0)
    fn = {"bark": oracle.log_bark, "spec": oracle.log_spectrogram}.get(
        projection, oracle.mfcc if dct else oracle.log_mel)
    xf = x.double().cpu().numpy()
    out = np.zeros((len(rows), c.num_frames(x.shape[1]),
                    _spectral.n_out(c, dct, projection)))
    for k, i in enumerate(rows):
        want = fn(xf[i, : x.shape[1] if lens is None else lens[i]], c)
        out[k, : want.shape[0]] = want
    return torch.from_numpy(out).to(x.device)


def _check(torch, dev, tag, got, want, x, c, dct, raw, lens, tile,
           projection: str = "mel"):
    """Kernel vs plain on one case, and, on the fft64 tile or where that
    comparison is over its bound, both against the float64 oracle fed the
    kernel's input (every row, or the first and last of a large batch
    where the plain version holds its bound).  The fft64 tile must be
    within 1e-5 of the oracle over every band and bin.  A case over the
    kernel-vs-plain bound passes only where the plain version is over
    that bound against the oracle and the kernel is not: then the oracle
    is the yardstick, and both errors are printed.  -> max abs diff to the
    plain version, counted where the plain version is the yardstick (else
    0)."""
    err, margin = _compare(torch, dev, got, want, c, dct, lens, projection)
    line = (f"{tag}: {tile} tile, shape {tuple(got.shape)}, max abs diff "
            f"{err:.3e} (margin {margin:.3e})")
    if tile == "fft64" or margin < 0:
        rows = list(range(x.shape[0]) if x.shape[0] <= 4 or margin < 0
                    else (0, x.shape[0] - 1))
        sub = None if lens is None else [lens[i] for i in rows]
        ref = _oracle_out(torch, x, c, dct, raw, rows, sub, projection)
        k_err, k_margin = _compare(torch, dev, got[rows].double(), ref, c,
                                   dct, sub, projection)
        p_err, p_margin = _compare(torch, dev, want[rows].double(), ref, c,
                                   dct, sub, projection)
        k_all = float((_valid_frames(torch, dev, got[rows].double(), c, sub)
                       - _valid_frames(torch, dev, ref, c, sub)).abs().max())
        line += (f"; vs the float64 oracle on rows {rows}: kernel "
                 f"{k_err:.3e}" + (f" (every bin {k_all:.3e})"
                                   if projection == "spec" else "")
                 + f", plain {p_err:.3e}")
        if tile == "fft64":
            assert k_all <= FFT64_ORACLE_TOL, (tag, k_all)
        if margin < 0:
            _log(line + " (the plain version is over the kernel-vs-plain "
                 "bound against the oracle: the oracle is the yardstick)")
            assert p_margin < 0 <= k_margin, (tag, err, k_err, p_err)
            return 0.0
    _log(line)
    return err


def _noise(rng, shape) -> np.ndarray:
    return (0.3 * rng.standard_normal(shape)).astype(np.float32)


def _valid_frames(torch, dev, t, c, lens):
    """(B, T, width) -> (frames, width): every frame, or each row's own."""
    if lens is None:
        return t.reshape(-1, t.shape[-1])
    keep = torch.arange(t.shape[1], device=dev)[None, :] < torch.tensor(
        [c.num_frames(n) for n in lens], device=dev)[:, None]
    return t[keep]


def _compare(torch, dev, got, want, c, dct, lens, projection: str = "mel"):
    """Kernel vs plain: -> (max abs diff, margin to the bound); cepstra
    unliftered <= 2e-5, log-mel and log bark energies rtol 1e-4 plus atol
    2e-5, the spectrogram 2e-4 on the bins within 50 dB of their frame's
    peak in ``want`` (the max abs diff is then over those bins); ragged
    rows inside their lengths."""
    from mfcc_tpu_torch import oracle
    assert got.shape == want.shape, (got.shape, want.shape)
    assert bool(torch.isfinite(got).all())
    got = _valid_frames(torch, dev, got, c, lens)
    want = _valid_frames(torch, dev, want, c, lens)
    diff = got - want
    if projection == "spec":
        window = want > (want.amax(dim=-1, keepdim=True)
                         - math.log(10.0 ** (SPEC_WINDOW_DB / 10.0)))
        err = float(diff.abs()[window].max())
        return err, SPEC_TOL - err
    if dct:
        lift = torch.from_numpy(oracle.lifter_coeffs(
            c.n_mfcc, c.lifter).astype(np.float32)).to(dev)
        diff = diff / lift
        excess = float(diff.abs().max()) - KERNEL_TOL
    else:
        excess = float((diff.abs() - LOGMEL_RTOL * want.abs()).max()
                       ) - KERNEL_TOL
    return float(diff.abs().max()), -excess


def _fft_grid_config(n_fft: int, **kw):
    """25 ms frames at hop 10 ms at the rate that gives n_fft the default
    config's bin spacing (2 kHz at 64 points ... 128 kHz at 4096)."""
    from mfcc_tpu_torch import FeatureConfig
    n_mels = min(26, n_fft // 8)
    return FeatureConfig(sample_rate=n_fft * 125 // 4, n_fft=n_fft,
                         n_mels=n_mels, n_mfcc=min(13, n_mels),
                         **kw).validate()


def _fft_tile_vs_plain(torch, dev) -> dict:
    """Phase 3b, second part: the FFT tile of all four spectral kernels
    against their plain versions (and, on the fft64 tile, against the
    float64 oracle), and the tile each keeps where the FFT tile does not
    apply; -> {kernel: max abs diff against the plain version}."""
    from mfcc_tpu_torch import FeatureConfig
    from mfcc_tpu_torch.ops import framing
    rng = np.random.default_rng(6)
    base = FeatureConfig()
    lm80 = base.replace(n_mels=80, n_mfcc=80)
    tts = _slice3_configs()["fused_dit"].validate()
    sr, fl, hop = base.sample_rate, base.frame_len, base.hop_len
    ragged_lens = (sr, sr * 3 // 4 + 123, sr // 4)
    ragged = np.zeros((3, sr), np.float32)
    for i, n in enumerate(ragged_lens):
        ragged[i, :n] = _noise(rng, n)
    t = np.arange(sr) / sr
    tones = (0.5 * np.sin(2 * np.pi * 180.0 * t)
             + 0.3 * np.sin(2 * np.pi * 1200.0 * t)).astype(np.float32)
    # (case, cfg, apply_dct, audio, lens, tile): tile "other" is the
    # kernel's own other tile
    cases = []
    for n in FFT_GRID:
        c = _fft_grid_config(n)
        cases.append((f"n_fft {n}, T=70", c, True,
                      _noise(rng, (3, 69 * c.hop_len + c.frame_len)), None,
                      "fft"))
    for n in FFT_GRID:
        c = _fft_grid_config(n)
        cases.append((f"unbounded log-mel, n_fft {n}, T=71", c, False,
                      _noise(rng, (3, 70 * c.hop_len + c.frame_len)), None,
                      "fft64"))
    cases += [
        ("B=3 ragged (frames inside each length)", base, True, ragged,
         ragged_lens, "fft"),
        ("T=1", base, True, _noise(rng, (2, fl)), None, "fft"),
        ("lifter=22, append_energy=True",
         base.replace(lifter=22, append_energy=True), True,
         _noise(rng, (3, 69 * hop + fl)), None, "fft"),
        ("dynamic_range_db=50", base.replace(dynamic_range_db=50.0), True,
         _noise(rng, (3, 69 * hop + fl)), None, "fft"),
        ("log-mel-80 <= 50 dB, apply_dct=False",
         lm80.replace(dynamic_range_db=50.0), False,
         _noise(rng, (3, 69 * hop + fl)), None, "fft"),
        ("unbounded log-mel-80, T=71", lm80, False,
         _noise(rng, (3, 70 * hop + fl)), None, "fft64"),
        ("unbounded log-mel-80, B=3 ragged", lm80, False, ragged,
         ragged_lens, "fft64"),
        ("unbounded log-mel-80, TTS geometry, T=71", tts, False,
         _noise(rng, (2, 70 * tts.hop_len + tts.frame_len)), None, "fft64"),
        ("unbounded log-mel-80, Hann two-tone valley",
         lm80.replace(window="hann"), False, tones[None], None, "fft64"),
        ("unbounded log-mel-80, Hamming two tones", lm80, False, tones[None],
         None, "fft64"),
        ("n_fft 401 (fused_dit: 400)", base.replace(n_fft=401), True,
         _noise(rng, (3, 69 * hop + fl)), None, "other"),
    ]
    wrappers = _spectral_wrappers()
    worst = {}
    for name, (module, fn, raw) in wrappers.items():
        worst[name] = 0.0
        for case, c, dct, audio, lens, tile in cases:
            if tile == "other":
                tile = _other_tile(name)
                if name == "fused_dit":
                    c = c.replace(n_fft=400)
            x = torch.from_numpy(np.ascontiguousarray(audio)).to(dev)
            if not raw:
                x = framing.preemphasize(x, c).contiguous()
            before = _tiles(module)
            got = getattr(module, fn)(x, c, apply_dct=dct)
            torch.cuda.synchronize()
            ran = _tile_ran(module, before)
            want = module.plain_features(x, c, dct)
            torch.cuda.synchronize()
            assert ran == f"{tile} tile, ", (name, case, ran, tile)
            err = _check(torch, dev, f"[3b FFT tile vs plain] {name} "
                         f"{'cepstra' if dct else 'log-mel'}, {case}", got,
                         want, x, c, dct, raw, lens, tile)
            worst[name] = max(worst[name], err)
    return worst


def _spectral_kernels_vs_plain(torch, dev) -> dict:
    """Phase 3b: -> {kernel: max abs diff over its cases}."""
    from mfcc_tpu_torch import FeatureConfig
    from mfcc_tpu_torch.ops import framing
    rng = np.random.default_rng(4)
    wrappers = _spectral_wrappers()
    worst = {}
    for name, path_cfg in _slice3_configs().items():
        module, fn, raw = wrappers[name]
        apply_dct = name == "fused_mfcc"
        sr, fl, hop = path_cfg.sample_rate, path_cfg.frame_len, path_cfg.hop_len
        ragged_lens = (sr, sr * 3 // 4 + 123, sr // 4)
        ragged = np.zeros((3, sr), np.float32)
        for i, n in enumerate(ragged_lens):
            ragged[i, :n] = _noise(rng, n)
        cases = [
            (f"bench {BATCH} x {SECONDS:g} s", path_cfg, apply_dct,
             _bench_audio(BATCH, SECONDS, sr), None),
            ("default config", FeatureConfig(), name != "fused_raw_dit",
             _noise(rng, (2, 16000)), None),
            ("B=3 ragged (frames inside each length)", path_cfg, apply_dct,
             ragged, ragged_lens),
            ("T=70, not a tile multiple", path_cfg, apply_dct,
             _noise(rng, (2, 69 * hop + fl)), None),
        ]
        worst[name] = 0.0
        for case, c, dct, audio, lens in cases:
            c = c.validate()
            x = torch.from_numpy(np.ascontiguousarray(audio)).to(dev)
            if not raw:
                x = framing.preemphasize(x, c).contiguous()
            before = _tiles(module)
            got = getattr(module, fn)(x, c, apply_dct=dct)
            torch.cuda.synchronize()
            ran = _tile_ran(module, before)
            want = module.plain_features(x, c, dct)
            torch.cuda.synchronize()
            assert got.shape == (x.shape[0], c.num_frames(x.shape[1]),
                                 c.n_mfcc if dct else c.n_mels), \
                (name, case, got.shape)
            err = _check(torch, dev, f"[3b spectral kernels vs plain] {name} "
                         f"{'cepstra' if dct else 'log-mel'}, {case}", got,
                         want, x, c, dct, raw, lens, ran.split(" ")[0])
            worst[name] = max(worst[name], err)
    return worst


def _acc_log_bits(torch, dev) -> int:
    """Phase 3c: the kernels' acc_log against ops/xmath, bit for bit."""
    from mfcc_tpu_torch.ops import xmath
    from mfcc_tpu_torch.ops.kernels import fused_mfcc
    rng = np.random.default_rng(5)
    floors = np.float32([1e-10, 1e-12, 1e-5, 1e-7, 1.0, 2.0,
                         np.finfo(np.float32).tiny, np.finfo(np.float32).max])
    bits = rng.integers(1, 0x7F800000, size=(1 << 20) - floors.size,
                        dtype=np.int64).astype(np.uint32)
    x = torch.from_numpy(np.concatenate([bits.view(np.float32), floors]))
    got = fused_mfcc.acc_log(x.to(dev)).cpu()
    want = xmath._acc_log(x)
    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    _log(f"[3c accurate log] CUDA acc_log vs ops/xmath on {x.numel()} "
         f"floats (full exponent range, subnormals and floors): {bad} "
         f"differ in any bit")
    assert bad == 0, bad
    return bad


def _logmel_main_paths(torch, dev):
    """Phase 4b: -> ({kernel: launches in its main path's run}, {kernel:
    those launches by tile, where the kernel has more than one})."""
    from mfcc_tpu_torch import oracle
    from mfcc_tpu_torch.models import logmel as logmel_model
    from mfcc_tpu_torch.models import mfcc as mfcc_model
    from mfcc_tpu_torch.utils import wav
    modules = {k: m for k, (m, _, _) in _spectral_wrappers().items()}
    speech, _ = wav.read_wav(os.path.join(GOLDEN, "speech2s.wav"))
    launches, tiles = {}, {}
    for name, cfg in _slice3_configs().items():
        cfg = cfg.validate()
        cepstra = name == "fused_mfcc"
        entry = mfcc_model.mfcc_batch if cepstra else logmel_model.log_mel_batch
        bench = _bench_audio(BATCH, SECONDS, cfg.sample_rate)
        B, N = bench.shape
        lens = np.maximum(N - np.arange(B) * (N // (B + 6)), 0).astype(np.int32)
        lens[-2:] = (cfg.frame_len, cfg.frame_len - 1)   # 1 frame, 0 frames
        audio = bench.copy()
        for i, n in enumerate(lens):
            audio[i, n:] = 0.0
        x16 = _int16(audio)

        _reset_counts(modules.values())
        feat, flens, mask = entry(torch.from_numpy(x16).to(dev),
                                  torch.from_numpy(lens).to(dev), cfg)
        torch.cuda.synchronize()
        counts = {k: m.LAUNCHES for k, m in modules.items()}
        tiles[name] = _tiles(modules[name])
        _log(f"[4b log-mel and fallback main paths] "
             f"{entry.__name__} ({name} route) launched {counts}, by tile "
             f"{tiles[name]}")
        assert counts[name] > 0 and sum(counts.values()) == counts[name], \
            f"the {name} main path did not go through {name} alone"
        assert tiles[name][MAIN_TILES[name]] == counts[name], \
            f"the {name} main path did not run the {MAIN_TILES[name]} tile"
        launches[name] = counts[name]
        gold = None
        if name == "fused_raw":      # the golden WAV, counted on its own
            _reset_counts(modules.values())
            gold = logmel_model.log_mel(torch.from_numpy(speech).to(dev), cfg)
            torch.cuda.synchronize()
            assert modules[name].LAUNCHES > 0, \
                "log_mel on speech2s.wav did not go through fused_raw"

        T = cfg.num_frames(N)
        width = (cfg.n_mfcc if cepstra else cfg.n_mels) * (
            3 if cfg.deltas else 1)
        want_fl = np.array([cfg.num_frames(int(n)) for n in lens])
        f, m = feat.cpu().numpy(), mask.cpu().numpy()
        assert f.shape == (B, T, width), f.shape
        assert (flens.cpu().numpy() == want_fl).all(), flens
        assert (m == (np.arange(T)[None] < want_fl[:, None])).all()
        assert np.isfinite(f).all() and (f[~m] == 0.0).all()
        # unbounded log-mel on audio the host pre-emphasized in f32 keeps
        # that rounding (fused_dit); the fft64 tile on raw audio does not
        tol = (LOGMEL_ORACLE_TOL if name == "fused_dit" else ORACLE_TOL)
        ref = oracle.mfcc if cepstra else oracle.log_mel
        xf = x16.astype(np.float64) / 32768.0
        for i in (0, B // 2, B - 2):
            want = ref(xf[i, : lens[i]], cfg)
            err = float(np.abs(f[i, : want.shape[0]] - want).max())
            _log(f"[4b log-mel and fallback main paths] {name}: int16 ragged "
                 f"batch {f.shape}, row {i} ({want.shape[0]} frames) vs "
                 f"float64 oracle {err:.3e} (bound {tol:g})")
            assert err <= tol, (name, i, err)
        if gold is not None:
            want = np.load(os.path.join(GOLDEN, "logmel80_deltas.npy"))
            got = gold.cpu().numpy()
            assert got.shape == want.shape, (got.shape, want.shape)
            err = float(np.abs(got - want).max())
            _log(f"[4b log-mel and fallback main paths] speech2s.wav vs "
                 f"logmel80_deltas.npy: {err:.3e} (bound "
                 f"{LOGMEL_ORACLE_TOL:g})")
            assert err <= LOGMEL_ORACLE_TOL, err
    return launches, tiles


def _projections_vs_plain(torch, dev, bench) -> dict:
    """Phase 3d: fused_raw_dit's bark and spec projections against their
    plain versions; -> {record name: max abs diff over its cases}."""
    from mfcc_tpu_torch import FeatureConfig
    from mfcc_tpu_torch.ops.kernels import fused_raw_dit
    rng = np.random.default_rng(8)
    base = FeatureConfig().validate()
    sr, fl, hop = base.sample_rate, base.frame_len, base.hop_len
    ragged_lens = (sr, sr * 3 // 4 + 123, sr // 4)
    ragged = np.zeros((3, sr), np.float32)
    for i, n in enumerate(ragged_lens):
        ragged[i, :n] = _noise(rng, n)
    t = np.arange(sr) / sr
    tones = (0.5 * np.sin(2 * np.pi * 180.0 * t)
             + 0.3 * np.sin(2 * np.pi * 1200.0 * t)).astype(np.float32)
    # (case, cfg, audio, lens, tile); tile "direct" runs n_fft 401 for bark
    # and 768 (admitted by spec_kernel_eligible) for spec
    cases = [
        (f"bench {bench.shape[0]} x {bench.shape[1] / sr:g} s", base, bench,
         None, "fft64"),
        ("B=3 ragged (frames inside each length)", base, ragged, ragged_lens,
         "fft64"),
        ("T=70, not a tile multiple", base, _noise(rng, (2, 69 * hop + fl)),
         None, "fft64"),
        ("T=1", base, _noise(rng, (2, fl)), None, "fft64"),
        ("n_fft 256, 8 kHz", FeatureConfig(sample_rate=8000, n_fft=256),
         _noise(rng, (2, 8000)), None, "fft64"),
        ("n_fft 1024", base.replace(n_fft=1024), _noise(rng, (2, sr)), None,
         "fft64"),
        ("n_fft 2048, 48 kHz", FeatureConfig(sample_rate=48000, n_fft=2048),
         _noise(rng, (2, 48000)), None, "fft64"),
        ("Hann two-tone valley", base.replace(window="hann"), tones[None],
         None, "fft64"),
        ("direct tile, n_fft 401 (spec: 768)", base, _noise(rng, (3, sr)),
         None, "direct"),
    ]
    worst = {}
    for rec, projection in PROJECTIONS.items():
        worst[rec] = 0.0
        for case, c, audio, lens, tile in cases:
            if tile == "direct":
                c = c.replace(n_fft=401 if projection == "bark" else 768)
            x = torch.from_numpy(np.ascontiguousarray(audio)).to(dev)
            before = _tiles(fused_raw_dit)
            got = fused_raw_dit.fused_features_raw_dit(
                x, c, apply_dct=False, projection=projection)
            torch.cuda.synchronize()
            ran = _tile_ran(fused_raw_dit, before)
            want = fused_raw_dit.plain_features(x, c, False, projection)
            torch.cuda.synchronize()
            assert ran == f"{tile} tile, ", (rec, case, ran, tile)
            assert got.shape == (x.shape[0], c.num_frames(x.shape[1]),
                                 c.n_bark if projection == "bark"
                                 else c.n_bins), (rec, case, got.shape)
            err = _check(torch, dev, f"[3d projections vs plain] {rec}, "
                         f"{case}", got, want, x, c, False, True, lens, tile,
                         projection)
            worst[rec] = max(worst[rec], err)
    return worst


def _plp_spectrogram_main_paths(torch, dev):
    """Phase 4c: -> ({record: fused_raw_dit launches in its main path's
    run}, {record: the tile they ran})."""
    from mfcc_tpu_torch import FeatureConfig, oracle
    from mfcc_tpu_torch.models import plp as plp_model
    from mfcc_tpu_torch.models import spectrogram as spec_model
    from mfcc_tpu_torch.utils import wav
    modules = {k: m for k, (m, _, _) in _spectral_wrappers().items()}
    raw_dit = modules["fused_raw_dit"]
    speech, _ = wav.read_wav(os.path.join(GOLDEN, "speech2s.wav"))
    cfg = FeatureConfig().validate()
    bench = _bench_audio(BATCH, SECONDS, cfg.sample_rate)
    B, N = bench.shape
    lens = np.maximum(N - np.arange(B) * (N // (B + 6)), 0).astype(np.int32)
    lens[-2:] = (cfg.frame_len, cfg.frame_len - 1)   # 1 frame, 0 frames
    audio = bench.copy()
    for i, n in enumerate(lens):
        audio[i, n:] = 0.0
    x16 = _int16(audio)
    xf = x16.astype(np.float64) / 32768.0
    entries = {"bark": (plp_model.plp_batch, oracle.plp, "plp13.npy"),
               "spec": (spec_model.log_spectrogram_batch,
                        oracle.log_spectrogram, "spectrogram257.npy")}
    launches, tiles = {}, {}
    for rec, projection in PROJECTIONS.items():
        entry, ref_fn, golden = entries[projection]
        _reset_counts(modules.values())
        feat, flens, mask = entry(torch.from_numpy(x16).to(dev),
                                  torch.from_numpy(lens).to(dev), cfg)
        torch.cuda.synchronize()
        counts = {k: m.LAUNCHES for k, m in modules.items()}
        by_tile = _tiles(raw_dit)
        by_proj = dict(raw_dit.PROJECTION_LAUNCHES)
        _log(f"[4c PLP and spectrogram main paths] {entry.__name__} launched "
             f"{counts}, by tile {by_tile}, by projection {by_proj}")
        assert counts == {k: int(k == "fused_raw_dit") for k in modules}, \
            f"{entry.__name__} did not launch fused_raw_dit once, alone"
        assert by_proj[projection] == 1 == by_tile["fft64"], \
            f"{entry.__name__} did not run the {projection} projection on fft64"
        launches[rec], tiles[rec] = by_proj[projection], "fft64"
        _reset_counts(modules.values())   # the golden WAV, counted apart
        gold, gold_fl, _ = entry(torch.from_numpy(speech[None]).to(dev),
                                 torch.tensor([len(speech)], device=dev), cfg)
        torch.cuda.synchronize()
        assert raw_dit.PROJECTION_LAUNCHES[projection] == 1, \
            f"{entry.__name__} on speech2s.wav did not go through the kernel"

        T = cfg.num_frames(N)
        width = cfg.n_mfcc if projection == "bark" else cfg.n_bins
        want_fl = np.array([cfg.num_frames(int(n)) for n in lens])
        f, m = feat.cpu().numpy(), mask.cpu().numpy()
        assert f.shape == (B, T, width), f.shape
        assert (flens.cpu().numpy() == want_fl).all(), flens
        assert (m == (np.arange(T)[None] < want_fl[:, None])).all()
        assert np.isfinite(f).all() and (f[~m] == 0.0).all()
        checks = [(f"int16 ragged batch {f.shape}, row {i}", f[i],
                   ref_fn(xf[i, : lens[i]], cfg)) for i in (0, B // 2, B - 2)]
        checks.append((f"speech2s.wav vs {golden}", gold[0].cpu().numpy(),
                       np.load(os.path.join(GOLDEN, golden))))
        assert int(gold_fl[0]) == checks[-1][2].shape[0]
        for what, got, want in checks:
            got = got[: want.shape[0]]
            if projection == "bark":
                err = float(np.abs(got - want).max())
                bound = ORACLE_TOL
            else:
                keep = want > (want.max(axis=-1, keepdims=True)
                               - math.log(10.0 ** (SPEC_WINDOW_DB / 10.0)))
                err = float(np.abs(got - want)[keep].max())
                bound = SPEC_TOL
            _log(f"[4c PLP and spectrogram main paths] {rec}: {what} "
                 f"({want.shape[0]} frames) vs the float64 reference {err:.3e}"
                 f" (bound {bound:g}; every bin {np.abs(got - want).max():.3e})")
            assert err <= bound, (rec, what, err)
    # configs the reference sends to XLA run the plain chain on the card
    rng = np.random.default_rng(9)
    for entry, ref_fn, c in (
            (spec_model.log_spectrogram_batch, oracle.log_spectrogram,
             cfg.replace(n_fft=400)),
            (plp_model.plp_batch, oracle.plp,
             FeatureConfig(sample_rate=44100, n_fft=2048))):
        x = _noise(rng, (4, c.sample_rate))
        _reset_counts(modules.values())
        feat, _, _ = entry(torch.from_numpy(x).to(dev),
                           torch.full((4,), c.sample_rate, device=dev), c)
        torch.cuda.synchronize()
        counts = {k: m.LAUNCHES for k, m in modules.items()}
        want = ref_fn(x[0].astype(np.float64), c)
        got = feat[0].cpu().numpy()
        if entry is plp_model.plp_batch:
            err, bound = float(np.abs(got - want).max()), ORACLE_TOL
        else:
            keep = want > (want.max(axis=-1, keepdims=True)
                           - math.log(10.0 ** (SPEC_WINDOW_DB / 10.0)))
            err, bound = float(np.abs(got - want)[keep].max()), SPEC_TOL
        _log(f"[4c PLP and spectrogram main paths] {entry.__name__} at "
             f"{c.sample_rate} Hz, n_fft {c.n_fft} (the reference's XLA "
             f"route): launched {counts}; row 0 vs the float64 oracle "
             f"{err:.3e} (bound {bound:g})")
        assert sum(counts.values()) == 0, counts
        assert err <= bound, err
    return launches, tiles


def _nccf_inputs(torch, dev, pcfg, audio, lens):
    """Work-rate rows, valid frame counts and the wrapper-side ballast of a
    (B, N) batch, on the card."""
    from mfcc_tpu_torch.ops import pitch as pitch_op, resample
    x = torch.from_numpy(np.ascontiguousarray(audio)).to(dev)
    xw = resample.resample(x, pcfg.sample_rate, pcfg.work_rate)
    T = pcfg.num_frames(audio.shape[1])
    flens = np.array([pcfg.num_frames(int(n)) for n in lens])
    mask = torch.from_numpy(np.arange(T)[None, :] < flens[:, None]).to(dev)
    mean_e = pitch_op.mean_frame_energy(xw, pcfg, mask)
    return xw, pcfg.ballast * mean_e * mean_e, T, flens


def _nccf_kernel_vs_plain(torch, dev, bench) -> tuple:
    from mfcc_tpu_torch import PitchConfig
    from mfcc_tpu_torch.ops.kernels import fused_nccf
    pcfg = PitchConfig().validate()
    sr = pcfg.sample_rate
    rng = np.random.default_rng(2)
    ragged_lens = (2 * sr, 23456, 4000)
    ragged = np.zeros((3, 2 * sr), np.float32)
    for i, n in enumerate(ragged_lens):
        ragged[i, :n] = 0.3 * rng.standard_normal(n)
    short = bench[:4, :3 * sr]
    full = [bench.shape[1]] * bench.shape[0]
    cases = [
        (f"bench {bench.shape[0]} x {bench.shape[1] / sr:g} s", pcfg, bench,
         full),
        ("B=3 ragged noise", pcfg, ragged, ragged_lens),
        ("work_rate=2000", pcfg.replace(work_rate=2000), short, [3 * sr] * 4),
        ("min_f0=60, max_f0=300", pcfg.replace(min_f0=60.0, max_f0=300.0),
         short, [3 * sr] * 4),
        ("hop_ms=15.25", pcfg.replace(hop_ms=15.25), short, [3 * sr] * 4),
        ("T=205, not a tile multiple", pcfg,
         0.3 * rng.standard_normal((2, 33360)).astype(np.float32), [33360] * 2),
        ("T=1", pcfg, bench[:3, :720], [720] * 3),
    ]
    worst, bench_tile = 0.0, None
    for name, c, audio, lens in cases:
        xw, ball, T, flens = _nccf_inputs(torch, dev, c.validate(), audio, lens)
        got = fused_nccf.fused_nccf(xw, ball, c, T=T)
        torch.cuda.synchronize()
        shape = fused_nccf.LAST_SHAPE
        want = fused_nccf.plain_nccf(xw, ball, c, T)
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got, want):
            assert g.shape == w.shape == (audio.shape[0], T, c.n_lags)
            assert bool(torch.isfinite(g).all()), name
            for i, v in enumerate(flens):
                if v:
                    err = max(err, float((g[i, :v] - w[i, :v]).abs().max()))
        _log(f"[5 NCCF kernel vs plain] {name}: tile {shape}, shape "
             f"{tuple(got[0].shape)}, max abs diff {err:.3e} on valid frames")
        assert err <= KERNEL_TOL, (name, err)
        worst = max(worst, err)
        bench_tile = bench_tile or shape
    return worst, bench_tile


def _viterbi_kernel_vs_plain(torch, dev) -> int:
    from mfcc_tpu_torch import PitchConfig
    from mfcc_tpu_torch.ops import pitch as pitch_op
    from mfcc_tpu_torch.ops.kernels import fused_viterbi
    pcfg = PitchConfig()
    rng = np.random.default_rng(3)

    def scores(B, T, n=pcfg.n_lags, ties=False):
        s = (rng.integers(-1, 2, (B, T, n)) if ties
             else 0.5 * rng.standard_normal((B, T, n))).astype(np.float32)
        s[1::2, T * 2 // 3:] = 0.0           # zero-emission tails
        return torch.from_numpy(s).to(dev)

    def differ(s, c):
        got = fused_viterbi.fused_viterbi(s, c)
        torch.cuda.synchronize()
        want = pitch_op.viterbi(s, c)
        assert got.dtype == want.dtype == torch.int32
        assert got.shape == want.shape == s.shape[:2]
        return int((got != want).sum())

    bad = 0
    for B in VITERBI_BATCHES:
        for T in VITERBI_STEPS:
            bad += differ(scores(B, T), pcfg)
    _log(f"[6 Viterbi kernel vs plain] B in {VITERBI_BATCHES} x T in "
         f"{VITERBI_STEPS}: {bad} path entries differ (the main path's "
         f"launch shape {fused_viterbi.LAST_SHAPE})")
    # min_f0 15.09 / 15.0 Hz at the 4 kHz work rate: 256 / 257 lags
    cases = [("tie-heavy (penalty=0, scores in {-1, 0, 1})",
              pcfg.replace(penalty=0.0), scores(64, VITERBI_WIDE, ties=True)),
             *((f"{c.n_lags} lags", c, scores(4, VITERBI_WIDE, c.n_lags))
               for c in (pcfg.replace(min_f0=15.09),
                         pcfg.replace(min_f0=15.0)))]
    n = int(LONG_SECONDS * pcfg.sample_rate)
    cases.append((f"unblocked B=1 x {LONG_SECONDS:g} s", pcfg,
                  scores(1, pcfg.num_frames(n))))
    for name, c, s in cases:
        case_bad = differ(s, c.validate())
        _log(f"[6 Viterbi kernel vs plain] {name}, (B, T, n) "
             f"{tuple(s.shape)}: {case_bad} path entries differ (launch shape "
             f"{fused_viterbi.LAST_SHAPE})")
        bad += case_bad
    got = pitch_op.viterbi_blocked(s, pcfg, backend="cuda")
    torch.cuda.synchronize()
    want = pitch_op.viterbi_blocked(s, pcfg, backend="torch")
    long_bad = int((got != want).sum())
    _log(f"[6 Viterbi kernel vs plain] viterbi_blocked, B=1 x "
         f"{LONG_SECONDS:g} s (T={s.shape[1]}): {long_bad} path entries "
         f"differ")
    bad += long_bad
    assert bad == 0, bad
    return bad


def _pitch_for(cfg):
    """The PitchConfig the MFCC + pitch composition uses with a
    FeatureConfig: the same frame and hop (align_pitch pastes pitch frame t
    onto main frame t) and a work rate capped at the input rate."""
    from mfcc_tpu_torch import PitchConfig
    return PitchConfig(sample_rate=cfg.sample_rate, frame_ms=cfg.frame_ms,
                       hop_ms=cfg.hop_ms,
                       work_rate=min(4000, cfg.sample_rate)).validate()


def _mfcc_plus_pitch(torch, x, lens, cfg):
    """(B, N), (B,) -> ((B, T, n_mfcc + 3), flens, mask): MFCC with the
    aligned pitch features appended, padded frames zero."""
    from mfcc_tpu_torch.models import mfcc as mfcc_model, pitch as pitch_model
    feat, flens, mask = mfcc_model.mfcc_batch(x, lens, cfg)
    pf, pl, _ = pitch_model.pitch_batch(x, lens, _pitch_for(cfg))
    pf = pitch_model.align_pitch(pf, pl, feat.shape[1])
    pf = torch.where(mask[..., None], pf, 0.0)
    return torch.cat([feat, pf], dim=-1), flens, mask


def _pitch_main_path(torch, dev, bench) -> dict:
    from mfcc_tpu_torch import FeatureConfig, PitchConfig, oracle
    from mfcc_tpu_torch.models import pitch as pitch_model
    from mfcc_tpu_torch.ops.kernels import (fused_nccf, fused_raw_dit,
                                            fused_viterbi)
    from mfcc_tpu_torch.utils import wav
    pcfg = PitchConfig().validate()
    cfg = FeatureConfig().validate()
    B, N = bench.shape
    lens = np.maximum(N - np.arange(B) * (N // (B + 6)), 0).astype(np.int32)
    lens[-2:] = (720, 715)                   # 1 pitch frame, 0 pitch frames
    audio = bench.copy()
    for i, n in enumerate(lens):
        audio[i, n:] = 0.0
    x16 = _int16(audio)
    speech, _ = wav.read_wav(os.path.join(GOLDEN, "speech2s.wav"))
    xd = torch.from_numpy(x16).to(dev)
    ld = torch.from_numpy(lens).to(dev)

    fused_nccf.LAUNCHES = fused_viterbi.LAUNCHES = 0
    feat, flens, mask = pitch_model.pitch_batch(xd, ld, pcfg)
    torch.cuda.synchronize()
    launches = {"fused_nccf": fused_nccf.LAUNCHES,
                "fused_viterbi": fused_viterbi.LAUNCHES}
    _log(f"[7 pitch main path] pitch_batch launched {launches}")
    assert all(v > 0 for v in launches.values()), \
        "the pitch main path did not go through both kernels"

    fused_nccf.LAUNCHES = fused_viterbi.LAUNCHES = fused_raw_dit.LAUNCHES = 0
    comb, cfl, cmask = _mfcc_plus_pitch(torch, xd, ld, cfg)
    torch.cuda.synchronize()
    comb_launches = {"fused_raw_dit": fused_raw_dit.LAUNCHES,
                     "fused_nccf": fused_nccf.LAUNCHES,
                     "fused_viterbi": fused_viterbi.LAUNCHES}
    _log(f"[7 pitch main path] the MFCC + pitch composition launched "
         f"{comb_launches}")
    assert all(v > 0 for v in comb_launches.values()), \
        "the MFCC + pitch composition did not go through all three kernels"
    gold, gold_fl, _ = pitch_model.pitch_batch(
        torch.from_numpy(speech[None]).to(dev),
        torch.tensor([len(speech)], dtype=torch.int32, device=dev), pcfg)
    torch.cuda.synchronize()

    T = pcfg.num_frames(N)
    want_fl = np.array([pcfg.num_frames(int(n)) for n in lens])
    f, m = feat.cpu().numpy(), mask.cpu().numpy()
    assert f.shape == (B, T, 3), f.shape
    assert (flens.cpu().numpy() == want_fl).all(), flens
    assert (m == (np.arange(T)[None] < want_fl[:, None])).all()
    assert np.isfinite(f).all()
    assert (f[~m] == 0.0).all(), "padded frames not zero"
    xf = x16.astype(np.float64) / 32768.0
    for i in (0, B // 2, B - 2):
        want = oracle.pitch(xf[i, : lens[i]], pcfg)
        errs = _columns_err(f[i, : want.shape[0]], want, PITCH_TOL)
        _log(f"[7 pitch main path] int16 ragged batch {f.shape}, row {i} "
             f"({want.shape[0]} frames) vs float64 oracle, pov/norm/delta "
             f"{_fmt(errs)}")
    want = np.load(os.path.join(GOLDEN, "pitch3.npy"))
    assert int(gold_fl[0]) == want.shape[0]
    errs = _columns_err(gold[0].cpu().numpy(), want, PITCH_TOL)
    _log(f"[7 pitch main path] speech2s.wav vs pitch3.npy, pov/norm/delta "
         f"{_fmt(errs)}")

    c, cm = comb.cpu().numpy(), cmask.cpu().numpy()
    Tm = cfg.num_frames(N)
    assert c.shape == (B, Tm, cfg.n_mfcc + 3), c.shape
    assert (cfl.cpu().numpy() == [cfg.num_frames(int(n)) for n in lens]).all()
    assert np.isfinite(c).all() and (c[~cm] == 0.0).all()
    assert (c[B - 1, :, cfg.n_mfcc:] == 0.0).all(), "no pitch frames -> 0"
    for i in (0, B - 2):
        ref = oracle.mfcc(xf[i, : lens[i]], cfg)
        pw = oracle.pitch(xf[i, : lens[i]], _pitch_for(cfg))
        pw = pw[np.minimum(np.arange(ref.shape[0]), pw.shape[0] - 1)]
        got = c[i, : ref.shape[0]]
        merr = float(np.abs(got[:, : cfg.n_mfcc] - ref).max())
        assert merr <= ORACLE_TOL, merr
        errs = _columns_err(got[:, cfg.n_mfcc:], pw, PITCH_TOL)
        _log(f"[7 pitch main path] MFCC + pitch {c.shape}, row {i} vs "
             f"float64 oracles: MFCC {merr:.3e}, pov/norm/delta {_fmt(errs)}")
    return launches


def _rfft_stage(torch, y, cfg):
    """The DFT stage alone as one library call: cuFFT's real FFT of the
    windowed frames of pre-emphasized audio y, materialized here, outside
    the timed call (a yardstick, not the function)."""
    from mfcc_tpu_torch import oracle
    from mfcc_tpu_torch.ops import framing
    win = torch.from_numpy(oracle.window_fn(cfg.window, cfg.frame_len)
                           .astype(np.float32)).to(y.device)
    frames = (framing.frames(y, cfg) * win).contiguous()
    return lambda: torch.fft.rfft(frames, n=cfg.n_fft)


def _ops_and_host_ms(torch, fn):
    """(ATen ops one call of fn dispatches, views included; host ms to
    enqueue one call, TIMING_CALLS calls back to back)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _CountOps(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with _CountOps() as counter:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMING_CALLS):
        fn()
    host_ms = (time.perf_counter() - t0) / TIMING_CALLS * 1e3
    torch.cuda.synchronize()
    return counter.n, host_ms


def _timing(torch, dev, bench, smi, sm_mhz) -> dict:
    from mfcc_tpu_torch import FeatureConfig, PitchConfig
    from mfcc_tpu_torch.models import logmel as logmel_model
    from mfcc_tpu_torch.models import mfcc as mfcc_model, pitch as pitch_model
    from mfcc_tpu_torch.models import plp as plp_model
    from mfcc_tpu_torch.models import spectrogram as spec_model
    from mfcc_tpu_torch.ops import framing, pitch as pitch_op, plp as plp_op
    from mfcc_tpu_torch.ops.kernels import (fused_nccf, fused_raw_dit,
                                            fused_viterbi)
    cfg, pcfg = FeatureConfig(), PitchConfig()
    B, N = bench.shape
    xb = torch.from_numpy(bench).to(dev)
    lb = torch.full((B,), N, dtype=torch.int32, device=dev)
    xw, ball, T, _ = _nccf_inputs(torch, dev, pcfg, bench, [N] * B)
    scores = fused_nccf.plain_nccf(xw, ball, pcfg, T)[0]   # every frame valid
    # the plain Viterbi's T-step loop (~0.1 s a call): one group a pass
    slow = max(2, TIMING_CALLS // 6)
    runs = {}
    # each spectral kernel at its main-path config (fused_raw_dit at the
    # MFCC-13 one), beside it the tile it replaced on the same work through
    # the same C entry, and beside a kernel on the fft64 tile the f32 FFT
    # tile, beside one on the fft tile cuFFT's DFT stage alone
    configs = {**_slice3_configs(), "fused_raw_dit": cfg}
    for name, (module, fn, raw) in _spectral_wrappers().items():
        c, dct = configs[name], name in ("fused_raw_dit", "fused_mfcc")
        audio = (xb if name == "fused_raw_dit" else torch.from_numpy(
            _bench_audio(B, SECONDS, c.sample_rate)).to(dev))
        inp = audio if raw else framing.preemphasize(audio, c).contiguous()
        runs[name] = (functools.partial(getattr(module, fn), inp, c,
                                        apply_dct=dct), TIMING_CALLS)
        runs[f"{name} plain"] = (functools.partial(module.plain_features,
                                                   inp, c, dct), TIMING_CALLS)
        other = _other_tile(name)
        runs[f"{name} {other}"] = (functools.partial(
            _on_tile, name, inp, c, dct, other),
            slow if name == "fused_mfcc" else TIMING_CALLS)
        if MAIN_TILES[name] == "fft64":
            runs[f"{name} fft"] = (functools.partial(
                _on_tile, name, inp, c, dct, "fft"), TIMING_CALLS)
        else:
            pre = inp if not raw else framing.preemphasize(inp, c)
            runs[f"{name} rfft"] = (_rfft_stage(torch, pre, c), TIMING_CALLS)
    # fused_raw_dit's bark and spec projections at the default config, with
    # the direct and the f32 FFT tile on the same work (cuFFT's rfft of the
    # same frames is "fused_raw_dit rfft" above)
    for rec, projection in PROJECTIONS.items():
        runs[rec] = (functools.partial(
            fused_raw_dit.fused_features_raw_dit, xb, cfg, apply_dct=False,
            projection=projection), TIMING_CALLS)
        runs[f"{rec} plain"] = (functools.partial(
            fused_raw_dit.plain_features, xb, cfg, False, projection),
            TIMING_CALLS)
        for tile in ("direct", "fft"):
            runs[f"{rec} {tile}"] = (functools.partial(
                _on_tile, "fused_raw_dit", xb, cfg, False, tile, projection),
                TIMING_CALLS)
    log_bark = fused_raw_dit.fused_features_raw_dit(xb, cfg, apply_dct=False,
                                                    projection="bark")
    lm_cfg = configs["fused_raw"]
    runs.update({
        "plp_batch cuda": (lambda: plp_model.plp_batch(xb, lb, cfg, "cuda"),
                           TIMING_CALLS),
        "plp_batch torch": (lambda: plp_model.plp_batch(xb, lb, cfg, "torch"),
                            TIMING_CALLS),
        "plp tail": (lambda: plp_op.plp_from_log_bark(log_bark, cfg),
                     TIMING_CALLS),
        "log_spectrogram_batch cuda": (lambda: spec_model.log_spectrogram_batch(
            xb, lb, cfg, "cuda"), TIMING_CALLS),
        "log_spectrogram_batch torch": (
            lambda: spec_model.log_spectrogram_batch(xb, lb, cfg, "torch"),
            TIMING_CALLS),
        "fused_nccf": (lambda: fused_nccf.fused_nccf(xw, ball, pcfg, T=T),
                       TIMING_CALLS),
        "fused_nccf plain": (lambda: fused_nccf.plain_nccf(xw, ball, pcfg, T),
                             TIMING_CALLS),
        "fused_viterbi": (lambda: fused_viterbi.fused_viterbi(scores, pcfg),
                          TIMING_CALLS),
        "fused_viterbi plain": (lambda: pitch_op.viterbi(scores, pcfg), slow),
        "mfcc_batch cuda": (lambda: mfcc_model.mfcc_batch(xb, lb, cfg, "cuda"),
                            TIMING_CALLS),
        "mfcc_batch torch": (lambda: mfcc_model.mfcc_batch(xb, lb, cfg, "torch"),
                             TIMING_CALLS),
        "log_mel_batch cuda": (lambda: logmel_model.log_mel_batch(
            xb, lb, lm_cfg, "cuda"), TIMING_CALLS),
        "log_mel_batch torch": (lambda: logmel_model.log_mel_batch(
            xb, lb, lm_cfg, "torch"), TIMING_CALLS),
        "pitch_batch cuda": (lambda: pitch_model.pitch_batch(xb, lb, pcfg,
                                                             "cuda"),
                             TIMING_CALLS),
        "pitch_batch torch": (lambda: pitch_model.pitch_batch(xb, lb, pcfg,
                                                              "torch"), slow),
    })
    times = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):
        for k in order:
            fn, calls = runs[k]
            times[k] += _time_ms(torch, fn, calls=calls)
    med = {k: statistics.median(v) for k, v in times.items()}
    audio_s = B * SECONDS
    for k, ms in med.items():
        _log(f"[8 timing] {k}: {ms:.4f} ms per {B} x {SECONDS:g} s "
             f"batch = {audio_s / (ms / 1e3):,.0f} audio-sec/s "
             f"(median of {len(times[k])} groups; {smi})")
    for name in SPECTRAL:
        other, tile = _other_tile(name), MAIN_TILES[name]
        line = (f"[8 timing] {name}: {tile} tile {med[name]:.4f} ms against "
                f"the {other} tile on the same work {med[f'{name} {other}']:.4f}"
                f" ms ({med[f'{name} {other}'] / med[name]:.2f}x)")
        if tile == "fft64":
            line += (f" and the f32 fft tile {med[f'{name} fft']:.4f} ms "
                     f"(f64 costs {med[name] / med[f'{name} fft']:.2f}x)")
        else:
            line += (f"; cuFFT rfft of the materialized windowed frames "
                     f"alone {med[f'{name} rfft']:.4f} ms")
        _log(line)
    for rec in PROJECTIONS:
        _log(f"[8 timing] {rec}: fft64 tile {med[rec]:.4f} ms against the "
             f"direct tile on the same work {med[f'{rec} direct']:.4f} ms "
             f"({med[f'{rec} direct'] / med[rec]:.2f}x) and the f32 fft tile "
             f"{med[f'{rec} fft']:.4f} ms (f64 costs "
             f"{med[rec] / med[f'{rec} fft']:.2f}x); cuFFT rfft of the "
             f"same frames alone {med['fused_raw_dit rfft']:.4f} ms")
    steps = scores.shape[1] - 1
    chain = _chain_ms(scores.shape[1], pcfg.n_lags, sm_mhz)
    _log(f"[8 timing] fused_viterbi per step of its {steps}-step chain: "
         f"{med['fused_viterbi'] / steps * 1e3:.4f} us against the chain "
         f"bound {chain / steps * 1e3:.4f} us ({_chain_cycles(pcfg.n_lags)} "
         f"cycles at {sm_mhz:g} MHz; {smi})")
    n_ops, host_ms = _ops_and_host_ms(
        torch, lambda: plp_op.plp_from_log_bark(log_bark, cfg))
    _log(f"[8 timing] PLP tail (plp_from_log_bark on the kernel's {B} x "
         f"{log_bark.shape[1]} x {log_bark.shape[2]} output): {n_ops} ATen "
         f"ops, host enqueue {host_ms:.4f} ms a call, device "
         f"{med['plp tail']:.4f} ms back to back; plp_batch "
         f"{med['plp_batch cuda']:.4f} ms, of it fused_raw_dit/bark "
         f"{med['fused_raw_dit/bark']:.4f} ms ({smi})")
    # what the pitch path waits on: the host's enqueue against its time
    n_ops, host_ms = _ops_and_host_ms(torch, runs["pitch_batch cuda"][0])
    _log(f"[8 timing] pitch_batch (cuda): {n_ops} ATen ops, host enqueue "
         f"{host_ms:.4f} ms a call against {med['pitch_batch cuda']:.4f} ms "
         f"back to back; of it fused_nccf {med['fused_nccf']:.4f} + "
         f"fused_viterbi {med['fused_viterbi']:.4f} ms ({smi})")
    return med


def _spectral_work(cfg, apply_dct: bool, raw: bool, B: int, N: int,
                   projection: str = "mel", log: bool = True):
    """(operations, bytes) of the spectral function on a (B, N) float32
    batch: per frame a real FFT of n_fft points (2.5 n log2 n), window and
    in-kernel pre-emphasis, |X|^2, the projection matrix's nonzeros (mel or
    bark; none for the spectrogram), floors and the accurate log per band
    or bin (not with ``log=False``: the roofline's ``fft`` rung), the DCT
    and the energy column; bytes are the audio read once and the features
    written once."""
    from mfcc_tpu_torch.ops.kernels import _spectral
    n, fl = cfg.n_fft, cfg.frame_len
    width = _spectral.n_out(cfg, False, projection)
    proj = _spectral.projection_matrix(cfg, projection)
    rel = projection == "mel" and cfg.dynamic_range_db is not None
    per_frame = (2.5 * n * math.log2(n) + fl
                 + (2 * fl if raw and cfg.preemph else 0) + 3 * cfg.n_bins
                 + (0 if proj is None else 2 * int(np.count_nonzero(proj)))
                 + (width * (ACC_LOG_OPS + 1 + (2 if rel else 0)) if log
                    else 0))
    if apply_dct:
        per_frame += 2 * width * cfg.n_mfcc
        if cfg.append_energy and log:
            per_frame += 2 * fl + ACC_LOG_OPS
    T = cfg.num_frames(N)
    n_out = _spectral.n_out(cfg, apply_dct, projection)
    return B * T * per_frame, 4 * B * N + 4 * B * T * n_out


def _bounds(bench) -> dict:
    """{kernel: (ops, bytes)} at the shapes phase 8 times."""
    from mfcc_tpu_torch import FeatureConfig, PitchConfig
    B, N = bench.shape
    out = {"fused_raw_dit": _spectral_work(FeatureConfig(), True, True, B, N)}
    configs = _slice3_configs()
    for name, (_, _, raw) in _spectral_wrappers().items():
        if name != "fused_raw_dit":
            c = configs[name]
            out[name] = _spectral_work(c, name == "fused_mfcc", raw, B,
                                       int(SECONDS * c.sample_rate))
    p = PitchConfig()
    T, L = p.num_frames(N), p.n_lags
    out["fused_nccf"] = _nccf_work(
        B, T, int(round(N * p.work_rate / p.sample_rate)))
    # Viterbi: per step and state L additions and L comparisons
    out["fused_viterbi"] = (B * T * 2 * L * L, 4 * B * T * L + 4 * B * T)
    for rec, projection in PROJECTIONS.items():
        out[rec] = _spectral_work(FeatureConfig(), False, True, B, N,
                                  projection)
    return out


def _nccf_work(B: int, T: int, nw: int) -> tuple:
    """(operations, bytes) of the NCCF of T frames of B work-rate rows of nw
    samples: w x L numerator MACs, lag energies by a running sum, then per
    lag the product, floor, ballast, two square roots and two divisions
    (the least work; the kernel's own is _nccf_kernel_ops); the rows and
    the ballast read once, both NCCFs written once."""
    from mfcc_tpu_torch import PitchConfig
    p = PitchConfig()
    w, L = p.frame_len_w, p.n_lags
    return (B * T * (2 * w * L + 2 * (w + p.max_lag) + 8 * L),
            4 * (B * nw + B) + 2 * 4 * B * T * L)


def _nccf_kernel_ops(B: int, T: int, TM: int) -> float:
    """The operations fused_nccf itself does: the numerators' w x L MACs, a
    direct w-MAC energy for every window position of each TM-frame tile
    (no running sum: its rounding would differ), and the epilogue."""
    from mfcc_tpu_torch import PitchConfig
    p = PitchConfig()
    w, L, hop = p.frame_len_w, p.n_lags, p.hop_len_w
    tiles = [min(TM, T - t0) for t0 in range(0, T, TM)]
    positions = sum((tm - 1) * hop + p.max_lag + 1 for tm in tiles)
    return B * (T * (2 * w * L + 8 * L) + positions * 2 * w)


# ---- phases 10-13: packed corpus, dither, post chain and CMVN, streaming --

def _spectral_counts(modules) -> dict:
    """Every spectral launch counter: {kernel: launches}, with
    fused_raw_dit's by projection."""
    out = {k: m.LAUNCHES for k, m in modules.items()}
    out.update({f"fused_raw_dit/{p}": v for p, v in
                modules["fused_raw_dit"].PROJECTION_LAUNCHES.items()})
    return out


def _window_err(got: np.ndarray, want: np.ndarray) -> float:
    """Max abs error on the bins within SPEC_WINDOW_DB of each frame's
    peak in want."""
    keep = want > (want.max(axis=-1, keepdims=True)
                   - math.log(10.0 ** (SPEC_WINDOW_DB / 10.0)))
    return float(np.abs(got - want)[keep].max()) if keep.any() else 0.0


def _packed_families():
    """(name, family, config, its _compare bound as (cepstra, projection),
    oracle twin, oracle bound (None: the spectrogram's window), the launch
    counter it must move) of phase 10."""
    from mfcc_tpu_torch import FeatureConfig, oracle
    lm = FeatureConfig(n_mels=80, n_mfcc=80)
    return [
        ("mfcc", "mfcc", FeatureConfig(), (True, "mel"), oracle.mfcc,
         ORACLE_TOL, "fused_raw_dit/mel"),
        ("logmel <= 50 dB", "logmel", lm.replace(dynamic_range_db=50.0),
         (False, "mel"), oracle.log_mel, ORACLE_TOL, "fused_raw_dit/mel"),
        ("logmel unbounded", "logmel", lm, (False, "mel"), oracle.log_mel,
         LOGMEL_ORACLE_TOL, "fused_raw"),
        ("plp", "plp", FeatureConfig(), (True, "mel"), oracle.plp,
         ORACLE_TOL, "fused_raw_dit/bark"),
        ("spec", "spec", FeatureConfig(), (False, "spec"),
         oracle.log_spectrogram, None, "fused_raw_dit/spec"),
    ]


def _standalone(torch, family, x, cfg):
    """The family's batch model on one utterance (1, n) on the card."""
    from mfcc_tpu_torch.models import mfcc as mfcc_model, plp as plp_model
    from mfcc_tpu_torch.models import spectrogram as spec_model
    n = torch.tensor([x.shape[1]], device=x.device)
    if family == "plp":
        return plp_model.plp_batch(x, n, cfg)[0][0]
    if family == "spec":
        return spec_model.log_spectrogram_batch(x, n, cfg)[0][0]
    return mfcc_model.features_batch(x, n, cfg,
                                     apply_dct=family == "mfcc")[0][0]


def _pick_segments(rows, hop: int, count: int) -> list:
    """count (row, slot, uid, offset, n) of the packed rows, among them
    segments at odd and at even frame offsets."""
    segs = [(b, j, uid, off, n) for b, r in enumerate(rows)
            for j, (uid, off, n) in enumerate(r.segments)]
    odd = [s for s in segs if (s[3] // hop) % 2]
    even = [s for s in segs if not (s[3] // hop) % 2]
    assert odd and even, "no packed segment at an odd or an even frame"
    half = max(1, count // 2)
    return sorted(odd[:half] + even[: count - min(half, len(odd))])


def _packed_corpus(torch, dev, smi) -> None:
    """Phase 10: the ragged corpus packed by pack_rows through all four
    families, segments against their standalone kernel result and the
    oracle; packed mfcc_batch_packed against padded mfcc_batch, timed."""
    from mfcc_tpu_torch import FeatureConfig
    from mfcc_tpu_torch.models import mfcc as mfcc_model
    from mfcc_tpu_torch.utils import batch as batch_lib
    modules = {k: m for k, (m, _, _) in _spectral_wrappers().items()}
    sr, hop = 16000, FeatureConfig().hop_len
    lo, hi = PACK_SECONDS
    rng = np.random.default_rng(0)
    lens = rng.integers(int(lo * sr), int(hi * sr) + 1, PACK_UTTERANCES)
    audio = _bench_audio(PACK_UTTERANCES, hi, sr)
    utts = {i: audio[i, :n] for i, n in enumerate(lens)}
    cap = int(hi * sr)
    rows = list(batch_lib.pack_rows([(i, int(n)) for i, n in enumerate(lens)],
                                    cap, hop))
    S = max(len(r.segments) for r in rows)
    xp = np.zeros((len(rows), cap), np.float32)
    starts = np.zeros((len(rows), S), np.int32)
    seg_lens = np.zeros((len(rows), S), np.int32)
    for b, row in enumerate(rows):
        sig, st, ln = batch_lib.pack_audio(row, utts.__getitem__)
        xp[b], starts[b, : len(st)], seg_lens[b, : len(ln)] = sig, st, ln
    real = int(lens.sum())
    _log(f"[10 packed corpus] {PACK_UTTERANCES} utterances of {lo:g}-{hi:g} s "
         f"(numpy seed 0), {real / sr:.1f} s of audio, packed by pack_rows "
         f"at {hi:g} s ({cap} samples) into {len(rows)} rows of up to {S} "
         f"segments")
    x = torch.from_numpy(xp).to(dev)
    st_d = torch.from_numpy(starts).to(dev)
    ln_d = torch.from_numpy(seg_lens).to(dev)
    picks = _pick_segments(rows, hop, PACK_CHECKS)
    for name, family, cfg, (dct, proj), ref_fn, ref_tol, counter in \
            _packed_families():
        _reset_counts(modules.values())
        feat, f0, fc, mask = mfcc_model.mfcc_batch_packed(x, st_d, ln_d, cfg,
                                                          family=family)
        torch.cuda.synchronize()
        counts = _spectral_counts(modules)
        _log(f"[10 packed corpus] {name}: mfcc_batch_packed on {len(rows)} "
             f"rows launched {counts}")
        assert counts[counter] == 1 and sum(
            v for k, v in counts.items() if "/" not in k) == 1, \
            f"packed {name} did not launch {counter} once, alone"
        assert bool(torch.isfinite(feat).all()) and \
            not bool(feat[~mask].any()), name
        f0, fc = f0.cpu().numpy(), fc.cpu().numpy()
        worst, worst_ref = 0.0, 0.0
        for b, j, uid, off, n in picks:
            got = feat[b, f0[b, j]: f0[b, j] + fc[b, j]]
            alone = _standalone(torch, family, torch.from_numpy(
                utts[uid][None]).to(dev), cfg)
            err, margin = _compare(torch, dev, got[None], alone[None], cfg,
                                   dct, None, proj)
            g = got.cpu().numpy()
            ref = ref_fn(utts[uid].astype(np.float64), cfg)
            err_ref = (_window_err(g, ref) if ref_tol is None
                       else float(np.abs(g - ref).max()))
            _log(f"[10 packed corpus] {name}: row {b} slot {j} (frame "
                 f"{off // hop}, {'odd' if (off // hop) % 2 else 'even'}, "
                 f"{fc[b, j]} frames) vs standalone {err:.3e} (margin "
                 f"{margin:.3e}); vs the float64 oracle {err_ref:.3e}")
            assert margin >= 0, (name, b, j, err)
            assert err_ref <= (SPEC_TOL if ref_tol is None else ref_tol), \
                (name, b, j, err_ref)
            worst, worst_ref = max(worst, err), max(worst_ref, err_ref)
        _log(f"[10 packed corpus] {name}: {len(picks)} segments within their "
             f"bounds (worst {worst:.3e} off standalone, {worst_ref:.3e} off "
             f"the oracle)")
    # packed against padded, MFCC-13: batches of PACK_BATCH rows
    cfg = FeatureConfig()
    packed_calls = [(x[i: i + PACK_BATCH], st_d[i: i + PACK_BATCH],
                     ln_d[i: i + PACK_BATCH])
                    for i in range(0, len(rows), PACK_BATCH)]
    padded_calls, padded_samples = [], 0
    for i in range(0, PACK_UTTERANCES, PACK_BATCH):
        ids = range(i, min(i + PACK_BATCH, PACK_UTTERANCES))
        width = int(max(lens[k] for k in ids))
        xb = np.zeros((len(ids), width), np.float32)
        for r, k in enumerate(ids):
            xb[r, : lens[k]] = utts[k]
        padded_calls.append((torch.from_numpy(xb).to(dev),
                             torch.from_numpy(lens[list(ids)]).to(dev)))
        padded_samples += xb.size
    runs = {
        "packed": lambda: [mfcc_model.mfcc_batch_packed(a, s, n, cfg)
                           for a, s, n in packed_calls],
        "padded": lambda: [mfcc_model.mfcc_batch(a, n, cfg)
                           for a, n in padded_calls]}
    launches = {}
    for k, fn in runs.items():
        _reset_counts(modules.values())
        fn()
        torch.cuda.synchronize()
        launches[k] = modules["fused_raw_dit"].LAUNCHES
    times = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):
        for k in order:
            times[k] += _time_ms(torch, runs[k], warmup=1, calls=PACK_TIMING,
                                 group=1)
    fill = {"packed": real / xp.size, "padded": real / padded_samples}
    ms = {k: statistics.median(v) for k, v in times.items()}
    for k in runs:
        _log(f"[10 packed corpus] {k}: {ms[k]:.4f} ms per corpus pass "
             f"({launches[k]} fused_raw_dit launches, median of "
             f"{len(times[k])}), fill {fill[k]:.4f}, "
             f"{real / sr / (ms[k] / 1e3):,.0f} audio-sec/s ({smi})")
    _log(f"[10 packed corpus] packed / padded time "
         f"{ms['packed'] / ms['padded']:.3f}, samples computed "
         f"{xp.size / padded_samples:.3f} ({smi})")
    # what a call costs the host: a pass is host-bound where it exceeds the
    # device's share of the pass
    for k, call in (("packed", lambda: mfcc_model.mfcc_batch_packed(
            *packed_calls[0], cfg)),
                    ("padded", lambda: mfcc_model.mfcc_batch(
                        *padded_calls[0], cfg))):
        n_ops, host_ms = _ops_and_host_ms(torch, call)
        _log(f"[10 packed corpus] {k}: one call of {PACK_BATCH} rows, "
             f"{n_ops} ATen ops, host enqueue {host_ms:.4f} ms ({smi})")


def _dither_phase(torch, dev, bench) -> None:
    """Phase 11: the hash's bits on the card, dithered MFCC-13 on the bench
    batch against the dithered oracle, a silent row off the log floor."""
    from mfcc_tpu_torch import FeatureConfig, oracle
    from mfcc_tpu_torch.models import mfcc as mfcc_model
    from mfcc_tpu_torch.ops import dither
    from mfcc_tpu_torch.ops.kernels import fused_raw_dit
    n = 1 << 20
    for seed, start in ((0, 0), (7, 2**32 - n // 2)):
        h1, h2 = dither.bits(seed, start, n, device=dev)
        w1, w2 = dither.bits_np(seed, start, n)
        bad = int((h1.cpu() != torch.from_numpy(w1.astype(np.int64))).sum()
                  + (h2.cpu() != torch.from_numpy(w2.astype(np.int64))).sum())
        z = dither.noise(seed, start, n, device=dev).cpu().double().numpy()
        zn = dither.noise_np(seed, start, n)
        rel = float((np.abs(z - zn) / np.maximum(np.abs(zn), 1.0)).max())
        _log(f"[11 dither] seed {seed}, samples [{start}, {start + n}) on the "
             f"card: {bad} of {2 * n} hash words differ from the uint32 "
             f"reference; noise vs float64 noise_np {rel:.3e} relative")
        assert bad == 0 and rel <= 1e-6, (seed, bad, rel)
    cfg = FeatureConfig(dither=dither.KALDI_ONE_LSB)
    B, N = bench.shape
    _reset_counts([fused_raw_dit])
    feat, _, _ = mfcc_model.mfcc_batch(
        torch.from_numpy(bench).to(dev),
        torch.full((B,), N, dtype=torch.int32, device=dev), cfg)
    torch.cuda.synchronize()
    launches = fused_raw_dit.LAUNCHES
    f = feat.cpu().numpy()
    err = max(float(np.abs(f[i] - oracle.mfcc(bench[i].astype(np.float64),
                                              cfg)).max()) for i in range(B))
    _log(f"[11 dither] mfcc_batch at dither 1/32768 on the {B} x "
         f"{N / cfg.sample_rate:g} s bench batch: {launches} fused_raw_dit "
         f"launch(es); vs the dithered float64 oracle {err:.3e} (bound "
         f"{ORACLE_TOL:g})")
    assert launches == 1 and err <= ORACLE_TOL, (launches, err)
    zero = torch.zeros((2, cfg.sample_rate), device=dev)
    nz = torch.full((2,), cfg.sample_rate, device=dev)
    plain = mfcc_model.mfcc_batch(zero, nz, cfg.replace(dither=0.0))[0]
    dith = mfcc_model.mfcc_batch(zero, nz, cfg)[0]
    c0, d0 = plain[0, :, 0].cpu().numpy(), dith[0, :, 0].cpu().numpy()
    zerr = float(np.abs(dith[0].cpu().numpy()
                        - oracle.mfcc(np.zeros(cfg.sample_rate), cfg)).max())
    _log(f"[11 dither] all-zero row: c0 spread {np.ptp(c0):.3e} undithered "
         f"(the log floor), {np.ptp(d0):.3e} dithered (range {d0.min():.3f} "
         f"to {d0.max():.3f}); vs the oracle {zerr:.3e}")
    assert np.ptp(c0) == 0.0 and np.ptp(d0) > 0.0 and zerr <= ORACLE_TOL


def _near(a: np.ndarray, thr: float, context: int) -> np.ndarray:
    """Frames within 1e-4 of a VAD threshold, widened by the vote window
    (there the float32 and float64 means may decide differently)."""
    near = np.abs(a - thr) <= 1e-4 * max(1.0, abs(thr))
    if context:
        near = np.convolve(near, np.ones(2 * context + 1), "same") > 0
    return near


def _post_phase(torch, dev, bench, smi) -> None:
    """Phase 12: the post chain and corpus CMVN on the bench batch's kernel
    features, each against its float64 oracle twin, and timed."""
    from mfcc_tpu_torch import FeatureConfig, oracle
    from mfcc_tpu_torch.models import mfcc as mfcc_model
    from mfcc_tpu_torch.ops import post
    from mfcc_tpu_torch.parallel import cmvn
    cfg = FeatureConfig(append_energy=True)
    B, N = bench.shape
    rng = np.random.default_rng(12)
    lens = rng.integers(N // 5, N + 1, B).astype(np.int32)
    lens[0] = N
    audio = bench.copy()
    for i, n in enumerate(lens):
        audio[i, n:] = 0.0
    feat, flens, mask = mfcc_model.mfcc_batch(
        torch.from_numpy(audio).to(dev), torch.from_numpy(lens).to(dev), cfg)
    fl = flens.cpu().numpy()
    rows = [feat[i, : fl[i]].cpu().double().numpy() for i in range(B)]
    ops = {
        "sliding_cmvn": (lambda: post.sliding_cmvn(feat, flens, POST_WINDOW,
                                                   True),
                         lambda r: oracle.sliding_cmvn(r, POST_WINDOW, True),
                         POST_VAR_TOL),
        "online_cmvn": (lambda: post.online_cmvn(feat, flens, POST_WINDOW,
                                                 True),
                        lambda r: oracle.online_cmvn(r, POST_WINDOW, True),
                        POST_VAR_TOL),
        "splice": (lambda: post.splice(feat, flens, 3, 3),
                   lambda r: oracle.splice(r, 3, 3), 0.0),
    }
    for name, (fn, ref_fn, tol) in ops.items():
        got = fn().cpu().numpy()
        err = max(float(np.abs(got[i, : fl[i]] - ref_fn(rows[i])).max())
                  for i in range(POST_CHECKS))
        pad = not got[~mask.cpu().numpy()].any()
        _log(f"[12 post chain] {name} on ({B}, {feat.shape[1]}, "
             f"{feat.shape[2]}) kernel features: rows 0-{POST_CHECKS - 1} vs "
             f"the float64 oracle {err:.3e} (bound {tol:g}); padded frames "
             f"zero {pad}")
        assert err <= tol and pad, (name, err)
    for ctx in (0, 3):
        got = post.energy_vad(feat[..., 0], flens, context=ctx).cpu().numpy()
        flips = near = 0
        for i in range(POST_CHECKS):
            le = rows[i][:, 0]
            want = oracle.energy_vad(le, context=ctx)
            ok = _near(le, 0.5 * le.mean(), ctx)
            near += int(ok.sum())
            flips += int((got[i, : fl[i]] != want)[~ok].sum())
            assert not got[i, fl[i]:].any()
        _log(f"[12 post chain] energy_vad (c0 log energy, context {ctx}): "
             f"rows 0-{POST_CHECKS - 1}, {flips} decisions differ from the "
             f"oracle's away from the threshold ({near} frames within 1e-4 "
             f"of it)")
        assert flips == 0, (ctx, flips)
    # corpus CMVN: float32 statistics on the card, float64 on the host
    stats = cmvn.batch_stats(feat, mask)
    host = cmvn.host_batch_stats(feat, flens)
    count, s, sq = oracle.cmvn_stats(rows)
    scale = sum(np.abs(r).sum(axis=0) for r in rows)
    dev_err = max(float((np.abs(stats.sum.cpu().double().numpy() - s)
                         / scale).max()),
                  float((np.abs(stats.sumsq.cpu().double().numpy() - sq)
                         / sq).max()))
    host_err = max(float((np.abs(host.sum.numpy() - s) / scale).max()),
                   float((np.abs(host.sumsq.numpy() - sq) / sq).max()))
    _log(f"[12 post chain] cmvn.batch_stats (float32, card) vs "
         f"oracle.cmvn_stats {dev_err:.3e} relative, host_batch_stats "
         f"(float64) {host_err:.3e}; count {int(stats.count)} = "
         f"{int(host.count)} = {count}")
    assert int(stats.count) == int(host.count) == count
    assert dev_err <= 1e-5 and host_err <= 1e-12, (dev_err, host_err)
    errs = {}
    for name, st in (("float32 card statistics", stats),
                     ("float64 host statistics", host)):
        normed = cmvn.apply(feat, st).cpu().numpy()
        errs[name] = max(float(np.abs(normed[i, : fl[i]] - oracle.apply_cmvn(
            rows[i], count, s, sq)).max()) for i in range(B))
        _log(f"[12 post chain] cmvn.apply with the {name} vs "
             f"oracle.apply_cmvn, all {B} rows: {errs[name]:.3e}")
    assert errs["float64 host statistics"] <= ORACLE_TOL, errs
    assert errs["float32 card statistics"] <= CMVN_F32_TOL, errs
    runs = {
        **{k: v[0] for k, v in ops.items()},
        "energy_vad": lambda: post.energy_vad(feat[..., 0], flens, context=3),
        "cmvn.batch_stats": lambda: cmvn.batch_stats(feat, mask),
        "cmvn.apply": lambda: cmvn.apply(feat, host),
        "cmvn.host_batch_stats": lambda: cmvn.host_batch_stats(feat, flens)}
    for k, fn in runs.items():
        ms = statistics.median(_time_ms(torch, fn, calls=TIMING_CALLS))
        _log(f"[12 post chain] {k}: {ms:.4f} ms per ({B}, {feat.shape[1]}, "
             f"{feat.shape[2]}) batch ({smi})")


def _streaming_phase(torch, dev, bench, smi) -> None:
    """Phase 13: STREAM sessions of the bench signal, K chunks a dispatch,
    through the fused serving path (all four variants) against the scan
    path and the oracle; online_cmvn_step against online_cmvn; one dispatch
    timed with its ATen ops and host enqueue."""
    from mfcc_tpu_torch import FeatureConfig, oracle
    from mfcc_tpu_torch.models import streaming
    from mfcc_tpu_torch.ops import post
    modules = {k: m for k, (m, _, _) in _spectral_wrappers().items()}
    cf, K, D = STREAM_CHUNK_FRAMES, STREAM_K, STREAM_DISPATCHES
    base = FeatureConfig()
    B = bench.shape[0]
    C = cf * base.hop_len
    need = D * K * C
    assert bench.shape[1] >= need, (bench.shape, need)
    sig = np.ascontiguousarray(bench[:, :need])
    chunks = [torch.from_numpy(sig[:, d * K * C:(d + 1) * K * C]
                               .reshape(B, K, C)).to(dev) for d in range(D)]
    variants = {"mfcc": (base, oracle.mfcc, ORACLE_TOL),
                "logmel": (base.replace(dynamic_range_db=50.0),
                           oracle.log_mel, ORACLE_TOL),
                "plp": (base, oracle.plp, ORACLE_TOL),
                "spec": (base, oracle.log_spectrogram, None)}
    _log(f"[13 streaming] {B} sessions of the bench signal, chunk_frames "
         f"{cf}, K = {K} chunks a dispatch, {D} dispatches: {need} samples a "
         f"session")
    emitted = {}
    for v, (cfg, ref_fn, ref_tol) in variants.items():
        st_f = streaming.init_state_batch(B, cfg, device=dev)
        st_s = streaming.init_state_batch(B, cfg, device=dev)
        outs, worst = [[] for _ in range(B)], 0.0
        launches = {}
        for d in range(D):
            _reset_counts(modules.values())
            st_f, ff, n_new = streaming.process_chunks_batch_fused(
                st_f, chunks[d], cfg, v)
            torch.cuda.synchronize()
            for k, n in _spectral_counts(modules).items():
                launches[k] = launches.get(k, 0) + n
            st_s, fs, nvs = streaming.process_chunks_batch(st_s, chunks[d],
                                                           cfg, v)
            nn, nv = n_new.cpu().numpy(), nvs.cpu().numpy()
            ff, fs = ff.cpu().numpy(), fs.cpu().numpy()
            for b in range(B):
                want = np.concatenate([fs[b, k, : nv[b, k]] for k in range(K)])
                assert nn[b] == want.shape[0]
                assert not ff[b, nn[b]:].any()
                got = ff[b, : nn[b]]
                worst = max(worst, _window_err(got, want) if v == "spec"
                            else float(np.abs(got - want).max()))
                outs[b].append(ff[b, : nn[b]])
        proj = {"plp": "bark", "spec": "spec"}.get(v, "mel")
        _log(f"[13 streaming] {v}: process_chunks_batch_fused launched "
             f"{launches} over {D} dispatches")
        assert launches[f"fused_raw_dit/{proj}"] == D and sum(
            n for k, n in launches.items() if "/" not in k) == D, v
        assert torch.equal(st_f.carry, st_s.carry) and torch.equal(
            st_f.frames_done, st_s.frames_done), v
        got = [np.concatenate(o) for o in outs]
        emitted[v] = outs
        ref_errs, all_bins = [], []
        for b in range(STREAM_ORACLE_ROWS):
            ref = ref_fn(sig[b].astype(np.float64), cfg)
            assert got[b].shape == ref.shape, (v, got[b].shape, ref.shape)
            ref_errs.append(_window_err(got[b], ref) if ref_tol is None
                            else float(np.abs(got[b] - ref).max()))
            all_bins.append(float(np.abs(got[b] - ref).max()))
        bound = SPEC_TOL if v == "spec" else STREAM_FUSED_TOL
        _log(f"[13 streaming] {v}: fused vs scan path {worst:.3e} (bound "
             f"{bound:g}{', 50 dB window' if v == 'spec' else ''}); sessions "
             f"0-{STREAM_ORACLE_ROWS - 1} ({got[0].shape[0]} frames) vs the "
             f"float64 oracle {max(ref_errs):.3e} (every bin "
             f"{max(all_bins):.3e})")
        assert worst <= bound, (v, worst)
        assert max(ref_errs) <= (SPEC_TOL if ref_tol is None else ref_tol), \
            (v, ref_errs)
    # the streaming online CMVN step against the batch op, on the fused
    # mfcc stream as each dispatch emitted it, on the card and on the CPU:
    # within STREAM_CMVN_TOL of each other, with or without the variance,
    # and within POST_VAR_TOL of the float64 oracle
    W, F = STREAM_CMVN_WINDOW, base.n_mfcc
    for nv in (False, True):
        errs = {}
        for where in (dev, torch.device("cpu")):
            err = err_step = err_batch = 0.0
            for b in range(STREAM_ORACLE_ROWS):
                cst = streaming.init_online_cmvn(W, F, device=where)
                parts = []
                for rows in emitted["mfcc"][b]:
                    slots = np.zeros((K * cf, F), np.float32)
                    slots[: len(rows)] = rows
                    cst, out = streaming.online_cmvn_step(
                        cst, torch.from_numpy(slots).to(where), len(rows),
                        W, nv)
                    parts.append(out[: len(rows)].cpu().numpy())
                feats = np.concatenate(emitted["mfcc"][b])
                step = np.concatenate(parts)
                whole = torch.from_numpy(feats)[None].to(where)
                batch = post.online_cmvn(whole, torch.tensor(
                    [whole.shape[1]], device=where), W, nv)[0].cpu().numpy()
                ref = oracle.online_cmvn(feats.astype(np.float64), W, nv)
                err = max(err, float(np.abs(step - batch).max()))
                err_step = max(err_step, float(np.abs(step - ref).max()))
                err_batch = max(err_batch, float(np.abs(batch - ref).max()))
            errs[where.type] = (err, err_step, err_batch)
            _log(f"[13 streaming] online_cmvn_step (window {W}, "
                 f"{'variance' if nv else 'mean only'}) over the fused mfcc "
                 f"stream of sessions 0-{STREAM_ORACLE_ROWS - 1}, one step a "
                 f"dispatch, on the {where.type}: vs the batch online_cmvn "
                 f"{err:.3e}; vs the float64 oracle {err_step:.3e} (the batch "
                 f"op {err_batch:.3e})")
        for err, err_step, err_batch in errs.values():
            assert err <= STREAM_CMVN_TOL, errs
            assert max(err_step, err_batch) <= POST_VAR_TOL, errs
    # the window sums behind them: float32 running sums (torch.cumsum of
    # float32 on each device) against float64 ones, on session 0's shifted
    # squares; ops/post and online_cmvn_step take float64 prefix sums
    sq = np.concatenate(emitted["mfcc"][0])
    sq = (sq - sq[0]) ** 2
    w = min(W, len(sq) - 1)
    want = np.cumsum(sq.astype(np.float64), axis=0)
    want = want[w:] - want[:-w]
    for where in (dev, torch.device("cpu")):
        cs = torch.cumsum(torch.from_numpy(sq).to(where), dim=0).cpu()
        got = (cs[w:] - cs[:-w]).double().numpy()
        _log(f"[13 streaming] window-{w} sums of squares from float32 "
             f"torch.cumsum on the {where.type}: {np.abs(got - want).max():.3e}"
             f" off float64 (relative {np.abs(got / want - 1).max():.3e})")
    # one dispatch, timed: the fused path's four variants and the scan path
    st0 = {v: streaming.init_state_batch(B, c, device=dev)
           for v, (c, _, _) in variants.items()}
    runs = {f"fused {v}": functools.partial(
        streaming.process_chunks_batch_fused, st0[v], chunks[0], c, v)
        for v, (c, _, _) in variants.items()}
    runs["scan mfcc"] = functools.partial(streaming.process_chunks_batch,
                                          st0["mfcc"], chunks[0], base)
    audio_s = B * K * C / base.sample_rate
    for k, fn in runs.items():
        ms = statistics.median(_time_ms(torch, fn, calls=TIMING_CALLS))
        n_ops, host_ms = _ops_and_host_ms(torch, fn)
        _log(f"[13 streaming] {k}: {ms:.4f} ms a dispatch of {B} x {K} "
             f"chunks ({audio_s:g} s of audio) = {audio_s / (ms / 1e3):,.0f}"
             f" audio-sec/s; {n_ops} ATen ops, host enqueue {host_ms:.4f} ms "
             f"a dispatch ({smi})")



def _write_runner_corpus(d: str, n: int, lo: float, hi: float,
                         sr: int) -> list:
    """n WAVs of phase 10's signal, lengths uniform in [lo, hi] s (numpy
    seed 0), written in blocks of 64 -> [(path, n_samples)] in path
    order."""
    from mfcc_tpu_torch.utils import wav
    lens = np.random.default_rng(0).integers(int(lo * sr), int(hi * sr) + 1,
                                             n)
    noise = np.random.default_rng(0)
    N = int(hi * sr)
    t = np.arange(N) / sr
    base = (0.3 * np.sin(2 * np.pi * 180 * t)
            + 0.1 * np.sin(2 * np.pi * 1200 * t)).astype(np.float32)
    out = []
    for i0 in range(0, n, 64):
        rows = base + 0.02 * noise.standard_normal(
            (min(64, n - i0), N)).astype(np.float32)
        for r, row in enumerate(rows):
            p = os.path.join(d, f"u{i0 + r:05d}.wav")
            wav.write_wav(p, row[: lens[i0 + r]], sr)
            out.append((p, int(lens[i0 + r])))
    return out


def _runner_counters():
    from mfcc_tpu_torch.ops.kernels import fused_nccf, fused_viterbi
    mods = {k: m for k, (m, _, _) in _spectral_wrappers().items()}
    mods.update(fused_nccf=fused_nccf, fused_viterbi=fused_viterbi)
    return mods


def _runner_cli(torch, argv: list) -> tuple:
    """One ``cli.main`` run in-process, every launch counter reset just
    before and read just after -> (exit code, launches, wall s, stdout)."""
    import contextlib
    import io
    from mfcc_tpu_torch import cli
    mods = _runner_counters()
    _reset_counts(mods.values())
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return rc, {k: m.LAUNCHES for k, m in mods.items()}, wall, buf.getvalue()


def _runner_batches(infos: list) -> list:
    """The runner's padded batches of these (path, n): its default bucket
    ladder, RUNNER_BATCH rows a batch, in its order."""
    from mfcc_tpu_torch.runner import RunnerOptions
    from mfcc_tpu_torch.utils import batch as batch_lib
    o = RunnerOptions()
    return list(batch_lib.make_path_batches(
        infos, RUNNER_BATCH, batch_lib.bucket_ladder(o.min_bucket,
                                                     o.max_bucket)))


def _pack_plan(corpus: list, cfg, seconds: float) -> tuple:
    """The runner's packed rows of these (path, n) -> (rows, capacity)."""
    from mfcc_tpu_torch.utils import batch as batch_lib
    hop, fl = cfg.hop_len, cfg.frame_len
    cap = max(int(round(seconds * cfg.sample_rate / hop)),
              -(-(fl + hop) // hop)) * hop
    return list(batch_lib.pack_rows_split(corpus, cap, hop, fl)), cap


def _direct_packed(torch, dev, cfg, rows, cap, uids, read) -> dict:
    """The utterances uids through a direct mfcc_batch_packed call on the
    packed rows that hold them, reassembled as the runner does."""
    from mfcc_tpu_torch.models import mfcc as mfcc_model
    from mfcc_tpu_torch.utils import batch as batch_lib
    mine = [r for r in rows if any(pc.uid in uids for pc in r.segments)]
    S = max(len(r.segments) for r in mine)
    x = np.zeros((len(mine), cap), np.float32)
    st = np.zeros((len(mine), S), np.int32)
    ln = np.zeros((len(mine), S), np.int32)
    for b, r in enumerate(mine):
        sig, s, n_, _ = batch_lib.pack_audio_split(r, read)
        x[b], st[b, : len(s)], ln[b, : len(n_)] = sig, s, n_
    feat, f0, fc, _ = mfcc_model.mfcc_batch_packed(
        *(torch.from_numpy(a).to(dev) for a in (x, st, ln)), cfg)
    feat, f0, fc = (t.cpu().numpy() for t in (feat, f0, fc))
    out = {u: np.zeros((cfg.num_frames(len(read(u))), cfg.n_mfcc),
                       np.float32) for u in uids}
    for b, r in enumerate(mine):
        for j, pc in enumerate(r.segments):
            if pc.uid in out:
                out[pc.uid][pc.frame_start: pc.frame_start + pc.n_frames] = \
                    feat[b, f0[b, j]: f0[b, j] + fc[b, j]]
    return out


def _direct_padded(torch, dev, model, infos: list, picks) -> dict:
    """The utterances infos[picks] through a direct call of ``model``
    (int16 rows, lengths) -> (feat, frame counts, ...) on the runner's own
    batches that hold them: the same rows, widths and batch size."""
    from mfcc_tpu_torch.utils import wav
    want = {infos[i][0]: i for i in picks}
    out = {}
    for pb in _runner_batches(infos):
        if not any(p in want for p in pb.paths):
            continue
        x16 = np.zeros((len(pb.paths), pb.bucket), np.int16)
        n = np.zeros(len(pb.paths), np.int32)
        for r, p in enumerate(pb.paths):
            if p is not None:
                row = _int16(wav.read_wav(p)[0])[: pb.bucket]
                x16[r, : len(row)], n[r] = row, len(row)
        feat, fl = (t.cpu().numpy() for t in model(
            torch.from_numpy(x16).to(dev), torch.from_numpy(n).to(dev))[:2])
        out.update({want[p]: feat[r, : fl[r]]
                    for r, p in enumerate(pb.paths) if p in want})
    return out


def _runner_corpus(root: str) -> tuple:
    """Phase 14's corpus, written under root (phase 16 reads it too) ->
    (its directory, [(path, n_samples)])."""
    sr = 16000
    lo, hi = RUNNER_SECONDS
    t0 = time.perf_counter()
    cdir = os.path.join(root, "corpus")
    os.makedirs(cdir)
    corpus = _write_runner_corpus(cdir, RUNNER_UTTERANCES, lo, hi, sr)
    lens = np.asarray([n for _, n in corpus])
    mb = sum(os.path.getsize(p) for p, _ in corpus) / 1e6
    _log(f"[14 corpus runner] {len(corpus)} utterances of {lo:g}-{hi:g} "
         f"s (numpy seed 0, phase 10's signal), {lens.sum() / sr:.1f} s "
         f"of audio, {mb:.1f} MB of PCM16 WAV written in "
         f"{time.perf_counter() - t0:.2f} s")
    return cdir, corpus


def _corpus_runner_phase(torch, dev, smi, root, cdir, corpus) -> str:
    """Phase 14: ``python -m mfcc_tpu_torch`` (``cli.main``, in-process)
    over one process's shard of a corpus: padded, packed, ark with global
    CMVN, log-mel-80 + deltas, pitch, a resume and a traced run; launches,
    the report's self-check, files against the oracle and a direct model
    call, the CMVN statistics against numpy, timings.  -> the path of run
    (c)'s cmvn.npz."""
    from mfcc_tpu_torch import FeatureConfig, oracle
    from mfcc_tpu_torch.models import mfcc as mfcc_model
    from mfcc_tpu_torch.models import logmel as logmel_model
    from mfcc_tpu_torch.utils import kaldi, wav
    device = "cuda" if dev.type == "cuda" else "cpu"
    lens = np.asarray([n for _, n in corpus])
    t0 = time.perf_counter()
    sub = os.path.join(root, "subset.txt")
    with open(sub, "w") as f:
        f.write("\n".join(p for p, _ in corpus[:RUNNER_SUBSET]) + "\n")
    trace_list = os.path.join(root, "trace.txt")
    with open(trace_list, "w") as f:
        f.write("\n".join(p for p, _ in corpus[:RUNNER_TRACE]) + "\n")
    cfg = FeatureConfig()
    lm = FeatureConfig(n_mels=80, n_mfcc=80, deltas=True)
    n_sub = min(RUNNER_SUBSET, len(corpus))
    rows, cap = _pack_plan(corpus, cfg, RUNNER_PACK_SECONDS)
    padded = {k: _runner_batches(corpus[:k])
              for k in (len(corpus), n_sub, min(RUNNER_TRACE, len(corpus)))}
    packed_batches = -(-len(rows) // RUNNER_BATCH)
    padded_samples = sum(len(pb.paths) * pb.bucket
                         for pb in padded[len(corpus)])
    none = dict.fromkeys(_runner_counters(), 0)
    runs = [  # name, input, args, cfg, launches expected
        ("a mfcc npy", cdir, [], cfg,
         {**none, "fused_raw_dit": len(padded[len(corpus)])}),
        ("b mfcc --pack", cdir, ["--pack", "--pack-seconds",
                                 RUNNER_PACK_SECONDS], cfg,
         {**none, "fused_raw_dit": packed_batches}),
        ("c ark --cmvn", cdir, ["--format", "ark", "--cmvn"], cfg,
         {**none, "fused_raw_dit": len(padded[len(corpus)])}),
        ("d logmel-80 deltas", sub, ["--logmel", "--n-mels", 80,
                                     "--deltas"], lm,
         {**none, "fused_raw": len(padded[n_sub])}),
        ("e mfcc --pitch", sub, ["--pitch"], cfg,
         {**none, **dict.fromkeys(("fused_raw_dit", "fused_nccf",
                                   "fused_viterbi"), len(padded[n_sub]))}),
        ("f resume of a", cdir, [], cfg, none),
        ("g traced", trace_list, ["--trace-dir",
                                  os.path.join(root, "trace")], cfg,
         {**none, "fused_raw_dit": len(padded[min(RUNNER_TRACE,
                                                  len(corpus))])}),
    ]
    outs = {}
    rng = np.random.default_rng(1)
    for name, src, args, rcfg, want in runs:
        key = name[0]
        out = outs["a"] if key == "f" else os.path.join(root, key)
        outs[key] = out
        rc, launches, wall, _ = _runner_cli(torch, [
            src, "-o", out, "--batch-size", RUNNER_BATCH, "--device",
            device, *args])
        rep = json.load(open(os.path.join(out, "run_report.0.json")))
        st = rep["stage_seconds"]
        _log(f"[14 corpus runner] {name}: exit {rc}, "
             f"{rep['n_utterances']} utterances, "
             f"{rep['audio_seconds']:.1f} s of audio in {wall:.3f} s wall "
             f"({rep['wall_seconds']:.3f} s in the runner) = "
             f"{rep['audio_seconds_per_second']:,.0f} audio-sec/s; stages "
             + ", ".join(f"{k} {v:.3f} s" for k, v in st.items())
             + f"; launched {launches}; self-check max_abs_error "
             f"{rep['max_abs_error']}, pitch {rep['max_abs_error_pitch']}"
             f" ({smi})")
        assert launches == want, (name, launches, want)
        if key == "f":
            assert rc == 1 and rep["n_utterances"] == 0, name
            continue
        assert rc == 0, name
        n_run = len(corpus) if src == cdir else n_sub if src == sub \
            else min(RUNNER_TRACE, len(corpus))
        assert rep["n_utterances"] == n_run, (name, rep["n_utterances"])
        if key != "c":
            assert rep["max_abs_error"] <= ORACLE_TOL, name
        if key == "e":
            assert rep["max_abs_error_pitch"] <= PITCH_TOL[1], name
        if key == "b":
            _log(f"[14 corpus runner] b: {len(rows)} packed rows of "
                 f"{cap} samples, fill {lens.sum() / (len(rows) * cap):.4f}"
                 f"; the padded run's fill "
                 f"{lens.sum() / padded_samples:.4f} "
                 f"({len(padded[len(corpus)])} batches of {RUNNER_BATCH})")
        if key == "g":
            tr = json.load(open(os.path.join(root, "trace",
                                             "trace.0.json")))
            ev = tr["traceEvents"]
            names = [e.get("name", "") for e in ev]
            kern = [n for e, n in zip(ev, names)
                    if e.get("cat") == "kernel"]
            # the device's busy share of the traced span: its kernels
            # and copies (one stream) over the span of every event
            busy = sum(e.get("dur", 0) for e in ev
                       if e.get("cat") in ("kernel", "gpu_memcpy",
                                           "gpu_memset"))
            ts = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in ev
                  if "ts" in e and e.get("ph") == "X"]
            span = max(b for _, b in ts) - min(a for a, _ in ts)
            _log(f"[14 corpus runner] g: the Chrome trace holds "
                 f"{names.count('fused_raw_dit')} fused_raw_dit events "
                 f"and {len(kern)} device kernel events "
                 f"({sum('raw_dit' in n for n in kern)} of raw_dit_*); "
                 f"the device busy {busy / 1e3:.3f} ms (kernels and "
                 f"copies) of the traced {span / 1e3:.3f} ms, "
                 f"{100 * busy / max(span, 1):.2f} % ({smi})")
            assert "fused_raw_dit" in names, "the trace names no launch"
            assert device == "cpu" or any("raw_dit" in n for n in kern)
            continue
        # 8 utterances read back: the oracle, a direct model call
        picks = sorted(rng.choice(n_run, min(RUNNER_CHECKS, n_run),
                                  replace=False))
        if key == "c":
            back = kaldi.read_scp(os.path.join(out, "features.0.scp"))
        sigs = {i: wav.read_wav(corpus[i][0])[0] for i in picks}
        uid = lambda i: os.path.splitext(os.path.basename(corpus[i][0]))[0]
        got = {i: (back[uid(i)] if key == "c" else
                   np.load(os.path.join(out, uid(i) + ".npy")))
               for i in picks}
        if key == "c":
            z = np.load(os.path.join(out, "cmvn.npz"))
            pre = [np.load(os.path.join(outs["a"], uid(i) + ".npy"))
                   for i in range(len(corpus))]
            allf = np.concatenate(pre).astype(np.float64)
            assert float(z["count"]) == allf.shape[0], name
            np.testing.assert_allclose(z["sum"], allf.sum(0), rtol=1e-9)
            np.testing.assert_allclose(z["sumsq"], (allf * allf).sum(0),
                                       rtol=1e-9)
            mean = z["sum"] / allf.shape[0]
            inv = 1.0 / np.sqrt(np.maximum(z["sumsq"] / allf.shape[0]
                                           - mean * mean, 1e-8))
            errs = []
            for i in picks:
                want_n = oracle.apply_cmvn(oracle.mfcc(
                    sigs[i].astype(np.float64), cfg), z["count"],
                    z["sum"], z["sumsq"])
                # the 1e-4 feature contract through (x - mean) * inv_std
                errs.append(float((np.abs(got[i] - want_n) / inv).max()))
                np.testing.assert_allclose(
                    got[i], ((pre[i] - mean) * inv).astype(np.float32),
                    rtol=1e-6, atol=1e-6)
            _log(f"[14 corpus runner] c: cmvn.npz equals numpy's float64 "
                 f"statistics of run a's {len(pre)} files (count "
                 f"{int(allf.shape[0])}); {len(picks)} normalized "
                 f"utterances equal run a's normalized, and "
                 f"{max(errs):.3e} off the oracle before the scaling")
            assert max(errs) <= ORACLE_TOL, errs
            continue
        ref = {i: oracle.log_mel(sigs[i].astype(np.float64), rcfg)
               if key == "d" else oracle.mfcc(sigs[i].astype(np.float64),
                                              rcfg) for i in picks}
        if key == "b":
            direct = _direct_packed(
                torch, dev, cfg, rows, cap, {corpus[i][0] for i in picks},
                lambda p: wav.read_wav(p)[0])
            direct = {i: direct[corpus[i][0]] for i in picks}
        else:
            model = (
                (lambda x, n: _mfcc_plus_pitch(torch, x, n, cfg))
                if key == "e" else
                (lambda x, n: logmel_model.log_mel_batch(x, n, lm))
                if key == "d" else
                (lambda x, n: mfcc_model.mfcc_batch(x, n, cfg)))
            direct = _direct_padded(torch, dev, model, corpus[:n_run],
                                    picks)
        e_ref, e_dir = 0.0, 0.0
        for i in picks:
            g = got[i]
            assert g.shape == direct[i].shape, (name, i)
            if key == "e":
                pw = oracle.pitch(sigs[i].astype(np.float64),
                                  _pitch_for(cfg))
                idx = np.minimum(np.arange(g.shape[0]), pw.shape[0] - 1)
                e_ref = max(e_ref, *_columns_err(
                    g[:, -3:], pw[idx], PITCH_TOL))
                g = g[:, :-3]
                assert np.abs(g - ref[i]).max() <= ORACLE_TOL, (name, i)
            tol = LOGMEL_ORACLE_TOL if key == "d" else ORACLE_TOL
            e = float(np.abs(g - ref[i]).max())
            assert e <= tol, (name, i, e)
            e_ref = max(e_ref, e)
            gd = got[i] - direct[i]
            bound = (KERNEL_TOL + LOGMEL_RTOL * np.abs(direct[i])
                     if key == "d" else KERNEL_TOL)
            assert (np.abs(gd) <= bound).all(), (name, i)
            e_dir = max(e_dir, float(np.abs(gd).max()))
        _log(f"[14 corpus runner] {key}: {len(picks)} utterances read "
             f"back, {e_ref:.3e} off the oracle, {e_dir:.3e} off a direct "
             f"{'mfcc_batch_packed' if key == 'b' else 'model'} call")
    _log(f"[14 corpus runner] phase 14 passed in "
         f"{time.perf_counter() - t0:.1f} s ({smi})")
    return os.path.join(outs["c"], "cmvn.npz")


# ---- phases 15-16: online pitch, the training feed and the front end ----

def _online_stream(pitch_online, pcfg, x, delay, dev):
    """x fed in ONLINE_FEED-sample pieces, then flushed -> (rows, tracker)."""
    op = pitch_online.OnlinePitch(pcfg, delay=delay,
                                  chunk_frames=ONLINE_CHUNK, device=dev)
    rows = [op.feed(x[i: i + ONLINE_FEED])
            for i in range(0, x.size, ONLINE_FEED)]
    rows.append(op.flush())
    return np.concatenate(rows), op


def _online_pitch_phase(torch, dev, smi) -> None:
    """Phase 15: one stream of the bench signal through ``OnlinePitch`` at
    the default PitchConfig (16 kHz in, the streaming resampler to 4 kHz),
    fed in 100 ms pieces: ``fused_nccf`` launched once a chunk, the rows
    against the float64 twin ``online_pitch_np``; with delay >= T against
    ``pitch_batch``; the chunk NCCF kernel against the plain chunk NCCF on
    the card; ms a chunk and the real-time factor."""
    from mfcc_tpu_torch import PitchConfig
    from mfcc_tpu_torch.models import pitch as pitch_model, pitch_online
    from mfcc_tpu_torch.ops.kernels import fused_nccf
    from mfcc_tpu_torch.ops.resample import resample_poly_numpy
    pcfg = PitchConfig().validate()
    sr, F = pcfg.sample_rate, ONLINE_CHUNK
    x = _bench_audio(1, ONLINE_SECONDS, sr)[0]
    T = pcfg.num_frames(x.size)
    chunks = -(-T // F)
    _online_stream(pitch_online, pcfg, x[: sr], ONLINE_DELAY, dev)  # warm
    torch.cuda.synchronize()
    _reset_counts([fused_nccf])
    t0 = time.perf_counter()
    got, op = _online_stream(pitch_online, pcfg, x, ONLINE_DELAY, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_nccf.LAUNCHES
    _log(f"[15 online pitch] {ONLINE_SECONDS:g} s stream fed in "
         f"{ONLINE_FEED}-sample pieces, delay {ONLINE_DELAY}, chunk_frames "
         f"{F}: {got.shape[0]} rows of {T} frames in {op.chunks} chunks; "
         f"launched fused_nccf {launches} times ({smi})")
    assert got.shape == (T, 3), got.shape
    assert launches == op.chunks == chunks, (launches, op.chunks, chunks)
    t1 = time.perf_counter()
    want = pitch_online.online_pitch_np(x.astype(np.float64), pcfg,
                                        ONLINE_DELAY, F)
    errs = _columns_err(got, want, PITCH_TOL)
    _log(f"[15 online pitch] vs online_pitch_np (float64, "
         f"{time.perf_counter() - t1:.1f} s on the host): pov/norm/delta "
         f"{_fmt(errs)} (bounds {_fmt(PITCH_TOL)}) ({smi})")
    _log(f"[15 online pitch] the stream: {wall * 1e3:.1f} ms wall, "
         f"{wall * 1e3 / chunks:.3f} ms a chunk of {F} frames "
         f"({F * pcfg.hop_ms:g} ms of audio), real-time factor "
         f"{wall / ONLINE_SECONDS:.5f}, {ONLINE_SECONDS / wall:,.0f} "
         f"audio-sec/s ({smi})")
    # one chunk step alone (kernel, energies, Viterbi ops, the fetch)
    xw = resample_poly_numpy(x.astype(np.float64), sr,
                             pcfg.work_rate).astype(np.float32)
    span, hop = pitch_online.chunk_span(pcfg, F), pcfg.hop_len_w
    for backend in ("cuda", "torch"):
        buf = torch.from_numpy(xw[:span].copy()).to(dev)
        state = pitch_online.init_chunk_state(pcfg, dev)
        steps = []
        for i in range(ONLINE_STEP_CALLS + 3):
            t0 = time.perf_counter()
            state, back, nccf_p = pitch_online.online_chunk_step(
                state, buf, F, pcfg, F, backend=backend)
            back.cpu(), nccf_p.cpu(), state.cost.cpu()
            steps.append(time.perf_counter() - t0)
        ms = statistics.median(steps[3:]) * 1e3
        ops, host_ms = _ops_and_host_ms(
            torch, lambda: pitch_online.online_chunk_step(
                state, buf, F, pcfg, F, backend=backend))
        _log(f"[15 online pitch] online_chunk_step ({backend}), its fetch "
             f"included: {ms:.4f} ms median of {ONLINE_STEP_CALLS}; "
             f"{ops} ATen ops, host enqueue {host_ms:.4f} ms a step "
             f"({smi})")
    # the chunk NCCF kernel against the plain chunk NCCF, stationary
    # signal: an interior chunk and the stream's last, n_valid < F
    c_last = (chunks - 1) * F
    worst = 0.0
    for c0 in (chunks // 2 * F, c_last):
        nv = min(F, T - c0)
        buf = np.zeros((span,), np.float32)
        have = min(xw.size - c0 * hop, span)
        buf[:have] = xw[c0 * hop: c0 * hop + have]
        b = torch.from_numpy(buf).to(dev)
        e0 = pitch_online.chunk_energies(b, F, pcfg)[:nv]
        ball = (pcfg.ballast * e0.mean() ** 2).reshape(1)
        kb, kp = pitch_online.chunk_nccf(b, F, pcfg, ball, backend="cuda")
        pb, pp = pitch_online.chunk_nccf(b, F, pcfg, ball, backend="torch")
        err = max(float((kb - pb)[:nv].abs().max()),
                  float((kp - pp)[:nv].abs().max()))
        _log(f"[15 online pitch] chunk NCCF kernel vs plain, chunk at frame "
             f"{c0}, n_valid {nv} of {F}: {err:.3e} (bound {KERNEL_TOL:g}) "
             f"({smi})")
        assert err <= KERNEL_TOL, (c0, err)
        worst = max(worst, err)
    assert T - c_last < F, "the stream's last chunk must be partial"
    # delay >= T: every decision from the final cost, against pitch_batch
    full, _ = _online_stream(pitch_online, pcfg, x, T + 10, dev)
    batch = pitch_model.pitch_batch(
        torch.from_numpy(x[None]).to(dev),
        torch.tensor([x.size], device=dev), pcfg)[0][0].cpu().numpy()
    d = np.abs(full[:, 0] - batch[:, 0])
    same = float((d < 2e-4).mean())
    _log(f"[15 online pitch] delay {T + 10} >= T against pitch_batch: pov "
         f"within 2e-4 on {100 * same:.2f} % of {T} frames (the causal "
         f"ballast is the one difference), max {d.max():.3e} ({smi})")
    assert same >= 0.95, same


def _check_feed_batch(torch, dev, cfg, b) -> None:
    """One plain feature_batches batch against mfcc_batch on the same
    rows, decoded by the pure reader to int16 at the batch's bucket."""
    from mfcc_tpu_torch.models import mfcc as mfcc_model
    from mfcc_tpu_torch.utils import wav
    x = np.zeros((len(b.uids), b.bucket), np.int16)
    n = np.zeros(len(b.uids), np.int32)
    for r, uid in enumerate(b.uids):
        if uid is not None:
            row = _int16(wav.read_wav(uid)[0])
            x[r, : len(row)], n[r] = row, len(row)
    feat, fl, mask = mfcc_model.mfcc_batch(torch.from_numpy(x).to(dev),
                                           torch.from_numpy(n).to(dev), cfg)
    assert torch.equal(b.frame_counts, fl) and torch.equal(b.mask, mask)
    assert torch.equal(b.features, feat), "feed batch != mfcc_batch"


def _training_phase(torch, dev, bench, smi, cdir, corpus, cmvn_path) -> None:
    """Phase 16: ``dataset.feature_batches`` over phase 14's corpus, plain
    and with its cmvn.npz and SpecAugment; the masks of one seed on the CPU
    and the card; ``speed_perturb`` on the card against the CPU; the
    trainable front end on the bench batch, at init against the kernel's
    ``mfcc_batch`` and through a 200-step recovery."""
    from mfcc_tpu_torch import FeatureConfig, dataset
    from mfcc_tpu_torch.models import mfcc as mfcc_model, trainable
    from mfcc_tpu_torch.ops import augment
    cfg = FeatureConfig()
    mods = {k: m for k, (m, _, _) in _spectral_wrappers().items()}
    seconds = sum(n for _, n in corpus) / cfg.sample_rate
    runs = {}
    for name, kw in (("plain", {}),
                     ("cmvn + augment", dict(cmvn_stats=cmvn_path,
                                             augment_seed=0))):
        _reset_counts(mods.values())
        t0 = time.perf_counter()
        batches = list(dataset.feature_batches(
            cdir, cfg, batch_size=RUNNER_BATCH, device=dev, **kw))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: m.LAUNCHES for k, m in mods.items()}
        n_utt = sum(u is not None for b in batches for u in b.uids)
        _log(f"[16 training feed] feature_batches ({name}): {len(batches)} "
             f"batches, {n_utt} utterances, {seconds:.1f} s of audio in "
             f"{wall:.3f} s = {seconds / wall:,.0f} audio-sec/s; launched "
             f"{launches} ({smi})")
        assert n_utt == len(corpus), n_utt
        assert launches == {**dict.fromkeys(mods, 0),
                            "fused_raw_dit": len(batches)}, launches
        for b in batches:
            assert b.features.is_cuda == (dev.type == "cuda")
            assert not b.features[~b.mask].any(), "padding not zero"
        runs[name] = batches
    plain, aug = runs["plain"], runs["cmvn + augment"]
    for b in plain[:FEED_CHECKS] + plain[-1:]:
        _check_feed_batch(torch, dev, cfg, b)
    stats = dataset.load_cmvn_stats(cmvn_path)
    m, v = stats.mean_var()
    mean, inv = m.to(dev, torch.float32), (1.0 / torch.sqrt(v)).to(
        dev, torch.float32)
    hit = 0.0
    for bi, (p, a) in enumerate(zip(plain, aug)):
        B, T, F = p.features.shape
        normed = torch.where(p.mask[..., None], (p.features - mean) * inv, 0.0)
        nf = p.frame_counts.cpu()
        masks = augment.draw_masks(dataset.augment_generator(0, 0, bi),
                                   B, T, F, num_frames=nf)
        want = augment.apply_masks(normed, masks, num_frames=nf)
        assert torch.equal(a.features, want), bi
        hit += float((a.features != normed).sum()) / float(
            p.mask.sum() * F)
    _log(f"[16 training feed] {min(FEED_CHECKS, len(plain)) + 1} plain "
         f"batches equal mfcc_batch on the same rows bit for bit; every "
         f"augmented batch equals its plain batch normalized by cmvn.npz "
         f"with its seed's stripes (mean masked share "
         f"{hit / len(plain):.3f}), padding zero ({smi})")
    # one seed's masks on the CPU and on the card
    f_dev = plain[0].features
    nf = plain[0].frame_counts.cpu()
    on_card = augment.spec_augment(f_dev, dataset.augment_generator(1, 0, 0),
                                   num_frames=nf)
    on_cpu = augment.spec_augment(f_dev.cpu(),
                                  dataset.augment_generator(1, 0, 0),
                                  num_frames=nf)
    assert torch.equal(on_card.cpu(), on_cpu), "masks differ by device"
    _log(f"[16 training feed] spec_augment, one seed: the card's output "
         f"equals the CPU's bit for bit ({int((on_cpu == 0).sum())} zeros "
         f"of {on_cpu.numel()}) ({smi})")
    # speed perturbation on the bench batch
    B, N = bench.shape
    lens = torch.full((B,), N, dtype=torch.int32)
    x_dev = torch.from_numpy(bench).to(dev)
    for factor in (0.9, 1.1):
        y, yl = augment.speed_perturb(x_dev, lens.to(dev), factor)
        y_cpu, yl_cpu = augment.speed_perturb(torch.from_numpy(bench), lens,
                                              factor)
        err = float((y.cpu() - y_cpu).abs().max())
        ms = statistics.median(_time_ms(
            torch, lambda: augment.speed_perturb(x_dev, lens.to(dev),
                                                 factor),
            calls=TIMING_CALLS // 3))
        _log(f"[16 training feed] speed_perturb {factor:g} on {B} x "
             f"{N / cfg.sample_rate:g} s: {tuple(y.shape)}, card vs CPU "
             f"{err:.3e}, {ms:.4f} ms on the card ({smi})")
        assert torch.equal(yl.cpu(), yl_cpu) and err <= 1e-6, (factor, err)
    # the trainable front end on the bench batch
    params = trainable.init_params(cfg, dev)
    _reset_counts(mods.values())
    want = mfcc_model.mfcc_batch(x_dev, lens.to(dev), cfg)[0]
    assert mods["fused_raw_dit"].LAUNCHES == 1
    got = trainable.forward(params, x_dev, cfg).detach()
    err = float((got - want).abs().max())
    _log(f"[16 trainable] forward at init vs mfcc_batch through "
         f"fused_raw_dit on {B} x {N / cfg.sample_rate:g} s: {err:.3e} "
         f"(bound {KERNEL_TOL:g}) ({smi})")
    assert err <= KERNEL_TOL, err
    tgt = trainable.init_params(cfg, dev)
    with torch.no_grad():
        tgt.mel_w.mul_(1.5)
    target = trainable.forward(tgt, x_dev, cfg).detach()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, losses = trainable.fit(x_dev, target, cfg, steps=TRAIN_STEPS,
                                   lr=3e-3, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    opt = trainable.make_optimizer(params, 1e-6)
    step = lambda: trainable.train_step(params, opt, x_dev, target, cfg)
    step_ms = statistics.median(_time_ms(torch, step,
                                         calls=TIMING_CALLS // 3))
    ops, host_ms = _ops_and_host_ms(torch, step)
    _log(f"[16 trainable] fit, {TRAIN_STEPS} steps at lr 3e-3 recovering a "
         f"1.5x filterbank: loss {losses[0]:.5f} -> {losses[-1]:.5f} "
         f"({losses[-1] / losses[0]:.4f} of the first); {wall * 1e3:.1f} ms "
         f"wall, {wall * 1e3 / TRAIN_STEPS:.3f} ms a step; train_step "
         f"{step_ms:.4f} ms between CUDA events, {ops} ATen ops, host "
         f"enqueue {host_ms:.4f} ms a step ({smi})")
    assert losses[-1] < 0.1 * losses[0], losses[::50]
    assert torch.isfinite(params.mel_w).all()


# ---- phase 17: the distributed step ----

def _distributed_phase(torch, dev, smi) -> None:
    """Phase 17: ``parallel/dryrun`` in DRYRUN_RANKS gloo processes, every
    one on this card: MFCC + CMVN and the training step at the default
    config on the BATCH x SECONDS bench batch, the other models at the
    reference's tiny sizes, each rank asserting its bounds; here each
    rank's launches, the errors against one process, and rank 0's
    collective and step times."""
    from mfcc_tpu_torch.parallel import dryrun
    t0 = time.perf_counter()
    res = dryrun.dryrun_multichip(DRYRUN_RANKS, device=dev.type,
                                  config="default", batch=BATCH,
                                  seconds=SECONDS)
    wall = time.perf_counter() - t0
    m, (B, T, F) = res["mesh"], res["feat_shape"]
    cols = 26 // m["tp"]
    _log(f"[17 distributed step] dryrun_multichip({DRYRUN_RANKS}): mesh dp "
         f"{m['dp']} x sp {m['sp']} x tp {m['tp']}, {DRYRUN_RANKS} gloo "
         f"processes on {res['device']}, each {B // m['dp']} rows x "
         f"{T // m['sp']} frames of the {B} x {SECONDS:g} s batch and "
         f"{cols} of 26 filterbank columns; {wall:.1f} s in all")
    _log(f"[17 distributed step] rank 0: {res['summary']}")
    _log(f"[17 distributed step] sharded vs one process on the whole batch:"
         f" raw {res['raw_err']:.3e} (bound {dryrun.RAW_TOL:g}), CMVN "
         f"{res['cmvn_err']:.3e} (bound {dryrun.CMVN_TOL:g}), kernel route "
         f"{res['kernel_err']:.3e}, packed {res['packed_err']:.3e} (bounds "
         f"{dryrun.KERNEL_TOL:g}); training step loss {res['loss']:.5f}, "
         f"{res['loss_rel_err']:.3e} relative (bound {dryrun.LOSS_RTOL:g}), "
         f"clipped gradients {res['grad_rel_err']:.3e} of their largest "
         f"(bound {dryrun.GRAD_TOL:g}), parameters after the step "
         f"{res['adam_bound_ratio']:.3f} of Adam's first-step bound")
    assert res["raw_err"] < dryrun.RAW_TOL and \
        res["cmvn_err"] < dryrun.CMVN_TOL, res
    assert res["loss_rel_err"] <= dryrun.LOSS_RTOL and \
        res["grad_rel_err"] <= dryrun.GRAD_TOL and \
        res["adam_bound_ratio"] <= 1.0, res
    main = [r["mfcc"]["fused_raw_dit"] for r in res["launches"]]
    steps = {k: {n: v for n, v in c.items() if v}
             for k, c in res["launches"][0].items()}
    _log(f"[17 distributed step] fused_raw_dit launches of the MFCC step by "
         f"rank (counters reset just before, read just after): {main}; "
         f"rank 0's launches by step: {steps}")
    if dev.type == "cuda":
        assert main == [1] * DRYRUN_RANKS, main
    ms = res["ms"]
    _log(f"[17 distributed step] rank 0, "
         f"{'CUDA events' if dev.type == 'cuda' else 'host clock'}, "
         f"{dryrun.TIMED} calls each with {DRYRUN_RANKS} processes sharing "
         f"the card: batch_stats_psum (the shard's sums, then count + 2 x "
         f"{F} float64 all-reduced over data x time) "
         f"{ms['stats_all_reduce']:.4f} ms (the same on host copies of the "
         f"shard, host clock, {ms['stats_all_reduce_host']:.4f} ms); feat "
         f"all-gather of "
         f"({B // m['dp']}, {T // m['sp']}, {cols}) float32 log-mel "
         f"{ms['feat_all_gather']:.4f} ms; training step sharded "
         f"{ms['train_step_sharded']:.4f} ms, one process on the whole batch"
         f" (the others idle) {ms['train_step_one_process']:.4f} ms ({smi})")


# ---- phases 18-19: the precision modes; the pitch post stages ----

def _precision_families(torch, dev, smi) -> None:
    """Phase 18, the families: each setting of ``PRECISION_SETTINGS``
    through each family's batch entry on the bench batch, on its route
    ("auto") and on the plain route ("torch")."""
    from mfcc_tpu_torch import FeatureConfig, backend, oracle
    from mfcc_tpu_torch.models import logmel as logmel_model
    from mfcc_tpu_torch.models import mfcc as mfcc_model, plp as plp_model
    modules = {k: m for k, (m, _, _) in _spectral_wrappers().items()}
    bench = _bench_audio(BATCH, SECONDS, 16000)
    B, N = bench.shape
    lens = np.maximum(N - np.arange(B) * (N // (B + 6)), 0).astype(np.int32)
    lens[-2:] = (400, 399)                   # 1 frame, 0 frames
    audio = bench.copy()
    for i, n in enumerate(lens):
        audio[i, n:] = 0.0
    x16 = _int16(audio)
    xf = x16.astype(np.float64) / 32768.0
    xd, ld = torch.from_numpy(x16).to(dev), torch.from_numpy(lens).to(dev)
    rows = sorted({0, B // 2, max(B - 2, 0)})[:PRECISION_ROWS]
    families = {
        "mfcc_batch": (mfcc_model.mfcc_batch, FeatureConfig(), oracle.mfcc),
        "log_mel_batch": (logmel_model.log_mel_batch,
                          FeatureConfig(n_mels=80, n_mfcc=80), oracle.log_mel),
        "plp_batch": (plp_model.plp_batch, FeatureConfig(), oracle.plp)}
    xc = torch.from_numpy(x16[rows])
    lc = torch.from_numpy(lens[rows])
    for fam, (entry, base, ref_fn) in families.items():
        base = base.validate()
        refs = {i: ref_fn(xf[i, : lens[i]], base) for i in rows}
        out = {}
        for name, kw in PRECISION_SETTINGS.items():
            cfg = base.replace(**kw)
            for route in ("auto", "torch"):
                flags = backend.matmul_flags()
                _reset_counts(modules.values())
                feat = entry(xd, ld, cfg, route)[0]
                torch.cuda.synchronize()
                ran = {k: m.LAUNCHES for k, m in modules.items() if m.LAUNCHES}
                assert backend.matmul_flags() == flags, (fam, name, route)
                f = feat.cpu().numpy()
                assert np.isfinite(f).all(), (fam, name, route)
                err = np.concatenate([
                    np.abs(f[i, : refs[i].shape[0]] - refs[i]).ravel()
                    for i in rows])
                ms = statistics.median(_time_ms(
                    torch, lambda: entry(xd, ld, cfg, route), warmup=1,
                    calls=PRECISION_CALLS))
                out[name, route] = (feat, ran, float(err.max()),
                                    float(err.mean()), ms)
                _log(f"[18 precision modes] {fam} {name} {route}: launched "
                     f"{ran or 'no spectral kernel (plain chain)'}; vs the "
                     f"float64 oracle on rows {rows} max {err.max():.3e} "
                     f"mean {err.mean():.3e}; {ms:.4f} ms a {B} x "
                     f"{N / 16000:g} s batch ({smi})")
        kernel = out["highest", "auto"][1]
        floor = out["highest", "torch"][2]
        assert len(kernel) == 1 and sum(kernel.values()) == 1, kernel
        assert out["high", "auto"][1] == {}, "'high' launched a kernel"
        # "high" is IEEE fp32 on the card: the "highest" plain chain
        assert torch.equal(out["high", "auto"][0], out["high", "torch"][0])
        assert torch.equal(out["high", "auto"][0], out["highest", "torch"][0])
        for name in ("default", "bf16"):
            assert out[name, "auto"][1] == kernel, (fam, name)
        # the kernels read neither field; PLP's tail after the kernel is
        # plain PyTorch, as in the reference, and its products follow the
        # mode
        assert torch.equal(out["bf16", "auto"][0], out["highest", "auto"][0])
        if fam == "plp_batch":
            assert out["default", "auto"][2] <= MODE_ERR["default"]
        else:
            assert torch.equal(out["default", "auto"][0],
                               out["highest", "auto"][0]), fam
        assert all(out[k][1] == {} for k in out if k[1] == "torch")
        assert out["highest", "auto"][2] <= MODE_ERR["highest"], fam
        assert out["high", "torch"][2] <= MODE_ERR["high"] + floor, (
            fam, out["high", "torch"][2], floor)
        _log(f"[18 precision modes] {fam}: 'high' on the plain route, equal "
             f"to 'highest' there, within {MODE_ERR['high']:g} + the plain "
             f"chain's own {floor:.3e} at 'highest'; 'default' and bf16 on "
             f"{next(iter(kernel))}, bf16 equal to 'highest' bit for bit, "
             + ("'default' within its 5.33e-2 (the LPC tail's products "
                "follow the mode)" if fam == "plp_batch"
                else "'default' too"))
        # the plain twins of the TF32 and bf16 forms: log-mel inside each
        # frame's 50 dB window, the cepstral families whole
        spectral = fam == "log_mel_batch"

        def twin_err(f, want):
            d = []
            for i in rows:
                e = np.abs(f[i, : refs[i].shape[0]] - want[i])
                if spectral:
                    e = e[refs[i] > refs[i].max(axis=-1, keepdims=True)
                          - math.log(10.0 ** (SPEC_WINDOW_DB / 10.0))]
                d.append(e.ravel())
            d = np.concatenate(d)
            return float(d.max()), float(d.mean())

        tf_max = twin_err(out["default", "torch"][0].cpu().numpy(), refs)[0]
        bf_max, bf_mean = twin_err(out["bf16", "torch"][0].cpu().numpy(), refs)
        bf_cfg = base.replace(**PRECISION_SETTINGS["bf16"])
        cpu = entry(xc, lc, bf_cfg, "torch")[0].numpy()
        form_max, form_mean = twin_err(
            out["bf16", "torch"][0].cpu().numpy(),
            {i: cpu[k, : refs[i].shape[0]] for k, i in enumerate(rows)})
        where = (f"inside each frame's {SPEC_WINDOW_DB:g} dB window"
                 if spectral else "whole")
        _log(f"[18 precision modes] {fam} plain twins {where}: 'default' "
             f"max {tf_max:.3e} (bound {MODE_ERR['default']:g} + "
             f"{floor:.3e}); bf16 mean {bf_mean:.3e} (gate "
             f"{BF16_GATES[0]:g}) max {bf_max:.3e} (gate {BF16_GATES[1]:g}"
             + (", not held: the reference's chain on the CPU is as far off"
                if spectral else "") +
             f"); bf16 vs the same chain on the CPU (the reference's form) "
             f"mean {form_mean:.3e} (bound {BF16_FORM_GATES[0]:g}) max "
             f"{form_max:.3e} (bound {BF16_FORM_GATES[1]:g})")
        assert tf_max <= MODE_ERR["default"] + floor, (fam, tf_max)
        assert bf_mean < BF16_GATES[0], (fam, bf_mean)
        assert spectral or bf_max < BF16_GATES[1], (fam, bf_max)
        assert (form_mean < BF16_FORM_GATES[0]
                and form_max < BF16_FORM_GATES[1]), (fam, form_mean, form_max)
        if fam == "mfcc_batch":
            # a caller that allows TF32 gets "highest" in IEEE fp32 and
            # its own flags back
            saved = torch.get_float32_matmul_precision()
            torch.set_float32_matmul_precision("high")
            try:
                feat = entry(xd, ld, base, "torch")[0]
                assert backend.matmul_flags()[:2] == ("high", True)
            finally:
                torch.set_float32_matmul_precision(saved)
            assert torch.equal(feat, out["highest", "torch"][0])
            _log("[18 precision modes] a caller's TF32 flags left as they "
                 "were, its 'highest' features unchanged by them")


def _three_tf32(torch, backend, a, b):
    """a @ b as three TF32 products of a split (hi = the operand with its
    13 low mantissa bits cleared, lo the rest): hi.lo + lo.hi + hi.hi.
    Not the port's form for "high"; timed beside it as the record of why
    (``backend.py``)."""
    def split(t):
        hi = (t.view(torch.int32) & -(1 << 13)).view(torch.float32)
        return hi, t - hi
    (ah, al), (bh, bl) = split(a), split(b)
    with backend.matmul_form("default"):
        return ah @ bl + al @ bh + ah @ bh


def _precision_forms(torch, dev, smi) -> None:
    """Phase 18, the forms alone: ``backend.matmul`` on the plain path's
    DFT product of the bench batch, against float64; one training step at
    "default"."""
    from mfcc_tpu_torch import FeatureConfig, backend
    from mfcc_tpu_torch.models import trainable
    from mfcc_tpu_torch.ops import framing, spectrum
    cfg = FeatureConfig().validate()
    bench = _bench_audio(BATCH, SECONDS, cfg.sample_rate)
    x = torch.from_numpy(bench).to(dev)
    a = framing.frames(framing.preemphasize(x, cfg), cfg).reshape(
        -1, cfg.frame_len).contiguous()
    cos_m, sin_m = spectrum.dft_matrices(cfg)
    b = torch.from_numpy(np.concatenate([cos_m, sin_m], axis=1)
                         .astype(np.float32)).to(dev)
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    live = scale > 0     # bin 0's sine column is all zeros
    K = a.shape[1]
    ab, bb = a.bfloat16(), b.bfloat16()
    forms = {m: functools.partial(backend.matmul, a, b, m)
             for m in backend.PRECISIONS}
    forms["bf16"] = functools.partial(backend.matmul, ab, bb)
    forms["3xTF32"] = functools.partial(_three_tf32, torch, backend, a, b)
    rel, ms = {}, {}
    for name, fn in forms.items():
        flags = backend.matmul_flags()
        got = fn()
        err = (got.double() - exact).abs()
        assert backend.matmul_flags() == flags, name
        rel[name] = float((err[live] / scale[live]).max())
        ms[name] = statistics.median(_time_ms(torch, fn, calls=TIMING_CALLS))
        within = ""
        if name in FORM_UNIT:
            bound = FORM_UNIT[name] + K * 2.0 ** -23
            assert bool((err <= bound * scale).all()), (name, rel[name])
            within = f" (bound {bound:.3e})"
        elif name == "high":
            assert torch.equal(got, forms["highest"]()), "'high' form"
            within = " (the 'highest' form, equal bit for bit)"
        _log(f"[18 precision forms] {name}: ({a.shape[0]}, {K}) x ({K}, "
             f"{b.shape[1]}) vs float64 max abs {float(err.max()):.3e}, "
             f"max relative to |A||B| {rel[name]:.3e}{within}; "
             f"{ms[name]:.4f} ms ({smi})")
    _log(f"[18 precision forms] 3xTF32, the split 'high' does not take: "
         f"{ms['3xTF32'] / ms['highest']:.2f}x IEEE fp32's time, "
         f"{rel['3xTF32'] / rel['highest']:.2f}x its error, "
         f"{rel['default'] / rel['3xTF32']:.1f}x closer to float64 than "
         f"one TF32 product")
    # one training step at "default": spectrum and DCT on TF32, the mel
    # product IEEE fp32
    tcfg = cfg.replace(matmul_precision="default")
    losses = {}
    for c in (cfg, tcfg):
        params = trainable.init_params(c, dev)
        tgt = trainable.init_params(c, dev)
        with torch.no_grad():
            tgt.mel_w.mul_(1.5)
        target = trainable.forward(tgt, x, cfg).detach()
        opt = trainable.make_optimizer(params, 1e-3)
        flags = backend.matmul_flags()
        losses[c.matmul_precision] = float(trainable.train_step(
            params, opt, x, target, c))
        assert backend.matmul_flags() == flags
    assert all(math.isfinite(v) for v in losses.values()), losses
    step_ms = statistics.median(_time_ms(
        torch, lambda: trainable.train_step(params, opt, x, target, tcfg),
        calls=TIMING_CALLS // 3))
    rel_loss = abs(losses["default"] / losses["highest"] - 1.0)
    _log(f"[18 precision forms] train_step at 'default' on {tuple(x.shape)}: "
         f"loss {losses['default']:.6f} against "
         f"{losses['highest']:.6f} at 'highest' ({rel_loss:.3e} relative), "
         f"{step_ms:.4f} ms a step, the caller's flags unchanged ({smi})")


def _pitch_post_phase(torch, dev, smi) -> None:
    """Phase 19 (ROADMAP port faults, to check 1): the pitch post stages
    (``ops/pitch.post_stages``: Viterbi, lag, log f0, POV, the POV^2-weighted
    sliding mean, deltas) on the card and on the CPU over the same NCCF
    (the card's ``fused_nccf``), with the float64 prefix sums the port
    takes and with float32 ``torch.cumsum`` (the form before), each
    against the float64 oracle: the bench batch and one long row."""
    import torch.nn.functional as F
    from mfcc_tpu_torch import PitchConfig, oracle
    from mfcc_tpu_torch.ops import pitch as pitch_op
    pcfg = PitchConfig().validate()
    bench = _bench_audio(BATCH, SECONDS, pcfg.sample_rate)
    B, N = bench.shape
    lens = np.maximum(N - np.arange(B) * (N // (B + 6)), 0).astype(np.int32)
    lens = np.maximum(lens, N // 4)
    audio = bench.copy()
    for i, n in enumerate(lens):
        audio[i, n:] = 0.0
    long = _bench_audio(1, PITCH_LONG_SECONDS, pcfg.sample_rate)
    prefix = {"float64 prefix sums": pitch_op._prefix64,
              "float32 torch.cumsum": lambda v: F.pad(
                  torch.cumsum(v, dim=-1), (1, 0))}
    for what, sig, ln in ((f"{B} x {SECONDS:g} s ragged", audio, lens),
                          (f"1 x {PITCH_LONG_SECONDS:g} s", long,
                           np.array([long.shape[1]], np.int32))):
        nb, npl, flens, mask, _ = pitch_op._track(
            torch.from_numpy(sig).to(dev), torch.from_numpy(ln).to(dev), pcfg,
            nccf_chunk=None, backend="auto", precision="highest")
        rows = sorted({0, len(ln) - 1})
        refs = {i: oracle.pitch(sig[i, : ln[i]].astype(np.float64), pcfg)
                for i in rows}
        m = mask.cpu().numpy()
        for form, fn in prefix.items():
            saved = pitch_op._prefix64
            pitch_op._prefix64 = fn
            try:
                card = pitch_op.post_stages(nb, npl, flens, mask, pcfg)
                cpu = pitch_op.post_stages(nb.cpu(), npl.cpu(), flens.cpu(),
                                           mask.cpu(), pcfg).numpy()
                card = card.cpu().numpy()
            finally:
                pitch_op._prefix64 = saved
            gap = [float(np.abs(card - cpu)[..., c][m].max())
                   for c in range(3)]
            errs = {}
            for side, f in (("card", card), ("cpu", cpu)):
                errs[side] = [max(float(np.abs(
                    f[i, : refs[i].shape[0], c] - refs[i][:, c]).max())
                    for i in rows) for c in range(3)]
            margin = [t - e for t, e in zip(PITCH_TOL, errs["cpu"])]
            _log(f"[19 pitch post stages] {what}, {form}: card vs CPU on "
                 f"the same NCCF (pov/norm/delta) {_fmt(gap)}, the CPU's "
                 f"margin to the bounds {_fmt(margin)}; vs the float64 "
                 f"oracle on rows {rows}: card {_fmt(errs['card'])}, CPU "
                 f"{_fmt(errs['cpu'])} (bounds {_fmt(PITCH_TOL)}) ({smi})")
            if fn is saved:
                assert all(e <= t for e, t in zip(errs["card"], PITCH_TOL)), (
                    what, errs["card"])


# ---- phase 20: the chunked NCCF on one long stream ----

def _vibrato(n: int, sr: int) -> np.ndarray:
    """A voiced 180 Hz vibrato (three harmonics, 10 % at 4 Hz, light noise),
    numpy seed 0: the voiced signal of tests/test_torch_pitch.py."""
    rng = np.random.default_rng(0)
    t = np.arange(n) / sr
    phase = 2 * np.pi * 180.0 * (t + 0.1 / (2 * np.pi * 4.0)
                              * np.sin(2 * np.pi * 4.0 * t))
    x = sum(a * np.sin(h * phase) for h, a in ((1, 0.5), (2, 0.25),
                                               (3, 0.12)))
    return (x + 0.02 * rng.standard_normal(n)).astype(np.float32)


def _valid_diff(torch, got, want, mask) -> float:
    """max |got - want| over the valid frames of (B, T, n_lags) NCCFs."""
    return float(torch.where(mask[..., None], (got - want).abs(), 0.0).max())


def _chunked_nccf_phase(torch, dev, smi) -> None:
    """Phase 20: ``nccf_chunk=`` on the card, where the port runs the
    unchunked kernel route (``ops/pitch._track``): on one 6-minute stream
    and the ragged bench batch at K in CHUNK_KS, the NCCF stage one
    ``fused_nccf`` launch, equal in every bit to ``nccf_chunk=None`` and
    within 2e-5 of the chunked plain route; K = 3 refused; ``pitch_track``
    (blocked) with chunking equal to without, and ``pitch_features`` with
    chunking on a voiced minute against the float64 oracle; CUDA-event ms
    of the unchunked kernel route beside the chunk rows through one
    ``fused_nccf`` launch (the design the card does not take), on the
    stream, the batch and a 60-minute row, and the host CPU's plain route
    chunked and unchunked (host clock)."""
    from mfcc_tpu_torch import PitchConfig, oracle
    from mfcc_tpu_torch.ops import pitch as pitch_op, resample
    from mfcc_tpu_torch.ops.kernels import fused_nccf, fused_viterbi
    pcfg = PitchConfig().validate()
    sr = pcfg.sample_rate
    stream = _bench_audio(1, CHUNK_STREAM_SECONDS, sr)
    batch = _bench_audio(BATCH, SECONDS, sr)
    B, N = batch.shape
    lens = np.maximum(N - np.arange(B) * (N // (B + 6)), N // 4)
    for i, n in enumerate(lens):
        batch[i, n:] = 0.0

    def stage(x, ln, k):
        fused_nccf.LAUNCHES = 0
        out = pitch_op._track(x, ln, pcfg, nccf_chunk=k, backend="auto",
                              precision="highest")
        torch.cuda.synchronize()
        assert fused_nccf.LAUNCHES == 1 and out[4] == "cuda", (
            k, fused_nccf.LAUNCHES, out[4])
        return out

    def unchunked(xw, mask, backend="cuda"):
        return pitch_op._nccf_dispatch(xw, pcfg, mask, backend, "highest")

    def chunk_rows(xw, mask, K):
        xc, _, ball = pitch_op._chunk_rows(xw, pcfg, mask, K)
        B, T = mask.shape
        return tuple(o.reshape(B, -1, o.shape[-1])[:, :T]
                     for o in fused_nccf.fused_nccf(xc, ball, pcfg, T=K))

    def ms(fn, *args):
        return statistics.median(_time_ms(torch, lambda: fn(*args),
                                          calls=CHUNK_CALLS))

    def timed(fn, *args):
        n_ops, host = _ops_and_host_ms(torch, lambda: fn(*args))
        return f"{ms(fn, *args):.4f} ({n_ops} ATen ops, enqueue {host:.4f})"

    def bound_ms(xw, T):
        ops, nbytes = _nccf_work(xw.shape[0], T, xw.shape[1])
        return 1e3 * max(ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)

    def same(a, b):
        return all(torch.equal(u, v) for u, v in zip(a, b))

    cases = {f"1 x {CHUNK_STREAM_SECONDS:g} s stream":
             (stream, [stream.shape[1]]),
             f"{B} x {SECONDS:g} s ragged": (batch, lens)}
    for what, (audio, lengths) in cases.items():
        x = torch.from_numpy(np.ascontiguousarray(audio)).to(dev)
        ln = torch.tensor(np.asarray(lengths), device=dev)
        full = stage(x, ln, None)
        mask = full[3]
        T = mask.shape[1]
        xw = resample.resample(x, sr, pcfg.work_rate, precision="highest")
        times = [f"unchunked {timed(unchunked, xw, mask)}"]
        for K in CHUNK_KS:
            got = stage(x, ln, K)
            plain = pitch_op._nccf_chunked(xw, pcfg, mask, K,
                                           precision="highest")
            d_plain = [_valid_diff(torch, g, p, mask)
                       for g, p in zip(got[:2], plain)]
            rows_same = same((g[mask] for g in chunk_rows(xw, mask, K)),
                             (f[mask] for f in unchunked(xw, mask)))
            _log(f"[20 chunked NCCF] {what} (T={T}), K={K}: one fused_nccf "
                 f"launch, equal in every bit to nccf_chunk=None: "
                 f"{same(got[:4], full[:4])}; vs the chunked plain route "
                 f"ballasted/plain {_fmt(d_plain)} (bound {KERNEL_TOL:g}); "
                 f"the chunk rows through fused_nccf equal on the valid "
                 f"frames: {rows_same}")
            assert same(got[:4], full[:4]), (what, K)
            assert max(d_plain) <= KERNEL_TOL, (what, K, d_plain)
            times.append(f"chunk rows K={K} {timed(chunk_rows, xw, mask, K)}")
        _log(f"[20 chunked NCCF] {what}: ms a call (CUDA events; host ms) "
             f"{', '.join(times)}; bound {bound_ms(xw, T):.4f} ({smi})")
    try:
        pitch_op.pitch_track(x, ln, pcfg, nccf_chunk=3)
    except ValueError as e:
        _log(f"[20 chunked NCCF] K=3 refused: ValueError: {e}")
    else:
        raise AssertionError("nccf_chunk=3 was not refused")

    # one hour: the stream's work-rate row repeated
    x = torch.from_numpy(stream).to(dev)
    xw_s = resample.resample(x, sr, pcfg.work_rate, precision="highest")
    xh = xw_s.repeat(1, CHUNK_HOUR_REPEATS)
    Th = (xh.shape[1] - pcfg.frame_len_w - pcfg.max_lag) // pcfg.hop_len_w + 1
    mask_h = torch.ones((1, Th), dtype=torch.bool, device=dev)
    K = CHUNK_KS[-1]
    _log(f"[20 chunked NCCF] 1 x {CHUNK_HOUR_REPEATS * CHUNK_STREAM_SECONDS:g}"
         f" s row (T={Th}): chunk rows K={K} equal to unchunked in every "
         f"bit: {same(chunk_rows(xh, mask_h, K), unchunked(xh, mask_h))}; "
         f"ms unchunked {ms(unchunked, xh, mask_h):.4f}, chunk rows K={K} "
         f"{ms(chunk_rows, xh, mask_h, K):.4f}; bound "
         f"{bound_ms(xh, Th):.4f} ({smi})")
    del xh

    # end to end: pitch_track, blocked, on the stream
    ln = torch.tensor([stream.shape[1]], device=dev)
    blocked = dict(viterbi_block=320, viterbi_warm=64)
    tracks = {}
    for k in (None, 128):
        _reset_counts([fused_nccf, fused_viterbi])
        tracks[k] = pitch_op.pitch_track(x, ln, pcfg, nccf_chunk=k, **blocked)
        torch.cuda.synchronize()
        counts = (fused_nccf.LAUNCHES, fused_viterbi.LAUNCHES)
        assert counts == (1, 1), (k, counts)
    _log(f"[20 chunked NCCF] pitch_track 1 x {CHUNK_STREAM_SECONDS:g} s, "
         f"viterbi_block 320, warm 64: one fused_nccf and one fused_viterbi "
         f"launch each; nccf_chunk=128 f0, voicing and mask equal to "
         f"unchunked in every bit: {same(tracks[None], tracks[128])}")
    assert same(tracks[None], tracks[128])

    xv = _vibrato(int(CHUNK_VOICED_SECONDS * sr), sr)
    _reset_counts([fused_nccf, fused_viterbi])
    feat, fl, _ = pitch_op.pitch_features(
        torch.from_numpy(xv[None]).to(dev), torch.tensor([xv.size], device=dev),
        pcfg, nccf_chunk=128)
    torch.cuda.synchronize()
    counts = (fused_nccf.LAUNCHES, fused_viterbi.LAUNCHES)
    want = oracle.pitch(xv.astype(np.float64), pcfg)
    assert int(fl[0]) == want.shape[0] and counts == (1, 1), (fl, counts)
    errs = _columns_err(feat[0].cpu().numpy(), want, PITCH_TOL)
    _log(f"[20 chunked NCCF] pitch_features(nccf_chunk=128) on a voiced "
         f"{CHUNK_VOICED_SECONDS:g} s vibrato ({want.shape[0]} frames, "
         f"launched fused_nccf/fused_viterbi {counts}) vs the float64 "
         f"oracle, pov/norm/delta {_fmt(errs)}")

    # the plain route on the host CPU, host clock
    xc = xw_s.cpu()
    mc = torch.ones((1, pcfg.num_frames(stream.shape[1])), dtype=torch.bool)

    def host_ms(fn):
        fn()
        out = []
        for _ in range(2):
            t0 = time.perf_counter()
            fn()
            out.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(out)

    cpu = [f"unchunked {host_ms(lambda: unchunked(xc, mc, 'torch')):.1f}"]
    cpu += [f"K={K} " + format(host_ms(lambda: pitch_op._nccf_chunked(
        xc, pcfg, mc, K, precision="highest")), ".1f") for K in CHUNK_KS]
    _log(f"[20 chunked NCCF] the plain route on the host CPU ({os.cpu_count()}"
         f" cores, {torch.get_num_threads()} threads), 1 x "
         f"{CHUNK_STREAM_SECONDS:g} s stream: ms a call {', '.join(cpu)}")


# ---- phase 21: the roofline ladder (row 7) ----

def _roofline_phase(torch, dev, smi, libs) -> dict:
    """The rungs built in phase 2 on each path's BATCH x SECONDS batch of
    the reference probe's signal: each held to its twin and to the
    kernel's launch, then the ladder timed (its rung launches counted from
    0 just before, read just after) -> row 7's record."""
    from mfcc_tpu_torch.tools import roofline
    inputs = {path: roofline.kernel_input(path, torch.from_numpy(
        roofline.signal(cfg, BATCH, SECONDS)).to(dev))
        for path, (_, cfg, _) in roofline.PATHS.items()}
    checks = {}
    for path, x in inputs.items():
        checks[path] = c = roofline.check(libs, path, x)
        p = c["plan"]
        _log(f"[21 roofline] {path} ({p['tile']} tile): stage, fft and "
             f"fftlog launched the kernel's plan (TM {p['TM']}, pairs "
             f"{p['pairs']}, span {p['span']}, {p['smem_bytes']} B shared, "
             f"{p['blocks']} blocks); stage equal in every bit to the gather, "
             f"fftlog to the kernel; fft {c['fft_max_abs_err']:.3e} off the "
             f"plain chain ({c['fft_rel_err']:.2e} of its max, bound "
             f"{roofline.FFT_RTOL:g})")
    for rung in roofline.LAUNCHES:
        roofline.LAUNCHES[rung] = 0
    results = roofline.ladder(libs, inputs, passes=2)
    launches = dict(roofline.LAUNCHES)
    doc = roofline.report(results, inputs, smi, 2, checks)
    for path in inputs:
        for rung, r in doc["results"][path].items():
            _log(f"[21 roofline] {path} {rung}: {r['median_ms']:.4f} ms "
                 f"({' / '.join(f'{t:.4f}' for t in r['ms'])}) = "
                 f"{r['audio_sec_per_s']:,.0f} audio-sec/s, host enqueue "
                 f"{r['host_enqueue_ms']:.4f} ms a call ({smi})")
        _log(f"[21 roofline] {path}: " + ", ".join(
            f"{k} {v:.1f} %" for k, v in doc["derived"][path].items())
            + f" ({smi})")
    _log(f"[21 roofline] rung launches of the ladder (counted from 0 just "
         f"before): {launches}")
    if not all(launches.values()):
        raise RuntimeError(f"a rung was not launched: {launches}")
    # the record: the fft rung of path 1, the attainable ceiling
    path = "fused_raw_dit"
    _, cfg, dct = roofline.PATHS[path]
    x = inputs[path]
    plain_ms = statistics.median(_time_ms(torch, lambda: roofline.plain_rung(
        "fft", x, cfg, dct), calls=TIMING_CALLS))
    ops, nbytes = _spectral_work(cfg, dct, True, *x.shape, log=False)
    times = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": ops / FP32_FLOPS}
    bound_by = max(times, key=times.get)
    fft_ms = doc["results"][path]["fft"]["median_ms"]
    _log(f"[21 roofline] {path} fft rung: {ops / 1e9:.3f} GFLOP, "
         f"{nbytes / 1e6:.2f} MB -> bound {1e3 * times[bound_by]:.4f} ms by "
         f"{bound_by}; ran {fft_ms:.4f} ms, its plain twin {plain_ms:.4f} ms")
    return {
        "name": "roofline_probe", "route": "cuda",
        "source": "mfcc_tpu_torch/tools/roofline.py",
        "replaces": REPLACES["roofline_probe"],
        "launches": sum(launches.values()),
        "max_abs_err": max(c["fft_max_abs_err"] for c in checks.values()),
        "ms": fft_ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * times[bound_by], "bound_by": bound_by,
        "library_ms": None, "tile": None, "direct_tile_ms": None,
        "f32_tile_ms": None, "rfft_stage_ms": None,
        "rungs": {p: {r: v["median_ms"] for r, v in doc["results"][p].items()}
                  for p in inputs},
        "kernel_pct_of_attainable_ceiling": {
            p: d["kernel_pct_of_attainable_ceiling"]
            for p, d in doc["derived"].items()},
        "stage_pct_of_hbm": {p: d["stage_pct_of_hbm"]
                             for p, d in doc["derived"].items()}}


def run(torch, dev) -> list[dict]:
    """Phases 1-8 and 10-21 on device ``dev``; -> the kernels' JSON records
    (of phases 1-8, and row 7's of phase 21: the other phases report their
    own counters)."""
    from mfcc_tpu_torch import PitchConfig
    from mfcc_tpu_torch.ops.kernels import _build

    # ---- 1. device ----
    smi, sm_mhz = _smi(), _sm_clock_mhz()
    _log(f"[1 device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"{torch.cuda.get_device_name(0)}, "
         f"device_count {torch.cuda.device_count()}")
    print(smi, flush=True)
    _log(f"[1 device] max SM clock {sm_mhz:g} MHz")

    rung_libs = _build_all(_build)                          # 2
    bench = _bench_audio(BATCH, SECONDS, 16000)
    mfcc_err = _mfcc_kernel_vs_plain(torch, dev, bench)     # 3
    spectral_errs = _spectral_kernels_vs_plain(torch, dev)  # 3b
    fft_errs = _fft_tile_vs_plain(torch, dev)               # 3b
    _acc_log_bits(torch, dev)                               # 3c
    proj_errs = _projections_vs_plain(torch, dev, bench)    # 3d
    mfcc_launches, mfcc_tiles = _mfcc_main_path(torch, dev, bench)  # 4
    logmel_launches, logmel_tiles = _logmel_main_paths(torch, dev)  # 4b
    proj_launches, proj_tiles = _plp_spectrogram_main_paths(torch, dev)  # 4c
    nccf_err, nccf_tile = _nccf_kernel_vs_plain(torch, dev, bench)  # 5
    viterbi_bad = _viterbi_kernel_vs_plain(torch, dev)      # 6
    pitch_launches = _pitch_main_path(torch, dev, bench)    # 7
    med = _timing(torch, dev, bench, smi, sm_mhz)           # 8
    _packed_corpus(torch, dev, smi)                         # 10
    _dither_phase(torch, dev, bench)                        # 11
    _post_phase(torch, dev, bench, smi)                     # 12
    _streaming_phase(torch, dev, bench, smi)                # 13
    root = tempfile.mkdtemp(prefix="mfcc_runner_")
    try:
        cdir, corpus = _runner_corpus(root)
        cmvn_path = _corpus_runner_phase(torch, dev, smi, root, cdir,
                                         corpus)            # 14
        _online_pitch_phase(torch, dev, smi)                # 15
        _training_phase(torch, dev, bench, smi, cdir, corpus,
                        cmvn_path)                          # 16
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _distributed_phase(torch, dev, smi)                     # 17
    _precision_families(torch, dev, smi)                    # 18
    _precision_forms(torch, dev, smi)                       # 18
    _pitch_post_phase(torch, dev, smi)                      # 19
    _chunked_nccf_phase(torch, dev, smi)                    # 20
    roofline = _roofline_phase(torch, dev, smi, rung_libs)  # 21

    src = lambda k: f"mfcc_tpu_torch/ops/kernels/csrc/{k.split('/')[0]}.cu"
    launches = {**logmel_launches, **pitch_launches, **proj_launches}
    launches["fused_raw_dit"] += mfcc_launches
    errs = {**spectral_errs, "fused_nccf": nccf_err,
            "fused_viterbi": viterbi_bad, **proj_errs}
    errs["fused_raw_dit"] = max(errs["fused_raw_dit"], mfcc_err)
    for k, e in fft_errs.items():
        errs[k] = max(errs[k], e)
    # the tile each kernel ran on its main path(s)
    tiles = {"fused_nccf": "direct", "fused_viterbi": None, **proj_tiles}
    logmel_tiles["fused_raw_dit"] = {
        t: v + mfcc_tiles[t] for t, v in logmel_tiles["fused_raw_dit"].items()}
    for k, counts in logmel_tiles.items():
        tiles[k] = "+".join(t for t, v in counts.items() if v)
    records = []
    B, N = bench.shape
    T_pitch = PitchConfig().num_frames(N)
    for k, (ops, nbytes) in _bounds(bench).items():
        times = {"bytes": nbytes / HBM_BYTES_PER_S,
                 "operations": ops / FP32_FLOPS,
                 "chain": (_chain_ms(T_pitch, PitchConfig().n_lags, sm_mhz)
                           / 1e3 if k == "fused_viterbi" else 0.0)}
        bound_by = max(times, key=times.get)
        records.append({
            "name": k, "route": "cuda", "source": src(k),
            "replaces": REPLACES[k], "launches": launches[k],
            "max_abs_err": errs[k], "ms": med[k],
            "plain_ms": med[f"{k} plain"],
            "bound_ms": 1e3 * times[bound_by], "bound_by": bound_by,
            "library_ms": None, "tile": tiles[k],
            "direct_tile_ms": med.get(f"{k} direct", med.get(f"{k} dit")),
            "f32_tile_ms": med.get(f"{k} fft"),
            "rfft_stage_ms": med.get(f"{k.split('/')[0]} rfft")})
        _log(f"[9 summary] {k}: {ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB"
             + (f", a {T_pitch - 1}-step chain" if times["chain"] else "")
             + f" -> bound {records[-1]['bound_ms']:.4f} ms by "
             f"{records[-1]['bound_by']}; ran {med[k]:.4f} ms")
    own = _nccf_kernel_ops(B, T_pitch, nccf_tile["TM"])
    _log(f"[9 summary] fused_nccf: the work the kernel does ({nccf_tile}: "
         f"window energies summed directly once per tile position) "
         f"{own / 1e9:.3f} GFLOP -> {own / FP32_FLOPS * 1e3:.4f} ms at the "
         f"fp32 peak; ran {med['fused_nccf']:.4f} ms")
    return records + [roofline]


def main() -> int:
    t0 = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "mfcc_tpu_torch")):
        print(f"chip_smoke: no mfcc_tpu_torch package beside {__file__}; run "
              "it from the repository root", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    kernels = run(torch, torch.device("cuda", 0))
    # ---- 9. summary ----
    assert "jax" not in sys.modules and "mfcc_tpu" not in sys.modules
    _log(f"[9 summary] phases 1-8 and 10-21 passed in "
         f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
