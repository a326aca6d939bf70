"""Streaming / chunked features (twin of ``mfcc_tpu/models/streaming.py``;
BASELINE config 4).

Unbounded audio streams through fixed-size, hop-aligned chunks of
``chunk_frames * hop_len`` samples.  The state carries the last
``frame_len`` samples (the history of any frame whose end lands in the
next chunk, and the pre-emphasis predecessor), the samples seen and the
frames emitted.  Each step emits ``chunk_frames`` slots and a count of the
valid ones: the frames whose last sample arrived in this chunk.  Four
variants stream through one state: "mfcc", "logmel" (no DCT), "plp" and
"spec" (the floored log power spectrum).

- The scan path (:func:`process_chunk`, its batched and K-chunk forms,
  :func:`stream_signal`) is plain PyTorch on the state's device, as the
  reference's scan path is its XLA engine and no Pallas kernel.  It
  pre-emphasizes the buffer once (the HTK x[-1] := x[0] rule applied only
  at the true stream start, through the carry), slices the hop-aligned
  span the chunk's slots read, and runs the batch plain chain
  (``_spectral.plain_features``; PLP's plain chain) on it with
  pre-emphasis done, so its frames are the batch plain path's frames.
  Sessions of a batch each have their own ``samples_seen`` and
  ``frames_done``: the span is a per-row gather and the dither start a
  per-row offset.
- The fused serving path (:func:`process_chunks_batch_fused`) advances B
  sessions by K chunks in one launch of ``fused_raw_dit`` (mel, bark or
  spec) on the host-pre-emphasized span with ``cfg.replace(preemph=0.0)``:
  the one allowed deviation from streaming-equals-batch (within 5e-5 of
  the scan path; the spectrogram 2e-4 inside its 50 dB window).
- :func:`online_cmvn_step` normalizes emitted frames causally, within 1e-5
  of the batch ``ops/post.online_cmvn`` (the second allowed deviation: a
  cumsum restarts at every chunk).

Dither is indexed by absolute sample position (``ops/dither``), so a
stream draws the noise the batch pipeline draws on the whole signal.
:func:`state_from_jax` carries a JAX ``StreamState``, ``OnlineCmvnState``
or CMVN ``Stats``, given as numpy arrays, into the port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import FeatureConfig
from .. import backend as backend_lib
from ..ops import dither as dither_op, framing, plp as plp_op, post, spectrum
from ..ops.kernels import _spectral, fused_raw_dit, routes
from ..parallel import cmvn

VARIANTS = ("mfcc", "logmel", "plp", "spec")


class StreamState(NamedTuple):
    carry: torch.Tensor         # (frame_len,) or (B, frame_len) trailing samples
    samples_seen: torch.Tensor  # () or (B,) int64
    frames_done: torch.Tensor   # () or (B,) int64, frames emitted so far


def init_state(cfg: FeatureConfig, device="cuda",
               dtype: torch.dtype = torch.float32) -> StreamState:
    return StreamState(
        carry=torch.zeros((cfg.frame_len,), dtype=dtype, device=device),
        samples_seen=torch.zeros((), dtype=torch.int64, device=device),
        frames_done=torch.zeros((), dtype=torch.int64, device=device))


def init_state_batch(n_streams: int, cfg: FeatureConfig, device="cuda",
                     dtype: torch.dtype = torch.float32) -> StreamState:
    """The state of ``n_streams`` concurrent sessions."""
    return StreamState(
        carry=torch.zeros((n_streams, cfg.frame_len), dtype=dtype,
                          device=device),
        samples_seen=torch.zeros((n_streams,), dtype=torch.int64,
                                 device=device),
        frames_done=torch.zeros((n_streams,), dtype=torch.int64,
                                device=device))


def _check(cfg: FeatureConfig, variant: str, C: int) -> int:
    """The reference's refusals; -> slots per chunk."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown streaming variant {variant!r}")
    if cfg.frame_mode != "valid":
        raise ValueError(
            "streaming supports frame_mode='valid' only: the centred "
            "convention's right-edge reflection needs end-of-stream "
            "lookahead")
    if C % cfg.hop_len != 0:
        raise ValueError(f"chunk length {C} must be a multiple of hop "
                         f"{cfg.hop_len}")
    backend_lib.check_config(cfg)
    return C // cfg.hop_len


def _num_frames_dyn(n: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """Tensor twin of FeatureConfig.num_frames (valid mode)."""
    return torch.clamp(torch.div(n - cfg.frame_len, cfg.hop_len,
                                 rounding_mode="floor") + 1, min=0)


def _span(state: StreamState, flat: torch.Tensor, cfg: FeatureConfig,
          n_slots: int):
    """(B, n) new samples of each session -> (buf (B, fl + n), the
    pre-emphasized span (B, (n_slots - 1) hop + fl) whose slot j starts at
    j hop, the new samples_seen, the new frames_done, the frames new
    this step (B,))."""
    fl, hop = cfg.frame_len, cfg.hop_len
    if flat.dtype == torch.int16:
        flat = flat.to(torch.float32) * (1.0 / 32768.0)
    flat = flat.to(state.carry.dtype)
    # noise indexed by absolute sample position, per session
    flat = dither_op.apply(flat, cfg, start=state.samples_seen)
    # stream start: the pre-emphasis predecessor of sample 0 is sample 0
    carry = state.carry.clone()
    first = state.samples_seen == 0
    carry[:, -1] = torch.where(first, flat[:, 0], carry[:, -1])
    buf = torch.cat([carry, flat], dim=1)
    z = framing.preemphasize(buf, cfg)
    # slot 0 (global frame frames_done) starts at buffer position
    # frames_done hop - samples_seen + fl, always in [1, fl]; tail slots
    # whose frames are incomplete read zero padding and are masked
    off0 = state.frames_done * hop - state.samples_seen + fl
    span = (n_slots - 1) * hop + fl
    zx = torch.cat([z, z.new_zeros((z.shape[0], max(fl - hop, 0)))], dim=1)
    idx = off0[:, None] + torch.arange(span, device=z.device)
    y = torch.gather(zx, 1, idx)
    new_seen = state.samples_seen + flat.shape[1]
    total = _num_frames_dyn(new_seen, cfg)
    return buf, y, new_seen, total, total - state.frames_done


def _scan_features(y: torch.Tensor, cfg: FeatureConfig,
                   variant: str) -> torch.Tensor:
    """The batch plain chain on pre-emphasized spans (B, span)."""
    if variant == "plp":
        fr = framing.frames(y, cfg)
        feat = plp_op.plp_from_power(
            spectrum.power_form(cfg)(fr, cfg), cfg)
        if cfg.append_energy:
            e = spectrum.log_energy_blocked(y, cfg)
            feat = torch.cat([e[..., None], feat[..., 1:]], dim=-1)
        return feat
    if variant == "spec":
        return _spectral.plain_features(y, cfg, False, projection="spec")
    return _spectral.plain_features(y, cfg, variant == "mfcc")


def _zero_past(feat: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Zero rows r >= n[b] of (B, R, F)."""
    r = torch.arange(feat.shape[1], device=feat.device)
    keep = r[None, :] < n[:, None]
    return torch.where(keep[..., None], feat,
                       torch.zeros((), dtype=feat.dtype, device=feat.device))


def process_chunk_batch(state: StreamState, chunks: torch.Tensor,
                        cfg: FeatureConfig, variant: str = "mfcc"):
    """Advance B concurrent sessions by one chunk each.

    chunks: (B, chunk_frames * hop), int16 PCM or float.  Returns
    (state', feats (B, chunk_frames, n_out), n_valid (B,)): slot j of row
    b holds global frame ``frames_done[b] + j``; slots j >= n_valid[b] are
    zero.
    """
    n_slots = _check(cfg, variant, chunks.shape[-1])
    chunks = chunks.to(state.carry.device)
    buf, y, new_seen, total, n_valid = _span(state, chunks, cfg, n_slots)
    feat = _zero_past(_scan_features(y, cfg, variant), n_valid)
    new_state = StreamState(carry=buf[:, chunks.shape[1]:],
                            samples_seen=new_seen, frames_done=total)
    return new_state, feat, n_valid


def _one(state: StreamState) -> StreamState:
    return StreamState(*(t[None] for t in state))


def _unbatch(state: StreamState) -> StreamState:
    return StreamState(*(t[0] for t in state))


def process_chunk(state: StreamState, chunk: torch.Tensor,
                  cfg: FeatureConfig, variant: str = "mfcc"):
    """One streaming step of one session.

    chunk: (chunk_frames * hop,) new samples.  Returns (state', feats
    (chunk_frames, n_out), n_valid ()): slot j holds global frame
    ``state.frames_done + j``; slots j >= n_valid are zero.
    """
    st, feat, nv = process_chunk_batch(_one(state), chunk[None], cfg,
                                       variant)
    return _unbatch(st), feat[0], nv[0]


def process_chunks(state: StreamState, chunks: torch.Tensor,
                   cfg: FeatureConfig, variant: str = "mfcc"):
    """Advance one session by K chunks (K, chunk_frames * hop) in one call:
    K :func:`process_chunk` steps.  Returns (state', feats (K,
    chunk_frames, n_out), n_valid (K,))."""
    feats, nvs = [], []
    for k in range(chunks.shape[0]):
        state, f, nv = process_chunk(state, chunks[k], cfg, variant)
        feats.append(f)
        nvs.append(nv)
    return state, torch.stack(feats), torch.stack(nvs)


def process_chunks_batch(state: StreamState, chunks: torch.Tensor,
                         cfg: FeatureConfig, variant: str = "mfcc"):
    """B sessions x K chunks (B, K, chunk_frames * hop).  Returns (state',
    feats (B, K, chunk_frames, n_out), n_valid (B, K))."""
    feats, nvs = [], []
    for k in range(chunks.shape[1]):
        state, f, nv = process_chunk_batch(state, chunks[:, k], cfg, variant)
        feats.append(f)
        nvs.append(nv)
    return state, torch.stack(feats, dim=1), torch.stack(nvs, dim=1)


def fused_eligible(cfg: FeatureConfig, variant: str) -> bool:
    """Whether the fused serving path takes cfg: the reference's kernel
    route (``spec_kernel_eligible`` for the spectrogram, else
    ``raw_dit_kernel_eligible``)."""
    return (routes.spec_kernel_eligible(cfg) if variant == "spec"
            else routes.raw_dit_kernel_eligible(cfg))


def process_chunks_batch_fused(state: StreamState, chunks: torch.Tensor,
                               cfg: FeatureConfig, variant: str = "mfcc"):
    """Serving step: advance B sessions by K chunks in ONE launch of
    ``fused_raw_dit`` instead of K steps of the scan path.

    chunks: (B, K, chunk_frames * hop).  Returns (state', feats (B,
    K chunk_frames, n_out), n_new (B,)): the frames completed this
    dispatch, contiguously: rows [0, n_new) are global frames
    [frames_done, frames_done + n_new), rows beyond are zero.

    The K chunks of a session are contiguous audio, so the dispatch is a
    batch of B short signals: the carry and the chunks, pre-emphasized
    once (continuity across dispatches comes from the carry, as in
    :func:`process_chunk`), one hop-aligned span a session, then the
    kernel with pre-emphasis off (``cfg.replace(preemph=0.0)``; the
    kernel's own x[-1] := x[0] rule would apply only at a true stream
    start, which the carry already encodes).  A CPU tensor runs the
    kernel's plain version.  Within 5e-5 of the scan path (the
    spectrogram 2e-4 inside its 50 dB window): the one allowed deviation
    from streaming-equals-batch.  Raises ValueError where the reference
    does: a config outside the kernel's route (:func:`fused_eligible`),
    log-mel not bounded to <= 50 dB (the kernel's valley envelope) and
    ``matmul_precision="high"`` (no kernel route; the scan path computes
    it).
    """
    B, K, C = chunks.shape
    n_slots = _check(cfg, variant, C)
    if not fused_eligible(cfg, variant):
        raise ValueError("config not eligible for the fused serving path "
                         "(use process_chunks_batch)")
    if variant == "logmel" and not routes.use_dit(cfg, False):
        raise ValueError(
            "fused serving log-mel requires dynamic_range_db <= 50 (the "
            "kernel's valley-accuracy envelope); use process_chunks_batch "
            "for unbounded log-mel")
    if not routes.kernel_precision_supported(cfg):
        raise ValueError("matmul_precision='high' has no kernel route (the "
                         "reference's Mosaic has no in-kernel HIGH dot); use "
                         "'highest' or 'default', or the scan path "
                         "(process_chunks_batch)")
    flat = chunks.to(state.carry.device).reshape(B, K * C)
    buf, y, new_seen, total, n_new = _span(state, flat, cfg, K * n_slots)
    kcfg = cfg.replace(preemph=0.0)
    if variant == "plp":
        log_bark = fused_raw_dit.fused_features_raw_dit(
            y, kcfg, apply_dct=False, projection="bark")
        feat = plp_op.plp_from_log_bark(log_bark, cfg)
        if cfg.append_energy:
            e = spectrum.log_energy_blocked(y, kcfg)
            feat = torch.cat([e[..., None], feat[..., 1:]], dim=-1)
    elif variant == "spec":
        feat = fused_raw_dit.fused_features_raw_dit(
            y, kcfg, apply_dct=False, projection="spec")
    else:
        feat = fused_raw_dit.fused_features_raw_dit(
            y, kcfg, apply_dct=variant == "mfcc")
    new_state = StreamState(carry=buf[:, -cfg.frame_len:],
                            samples_seen=new_seen, frames_done=total)
    return new_state, _zero_past(feat, n_new), n_new


class OnlineCmvnState(NamedTuple):
    """Carry of causal online CMVN over one feature stream: the trailing
    ``window - 1`` emitted frames shifted by the offset (zeros before the
    stream starts), the frames absorbed so far, and the shift (the
    stream's first frame, captured once)."""
    buf: torch.Tensor          # (window-1, F) trailing shifted frames
    frames_seen: torch.Tensor  # () int64
    offset: torch.Tensor       # (F,) first stream frame (0 until captured)


def init_online_cmvn(window: int, n_feats: int, device="cuda",
                     dtype: torch.dtype = torch.float32) -> OnlineCmvnState:
    return OnlineCmvnState(
        buf=torch.zeros((window - 1, n_feats), dtype=dtype, device=device),
        frames_seen=torch.zeros((), dtype=torch.int64, device=device),
        offset=torch.zeros((n_feats,), dtype=dtype, device=device))


def online_cmvn_step(state: OnlineCmvnState, feats: torch.Tensor,
                     n_valid, window: int, normalize_variance: bool = False,
                     prior=None):
    """Normalize one chunk of streamed features causally (zero lookahead).

    feats: (S, F) slots as :func:`process_chunk` emits them (slots past
    ``n_valid`` are zero and stay zero).  Slot j (global frame g =
    frames_seen + j) is normalized by the statistics of global frames
    [max(0, g - window + 1), g], the contract of ``ops/post.online_cmvn``
    and ``oracle.online_cmvn``; within 1e-5 of the batch op (the cumsum
    restarts at each chunk, so the summation order differs), with or
    without the variance, at any window.
    Statistics run on data shifted by the stream's first frame.
    ``prior``: optional raw (count, sum (F,), sumsq (F,)) blended in while
    the window is young.  Returns (state', normalized (S, F)).
    """
    S, F = feats.shape
    W = window
    dev = state.buf.device
    feats = feats.to(dev)
    n_valid = torch.as_tensor(n_valid, device=dev).to(torch.int64)
    j = torch.arange(S, device=dev)
    valid = (j < n_valid).to(feats.dtype)[:, None]
    # the shift: the first valid frame of the stream (slot 0 of the first
    # chunk; a leading chunk with no valid slot emits nothing)
    off = torch.where(state.frames_seen == 0, feats[0], state.offset)
    buf = torch.cat([state.buf, (feats - off) * valid])   # (W-1+S, F)
    # rows of buf are global frames [frames_seen - (W-1), frames_seen + S):
    # slot j's window is rows [j, W-1+j]; rows before the stream are zeros
    # and are left out of the count
    # float64 prefix sums on every device (``ops/post``: CUDA's float32
    # cumsum accumulates in float32, ~3e-5 off at a 300-frame window)
    zero = buf.new_zeros((1, F), dtype=torch.float64)

    def window_sums(v):
        cs = torch.cat([zero, torch.cumsum(v, dim=0, dtype=torch.float64)])
        return (cs[W + j] - cs[j]).to(feats.dtype)

    sums = window_sums(buf)
    cnt = torch.clamp(state.frames_seen + j + 1, max=W).to(feats.dtype)
    sq = window_sums(buf * buf) if normalize_variance else None
    cnt, sums, sq = post._blend_prior(cnt, sums, sq, W, prior, offset=off)
    out = post._normalize(feats, off, sums, sq, cnt) * valid
    new_buf = buf[n_valid + torch.arange(W - 1, device=dev)]
    return OnlineCmvnState(buf=new_buf,
                           frames_seen=state.frames_seen + n_valid,
                           offset=off), out


def stream_signal(x: torch.Tensor, cfg: FeatureConfig,
                  chunk_frames: int = 64, variant: str = "mfcc"):
    """A whole signal through the scan path, on x's device.  x's length
    should be a multiple of chunk_frames * hop (the rest is dropped).
    Returns (feats (n_chunks chunk_frames, n_out), slot-aligned as each
    step emits them, frames emitted ())."""
    C = chunk_frames * cfg.hop_len
    n_chunks = x.shape[0] // C
    st, feats, _ = process_chunks(init_state(cfg, device=x.device),
                                  x[: n_chunks * C].reshape(n_chunks, C),
                                  cfg, variant)
    return feats.reshape(n_chunks * chunk_frames, -1), st.frames_done


_STATES = {StreamState: (None, torch.int64, torch.int64),
           OnlineCmvnState: (None, torch.int64, None),
           cmvn.Stats: (None, None, None)}


def state_from_jax(state, device="cuda"):
    """The port's StreamState, OnlineCmvnState or CMVN Stats for the JAX
    one of that name, given as numpy arrays (``jax.tree.map(np.asarray,
    state)``) or as a dict of its fields; the kind is matched by the field
    names, so a state that grew a field on one side raises.  Counters
    become int64; float arrays keep their dtype (float32 from the device,
    float64 from the corpus runner's host statistics)."""
    d = state._asdict() if hasattr(state, "_asdict") else dict(state)
    for cls, dtypes in _STATES.items():
        if set(d) == set(cls._fields):
            return cls(*(torch.as_tensor(np.array(d[f]), dtype=dt,
                                         device=device)
                         for f, dt in zip(cls._fields, dtypes)))
    raise ValueError(f"no port state has the fields {sorted(d)}")
