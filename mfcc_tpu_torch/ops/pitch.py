"""Pitch stages, NCCF + Viterbi in the Kaldi style (twin of
``mfcc_tpu/ops/pitch.py``).

The stage math and conventions are the reference's (docs/conventions.md),
mirrored by the float64 oracle (``oracle.pitch``):

- lowpass + decimate to the work rate: the polyphase resampler
  (``ops/resample``), whose Kaiser anti-alias filter is the pitch lowpass;
- NCCF of every frame on the lag grid min_lag..max_lag, ballasted (silence
  suppression by ballast * mean_frame_energy^2) and plain;
- a min-plus Viterbi over the lag states with transition cost
  penalty * dlog(lag)^2, then parabolic lag refinement, the POV feature,
  POV^2-weighted mean normalization and delta log pitch.

:func:`nccf` (the correlation-theorem form) and :func:`viterbi` are the
plain twins of the CUDA kernels ``kernels/fused_nccf`` and
``kernels/fused_viterbi``.  With ``backend`` resolving to "cuda" (a CUDA
tensor under "auto") the pipeline runs the kernels; a config they do not
take raises NotImplementedError.

Padded (ragged-batch) frames get their ballasted NCCF set to exactly 0
before the Viterbi pass: a flat-zero emission makes staying in the current
state free and optimal, so the padded tail never changes the path through
the valid region.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import backend as backend_lib
from ..config import PitchConfig
from . import deltas as deltas_op, xmath
from .resample import reduce_ratio, resample


# --------------------------------------------------------------------------
# Constant matrices (float64 construction)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _corr_matrices(pcfg: PitchConfig):
    """DFT/IDFT matrices for the NCCF correlation theorem.

    n = frame_len_w + max_lag samples per extended window; Nc = n rounded
    up to even (the lags 0..max_lag never wrap a length-Nc circular
    correlation).  K = Nc//2 + 1 real bins; the IDFT lands on the
    min_lag..max_lag grid with the 1/Nc and the 2x interior-bin weights
    folded in.
    """
    n = pcfg.frame_len_w + pcfg.max_lag
    Nc = n + (n % 2)
    K = Nc // 2 + 1
    j = np.arange(Nc, dtype=np.float64)[:, None]
    k = np.arange(K, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * j * k / Nc
    cos_m = np.cos(ang)                    # (Nc, K)
    sin_m = np.sin(ang)
    wk = np.full((K,), 2.0)
    wk[0] = 1.0
    if Nc % 2 == 0:
        wk[-1] = 1.0
    lags = np.arange(pcfg.min_lag, pcfg.max_lag + 1, dtype=np.float64)
    angL = 2.0 * np.pi * k.T * lags[None, :] / Nc   # (K, n_lags)
    cl = (wk[:, None] * np.cos(angL)) / Nc
    sl = (wk[:, None] * np.sin(angL)) / Nc
    f32 = np.float32
    return (n, Nc, cos_m.astype(f32), sin_m.astype(f32),
            cl.astype(f32), sl.astype(f32))


@functools.lru_cache(maxsize=16)
def _trans_matrix(pcfg: PitchConfig) -> np.ndarray:
    """(n_lags, n_lags) Viterbi transition costs penalty * dlog(lag)^2,
    built in float64 and cast to float32 once."""
    lags = np.arange(pcfg.min_lag, pcfg.max_lag + 1, dtype=np.float64)
    d = np.log(lags)[:, None] - np.log(lags)[None, :]
    return (pcfg.penalty * d * d).astype(np.float32)


def _const(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


# --------------------------------------------------------------------------
# Stages
# --------------------------------------------------------------------------

def work_lengths(lengths: torch.Tensor, pcfg: PitchConfig) -> torch.Tensor:
    """True work-rate sample counts ceil(len * L / M), int32."""
    L, M = reduce_ratio(pcfg.sample_rate, pcfg.work_rate)
    return ((lengths.to(torch.int64) * L + (M - 1)) // M).to(torch.int32)


def pitch_frame_counts(lengths: torch.Tensor,
                       pcfg: PitchConfig) -> torch.Tensor:
    """Per-utterance pitch frame counts (tensor twin of
    PitchConfig.num_frames), int32."""
    nw = work_lengths(lengths, pcfg).to(torch.int64)
    n = torch.div(nw - (pcfg.frame_len_w + pcfg.max_lag), pcfg.hop_len_w,
                  rounding_mode="floor") + 1
    return torch.clamp(n, min=0).to(torch.int32)


def _prefix64(v: torch.Tensor) -> torch.Tensor:
    """(..., n) -> (..., n + 1) float64 prefix sums along the last axis,
    0 first.  A difference of two is a window sum rounded once: a float32
    running sum (CUDA's ``torch.cumsum`` of float32 keeps one; the CPU's
    accumulates in float64) puts the normalized log pitch of a 2-minute
    row ~4e-4 off the float64 oracle, over its 3e-4 bound
    (``tests/test_torch_pitch.py``)."""
    return F.pad(torch.cumsum(v, dim=-1, dtype=torch.float64), (1, 0))


def nccf(xw: torch.Tensor, pcfg: PitchConfig, mask: torch.Tensor, *,
         precision: str = backend_lib.KEYWORD_PRECISION,
         ball: torch.Tensor | None = None):
    """(B, Nw) work-rate signal -> (nccf_ballasted, nccf_plain), each
    (B, T, n_lags), by the correlation theorem (four DFT products and a
    lag-grid IDFT, float32 at the mode ``precision``; ``backend.matmul``).
    mask: (B, T) frame validity, for the masked mean energy the ballast
    scales with.  ``ball``: optional (B,) precomputed ballast
    (pcfg.ballast * mean_energy^2) used instead.  The window energies are
    differences of float64 prefix sums (:func:`_prefix64`)."""
    w, hop = pcfg.frame_len_w, pcfg.hop_len_w
    n, Nc, cos_m, sin_m, cl, sl = _corr_matrices(pcfg)
    B, Nw = xw.shape
    T = mask.shape[1]
    dev = xw.device

    # extended frames (B, T, n); frames past the signal end clamp to its
    # last sample (those frames are masked by every caller)
    idx = (np.arange(T) * hop)[:, None] + np.arange(n)[None, :]
    idx = np.minimum(idx, max(Nw - 1, 0))
    E = xw[:, _const(idx, dev)]
    A = torch.where(torch.arange(n, device=dev) < w, E, 0.0)
    if Nc > n:
        E = F.pad(E, (0, Nc - n))
        A = F.pad(A, (0, Nc - n))

    def mm(a, b):
        return backend_lib.matmul(a, b, precision)

    cm, sm = _const(cos_m, dev), _const(sin_m, dev)
    re_a, im_a = mm(A, cm), -mm(A, sm)
    re_e, im_e = mm(E, cm), -mm(E, sm)
    # conj(FA) * FE
    R = re_a * re_e + im_a * im_e
    I = re_a * im_e - im_a * re_e
    num = mm(R, _const(cl, dev)) - mm(I, _const(sl, dev))

    # window energies: one prefix sum + static slices
    cs = _prefix64(E[..., :n] * E[..., :n])
    e0 = cs[..., w].to(torch.float32)                  # (B, T)
    lo, hi = pcfg.min_lag, pcfg.max_lag
    e_lag = (cs[..., w + lo: w + hi + 1] - cs[..., lo: hi + 1]).to(
        torch.float32)

    if ball is None:
        mask_f = mask.to(e0.dtype)
        n_valid = torch.clamp(mask_f.sum(dim=1), min=1.0)
        mean_e = (e0 * mask_f).sum(dim=1) / n_valid    # (B,)
        ball = pcfg.ballast * mean_e * mean_e

    prod = torch.clamp(e0[..., None] * e_lag, min=1e-30)
    return num / torch.sqrt(prod + ball[:, None, None]), num / torch.sqrt(prod)


def mean_frame_energy(xw: torch.Tensor, pcfg: PitchConfig,
                      mask: torch.Tensor) -> torch.Tensor:
    """(B,) masked mean of the per-frame window energies e0: the kernel
    route's ballast input (:func:`nccf` derives the same quantity from its
    frame tensor, equal up to f32 summation order).

    From local hop-block sums: frame t's window covers hop-blocks
    [t, t+q) plus the first r samples of block t+q (q, r =
    divmod(frame_len_w, hop_len_w)), so every accumulation stays
    window-sized (a global cumsum difference loses f32 precision with
    signal length)."""
    w, hop = pcfg.frame_len_w, pcfg.hop_len_w
    T = mask.shape[1]
    B, Nw = xw.shape
    q, r = divmod(w, hop)
    need = (T + q) * hop   # last sample any frame's window can touch
    s2 = xw * xw
    if Nw >= need:
        s2 = s2[:, :need]
    else:   # frames past the signal read zeros (they are masked anyway)
        s2 = F.pad(s2, (0, need - Nw))
    s2b = s2.reshape(B, T + q, hop)
    bs = s2b.sum(dim=-1)                          # (B, T+q) block sums
    e0 = torch.zeros((B, T), dtype=xw.dtype, device=xw.device)
    for k in range(q):
        e0 = e0 + bs[:, k: k + T]
    if r:
        hr = s2b[:, :, :r].sum(dim=-1)            # (B, T+q) head sums
        e0 = e0 + hr[:, q: q + T]
    mask_f = mask.to(e0.dtype)
    n_valid = torch.clamp(mask_f.sum(dim=1), min=1.0)
    return (e0 * mask_f).sum(dim=1) / n_valid


def _nccf_dispatch(xw: torch.Tensor, pcfg: PitchConfig, mask: torch.Tensor,
                   backend: str, precision: str):
    """:func:`nccf` at ``precision`` ("torch") or the CUDA kernel ("cuda",
    ballast from :func:`mean_frame_energy`, as the reference's kernel
    route; the kernel has no product a mode changes, as the reference's
    keeps HIGHEST)."""
    if backend == "cuda":
        from .kernels import fused_nccf
        mean_e = mean_frame_energy(xw, pcfg, mask)
        return fused_nccf.fused_nccf(xw, pcfg.ballast * mean_e * mean_e,
                                     pcfg, T=mask.shape[1])
    return nccf(xw, pcfg, mask, precision=precision)


def _check_chunk(K: int, pcfg: PitchConfig) -> None:
    """ValueError unless chunks of K frames can be cut: a chunk row holds
    one block of K*hop_len_w samples and the head of the next, which needs
    (K+1)*hop_len_w >= frame_len_w + max_lag, and K >= 1.  A deliberate
    deviation: below the bound the reference fails inside its reshape, with
    a bare TypeError."""
    hop, need = pcfg.hop_len_w, pcfg.frame_len_w + pcfg.max_lag
    if K < 1 or (K + 1) * hop < need:
        raise ValueError(
            f"nccf_chunk={K}: a chunk row spans one block of K*hop_len_w "
            f"samples and the head of the next, so (K+1)*hop_len_w = "
            f"{(K + 1) * hop} must be >= frame_len_w + max_lag = {need}")


def _chunk_rows(xw: torch.Tensor, pcfg: PitchConfig, mask: torch.Tensor,
                K: int):
    """(B, Nw) work-rate rows, (B, T) mask -> the chunked NCCF's inputs:
    (B*C, span) chunk rows of K frames each (C = ceil(T/K)), their (B*C,
    K) masks against the true frame counts, and the (B*C,) ballast.

    Row c is [block c | head of block c+1] of the zero-padded signal cut
    in blocks of K*hop_len_w samples (static slices and a reshape, no
    gather), so frame c*K + k reads the samples it reads unchunked.  The
    ballast is the GLOBAL masked mean energy (:func:`mean_frame_energy`),
    repeated for every chunk."""
    _check_chunk(K, pcfg)
    B, Nw = xw.shape
    T = mask.shape[1]
    hop = pcfg.hop_len_w
    span = (K - 1) * hop + pcfg.frame_len_w + pcfg.max_lag
    C = -(-T // K)
    stride = K * hop
    need = (C + 1) * stride                  # base blocks + context
    xw_p = F.pad(xw, (0, need - Nw)) if Nw < need else xw[:, :need]
    base = xw_p[:, : C * stride].reshape(B, C, stride)
    ctx = xw_p[:, stride:].reshape(B, C, stride)[:, :, : span - stride]
    xc = torch.cat([base, ctx], dim=-1).reshape(B * C, span)
    flens = mask.sum(dim=1)                          # (B,)
    g = torch.arange(C * K, device=xw.device).reshape(C, K)
    mask_c = (g[None] < flens[:, None, None]).reshape(B * C, K)
    mean_e = mean_frame_energy(xw, pcfg, mask)
    return xc, mask_c, (pcfg.ballast * mean_e * mean_e).repeat_interleave(C)


def _nccf_chunked(xw: torch.Tensor, pcfg: PitchConfig, mask: torch.Tensor,
                  K: int, *, precision: str):
    """The plain NCCF (:func:`nccf` at ``precision``) of time chunks of K
    frames folded into the batch axis, (B, Nw) -> (B*C, span) rows
    (:func:`_chunk_rows`) -> (B, T, n_lags) again: the reference's
    ``nccf_chunk=`` option (``_nccf_chunked``), faster than the unchunked
    :func:`nccf` on the host CPU.  The plain NCCF equals the unchunked one;
    the ballasted one differs by the ballast's f32 summation order."""
    B, T = mask.shape
    xc, mask_c, ball_c = _chunk_rows(xw, pcfg, mask, K)
    nb, npl = nccf(xc, pcfg, mask_c, precision=precision, ball=ball_c)
    return (nb.reshape(B, -1, nb.shape[-1])[:, :T],
            npl.reshape(B, -1, npl.shape[-1])[:, :T])


def viterbi(nccf_b: torch.Tensor, pcfg: PitchConfig) -> torch.Tensor:
    """(B, T, n_lags) masked ballasted NCCF -> (B, T) int32 lag indices.

    cost_0 = -s_0; cost_t[i] = min_j(cost_{t-1}[j] + trans[j, i]) - s_t[i]
    with the first minimizing j as backpointer (torch.argmin), then a
    backtrace from the first minimal final cost."""
    B, T, n = nccf_b.shape
    if T == 0:
        return torch.zeros((B, 0), dtype=torch.int32, device=nccf_b.device)
    trans = _const(_trans_matrix(pcfg), nccf_b.device)       # (j, i)
    cost = -nccf_b[:, 0]
    back = torch.zeros((B, T, n), dtype=torch.int64, device=nccf_b.device)
    for t in range(1, T):
        tot = cost[:, :, None] + trans                        # (B, j, i)
        back[:, t] = torch.argmin(tot, dim=1)
        cost = torch.amin(tot, dim=1) - nccf_b[:, t]
    path = torch.empty((B, T), dtype=torch.int64, device=nccf_b.device)
    nxt = torch.argmin(cost, dim=1)
    path[:, T - 1] = nxt
    for t in range(T - 1, 0, -1):
        nxt = torch.gather(back[:, t], 1, nxt[:, None])[:, 0]
        path[:, t - 1] = nxt
    return path.to(torch.int32)


def viterbi_blocked(nccf_b: torch.Tensor, pcfg: PitchConfig, *,
                    block: int = 256, warm: int = 128,
                    backend: str = "auto") -> torch.Tensor:
    """Blocked Viterbi: (B, T, n_lags) -> (B, T) lag indices with the T-step
    chain cut to ``block + 2*warm`` steps.

    Time is split into C = ceil(T/block) chunks solved in parallel (the
    chunk axis joins the batch axis, so the B*C problems go through one
    kernel launch on "cuda"); each chunk sees ``warm`` frames of context
    on both sides and keeps its interior.  Chunks are cut from the scores
    padded with zero-emission frames, so the outer edges are exact;
    deviation from :func:`viterbi` is confined to interior seams in long
    stretches without voicing evidence (the reference function's docstring
    has the argument; tests/test_pitch.py measures it).
    """
    if backend_lib.resolve(backend, nccf_b, None) == "cuda":
        from .kernels import fused_viterbi
        solve = fused_viterbi.fused_viterbi
    else:
        solve = viterbi
    B, T, n = nccf_b.shape
    if T <= block + 2 * warm:
        return solve(nccf_b, pcfg)
    C = -(-T // block)
    Tpad = C * block
    S = F.pad(nccf_b, (0, 0, warm, Tpad - T + warm))
    Lw = block + 2 * warm
    idx = (np.arange(C) * block)[:, None] + np.arange(Lw)[None, :]
    W = S[:, _const(idx, nccf_b.device)]                     # (B, C, Lw, n)
    paths = solve(W.reshape(B * C, Lw, n), pcfg).reshape(B, C, Lw)
    interior = paths[:, :, warm: warm + block]                # (B, C, block)
    return interior.reshape(B, Tpad)[:, :T]


def _viterbi_dispatch(nccf_b: torch.Tensor, pcfg: PitchConfig, *,
                      viterbi_block: int | None, viterbi_warm: int,
                      backend: str) -> torch.Tensor:
    if viterbi_block is not None:
        return viterbi_blocked(nccf_b, pcfg, block=viterbi_block,
                               warm=viterbi_warm, backend=backend)
    if backend == "cuda":
        from .kernels import fused_viterbi
        return fused_viterbi.fused_viterbi(nccf_b, pcfg)
    return viterbi(nccf_b, pcfg)


def _path_neighborhood(nccf_p: torch.Tensor, path: torch.Tensor):
    """(..., n_lags) values at (path-1, path, path+1); neighbours off the
    lag grid are 0 (callers mask those frames anyway)."""
    n = nccf_p.shape[-1]
    p = path.to(torch.int64)[..., None]

    def pick(q):
        v = torch.gather(nccf_p, -1, torch.clamp(q, 0, n - 1))[..., 0]
        return torch.where((q[..., 0] >= 0) & (q[..., 0] < n), v, 0.0)

    return pick(p - 1), pick(p), pick(p + 1)


def _parabolic_from(ym, y0, yp, path, n) -> torch.Tensor:
    """Sub-sample lag refinement around the path (oracle._parabolic_lag
    semantics: 0 at grid edges or flat curvature, clipped to +-0.5)."""
    denom = ym - 2.0 * y0 + yp
    d = torch.where(torch.abs(denom) < 1e-12, 0.0,
                    0.5 * (ym - yp) / torch.where(denom == 0, 1.0, denom))
    d = torch.clamp(d, -0.5, 0.5)
    return torch.where((path == 0) | (path == n - 1), 0.0, d)


def pov_feature(c: torch.Tensor) -> torch.Tensor:
    """Kaldi's NCCF -> POV-feature nonlinearity: 2*((1.0001 - c)^0.15 - 1),
    the power as exp(0.15 * log(.)) with the accurate log."""
    base = 1.0001 - torch.clamp(c, -1.0, 1.0)
    k = torch.tensor(0.15, dtype=torch.float32, device=c.device)
    return 2.0 * (torch.exp(k * xmath.accurate_log(base)) - 1.0)


def weighted_sliding_mean(v: torch.Tensor, wgt: torch.Tensor,
                          window: int) -> torch.Tensor:
    """(B, T) centered weighted sliding mean, edges shrink (oracle
    semantics); frames with zero total weight keep v[t].  Float64 prefix
    sums (:func:`_prefix64`) indexed at min(t+half+1, T) and max(t-half,
    0); the mean is rounded to float32 once."""
    T = v.shape[-1]
    half = window // 2
    pv = _prefix64(v * wgt)
    pw = _prefix64(wgt)

    def shifted(p):
        tail = p[..., -1:].expand(*p.shape[:-1], half)
        hi = torch.cat([p, tail], dim=-1)[..., half + 1: half + 1 + T]
        lo = F.pad(p, (half, 0))[..., :T]
        return hi - lo

    sv = shifted(pv)
    sw = shifted(pw)
    return torch.where(sw > 1e-12, (sv / torch.clamp(sw, min=1e-12)).to(
        v.dtype), v)


def _track(x, lengths, pcfg, *, nccf_chunk, backend, precision):
    """The NCCF stage shared by :func:`pitch_features` and
    :func:`pitch_track`: -> (masked nccf_b, nccf_p, flens, mask, the
    resolved backend), or None when no frame fits.  With ``nccf_chunk``
    set and more frames than it, the plain route's NCCF is
    :func:`_nccf_chunked`; the kernel route ("cuda") does not chunk: it
    sums each frame alone, so chunk rows would give the same bits, and on
    the H100 they took longer (PERF.md)."""
    if nccf_chunk is not None:
        _check_chunk(nccf_chunk, pcfg)
    backend = backend_lib.resolve(backend, x, None)
    B, N = x.shape
    T = pcfg.num_frames(N)
    if T <= 0:
        return None
    x = x.to(torch.float32)
    xw = (resample(x, pcfg.sample_rate, pcfg.work_rate, precision=precision)
          if pcfg.work_rate != pcfg.sample_rate else x)
    lengths = torch.as_tensor(lengths, device=x.device)
    flens = torch.clamp(pitch_frame_counts(lengths, pcfg), max=T)
    mask = torch.arange(T, dtype=torch.int32,
                        device=x.device)[None, :] < flens[:, None]
    if nccf_chunk is not None and T > nccf_chunk and backend == "torch":
        nccf_b, nccf_p = _nccf_chunked(xw, pcfg, mask, nccf_chunk,
                                       precision=precision)
    else:
        nccf_b, nccf_p = _nccf_dispatch(xw, pcfg, mask, backend, precision)
    nccf_b = torch.where(mask[..., None], nccf_b, 0.0)
    return nccf_b, nccf_p, flens, mask, backend


def _path(nccf_b, nccf_p, pcfg, *, viterbi_block, viterbi_warm, backend):
    """-> (path, and the plain NCCF at path - 1, path, path + 1)."""
    path = _viterbi_dispatch(nccf_b, pcfg, viterbi_block=viterbi_block,
                             viterbi_warm=viterbi_warm, backend=backend)
    return (path, *_path_neighborhood(nccf_p, path))


def _lag(path, ym, c, yp, pcfg):
    return (pcfg.min_lag + path.to(torch.float32)
            + _parabolic_from(ym, c, yp, path, pcfg.n_lags))


def post_stages(nccf_b: torch.Tensor, nccf_p: torch.Tensor,
                flens: torch.Tensor, mask: torch.Tensor, pcfg: PitchConfig,
                *, viterbi_block: int | None = None, viterbi_warm: int = 128,
                backend: str = "auto") -> torch.Tensor:
    """The stages after the NCCF, on its device: (B, T, n_lags) ballasted
    NCCF (zero on invalid frames) and plain NCCF, (B,) frame counts, (B,
    T) mask -> (B, T, 3) [pov, normalized log pitch, delta log pitch],
    zero on invalid frames: the Viterbi path ("cuda": the kernel),
    parabolic lag, log f0, POV, the POV^2-weighted sliding mean and the
    deltas."""
    backend = backend_lib.resolve(backend, nccf_b, None)
    path, ym, c, yp = _path(nccf_b, nccf_p, pcfg, viterbi_block=viterbi_block,
                            viterbi_warm=viterbi_warm, backend=backend)
    wr = torch.tensor(float(pcfg.work_rate), dtype=torch.float32,
                      device=nccf_b.device)
    log_f0 = xmath.accurate_log(wr / _lag(path, ym, c, yp, pcfg))
    pov = pov_feature(c)
    wgt = torch.clamp(c, 0.0, 1.0) ** 2 * mask.to(c.dtype)
    norm = log_f0 - weighted_sliding_mean(log_f0, wgt, pcfg.norm_window)
    d = deltas_op.deltas(log_f0[..., None], pcfg.delta_window,
                         lengths=flens)[..., 0]
    feat = torch.stack([pov, norm, d], dim=-1)
    return torch.where(mask[..., None], feat, 0.0)


def pitch_features(x: torch.Tensor, lengths: torch.Tensor,
                   pcfg: PitchConfig, *,
                   precision: str = backend_lib.KEYWORD_PRECISION,
                   viterbi_block: int | None = None,
                   viterbi_warm: int = 128, nccf_chunk: int | None = None,
                   backend: str = "auto"):
    """(B, N) zero-padded float audio at pcfg.sample_rate + (B,) true
    lengths -> ((B, T, 3) [pov, normalized log pitch, delta log pitch],
    (B,) int32 frame counts, (B, T) bool mask).  Padded frames are zero.

    precision: the mode of the resampler's and the plain NCCF's products
    (``backend.matmul``), "highest" by default as in the reference; the
    ``fused_nccf`` route ignores it, as the reference's kernel does.
    viterbi_block: opt-in blocked Viterbi (see :func:`viterbi_blocked`).
    nccf_chunk: opt-in chunked NCCF (see :func:`_nccf_chunked`), K frames
    a chunk folded into the batch axis, on the plain route when there are
    more than K frames; the kernel route only checks K (see
    :func:`_track`).  The automatic paths never set it."""
    B = x.shape[0]
    tr = _track(x, lengths, pcfg, nccf_chunk=nccf_chunk, backend=backend,
                precision=precision)
    if tr is None:
        return (torch.zeros((B, 0, pcfg.n_feats), device=x.device),
                torch.zeros((B,), dtype=torch.int32, device=x.device),
                torch.zeros((B, 0), dtype=torch.bool, device=x.device))
    nccf_b, nccf_p, flens, mask, backend = tr
    return post_stages(nccf_b, nccf_p, flens, mask, pcfg,
                       viterbi_block=viterbi_block, viterbi_warm=viterbi_warm,
                       backend=backend), flens, mask


def pitch_track(x: torch.Tensor, lengths: torch.Tensor, pcfg: PitchConfig,
                *, viterbi_block: int | None = None, viterbi_warm: int = 128,
                nccf_chunk: int | None = None, backend: str = "auto"):
    """(B, N), (B,) -> ((B, T) f0 in Hz, (B, T) plain NCCF voicing, mask):
    the raw track for consumers that want Hz rather than ASR features.
    viterbi_block and nccf_chunk as in :func:`pitch_features`."""
    B = x.shape[0]
    tr = _track(x, lengths, pcfg, nccf_chunk=nccf_chunk, backend=backend,
                precision="highest")
    if tr is None:
        z = torch.zeros((B, 0), device=x.device)
        return z, z, torch.zeros((B, 0), dtype=torch.bool, device=x.device)
    nccf_b, nccf_p, _, mask, backend = tr
    path, ym, c, yp = _path(nccf_b, nccf_p, pcfg, viterbi_block=viterbi_block,
                            viterbi_warm=viterbi_warm, backend=backend)
    f0 = float(pcfg.work_rate) / _lag(path, ym, c, yp, pcfg)
    return torch.where(mask, f0, 0.0), torch.where(mask, c, 0.0), mask
