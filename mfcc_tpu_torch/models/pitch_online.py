"""Online (streaming) pitch tracker: chunked NCCF and a delayed Viterbi
(twin of ``mfcc_tpu/models/pitch_online.py``).

The batch tracker (``models/pitch``) needs the whole utterance twice: the
Viterbi backward pass starts from the final frame, and the ballast and
normalization statistics are utterance-global.  This is the bounded-latency
variant for serving, with the reference's three documented deviations
from the batch conventions (``docs/conventions.md``):

1. **Delayed Viterbi.** Frame t is finalized once frame t + delay has been
   scored, by a backtrace from the current best state; :meth:`OnlinePitch.
   flush` finalizes the rest from the true final cost, so with
   ``delay >= T`` the output path is the batch path (up to the ballast
   below).
2. **Causal ballast.** The NCCF's silence term uses the running mean frame
   energy over everything seen so far, this chunk included.
3. **Causal normalization.** The POV^2-weighted log-pitch mean runs over
   the trailing ``norm_window`` finalized frames; deltas use the
   provisional path at finalization.

Split of labour, as in the reference: the device step
(:func:`online_chunk_step`) scores a fixed-size chunk of ``chunk_frames``
frames: the chunk's frame energies (plain torch), the ballasted and plain
NCCF (on a CUDA tensor one launch of ``ops/kernels/fused_nccf`` at B = 1,
else the plain correlation-theorem ``ops/pitch.nccf``), and the Viterbi
forward recursion with the carried cost (plain torch: the reference runs
it in XLA, and ``fused_viterbi`` starts fresh and returns paths, not
per-frame backpointers).  The host ring-buffers backpointers and plain
NCCF rows, fetched once a chunk, and does the O(delay) backtrace.
:func:`online_pitch_np` is the float64 twin, chunk for chunk.

Differences from the reference: a feed or flush after :meth:`flush`
raises ``RuntimeError`` (the reference asserts), and the tracker lives on
one device, "cuda" unless the caller asks for the CPU.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import backend as backend_lib, oracle
from ..config import PitchConfig, from_jax
from ..ops import pitch as pitch_op
from ..ops.resample import StreamingResampler, resample_poly_numpy


class OnlineChunkState(NamedTuple):
    cost: torch.Tensor      # (n_lags,) Viterbi running cost
    e_sum: torch.Tensor     # () running frame-energy sum
    e_cnt: torch.Tensor     # () frames scored so far
    started: torch.Tensor   # () int32: 0 until the first valid frame


def init_chunk_state(pcfg: PitchConfig, device="cuda") -> OnlineChunkState:
    f32 = dict(dtype=torch.float32, device=device)
    return OnlineChunkState(
        cost=torch.zeros((pcfg.n_lags,), **f32),
        e_sum=torch.zeros((), **f32),
        e_cnt=torch.zeros((), **f32),
        started=torch.zeros((), dtype=torch.int32, device=device))


@functools.lru_cache(maxsize=8)
def _consts(pcfg: PitchConfig, n_frames: int, device: torch.device):
    """The chunk step's constants on ``device``, copied there once: the
    (n_frames, frame_len_w + max_lag) extended-frame indices, the
    (n_lags, n_lags) transition costs, the identity backpointers."""
    n = pcfg.frame_len_w + pcfg.max_lag
    idx = (np.arange(n_frames) * pcfg.hop_len_w)[:, None] + np.arange(n)
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(pitch_op._trans_matrix(pcfg)).to(device),
            torch.arange(pcfg.n_lags, device=device))


def chunk_span(pcfg: PitchConfig, n_frames: int) -> int:
    """Work samples one chunk of ``n_frames`` frames reads."""
    return pcfg.frame_len_w + pcfg.max_lag + (n_frames - 1) * pcfg.hop_len_w


def chunk_energies(buf: torch.Tensor, n_frames: int,
                   pcfg: PitchConfig) -> torch.Tensor:
    """(span,) chunk buffer -> (n_frames,) window energies e0: the prefix
    sum of the squared extended frame at w - 1, as the reference's
    ``_chunk_nccf`` takes it, in float64 rounded once (``ops/pitch``'s
    prefix sums: CUDA's float32 cumsum keeps a float32 running sum)."""
    E = buf[_consts(pcfg, n_frames, buf.device)[0]]
    return torch.cumsum(E * E, dim=-1, dtype=torch.float64)[
        :, pcfg.frame_len_w - 1].to(torch.float32)


def chunk_nccf(buf: torch.Tensor, n_frames: int, pcfg: PitchConfig,
               ball: torch.Tensor, backend: str = "auto", *,
               precision: str = backend_lib.KEYWORD_PRECISION):
    """(span,) chunk buffer + (1,) ballast (pcfg.ballast * mean_e^2) ->
    ((n_frames, n_lags) ballasted NCCF, (n_frames, n_lags) plain NCCF):
    ``fused_nccf`` at B = 1 on "cuda", the plain ``ops/pitch.nccf`` at
    the mode ``precision`` on "torch" (the reference's ``_chunk_nccf``
    takes one; its ``online_chunk_step`` passes HIGHEST, as this
    module's does)."""
    if backend_lib.resolve(backend, buf, None) == "cuda":
        from ..ops.kernels import fused_nccf
        nb, npl = fused_nccf.fused_nccf(buf[None], ball, pcfg, T=n_frames)
    else:
        mask = torch.ones((1, n_frames), dtype=torch.bool, device=buf.device)
        nb, npl = pitch_op.nccf(buf[None], pcfg, mask, precision=precision,
                                ball=ball)
    return nb[0], npl[0]


def online_chunk_step(state: OnlineChunkState, buf: torch.Tensor,
                      n_valid: int, pcfg: PitchConfig, n_frames: int,
                      backend: str = "auto"):
    """Score one chunk of up to ``n_frames`` frames; tail chunks pass
    ``n_valid < n_frames``, and frames at or past it (they read the
    buffer's zero padding) leave the cost and the statistics untouched.
    -> (state', (n_frames, n_lags) int32 backpointers, (n_frames, n_lags)
    plain NCCF), on the state's device."""
    dev = state.cost.device
    # causal ballast: the running mean including this chunk's valid frames
    e0 = chunk_energies(buf, n_frames, pcfg)
    e_sum = state.e_sum + e0[:n_valid].sum()
    e_cnt = state.e_cnt + float(n_valid)
    mean_e = e_sum / torch.clamp(e_cnt, min=1.0)
    ball = (pcfg.ballast * mean_e * mean_e).reshape(1)
    nccf_b, nccf_p = chunk_nccf(buf, n_frames, pcfg, ball, backend)

    _, trans, self_ptr = _consts(pcfg, n_frames, dev)   # trans: (j, i)
    cost, started = state.cost, state.started
    ptrs = []
    for i in range(n_valid):
        tot_min, arg = torch.min(cost[:, None] + trans, dim=0)  # first index
        if i == 0:
            # a stream's first valid frame starts fresh: cost -s_0, the
            # identity backpointers; every later frame has started
            go = started > 0
            cost = torch.where(go, tot_min, 0.0) - nccf_b[0]
            arg = torch.where(go, arg, self_ptr)
            started = torch.ones_like(started)
        else:
            cost = tot_min - nccf_b[i]
        ptrs.append(arg)
    ptrs += [self_ptr] * (n_frames - n_valid)
    return (OnlineChunkState(cost, e_sum, e_cnt, started),
            torch.stack(ptrs).to(torch.int32), nccf_p)


class OnlinePitch:
    """Streaming pitch front end: feed raw audio at ``pcfg.sample_rate`` in
    pieces of any size, receive finalized (k, 3) rows [pov, causally
    normalized log pitch, delta log pitch] at most ``delay`` frames (plus
    one chunk and the resampler's buffering) behind.  :meth:`flush` ends
    the stream and returns the rest.

    ``device``: where the chunk steps run ("cuda" by default: the NCCF
    through the ``fused_nccf`` kernel; "cpu": the plain chunk NCCF)."""

    def __init__(self, pcfg: PitchConfig, delay: int = 50,
                 chunk_frames: int = 16, device="cuda"):
        self.pcfg = pcfg.validate()
        self.delay = int(delay)
        self.F = int(chunk_frames)
        self.device = backend_lib.require_device(device)
        self.rs = (StreamingResampler(pcfg.sample_rate, pcfg.work_rate)
                   if pcfg.work_rate != pcfg.sample_rate else None)
        self.need = pcfg.frame_len_w + pcfg.max_lag
        self.hop = pcfg.hop_len_w
        self.span = chunk_span(pcfg, self.F)
        self._work = np.zeros((0,), np.float64)   # unconsumed work samples
        self._state = init_chunk_state(pcfg, self.device)
        self._cost = np.zeros((pcfg.n_lags,), np.float32)  # host copy
        # ring buffers, pruned behind the finalization point
        self._back: list[np.ndarray] = []         # per-frame backpointers
        self._nccf: list[np.ndarray] = []         # per-frame plain NCCF
        self._tbase = 0                           # global frame of _back[0]
        self._scored = 0                          # frames scored
        self._done = 0                            # frames finalized
        self._logf0: list[float] = []             # finalized log-f0 tail
        self._wgt: list[float] = []               # finalized POV^2 weights
        self._vbase = 0                           # global frame of _logf0[0]
        self._flushed = False
        self.chunks = 0                           # device chunk steps run

    @classmethod
    def from_jax(cls, op, device="cuda") -> "OnlinePitch":
        """A fresh tracker with a JAX ``OnlinePitch``'s configuration
        (its ``PitchConfig`` through ``config.from_jax``, delay and chunk
        size)."""
        return cls(from_jax(op.pcfg), delay=op.delay, chunk_frames=op.F,
                   device=device)

    def feed(self, chunk: np.ndarray) -> np.ndarray:
        """Raw samples -> (k, 3) finalized rows (k may be 0).  Rows are
        finalized after each internal chunk, so the emission schedule
        depends on chunk_frames and delay only, never on feed sizes."""
        if self._flushed:
            raise RuntimeError("feed after flush")
        xw = (self.rs.feed(np.asarray(chunk, np.float64)) if self.rs
              else np.asarray(chunk, np.float64))
        self._work = np.concatenate([self._work, xw])
        return self._score_available()

    def flush(self) -> np.ndarray:
        """End of stream: the resampler's tail and the final Viterbi
        termination."""
        if self._flushed:
            raise RuntimeError("flush after flush")
        if self.rs is not None:
            self._work = np.concatenate([self._work, self.rs.flush()])
        self._flushed = True
        rows = [self._score_available()]
        rows.append(self._finalize(upto=self._scored))
        return np.concatenate(rows)

    def _score_available(self) -> np.ndarray:
        """Run chunk steps over every complete frame; finalize up to
        scored - delay after each chunk."""
        rows = []
        while True:
            avail = (len(self._work) - self.need) // self.hop + 1
            if avail <= 0 or (avail < self.F and not self._flushed):
                break                     # wait for a full chunk
            nv = min(avail, self.F)
            buf = np.zeros((self.span,), np.float32)
            have = min(len(self._work), self.span)
            buf[:have] = self._work[:have]
            self._state, back, nccf_p = online_chunk_step(
                self._state, torch.from_numpy(buf).to(self.device), nv,
                self.pcfg, self.F)
            # one fetch a chunk: backpointers, plain NCCF, the cost
            back, nccf_p = back[:nv].cpu().numpy(), nccf_p[:nv].cpu().numpy()
            self._cost = self._state.cost.cpu().numpy()
            self.chunks += 1
            self._back.extend(back)
            self._nccf.extend(nccf_p)
            self._scored += nv
            self._work = self._work[nv * self.hop:]
            rows.append(self._finalize(upto=self._scored - self.delay))
        return (np.concatenate(rows) if rows
                else np.zeros((0, 3), np.float32))

    def _finalize(self, upto: int) -> np.ndarray:
        upto = max(min(upto, self._scored), 0)
        if upto <= self._done:
            return np.zeros((0, 3), np.float32)
        # backtrace from the current best terminal state to frame done
        path_end = self._scored - 1
        s = int(np.argmin(self._cost))
        path = {path_end: s}
        for t in range(path_end, self._done, -1):
            s = int(self._back[t - self._tbase][s])
            path[t - 1] = s
        pcfg = self.pcfg
        lag_of = {}

        def log_f0(t):
            if t in lag_of:
                return lag_of[t]
            p = path[t]
            d = oracle._parabolic_lag(self._nccf[t - self._tbase], p)
            v = float(np.log(pcfg.work_rate / (pcfg.min_lag + p + d)))
            lag_of[t] = v
            return v

        def value(u):
            return (self._logf0[u - self._vbase] if u < self._done
                    else log_f0(u))

        rows = []
        W, D = pcfg.norm_window, pcfg.delta_window
        denom = 2.0 * sum(k * k for k in range(1, D + 1))
        for t in range(self._done, upto):
            c = float(self._nccf[t - self._tbase][path[t]])
            lf = log_f0(t)
            self._logf0.append(lf)
            self._wgt.append(min(max(c, 0.0), 1.0) ** 2)
            lo = max(0, len(self._logf0) - W)
            wseg = np.asarray(self._wgt[lo:])
            vseg = np.asarray(self._logf0[lo:])
            sw = wseg.sum()
            norm = lf - (float((vseg * wseg).sum() / sw) if sw > 1e-12
                         else lf)
            # delta over the (possibly provisional) path, edges replicated
            d = sum(k * (value(min(t + k, self._scored - 1))
                         - value(max(t - k, 0)))
                    for k in range(1, D + 1)) / denom
            pov = float(2.0 * ((1.0001 - min(max(c, -1.0), 1.0)) ** 0.15
                               - 1.0))
            rows.append((pov, norm, d))
        self._done = upto
        # prune: entries behind `done`, and log-f0 history beyond the
        # normalization and delta windows, are dead
        tdrop = self._done - self._tbase
        if tdrop > 0:
            del self._back[:tdrop]
            del self._nccf[:tdrop]
            self._tbase = self._done
        vdrop = len(self._logf0) - (W + D)
        if vdrop > 0:
            del self._logf0[:vdrop]
            del self._wgt[:vdrop]
            self._vbase += vdrop
        return np.asarray(rows, np.float32)


# --------------------------------------------------------------------------
# float64 twin (chunk-for-chunk mirror of the deviations above)
# --------------------------------------------------------------------------

def online_pitch_np(x: np.ndarray, pcfg: PitchConfig, delay: int = 50,
                    chunk_frames: int = 16) -> np.ndarray:
    """Float64 reference for OnlinePitch (the reference's, copied): the
    same chunking, causal ballast and normalization, and delayed
    backtrace, NumPy throughout."""
    need = pcfg.frame_len_w + pcfg.max_lag
    hop, F = pcfg.hop_len_w, chunk_frames
    xw_all = (resample_poly_numpy(np.asarray(x, np.float64),
                                  pcfg.sample_rate, pcfg.work_rate)
              if pcfg.work_rate != pcfg.sample_rate
              else np.asarray(x, np.float64))
    T = 0
    if xw_all.shape[0] >= need:
        T = 1 + (xw_all.shape[0] - need) // hop
    if T == 0:
        return np.zeros((0, 3))
    lags = np.arange(pcfg.min_lag, pcfg.max_lag + 1)
    dlog = np.log(lags)[:, None] - np.log(lags)[None, :]
    trans = pcfg.penalty * dlog * dlog
    n = lags.size

    cost = np.zeros((n,))
    started = False
    e_sum = e_cnt = 0.0
    back, nccf_rows, snapshots = [], [], []
    for c0 in range(0, T, F):
        nv = min(F, T - c0)
        # chunk energies first (causal ballast includes this chunk)
        e0s, nums, elags = [], [], []
        for i in range(nv):
            t = c0 + i
            a = xw_all[t * hop: t * hop + pcfg.frame_len_w]
            e0s.append((a * a).sum())
            row_num = np.empty((n,))
            row_el = np.empty((n,))
            for j, L in enumerate(lags):
                b = xw_all[t * hop + L: t * hop + L + pcfg.frame_len_w]
                row_num[j] = (a * b).sum()
                row_el[j] = (b * b).sum()
            nums.append(row_num)
            elags.append(row_el)
        e_sum += sum(e0s)
        e_cnt += nv
        mean_e = e_sum / max(e_cnt, 1.0)
        for i in range(nv):
            prod = np.maximum(e0s[i] * elags[i], 1e-30)
            nb = nums[i] / np.sqrt(prod + pcfg.ballast * mean_e * mean_e)
            npl = nums[i] / np.sqrt(prod)
            nccf_rows.append(npl)
            if not started:
                cost = -nb
                back.append(np.arange(n, dtype=np.int64))
                started = True
            else:
                tot = cost[:, None] + trans
                back.append(np.argmin(tot, axis=0))
                cost = tot[back[-1], np.arange(n)] - nb
        snapshots.append((c0 + nv, cost.copy()))

    # emission loop with the same delayed backtrace
    done = 0
    logf0s, wgts, rows = [], [], []

    def finalize(upto, cost_now, scored):
        nonlocal done
        upto = max(min(upto, scored), 0)
        if upto <= done:
            return
        s = int(np.argmin(cost_now))
        path = {scored - 1: s}
        for t in range(scored - 1, done, -1):
            s = int(back[t][s])
            path[t - 1] = s

        def lf_at(t):
            if t < done:
                return logf0s[t]
            p = path[t]
            d = oracle._parabolic_lag(nccf_rows[t], p)
            return float(np.log(pcfg.work_rate / (pcfg.min_lag + p + d)))

        for t in range(done, upto):
            c = float(nccf_rows[t][path[t]])
            lf = lf_at(t)
            logf0s.append(lf)
            wgts.append(min(max(c, 0.0), 1.0) ** 2)
            lo = max(0, len(logf0s) - pcfg.norm_window)
            wseg = np.asarray(wgts[lo:])
            vseg = np.asarray(logf0s[lo:])
            sw = wseg.sum()
            norm = lf - (float((vseg * wseg).sum() / sw) if sw > 1e-12
                         else lf)
            D = pcfg.delta_window
            denom = 2.0 * sum(k * k for k in range(1, D + 1))
            d = sum(k * (lf_at(min(t + k, scored - 1))
                         - lf_at(max(t - k, 0)))
                    for k in range(1, D + 1)) / denom
            pov = float(2.0 * ((1.0001 - min(max(c, -1.0), 1.0)) ** 0.15
                               - 1.0))
            rows.append((pov, norm, d))
            done = t + 1

    # replay the emission schedule: after scoring the chunk ending at
    # frame G, frames up to G - delay finalize from that chunk's cost
    # snapshot; flush finalizes the rest from the final cost
    for scored, cost_snap in snapshots:
        finalize(scored - delay, cost_snap, scored)
    finalize(T, cost, T)
    return np.asarray(rows, np.float64)
