"""Trainable MFCC-style front end with a learnable filterbank (twin of
``mfcc_tpu/models/trainable.py``).

The mel filterbank and the per-band compression floor are parameters,
initialized at the classic HTK values, so the front end can be fine-tuned
against a downstream loss; the built-in objective is the MSE to target
features.  The forward pass is plain PyTorch on the parameters' device:
framing, pre-emphasis and the power spectrum (``ops/framing``,
``ops/spectrum``), the learnable mel product through ``backend.matmul``
(IEEE fp32), the softplus floor, ``xmath.accurate_log`` (its autograd
Function carries the analytic 1/x) and the DCT.  The reference computes
this product outside Pallas too, so no kernel is involved, and no kernel
has a backward.

optax becomes ``torch.optim``: Adam (beta 0.9 / 0.999, eps 1e-8) behind a
global-norm clip written as optax writes it, with optax's closed-form
cosine decay as a ``LambdaLR``.  A checkpoint is the reference's NPZ (the
same keys and config hash), so either package loads the other's.

Not ported here: ``param_shardings`` (the dp x tp sharding of the
reference's multichip dry run; ROADMAP.md, modules to port, item 8).
"""

from __future__ import annotations

import io
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import backend
from ..config import FeatureConfig
from ..ops import dct as dct_op, framing, spectrum, xmath
from ..ops.mel import mel_matrix
from ..utils.manifest import _atomic_write


class FrontendParams(torch.nn.Module):
    """The learnable filterbank ``mel_w`` (n_bins, n_mels) and the raw
    softplus floors ``log_floor`` (n_mels,), copied from the tensors
    given (training updates them in place)."""

    def __init__(self, mel_w: torch.Tensor, log_floor: torch.Tensor):
        super().__init__()
        self.mel_w = torch.nn.Parameter(
            mel_w.detach().to(torch.float32, copy=True))
        self.log_floor = torch.nn.Parameter(
            log_floor.detach().to(torch.float32, copy=True))

    def forward(self, audio: torch.Tensor, cfg: FeatureConfig):
        return forward(self, audio, cfg)


def init_params(cfg: FeatureConfig, device="cuda") -> FrontendParams:
    """The classic pipeline's filterbank, and floors whose softplus is
    cfg.log_floor."""
    dev = backend.require_device(device)
    raw = np.log(np.expm1(max(cfg.log_floor, 1e-12)))
    return FrontendParams(
        torch.from_numpy(mel_matrix(cfg).astype(np.float32)),
        torch.full((cfg.n_mels,), raw, dtype=torch.float32)).to(dev)


def params_from_jax(params, device="cuda") -> FrontendParams:
    """A JAX ``FrontendParams`` (or anything with ``mel_w`` and
    ``log_floor`` arrays) as the port's, on ``device``."""
    dev = backend.require_device(device)
    return FrontendParams(
        torch.from_numpy(np.array(params.mel_w, np.float32)),
        torch.from_numpy(np.array(params.log_floor, np.float32))).to(dev)


def forward(params: FrontendParams, audio: torch.Tensor,
            cfg: FeatureConfig) -> torch.Tensor:
    """(B, N) full-length rows -> (B, T, n_mfcc) with the learnable
    filterbank (no ragged lengths, so centre mode resolves statically)."""
    audio, cfg = framing.resolve_frame_mode_static(audio, cfg)
    y = framing.preemphasize(audio.to(torch.float32), cfg)
    power = spectrum.power_spectrum(framing.frames(y, cfg), cfg)
    floor = F.softplus(params.log_floor)
    energies = backend.matmul(power, params.mel_w)
    logmel = xmath.accurate_log(torch.maximum(energies, floor))
    return dct_op.cepstra(logmel, cfg)


def loss_fn(params: FrontendParams, audio: torch.Tensor,
            target: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    return torch.mean((forward(params, audio, cfg) - target) ** 2)


def cosine_decay(step: int, decay_steps: int) -> float:
    """optax's cosine_decay_schedule factor at ``step``:
    0.5 (1 + cos(pi min(step, D) / D))."""
    return 0.5 * (1.0 + math.cos(math.pi * min(step, decay_steps)
                                 / decay_steps))


class Optimizer(NamedTuple):
    """Adam behind a global-norm clip (at ``CLIP_NORM``), with an optional
    cosine schedule (stepped after each update, so update s uses the
    factor at s)."""
    adam: torch.optim.Adam
    schedule: torch.optim.lr_scheduler.LambdaLR | None


# the global gradient norm the update is clipped to (the reference's)
CLIP_NORM = 1.0


def make_optimizer(params: FrontendParams, lr: float = 1e-3,
                   decay_steps: int | None = None) -> Optimizer:
    """Adam (beta 0.9 / 0.999, eps 1e-8) with global-norm clipping (the
    1/E gradient through the log spans orders of magnitude across bands)
    and, with ``decay_steps``, cosine decay to 0."""
    adam = torch.optim.Adam(params.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)
    sched = None if decay_steps is None else \
        torch.optim.lr_scheduler.LambdaLR(
            adam, lambda s: cosine_decay(s, decay_steps))
    return Optimizer(adam, sched)


def clip_by_global_norm_(grads: list, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: each g becomes g / |g| *
    max_norm where the global norm |g| >= max_norm (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``); no host synchronization."""
    g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / g_norm * max_norm))


def train_step(params: FrontendParams, opt: Optimizer, audio: torch.Tensor,
               target: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """One update in place -> the loss before it (a 0-d tensor, not
    synchronized).  Ends with the projection mel_w >= 0: a negative
    filter weight floor-clamps its band (a dead band and a loss spike)."""
    opt.adam.zero_grad(set_to_none=False)
    with backend.ieee_fp32():          # the backward's products too
        loss = loss_fn(params, audio, target, cfg)
        loss.backward()
    clip_by_global_norm_([p.grad for p in params.parameters()], CLIP_NORM)
    opt.adam.step()
    if opt.schedule is not None:
        opt.schedule.step()
    with torch.no_grad():
        params.mel_w.clamp_(min=0.0)
    return loss.detach()


def save_params(path: str, params: FrontendParams, cfg: FeatureConfig):
    """Checkpoint the front end: an atomic NPZ with the reference's keys
    (mel_w, log_floor, config_hash)."""
    buf = io.BytesIO()
    np.savez(buf, mel_w=params.mel_w.detach().cpu().numpy(),
             log_floor=params.log_floor.detach().cpu().numpy(),
             config_hash=np.asarray(cfg.config_hash()))
    _atomic_write(path, buf.getvalue())


def load_params(path: str, cfg: FeatureConfig,
                device="cuda") -> FrontendParams:
    """A checkpoint of either package, on ``device``; one trained under
    another FeatureConfig raises."""
    with np.load(path) as z:
        if str(z["config_hash"]) != cfg.config_hash():
            raise ValueError(
                "checkpoint was trained under a different FeatureConfig")
        return FrontendParams(torch.from_numpy(z["mel_w"]),
                              torch.from_numpy(z["log_floor"])).to(
            backend.require_device(device))


def fit(audio: np.ndarray, target: np.ndarray, cfg: FeatureConfig,
        steps: int = 100, lr: float = 1e-3, device="cuda"):
    """Single-process fit loop from the classic init, cosine-decayed over
    ``steps`` -> (params, per-step losses as floats)."""
    params = init_params(cfg, device)
    opt = make_optimizer(params, lr, decay_steps=steps)
    dev = params.mel_w.device
    audio = torch.as_tensor(audio).to(dev)
    target = torch.as_tensor(target).to(dev)
    losses = [train_step(params, opt, audio, target, cfg)
              for _ in range(steps)]
    return params, torch.stack(losses).tolist() if losses else []
