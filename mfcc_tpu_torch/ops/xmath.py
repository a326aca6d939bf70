"""Accurate float32 log (twin of ``mfcc_tpu/ops/xmath.py``).

Exact exponent extraction from the int32 bit view, the mantissa centred
into [sqrt(2)/2, sqrt(2)), and a Horner atanh series:

    x = m * 2^e,  r = (m - 1) / (m + 1),
    log(x) = e * ln2 + 2 * (r + r^3/3 + r^5/5 + r^7/7 + r^9/9)

Every step is one correctly rounded f32 operation in the reference's
order, so the result is bit-identical to the JAX function on the CPU and
to the CUDA kernel's ``acc_log`` (which spells each step with ``__fmul_rn``
/ ``__fadd_rn`` / ``__fdiv_rn`` so that nvcc contracts nothing).  Valid for
finite x > 0; callers floor first.
"""

from __future__ import annotations

import numpy as np
import torch

# the reference's Python-float constants as the f32 values its weak-typed
# arithmetic rounds them to
_LN2 = float(np.float32(np.log(2.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
_C9, _C7, _C5, _C3 = (float(np.float32(c))
                      for c in (2.0 / 9.0, 2.0 / 7.0, 2.0 / 5.0, 2.0 / 3.0))


def _acc_log(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)
    bits = x.contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32)
    big = m >= f32(_SQRT2)
    m = torch.where(big, m * f32(0.5), m)
    e = (e + big.to(torch.int32)).to(torch.float32)
    one = f32(1.0)
    r = (m - one) / (m + one)
    r2 = r * r
    p = f32(_C9) * r2 + f32(_C7)
    p = p * r2 + f32(_C5)
    p = p * r2 + f32(_C3)
    p = p * r2 + f32(2.0)
    return e * f32(_LN2) + r * p


class _AccurateLog(torch.autograd.Function):
    """The bit-view chain has no derivative; the backward is the analytic
    d/dx log(x) = 1/x (the reference's custom JVP)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _acc_log(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad / x


def accurate_log(x: torch.Tensor) -> torch.Tensor:
    """Accurate natural log for finite positive float32 inputs."""
    return _AccurateLog.apply(x)


def floored_log(x: torch.Tensor, floor: float) -> torch.Tensor:
    """log(max(x, floor)) with the accurate log."""
    return accurate_log(torch.maximum(
        x, torch.tensor(floor, dtype=torch.float32, device=x.device)))
