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


def mul_add(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
            cast: bool = False) -> torch.Tensor:
    """a * b + c in a's dtype, rounded as the reference's XLA rounds it on
    the CPU, or with ``cast`` as the float32 op that takes it next reads
    it (the float32 result):

    - float16: once (its LLVM contracts a half product into the add that
      takes it, in float32, where a product of two halves is exact:
      measured on ``_dit_combine``, this form misses JAX on 1e-5 of the
      elements where a rounding after each op misses 27 %);
    - bfloat16: after each op (XLA's float normalization converts after
      every bfloat16 op), but where a cast to float32 follows, the sum is
      not rounded: XLA's excess precision drops the rounding between an
      op and the cast that takes it (measured: 100 % of a x b + c read
      unrounded by a float32 maximum, 46 % had it been rounded);
    - float32: after each op."""
    f = torch.float32
    if a.dtype == torch.float16:
        out = (a.to(f) * b.to(f) + c.to(f)).to(torch.float16)
    elif a.dtype == torch.bfloat16 and cast:
        out = (a * b).to(f) + c.to(f)
    else:
        out = a * b + c
    return out.to(f) if cast else out


def xla_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max(a, b) as XLA computes its maximum: ``a`` where a >= b or a is
    NaN, else ``b``, so that a NaN keeps its bits.  torch.maximum and
    torch.amax return a NaN of their own (0xFFFFFFFF on the CPU's vector
    lanes), which the accurate log reads as ~89.42 where the reference's
    x86 NaN (0xFFC00000) reads ~89.13."""
    return torch.where((a >= b) | torch.isnan(a), a, b)


def xla_amax(x: torch.Tensor) -> torch.Tensor:
    """torch.amax(x, -1, keepdim=True) as XLA's reduce computes it: a row
    holding a NaN gives a NaN of that row, with its bits (its first)."""
    nan = torch.isnan(x)
    first = torch.gather(x, -1, nan.to(torch.uint8).argmax(-1, keepdim=True))
    return torch.where(nan.any(-1, keepdim=True), first,
                       torch.amax(x, dim=-1, keepdim=True))


def floored_log(x: torch.Tensor, floor: float) -> torch.Tensor:
    """log(max(x, floor)) with the accurate log.  x is cast to float32
    first, as the reference's ``jnp.maximum(x, float32 floor)`` promotes
    it: a bfloat16 or float16 x against the floor in its own dtype would
    floor at 1.0004e-10 or at 0 (1e-10 underflows float16, so a floored
    element would read log(0) = -88.03 instead of -23.03)."""
    return accurate_log(xla_max(
        x.to(torch.float32),
        torch.tensor(floor, dtype=torch.float32, device=x.device)))
