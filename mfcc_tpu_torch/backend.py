"""Execution backends: ``auto | torch | cuda``.

- ``torch`` — the plain PyTorch path (ATen ops; CPU or GPU).  It is the
  differential twin of every kernel.
- ``cuda``  — the hand-written Hopper kernels.  Raises on a CPU tensor.
- ``auto``  — the kernels for a CUDA tensor, the plain path for a CPU
  tensor.  The choice is made from the tensor's device alone, never by
  catching a failure.

Mirrors ``mfcc_tpu/backend.py``.  On "cuda" the spectral features follow
the reference's kernel route (``ops/kernels/routes.py``: its eligibility
predicates, which are Mosaic lane-layout rules, plus its <= 50 dB accuracy
rule), so that each config reaches the counterpart of the kernel the
reference gives it.  The rules decide the route only: they are no capacity
limits, and every Hopper kernel takes every valid-mode config.  Inside
each kernel the config picks the tile (``routes.py`` sets it out): at a
power-of-two n_fft the FFT tile, in f32 for cepstra and log-mel bounded to
<= 50 dB and with a float64 front for unbounded log-mel, else the direct
(or DIT) tile.  Configs the port has not reached yet raise
``NotImplementedError`` here, naming the ROADMAP item.
"""

from __future__ import annotations

import contextlib

import torch

BACKENDS = ("auto", "torch", "cuda")


def check_config(cfg) -> None:
    """Raise NotImplementedError for configs outside the ported slice."""
    if cfg.matmul_precision != "highest":
        raise NotImplementedError(
            f"matmul_precision={cfg.matmul_precision!r} is not ported yet: "
            "only 'highest' (IEEE fp32) is (ROADMAP.md, modules to port, "
            "item 2: precision modes measured against the oracle)")
    if cfg.compute_dtype != "float32" or cfg.accum_dtype != "float32":
        raise NotImplementedError(
            "compute_dtype/accum_dtype other than float32 are not ported "
            "yet (ROADMAP.md, modules to port, item 2: precision modes)")


def resolve(name: str, x: torch.Tensor) -> str:
    """Backend for input ``x``: "torch" or "cuda"."""
    if name not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {name!r}")
    if name == "auto":
        return "cuda" if x.is_cuda else "torch"
    if name == "cuda" and not x.is_cuda:
        raise ValueError("backend='cuda' needs a CUDA tensor, got one on "
                         f"{x.device}")
    return name


def require_device(name) -> torch.device:
    """torch.device(name), raising when it names a card and none is
    available: an entry point runs on the host only when asked."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to compute on the host")
    return dev


@contextlib.contextmanager
def ieee_fp32():
    """Matmuls inside run in IEEE fp32 (no TF32); the caller's settings
    are restored after.  :func:`matmul` runs under it, and so does the
    trainable front end's backward pass."""
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The one place the plain path multiplies matrices.

    matmul_precision="highest" is the f32 contract (true fp32 products):
    TF32 keeps ~3 decimal digits, which the log stage turns into errors far
    above the 1e-4 feature tolerance.  The flags are set for the call and
    restored after it.
    """
    with ieee_fp32():
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.get_float32_matmul_precision() != "highest"):
            raise RuntimeError("fp32 matmul precision could not be pinned")
        return torch.matmul(a, b)
