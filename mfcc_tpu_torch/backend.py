"""Execution backends: ``auto | torch | cuda``, and the precision modes.

- ``torch`` — the plain PyTorch path (ATen ops; CPU or GPU).  It is the
  differential twin of every kernel.
- ``cuda``  — the hand-written Hopper kernels.  Raises on a CPU tensor.
- ``auto``  — the kernels for a CUDA tensor, the plain path for a CPU
  tensor.  The choice is made from the tensor's device and the config,
  never by catching a failure.

Mirrors ``mfcc_tpu/backend.py``.  On "cuda" the spectral features follow
the reference's kernel route (``ops/kernels/routes.py``: its eligibility
predicates, which are Mosaic lane-layout rules, plus its <= 50 dB accuracy
rule), so that each config reaches the counterpart of the kernel the
reference gives it.  The rules decide the route only: they are no capacity
limits, and every Hopper kernel takes every valid-mode config.  Inside
each kernel the config picks the tile (``routes.py`` sets it out): at a
power-of-two n_fft the FFT tile, in f32 for cepstra and log-mel bounded to
<= 50 dB and with a float64 front for unbounded log-mel, else the direct
(or DIT) tile.

Precision modes (``FeatureConfig.matmul_precision``, the reference's
``jax.lax.Precision`` names) set how :func:`matmul` multiplies float32
matrices:

- on a CPU tensor every mode is IEEE fp32, as XLA:CPU computes all three;
- on a CUDA tensor "highest" and "high" are IEEE fp32, "default" one TF32
  tensor-core product.

"high" needs an error within the TPU's bf16x3 bound (2.8e-4 against the
oracle), which IEEE fp32 meets.  The TF32 split the mode suggests (hi.hi +
hi.lo + lo.hi, three TF32 products over a 13-bit split) was measured on
the DFT product of the bench batch, (63,872, 400) x (400, 514), by
``chip_smoke.py`` phase 18 (NVIDIA H100 80GB HBM3, 700.00 W): it is both
slower (1.94x the IEEE fp32 product's time) and less accurate (1.49x its
error against float64), so the port keeps one float32 form for both.
"default" is one TF32 product: TF32 keeps 10 mantissa bits to bf16's 7, so
it is at least as accurate as the TPU's one bf16 pass, whose error against
the oracle bounds it.  The forms hold only inside :func:`matmul_form`,
which restores the caller's flags; nothing sets them for the process.  The
spectral kernels have no matrix product for a mode to change; "high" is
routed away from them (:func:`resolve`), as the reference routes it away
from Mosaic.  ``compute_dtype="bfloat16"`` rounds the DFT's operands
(``ops/spectrum``).

The accumulation dtype (``FeatureConfig.accum_dtype``, :data:`ACCUM_DTYPES`)
is the dtype the plain route casts the DFT's real and imaginary parts to,
squares and adds them in, and rounds the filterbank and DCT matrices to
(``ops/spectrum``, ``ops/mel``, ``ops/dct``, ``ops/plp``): the reference's
XLA casts at its sites.  The kernels never read it, as the reference's
Pallas kernels do not: on the card "auto" and "cuda" give the float32
features whatever it says.  "float64" is float32, as JAX computes it
without its x64 mode (which the reference never enables), with a warning.
Any other name raises ValueError, where the reference passes it to
``jnp.dtype``.
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch

BACKENDS = ("auto", "torch", "cuda")
PRECISIONS = ("highest", "high", "default")
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ACCUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "float64": torch.float32}
# the reference's default for the ``precision=`` keywords of the pitch,
# resampling and augmentation functions, which take no FeatureConfig
KEYWORD_PRECISION = "highest"


def check_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(f"matmul precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    return precision


def check_config(cfg) -> None:
    """Raise ValueError for a numerics setting the port does not compute:
    an unknown mode, compute dtype or accumulation dtype.  Warns that
    accum_dtype "float64" computes in float32."""
    check_precision(cfg.matmul_precision)
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of "
                         f"{tuple(COMPUTE_DTYPES)}, got {cfg.compute_dtype!r}")
    if cfg.accum_dtype not in ACCUM_DTYPES:
        raise ValueError(f"accum_dtype must be one of "
                         f"{tuple(ACCUM_DTYPES)}, got {cfg.accum_dtype!r}")
    if cfg.accum_dtype == "float64":
        warnings.warn("accum_dtype='float64' computes in float32, as the "
                      "reference does (JAX without x64 mode)", UserWarning,
                      stacklevel=2)


def accum_dtype(cfg) -> torch.dtype:
    """The torch dtype the plain route accumulates in for cfg."""
    return ACCUM_DTYPES[cfg.accum_dtype]


def constant(a: np.ndarray, dtype: torch.dtype,
             device=None) -> torch.Tensor:
    """A float64 constant rounded once to ``dtype``, as JAX's
    ``jnp.asarray(a, dtype)`` rounds it (torch's own float64 -> float16
    cast goes through float32 and can round twice)."""
    if dtype == torch.float16:
        t = torch.from_numpy(np.asarray(a, np.float16))
    elif dtype == torch.float32:
        t = torch.from_numpy(np.asarray(a, np.float32))
    else:
        t = torch.from_numpy(np.asarray(a, np.float64)).to(dtype)
    return t.to(device)


def resolve(name: str, x: torch.Tensor, cfg) -> str:
    """Backend for input ``x`` and ``cfg``: "torch" or "cuda".  A config
    whose mode the kernels do not take (``routes.kernel_precision_supported``:
    "high") resolves "auto" and "cuda" to "torch" on a CUDA tensor, as the
    reference's ``resolve`` sends it from "pallas" to "xla".  ``cfg`` is
    None only for the pitch path, whose kernels fix their own precision
    (a PitchConfig has no mode)."""
    if name not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {name!r}")
    if name == "cuda" and not x.is_cuda:
        raise ValueError("backend='cuda' needs a CUDA tensor, got one on "
                         f"{x.device}")
    if name == "torch" or not x.is_cuda:
        return "torch"
    # imported here: ops.kernels imports this module
    from .ops.kernels.routes import kernel_precision_supported
    return ("cuda" if cfg is None or kernel_precision_supported(cfg)
            else "torch")


def require_device(name) -> torch.device:
    """torch.device(name), raising when it names a card and none is
    available: an entry point runs on the host only when asked."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to compute on the host")
    return dev


def matmul_flags() -> tuple:
    """(float32 matmul precision, allow_tf32,
    allow_bf16_reduced_precision_reduction,
    allow_fp16_reduced_precision_reduction): the flags a form sets."""
    m = torch.backends.cuda.matmul
    return (torch.get_float32_matmul_precision(), m.allow_tf32,
            m.allow_bf16_reduced_precision_reduction,
            m.allow_fp16_reduced_precision_reduction)


@contextlib.contextmanager
def matmul_form(precision: str):
    """Float32 matmuls inside run on TF32 tensor cores ("default") or in
    IEEE fp32 ("highest", "high"); bf16 and fp16 products keep float32
    reductions, as XLA accumulates them.  The caller's flags are restored
    after."""
    tf32 = check_precision(precision) == "default"
    want = ("high" if tf32 else "highest", tf32, False, False)
    saved = matmul_flags()
    m = torch.backends.cuda.matmul
    torch.set_float32_matmul_precision(want[0])
    m.allow_tf32 = tf32
    m.allow_bf16_reduced_precision_reduction = False
    m.allow_fp16_reduced_precision_reduction = False
    try:
        if matmul_flags() != want:
            raise RuntimeError(f"matmul flags could not be set for "
                               f"{precision!r}: {matmul_flags()}")
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        m.allow_tf32 = saved[1]
        m.allow_bf16_reduced_precision_reduction = saved[2]
        m.allow_fp16_reduced_precision_reduction = saved[3]


def matmul(a: torch.Tensor, b: torch.Tensor,
           precision: str = "highest") -> torch.Tensor:
    """The one place the plain path multiplies matrices, at a mode
    (:data:`PRECISIONS`; see the module docstring).

    "highest" is the f32 contract (true fp32 products): TF32 keeps ~3
    decimal digits, which the log stage turns into errors far above the
    1e-4 feature tolerance.  "high" is IEEE fp32 too.  On a CUDA tensor
    "default" is one TF32 product; on a CPU tensor it is IEEE fp32.
    bfloat16 operands give their bfloat16 product (float32 sums inside).
    The flags are set for the call and restored after it."""
    check_precision(precision)
    with matmul_form(precision if a.is_cuda else "highest"):
        return torch.matmul(a, b)
