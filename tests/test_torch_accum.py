"""``accum_dtype`` other than float32 (bfloat16, float16, float64) on every
feature family: the port's plain route against the reference's XLA route
on the CPU, the same numpy-seeded inputs through both.

The reference casts the DFT's real and imaginary parts to the accumulation
dtype, squares and adds them in it, rounds its mel, bark and DCT matrices
to it and floors its energies with a float32 floor (``ops/xmath``).  XLA
rounds bfloat16 after every op but the one a float32 cast takes; in
float16 its LLVM contracts a product into the add that takes it
(``xmath.mul_add``).  The port does the same at the same sites.  Its one
float32 DFT product differs from JAX's hop-block chain by ~1e-7 relative,
enough to flip the rounding of a few real or imaginary parts by one ulp,
so the bounds count ulps:

- log-mel and the spectrogram: the energies (exp of the features) within
  ULPS units in the last place of the accumulation dtype (float16's least
  spacing, 2^-24, below 2^-14, where its values are subnormal).  One
  flipped part moves its square by up to 4 ulps of the power (2 |re|
  ulp(re) <= 4 ulp(re^2)), the square's and the sum's roundings one more
  each: 6.  In the log domain 4.6e-2 in bfloat16 and 5.8e-3 in float16
  at worst, over the 7.8e-3 (bfloat16 log-mel) and 2e-3 (float16) that
  two ulps of a band would allow: a low band of 80 mels holds one or two
  bins, and the spectrogram none but one;
- cepstra and PLP (sums of logs): CEPSTRA, bfloat16 2e-2 and 1e-3, float16
  at its ulp 5e-3 and 2.5e-4 where every band energy is normal, and the
  bfloat16 bounds where one is subnormal (a subnormal float16 keeps fewer
  bits than a bfloat16);
- float16 where an energy is subnormal: the positions are the reference's;
- float16 overflowing (int16-scale audio as floats): the elements from an
  inf or NaN energy sit where the reference's do, and read as its (both
  are x86 NaNs; ``xmath.xla_max`` keeps a NaN's bits);
- float64 is float32 (JAX without x64), with a warning: equal to the
  float32 config's output, within the float32 bounds of JAX's.

The measured maxima stand beside the bounds.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfcc_tpu import FeatureConfig as JaxConfig
from mfcc_tpu.models import logmel as jax_logmel, mfcc as jax_mfcc
from mfcc_tpu.models import plp as jax_plp, spectrogram as jax_spec
from mfcc_tpu.models import streaming as jax_streaming
from mfcc_tpu.models import trainable as jax_trainable
from mfcc_tpu.ops import dct as jax_dct, framing as jax_framing
from mfcc_tpu.ops import mel as jax_mel, plp as jax_plp_op
from mfcc_tpu.ops import spectrum as jax_spectrum, xmath as jax_xmath
from mfcc_tpu_torch import backend, from_jax, oracle
from mfcc_tpu_torch.models import logmel, mfcc as mfcc_model, plp
from mfcc_tpu_torch.models import spectrogram, streaming, trainable
from mfcc_tpu_torch.ops import dct, framing, mel, spectrum, xmath
from mfcc_tpu_torch.ops.kernels import _spectral, fused_raw_dit

N, LENS = 24000, (24000, 17600)     # 2 ragged rows of 1.5 s and 1.1 s
# log of the least normal float16, 2^-14: an energy below it is subnormal
NORMAL16 = float(np.log(2.0 ** -14))
# an element above it came from an inf (88.72) or NaN (~89.13) energy
OVERFLOW = 80.0

FAMILIES = {
    # name: (port batch entry, JAX batch entry, config)
    "mfcc": (mfcc_model.mfcc_batch, jax_mfcc.mfcc_batch_jit,
             dict(n_mels=26)),
    "logmel": (logmel.log_mel_batch, jax_logmel.log_mel_batch_jit,
               dict(n_mels=80, n_mfcc=80)),
    "logmel50": (logmel.log_mel_batch, jax_logmel.log_mel_batch_jit,
                 dict(n_mels=80, n_mfcc=80, dynamic_range_db=50.0)),
    "plp": (plp.plp_batch, jax_plp.plp_batch_jit, dict()),
    "spec": (spectrogram.log_spectrogram_batch,
             jax_spec.log_spectrogram_batch_jit, dict()),
}
ORACLE = {"mfcc": oracle.mfcc, "logmel": oracle.log_mel,
          "logmel50": oracle.log_mel, "plp": oracle.plp,
          "spec": oracle.log_spectrogram}
# log-mel and the spectrogram: ulps of the energy in the accumulation dtype
# (module docstring; measured on these inputs at most 3.0, the spectrogram
# in float16; log-mel 1.0)
ULPS = 6
# cepstra and PLP, max abs: bfloat16; float16 where every band energy is
# normal; float16 where one is subnormal.  Measured: MFCC 2.6e-3 / 3.2e-4
# / 3.1e-4, PLP 1.2e-4 / none / 2.4e-5 (every PLP frame of the quiet rows
# has a subnormal bark band: the equal-loudness weights are small at the
# band edges)
CEPSTRA = {"mfcc": (2e-2, 5e-3, 2e-2), "plp": (1e-3, 2.5e-4, 1e-3)}
# float32 port vs JAX (atol, rtol): cepstra 1e-4, log-mel 1e-4 + 1e-4
# relative, PLP 1e-4, the spectrogram 2e-4 inside its window
F32_BOUNDS = {"mfcc": (1e-4, 0.0), "logmel": (1e-4, 1e-4),
              "logmel50": (1e-4, 1e-4), "plp": (1e-4, 0.0),
              "spec": (2e-4, 0.0)}
# the port's error against the float64 oracle, at most this times JAX's
ORACLE_RATIO = 1.1


def _signal(kind: str) -> np.ndarray:
    """(2, N) float32 rows, zero past LENS, made from a seed.

    "speech": harmonics of a gliding 110 Hz voice plus noise, peak 0.8;
    "quiet": 0.01 N(0, 1), whose float16 energies are in range;
    "loud": the bench signal (180 and 1200 Hz tones plus noise) at int16
    scale as floats, whose float16 power spectrum overflows."""
    g = np.random.default_rng({"speech": 11, "quiet": 12, "loud": 13}[kind])
    t = np.arange(N) / 16000.0
    if kind == "quiet":
        x = 0.01 * g.standard_normal((2, N))
    elif kind == "loud":
        base = 0.3 * np.sin(2 * np.pi * 180 * t) + 0.1 * np.sin(
            2 * np.pi * 1200 * t)
        x = 32768.0 * (base + 0.02 * g.standard_normal((2, N)))
    else:
        f0 = 110.0 * (1.0 + 0.3 * np.sin(2 * np.pi * 2.5 * t))
        ph = np.cumsum(f0) / 16000.0
        x = sum((0.5 / k) * np.sin(2 * np.pi * k * ph) for k in range(1, 6))
        x = x + 0.01 * g.standard_normal((2, N))
        x = 0.8 * x / np.abs(x).max()
    x = x.astype(np.float32)
    for i, n in enumerate(LENS):
        x[i, n:] = 0.0
    return x


CASES = {  # name: (accum_dtype, signal)
    "bfloat16": ("bfloat16", "speech"), "float16": ("float16", "quiet"),
    "float16_overflow": ("float16", "loud"), "float64": ("float64", "speech"),
}


def _jax_config(family: str, accum: str, **kw) -> JaxConfig:
    return JaxConfig(accum_dtype=accum, **FAMILIES[family][2], **kw)


@functools.lru_cache(maxsize=None)
def _run(family: str, case: str):
    """-> (port features, JAX features, mask) of one family and case, the
    features of the valid frames only (float64 under JAX computes float32
    and warns, as the port does)."""
    accum, kind = CASES[case]
    port_fn, jax_fn, _ = FAMILIES[family]
    x, lens = _signal(kind), np.asarray(LENS, np.int32)
    jc = _jax_config(family, accum)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        want, _, m = jax_fn(jnp.asarray(x), jnp.asarray(lens), jc, "xla")
        got, _, tm = port_fn(torch.from_numpy(x), torch.from_numpy(lens),
                             from_jax(jc))
    m = np.asarray(m)
    assert np.array_equal(m, tm.numpy())
    return got.numpy()[m], np.asarray(want)[m], m


@functools.lru_cache(maxsize=None)
def _energies(family: str, case: str):
    """The floored log band energies (mel or bark; the spectrogram's own
    output) of the valid frames, (JAX's, the port's): JAX's recomputed
    from its stages, the port's from its plain chain."""
    accum, kind = CASES[case]
    x, lens = _signal(kind), np.asarray(LENS, np.int32)
    jc = _jax_config(family, accum)
    if family in ("logmel", "logmel50", "spec"):
        got, want, _ = _run(family, case)
        return want, got
    m = _run(family, case)[2]
    cfg = from_jax(jc)
    if family == "mfcc":
        want = np.asarray(jax_logmel.log_mel_batch_jit(
            jnp.asarray(x), jnp.asarray(lens), jc, "xla")[0])
        got = logmel.log_mel_batch(torch.from_numpy(x),
                                   torch.from_numpy(lens), cfg)[0].numpy()
        return want[m], got[m]

    @jax.jit
    def bark(x):
        p_lo, p_hi = jax_spectrum.power_spectrum_split(
            jax_framing.preemphasize(x, jc), jc)
        acc = jnp.dtype(jc.accum_dtype)
        fb = jnp.asarray(jax_plp_op._plp_matrices(jc)[0].T, acc)
        e = jnp.matmul(p_lo, fb[:-1], precision=jax.lax.Precision.HIGHEST)
        return jax_xmath.floored_log(e + p_hi * fb[-1][None, :],
                                     jc.log_floor)

    want = np.asarray(bark(jnp.asarray(x)))
    y = framing.preemphasize(torch.from_numpy(x), cfg)
    got = _spectral.plain_features(y, cfg, False, projection="bark").numpy()
    T = m.shape[1]
    return want[:, :T][m], got[:, :T][m]


def _energy_ulps(got: np.ndarray, want: np.ndarray, accum: str):
    """|e_got - e_want| in units in the last place of the larger energy
    in the accumulation dtype, e = exp(feature) (float16: at least its
    least subnormal spacing, 2^-24)."""
    eg, ew = (np.exp(np.asarray(v, np.float64)) for v in (got, want))
    e = np.maximum(eg, ew)
    ulp = 2.0 ** (np.floor(np.log2(e)) - (7 if accum == "bfloat16" else 10))
    if accum == "float16":
        ulp = np.maximum(ulp, 2.0 ** -24)
    return np.abs(eg - ew) / ulp


def _check(family: str, accum: str, got, want, normal=None) -> None:
    """got within the family's bound of want in ``accum``: log-mel and the
    spectrogram ULPS of their energies (the spectrogram inside the 50 dB
    window of want's own frames), cepstra and PLP CEPSTRA (in float16 by
    ``normal``, the frames whose band energies are all normal: all, if
    None, take the subnormal bound)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    family = family.replace("50", "")
    if family in ("logmel", "spec"):
        keep = want < OVERFLOW
        if family == "spec":
            keep &= want >= want.max(-1, keepdims=True) - np.log(1e5)
        ulps = _energy_ulps(got[keep], want[keep], accum)
        assert not ulps.size or ulps.max() <= ULPS, ulps.max()
        return
    bf16, f16_normal, f16_sub = CEPSTRA[family]
    diff = np.abs(got - want)
    if accum == "bfloat16":
        assert diff.max() < bf16, diff.max()
        return
    if normal is None:
        normal = np.zeros(diff.shape, bool)
    for where, bound in ((normal, f16_normal), (~normal, f16_sub)):
        if where.any():
            assert diff[where].max() < bound, diff[where].max()


def _normal(family: str, case: str) -> np.ndarray:
    """(valid frames, n_out) bool: the elements whose energies are all
    normal float16 in JAX (a band energy for log-mel and the spectrogram,
    every band of the frame for cepstra and PLP)."""
    want = _energies(family, case)[0]
    ok = want >= NORMAL16
    if family in ("mfcc", "plp"):
        ok = np.broadcast_to(ok.all(-1, keepdims=True),
                             _run(family, case)[1].shape)
    return ok


@pytest.mark.parametrize("family", list(FAMILIES))
def test_bfloat16_matches_jax_and_its_oracle_error(family):
    """Every family under bfloat16 accumulation within its ulp bound of
    JAX's XLA route, and the port's error against the float64 oracle
    within 1.1x JAX's (MFCC-13 0.11, the spectrogram 1.3e-2 in the
    reference's own run)."""
    got, want, m = _run(family, "bfloat16")
    _check(family, "bfloat16", got, want)
    x = _signal("speech")
    cfg = from_jax(_jax_config(family, "float32"))
    ref = np.concatenate([ORACLE[family](x[i, :n].astype(np.float64), cfg)
                          for i, n in enumerate(LENS)])
    err_port, err_jax = (np.abs(a - ref).max() for a in (got, want))
    assert err_port <= ORACLE_RATIO * err_jax, (err_port, err_jax)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_float16_in_range_matches_jax(family):
    """Float16 accumulation on 0.01 N(0, 1) audio: the subnormal energies
    at JAX's positions, every feature within its float16 bound."""
    jax_e, port_e = _energies(family, "float16")
    np.testing.assert_array_equal(port_e >= NORMAL16, jax_e >= NORMAL16)
    got, want, _ = _run(family, "float16")
    _check(family, "float16", got, want, _normal(family, "float16"))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_float16_overflow_positions_and_values_match_jax(family):
    """Int16-scale audio as floats overflows the float16 power spectrum:
    the band energies that are inf or NaN are JAX's, their logs equal
    JAX's bit for bit (the accurate log reads an inf as 88.72 and the x86
    NaN as 89.13 in both), and every feature equals JAX's within the
    in-range bound."""
    got, want, _ = _run(family, "float16_overflow")
    jax_e, port_e = _energies(family, "float16_overflow")
    assert (jax_e > OVERFLOW).any()
    np.testing.assert_array_equal(port_e > OVERFLOW, jax_e > OVERFLOW)
    assert np.isfinite(got).all()
    over = jax_e > OVERFLOW
    np.testing.assert_array_equal(port_e[over], jax_e[over])
    _check(family, "float16", got, want, _normal(family, "float16_overflow"))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_float64_is_float32_with_a_warning(family):
    """accum_dtype="float64" computes in float32, as JAX without x64 does,
    and says so; JAX's output is float32's too."""
    port_fn, jax_fn, kw = FAMILIES[family]
    x, lens = _signal("speech"), np.asarray(LENS, np.int32)
    cfg32 = from_jax(_jax_config(family, "float32"))
    with pytest.warns(UserWarning, match="float64"):
        got = port_fn(torch.from_numpy(x), torch.from_numpy(lens),
                      cfg32.replace(accum_dtype="float64"))[0]
    want = port_fn(torch.from_numpy(x), torch.from_numpy(lens), cfg32)[0]
    assert torch.equal(got, want)
    # JAX's float64 is its float32, and the port is held to it at the
    # float32 bounds of the family's own test file
    got, want, m = _run(family, "float64")
    keep = (want >= want.max(-1, keepdims=True) - np.log(1e5)
            if family == "spec" else np.ones(want.shape, bool))
    diff = np.abs(got - want)[keep]
    assert (diff <= F32_BOUNDS[family][0] + F32_BOUNDS[family][1]
            * np.abs(want[keep])).all(), diff.max()


# -- the accurate log's floor ----------------------------------------------

_SPECIALS = [0.0, -0.0, 1e-12, 1e-10, 3e-8, 6e-8, 1e-5, 6.1e-5, 0.5, 1.0,
             3.0, 1e4, 65504.0, float("inf"), float("nan")]


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32"])
def test_floored_log_equals_jax_bit_for_bit(dtype):
    """floored_log and accurate_log on float16, bfloat16 and float32 input
    (values under the floor, zeros, subnormals of each dtype, inf and the
    x86 NaN of inf * 0) equal ``mfcc_tpu.ops.xmath``'s bit for bit: the
    input is cast to float32 before the floor, so a floored float16
    element reads log(1e-10) = -23.03, not log(0) = -88.03."""
    g = np.random.default_rng(7)
    with np.errstate(invalid="ignore", over="ignore"):
        nan = np.float32(np.inf) * np.float32(0.0)      # the x86 NaN
        vals = np.concatenate([np.asarray(_SPECIALS, np.float32), [nan],
                               np.exp(g.uniform(-30, 12, 4096)).astype(
                                   np.float32)])
        # the same bits on both sides (numpy's and ml_dtypes' casts keep a
        # NaN's sign and payload; float16 overflows to inf past 65504)
        vals = vals.astype(np.float16 if dtype == "float16"
                           else getattr(jnp, dtype))
    t = torch.from_numpy(vals.view(np.int16) if dtype == "bfloat16"
                         else vals)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    j = jnp.asarray(vals)
    # op by op, as the bit-identity of tests/test_torch_ops.py reads it
    # (under jit XLA contracts the Horner steps into FMAs: one ulp)
    for port_fn, jax_fn in (
            (lambda v: xmath.floored_log(v, 1e-10),
             lambda v: jax_xmath.floored_log(v, 1e-10)),
            (xmath.accurate_log, jax_xmath.accurate_log)):
        got = port_fn(t).numpy()
        want = np.asarray(jax_fn(j))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    floored = xmath.floored_log(torch.zeros(1, dtype=getattr(torch, dtype)),
                                1e-10)
    assert abs(float(floored) - np.log(1e-10)) < 1e-5


# -- the setting -----------------------------------------------------------

def test_check_config_takes_the_reference_names_and_refuses_others():
    """float32, bfloat16, float16 and float64 compute (float64 as float32,
    warning); any other name raises ValueError, where the reference hands
    it to jnp.dtype."""
    cfg = from_jax(JaxConfig())
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16),
                     ("float16", torch.float16)):
        c = cfg.replace(accum_dtype=name)
        backend.check_config(c)
        assert backend.accum_dtype(c) == dt
    with pytest.warns(UserWarning, match="float32"):
        backend.check_config(cfg.replace(accum_dtype="float64"))
    assert backend.accum_dtype(cfg.replace(accum_dtype="float64")) == (
        torch.float32)
    for bad in ("int32", "float8", "half"):
        with pytest.raises(ValueError, match="accum_dtype"):
            backend.check_config(cfg.replace(accum_dtype=bad))


def test_matmul_form_turns_the_fp16_reduction_off_and_restores_it():
    """Inside every form cuBLAS reduces float16 products in float32 (XLA
    accumulates a float16 dot in float32); the caller's flag comes back."""
    m = torch.backends.cuda.matmul
    saved = m.allow_fp16_reduced_precision_reduction
    try:
        for caller in (True, False):
            m.allow_fp16_reduced_precision_reduction = caller
            for mode in backend.PRECISIONS:
                with backend.matmul_form(mode):
                    assert backend.matmul_flags()[3] is False
                    assert not m.allow_fp16_reduced_precision_reduction
                assert m.allow_fp16_reduced_precision_reduction == caller
    finally:
        m.allow_fp16_reduced_precision_reduction = saved


# -- the stages on the same inputs -----------------------------------------

def _ulps(got: np.ndarray, want: np.ndarray) -> int:
    """The largest distance of two float32 arrays in units in the last
    place.  Jitted JAX contracts the accurate log's Horner steps into FMAs
    (one ulp, ``tests/test_torch_ops.py``); a flipped rounding of an
    energy in the accumulation dtype is thousands."""
    a, b = (np.asarray(v, np.float32).view(np.int32).astype(np.int64)
            for v in (got, want))
    return int(np.abs(a - b).max())

def _power(accum: str, n_fft: int = 512, seed: int = 3):
    """A power spectrum (2, 40, n_fft/2 + 1) with a 60 dB spread in the
    accumulation dtype: (JAX's float32 p_lo, p_hi holding its values, the
    torch power).  JAX casts them inside its jitted stage, as its pipeline
    does: a bfloat16 parameter would let XLA drop roundings the pipeline
    keeps."""
    g = np.random.default_rng(seed)
    p = np.exp(g.uniform(-9, 5, (2, 40, n_fft // 2 + 1))).astype(np.float32)
    t = torch.from_numpy(p).to(getattr(torch, accum))
    j = jnp.asarray(t.to(torch.float32).numpy())
    return j[..., :-1], j[..., -1:], t


def _in(accum: str, fn):
    """fn on the float32 stand-ins cast to the accumulation dtype, jitted."""
    acc = jnp.dtype(accum)
    return jax.jit(lambda a, b: fn(a.astype(acc), b.astype(acc)))


@pytest.mark.parametrize("accum", ["bfloat16", "float16"])
@pytest.mark.parametrize("kw", [dict(n_mels=26),
                                dict(n_mels=80, dynamic_range_db=50.0)])
def test_mel_stage_equals_jax_split_form(accum, kw):
    """``mel.log_mel_energies`` on a power in the accumulation dtype against
    the reference's ``log_mel_energies_split`` on the same power: the
    filterbank rounded to the dtype, the top bin's term added apart, the
    relative floor's product in the dtype (the factor rounded to it).
    Within the jitted log's one ulp."""
    jc = JaxConfig(accum_dtype=accum, **kw)
    p_lo, p_hi, t = _power(accum)
    want = np.asarray(_in(accum, lambda a, b: jax_mel.log_mel_energies_split(
        a, b, jc))(p_lo, p_hi))
    got = mel.log_mel_energies(t, from_jax(jc)).numpy()
    assert _ulps(got, want) <= 1


@pytest.mark.parametrize("accum", ["bfloat16", "float16"])
def test_bark_stage_equals_jax_split_form(accum):
    """``plp.bark_loudness`` (the bark energies by ``mel.band_energies``,
    floored and logged, then the cube root) against the reference's
    ``bark_loudness_split`` on the same power in the accumulation dtype:
    the product rounded to the dtype, the top bin's add unrounded in
    bfloat16 (a float32 floor takes it; ``plp_batch_jit``'s HLO) and
    rounded once in float16.  Within a few float32 ulps of the log and
    the exp (1e-6 relative; measured 2.4e-7 and 3.0e-7), where one
    flipped rounding of an energy would be >= 6e-4."""
    from mfcc_tpu_torch.ops import plp as plp_op
    jc = JaxConfig(accum_dtype=accum)
    p_lo, p_hi, t = _power(accum)
    loud = np.asarray(_in(accum, lambda a, b: jax_plp_op.bark_loudness_split(
        a, b, jc))(p_lo, p_hi))
    got = plp_op.bark_loudness(t, from_jax(jc)).numpy()
    np.testing.assert_allclose(got, loud, rtol=1e-6, atol=0)


@pytest.mark.parametrize("accum", ["bfloat16", "float16"])
def test_top_bin_is_added_apart(accum):
    """The split form is not one product: the top bin's term is a
    rounding of its own in the accumulation dtype, so a single product
    over every bin misses the reference where ``band_energies`` meets it.
    A mel matrix whose top bin weighs in (fmax at Nyquist, 4 mels) shows
    it."""
    jc = JaxConfig(accum_dtype=accum, n_mels=4, n_mfcc=4, n_fft=64,
                   frame_ms=4.0, hop_ms=2.0)
    cfg = from_jax(jc)
    mat = mel.mel_matrix(cfg).copy()
    mat[-1] = mat[-2] + 0.3          # a top bin every band weighs
    p_lo, p_hi, t = _power(accum, n_fft=64, seed=5)
    acc = jnp.dtype(accum)
    fb = jnp.asarray(mat, acc)
    want = np.asarray(_in(accum, lambda a, b: jnp.maximum(jnp.matmul(
        a, fb[:-1], precision=jax.lax.Precision.HIGHEST)
        + b * fb[-1][None, :], jnp.float32(0.0)))(p_lo, p_hi))
    got = mel.band_energies(t, mat, cfg, cast=True).numpy()
    np.testing.assert_array_equal(got, want)
    one = backend.matmul(t.float(), backend.constant(
        mat, t.dtype).float()).to(t.dtype).float().numpy()
    assert (one != want).any()


@pytest.mark.parametrize("accum", ["bfloat16", "float16", "float32"])
def test_dct_stage_equals_jax(accum):
    """``dct.cepstra``: the matrix rounded to the accumulation dtype, the
    product in float32, as JAX promotes float32 @ bfloat16."""
    jc = JaxConfig(accum_dtype=accum, lifter=22)
    g = np.random.default_rng(4)
    lm = g.uniform(-20, 10, (2, 40, jc.n_mels)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jax_dct.cepstra(v, jc))(
        jnp.asarray(lm)))
    got = dct.cepstra(torch.from_numpy(lm), from_jax(jc)).numpy()
    assert np.abs(got - want).max() < 1e-4      # the float32 cepstra bound
    if accum != "float32":
        f32 = dct.cepstra(torch.from_numpy(lm), from_jax(
            jc.replace(accum_dtype="float32"))).numpy()
        assert np.abs(f32 - want).max() > 100 * np.abs(got - want).max()


# -- the other entry points ------------------------------------------------

ENTRY_SIGNAL = {"bfloat16": "speech", "float16": "quiet"}
# log-mel-80 through a DIT form (test_dft_algorithms_take_their_own_form)
DIT_LOGMEL = 6e-2


@pytest.mark.parametrize("accum", ["bfloat16", "float16"])
@pytest.mark.parametrize("family", ["mfcc", "logmel", "plp", "spec"])
def test_packed_rows_match_jax(family, accum):
    """``mfcc_batch_packed`` under each accumulation dtype against the
    reference's packed entry; a segment also equals the port's own
    standalone computation bit for bit (hop alignment gives its frames
    the same samples and reductions)."""
    x = _signal(ENTRY_SIGNAL[accum])[:, :12000].copy()
    starts = np.asarray([[0, 6400], [0, 0]], np.int32)
    lens = np.asarray([[6000, 5600], [11000, 0]], np.int32)
    x[0, 6000:6400] = 0.0
    jc = _jax_config(family if family != "logmel" else "logmel50", accum)
    want = jax_mfcc.mfcc_batch_packed_jit(
        jnp.asarray(x), jnp.asarray(starts), jnp.asarray(lens), jc, "xla",
        family == "mfcc", family)
    got = mfcc_model.mfcc_batch_packed(
        torch.from_numpy(x), torch.from_numpy(starts), torch.from_numpy(lens),
        from_jax(jc), family=family)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    m = got[3].numpy()
    _check(family, accum, got[0].numpy()[m], np.asarray(want[0])[m])
    alone = FAMILIES[family if family != "logmel" else "logmel50"][0](
        torch.from_numpy(x[1:, :11000]), torch.tensor([11000]),
        from_jax(jc))[0][0]
    T = alone.shape[0]
    assert torch.equal(got[0][1, :T], alone)


@pytest.mark.parametrize("accum", ["bfloat16", "float16"])
def test_mfcc_long_and_single_utterance_entries_match_jax(accum):
    """``mfcc_long`` and the one-utterance entries (``mfcc``, ``log_mel``,
    ``plp``, ``log_spectrogram``) under each accumulation dtype against
    the reference's."""
    x = _signal(ENTRY_SIGNAL[accum])[0]
    jx = jnp.asarray(x)
    for family, port_fn, jax_fn in (
            ("mfcc", mfcc_model.mfcc_long,
             lambda v, c: jax_mfcc.mfcc_long_jit(v, c, "xla")),
            ("mfcc", mfcc_model.mfcc, jax_mfcc.mfcc_jit),
            ("logmel50", logmel.log_mel, jax_logmel.log_mel_jit),
            ("plp", plp.plp, jax_plp.plp_jit),
            ("spec", spectrogram.log_spectrogram,
             jax_spec.log_spectrogram_jit)):
        jc = _jax_config(family, accum)
        got = port_fn(torch.from_numpy(x), from_jax(jc)).numpy()
        _check(family, accum, got, jax_fn(jx, jc))


@pytest.mark.parametrize("accum", ["bfloat16", "float16"])
@pytest.mark.parametrize("variant", ["mfcc", "logmel", "plp", "spec"])
def test_streaming_scan_step_matches_jax(variant, accum):
    """The streaming scan path (its plain chain on each chunk's span)
    under each accumulation dtype against the reference's scan path: the
    same valid counts, the features within the family's bound."""
    family = {"logmel": "logmel50"}.get(variant, variant)
    jc = _jax_config(family, accum)
    cfg = from_jax(jc)
    B, K, C = 2, 3, 8 * jc.hop_len
    chunks = _signal(ENTRY_SIGNAL[accum])[:, : K * C].reshape(B, K, C)
    _, feats, nvs = streaming.process_chunks_batch(
        streaming.init_state_batch(B, cfg, device="cpu"),
        torch.from_numpy(chunks), cfg, variant)
    _, jfeats, jnvs = jax_streaming.process_chunks_batch_jit(
        jax_streaming.init_state_batch(B, jc), jnp.asarray(chunks), jc,
        variant)
    np.testing.assert_array_equal(nvs.numpy(), np.asarray(jnvs))
    _check(variant, accum, feats.numpy(), jfeats)


@pytest.mark.parametrize("accum", ["bfloat16", "float16"])
def test_trainable_forward_and_gradients_match_jax(accum):
    """The trainable front end under each accumulation dtype: its power in
    the dtype, promoted to float32 against the float32 filterbank (the
    last add unrounded in bfloat16, as XLA reads it), the DCT rounded to
    the dtype.  Forward within the cepstra bound; the loss and the
    gradients w.r.t. mel_w and log_floor within 1e-3 of jax.grad's
    (relative to each gradient's largest element; measured: BF16_GRAD)."""
    jc = JaxConfig(accum_dtype=accum).validate()
    cfg = from_jax(jc)
    audio = _signal(ENTRY_SIGNAL[accum])[:, :8000].copy()
    jp = jax_trainable.init_params(jc)
    jp = jp._replace(mel_w=jp.mel_w * 1.3)
    jforward = jax.jit(jax_trainable.forward, static_argnames="cfg")
    target = np.array(jforward(jax_trainable.init_params(jc),
                               jnp.asarray(audio), cfg=jc))
    jloss, jgrad = jax.jit(jax.value_and_grad(jax_trainable.loss_fn),
                           static_argnames="cfg")(
        jp, jnp.asarray(audio), jnp.asarray(target), cfg=jc)
    params = trainable.params_from_jax(jp, "cpu")
    got = trainable.forward(params, torch.from_numpy(audio), cfg)
    _check("mfcc", accum, got.detach().numpy(),
           jforward(jp, jnp.asarray(audio), cfg=jc))
    loss = trainable.loss_and_grad(params, torch.from_numpy(audio),
                                   torch.from_numpy(target), cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)
    for g, jg in ((params.mel_w.grad, jgrad.mel_w),
                  (params.log_floor.grad, jgrad.log_floor)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=1e-3 * np.abs(jg).max())


@pytest.mark.parametrize("accum", ["bfloat16", "float16"])
@pytest.mark.parametrize("algo", ["dit2", "dit2c", "dit4c", "directc"])
def test_dft_algorithms_take_their_own_form(algo, accum):
    """In a narrow accumulation dtype each factorization rounds its own
    intermediates, so the plain route takes the reference's form for the
    DIT algorithms (``spectrum.power_form``).  Through the direct form
    the radix-2 combine's valleys put bfloat16 log-mel-80 14.7 off JAX's
    route at "dit2" (0.3 N(0, 1) rows); through the DIT forms MFCC is
    within its bound and log-mel-80 within DIT_LOGMEL: the combine's
    cancellation (e - W o in a valley) magnifies a flipped rounding of a
    half DFT (measured over three shifted and scaled inputs: 2.0e-2 in
    bfloat16 at "dit4c", 3.2e-2 in float16 at "dit2")."""
    for family in ("mfcc", "logmel"):
        jc = _jax_config(family, accum, dft_algorithm=algo)
        x = _signal(ENTRY_SIGNAL[accum])
        lens = np.asarray(LENS, np.int32)
        want, _, m = FAMILIES[family][1](jnp.asarray(x), jnp.asarray(lens),
                                         jc, "xla")
        got = FAMILIES[family][0](torch.from_numpy(x),
                                  torch.from_numpy(lens), from_jax(jc))[0]
        got, want = got.numpy()[np.asarray(m)], np.asarray(want)[np.asarray(m)]
        if family == "logmel":
            assert np.abs(got - want).max() < DIT_LOGMEL
        else:
            _check(family, accum, got, want)


@pytest.mark.parametrize("accum", ["bfloat16", "float16", "float64"])
def test_kernel_wrappers_compute_float32_whatever_the_setting(accum):
    """The kernels never read accum_dtype (as the reference's Pallas
    kernels do not), so each wrapper's plain version on a CPU tensor, and
    the fused serving path through it, give the float32 config's bits;
    the plain route gives the reference's XLA casts."""
    from mfcc_tpu_torch.ops.kernels import fused_dit, fused_mfcc, fused_raw
    cfg32 = from_jax(JaxConfig(n_mels=26))
    cfg = cfg32.replace(accum_dtype=accum)
    x = torch.from_numpy(_signal("speech")[:, :8000].copy())
    y = framing.preemphasize(x, cfg32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        for fn, arg in ((fused_raw_dit.fused_features_raw_dit, x),
                        (fused_raw.fused_features_raw, x),
                        (fused_mfcc.fused_features, y),
                        (fused_dit.fused_features_dit, y)):
            assert torch.equal(fn(arg, cfg), fn(arg, cfg32))
        st = streaming.init_state_batch(2, cfg, device="cpu")
        chunks = x[:, :4800].reshape(2, 3, 1600)
        got = streaming.process_chunks_batch_fused(st, chunks, cfg)[1]
        want = streaming.process_chunks_batch_fused(st, chunks, cfg32)[1]
        assert torch.equal(got, want)
        plain = fused_raw_dit.plain_features(x, cfg)
    assert torch.equal(plain, fused_raw_dit.plain_features(x, cfg32)) == (
        accum == "float64")


def test_chip_smoke_jax_cpu_figures():
    """The reference's own errors against the float64 oracle that
    chip_smoke.py's phase 23 prints beside the card's (``ACCUM_JAX_CPU``):
    JAX's XLA route on the CPU on the first second of the bench batch's
    row 0 as int16, each family under float32, bfloat16 and float16,
    measured here (within 5 %: XLA's CPU code may differ by host)."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    x16 = smoke._int16(smoke._bench_audio(1, 1.0, 16000))
    x64 = x16[0].astype(np.float64) / 32768.0
    for family, figures in smoke.ACCUM_JAX_CPU.items():
        for accum, figure in figures.items():
            jc = _jax_config(family, accum)
            got = np.asarray(FAMILIES[family][1](
                jnp.asarray(x16), jnp.asarray([16000], np.int32), jc,
                "xla")[0][0])
            ref = ORACLE[family](x64, from_jax(jc))
            err = float(np.abs(got[: ref.shape[0]] - ref).max())
            assert figure is not None and abs(err / figure - 1.0) < 0.05, (
                family, accum, err, figure)
