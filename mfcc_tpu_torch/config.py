"""Feature-extraction configuration (the port's twin of ``mfcc_tpu.config``).

The port cannot import the JAX package at run time (importing anything
under ``mfcc_tpu`` imports jax), so it carries its own copy of the frozen
numerical contracts: :class:`FeatureConfig` and :class:`PitchConfig`.  The
fields, their order and their defaults are the reference's, so ``to_json``
and ``config_hash`` give the same string and the same hash for the same
contract; ``tests/test_torch_config.py`` and ``tests/test_torch_pitch.py``
hold the two equal.  Field notes live on the reference classes.
:class:`WhisperConfig` (Whisper's log-mel front end) and :class:`NemoConfig`
(NeMo's ASR preprocessor) are the port's own and have no twin.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Optional

WINDOWS = ("hamming", "hann", "povey", "rect")
FRAME_MODES = ("valid", "center")
MEL_SCALES = ("htk", "slaney")
DFT_ALGORITHMS = ("auto", "direct", "directc", "dit2", "dit2c", "dit4c")


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Frozen numerical contract for the MFCC front end.

    Defaults: 16 kHz, 25 ms / 10 ms Hamming frames, pre-emphasis 0.97,
    512-point DFT, 26 HTK mels, 13 cepstra.
    """

    # --- sampling / framing ---
    sample_rate: int = 16_000
    frame_ms: float = 25.0
    hop_ms: float = 10.0
    frame_mode: str = "valid"
    # --- spectral ---
    n_fft: int = 512
    window: str = "hamming"
    preemph: float = 0.97
    dither: float = 0.0
    dither_seed: int = 0
    # --- mel ---
    n_mels: int = 26
    fmin: float = 0.0
    fmax: Optional[float] = None
    mel_scale: str = "htk"
    vtln_warp: float = 1.0
    vtln_low: float = 100.0
    vtln_high: float = -500.0
    # --- cepstral ---
    n_mfcc: int = 13
    log_floor: float = 1e-10
    dynamic_range_db: Optional[float] = None
    lifter: int = 0
    append_energy: bool = False
    # --- PLP (not used by the MFCC path) ---
    n_bark: int = 21
    lpc_order: int = 12
    # --- post ---
    deltas: bool = False
    delta_window: int = 2
    cmvn: bool = False
    # --- numerics ---
    compute_dtype: str = "float32"
    accum_dtype: str = "float32"
    matmul_precision: str = "highest"
    dft_algorithm: str = "auto"

    # --- derived sizes ---
    @property
    def frame_len(self) -> int:
        return int(round(self.sample_rate * self.frame_ms / 1000.0))

    @property
    def hop_len(self) -> int:
        return int(round(self.sample_rate * self.hop_ms / 1000.0))

    @property
    def n_bins(self) -> int:
        """Number of non-redundant rFFT bins."""
        return self.n_fft // 2 + 1

    @property
    def fmax_hz(self) -> float:
        return self.sample_rate / 2.0 if self.fmax is None else float(self.fmax)

    @property
    def vtln_high_hz(self) -> float:
        """vtln_high resolved to Hz (negative = offset below fmax)."""
        return (self.fmax_hz + self.vtln_high if self.vtln_high < 0.0
                else self.vtln_high)

    @property
    def n_feats(self) -> int:
        """Final feature dimension (after optional deltas)."""
        return self.n_mfcc * 3 if self.deltas else self.n_mfcc

    @property
    def dit2_eligible(self) -> bool:
        return (self.n_fft % 4 == 0 and self.hop_len % 2 == 0
                and self.frame_len >= 2)

    @property
    def dit4_eligible(self) -> bool:
        return (self.n_fft % 8 == 0 and self.hop_len % 4 == 0
                and self.frame_len >= 4)

    @property
    def center_left_pad(self) -> int:
        """Center mode: samples reflected before the signal start."""
        return self.frame_len // 2 - self.hop_len // 2

    @property
    def center_min_samples(self) -> int:
        """Center mode: shortest signal that emits frames."""
        return self.frame_len - self.frame_len // 2

    def num_frames(self, n_samples: int) -> int:
        """Frames emitted for an ``n_samples``-long signal ("valid": tail
        dropped; "center": (n + hop//2) // hop, 0 below
        center_min_samples)."""
        if self.frame_mode == "center":
            if n_samples < self.center_min_samples:
                return 0
            return (n_samples + self.hop_len // 2) // self.hop_len
        if n_samples < self.frame_len:
            return 0
        return 1 + (n_samples - self.frame_len) // self.hop_len

    def validate(self) -> "FeatureConfig":
        if self.window not in WINDOWS:
            raise ValueError(f"window must be one of {WINDOWS}, got {self.window!r}")
        if self.frame_mode not in FRAME_MODES:
            raise ValueError(f"frame_mode must be one of {FRAME_MODES}, "
                             f"got {self.frame_mode!r}")
        if self.frame_mode == "center" and self.hop_len > self.frame_len:
            raise ValueError("frame_mode='center' requires hop_len <= "
                             "frame_len (centered windows must overlap or "
                             "tile; gapped framing has no centered "
                             "convention)")
        if self.mel_scale not in MEL_SCALES:
            raise ValueError(
                f"mel_scale must be one of {MEL_SCALES}, got {self.mel_scale!r}")
        if self.n_fft < self.frame_len:
            raise ValueError(
                f"n_fft ({self.n_fft}) must be >= frame_len ({self.frame_len})")
        if self.n_mfcc > self.n_mels:
            raise ValueError("n_mfcc must be <= n_mels")
        if not (0.0 <= self.preemph < 1.0):
            raise ValueError("preemph must be in [0, 1)")
        if self.dither < 0.0:
            raise ValueError("dither must be >= 0")
        if self.fmax is not None and self.fmax <= self.fmin:
            raise ValueError("fmax must be > fmin")
        if self.vtln_warp <= 0.0:
            raise ValueError("vtln_warp must be > 0")
        if self.vtln_warp != 1.0:
            l = self.vtln_low * max(1.0, self.vtln_warp)
            h = self.vtln_high_hz * min(1.0, self.vtln_warp)
            if not (self.fmin < l < h < self.fmax_hz):
                raise ValueError(
                    "VTLN needs fmin < vtln_low*max(1,warp) < "
                    "vtln_high*min(1,warp) < fmax "
                    f"(got fmin={self.fmin}, l={l}, h={h}, "
                    f"fmax={self.fmax_hz})")
            if not (self.fmin < self.vtln_low
                    and self.vtln_high_hz < self.fmax_hz):
                raise ValueError(
                    "VTLN needs fmin < vtln_low and vtln_high < fmax "
                    f"(got fmin={self.fmin}, vtln_low={self.vtln_low}, "
                    f"vtln_high_hz={self.vtln_high_hz}, "
                    f"fmax={self.fmax_hz})")
        if self.n_bark < 2:
            raise ValueError("n_bark must be >= 2")
        if not (1 <= self.lpc_order < self.n_bark + 2):
            raise ValueError(
                "lpc_order must be in [1, n_bark + 1] (the autocorrelation "
                "IDFT provides n_bark + 2 spectral samples)")
        if self.dft_algorithm not in DFT_ALGORITHMS:
            raise ValueError(
                f"dft_algorithm must be one of {DFT_ALGORITHMS}, "
                f"got {self.dft_algorithm!r}")
        if self.dft_algorithm in ("dit2", "dit2c") and not self.dit2_eligible:
            raise ValueError(
                f"dft_algorithm={self.dft_algorithm!r} requires n_fft % 4 "
                "== 0, an even hop_len, and frame_len >= 2 (use 'auto' to "
                "fall back automatically)")
        if self.dft_algorithm == "dit4c" and not self.dit4_eligible:
            raise ValueError(
                "dft_algorithm='dit4c' requires n_fft % 8 == 0, hop_len % 4 "
                "== 0, and frame_len >= 4 (use 'auto' to fall back "
                "automatically)")
        return self

    # --- reproducibility ---
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    def config_hash(self) -> str:
        """Stable short hash of the numerical contract (equal to the JAX
        package's hash for the same field values)."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:12]

    def replace(self, **kw) -> "FeatureConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class PitchConfig:
    """Frozen numerical contract for the Kaldi-style pitch front end
    (NCCF + Viterbi; ``models/pitch.py``).  Defaults: 16 kHz input, 4 kHz
    work rate, 25 ms / 10 ms frames, f0 in 50..400 Hz."""

    sample_rate: int = 16_000
    work_rate: int = 4_000
    frame_ms: float = 25.0
    hop_ms: float = 10.0
    min_f0: float = 50.0
    max_f0: float = 400.0
    penalty: float = 0.35
    ballast: float = 1.0
    norm_window: int = 151
    delta_window: int = 2

    @property
    def frame_len_w(self) -> int:
        return int(round(self.work_rate * self.frame_ms / 1000.0))

    @property
    def hop_len_w(self) -> int:
        return int(round(self.work_rate * self.hop_ms / 1000.0))

    @property
    def min_lag(self) -> int:
        return max(2, math.ceil(self.work_rate / self.max_f0))

    @property
    def max_lag(self) -> int:
        return int(self.work_rate // self.min_f0)

    @property
    def n_lags(self) -> int:
        return self.max_lag - self.min_lag + 1

    @property
    def n_feats(self) -> int:
        return 3                   # [pov, normalized log pitch, delta]

    def num_frames(self, n_samples: int) -> int:
        """Pitch frames for an ``n_samples``-long signal at sample_rate:
        "valid" framing at the work rate, each frame spanning frame_len_w
        + max_lag work samples, tail dropped."""
        from .ops.resample import resampled_length
        nw = resampled_length(n_samples, self.sample_rate, self.work_rate)
        need = self.frame_len_w + self.max_lag
        if nw < need:
            return 0
        return 1 + (nw - need) // self.hop_len_w

    def validate(self) -> "PitchConfig":
        if self.work_rate > self.sample_rate:
            raise ValueError("work_rate must be <= sample_rate")
        if not (0 < self.min_f0 < self.max_f0):
            raise ValueError("need 0 < min_f0 < max_f0")
        if self.max_f0 > self.work_rate / 2:
            raise ValueError("max_f0 must be <= work_rate / 2")
        if self.min_lag >= self.max_lag:
            raise ValueError("empty lag grid (raise work_rate or widen "
                             "the f0 band)")
        if self.norm_window < 1 or self.norm_window % 2 == 0:
            raise ValueError("norm_window must be odd and >= 1")
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    def config_hash(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:12]

    def replace(self, **kw) -> "PitchConfig":
        return dataclasses.replace(self, **kw)


class _OwnFront:
    """What the port's own front-end configs (:class:`WhisperConfig`,
    :class:`NemoConfig`) share: their sizes, the FeatureConfig of their
    spectral stage, and the refusal of the steps they do not have."""

    @property
    def frame_len(self) -> int:
        return int(round(self.sample_rate * self.frame_ms / 1000.0))

    @property
    def hop_len(self) -> int:
        return int(round(self.sample_rate * self.hop_ms / 1000.0))

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    def feature_config(self) -> FeatureConfig:
        """The FeatureConfig of the spectral stage's sizes and numerics:
        valid-mode frames of frame_len samples over the rows the entry's
        framing step writes, no pre-emphasis, an n_fft-point DFT, the mel
        floor and accurate log, no relative floor.  Its window, its mel
        bank and its log's guard are not the front end's own; the entry's
        model (``models/whisper``, ``models/nemo``) supplies those."""
        return FeatureConfig(
            sample_rate=self.sample_rate, frame_ms=self.frame_ms,
            hop_ms=self.hop_ms, n_fft=self.n_fft, window="hann", preemph=0.0,
            n_mels=self.n_mels, fmin=self.fmin, fmax=self.fmax,
            mel_scale="slaney", n_mfcc=self.n_mels,
            log_floor=self.log_floor).validate()

    def _refuse_steps(self, fixed: dict, name: str) -> None:
        """ValueError where a field of ``fixed`` (the steps of other front
        ends, and the front end's own fixed ones) is not at its value."""
        off = {k: getattr(self, k) for k, v in fixed.items()
               if getattr(self, k) != v}
        if off:
            raise ValueError(f"{name}'s front end has no such step: {off}")


@dataclasses.dataclass(frozen=True)
class WhisperConfig(_OwnFront):
    """Whisper's log-mel front end (``models/whisper``), the port's own:
    the JAX package has no twin.  Defaults: large-v3's, 128 mels
    (openai ``whisper/audio.py``: ``N_FFT`` 400, ``HOP_LENGTH`` 160,
    ``CHUNK_LENGTH`` 30; Hugging Face ``WhisperFeatureExtractor``).

    A row is cut or zero-padded to ``chunk_s`` seconds, reflect-padded by
    n_fft // 2 on each side without repeating the edge sample
    (``torch.stft(center=True)``), framed with the periodic Hann window
    of n_fft points at hop_ms, the last frame dropped; then |X|^2 of the
    n_bins bins, Slaney-scale mel filters whose triangles are linear in
    Hz with Slaney's area normalisation, log10 of the energies floored at
    ``log_floor``, a floor 80 dB (``models/whisper.ROW_FLOOR_DB``) under
    the row's largest value over all its frames and bands, and (x + 4) /
    4.  Those steps are Whisper's alone and have no field.

    The other fields are FeatureConfig's, so that readers of a
    FeatureConfig's settings read this one too; those Whisper has no step
    for must hold the value that turns the step off
    (:data:`WHISPER_FIXED`).  ``frame_mode="valid"`` names the frames
    that lie wholly inside an utterance's own samples; Whisper's own are
    the centred frames of the whole window, ``num_frames`` of them a row
    whatever its length.
    """

    sample_rate: int = 16_000
    frame_ms: float = 25.0
    hop_ms: float = 10.0
    frame_mode: str = "valid"
    n_fft: int = 400
    window: str = "hann"
    preemph: float = 0.0
    dither: float = 0.0
    n_mels: int = 128
    fmin: float = 0.0
    fmax: Optional[float] = 8000.0
    mel_scale: str = "slaney"
    vtln_warp: float = 1.0
    n_mfcc: int = 128
    log_floor: float = 1e-10
    dynamic_range_db: Optional[float] = None
    lifter: int = 0
    append_energy: bool = False
    deltas: bool = False
    delta_window: int = 2
    cmvn: bool = False
    chunk_s: float = 30.0            # Whisper's input window (pad_or_trim)

    @property
    def chunk_samples(self) -> int:
        return int(round(self.sample_rate * self.chunk_s))

    def num_frames(self) -> int:
        """Frames of every row, whatever its length: the centred STFT's 1 +
        chunk // hop, less the last."""
        return self.chunk_samples // self.hop_len

    def validate(self) -> "WhisperConfig":
        self._refuse_steps(WHISPER_FIXED, "Whisper")
        if self.frame_len != self.n_fft:
            raise ValueError(f"frame_len ({self.frame_len}) must equal n_fft "
                             f"({self.n_fft}): Whisper's window is n_fft long")
        if self.n_fft % 2 or self.hop_len < 1:
            raise ValueError("n_fft must be even and hop_len >= 1")
        if self.n_mfcc != self.n_mels:
            raise ValueError("n_mfcc must equal n_mels (no cepstra)")
        if self.chunk_samples <= self.n_fft or self.num_frames() < 2:
            raise ValueError("chunk_s must hold more than n_fft samples and "
                             "two hops")
        if self.log_floor <= 0.0:
            raise ValueError("log_floor must be > 0")
        self.feature_config()
        return self


# The fields of WhisperConfig that name steps of the port's other front
# ends, at the values that turn them off, and Whisper's own scale.
WHISPER_FIXED = dict(
    frame_mode="valid", window="hann", preemph=0.0, dither=0.0,
    mel_scale="slaney", vtln_warp=1.0, dynamic_range_db=None, lifter=0,
    append_energy=False, deltas=False, cmvn=False)


@dataclasses.dataclass(frozen=True)
class NemoConfig(_OwnFront):
    """NVIDIA NeMo's ASR preprocessor (``models/nemo``), the port's own:
    the JAX package has no twin.  Defaults: the log-mel-128 front end of
    the Parakeet (FastConformer) and Canary models (NeMo
    ``AudioToMelSpectrogramPreprocessor`` -> ``FilterbankFeatures`` with
    ``normalize="per_feature"``; Hugging Face ``ParakeetFeatureExtractor``).

    Per row of length L in a (B, N) batch: pre-emphasis by NeMo's rule,
    y[0] = x[0] and y[n] = x[n] - preemph x[n - 1], then y[n] = 0 for n >= L
    (not the HTK rule x[-1] := x[0] of :class:`FeatureConfig`; 0 turns it
    off); ``torch.stft(center=True, pad_mode="constant")`` at n_fft with
    the symmetric Hann window of frame_len points centred in n_fft, so
    1 + N // hop frames a row, frame t's window covering samples [t hop -
    P, t hop - P + frame_len), P = :attr:`center_offset` (200 at 400 in
    512), zeros outside the row; |X|^2; Slaney-scale mel filters whose
    triangles are linear in Hz with Slaney's area normalisation; the
    natural log guarded by ``log_floor``: log(e + log_floor)
    (``log_guard="add"``, NeMo's default); then ``normalize="per_feature"``:
    each band of each row less its mean over the row's L // hop valid
    frames, over its Bessel-corrected standard deviation plus
    ``norm_eps``, and the frames past them written as zeros.  A row with fewer than two valid frames,
    where NeMo raises and Hugging Face writes NaN, is written as zeros
    (``models/nemo.normalize``).

    The other fields are FeatureConfig's, so that readers of a
    FeatureConfig's settings read this one too; those NeMo has no step for
    must hold the value that turns the step off, and ``log_guard`` and
    ``normalize`` NeMo's own (:data:`NEMO_FIXED`).
    ``frame_mode="valid"`` names the frames that lie wholly inside an
    utterance's own samples; NeMo's own are the centred frames above.
    """

    sample_rate: int = 16_000
    frame_ms: float = 25.0
    hop_ms: float = 10.0
    frame_mode: str = "valid"
    n_fft: int = 512
    window: str = "hann"
    preemph: float = 0.97
    dither: float = 0.0
    n_mels: int = 128
    fmin: float = 0.0
    fmax: Optional[float] = 8000.0
    mel_scale: str = "slaney"
    vtln_warp: float = 1.0
    n_mfcc: int = 128
    log_floor: float = 2.0 ** -24    # NeMo's log_zero_guard_value
    dynamic_range_db: Optional[float] = None
    lifter: int = 0
    append_energy: bool = False
    deltas: bool = False
    delta_window: int = 2
    cmvn: bool = False
    log_guard: str = "add"
    normalize: str = "per_feature"
    norm_eps: float = 1e-5

    @property
    def center_offset(self) -> int:
        """Where a row's own samples begin in the rows that
        ``framing.nemo_center_batch`` writes: n_fft // 2 less the window's
        offset (n_fft - frame_len) // 2 inside the n_fft points."""
        return self.n_fft // 2 - (self.n_fft - self.frame_len) // 2

    def num_frames(self, n_samples: int) -> int:
        """Frames of every row of a batch padded to n_samples:
        ``torch.stft(center=True)``'s 1 + n_samples // hop."""
        return 1 + n_samples // self.hop_len

    def validate(self) -> "NemoConfig":
        self._refuse_steps(NEMO_FIXED, "NeMo")
        n = self.n_fft
        if not (64 <= n <= 4096 and n & (n - 1) == 0):
            raise ValueError(f"n_fft ({n}) must be a power of two from 64 to "
                             "4096 (the FFT tile's)")
        if not (2 <= self.frame_len <= n) or self.hop_len < 1:
            raise ValueError(f"frame_len ({self.frame_len}) must be in [2, "
                             f"n_fft] and hop_len ({self.hop_len}) >= 1")
        if self.n_mfcc != self.n_mels:
            raise ValueError("n_mfcc must equal n_mels (no cepstra)")
        if not (0.0 <= self.preemph < 1.0):
            raise ValueError("preemph must be in [0, 1)")
        if self.log_floor <= 0.0 or self.norm_eps <= 0.0:
            raise ValueError("log_floor and norm_eps must be > 0")
        if self.fmax is None or self.fmax > self.sample_rate / 2.0:
            raise ValueError("fmax must be given and at most sample_rate / 2")
        self.feature_config()
        return self


# The fields of NemoConfig that name steps of the port's other front ends,
# at the values that turn them off, and NeMo's own scale, guard and
# normalization.
NEMO_FIXED = dict(
    frame_mode="valid", window="hann", dither=0.0, mel_scale="slaney",
    vtln_warp=1.0, dynamic_range_db=None, lifter=0, append_energy=False,
    deltas=False, cmvn=False, log_guard="add", normalize="per_feature")


# Named presets of the baseline's configs (BASELINE.md), the reference's.
MFCC13 = FeatureConfig().validate()
LOGMEL80 = FeatureConfig(n_mels=80, n_mfcc=80, deltas=True).validate()
WHISPER128 = WhisperConfig().validate()
NEMO128 = NemoConfig().validate()


def logmel_config(n_mels: int = 80, deltas: bool = True) -> FeatureConfig:
    """Log-mel variant: mel energies + log, DCT skipped (models/logmel.py)."""
    return FeatureConfig(n_mels=n_mels, n_mfcc=n_mels,
                         deltas=deltas).validate()


def from_jax(cfg_or_dict):
    """The port's FeatureConfig or PitchConfig for a JAX config of that
    name or its ``dataclasses.asdict`` (a dict is matched by its field
    set).  Unknown or missing fields raise, so a contract that grew on one
    side cannot be carried over silently."""
    if isinstance(cfg_or_dict, dict):
        d = dict(cfg_or_dict)
        # the class whose fields the dict covers best
        cls = max((FeatureConfig, PitchConfig), key=lambda c: len(
            set(d) & {f.name for f in dataclasses.fields(c)}))
    else:
        d = dataclasses.asdict(cfg_or_dict)
        cls = (PitchConfig if type(cfg_or_dict).__name__ == "PitchConfig"
               else FeatureConfig)
    names = [f.name for f in dataclasses.fields(cls)]
    if sorted(d) != sorted(names):
        raise ValueError(
            f"config fields differ from the port's {cls.__name__}: "
            f"extra {sorted(set(d) - set(names))}, "
            f"missing {sorted(set(names) - set(d))}")
    return cls(**d)
