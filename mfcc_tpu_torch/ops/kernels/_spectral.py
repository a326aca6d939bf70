"""Host side shared by the four spectral kernel modules (``fused_raw_dit``,
``fused_raw``, ``fused_mfcc``, ``fused_dit``), whose CUDA sources share
``csrc/spectral.cuh`` and ``csrc/fft_tile.cuh``.

- :func:`plain_features` — the plain PyTorch spectral chain from audio the
  caller has pre-emphasized: frames, DFT power (direct or radix-2 DIT),
  then by projection: mel, floors, accurate log and the lifter-folded DCT
  with the optional log energy in c0, or the log-mel energies ("mel");
  the floored log of the bark + equal-loudness band energies ("bark",
  PLP's front half); the floored log of each |X|^2 bin ("spec").
- :func:`n_out`, :func:`projection_matrix`, :func:`staged_width` — each
  projection's output width, its (n_bins, width) matrix, and the floats a
  tile stages per frame for it.
- :func:`direct_matrices` — the direct tile's float32 constants.
- :func:`fft_tile`, :func:`fft_radices`, :func:`fft_smem_bytes`,
  :func:`fft_frame_tile`,
  :func:`fft_matrices`, :func:`fft_tables`, :func:`mel_bands`,
  :func:`mel_chunks` — the tile rule (which tile a config takes: the f32
  FFT tile "fft", its float64-front flavour "fft64" or, at an n_fft of
  2^a 5^b, that flavour's mixed-radix tile "fft64_mixed", or the entry's
  other tile), the tile's passes, and its constants.
- :class:`Front` — a front end's own window and filterbank, which a
  config's fields cannot state (``models/whisper``, ``models/nemo``), and
  its log (floored, or NeMo's additive guard): the entries build
  whichever tile's tables from them; :func:`plain_front_features` is
  their plain chain.
- :class:`RowBounds`, :func:`zero_tail`, :func:`first_skipped_frame` —
  where each row of ``framing.stft_center_batch``'s output turns to the
  zeros it wrote, which the mixed-radix tile reads from the rows' lengths
  on the device and skips, frame tile by frame tile (the host twins of
  ``spectral::zero_tail`` and of its rule in ``fft_mixed_features``).
- :func:`pinned` — constants in page-locked memory, so that each call's
  upload is an asynchronous copy on the launch stream.  The host seconds
  of each miss of the launch path's constant caches
  (:func:`_device_fft_matrices`, the pinned direct constants), the
  float64 build included, go to ``utils/report``'s counter ``consts_s``;
  the frames of each call that runs a direct tile go to its per-batch
  counter ``frames_direct``, and those of each call that hands the
  mixed-radix tile its rows' lengths to ``frames_bounded``.
- :func:`check_input`, :func:`epilogue_args`, :func:`raise_on_error` — the
  wrappers' common checks and launch arguments.
- :func:`entry_argtypes`, :func:`launch_spectral` — the C types of a
  spectral entry, and one launch of it: the FFT tile :func:`fft_tile`
  picks, or the entry's other tile (the direct tile; ``fused_dit``'s DIT
  tile).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ... import backend, oracle
from ...config import FeatureConfig
from ...utils import report
from .. import (dct as dct_op, framing, mel as mel_op, plp as plp_op,
                spectrum, xmath)
from . import _build, routes

BINS_PER_BLOCK = 256   # must match spectral::kBins in csrc/spectral.cuh
FFT_MIN, FFT_MAX = 64, 4096   # must match spectral::kFftMin / kFftMax
MEL_CHUNK = 16                # must match spectral::kMelChunk
# the projections of fused_raw_dit and their codes in its C entry (must
# match spectral::Projection)
PROJECTION_CODES = {"mel": 0, "bark": 1, "spec": 2}


def check_projection(projection: str, apply_dct: bool) -> None:
    """The reference's asserts (``fused_raw_dit.py:144-146``)."""
    if projection not in PROJECTION_CODES:
        raise ValueError(f"projection must be one of "
                         f"{tuple(PROJECTION_CODES)}, got {projection!r}")
    if projection != "mel" and apply_dct:
        raise ValueError("bark/spec projections emit band/bin energies; no "
                         "DCT stage (pass apply_dct=False)")


def n_out(cfg: FeatureConfig, apply_dct: bool,
          projection: str = "mel") -> int:
    if projection == "bark":
        return cfg.n_bark
    if projection == "spec":
        return cfg.n_bins
    return cfg.n_mfcc if apply_dct else cfg.n_mels


def staged_width(cfg: FeatureConfig, projection: str = "mel") -> int:
    """Floats a tile stages per frame for the projection
    (``spectral::staged_width``): the band energies, or none for the
    spectrogram, whose logs go from |X|^2 straight to the output."""
    return 0 if projection == "spec" else n_out(cfg, False, projection)


def projection_matrix(cfg: FeatureConfig, projection: str = "mel"):
    """(n_bins, n_mels or n_bark) float64 projection, or None ("spec")."""
    if projection == "bark":
        return plp_op.bark_matrix(cfg)
    return None if projection == "spec" else mel_op.mel_matrix(cfg)


def plain_features(y: torch.Tensor, cfg: FeatureConfig, apply_dct: bool,
                   power=None, projection: str = "mel") -> torch.Tensor:
    """(B, N) pre-emphasized audio -> (B, T, n_out), plain PyTorch;
    ``power`` maps frames to |X|^2 in natural bin order (None: the
    config's form, ``spectrum.power_form``).  Every product
    runs at the config's precision mode, the DFT's at its compute dtype
    (``ops/spectrum``); the power, the band energies and the DCT matrix
    follow the accumulation dtype as the reference's XLA route does
    (``backend.accum_dtype``).  The kernels compute at float32 whatever
    it says: their twin is this function at :func:`kernel_config`."""
    backend.check_config(cfg)
    check_projection(projection, apply_dct)
    B, N = y.shape
    T = cfg.num_frames(N)
    if T == 0:
        return y.new_zeros((B, 0, n_out(cfg, apply_dct, projection)),
                           dtype=torch.float32)
    fr = framing.frames(y.to(torch.float32), cfg)
    p = (power or spectrum.power_form(cfg))(fr, cfg)
    if projection == "spec":
        return xmath.floored_log(p, cfg.log_floor)
    if projection == "bark":
        return xmath.floored_log(mel_op.band_energies(
            p, projection_matrix(cfg, "bark"), cfg, cast=True),
            cfg.log_floor)
    logmel = mel_op.log_mel_energies(p, cfg)
    if not apply_dct:
        return logmel
    feat = dct_op.cepstra(logmel, cfg)
    if cfg.append_energy:
        e = framing.log_energy(fr, cfg)
        feat = torch.cat([e[..., None], feat[..., 1:]], dim=-1)
    return feat


def _f32(a):
    return None if a is None else a.astype(np.float32)


@functools.lru_cache(maxsize=16)
def direct_matrices(cfg: FeatureConfig, projection: str = "mel"):
    """Float32 constants of the direct tile, from the float64 twins.

    basis (nbb, frame_len, 512): block k holds the window-folded cos (cols
      0..255) and sin (cols 256..511) of bins 256k .. 256k+255, zero past
      bin n_bins-2;
    last (frame_len, 2): cos and sin of the last bin n_bins-1 (the Nyquist
      for even n_fft), kept out of the blocks so they stay 256 wide;
    the projection (n_bins, n_mels or n_bark; None for "spec");
    dct (n_mels, n_mfcc), lifter folded in ("mel" only, else None).
    """
    return direct_blocks(
        *spectrum.dft_matrices(cfg), projection_matrix(cfg, projection),
        dct_op.dct_matrix(cfg) if projection == "mel" else None)


def direct_blocks(cos_m: np.ndarray, sin_m: np.ndarray, proj, dct) -> tuple:
    """:func:`direct_matrices`' float32 constants from float64 window-folded
    (frame_len, n_bins) cos and sin bases, a (n_bins, width) projection
    (or None) and a DCT (or None)."""
    fl, nb = cos_m.shape[0], cos_m.shape[1] - 1
    nbb = -(-nb // BINS_PER_BLOCK)
    basis = np.zeros((nbb, fl, 2 * BINS_PER_BLOCK), np.float32)
    for k in range(nbb):
        lo, hi = k * BINS_PER_BLOCK, min(nb, (k + 1) * BINS_PER_BLOCK)
        basis[k, :, : hi - lo] = cos_m[:, lo:hi]
        basis[k, :, BINS_PER_BLOCK: BINS_PER_BLOCK + hi - lo] = sin_m[:, lo:hi]
    last = np.stack([cos_m[:, nb], sin_m[:, nb]], axis=1).astype(np.float32)
    return basis, np.ascontiguousarray(last), _f32(proj), _f32(dct)


# Per FFT tile flavour: bytes per scalar, complex points per wave, pad
# shift, samples staged before the span (spectral::FftFlavour; the mixed
# tile is the float64 flavour's with spectral::kMixedWavePoints).
FFT_FLAVOURS = {"fft": (4, 2048, 5, 0), "fft64": (8, 1024, 4, 1),
                "fft64_mixed": (8, 2048, 4, 1)}
# blocks an SM per flavour (spectral::FftFlavour::kBlocks)
FFT_BLOCKS = {"fft": 4, "fft64": 3, "fft64_mixed": 3}
# the mixed tile's plan (must match spectral::kMixedPow2Radix)
MIXED_POW2_RADIX = 4
MAX_SMEM = 232448   # the H100's shared memory per block (opt-in), bytes


def fft_smem_bytes(cfg: FeatureConfig, tile: str, tm: int,
                   projection: str = "mel") -> int:
    """Shared-memory bytes of an FFT tile of tm frames for cfg
    (``spectral::fft_smem_bytes`` with ``launch_fft``'s pairs, a power of
    two, and span)."""
    size, wave, shift, lead = FFT_FLAVOURS[tile]
    n = cfg.n_fft
    pairs = min(1 << max(0, (wave // n).bit_length() - 1), tm // 2)
    span = ((tm - 1) * cfg.hop_len + cfg.frame_len + 3) // 4 * 4
    return (size * 4 * pairs * (n + (n >> shift))
            + 4 * (span + lead + tm * staged_width(cfg, projection) + 2 * tm))


def fft_frame_tile(cfg: FeatureConfig, tile: str,
                   projection: str = "mel") -> int | None:
    """The frame tile ``spectral::launch_fft`` picks for cfg on FFT flavour
    ``tile``: the largest of 64, 32, 16 frames whose shared memory lets the
    flavour's blocks share an SM (``fft_smem_target``), else 8 where it
    fits a block at all; None where nothing fits."""
    target = (228 // FFT_BLOCKS[tile] - 2) * 1024
    for tm in (64, 32, 16):
        if fft_smem_bytes(cfg, tile, tm, projection) <= target:
            return tm
    return 8 if fft_smem_bytes(cfg, tile, 8, projection) <= MAX_SMEM else None


def fft_radices(n: int) -> list | None:
    """The FFT tile's radix passes over n points, in order, the first
    reading the span: a power of two in radix-8 passes, then one radix-2
    or radix-4 pass where log2 n is no multiple of 3 (``fft_features``);
    n = 2^a 5^b with b >= 1 as ``spectral::mixed_plan`` plans it (the
    power-of-two part in radix-``MIXED_POW2_RADIX`` passes and one radix-2
    or radix-4 pass for the rest, the radix-5 passes after them); None
    for any other n."""
    a = (n & -n).bit_length() - 1 if n > 0 else 0
    m, b = n >> a, 0
    while m > 1 and m % 5 == 0:
        m, b = m // 5, b + 1
    if n < 1 or m != 1:
        return None
    if b == 0:
        return [8] * (a // 3) + ([1 << a % 3] if a % 3 else [])
    lr = MIXED_POW2_RADIX.bit_length() - 1
    pow2 = [MIXED_POW2_RADIX] * (a // lr) + ([1 << a % lr] if a % lr else [])
    return pow2 + [5] * b


def fft_tile(cfg: FeatureConfig, apply_dct: bool,
             projection: str = "mel", mixed: bool = False) -> str:
    """The tile the spectral entries run for cfg, decided from the config
    alone:

    - "fft", the f32 FFT tile, for cepstra and log-mel bounded to <= 50 dB
      (``routes.use_dit``, the reference's accuracy rule: the floors bound
      the spectral valleys);
    - "fft64", the tile's float64-front flavour, for other log-mel, for
      PLP's bark bands and for the spectrogram: in valleys ~120-140 dB
      deep an f32 FFT rounds up to 6x worse than the direct form, while
      float64 through |X|^2 holds the oracle;
    - "direct", the entry's other tile (the direct tile; the DIT tile in
      ``fused_dit``), where neither FFT flavour applies.

    The bark and spec projections were decided by the valley check of
    ``tests/test_torch_kernels.py::test_projection_valley_choice`` (the
    tile's numpy emulation against the float64 oracle, 16 kHz two-tone and
    bench-like signals, Hamming, Hann and Povey windows).  PLP-13 through
    the f32 tile is 1.76e-4 (Hann) and 2.72e-4 (Povey) off the oracle on
    the two tones, over the 2e-5 the f32 tile had to meet and over PLP's
    1e-4 contract, where the direct f32 form is 8.0e-5 and 5.6e-5 and the
    float64 front 2.1e-5 and 1.4e-5 (the f32 PLP tail's own error).  The
    spectrogram through the f32 tile is within 2.6e-5 inside the 50 dB
    window, but below it 5.1e-2 and 1.3e-2 off (two tones and bench-like,
    Hann) where the direct form is 3.9e-2 and 4.2e-3, and the float64
    front is within 2e-6 over every bin.

    Both flavours need a power-of-two n_fft from 64 to 4096 that holds the
    frame (``spectral::fft_tile_ok``) and a frame tile of 8 whose shared
    memory fits a block (:func:`fft_smem_bytes`).  In an entry with the
    mixed-radix tile (``mixed``: ``fused_raw`` alone), an n_fft from 64 to
    4096 of the form 2^a 5^b (b >= 1; Whisper's 400) that would take
    "fft64" takes "fft64_mixed", the same flavour with radix-5 passes
    beside the radix-2/4/8 ones (:func:`fft_radices`), on the band
    projections; the "fft" flavour and the other entries keep the direct
    tile there.  The factors of n_fft decide, no setting."""
    n = cfg.n_fft
    radices = fft_radices(n)
    if not (FFT_MIN <= n <= FFT_MAX and radices is not None
            and 1 <= cfg.frame_len <= n):
        return "direct"
    tile = ("fft" if projection == "mel" and routes.use_dit(cfg, apply_dct)
            else "fft64")
    if 5 in radices:
        if not (mixed and tile == "fft64" and projection != "spec"):
            return "direct"
        tile = "fft64_mixed"
    return (tile if fft_smem_bytes(cfg, tile, 8, projection) <= MAX_SMEM
            else "direct")


def mel_bands(melw: np.ndarray) -> np.ndarray:
    """(n_mels, 2) int32 [lo, hi): the first nonzero row of each mel column
    and one past its last ((0, 0) for an all-zero column)."""
    bands = np.zeros((melw.shape[1], 2), np.int32)
    for j in range(melw.shape[1]):
        nz = np.flatnonzero(melw[:, j])
        if nz.size:
            bands[j] = nz[0], nz[-1] + 1
    return bands


def mel_chunks(bands: np.ndarray, size: int = MEL_CHUNK):
    """Each band's range cut into chunks of at most ``size`` bins, in band
    order: -> chunks (n_chunks, 2) int32, bins [k0, k1), and band_chunks
    (n_mels, 2) int32, the chunks [c0, c1) of band j."""
    chunks, band_chunks = [], np.zeros((bands.shape[0], 2), np.int32)
    for j, (lo, hi) in enumerate(bands):
        band_chunks[j, 0] = len(chunks)
        chunks += [(k, min(k + size, hi)) for k in range(lo, hi, size)]
        band_chunks[j, 1] = len(chunks)
    return np.array(chunks, np.int32).reshape(-1, 2), band_chunks


@dataclasses.dataclass(frozen=True, eq=False)
class Front:
    """A front end's own analysis window (frame_len,) and filterbank
    (n_bins, n_bands), float64, which a config's fields cannot state
    (``models/whisper``, ``models/nemo``): the spectral entries build
    whichever tile's tables from these in place of the config's window and
    mel matrix, with no DCT.  ``guard``: the log is log(e + log_floor),
    NeMo's additive guard, in place of log(max(e, log_floor)); only
    ``fused_raw``'s "fft64" tile takes it.  Hashed by identity, so that
    the constant caches key on it: keep one per config."""
    window: np.ndarray
    bank: np.ndarray
    guard: bool = False


@functools.lru_cache(maxsize=8)
@report.timed("consts_s")
def plain_front_constants(front: Front, n_fft: int,
                          device: torch.device) -> tuple:
    """([cos | sin] (frame_len, 2 n_bins), bank (n_bins, n_bands)) float32
    on ``device``: the front's window folded into the n_fft-point DFT, and
    its bank."""
    cos_m, sin_m = spectrum.folded_dft(front.window, n_fft)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device)
                 for a in (np.concatenate([cos_m, sin_m], axis=1),
                           front.bank))


def plain_front_features(xp: torch.Tensor, cfg: FeatureConfig,
                         front: Front) -> torch.Tensor:
    """(B, L) rows -> (B, T, n_bands) natural logs of the front's band
    energies over cfg's "valid" frames, plain torch, float32 IEEE
    products: log(max(e, log_floor)), or log(e + log_floor) with the
    front's ``guard`` (the sum rounded to float32, as the kernel's
    epilogue rounds it).  The plain twin of ``fused_raw`` on a front."""
    basis, bank = plain_front_constants(front, cfg.n_fft, xp.device)
    fr = framing.frames(xp.to(torch.float32), cfg)
    spec = backend.matmul(fr, basis, "highest")
    re, im = spec[..., :cfg.n_bins], spec[..., cfg.n_bins:]
    power = xmath.mul_add(re, re, im * im, True)
    e = backend.matmul(power, bank, "highest")
    if front.guard:   # the float32 guard goes with the kernel: no upload
        return xmath.accurate_log(e + cfg.log_floor)
    return xmath.floored_log(e, cfg.log_floor)


@dataclasses.dataclass(frozen=True)
class RowBounds:
    """Where each row of a spectral entry's input holds its own samples
    (``framing.stft_center_batch``'s layout): row b's first
    min(lengths[b], chunk) samples begin at ``offset``, zeros the host
    wrote follow them, and a right reflect pad ends the row
    (:func:`zero_tail`).  ``lengths``: (B,) int64 on the input's device,
    which the kernel reads there (no host copy)."""
    lengths: torch.Tensor
    offset: int
    chunk: int


def zero_tail(length: int, offset: int, chunk: int, n: int) -> int:
    """``spectral::zero_tail``: the sample of a row of n from which every
    sample is a zero the host wrote, offset + min(length, chunk); n (none)
    where the right reflect pad of n - offset - chunk samples reflects a
    sample of the row."""
    pad, length = n - offset - chunk, max(int(length), 0)
    if pad > 0 and length > chunk - 1 - pad:
        return n
    return offset + min(length, chunk)


def first_skipped_frame(length: int, offset: int, chunk: int, n: int,
                        hop: int, tm: int) -> int:
    """The first frame of the first tile of tm frames that the mixed-radix
    tile skips in a row of n samples (``fft_mixed_features``' rule: a tile
    from frame t0 stages the samples from t0 hop - 1 on, and is skipped
    where all of them are past :func:`zero_tail`); every later tile is
    skipped too.  At least the row's frame count where none is."""
    return (zero_tail(length, offset, chunk, n) // hop + tm) // tm * tm


@functools.lru_cache(maxsize=16)
def fft_matrices(cfg: FeatureConfig, tile: str = "fft",
                 projection: str = "mel"):
    """Constants of the FFT tile's flavour ``tile`` for ``projection``,
    from the float64 twins (:func:`fft_tables` of the config's window,
    projection and DCT).

    window (frame_len,): the analysis window (``spectrum.dft_matrices``'
      window, unfolded);
    twiddles (n_fft, 2): cos and sin of 2 pi m / n_fft;
      both float32 for "fft", float64 for "fft64" (rounded to float32 they
      would put an eps32 x peak floor back into every bin);
    chunk_w (n_chunks, MEL_CHUNK) f32: chunk c's projection weights,
      zero-padded;
    chunks (n_chunks, 2), band_chunks (n_bands, 2) int32: :func:`mel_chunks`
      of the nonzero ranges (:func:`mel_bands`) of the f32 projection (the
      mel or the bark matrix: any banded nonnegative matrix);
    dct (n_mels, n_mfcc) f32, lifter folded in ("mel" only).
    "spec" has no projection: chunk_w, chunks, band_chunks and dct are None.
    """
    return fft_tables(oracle.window_fn(cfg.window, cfg.frame_len),
                      cfg.n_fft, projection_matrix(cfg, projection),
                      dct_op.dct_matrix(cfg) if projection == "mel" else None,
                      tile)


def fft_tables(window: np.ndarray, n_fft: int, proj, dct, tile: str):
    """:func:`fft_matrices`' constants from a float64 window, n_fft, a
    (n_bins, width) float64 projection (None: the spectrogram's) and a
    DCT (or None), for flavour ``tile``."""
    ang = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    win = np.asarray(window, np.float64)
    if tile == "fft":
        tw, win = tw.astype(np.float32), win.astype(np.float32)
    if proj is None:
        return np.ascontiguousarray(win), tw, None, None, None, None
    melw = proj.astype(np.float32)
    chunks, band_chunks = mel_chunks(mel_bands(melw))
    chunk_w = np.zeros((chunks.shape[0], MEL_CHUNK), np.float32)
    for j, (c0, c1) in enumerate(band_chunks):
        for c in range(c0, c1):
            k0, k1 = chunks[c]
            chunk_w[c, : k1 - k0] = melw[k0:k1, j]
    return (np.ascontiguousarray(win), tw, chunk_w, chunks, band_chunks,
            _f32(dct))


@functools.lru_cache(maxsize=16)
@report.timed("consts_s")
def _device_fft_matrices(cfg: FeatureConfig, tile: str, projection: str,
                         device: torch.device, front: Front | None = None):
    """The constants of FFT flavour ``tile`` on one device, uploaded once
    per (config, flavour, projection, device, front) and kept: the
    config's, or the front end's (``front``)."""
    arrays = (fft_matrices(cfg, tile, projection) if front is None else
              fft_tables(front.window, cfg.n_fft, front.bank, None, tile))
    return tuple(None if a is None else torch.from_numpy(a).to(device)
                 for a in arrays)


def pinned(arrays) -> tuple:
    """numpy constants -> page-locked CPU tensors (cache the result per
    config; each call then uploads with ``to(device, non_blocking=True)``);
    None stays None."""
    return tuple(None if a is None else torch.from_numpy(a).pin_memory()
                 for a in arrays)


@functools.lru_cache(maxsize=16)
@report.timed("consts_s")
def _pinned_direct_matrices(cfg: FeatureConfig, projection: str,
                            front: Front | None = None):
    if front is None:
        return pinned(direct_matrices(cfg, projection))
    return pinned(direct_blocks(*spectrum.folded_dft(front.window, cfg.n_fft),
                                front.bank, None))


def kernel_config(cfg: FeatureConfig) -> FeatureConfig:
    """cfg as the kernels compute it: accum_dtype float32, which no kernel
    reads, as the reference's Pallas kernels read none
    (``mfcc_tpu/ops/kernels/``).  So every accumulation dtype reaches the
    float32 config's kernel, tile and bits."""
    return (cfg if cfg.accum_dtype == "float32"
            else cfg.replace(accum_dtype="float32"))


def check_input(x: torch.Tensor, cfg: FeatureConfig) -> FeatureConfig:
    """The checks every spectral wrapper makes before it picks a path;
    -> the config the kernel computes (:func:`kernel_config`), which its
    plain version runs on a CPU tensor."""
    backend.check_config(cfg)
    if x.dim() != 2:
        raise ValueError(f"batch input (B, N) expected, got {tuple(x.shape)}")
    if cfg.frame_mode != "valid":
        raise ValueError("resolve frame_mode='center' to 'valid' first "
                         "(ops.framing.resolve_frame_mode)")
    return kernel_config(cfg)


def check_bounds(x: torch.Tensor, bounds: RowBounds) -> None:
    """The row bounds the C entry reads: (B,) contiguous int64 on x's
    device, a nonnegative offset and chunk."""
    n = bounds.lengths
    if (n.dtype != torch.int64 or n.shape != x.shape[:1]
            or n.device != x.device or not n.is_contiguous()):
        raise ValueError(f"row lengths: ({x.shape[0]},) contiguous int64 on "
                         f"{x.device} expected, got {tuple(n.shape)} "
                         f"{n.dtype} on {n.device}")
    if bounds.offset < 0 or bounds.chunk < 0:
        raise ValueError(f"row bounds: offset {bounds.offset} and chunk "
                         f"{bounds.chunk} must be >= 0")


def check_cuda_input(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"float32 audio expected, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("contiguous audio expected")


def epilogue_args(cfg: FeatureConfig, apply_dct: bool,
                  projection: str = "mel") -> tuple:
    """(n_mels, n_out, log_floor, rel_floor, append_energy, apply_dct) as
    the C entries take them; the energy column is a cepstral feature (c0),
    so it is gated on apply_dct as the reference gates it.  The bark and
    spec projections take no relative floor and no energy column, as the
    reference's plan (``fused_raw_dit.py:176-184``); their width goes in
    n_mels and n_out, and apply_dct goes as given (the C entry refuses it
    there)."""
    if projection != "mel":
        width = n_out(cfg, False, projection)
        return (width, width, cfg.log_floor, 0.0, 0, int(apply_dct))
    return (cfg.n_mels, n_out(cfg, apply_dct), cfg.log_floor,
            mel_op.relative_floor(cfg),
            int(cfg.append_energy and apply_dct), int(apply_dct))


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (n_mels, n_out, log_floor, rel_floor, append_energy, apply_dct)
EPILOGUE_ARGTYPES = [_I, _I, _F, _F, _I, _I]
# the direct tile's constants: (basis, nbb, last, melw)
DIRECT_ARGTYPES = [_P, _I, _P, _P]
# the tile codes of the C entries (spectral::Tile; the other tile is 0)
TILE_CODES = {"fft": 1, "fft64": 2, "fft64_mixed": 3}
# the entry with the mixed-radix tile: the log guard (Front.guard, 0 or 1),
# then the row bounds (lengths, offset, chunk) (RowBounds)
BOUNDS_ARGTYPES = [_I, _P, ctypes.c_longlong, ctypes.c_longlong]


def entry_argtypes(other, preemph: bool, projection: bool = False,
                   mixed: bool = False) -> list:
    """The C types of a spectral entry: (x, B, N, T, *the other tile's
    constants (``other``), win, tw, chunk_w, chunks, band_chunks, n_chunks,
    dctm, out, frame_len, hop, n_bins, n_fft, tile[, preemph as a double]
    [, projection code][, the log guard and the row bounds of the entry
    with the mixed-radix tile], *epilogue, stream)."""
    return ([_P, _I, ctypes.c_longlong, _I, *other, _P, _P, _P, _P, _P, _I,
             _P, _P, _I, _I, _I, _I, _I]
            + ([ctypes.c_double] if preemph else [])
            + ([_I] if projection else [])
            + (BOUNDS_ARGTYPES if mixed else [])
            + EPILOGUE_ARGTYPES + [_P])


def bind(name: str, entry: str, argtypes) -> ctypes.CDLL:
    """Build and load ``csrc/<name>.cu`` and declare the C types of its
    entry and of the error-string and acc_log entries that every spectral
    source exports."""
    lib = _build.load(name)
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.mfcc_error_string.argtypes = [ctypes.c_int]
    lib.mfcc_error_string.restype = ctypes.c_char_p
    lib.mfcc_acc_log.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.c_void_p]
    lib.mfcc_acc_log.restype = ctypes.c_int
    return lib


def raise_on_error(err: int, lib, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.mfcc_error_string(err).decode()} ({err})")


def _empty_out(x: torch.Tensor, cfg: FeatureConfig, apply_dct: bool,
               projection: str):
    B, N = x.shape
    return torch.empty((B, cfg.num_frames(N),
                        n_out(cfg, apply_dct, projection)),
                       dtype=torch.float32, device=x.device)


def direct_consts(cfg: FeatureConfig, device: torch.device,
                  projection: str = "mel", front: Front | None = None):
    """The direct tile's constants as the entries take them, uploaded from
    pinned memory on the current stream: -> ([basis, nbb, last, melw],
    dctm); melw is the projection (None for "spec"; the bank of a
    ``front``), dctm None but for "mel" without a front."""
    basis, last, melw, dctm = (
        None if t is None else t.to(device, non_blocking=True)
        for t in _pinned_direct_matrices(cfg, projection, front))
    return [basis, basis.shape[0], last, melw], dctm


# an entry's other tile: (its name, its constants, their nulls)
DIRECT_TILE = ("direct", direct_consts, [None, 0, None, None])


def direct_tile(projection: str, front: Front | None = None):
    """The direct tile with the projection's constants, or a front end's."""
    if projection == "mel" and front is None:
        return DIRECT_TILE
    return ("direct", functools.partial(direct_consts, projection=projection,
                                        front=front), DIRECT_TILE[2])


def _arg(a):
    return a.data_ptr() if isinstance(a, torch.Tensor) else a


def launch_spectral(lib_fn, entry: str, name: str, x: torch.Tensor,
                    cfg: FeatureConfig, apply_dct: bool,
                    preemph: float | None, other=DIRECT_TILE,
                    tile: str | None = None, projection: str | None = None,
                    front: Front | None = None, mixed: bool = False,
                    bounds: RowBounds | None = None):
    """Launch a spectral entry on x's device and current stream.

    The tile is :func:`fft_tile`'s pick for the config (``mixed``: the
    entry has the mixed-radix tile and takes the log guard and the row
    bounds), or ``tile`` where the caller names one (to time the tile a kernel replaced on the
    same work; the C entry refuses one the shape does not allow).  An FFT flavour reads its
    constants from the device (:func:`_device_fft_matrices`, of the
    ``front`` where one is given); the entry's other tile, ``other`` =
    (name, consts(cfg, device) -> (its constants, dctm), their nulls),
    uploads its constants per call (a front's through
    :func:`direct_tile`); the tile not run gets nulls.  A call that runs
    the direct tile counts its B x T frames in ``frames_direct``.
    ``bounds`` (x must be ``framing.stft_center_batch``'s output) goes to
    the mixed-radix tile, which skips the frame tiles wholly in the rows'
    zero tails; a call that runs that tile with them counts its B x T
    frames in ``frames_bounded``, and any other tile computes every frame.
    A front with ``guard`` runs on the "fft64" tile of an entry with the
    mixed tile alone (else ValueError), and its call counts B x T in
    ``frames_guarded``.
    preemph goes to the entries that pre-emphasize in the kernel (None for
    ``fused_mfcc`` and ``fused_dit``).  ``projection`` goes to the entry that takes one
    (``fused_raw_dit``; None for the others, which project on mel); the
    other tile's constants must be that projection's
    (:func:`direct_tile`).  lib_fn() loads the library (not called for an
    empty output).  -> out.  The launch is recorded under ``name``, its
    tile and its projection (``report.launched``; an empty output
    launches nothing), and a profiler trace shows it under ``name``.
    """
    proj = projection or "mel"
    out = _empty_out(x, cfg, apply_dct, proj)
    if out.numel() == 0:
        return out
    lib = lib_fn()
    other_name, other_consts, other_nulls = other
    tile = tile or fft_tile(cfg, apply_dct, proj, mixed)
    if tile == "direct":
        tile = other_name
    if tile == "direct":
        report.count("frames_direct", out.shape[0] * out.shape[1])
    if bounds is not None:
        if not mixed:
            raise ValueError("row bounds go to an entry with the mixed tile")
        check_bounds(x, bounds)
        if tile == "fft64_mixed":
            report.count("frames_bounded", out.shape[0] * out.shape[1])
    guard = front is not None and front.guard
    if guard:
        if not (mixed and tile == "fft64"):
            raise ValueError(f"the additive log guard runs on fused_raw's "
                             f"fft64 tile alone, not {name}'s {tile!r}")
        report.count("frames_guarded", out.shape[0] * out.shape[1])
    with torch.cuda.device(x.device), report.span(name):
        if tile in TILE_CODES:
            *fft, dctm = _device_fft_matrices(cfg, tile, proj, x.device,
                                              front)
            n_chunks = 0 if fft[3] is None else fft[3].shape[0]
            consts = other_nulls + fft[:5] + [n_chunks]
        else:
            lead, dctm = other_consts(cfg, x.device)
            consts = lead + [None] * 5 + [0]
        args = [x, *x.shape, out.shape[1], *consts, dctm, out, cfg.frame_len,
                cfg.hop_len, cfg.n_bins, cfg.n_fft, TILE_CODES.get(tile, 0)]
        if preemph is not None:
            args.append(preemph)
        if projection is not None:
            args.append(PROJECTION_CODES[projection])
        if mixed:
            args += [int(guard)] + ([None, 0, 0] if bounds is None else
                                    [bounds.lengths, bounds.offset,
                                     bounds.chunk])
        err = getattr(lib, entry)(
            *map(_arg, args), *epilogue_args(cfg, apply_dct, proj),
            torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error(err, lib, name)
    report.launched(name, tile, projection)
    return out
