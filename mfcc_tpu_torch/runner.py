"""Corpus runner: a WAV corpus -> feature files, resumably (the twin of
``mfcc_tpu/runner.py``).

Shape-bucketed padded batches or packed rows, per-utterance quarantine (a
corrupt WAV is skipped and logged, never kills the job), manifest-based
resume, optional global CMVN in two passes, and a JSON run report with
its own oracle self-check and stage timings.

One process computes on one device: ``RunnerOptions.device``, "cuda" by
default (``cuda:{LOCAL_RANK}`` under ``torch.distributed``); only an
explicit "cpu" runs on the host.  The reference's in-process mesh (one
dispatch sharded over a host's chips) maps to one process per GPU
(``parallel/dist``): each process reads its own strided shard of the
listing and writes its own manifest, writer files and report, and the one
exchange between processes is the sum of the float64 CMVN statistics over
gloo.

The loop is a depth-2 pipeline, as in the reference: batch N's features
are copied to pinned host memory (``non_blocking``) right after N is
enqueued, with an event recorded behind the copy; batch N+1 is decoded and
enqueued; then N is written, after a wait on N's event alone (a plain
``.cpu()`` would wait for N+1's work too).  Host-to-device copies go from
pinned memory; PyTorch's pinned allocator does not hand a buffer out again
while a copy from it is in flight.

Differences from the reference, on purpose:

- decoding needs the native decoder (``mfcc_tpu_torch.native``); a build
  or load failure raises, nothing falls back to the pure-Python parser;
- the probe quarantines headers of an encoding the decoders do not take;
- the packed loop quarantines a WAV whose decoded length differs from its
  probed length (a header that promises more data than the file holds):
  the reference computes the missing tail over zeros and writes it;
- the relay's chunked device-to-host fetch is not ported.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import native, oracle
from .config import FeatureConfig, PitchConfig
from .models import logmel as logmel_model, mfcc as mfcc_model
from .models import pitch as pitch_model, plp as plp_model
from .models import spectrogram as spec_model
from .ops import dither as dither_op, framing, post, resample as resample_op
from .ops import spectrum
from .parallel import cmvn as cmvn_lib, dist
from .utils import (batch as batch_lib, htk as htk_lib, kaldi as kaldi_lib,
                    manifest as manifest_lib, report, tfrecord, wav)


class NpyWriter:
    """One .npy per utterance (default).  Incremental by construction:
    every write is durable before the manifest marks the utterance."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir

    def write(self, uid: str, feat: np.ndarray):
        np.save(_out_path(self.out_dir, uid), feat)

    def finish(self):
        pass

    def apply_cmvn(self, uids, mean, inv_std):
        for uid in uids:
            fp = _out_path(self.out_dir, uid)
            if os.path.exists(fp):
                # float64 statistics, float32 output (as ark / tfrecord)
                np.save(fp, ((np.load(fp) - mean) * inv_std)
                        .astype(np.float32))


class HTKWriter:
    """One .htk per utterance (HTK parameter files, utils/htk.py), with
    NpyWriter's durability: written before the manifest marks it."""

    def __init__(self, out_dir: str, frame_period_s: float):
        self.out_dir = out_dir
        self.period = frame_period_s

    def _path(self, uid: str) -> str:
        base = os.path.splitext(os.path.basename(uid))[0]
        return os.path.join(self.out_dir, base + ".htk")

    def write(self, uid: str, feat: np.ndarray):
        htk_lib.write_htk(self._path(uid), feat, self.period)

    def finish(self):
        pass

    def apply_cmvn(self, uids, mean, inv_std):
        for uid in uids:
            fp = self._path(uid)
            if os.path.exists(fp):
                feat, period, kind = htk_lib.read_htk(fp)
                htk_lib.write_htk(fp, (feat - mean) * inv_std, period, kind)


class TFRecordWriter:
    """TFRecord of tf.train.Examples: features.<process>.tfrecord.

    Appends each utterance as soon as it is computed (durable before the
    manifest marks it), so an interrupted run keeps what it wrote and a
    resumed run appends the rest.  On open, an incomplete tail record from
    a crash mid-append is truncated away."""

    def __init__(self, out_dir: str, host: int, resume: bool = True):
        self.path = os.path.join(out_dir, f"features.{host}.tfrecord")
        if resume:
            dropped = tfrecord.truncate_incomplete_tail(self.path)
            if dropped:
                print(f"[resume] {self.path}: dropped {dropped} bytes of "
                      "incomplete tail record")
        self.f = open(self.path, "ab" if resume else "wb")

    def write(self, uid: str, feat: np.ndarray):
        tfrecord.append_record(
            self.f, os.path.splitext(os.path.basename(uid))[0], feat)

    def finish(self):
        self.f.close()

    def apply_cmvn(self, uids, mean, inv_std):
        feats = tfrecord.read_tfrecord(self.path)  # duplicate uids: last wins
        tfrecord.write_tfrecord(
            self.path, {u: (f - mean) * inv_std for u, f in feats.items()},
            atomic=True)


class ArkWriter:
    """Kaldi binary archive: features.<process>.{ark,scp} (utils/kaldi.py).

    Appends entries incrementally (ark bytes flushed before the scp index
    line, the scp line before the manifest marks the utterance), so an
    interrupted run loses nothing.  The CMVN apply pass rewrites the
    archive atomically, which also drops orphaned ark bytes."""

    def __init__(self, out_dir: str, host: int, resume: bool = True):
        self.prefix = os.path.join(out_dir, f"features.{host}")
        self.ark = open(self.prefix + ".ark", "ab" if resume else "wb")
        self.scp = open(self.prefix + ".scp", "a" if resume else "w")

    def write(self, uid: str, feat: np.ndarray):
        kaldi_lib.append_ark_entry(
            self.ark, self.scp, self.prefix + ".ark",
            os.path.splitext(os.path.basename(uid))[0], feat)

    def finish(self):
        self.ark.close()
        self.scp.close()

    def apply_cmvn(self, uids, mean, inv_std):
        feats = kaldi_lib.read_scp(self.prefix + ".scp")  # dup uids: last wins
        feats = {u: (f - mean) * inv_std for u, f in feats.items()}
        kaldi_lib.write_ark_scp(self.prefix, feats, atomic=True)


@dataclass
class RunnerOptions:
    out_dir: str = "features"
    batch_size: int = 16
    logmel: bool = False              # log-mel pipeline instead of MFCC
    plp: bool = False                 # PLP pipeline instead of MFCC
    spectrogram: bool = False         # log-power spectrogram (T, n_bins)
    pitch: bool = False               # append 3-dim pitch features
    cmvn_sliding: int = 0             # sliding-window CMVN (frames; 0 off)
    cmvn_online: int = 0              # causal online CMVN window (0 off)
    cmvn_online_prior: str | None = None  # cmvn.npz blended while young
    splice: int = 0                   # symmetric context splice (0 off)
    pack: bool = False                # splittable multi-utterance rows
                                      # (utils/batch.pack_rows_split); the
                                      # four families, optionally with
                                      # global CMVN; not with the per-row
                                      # post chain, deltas, centre framing
                                      # or resample
    pack_seconds: float = 10.0        # packed row capacity (seconds)
    vad: bool = False                 # append a 0/1 energy-VAD column,
                                      # last, from the audio
    vad_context: int = 0              # +-context majority vote (frames)
    min_bucket: int = 16_000          # 1 s
    max_bucket: int = 16_000 * 30     # 30 s
    resume: bool = True
    trace_dir: str | None = None      # torch.profiler Chrome trace here
    backend: str = "auto"             # backend.BACKENDS
    out_format: str = "npy"           # "npy" | "ark" | "htk" | "tfrecord"
    ladder: list = field(default_factory=list)
    # convert foreign-rate WAVs to cfg.sample_rate on the host (polyphase
    # Kaiser sinc, ops/resample) instead of quarantining them
    resample: bool = False
    # the device this process computes on: "cuda" (cuda:{LOCAL_RANK} under
    # torch.distributed), "cuda:k", or "cpu"
    device: str = "cuda"


def resolve_device(name: str) -> torch.device:
    """RunnerOptions.device -> the torch.device this process computes on.
    "cuda" without a card raises: the host runs only when asked."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; run with "
                               "device='cpu' (--device cpu) to compute on "
                               "the host")
        if dev.index is None:
            dev = torch.device("cuda", dist.local_device_index())
    return dev


def collect_wavs(path: str) -> list[str]:
    """A .wav file, a directory (recursive), or a .txt listing."""
    if os.path.isdir(path):
        out = []
        for root, _dirs, files in os.walk(path):
            out += [os.path.join(root, f) for f in files
                    if f.lower().endswith(".wav")]
        return sorted(out)
    if path.lower().endswith(".txt"):
        with open(path) as f:
            return [ln.strip() for ln in f if ln.strip()]
    return [path]


def _probe(paths, cfg, on_bad=None, resample=False):
    """Header-only probe: yield (path, n_samples at cfg.sample_rate);
    quarantine corrupt files and encodings the decoders do not take, and
    foreign-rate files unless the resample policy is on (then bucket by
    the converted length)."""
    for p in paths:
        try:
            n, sr = wav.probe(p)
        except (OSError, ValueError) as e:
            print(f"[quarantine] {p}: {e}")
            if on_bad:
                on_bad(p)
            continue
        if sr != cfg.sample_rate:
            if resample:
                yield p, resample_op.resampled_length(n, sr, cfg.sample_rate)
                continue
            print(f"[quarantine] {p}: sample rate {sr} != {cfg.sample_rate} "
                  "(pass --resample to convert instead)")
            if on_bad:
                on_bad(p)
            continue
        yield p, n


def _resample_row(p, cfg, bucket):
    """Decode and host-resample one foreign-rate file -> (f32 row, length):
    float64 polyphase then float32, the input the self-check reproduces."""
    x, sr = wav.read_wav(p)
    y = resample_op.resample_poly_numpy(x, sr, cfg.sample_rate)
    y = y.astype(np.float32)[:bucket]
    return y, len(y)


def _decode_batch(pb, cfg, resample=False):
    """Decode a PathBatch -> (audio (B, bucket) int16 or float32, lengths
    (B,) int32), through the native decoder.

    PCM16 passthrough (raw int16, half the host-to-device bytes; the
    models cast on the device) unless a file of the batch is not mono
    PCM16: then the whole batch takes the float decoder, so the dtype stays
    uniform.  Rows that fail late (corrupt despite a sane header) are
    quarantined by a zero length; foreign-rate rows are host-resampled
    when the resample policy is on (which makes the batch float)."""
    B = len(pb.paths)
    real = [p for p in pb.paths if p is not None]   # Nones pad the tail
    a, lens, rates, errors = native.read_wavs_padded_i16(real, pb.bucket)
    if np.any(errors == -6):  # not mono PCM16: the float decoder
        a, lens, rates, errors = native.read_wavs_padded(real, pb.bucket)
    if resample and np.any((errors == 0) & (rates != cfg.sample_rate)) \
            and a.dtype == np.int16:
        a = a.astype(np.float32) * (1.0 / 32768.0)
    for i, p in enumerate(real):
        if errors[i] != 0:
            print(f"[quarantine] {p}: native decode error {errors[i]} "
                  f"({native.ERRORS.get(int(errors[i]), '?')})")
            lens[i] = 0
        elif rates[i] != cfg.sample_rate:
            if resample:
                try:
                    row, L = _resample_row(p, cfg, pb.bucket)
                    a[i] = 0
                    a[i, :L] = row
                    lens[i] = L
                    continue
                except (OSError, ValueError) as e:
                    print(f"[quarantine] {p}: resample failed: {e}")
            else:
                print(f"[quarantine] {p}: sample rate {rates[i]}")
            lens[i] = 0
            a[i] = 0
    audio = np.zeros((B, pb.bucket), a.dtype)
    lengths = np.zeros((B,), np.int32)
    audio[: len(real)] = a
    lengths[: len(real)] = lens.astype(np.int32)
    return audio, lengths


def _base_feature_fn(opts):
    if opts.logmel:
        return logmel_model.log_mel_batch
    if opts.plp:
        return plp_model.plp_batch
    if opts.spectrogram:
        return spec_model.log_spectrogram_batch
    return mfcc_model.mfcc_batch


def _oracle_fn(opts):
    return (oracle.log_mel if opts.logmel else oracle.plp if opts.plp
            else oracle.log_spectrogram if opts.spectrogram else oracle.mfcc)


def _pitch_config(cfg):
    """PitchConfig of the main FeatureConfig: the same frame and hop
    (align_pitch pastes pitch frame t onto main frame t) and a work rate
    capped at the input rate."""
    return PitchConfig(sample_rate=cfg.sample_rate,
                       frame_ms=cfg.frame_ms, hop_ms=cfg.hop_ms,
                       work_rate=min(4000, cfg.sample_rate)).validate()


def _load_online_prior(opts):
    """cmvn.npz -> f32 (count, sum (F,), sumsq (F,)) for the prior blend,
    or None."""
    if not (opts.cmvn_online and opts.cmvn_online_prior):
        return None
    with np.load(opts.cmvn_online_prior) as z:
        return (np.float32(z["count"]), z["sum"].astype(np.float32),
                z["sumsq"].astype(np.float32))


def _feature_fn(opts):
    """(audio, lengths, cfg, backend) -> (feat, flens, mask): the family's
    batch model, then pitch, the post chain and the VAD column."""
    base = _base_feature_fn(opts)
    if not (opts.pitch or opts.cmvn_sliding or opts.cmvn_online
            or opts.splice or opts.vad):
        return base
    prior = _load_online_prior(opts)

    def wrapped(a, l, cfg, backend="auto"):
        feat, flens, mask = base(a, l, cfg, backend)
        if opts.pitch:
            pf, pl, _ = pitch_model.pitch_batch(a, l, _pitch_config(cfg),
                                                backend)
            pf = pitch_model.align_pitch(pf, pl, feat.shape[1])
            pf = torch.where(mask[..., None], pf, 0.0)
            feat = torch.cat([feat, pf], dim=-1)
        if opts.cmvn_sliding:               # Kaldi order: cmvn, then splice
            feat = post.sliding_cmvn(feat, flens, opts.cmvn_sliding)
        if opts.cmvn_online:
            feat = post.online_cmvn(feat, flens, opts.cmvn_online,
                                    prior=prior)
        if opts.splice:
            feat = post.splice(feat, flens, opts.splice, opts.splice)
        if opts.vad:
            # energy VAD from the audio (the pre-emphasized frame log
            # energy of the append_energy path), appended last so that it
            # stays one clean 0/1 column after cmvn and splice
            x = a
            if x.dtype == torch.int16:
                x = x.to(torch.float32) * (1.0 / 32768.0)
            x = dither_op.apply(x, cfg)
            x, _vl, vcfg = framing.resolve_frame_mode(
                x, l, cfg.replace(dither=0.0))
            le = spectrum.log_energy_blocked(framing.preemphasize(x, vcfg),
                                             vcfg)
            v = post.energy_vad(le[:, : feat.shape[1]], flens,
                                context=opts.vad_context)
            feat = torch.cat([feat, v.to(feat.dtype)[..., None]], dim=-1)
        return feat, flens, mask

    return wrapped


def _out_path(out_dir: str, wav_path: str) -> str:
    base = os.path.splitext(os.path.basename(wav_path))[0]
    return os.path.join(out_dir, base + ".npy")


def _global_stats(stats: cmvn_lib.Stats) -> cmvn_lib.Stats:
    """Sum the float64 CMVN statistics over every process (the input as
    it is in a world of one): each process accumulates over its own shard,
    and this all-reduce of a count and two (F,) vectors over gloo is the
    only traffic between processes."""
    return cmvn_lib.Stats(*dist.all_reduce_sum_f64(stats))


def _to_host_async(tensors, dev):
    """Enqueue each tensor's copy into pinned host memory behind the
    work on dev's current stream -> (host tensors, event to wait on).  On
    the CPU: the tensors as they are, no event."""
    if dev.type != "cuda":
        return list(tensors), None
    hosts = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        hosts.append(h)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return hosts, ev


def _to_device(arrays, dev):
    """numpy arrays -> tensors on dev, from pinned memory on a card."""
    out = []
    for a in arrays:
        t = torch.from_numpy(a)
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out.append(t)
    return out


def run(corpus: str, cfg: FeatureConfig,
        opts: RunnerOptions) -> report.RunReport:
    """Extract features for a corpus.  -> the run report.

    Multi-process safe: compute stays on this process's device, writers
    and manifests are per process, and the one exchange between processes
    is the CMVN statistics' all-reduce (_global_stats).

    Resume is exact for every writer: features are durable on disk before
    the manifest marks them, the CMVN accumulator is checkpointed
    atomically with the manifest, and the apply pass normalizes every
    utterance of the corpus (done and resumed), once.
    """
    cfg.validate()
    if opts.vad and cfg.cmvn:
        raise ValueError(
            "vad cannot be combined with global two-pass CMVN: the apply "
            "pass rewrites every stored column, which would normalize the "
            "0/1 VAD indicator (use cmvn_sliding/cmvn_online, or run VAD "
            "in a separate pass)")
    if opts.pack:
        bad = [nm for nm, on in (
            ("pitch", opts.pitch), ("cmvn_sliding", opts.cmvn_sliding),
            ("cmvn_online", opts.cmvn_online), ("splice", opts.splice),
            ("vad", opts.vad), ("deltas", cfg.deltas),
            ("resample", opts.resample),
            ("frame_mode=center", cfg.frame_mode != "valid")) if on]
        if bad:
            raise ValueError(
                f"pack supports plain feature extraction (MFCC/log-mel/"
                f"PLP/spectrogram, optionally with global --cmvn); "
                f"incompatible with: {', '.join(bad)} (per-row "
                f"post-processing and time-recursive stages cannot cross "
                f"segment boundaries)")
    dev = resolve_device(opts.device)
    rank = dist.process_index()
    os.makedirs(opts.out_dir, exist_ok=True)
    rep = report.RunReport(config_hash=cfg.config_hash(), n_devices=1,
                           n_hosts=dist.process_count())
    all_paths = dist.host_shard(collect_wavs(corpus))
    man = manifest_lib.Manifest(
        os.path.join(opts.out_dir, f"manifest.{rank}.json"),
        cfg.config_hash()) if opts.resume else None
    paths = man.pending(all_paths) if man is not None else all_paths
    if man is not None and man.cmvn_applied and cfg.cmvn and paths:
        raise RuntimeError(
            f"{man.path}: CMVN was already applied to this output dir but "
            f"{len(paths)} new utterances are pending — normalizing them "
            "with updated statistics would leave the archive inconsistent. "
            "Use a fresh out_dir (or resume=False).")

    ladder = opts.ladder or batch_lib.bucket_ladder(
        opts.min_bucket, opts.max_bucket)
    fn = _feature_fn(opts)
    batch_size = opts.batch_size
    writer = {"npy": lambda: NpyWriter(opts.out_dir),
              "ark": lambda: ArkWriter(opts.out_dir, rank, opts.resume),
              "htk": lambda: HTKWriter(opts.out_dir, cfg.hop_ms / 1000.0),
              "tfrecord": lambda: TFRecordWriter(opts.out_dir, rank,
                                                 opts.resume),
              }[opts.out_format]()

    stats_path = os.path.join(opts.out_dir, "cmvn.npz")
    n_feats = (cfg.n_bins if opts.spectrogram
               else cfg.n_feats if not opts.logmel
               else cfg.n_mels * (3 if cfg.deltas else 1))
    if opts.pitch:
        n_feats += 3
    if opts.splice:
        n_feats *= 2 * opts.splice + 1
    if opts.vad:
        n_feats += 1   # the trailing 0/1 column (global CMVN forbids it)
    f64 = dict(dtype=torch.float64)
    stats = cmvn_lib.Stats(torch.zeros((), **f64), torch.zeros(n_feats, **f64),
                           torch.zeros(n_feats, **f64))
    if man is not None and man.cmvn is not None:
        # resume: start from the accumulator checkpointed with the done-set
        stats = stats.merge(cmvn_lib.Stats(
            *(torch.as_tensor(np.asarray(v, np.float64)) for v in man.cmvn)))

    def _self_check(pb, lengths, feat_np, flens_np):
        """Differential spot check: the run's first real utterance against
        the float64 oracle, so every report carries its own accuracy
        (rep.max_abs_error; the pitch columns in max_abs_error_pitch)."""
        for i, p in enumerate(pb.paths):
            if p is None or lengths[i] == 0 or flens_np[i] == 0:
                continue
            try:
                x, _sr = wav.read_wav(p)
            except (OSError, ValueError):
                continue
            if _sr != cfg.sample_rate:
                # the ingestion resample exactly (float64, cast to f32)
                x = resample_op.resample_poly_numpy(
                    x, _sr, cfg.sample_rate).astype(np.float32)
            want = _oracle_fn(opts)(x[: lengths[i]].astype(np.float64), cfg)
            if opts.pitch:
                pw = oracle.pitch(x[: lengths[i]].astype(np.float64),
                                  _pitch_config(cfg))
                if pw.shape[0] == 0:
                    pw = np.zeros((want.shape[0], 3))
                else:  # edge-replicate to the main track (align_pitch)
                    idx = np.minimum(np.arange(want.shape[0]),
                                     pw.shape[0] - 1)
                    pw = pw[idx]
                want = np.concatenate([want, pw], axis=-1)
            if opts.cmvn_sliding:
                want = oracle.sliding_cmvn(want, opts.cmvn_sliding)
            if opts.cmvn_online:
                pr = _load_online_prior(opts)
                if pr is not None:
                    pr = (float(pr[0]), pr[1].astype(np.float64),
                          pr[2].astype(np.float64))
                want = oracle.online_cmvn(want, opts.cmvn_online, prior=pr)
            if opts.splice:
                want = oracle.splice(want, opts.splice, opts.splice)
            got = feat_np[i, : flens_np[i]]
            if cfg.cmvn:
                return  # features are pre-normalization here; skip
            if opts.vad:
                # the trailing 0/1 VAD column is a threshold decision that
                # f32 against f64 energy may flip at the threshold: kept
                # out of the error (parity on margin-clear signals is
                # test-pinned)
                got = got[:, :-1]
            diff = np.abs(got[: want.shape[0]] - want)
            # the pitch columns carry their own contract (norm <= 3e-4);
            # splice stacks copies of every column, so the mask tiles
            reps = 2 * opts.splice + 1 if opts.splice else 1
            n_pitch = 3 if opts.pitch else 0
            col_is_pitch = np.asarray(
                ([False] * (want.shape[1] // reps - n_pitch)
                 + [True] * n_pitch) * reps)
            d_main = diff[:, ~col_is_pitch]
            if opts.pitch:
                rep.max_abs_error_pitch = float(diff[:, col_is_pitch].max())
            if opts.spectrogram:
                # the spectrogram's contract: inside the 50 dB window,
                # over the spectral columns only
                w_main = want[:, ~col_is_pitch]
                keep = w_main > (w_main.max(axis=1, keepdims=True)
                                 - np.log(10.0 ** 5))
                rep.max_abs_error = float(d_main[keep].max())
            else:
                rep.max_abs_error = float(d_main.max())
            return

    def _write_out(pb, lengths, host, ev):
        """Write a finished batch (waits on its own copy's event only)."""
        nonlocal stats
        with report.stage_timer(rep, "fetch+write"):
            if ev is not None:
                ev.synchronize()
            feat_np, flens_np = host[0].numpy(), host[1].numpy()
            if rep.max_abs_error is None:
                _self_check(pb, lengths, feat_np, flens_np)
            if cfg.cmvn:
                stats = stats.merge(cmvn_lib.host_batch_stats(feat_np,
                                                              flens_np))
            for i, uid in enumerate(pb.paths):
                if uid is None:
                    continue  # padding row
                if lengths[i] == 0:
                    if man is not None:  # quarantined at decode time
                        man.mark_quarantined(uid)
                    continue
                writer.write(uid, feat_np[i, : flens_np[i]])
                if man is not None:
                    man.mark(uid)
            if man is not None:
                if cfg.cmvn:
                    # the accumulator, atomically with the done-set it
                    # covers (the features above are already durable)
                    man.set_cmvn(*stats)
                man.save()

    def _packed_loop(on_bad):
        """--pack: splittable multi-utterance rows (utils/batch.
        pack_rows_split) through mfcc_batch_packed; utterances are
        reassembled on the host and written once complete."""
        nonlocal stats
        hop, fl = cfg.hop_len, cfg.frame_len
        capacity = max(int(round(opts.pack_seconds * cfg.sample_rate
                                 / hop)), -(-(fl + hop) // hop)) * hop
        # worst-case pieces a row: 1-frame pieces (span fl) at hop-aligned
        # starts with a >= 1-sample gap
        s_max = capacity // ((-(-(fl + 1) // hop)) * hop) + 2
        family = ("spec" if opts.spectrogram else "plp" if opts.plp
                  else "logmel" if opts.logmel else "mfcc")
        n_out = (cfg.n_bins if opts.spectrogram
                 else cfg.n_mels if opts.logmel else cfg.n_mfcc)
        sr = cfg.sample_rate
        cache: dict = {}        # uid -> decoded f32 signal
        probed: dict = {}       # uid -> probed sample count (the plan)
        bad_uids: set = set()
        bufs: dict = {}         # uid -> [feature buffer, frames filled]
        checked = [rep.max_abs_error is not None]

        def fetch(uid):
            if uid in bad_uids:
                return None
            if uid not in cache:
                a, lens, rates, errors = native.read_wavs_padded(
                    [uid], probed[uid])
                err = None
                if errors[0] != 0:
                    err = (f"native decode error {errors[0]} "
                           f"({native.ERRORS.get(int(errors[0]), '?')})")
                elif rates[0] != sr:
                    err = f"sample rate {rates[0]}"
                elif lens[0] != probed[uid]:
                    # the packer planned rows for the probed length: the
                    # missing tail would be computed over zeros
                    err = (f"decoded {lens[0]} samples, the header "
                           f"promises {probed[uid]}")
                if err is not None:
                    print(f"[quarantine] {uid}: {err}")
                    if man is not None:
                        man.mark_quarantined(uid)
                    bad_uids.add(uid)
                    return None
                cache[uid] = a[0]
            return cache[uid]

        def infos_gen():
            for p, n in _probe(paths, cfg, on_bad):
                probed[p] = int(n)
                if cfg.num_frames(int(n)) == 0:
                    # shorter than one frame: empty output now (the packer
                    # drops a zero-frame utterance, and resume would retry
                    # it forever)
                    if fetch(p) is not None:
                        finish_utt(p, np.zeros((0, n_out), np.float32))
                    continue
                yield p, n

        def batches():
            buf = []
            for row in batch_lib.pack_rows_split(
                    infos_gen(), capacity, hop, fl):
                buf.append(row)
                if len(buf) == batch_size:
                    yield buf
                    buf = []
            if buf:
                yield buf

        def assemble(rows):
            x = np.zeros((batch_size, capacity), np.float32)
            starts = np.zeros((batch_size, s_max), np.int32)
            lens = np.zeros((batch_size, s_max), np.int32)
            kept = []
            for b, row in enumerate(rows):
                segs = [pc for pc in row.segments
                        if fetch(pc.uid) is not None]
                r2 = batch_lib.PackedRow(capacity=capacity, segments=segs)
                sig, st, ln, _ = batch_lib.pack_audio_split(r2, fetch)
                if len(st) > s_max:
                    raise RuntimeError(f"a packed row holds {len(st)} "
                                       f"pieces, more than {s_max}")
                x[b] = sig
                starts[b, : len(st)], lens[b, : len(ln)] = st, ln
                kept.append(r2)
            return kept, x, starts, lens

        def finish_utt(uid, feat_u):
            nonlocal stats
            sig = cache.pop(uid)
            rep.n_utterances += 1
            rep.audio_seconds += len(sig) / sr
            if not checked[0] and not cfg.cmvn and feat_u.shape[0]:
                want = _oracle_fn(opts)(sig.astype(np.float64), cfg)
                if want.shape[0]:
                    diff = np.abs(feat_u[: want.shape[0]] - want)
                    if opts.spectrogram:
                        # the 50 dB-window contract of the padded path
                        keep = want > (want.max(axis=1, keepdims=True)
                                       - np.log(10.0 ** 5))
                        rep.max_abs_error = float(diff[keep].max())
                    else:
                        rep.max_abs_error = float(diff.max())
                    checked[0] = True
            if cfg.cmvn:
                stats = stats.merge(cmvn_lib.host_batch_stats(
                    feat_u[None], np.asarray([feat_u.shape[0]])))
            writer.write(uid, feat_u)
            if man is not None:
                man.mark(uid)

        def write_packed(rows, host, ev):
            with report.stage_timer(rep, "fetch+write"):
                if ev is not None:
                    ev.synchronize()
                feat_np, f0, fc = (h.numpy() for h in host)
                for b, row in enumerate(rows):
                    for j, pc in enumerate(row.segments):
                        if pc.uid in bad_uids:
                            continue
                        ent = bufs.get(pc.uid)
                        if ent is None:
                            ent = [np.zeros((cfg.num_frames(probed[pc.uid]),
                                             n_out), np.float32), 0]
                            bufs[pc.uid] = ent
                        ent[0][pc.frame_start: pc.frame_start
                               + pc.n_frames] = \
                            feat_np[b, f0[b, j]: f0[b, j] + fc[b, j]]
                        ent[1] += pc.n_frames
                        if ent[1] == ent[0].shape[0]:
                            finish_utt(pc.uid, bufs.pop(pc.uid)[0])
                if man is not None:
                    if cfg.cmvn:
                        man.set_cmvn(*stats)
                    man.save()

        in_flight = None
        for rows in batches():
            with report.stage_timer(rep, "decode"):
                kept, x, starts, lens = assemble(rows)
            with report.stage_timer(rep, "dispatch"):
                a_dev, st_dev, ln_dev = _to_device((x, starts, lens), dev)
                feat, f0, fc, _m = mfcc_model.mfcc_batch_packed(
                    a_dev, st_dev, ln_dev, cfg, opts.backend, family=family)
                host, ev = _to_host_async((feat, f0, fc), dev)
            if in_flight is not None:
                write_packed(*in_flight)
            in_flight = (kept, host, ev)
        if in_flight is not None:
            write_packed(*in_flight)
        if man is not None:
            man.save()   # persist trailing quarantines

    on_bad = man.mark_quarantined if man is not None else None
    device_ctx = (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext())
    t0 = time.perf_counter()
    with device_ctx, report.maybe_profile(opts.trace_dir,
                                          cuda=dev.type == "cuda",
                                          name=f"trace.{rank}.json"):
        if opts.pack:
            _packed_loop(on_bad)
        else:
            in_flight = None  # depth 2: decode and enqueue N+1, write N
            for pb in batch_lib.make_path_batches(
                    _probe(paths, cfg, on_bad, opts.resample),
                    batch_size, ladder):
                with report.stage_timer(rep, "decode"):
                    audio, lengths = _decode_batch(pb, cfg, opts.resample)
                    rep.n_utterances += int((lengths > 0).sum())
                    rep.audio_seconds += (float(lengths.sum())
                                          / cfg.sample_rate)
                with report.stage_timer(rep, "dispatch"):
                    a_dev, l_dev = _to_device((audio, lengths), dev)
                    feat, flens, _mask = fn(a_dev, l_dev, cfg, opts.backend)
                    host, ev = _to_host_async((feat, flens), dev)
                if in_flight is not None:
                    _write_out(*in_flight)
                in_flight = (pb, lengths, host, ev)
            if in_flight is not None:
                _write_out(*in_flight)
    writer.finish()
    if man is not None:
        man.save()  # persist probe-time quarantines even on empty runs
    rep.wall_seconds = time.perf_counter() - t0
    return _finish_cmvn_and_report(cfg, opts, rep, man, writer, stats,
                                   stats_path, all_paths, rank)


def _finish_cmvn_and_report(cfg, opts, rep, man, writer, stats,
                            stats_path, all_paths, rank):
    """The run's tail (padded and packed loops): global CMVN reduce and
    apply once, then the report."""
    if cfg.cmvn and not (man is not None and man.cmvn_applied):
        # sum over processes, persist, normalize every utterance of this
        # process's shard, done and just computed alike, in float64
        gstats = _global_stats(stats)
        manifest_lib.save_cmvn(stats_path, gstats, cfg.config_hash())
        c = max(float(gstats.count), 1.0)
        mean = gstats.sum.numpy() / c
        var = np.maximum(gstats.sumsq.numpy() / c - mean * mean, 1e-8)
        writer.apply_cmvn(all_paths, mean, 1.0 / np.sqrt(var))
        if man is not None:
            man.cmvn_applied = True
            man.save()

    rep.dump(os.path.join(opts.out_dir, f"run_report.{rank}.json"))
    return rep
