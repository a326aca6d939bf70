"""The port's host utilities against the JAX package's on the CPU: the WAV
reader and header probe, the native batch decoder against the pure reader,
the HTK, Kaldi ark/scp and TFRecord writers byte for byte, manifests and
CMVN checkpoints read across the two packages, the run report's fields
and the per-process shard."""

import json
import os
import struct

import numpy as np
import pytest
import torch

from mfcc_tpu.parallel import dist as jax_dist
from mfcc_tpu.parallel.cmvn import Stats as JaxStats
from mfcc_tpu.utils import (htk as jax_htk, kaldi as jax_kaldi,
                            manifest as jax_manifest, report as jax_report,
                            tfrecord as jax_tfrecord, wav as jax_wav)
from mfcc_tpu_torch import native
from mfcc_tpu_torch.parallel import cmvn, dist
from mfcc_tpu_torch.utils import (htk, kaldi, manifest, report, tfrecord,
                                  wav)


def _riff(payload: bytes, fmt_code: int, n_ch: int, bits: int,
          sr: int = 16000, extra: bytes = b"") -> bytes:
    ba = n_ch * max(bits // 8, 1)
    fmt = struct.pack("<HHIIHH", fmt_code, n_ch, sr, sr * ba, ba, bits)
    body = (b"WAVE" + extra + b"fmt " + struct.pack("<I", 16) + fmt
            + b"data" + struct.pack("<I", len(payload)) + payload)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _encodings(rng, n=301):
    """name -> WAV bytes for each encoding the readers take."""
    v = rng.standard_normal(n) * 0.3
    i16 = np.round(np.clip(v, -1, 0.999) * 32767).astype("<i2")
    i32 = np.round(np.clip(v, -1, 0.999) * 2 ** 31).astype("<i4")
    u8 = np.round(np.clip(v, -1, 0.99) * 127 + 128).astype("u1")
    i24 = np.round(np.clip(v, -1, 0.999) * 2 ** 23).astype(np.int64)
    b24 = np.stack([(i24 >> s) & 0xFF for s in (0, 8, 16)], -1).astype("u1")
    f32 = v.astype("<f4")
    st = np.round(np.clip(rng.standard_normal((n, 2)) * 0.3, -1, 0.999)
                  * 32767).astype("<i2")
    return {
        "pcm16": _riff(i16.tobytes(), 1, 1, 16),
        "pcm8": _riff(u8.tobytes(), 1, 1, 8),
        "pcm24": _riff(b24.tobytes(), 1, 1, 24),
        "pcm32": _riff(i32.tobytes(), 1, 1, 32),
        "float32": _riff(f32.tobytes(), 3, 1, 32),
        "stereo16": _riff(st.tobytes(), 1, 2, 16),
        "extensible16": _riff(i16.tobytes(), 0xFFFE, 1, 16),
        "list_chunk": _riff(i16.tobytes(), 1, 1, 16,
                            extra=b"LIST" + struct.pack("<I", 3) + b"abc\0"),
        "rate22k": _riff(i16.tobytes(), 1, 1, 16, sr=22050),
    }


CORRUPT = {
    "empty": b"",
    "short": b"RI",
    "not_riff": b"not a wav at all",
    "no_chunks": b"RIFF....WAVEnope",
    "fmt_too_small": b"RIFF\0\0\0\0WAVEfmt \x04\0\0\0abcd",
    "pcm12": _riff(bytes(30), 1, 1, 12),
    "adpcm": _riff(bytes(30), 2, 1, 4),
    "odd_pcm16": _riff(bytes(31), 1, 1, 16),
}


@pytest.mark.parametrize("name,channel", [
    *((k, c) for k in _encodings(np.random.default_rng(0)) for c in (None, 0)),
    ("stereo16", 1)])
def test_wav_reader_matches_reference(tmp_path, rng, name, channel):
    data = _encodings(rng)[name]
    p = tmp_path / f"{name}.wav"
    p.write_bytes(data)
    got, sr = wav.read_wav(p, channel)
    want, jsr = jax_wav._parse(data, channel)
    assert sr == jsr and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert wav.wav_info(p) == jax_wav.wav_info(p)
    assert wav.probe(p) == jax_wav.wav_info(p)


@pytest.mark.parametrize("name", list(CORRUPT))
def test_wav_reader_rejects_what_the_reference_rejects(tmp_path, name):
    p = tmp_path / f"{name}.wav"
    p.write_bytes(CORRUPT[name])
    with pytest.raises(ValueError) as want:
        jax_wav._parse(CORRUPT[name], None)
    with pytest.raises(ValueError) as got:
        wav.read_wav(p)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_wav_probe_refuses_what_no_decoder_takes(tmp_path):
    for name in ("pcm12", "adpcm"):
        p = tmp_path / f"{name}.wav"
        p.write_bytes(CORRUPT[name])
        assert wav.wav_info(p) == jax_wav.wav_info(p)   # the header reads
        with pytest.raises(wav.WavError, match="unsupported audio format"):
            wav.probe(p)
    with pytest.raises(wav.WavError):
        wav.wav_info(_write(tmp_path, "x.wav", CORRUPT["no_chunks"]))


def _write(tmp_path, name, data):
    p = tmp_path / name
    p.write_bytes(data)
    return str(p)


def test_write_wav_bytes_equal_reference(tmp_path, rng):
    x = (rng.standard_normal(999) * 0.4).astype(np.float32)
    wav.write_wav(tmp_path / "a.wav", x, 16000)
    jax_wav.write_wav(tmp_path / "b.wav", x, 16000)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    wav.write_wav(tmp_path / "c.wav", x.view(np.int16), 8000)
    jax_wav.write_wav(tmp_path / "d.wav", x.view(np.int16), 8000)
    assert (tmp_path / "c.wav").read_bytes() == (tmp_path / "d.wav").read_bytes()


def test_native_float_decoder_equals_pure_reader(tmp_path, rng):
    encs = _encodings(rng)
    paths = [_write(tmp_path, f"{k}.wav", v) for k, v in encs.items()]
    for channel in (-1, 0):
        audio, lens, rates, errs = native.read_wavs_padded(paths, 400,
                                                           channel)
        assert (errs == 0).all()
        for i, p in enumerate(paths):
            ref, sr = wav.read_wav(p, None if channel < 0 else channel)
            assert lens[i] == len(ref) and rates[i] == sr
            np.testing.assert_array_equal(audio[i, : lens[i]], ref)
            assert not audio[i, lens[i]:].any()
    # cut to max_len
    audio, lens, _, _ = native.read_wavs_padded(paths[:1], 100)
    np.testing.assert_array_equal(audio[0], wav.read_wav(paths[0])[0][:100])
    assert lens[0] == 100


def test_native_i16_decoder_equals_pure_reader(tmp_path, rng):
    encs = _encodings(rng)
    paths = [_write(tmp_path, f"{k}.wav", v) for k, v in encs.items()]
    audio, lens, rates, errs = native.read_wavs_padded_i16(paths, 400)
    for i, (k, p) in enumerate(zip(encs, paths)):
        if k in ("pcm16", "extensible16", "list_chunk", "rate22k"):
            ref, sr = wav.read_wav(p)
            assert errs[i] == 0 and lens[i] == len(ref) and rates[i] == sr
            np.testing.assert_array_equal(
                audio[i, : lens[i]].astype(np.float32) / 32768.0, ref)
        else:
            assert errs[i] == -6 and lens[i] == 0 and not audio[i].any()


def test_native_error_codes(tmp_path):
    # (a header of fewer than 8 bits a sample is kept away from the native
    # decoder, which divides by the bytes a sample: test_wav_probe_...)
    cases = {"missing": (None, -1), "not_riff": (CORRUPT["not_riff"], -2),
             "no_chunks": (CORRUPT["no_chunks"], -3),
             "pcm12": (CORRUPT["pcm12"], -4),
             "alaw16": (_riff(bytes(30), 6, 1, 16), -4)}
    paths = [str(tmp_path / "nope.wav") if data is None
             else _write(tmp_path, f"{k}.wav", data)
             for k, (data, _) in cases.items()]
    want = [code for _, code in cases.values()]
    for decode, unsupported in ((native.read_wavs_padded, -4),
                                (native.read_wavs_padded_i16, -6)):
        audio, lens, rates, errs = decode(paths, 64)
        assert list(errs) == [unsupported if c == -4 else c for c in want]
        assert not audio.any() and not lens.any() and not rates.any()
    assert all(code in native.ERRORS for code in (-1, -2, -3, -4, -5, -6))
    assert native.read_wavs_padded([], 10)[0].shape == (0, 10)
    with pytest.raises(ValueError):
        native.read_wavs_padded(paths, -1)


def test_native_library_built_into_build_dir():
    lib = native.library_path()
    native.load()
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert lib.parent.parts[-2:] == ("build", "mfcc_tpu_torch")
    assert native.SOURCE.name == "wavio.cpp" and native.SOURCE.exists()


def _feats(rng):
    return {f"utt{i}": rng.standard_normal(
        (int(rng.integers(1, 30)), 13)).astype(np.float32) for i in range(5)}


def test_htk_bytes_equal_reference(tmp_path, rng):
    for uid, f in _feats(rng).items():
        htk.write_htk(str(tmp_path / "a.htk"), f, 0.01)
        jax_htk.write_htk(str(tmp_path / "b.htk"), f, 0.01)
        a, b = (tmp_path / "a.htk").read_bytes(), (tmp_path / "b.htk").read_bytes()
        assert a == b
        got, period, kind = htk.read_htk(str(tmp_path / "a.htk"))
        np.testing.assert_array_equal(got, f)
        assert abs(period - 0.01) < 1e-12 and kind == htk.PARM_USER


@pytest.mark.parametrize("atomic", [False, True])
def test_ark_scp_bytes_equal_reference(tmp_path, rng, atomic):
    feats = _feats(rng)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    kaldi.write_ark_scp(str(tmp_path / "a" / "f"), feats, atomic=atomic)
    jax_kaldi.write_ark_scp(str(tmp_path / "b" / "f"), feats, atomic=atomic)
    for ext in (".ark",):
        assert (tmp_path / "a" / f"f{ext}").read_bytes() == \
            (tmp_path / "b" / f"f{ext}").read_bytes()
    # the scp lines differ only in the archive path they name
    a = (tmp_path / "a" / "f.scp").read_text().replace("/a/", "/b/")
    assert a == (tmp_path / "b" / "f.scp").read_text()
    back = jax_kaldi.read_scp(str(tmp_path / "a" / "f.scp"))
    for k in feats:
        np.testing.assert_array_equal(back[k], feats[k])


def test_tfrecord_bytes_equal_reference(tmp_path, rng):
    feats = _feats(rng)
    tfrecord.write_tfrecord(str(tmp_path / "a.tfrecord"), feats)
    jax_tfrecord.write_tfrecord(str(tmp_path / "b.tfrecord"), feats)
    assert (tmp_path / "a.tfrecord").read_bytes() == \
        (tmp_path / "b.tfrecord").read_bytes()
    back = jax_tfrecord.read_tfrecord(str(tmp_path / "a.tfrecord"))
    for k in feats:
        np.testing.assert_array_equal(back[k], feats[k])
    assert tfrecord.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert tfrecord.crc32c(b"123456789") == 0xE3069283
    # tail repair: the same bytes dropped, the same file left
    for mod, name in ((tfrecord, "a"), (jax_tfrecord, "b")):
        with open(tmp_path / f"{name}.tfrecord", "ab") as f:
            f.write(b"\x07" * 23)
        assert mod.truncate_incomplete_tail(str(tmp_path / f"{name}.tfrecord")) \
            == 23
    assert (tmp_path / "a.tfrecord").read_bytes() == \
        (tmp_path / "b.tfrecord").read_bytes()


def test_manifest_read_across_packages(tmp_path):
    stats = (7.0, [1.0, 2.5, -3.0], [4.0, 9.0, 16.25])
    for writer, reader in ((jax_manifest, manifest), (manifest, jax_manifest)):
        p = str(tmp_path / f"m_{writer.__name__.split('.')[0]}.json")
        m = writer.Manifest(p, config_hash="abc123")
        m.mark("u1")
        m.mark("u2")
        m.mark_quarantined("bad")
        m.set_cmvn(*stats)
        m.save()
        back = reader.Manifest(p, config_hash="abc123")
        assert back.done == {"u1", "u2"} and back.quarantined == {"bad"}
        assert back.pending(["u1", "u3", "bad"]) == ["u3"]
        assert not back.cmvn_applied
        assert float(back.cmvn[0]) == 7.0
        np.testing.assert_array_equal(back.cmvn[1], stats[1])
        np.testing.assert_array_equal(back.cmvn[2], stats[2])
        with pytest.raises(ValueError):
            reader.Manifest(p, config_hash="different")
    a, b = (json.loads(open(tmp_path / f"m_{n}.json").read())
            for n in ("mfcc_tpu", "mfcc_tpu_torch"))
    assert a == b


def test_cmvn_checkpoint_read_across_packages(tmp_path):
    import jax.numpy as jnp
    jst = JaxStats(jnp.asarray(10.0), jnp.arange(13, dtype=jnp.float32),
                   jnp.ones(13))
    jax_manifest.save_cmvn(str(tmp_path / "j.npz"), jst, "h")
    back = manifest.load_cmvn(str(tmp_path / "j.npz"), "h")
    assert isinstance(back, cmvn.Stats) and back.sum.dtype == torch.float64
    assert float(back.count) == 10.0
    np.testing.assert_array_equal(back.sum.numpy(), np.arange(13))
    with pytest.raises(ValueError):
        manifest.load_cmvn(str(tmp_path / "j.npz"), "other")
    pst = cmvn.Stats(torch.tensor(5.0, dtype=torch.float64),
                     torch.arange(4, dtype=torch.float64),
                     torch.full((4,), 2.0, dtype=torch.float64))
    manifest.save_cmvn(str(tmp_path / "p.npz"), pst, "h")
    jback = jax_manifest.load_cmvn(str(tmp_path / "p.npz"), "h")
    assert float(jback.count) == 5.0
    np.testing.assert_array_equal(np.asarray(jback.sumsq), np.full(4, 2.0))


def test_run_report_fields_match_reference(tmp_path):
    kw = dict(config_hash="h", n_utterances=3, audio_seconds=6.0,
              wall_seconds=2.0, n_devices=1, n_hosts=1, max_abs_error=1e-6,
              stage_seconds={"decode": 0.5})
    got = report.RunReport(**kw)
    want = jax_report.RunReport(**kw)
    assert got.finalize() == want.finalize()
    assert got.audio_seconds_per_second == 3.0
    assert json.loads(got.dump(str(tmp_path / "r.json"))) == got.finalize()
    with report.stage_timer(got, "decode"):
        pass
    assert got.stage_seconds["decode"] >= 0.5
    with report.maybe_profile(None):
        pass
    with report.maybe_profile(str(tmp_path / "t"), name="x.json"):
        torch.ones(3).sum()
    assert json.loads((tmp_path / "t" / "x.json").read_text())["traceEvents"]


def test_host_shard_matches_reference():
    items = [f"u{i}" for i in range(11)]
    for pc in (1, 2, 3, 4):
        for pi in range(pc):
            assert dist.host_shard(items, pi, pc) == \
                jax_dist.host_shard(items, pi, pc)
    assert dist.host_shard(items) == items          # one process
    assert dist.process_index() == 0 and dist.process_count() == 1
    assert dist.is_coordinator()
    dist.initialize()                               # a world of one: no-op
    assert not torch.distributed.is_initialized()
    count, s = dist.all_reduce_sum_f64([torch.tensor(2.0, dtype=torch.float64),
                                        torch.arange(3.0)])
    assert count.shape == () and float(count) == 2.0
    assert s.dtype == torch.float64 and s.tolist() == [0.0, 1.0, 2.0]
