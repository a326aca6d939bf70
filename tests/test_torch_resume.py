"""Interrupt and resume of the port's corpus runner on the CPU: the twins
of ``tests/test_resume.py``, plus resume across the two packages (an
output directory half written by one runner is finished by the other).

For every writer format, with CMVN on and off: a run is cut midway (a
writer raises after K utterances, the state a SIGKILL leaves, since
writers flush before the manifest marks anything), resumed, and held equal
to an uninterrupted run into a fresh directory.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from mfcc_tpu import FeatureConfig as JaxConfig, runner as jax_runner
from mfcc_tpu.utils import wav
from mfcc_tpu_torch import FeatureConfig, runner
from mfcc_tpu_torch.utils import (htk, kaldi, manifest as manifest_lib,
                                  tfrecord)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Boom(RuntimeError):
    pass


def _mk_corpus(tmp_path, rng, n=20):
    d = tmp_path / "corpus"
    d.mkdir()
    for i in range(n):
        x = (rng.standard_normal(int(rng.integers(4800, 16000)))
             * 0.3).astype(np.float32)
        wav.write_wav(d / f"utt{i}.wav", x, 16000)
    return str(d)


def _read_outputs(out_dir: str, fmt: str) -> dict:
    if fmt == "npy":
        return {f[:-4]: np.load(os.path.join(out_dir, f))
                for f in os.listdir(out_dir) if f.endswith(".npy")}
    if fmt == "ark":
        return kaldi.read_scp(os.path.join(out_dir, "features.0.scp"))
    if fmt == "htk":
        return {f[:-4]: htk.read_htk(os.path.join(out_dir, f))[0]
                for f in os.listdir(out_dir) if f.endswith(".htk")}
    return tfrecord.read_tfrecord(
        os.path.join(out_dir, "features.0.tfrecord"))


def _interrupt_after(monkeypatch, cls, k: int):
    """Make cls.write raise after k successful utterance writes."""
    orig = cls.write
    calls = {"n": 0}

    def bomb(self, uid, feat):
        if calls["n"] >= k:
            raise _Boom()
        calls["n"] += 1
        return orig(self, uid, feat)

    monkeypatch.setattr(cls, "write", bomb)
    return lambda: monkeypatch.setattr(cls, "write", orig)


_WRITERS = {"npy": runner.NpyWriter, "ark": runner.ArkWriter,
            "htk": runner.HTKWriter, "tfrecord": runner.TFRecordWriter}


def _opts(out_dir, **kw):
    return runner.RunnerOptions(out_dir=str(out_dir), batch_size=2,
                                device="cpu", **kw)


@pytest.mark.parametrize("fmt", ["npy", "ark", "htk", "tfrecord"])
@pytest.mark.parametrize("cmvn", [False, True])
def test_interrupt_resume_equals_uninterrupted(tmp_path, rng, monkeypatch,
                                               fmt, cmvn):
    corpus = _mk_corpus(tmp_path, rng)
    cfg = FeatureConfig(cmvn=cmvn).validate()
    runner.run(corpus, cfg, _opts(tmp_path / "ref", out_format=fmt))
    want = _read_outputs(str(tmp_path / "ref"), fmt)
    assert len(want) == 20

    out_dir = str(tmp_path / "out")
    restore = _interrupt_after(monkeypatch, _WRITERS[fmt], 10)
    with pytest.raises(_Boom):
        runner.run(corpus, cfg, _opts(out_dir, out_format=fmt))
    restore()
    man = manifest_lib.Manifest(
        os.path.join(out_dir, "manifest.0.json"), cfg.config_hash())
    assert 0 < len(man.done) < 20         # genuinely mid-run
    if cmvn:
        assert man.cmvn is not None       # accumulator checkpointed
        assert not man.cmvn_applied

    rep = runner.run(corpus, cfg, _opts(out_dir, out_format=fmt))
    got = _read_outputs(out_dir, fmt)
    assert sorted(got) == sorted(want)
    for uid in want:
        if cmvn:
            # the resumed accumulation rebatches the remainder, so the
            # float64 sums run in another order: ulp-level drift
            np.testing.assert_allclose(got[uid], want[uid],
                                       atol=1e-5, rtol=1e-5)
        else:
            np.testing.assert_array_equal(got[uid], want[uid])
    assert rep.n_utterances < 20          # only the remainder recomputed

    # idempotent re-run: nothing pending, CMVN applied once
    rep2 = runner.run(corpus, cfg, _opts(out_dir, out_format=fmt))
    assert rep2.n_utterances == 0
    got2 = _read_outputs(out_dir, fmt)
    for uid in want:
        np.testing.assert_array_equal(got2[uid], got[uid])


def test_interrupt_resume_with_pitch_appended(tmp_path, rng, monkeypatch):
    """--pitch and resume: the 3 pitch columns survive an interrupt and
    resume bit for bit (the batch step recomputes whole feature rows)."""
    corpus = _mk_corpus(tmp_path, rng, n=12)
    cfg = FeatureConfig().validate()
    runner.run(corpus, cfg, _opts(tmp_path / "ref", pitch=True))
    want = _read_outputs(str(tmp_path / "ref"), "npy")
    assert len(want) == 12
    assert next(iter(want.values())).shape[1] == cfg.n_mfcc + 3

    out_dir = str(tmp_path / "out")
    restore = _interrupt_after(monkeypatch, _WRITERS["npy"], 5)
    with pytest.raises(_Boom):
        runner.run(corpus, cfg, _opts(out_dir, pitch=True))
    restore()
    man = manifest_lib.Manifest(
        os.path.join(out_dir, "manifest.0.json"), cfg.config_hash())
    assert 0 < len(man.done) < 12
    runner.run(corpus, cfg, _opts(out_dir, pitch=True))
    got = _read_outputs(out_dir, "npy")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("fmt", ["npy", "tfrecord"])
def test_sigkill_worker_resume_equals_uninterrupted(tmp_path, rng, fmt):
    """SIGKILL a real ``python -m mfcc_tpu_torch --device cpu`` process
    mid-run (at an arbitrary instruction, not a cooperative raise), resume,
    and hold the outputs equal to an uninterrupted run: features flush
    before the manifest marks them, the manifest and the CMVN accumulator
    commit in one atomic replace, and the TFRecord tail is repaired."""
    n = 64
    corpus = _mk_corpus(tmp_path, rng, n=n)
    cfg = FeatureConfig(cmvn=True).validate()
    runner.run(corpus, cfg, _opts(tmp_path / "ref", out_format=fmt))
    want = _read_outputs(str(tmp_path / "ref"), fmt)
    assert len(want) == n

    out_dir = str(tmp_path / "out")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mfcc_tpu_torch", corpus, "-o", out_dir,
         "--cmvn", "--batch-size", "1", "--format", fmt, "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # poll the manifest; SIGKILL the worker (the exact process spawned)
    # once >= 6 utterances are durable
    man_path = os.path.join(out_dir, "manifest.0.json")
    deadline = time.time() + 120
    killed = False
    while time.time() < deadline and proc.poll() is None:
        try:
            with open(man_path) as f:
                if len(json.load(f).get("done", [])) >= 6:
                    proc.kill()
                    killed = True
                    break
        except (OSError, ValueError):
            pass  # not written yet, or a torn read around the rename
        time.sleep(0.001)
    out = proc.communicate(timeout=60)[0]
    assert killed, f"worker finished before the kill landed:\n{out[-2000:]}"
    assert proc.returncode == -9

    man = manifest_lib.Manifest(man_path, cfg.config_hash())
    assert 0 < len(man.done) < n          # genuinely mid-run
    assert man.cmvn is not None and not man.cmvn_applied

    rep = runner.run(corpus, cfg, _opts(out_dir, out_format=fmt))
    got = _read_outputs(out_dir, fmt)
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_allclose(got[uid], want[uid], atol=1e-5, rtol=1e-5)
    assert rep.n_utterances < n           # only the remainder recomputed


def test_cmvn_applied_guard_on_grown_corpus(tmp_path, rng):
    corpus = _mk_corpus(tmp_path, rng, n=3)
    cfg = FeatureConfig(cmvn=True).validate()
    runner.run(corpus, cfg, _opts(tmp_path / "out"))
    # the corpus grows after normalization was applied
    x = (rng.standard_normal(9000) * 0.3).astype(np.float32)
    wav.write_wav(os.path.join(corpus, "uttZ.wav"), x, 16000)
    with pytest.raises(RuntimeError, match="CMVN was already applied"):
        runner.run(corpus, cfg, _opts(tmp_path / "out"))


def test_tfrecord_tail_repair(tmp_path, rng):
    path = str(tmp_path / "features.0.tfrecord")
    feats = {"a": rng.standard_normal((4, 3)).astype(np.float32),
             "b": rng.standard_normal((5, 3)).astype(np.float32)}
    tfrecord.write_tfrecord(path, feats)
    good = os.path.getsize(path)
    with open(path, "ab") as f:       # a crash mid-append
        f.write(b"\x99" * 17)
    assert tfrecord.truncate_incomplete_tail(path) == 17
    assert os.path.getsize(path) == good
    out = tfrecord.read_tfrecord(path)
    np.testing.assert_array_equal(out["a"], feats["a"])
    np.testing.assert_array_equal(out["b"], feats["b"])
    assert tfrecord.truncate_incomplete_tail(path) == 0
    # the runner's writer repairs the tail when it opens to resume
    with open(path, "ab") as f:
        f.write(b"\x01" * 9)
    w = runner.TFRecordWriter(str(tmp_path), 0, resume=True)
    w.finish()
    assert w.path == path and os.path.getsize(path) == good


def test_ark_append_then_rewrite_atomic(tmp_path, rng):
    prefix = str(tmp_path / "features.0")
    a = rng.standard_normal((4, 13)).astype(np.float32)
    b = rng.standard_normal((6, 13)).astype(np.float32)
    with open(prefix + ".ark", "ab") as ark, open(prefix + ".scp", "a") as scp:
        kaldi.append_ark_entry(ark, scp, prefix + ".ark", "a", a)
        kaldi.append_ark_entry(ark, scp, prefix + ".ark", "b", b)
    got = kaldi.read_scp(prefix + ".scp")
    np.testing.assert_array_equal(got["a"], a)
    np.testing.assert_array_equal(got["b"], b)
    kaldi.write_ark_scp(prefix, {"a": a * 2, "b": b * 2}, atomic=True)
    got = kaldi.read_scp(prefix + ".scp")
    np.testing.assert_array_equal(got["a"], a * 2)
    assert not os.path.exists(prefix + ".ark.tmp")


@pytest.mark.parametrize("first", ["jax", "port"])
@pytest.mark.parametrize("cmvn", [False, True])
def test_resume_across_packages(tmp_path, rng, monkeypatch, first, cmvn):
    """One package's runner writes half of an output directory (cut after
    8 utterances), the other's finishes it, and the result equals one
    uninterrupted JAX run: the manifest, its CMVN accumulator and the
    config hash are one format across the two.  Tolerance 1e-4, the
    feature contract (port against JAX on the CPU: ~4e-6 raw)."""
    corpus = _mk_corpus(tmp_path, rng, n=16)
    jcfg = JaxConfig(cmvn=cmvn).validate()
    cfg = FeatureConfig(cmvn=cmvn).validate()
    assert cfg.config_hash() == jcfg.config_hash()
    jax_runner.run(corpus, jcfg, jax_runner.RunnerOptions(
        out_dir=str(tmp_path / "ref"), batch_size=2))
    want = _read_outputs(str(tmp_path / "ref"), "npy")
    assert len(want) == 16

    out_dir = str(tmp_path / "out")
    runs = {"jax": lambda: jax_runner.run(corpus, jcfg, jax_runner.RunnerOptions(
                out_dir=out_dir, batch_size=2)),
            "port": lambda: runner.run(corpus, cfg, _opts(out_dir))}
    cls = {"jax": jax_runner.NpyWriter, "port": runner.NpyWriter}[first]
    restore = _interrupt_after(monkeypatch, cls, 8)
    with pytest.raises(_Boom):
        runs[first]()
    restore()
    man = manifest_lib.Manifest(os.path.join(out_dir, "manifest.0.json"),
                                cfg.config_hash())
    assert len(man.done) == 8 and (man.cmvn is not None) == cmvn
    second = "port" if first == "jax" else "jax"
    rep = runs[second]()
    assert rep.n_utterances == 8          # only the remainder computed
    got = _read_outputs(out_dir, "npy")
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_allclose(got[uid], want[uid], atol=1e-4, err_msg=uid)
    man = manifest_lib.Manifest(os.path.join(out_dir, "manifest.0.json"),
                                cfg.config_hash())
    assert len(man.done) == 16 and man.cmvn_applied == cmvn
