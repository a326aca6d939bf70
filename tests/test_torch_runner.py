"""The port's corpus runner and CLI (``python -m mfcc_tpu_torch``) on the
CPU: the twins of ``tests/test_cli.py``.

Each case runs the JAX CLI (``mfcc_tpu.cli.main``) and the port's
(``mfcc_tpu_torch.cli.main`` with ``--device cpu``) on the same small
corpus and holds the port's files to the JAX CLI's, and to the float64
oracle, at the JAX test's own tolerance for that case.
``test_cli_data_parallel_8_devices`` has no twin: the port runs one process
per GPU in place of the in-process mesh (``tests/test_torch_multiprocess.py``
covers the processes).
"""

import contextlib
import io
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from mfcc_tpu import FeatureConfig, cli as jax_cli, oracle
from mfcc_tpu.utils import htk, kaldi, tfrecord, wav
from mfcc_tpu_torch import cli as port_cli, runner as port_runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mk_corpus(tmp_path, rng, n=4):
    """n WAVs of 0.3-1.0 s (one ladder bucket) -> (dir, {name: signal})."""
    d = tmp_path / "corpus"
    d.mkdir()
    sigs = {}
    for i in range(n):
        x = (rng.standard_normal(int(rng.integers(4800, 16000)))
             * 0.3).astype(np.float32)
        p = d / f"utt{i}.wav"
        wav.write_wav(p, x, 16000)
        # features are computed on the PCM16-quantized signal
        sigs[f"utt{i}"], _ = wav._parse(open(p, "rb").read(), None)
    return d, sigs


def _cli(main, corpus, out, *args):
    """Run a CLI main in-process -> (exit code, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([str(corpus), "-o", str(out), *map(str, args)])
    return rc, buf.getvalue()


def _both(tmp_path, corpus, *args):
    """The JAX CLI and the port's on one corpus -> (jax out, port out)."""
    jo, po = tmp_path / "jax", tmp_path / "port"
    rc, _ = _cli(jax_cli.main, corpus, jo, *args)
    assert rc == 0
    rc, _ = _cli(port_cli.main, corpus, po, *args, "--device", "cpu")
    assert rc == 0
    return jo, po


def _npys(out) -> dict:
    return {f[:-4]: np.load(os.path.join(out, f)) for f in os.listdir(out)
            if f.endswith(".npy")}


def _report(out) -> dict:
    return json.loads((out / "run_report.0.json").read_text())


def _same(got: dict, want: dict, atol: float, rtol: float = 0.0):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol,
                                   err_msg=k)


FAMILIES = {
    "mfcc": ((), FeatureConfig(), oracle.mfcc),
    "logmel_deltas": (("--logmel", "--n-mels", "40", "--deltas"),
                      FeatureConfig(n_mels=40, n_mfcc=40, deltas=True),
                      oracle.log_mel),
    "plp": (("--plp",), FeatureConfig(), oracle.plp),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_cli_corpus_end_to_end(tmp_path, rng, family):
    args, cfg, ref = FAMILIES[family]
    d, sigs = _mk_corpus(tmp_path, rng)
    jo, po = _both(tmp_path, d, "--batch-size", "4", *args)
    got = _npys(po)
    # unbounded log-mel: f32 valleys, port vs JAX with rtol beside atol
    _same(got, _npys(jo), 1e-4, 1e-4 if family == "logmel_deltas" else 0.0)
    for name, sig in sigs.items():
        np.testing.assert_allclose(got[name], ref(sig.astype(np.float64), cfg),
                                   atol=1e-4 if family != "logmel_deltas"
                                   else 1e-3)
    rep = _report(po)
    assert rep["n_utterances"] == len(sigs)
    assert rep["config_hash"] == cfg.config_hash() == _report(jo)["config_hash"]
    assert rep["n_devices"] == 1 and rep["n_hosts"] == 1
    assert rep["max_abs_error"] < (1e-4 if family != "logmel_deltas" else 1e-3)
    assert set(rep["stage_seconds"]) == {"decode", "dispatch", "fetch+write"}


def test_cli_spectrogram(tmp_path, rng):
    """The spectrogram's contract: 2e-4 inside the 50 dB window."""
    d, sigs = _mk_corpus(tmp_path, rng, n=3)
    jo, po = _both(tmp_path, d, "--spectrogram")
    got, want = _npys(po), _npys(jo)
    cfg = FeatureConfig()
    for name, sig in sigs.items():
        ref = oracle.log_spectrogram(sig.astype(np.float64), cfg)
        keep = ref > ref.max(axis=1, keepdims=True) - np.log(10.0 ** 5)
        assert np.abs(got[name] - ref)[keep].max() <= 2e-4
        assert np.abs(got[name] - want[name])[keep].max() <= 2e-4
    assert _report(po)["max_abs_error"] <= 2e-4


def test_cli_resume_skips_done(tmp_path, rng, capsys):
    d, _ = _mk_corpus(tmp_path, rng, n=3)
    out = tmp_path / "feats"
    assert port_cli.main([str(d), "-o", str(out), "--device", "cpu"]) == 0
    capsys.readouterr()
    # nothing left to do: exit 1 and a message, as the JAX CLI
    assert port_cli.main([str(d), "-o", str(out), "--device", "cpu"]) == 1
    assert "no utterances" in capsys.readouterr().err
    assert _report(out)["n_utterances"] == 0


def test_cli_quarantines_bad_wav(tmp_path, rng):
    d, sigs = _mk_corpus(tmp_path, rng, n=2)
    (d / "corrupt.wav").write_bytes(b"RIFF....WAVEnope")
    x = (rng.standard_normal(8000) * 0.3).astype(np.float32)
    wav.write_wav(d / "rate8k.wav", x, 8000)        # foreign rate
    jo, po = tmp_path / "jax", tmp_path / "port"
    rc, jout = _cli(jax_cli.main, d, jo)
    assert rc == 0
    rc, pout = _cli(port_cli.main, d, po, "--device", "cpu")
    assert rc == 0                                  # the job survives
    for bad in ("corrupt", "rate8k"):
        assert f"[quarantine] {d / bad}.wav" in pout
        assert not (po / f"{bad}.npy").exists()
    _same(_npys(po), _npys(jo), 1e-4)
    jm = json.loads((jo / "manifest.0.json").read_text())
    pm = json.loads((po / "manifest.0.json").read_text())
    assert pm["quarantined"] == jm["quarantined"] and pm["done"] == jm["done"]


def test_cli_quarantines_encoding_the_decoder_cannot_take(tmp_path, rng):
    """A header of 4 bits a sample is quarantined at probe time: the
    native decoder divides by the bytes a sample."""
    d, sigs = _mk_corpus(tmp_path, rng, n=2)
    payload = bytes(400)
    with open(d / "adpcm.wav", "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", 16)
                + struct.pack("<HHIIHH", 1, 1, 16000, 8000, 1, 4))
        f.write(b"data" + struct.pack("<I", len(payload)) + payload)
    out = tmp_path / "port"
    rc, pout = _cli(port_cli.main, d, out, "--device", "cpu")
    assert rc == 0
    assert f"[quarantine] {d / 'adpcm.wav'}: unsupported audio format 1/4bit" \
        in pout
    assert sorted(_npys(out)) == sorted(sigs)


def test_cli_resample_policy(tmp_path, rng):
    d, sigs = _mk_corpus(tmp_path, rng, n=2)
    x = (rng.standard_normal(7000) * 0.3).astype(np.float32)
    wav.write_wav(d / "rate8k.wav", x, 8000)
    jo, po = _both(tmp_path, d, "--resample")
    got = _npys(po)
    _same(got, _npys(jo), 1e-4)
    assert got["rate8k"].shape[0] == FeatureConfig().num_frames(14000)


def test_cli_logmel_cmvn(tmp_path, rng):
    d, sigs = _mk_corpus(tmp_path, rng, n=4)
    jo, po = _both(tmp_path, d, "--logmel", "--n-mels", "32", "--cmvn")
    got = _npys(po)
    _same(got, _npys(jo), 1e-3)
    # normalized corpus: frame-weighted mean ~0, std ~1 per dim
    allf = np.concatenate([got[n] for n in sigs])
    np.testing.assert_allclose(allf.mean(axis=0), 0.0, atol=1e-3)
    np.testing.assert_allclose(allf.std(axis=0), 1.0, atol=1e-2)
    jz, pz = np.load(jo / "cmvn.npz"), np.load(po / "cmvn.npz")
    assert float(pz["count"]) == float(jz["count"])
    np.testing.assert_allclose(pz["sum"], jz["sum"], rtol=1e-5)
    np.testing.assert_allclose(pz["sumsq"], jz["sumsq"], rtol=1e-5)
    assert str(pz["config_hash"]) == str(jz["config_hash"])
    assert json.loads((po / "manifest.0.json").read_text())["cmvn_applied"]


def test_cli_cmvn_online_with_prior(tmp_path, rng):
    """A --cmvn pass writes cmvn.npz; a --cmvn-online run blends it as the
    prior while each causal window is young."""
    d, sigs = _mk_corpus(tmp_path, rng, n=3)
    rc, _ = _cli(port_cli.main, d, tmp_path / "pass1", "--cmvn",
                 "--device", "cpu")
    assert rc == 0
    prior_npz = tmp_path / "pass1" / "cmvn.npz"
    jo, po = _both(tmp_path, d, "--cmvn-online", "40",
                   "--cmvn-online-prior", prior_npz)
    z = np.load(prior_npz)
    prior = (float(z["count"]), z["sum"].astype(np.float64),
             z["sumsq"].astype(np.float64))
    cfg = FeatureConfig()
    got = _npys(po)
    _same(got, _npys(jo), 2e-5)
    for name, sig in sigs.items():
        want = oracle.online_cmvn(
            oracle.mfcc(sig.astype(np.float64), cfg), 40, prior=prior)
        np.testing.assert_allclose(got[name], want, atol=2e-5)
    assert _report(po)["max_abs_error"] < 1e-4


def test_cli_dynamic_range_db(tmp_path):
    """--dynamic-range-db reaches the pipeline: log-mel matches the oracle
    with the same per-frame relative floor."""
    d = tmp_path / "corpus"
    d.mkdir()
    t = np.arange(16000) / 16000.0
    x = (0.5 * np.sin(2 * np.pi * 440 * t)
         + 1e-4 * np.sin(2 * np.pi * 3700 * t)).astype(np.float32)
    wav.write_wav(d / "u.wav", x, 16000)
    sig, _ = wav._parse(open(d / "u.wav", "rb").read(), None)
    jo, po = _both(tmp_path, d, "--logmel", "--n-mels", "40",
                   "--dynamic-range-db", "60")
    cfg = FeatureConfig(n_mels=40, n_mfcc=40, dynamic_range_db=60.0)
    feat = np.load(po / "u.npy")
    want = oracle.log_mel(sig.astype(np.float64), cfg)
    np.testing.assert_allclose(feat, want, atol=1e-4)
    np.testing.assert_allclose(feat, np.load(jo / "u.npy"), atol=1e-4)
    nofloor = oracle.log_mel(sig.astype(np.float64),
                             FeatureConfig(n_mels=40, n_mfcc=40))
    assert np.abs(want - nofloor).max() > 1.0   # the floor engaged


def test_cli_vad_column(tmp_path, rng):
    """--vad appends a trailing 0/1 column equal to oracle.energy_vad on a
    margin-clear tone/silence signal; silence frames are unvoiced."""
    d = tmp_path / "corpus"
    d.mkdir()
    t = np.arange(32000) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * 220 * t)
         + 0.02 * rng.standard_normal(32000)).astype(np.float32)
    x[16000:] *= 1e-3                      # second half ~silence
    wav.write_wav(d / "u.wav", x, 16000)
    sig, _ = wav._parse(open(d / "u.wav", "rb").read(), None)
    jo, po = _both(tmp_path, d, "--vad", "--vad-context", "2")
    cfg = FeatureConfig()
    feat = np.load(po / "u.npy")
    assert feat.shape[1] == cfg.n_mfcc + 1
    np.testing.assert_allclose(feat[:, :-1],
                               oracle.mfcc(sig.astype(np.float64), cfg),
                               atol=1e-4)
    frames = oracle.frame_signal(sig.astype(np.float64), cfg)
    want_vad = oracle.energy_vad(oracle.log_energy(frames, cfg), context=2)
    np.testing.assert_array_equal(feat[:, -1], want_vad.astype(np.float64))
    np.testing.assert_array_equal(feat[:, -1], np.load(jo / "u.npy")[:, -1])
    assert feat[:20, -1].all() and not feat[-20:, -1].any()
    assert _report(po)["max_abs_error"] < 1e-4    # vad column excluded


def test_cli_frame_mode_center(tmp_path, rng):
    d, sigs = _mk_corpus(tmp_path, rng, n=2)
    jo, po = _both(tmp_path, d, "--frame-mode", "center")
    cfg = FeatureConfig(frame_mode="center").validate()
    got = _npys(po)
    _same(got, _npys(jo), 1e-4)
    for name, sig in sigs.items():
        assert got[name].shape[0] == (len(sig) + 80) // 160   # Kaldi count
        np.testing.assert_allclose(
            got[name], oracle.mfcc(sig.astype(np.float64), cfg), atol=1e-4)
    rep = _report(po)
    assert rep["max_abs_error"] < 1e-4
    assert rep["config_hash"] == cfg.config_hash()


@pytest.mark.parametrize("args,message", [
    (("--vad", "--cmvn"), "incompatible"),
    (("--logmel", "--plp"), "mutually exclusive"),
    (("--spectrogram", "--deltas"), "no delta append"),
    (("--cmvn", "--cmvn-sliding", "300"), "mutually exclusive"),
    (("--cmvn-online-prior", "x.npz"), "requires --cmvn-online"),
])
def test_cli_vad_cmvn_exclusive(tmp_path, args, message):
    """The CLI's guards: the same exit and message as the JAX CLI's."""
    msgs = []
    for main in (jax_cli.main, port_cli.main):
        with pytest.raises(SystemExit) as e:
            main([str(tmp_path), "-o", str(tmp_path / "o"), *args,
                  *(["--device", "cpu"] if main is port_cli.main else [])])
        msgs.append(str(e.value))
    assert message in msgs[1] and msgs[0] == msgs[1]


@pytest.mark.parametrize("args", [("--pack", "--pitch"),
                                  ("--pack", "--deltas"),
                                  ("--pack", "--frame-mode", "center")])
def test_cli_pack_guards(tmp_path, rng, args):
    d, _ = _mk_corpus(tmp_path, rng, n=1)
    with pytest.raises(ValueError, match="pack supports plain feature"):
        port_cli.main([str(d), "-o", str(tmp_path / "o"), *args,
                       "--device", "cpu"])


@pytest.mark.parametrize("args", [("--window", "blackman"),
                                  ("--backend", "pallas"),
                                  ("--device", "tpu")])
def test_cli_bad_args(args):
    r = subprocess.run(
        [sys.executable, "-m", "mfcc_tpu_torch", "nonexistent_dir_xyz",
         *args], capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert r.returncode == 2  # argparse rejects the choice


def test_cli_without_a_card_names_the_flag(tmp_path, rng):
    """No card and no --device cpu: exit 1 with one line naming the flag,
    no fallback to the host."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    d, _ = _mk_corpus(tmp_path, rng, n=1)
    r = subprocess.run(
        [sys.executable, "-m", "mfcc_tpu_torch", str(d), "-o",
         str(tmp_path / "out")], capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert r.returncode == 1
    lines = r.stderr.strip().splitlines()
    assert len(lines) == 1 and "--device cpu" in lines[0], r.stderr
    assert not (tmp_path / "out").exists() and r.stdout == ""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_runner.run(str(d), FeatureConfig(), port_runner.RunnerOptions(
            out_dir=str(tmp_path / "out")))


def test_python_m_mfcc_tpu_torch_device_cpu(tmp_path, rng):
    """The program as a user starts it on a host without a card."""
    d, sigs = _mk_corpus(tmp_path, rng, n=3)
    out = tmp_path / "feats"
    r = subprocess.run(
        [sys.executable, "-m", "mfcc_tpu_torch", str(d), "-o", str(out),
         "--device", "cpu", "--batch-size", "2"], capture_output=True,
        text=True, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout)["n_utterances"] == 3
    cfg = FeatureConfig()
    for name, sig in sigs.items():
        np.testing.assert_allclose(np.load(out / f"{name}.npy"),
                                   oracle.mfcc(sig.astype(np.float64), cfg),
                                   atol=1e-4)


def _read_format(out, fmt) -> dict:
    if fmt == "ark":
        return kaldi.read_scp(str(out / "features.0.scp"))
    if fmt == "tfrecord":
        return tfrecord.read_tfrecord(str(out / "features.0.tfrecord"))
    back = {}
    for f in os.listdir(out):
        if f.endswith(".htk"):
            feat, period, kind = htk.read_htk(str(out / f))
            assert abs(period - 0.010) < 1e-9 and kind == htk.PARM_USER
            back[f[:-4]] = feat
    return back


@pytest.mark.parametrize("fmt", ["ark", "tfrecord", "htk"])
def test_cli_ark_format(tmp_path, rng, fmt):
    """The archive formats (the twins of test_cli_ark_format,
    test_cli_tfrecord_format and test_cli_htk_format)."""
    d, sigs = _mk_corpus(tmp_path, rng, n=3)
    jo, po = _both(tmp_path, d, "--format", fmt)
    got = _read_format(po, fmt)
    _same(got, _read_format(jo, fmt), 1e-4)
    cfg = FeatureConfig()
    for name, sig in sigs.items():
        np.testing.assert_allclose(
            got[name], oracle.mfcc(sig.astype(np.float64), cfg), atol=1e-4)


@pytest.mark.parametrize("cmvn", [False, True])
def test_cli_pack_matches_padded(tmp_path, rng, cmvn):
    """--pack against the padded run and the JAX CLI's --pack: on the CPU
    a packed piece is bit-identical to the padded computation (the CMVN
    statistics sum in another order)."""
    d, sigs = _mk_corpus(tmp_path, rng, n=5)
    extra = ("--cmvn",) if cmvn else ()
    jo, po = _both(tmp_path, d, "--pack", "--pack-seconds", "1.5", *extra)
    rc, _ = _cli(port_cli.main, d, tmp_path / "padded", *extra,
                 "--device", "cpu")
    assert rc == 0
    got, padded = _npys(po), _npys(tmp_path / "padded")
    if cmvn:
        _same(got, padded, 1e-5, 1e-5)
    else:
        _same(got, padded, 0.0)
    _same(got, _npys(jo), 1e-4)
    assert _report(po)["n_utterances"] == len(sigs)


def test_cli_pack_quarantines_truncated_wav(tmp_path, rng):
    """A WAV whose header promises more samples than the file holds is
    quarantined under --pack (its missing tail is not computed over
    zeros); the other utterances equal a padded run."""
    d, sigs = _mk_corpus(tmp_path, rng, n=4)
    x = (rng.standard_normal(12000) * 0.3).astype(np.float32)
    p = d / "truncated.wav"
    wav.write_wav(p, x, 16000)
    p.write_bytes(p.read_bytes()[: 44 + 2 * 9000])   # 9000 of 12000 samples
    rc, pout = _cli(port_cli.main, d, tmp_path / "packed", "--pack",
                    "--pack-seconds", "1.5", "--device", "cpu")
    assert rc == 0
    assert f"[quarantine] {p}: decoded 9000 samples, the header promises " \
        "12000" in pout
    got = _npys(tmp_path / "packed")
    assert "truncated" not in got
    man = json.loads((tmp_path / "packed" / "manifest.0.json").read_text())
    assert str(p) in man["quarantined"]
    rc, _ = _cli(port_cli.main, d, tmp_path / "padded", "--device", "cpu")
    padded = _npys(tmp_path / "padded")
    padded.pop("truncated")        # the padded loop computes what it decoded
    _same(got, padded, 0.0)


def test_cli_pitch(tmp_path, rng):
    """--pitch appends the 3 pitch columns (the twin of
    tests/test_pitch.py::test_cli_pitch_append): MFCC columns at 1e-4,
    pitch columns at that test's 3e-4, to the JAX CLI's and to the
    aligned oracle; the report carries them apart."""
    from mfcc_tpu import PitchConfig
    d = tmp_path / "corpus"
    d.mkdir()
    t = np.arange(14000) / 16000.0
    sigs = {}
    for i, f0 in enumerate((140.0, 210.0)):
        x = (0.4 * np.sin(2 * np.pi * f0 * t)
             + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
        wav.write_wav(d / f"v{i}.wav", x, 16000)
        sigs[f"v{i}"], _ = wav._parse(open(d / f"v{i}.wav", "rb").read(),
                                      None)
    jo, po = _both(tmp_path, d, "--pitch")
    got, want = _npys(po), _npys(jo)
    cfg = FeatureConfig()
    for name, sig in sigs.items():
        assert got[name].shape == (cfg.num_frames(sig.size), cfg.n_mfcc + 3)
        np.testing.assert_allclose(got[name][:, :-3], want[name][:, :-3],
                                   atol=1e-4)
        np.testing.assert_allclose(got[name][:, -3:], want[name][:, -3:],
                                   atol=3e-4)
        want_p = oracle.pitch(sig.astype(np.float64), PitchConfig())
        idx = np.minimum(np.arange(got[name].shape[0]), want_p.shape[0] - 1)
        np.testing.assert_allclose(got[name][:, -3:], want_p[idx], atol=3e-4)
    rep = _report(po)
    assert rep["max_abs_error"] < 1e-4 and rep["max_abs_error_pitch"] < 3e-4


def test_cli_trace_dir(tmp_path, rng):
    """--trace-dir writes a torch.profiler Chrome trace of the run."""
    d, _ = _mk_corpus(tmp_path, rng, n=2)
    rc, _ = _cli(port_cli.main, d, tmp_path / "o", "--trace-dir",
                 tmp_path / "trace", "--device", "cpu")
    assert rc == 0
    trace = json.loads((tmp_path / "trace" / "trace.0.json").read_text())
    assert trace["traceEvents"]
