"""The PyTorch port's example scripts (``examples/torch/``), twins of
``examples/*.py``: one for each, none importing jax or the JAX package
(the source check ``test_port_imports_no_jax`` makes of the package), and
each run with ``--device cpu`` at a small size."""

import ast
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from mfcc_tpu import FeatureConfig as JaxConfig
from mfcc_tpu.models import trainable as jax_trainable
from mfcc_tpu.utils import wav
from mfcc_tpu_torch import FeatureConfig, mfcc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = os.path.join(REPO, "examples", "torch")
NAMES = sorted(f for f in os.listdir(os.path.join(REPO, "examples"))
               if f.endswith(".py"))


def test_every_example_has_a_twin_importing_no_jax():
    assert NAMES and sorted(f for f in os.listdir(TWINS)
                            if f.endswith(".py")) == NAMES
    for name in NAMES:
        src = open(os.path.join(TWINS, name)).read()
        assert "import jax" not in src and "from jax" not in src, name
        assert "import mfcc_tpu\n" not in src, name
        assert "from mfcc_tpu " not in src and "from mfcc_tpu." not in src
        for node in ast.walk(ast.parse(src)):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "mfcc_tpu", "optax"), \
                    (name, m)
        assert "--device" in src and '"cuda"' in src, name


def _wavs(d, n=2, seconds=1.5):
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * 16000)) / 16000
    paths = []
    for i in range(n):
        x = (0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t)
             + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
        paths.append(str(d / f"u{i}.wav"))
        wav.write_wav(paths[-1], x, 16000)
    return paths


def _run(monkeypatch, capsys, tmp_path, name, *argv):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(sys, "argv", [name, *argv, "--device", "cpu"])
    runpy.run_path(os.path.join(TWINS, name), run_name="__main__")
    return capsys.readouterr().out


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_the_cpu(monkeypatch, capsys, tmp_path, name):
    paths = _wavs(tmp_path)
    if name == "extract_features.py":
        out = _run(monkeypatch, capsys, tmp_path, name, paths[0], "f.npy")
        x, _ = wav.read_wav(paths[0])
        want = mfcc(torch.from_numpy(x), FeatureConfig()).numpy()
        np.testing.assert_array_equal(np.load(tmp_path / "f.npy"), want)
        assert "-> (148, 13) features" in out
    elif name == "streaming_session.py":
        out = _run(monkeypatch, capsys, tmp_path, name, paths[0])
        assert "148 frames streamed; max |stream - batch| = 0.00e+00" in out
    elif name == "online_pitch.py":
        out = _run(monkeypatch, capsys, tmp_path, name, paths[0], "20")
        assert "total 146 frames (1.46 s of audio)" in out
    elif name == "longform_pitch.py":
        out = _run(monkeypatch, capsys, tmp_path, name, "--minutes", "0.05")
        assert "3 s of audio -> 296 pitch frames" in out
        chunked = _run(monkeypatch, capsys, tmp_path, name, "--minutes",
                       "0.05", "--nccf-chunk", "128")
        assert chunked == out
    elif name == "train_frontend.py":
        out = _run(monkeypatch, capsys, tmp_path, name, "--out", "f.npz",
                   "--steps", "20")
        a, b = (float(v) for v in out.split("loss ")[1].split(" (")[0]
                .split(" -> "))
        assert b < a, out
        # the checkpoint is the one the JAX package loads
        jcfg = JaxConfig(sample_rate=2000, n_fft=64, n_mels=8,
                         n_mfcc=4).validate()
        p = jax_trainable.load_params(str(tmp_path / "f.npz"), jcfg)
        assert np.asarray(p.mel_w).shape == (33, 8)
    elif name == "serving_session.py":
        out = _run(monkeypatch, capsys, tmp_path, name, *paths, "--fused",
                   "3")
        for b in range(2):
            assert f"session {b}: 148 normalized cepstral frames, 146 " \
                   "pitch frames" in out
    else:
        assert name == "pod_run.py"
        out = _run(monkeypatch, capsys, tmp_path, name, str(tmp_path), "out")
        assert '"n_utterances": 2' in out
        for i in range(2):
            assert np.load(tmp_path / "out" / f"u{i}.npy").shape == (148, 13)
