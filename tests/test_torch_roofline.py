"""mfcc_tpu_torch/tools/roofline.py on the CPU: its rungs' text edits
against the current sources, each path's launch plan against the host's
shared-memory mirror, each rung's plain twin against the JAX package's ops
on the same numpy input, the reference probe's signal, the derived shares
and the JSON keys, and the exit without a card.  The rungs themselves run
only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase
21).  The JAX probe's kernels are closures of its ``main()`` whose outputs
mean nothing (``bench/roofline.py:32-33``), so the twins are held to JAX's
ops instead."""

import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mfcc_tpu import FeatureConfig as JaxConfig
from mfcc_tpu.models import logmel as jax_logmel, mfcc as jax_mfcc
from mfcc_tpu.ops import (dct as jax_dct, framing as jax_framing,
                          mel as jax_mel, spectrum as jax_spectrum)
from mfcc_tpu_torch import from_jax
from mfcc_tpu_torch.ops.kernels import _build, _spectral
from mfcc_tpu_torch.tools import roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5        # cepstra, port vs JAX (tests/test_torch_mfcc.py)
LOGMEL_TOL = 1e-4  # unbounded log-mel, atol and rtol (test_torch_logmel.py)
# the text of csrc/fft_tile.cuh no rung may change: a rung runs the
# kernel's launch, shared memory and first pass
KEPT = ("inline cudaError_t launch_fft(",
        "inline size_t fft_smem_bytes(",
        "__device__ __forceinline__ void fft_first_pass(")
# each path's frame tile on 64 x 10 s (read off fft_smem_bytes)
TMS = {"fused_raw_dit": 16, "fused_raw": 32, "fused_mfcc": 8}


def _function(text: str, head: str) -> str:
    start = text.index(head)
    return text[start:text.index("\n}\n", start) + 3]


def _jax_cfg(path):
    return JaxConfig(**roofline.PATHS[path][1].__dict__).validate()


def _small(path):
    """2 rows x 0.5 s of the probe's signal at the path's rate, as numpy,
    and the kernel's input (the host pre-emphasizes for fused_mfcc)."""
    cfg = roofline.PATHS[path][1]
    x = roofline.signal(cfg, 2, 0.5)
    return x, roofline.kernel_input(path, torch.from_numpy(x))


@pytest.mark.parametrize("source", sorted(roofline.SOURCES))
@pytest.mark.parametrize("rung", roofline.BUILT)
def test_rung_edits_apply_once(rung, source):
    """Each edit matches the current sources exactly once (else
    variant_sources raises), for each source the ladder builds."""
    files = roofline.variant_sources(rung)
    assert f"{source}.cu" in files
    assert "mfcc_roofline_plan" in files[roofline.TILE]
    assert "record_plan(TM, p);" in files[roofline.TILE]
    marker = {"stage": 'rung "stage"', "fft": 'rung "fft"',
              "fftlog": None}[rung]
    if marker:
        assert marker in files[roofline.TILE]
    # every rung cuts the frame energy but stage, which stops before it
    assert ("se = fma_s(v, v, se);" in files[roofline.TILE]) == (
        rung == "stage")


@pytest.mark.parametrize("rung", roofline.BUILT)
def test_rungs_keep_the_kernels_launch(rung):
    """The edited copies leave launch_fft, fft_smem_bytes, fft_first_pass,
    spectral.cuh and every C entry's source as they are."""
    files = roofline.variant_sources(rung)
    orig = {p.name: p.read_text() for p in _build.CSRC.iterdir()}
    assert set(files) == set(orig)
    for name, text in orig.items():
        if name != roofline.TILE:
            assert files[name] == text, name
    for head in KEPT:
        assert _function(files[roofline.TILE], head) == \
            _function(orig[roofline.TILE], head), head


@pytest.mark.parametrize("path", list(roofline.PATHS))
def test_plan_is_the_smem_mirrors(path):
    """The shapes the tool reports are _spectral.fft_smem_bytes's plan: the
    largest frame tile within the flavour's target."""
    _, cfg, dct = roofline.PATHS[path]
    N = int(10 * cfg.sample_rate)
    p = roofline.plan(path, 64, N)
    tile = _spectral.fft_tile(cfg, dct)
    tm = TMS[path]
    assert p["tile"] == tile == ("fft64" if path == "fused_raw" else "fft")
    assert p["TM"] == tm and p["T"] == 998
    assert p["smem_bytes"] == _spectral.fft_smem_bytes(cfg, tile, tm)
    assert p["smem_bytes"] <= roofline.SMEM_TARGET[tile] < \
        _spectral.fft_smem_bytes(cfg, tile, 2 * tm)
    size, wave, shift, lead = _spectral.FFT_FLAVOURS[tile]
    assert p["pairs"] == max(1, min(wave // cfg.n_fft, tm // 2))
    assert p["span"] == ((tm - 1) * cfg.hop_len + cfg.frame_len + 3) // 4 * 4
    assert p["tiles"] == -(-998 // tm) and p["blocks"] == 64 * p["tiles"]
    assert (p["n_fft"], p["frame_len"], p["hop"]) == (
        cfg.n_fft, cfg.frame_len, cfg.hop_len)
    assert (p["smem_bytes"], p["blocks"]) == {
        "fused_raw_dit": (46784, 4032), "fused_raw": (66756, 2048),
        "fused_mfcc": (51456, 8000)}[path]


def test_smem_targets_are_the_kernels():
    """SMEM_TARGET mirrors spectral::fft_smem_target (kBlocks of each
    flavour in csrc/fft_tile.cuh)."""
    text = (_build.CSRC / roofline.TILE).read_text()
    blocks = re.findall(r"static constexpr int kBlocks = (\d+);", text)
    assert blocks == ["4", "3"]
    assert "(228 / FftFlavour<S>::kBlocks - 2) * 1024" in text
    assert roofline.SMEM_TARGET == {"fft": (228 // 4 - 2) * 1024,
                                    "fft64": (228 // 3 - 2) * 1024}


@pytest.mark.parametrize("path", list(roofline.PATHS))
def test_stage_twin_matches_jax_preemphasis(path):
    """The stage rung's twin: the staged samples at each frame's start, bit
    for bit the JAX package's pre-emphasis there (raw samples on the fft64
    tile)."""
    src, cfg, dct = roofline.PATHS[path]
    x, inp = _small(path)
    jc = _jax_cfg(path)
    got = roofline.plain_rung("stage", inp, cfg, dct, src).numpy()
    staged = (x if path == "fused_raw" else
              np.asarray(jax_framing.preemphasize(jnp.asarray(x), jc)))
    idx = jax_framing.frame_indices(x.shape[1], jc)
    want = staged[:, idx[:, :_spectral.n_out(cfg, dct)]]
    assert got.shape == want.shape == (2, cfg.num_frames(x.shape[1]),
                                       _spectral.n_out(cfg, dct))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("path", list(roofline.PATHS))
def test_fft_twin_matches_jax_ops(path):
    """The fft rung's twin: JAX's power spectrum, mel matrix and DCT
    without floors or log, within 1e-5 of its max."""
    src, cfg, dct = roofline.PATHS[path]
    x, inp = _small(path)
    jc = _jax_cfg(path)
    got = roofline.plain_rung("fft", inp, cfg, dct, src).numpy()
    frames = jax_framing.frame_batch(jnp.asarray(x), jc)
    power = np.asarray(jax_spectrum.power_spectrum(frames, jc), np.float64)
    want = power @ jax_mel.mel_matrix(jc)
    if dct:
        want = want @ jax_dct.dct_matrix(jc)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale


@pytest.mark.parametrize("path", list(roofline.PATHS))
def test_fftlog_twin_matches_jax_batch(path):
    """The fftlog rung's twin (the kernel module's plain version) against
    the JAX mfcc_batch / log_mel_batch at the port-vs-JAX tolerances."""
    src, cfg, dct = roofline.PATHS[path]
    x, inp = _small(path)
    jc = _jax_cfg(path)
    lens = jnp.full((2,), x.shape[1], jnp.int32)
    got = roofline.plain_rung("fftlog", inp, cfg, dct, src).numpy()
    if dct:
        want = np.asarray(jax_mfcc.mfcc_batch_jit(jnp.asarray(x), lens, jc,
                                                  "xla")[0])
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    else:
        want = np.asarray(jax_logmel.log_mel_batch_jit(jnp.asarray(x), lens,
                                                       jc, "xla")[0])
        np.testing.assert_allclose(got, want, atol=LOGMEL_TOL,
                                   rtol=LOGMEL_TOL)


def test_plain_rung_refuses_what_no_rung_computes():
    cfg = roofline.PATHS["fused_raw_dit"][1]
    x = torch.from_numpy(roofline.signal(cfg, 1, 0.1))
    with pytest.raises(ValueError, match="append_energy"):
        roofline.plain_rung("fftlog", x, cfg.replace(append_energy=True),
                            True)
    with pytest.raises(ValueError, match="kernel"):
        roofline.plain_rung("kernel", x, cfg, True)


def test_the_probes_signal_and_frame_count():
    """seed 0, 0.1 N(0, 1) in float32 and T = 998, as bench/roofline.py."""
    src = open(os.path.join(REPO, "bench", "roofline.py")).read()
    assert "rng = np.random.default_rng(0)" in src
    assert "audio = (0.1 * rng.standard_normal((B, n))).astype(np.float32)" \
        in src
    rng = np.random.default_rng(0)
    want = (0.1 * rng.standard_normal((2, 8000))).astype(np.float32)
    cfg = roofline.PATHS["fused_raw_dit"][1]
    np.testing.assert_array_equal(roofline.signal(cfg, 2, 0.5), want)
    N = int(roofline.SECONDS * cfg.sample_rate)
    assert roofline.plan("fused_raw_dit", roofline.BATCH, N)["T"] == \
        JaxConfig().validate().num_frames(N) == 998
    assert from_jax(JaxConfig()) == cfg
    assert (roofline.BATCH, roofline.SECONDS) == (64, 10.0)


def test_derived_shares_and_json_keys():
    """The five shares from fixed times, and the document's keys
    (bench/roofline.py's, on this ladder)."""
    med = {"stage": 0.04, "fft": 0.18, "fftlog": 0.19, "kernel": 0.2}
    d = roofline.derived(med, 44_281_344)
    assert d["kernel_pct_of_attainable_ceiling"] == pytest.approx(90.0)
    assert d["log_cost_pct_of_fft_chain"] == pytest.approx(100 / 18)
    assert d["fft_cost_pct_of_stage_floor"] == pytest.approx(350.0)
    assert d["energy_cost_pct"] == pytest.approx(100 / 19)
    assert d["stage_pct_of_hbm"] == pytest.approx(
        100 * 44_281_344 / 3.35e12 * 1e3 / 0.04)
    assert roofline.path_bytes("fused_raw_dit", 64, 160000) == 44_281_344
    results = {"fused_raw_dit": {r: {"ms": [t, t], "median_ms": t,
                                     "host_enqueue_ms": 0.01}
                                 for r, t in med.items()}}
    inputs = {"fused_raw_dit": torch.empty((64, 160000))}
    doc = roofline.report(results, inputs, "Fake GPU, 700.00 W", 2,
                          {"fused_raw_dit": {"plan": {},
                                             "fft_max_abs_err": 0.0,
                                             "fft_rel_err": 0.0}})
    assert set(doc) == {"device", "batch", "utt_seconds", "passes", "calls",
                        "protocol", "shapes", "results", "derived", "checks"}
    assert doc["protocol"] == "cuda-events" and doc["batch"] == 64
    assert doc["utt_seconds"] == 10.0 and doc["calls"] == roofline.CALLS
    assert set(doc["derived"]["fused_raw_dit"]) == set(d)
    r = doc["results"]["fused_raw_dit"]
    assert list(r) == list(roofline.RUNGS)
    assert r["kernel"]["audio_sec_per_s"] == pytest.approx(640 / 0.2e-3)
    assert set(doc["shapes"]["fused_raw_dit"]) >= {
        "n_fft", "frame_len", "hop", "T", "TM", "pairs", "span",
        "smem_bytes", "blocks", "tile"}
    line = roofline.path_line(doc, "fused_raw_dit")
    assert set(line) == {"path", "device", "shapes", "results", "derived",
                         "checks"}
    assert line["path"] == "fused_raw_dit" and "plan" not in line["checks"]
    assert line["device"] == "Fake GPU, 700.00 W"
    assert roofline.DEFAULT_OUT.parts[-3:] == ("build", "roofline",
                                              "roofline.json")


def test_main_without_a_card_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def nothing(*a, **k):
        raise AssertionError("built without a card")
    monkeypatch.setattr(roofline, "build", nothing)
    assert roofline.main(["--passes", "1"]) == 1
    captured = capsys.readouterr()
    assert "needs an NVIDIA GPU" in captured.err and captured.out == ""
    with pytest.raises(SystemExit):
        roofline.main(["--paths", "fused_dit"])
