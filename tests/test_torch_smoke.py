"""chip_smoke.py rehearsed on the CPU, so that a fault in one of its phases
shows here and not first on the card.

``torch.cuda`` is faked (synchronize, Event, device name and count), nvcc
is not called, ``backend.resolve`` routes "auto" to "cuda", and each kernel
wrapper counts a launch (and, for the two kernels with an FFT and a direct
tile, the tile the config picks) and runs its plain version on the CPU
tensor it is given.  Every phase then runs end to end at a small size: the
control flow, shapes, comparisons, launch and tile accounting and the
kernels' JSON record with its bounds.  Imports no jax.
"""

import importlib.util
import json
import os
import time

import torch

from mfcc_tpu_torch import backend
from mfcc_tpu_torch.ops.kernels import (_build, _spectral, fused_dit,
                                        fused_mfcc, fused_nccf, fused_raw,
                                        fused_raw_dit, fused_viterbi)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRAPPERS = ((fused_raw_dit, "fused_features_raw_dit"),
            (fused_raw, "fused_features_raw"),
            (fused_dit, "fused_features_dit"),
            (fused_mfcc, "fused_features"),
            (fused_nccf, "fused_nccf"),
            (fused_viterbi, "fused_viterbi"))


class _Event:
    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def _counting(mod, name):
    fn = getattr(mod, name)

    def wrapper(*args, **kwargs):
        mod.LAUNCHES += 1
        x, cfg = args[:2]
        if hasattr(mod, "TILE_LAUNCHES") and x.shape[0] and \
                cfg.num_frames(x.shape[1]):
            fft = _spectral.fft_tile(cfg, kwargs.get("apply_dct", True))
            mod.TILE_LAUNCHES["fft" if fft else "direct"] += 1
        return fn(*args, **kwargs)

    return wrapper


def test_chip_smoke_phases_rehearsed_on_the_cpu(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name, value in (("BATCH", 8), ("SECONDS", 1.0), ("TIMING_CALLS", 2),
                        ("VITERBI_BATCHES", (1, 3)),
                        ("VITERBI_STEPS", (1, 2, 65)),
                        ("LONG_SECONDS", 12.0)):
        monkeypatch.setattr(smoke, name, value)
    monkeypatch.setattr(smoke, "_smi", lambda: "Fake GPU, 700.00 W")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "Fake GPU")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(_build, "load", lambda name: None)
    resolve = backend.resolve
    monkeypatch.setattr(backend, "resolve", lambda name, x: (
        "cuda" if name in ("auto", "cuda") else resolve(name, x)))
    for mod, fn in WRAPPERS:
        monkeypatch.setattr(mod, "LAUNCHES", mod.LAUNCHES)   # restored after
        if hasattr(mod, "TILE_LAUNCHES"):
            monkeypatch.setattr(mod, "TILE_LAUNCHES", dict(mod.TILE_LAUNCHES))
        monkeypatch.setattr(mod, fn, _counting(mod, fn))

    kernels = smoke.run(torch, torch.device("cpu"))

    out = capsys.readouterr().out
    for phase in [*map(str, range(1, 10)), "3b", "3c", "4b"]:
        assert f"[{phase} " in out, phase
    assert "[3b FFT tile vs plain] fused_mfcc cepstra, n_fft 4096" in out
    assert "n_fft 401: direct tile" in out
    assert "Fake GPU, 700.00 W" in out
    json.dumps({"kernels": kernels})
    assert [k["name"] for k in kernels] == list(smoke.KERNELS)
    # launches are the main paths' own: one per batch call (fused_raw_dit:
    # two MFCC batches and the 50 dB log-mel batch), no golden or check run
    assert {k["name"]: k["launches"] for k in kernels} == {
        "fused_raw_dit": 3, "fused_raw": 1, "fused_mfcc": 1, "fused_dit": 1,
        "fused_nccf": 1, "fused_viterbi": 1}
    for k in kernels:
        assert k["route"] == "cuda" and k["launches"] > 0, k
        assert os.path.exists(os.path.join(REPO, k["source"])), k
        path, line = k["replaces"].split(":")
        assert os.path.exists(os.path.join(REPO, path)), k
        src = open(os.path.join(REPO, path)).read().splitlines()
        assert src[int(line) - 1].startswith("def "), k
        assert k["ms"] > 0 and k["plain_ms"] > 0, k
        assert k["bound_ms"] > 0 and k["library_ms"] is None, k
        assert k["bound_by"] in ("bytes", "operations"), k
    tiles = {k["name"]: k["tile"] for k in kernels}
    assert tiles == {"fused_raw_dit": "fft", "fused_mfcc": "fft",
                     "fused_raw": "direct", "fused_dit": "dit",
                     "fused_nccf": "direct", "fused_viterbi": None}
    for k in kernels:
        fft = k["name"] in ("fused_raw_dit", "fused_mfcc")
        assert (k["direct_tile_ms"] is not None) == fft, k
        assert (k["rfft_stage_ms"] is not None) == fft, k
    # on the CPU the wrappers run the plain versions: no difference at all
    assert [k["max_abs_err"] for k in kernels] == [0.0] * 5 + [0]
    assert "0 differ in any bit" in out
