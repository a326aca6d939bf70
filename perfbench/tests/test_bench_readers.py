"""The metric readers and the trace reduction on a made-up trace."""

import types

import numpy as np
import pytest

from perfbench import harness, readings, work

SPECTRAL = "void (anonymous namespace)::raw_dit_fft_kernel<16, float, false>(spectral::FftParams<float>)"
RAW = "void (anonymous namespace)::raw_fft_kernel<32, double>(spectral::FftParams<double>)"
CAST = "void at::native::vectorized_elementwise_kernel<4, MulFunctor<float>>"


def _run(dev_ops, kind="NVIDIA H100 80GB HBM3", batches=2, window_s=1e-3,
         config="htk-mfcc13-16k"):
    busy = harness.busy_intervals(dev_ops, 0.0, window_s * 1e6)
    cfg = harness.load_json(harness.HERE / "configs" / f"{config}.json")
    return types.SimpleNamespace(
        trace={"dev_ops": dev_ops, "window_s": window_s,
               "busy_s": sum(e - s for s, e in busy) * 1e-6},
        traced=types.SimpleNamespace(
            batches=batches, lengths=[np.array([16000, 16000])] * batches),
        window=types.SimpleNamespace(host_ms=[0.3, 0.1, 0.2]),
        cell=types.SimpleNamespace(config=cfg), kind=kind)


OPS = [(SPECTRAL, 0.0, 100.0), (CAST, 100.0, 150.0),
       ("Memcpy DtoD (Device -> Device)", 150.0, 160.0),
       (SPECTRAL, 400.0, 500.0), (CAST, 450.0, 520.0)]


def test_matchers_take_whole_identifiers():
    raw_dit = readings.matcher(readings.SPECTRAL["fused_raw_dit"])
    raw = readings.matcher(readings.SPECTRAL["fused_raw"])
    dit = readings.matcher(readings.SPECTRAL["fused_dit"])
    assert raw_dit(SPECTRAL) and not raw(SPECTRAL) and not dit(SPECTRAL)
    assert raw(RAW) and not raw_dit(RAW)
    assert raw_dit("void raw_dit_kernel<8>(spectral::DirectParams)")


def test_counts_times_and_idle_share():
    r = _run(OPS)
    assert harness.reader("launches_per_batch")(r) == 2.0
    # everything but the spectral kernel, copies included: 50 + 10 + 70 us
    assert harness.reader("post_ms")(r) == pytest.approx(0.065)
    # busy: [0, 160] and [400, 520] of 1,000 us
    assert harness.reader("idle_pct")(r) == pytest.approx(72.0)
    assert harness.reader("host_enqueue_ms")(r) == pytest.approx(0.2)


def test_roofline_share():
    r = _run(OPS)
    ops, nbytes = work.spectral_work(
        r.cell.config["features"], True, np.concatenate(r.traced.lengths))
    want = 100 * max(ops / 67e12, nbytes / 3.35e12) / 200e-6
    assert harness.reader("roofline_pct.fused_raw_dit")(r) == pytest.approx(want)
    assert harness.reader("roofline_pct.fused_raw")(r) is None
    assert harness.reader("roofline_pct.fused_raw_dit")(_run(OPS, "cpu")) is None


def test_readers_find_nothing_in_an_empty_trace():
    r = _run([])
    for name in ("launches_per_batch", "post_ms", "idle_pct",
                 "roofline_pct.fused_raw_dit", "roofline_pct.fused_raw"):
        assert harness.reader(name)(r) is None


def test_breakdown_names_gaps_by_the_innermost_host_operation():
    busy = harness.busy_intervals(OPS, 0.0, 1000.0)
    assert busy == [[0.0, 160.0], [400.0, 520.0]]
    host = [("perfbench.batch", 150.0, 450.0, 1),
            ("aten::where", 250.0, 300.0, 1)]
    b = harness.breakdown(OPS, host, (0.0, 1000.0), busy)
    assert b["idle_gaps"][0] == ["host outside any recorded operation",
                                 pytest.approx(480e-6)]
    assert b["idle_gaps"][1] == ["aten::where", pytest.approx(240e-6)]
    assert b["device_ops"][0] == [SPECTRAL, pytest.approx(200e-6)]


def test_device_trace_leaves_out_annotations():
    from torch.autograd import DeviceType

    def ev(name, dev, annotation=False):
        return types.SimpleNamespace(
            name=name, device_type=dev, is_user_annotation=annotation,
            thread=1, time_range=types.SimpleNamespace(start=0.0, end=1.0))

    prof = types.SimpleNamespace(events=lambda: [
        ev("fused_raw_dit", DeviceType.CPU, True),
        ev("fused_raw_dit", DeviceType.CUDA),
        ev("perfbench.batch", DeviceType.CUDA, True),
        ev(SPECTRAL, DeviceType.CUDA)])
    dev_ops, host_ops = harness.device_trace(prof)
    assert [o[0] for o in dev_ops] == [SPECTRAL]
    assert [h[0] for h in host_ops] == ["fused_raw_dit"]
