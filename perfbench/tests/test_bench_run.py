"""A run driven on the CPU in place of the card: its result line, and
``correct`` false under each fault planted in the timed path."""

import json
import shutil
import subprocess
import sys

import pytest

import torch

from perfbench import faults, harness
from perfbench.reference import features as ref
from perfbench.tests.hostdev import Host, tiny_cell

CELLS = ("mfcc13.libri_sorted", "fbank80d.libri_sorted",
         "mfcc13.libri_shuffled")


def exact(cell):
    """The program's stand-in on the CPU.  The MFCC cells run the port's
    plain route, which meets their limit; unbounded log-mel on the plain
    float32 route is limited by its spectral valleys (~3e-4, the contract's
    "f32 valley limit"), where the card's fft64 tile reads ~2e-6, so the
    log-mel cell runs the float64 reference rounded to float32 instead."""
    if cell.config["output"] == "cepstra":
        return lambda call: call

    def wrap(call):
        def stand_in(x, lengths):
            feat, flens, mask = ref.features(
                x, lengths.tolist(), cell.config["features"], False)
            return feat.float(), flens.to(torch.int32), mask
        return stand_in
    return wrap


@pytest.mark.parametrize("name", CELLS)
def test_a_run_is_correct_and_reports_its_metrics(name):
    cell = tiny_cell(name)
    result, lines = harness.run(cell, 2 ** 32 + 7, 0.05, False, Host(),
                                wrap=exact(cell))
    assert result["correct"] and result["failed"] == 0
    assert list(result["metrics"]) == [m["name"] for m in
                                       cell.metrics["end_to_end"]]
    assert list(result)[-1] == "checks"
    assert len(lines) == len(result["checks"])
    assert all(k in result["device"] for k in
               ("platform", "kind", "count", "memory_peak_bytes"))
    json.dumps(result)


def test_a_traced_run_leaves_out_what_it_cannot_read():
    result, _ = harness.run(tiny_cell("mfcc13.libri_sorted"), 3, 0.05, True,
                            Host())
    # the CPU stand-in has no device operations: only the host clock reads
    assert list(result["metrics"]) == ["host_enqueue_ms"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS[:2])
def test_a_planted_fault_is_not_correct(name, fault):
    cell = tiny_cell(name)
    base = harness.run(cell, 9, 0.02, False, Host(), wrap=exact(cell))[0]
    assert base["correct"]
    result, _ = harness.run(cell, 9, 0.02, False, Host(),
                            wrap=lambda c: faults.FAULTS[fault](exact(cell)(c)))
    assert result["correct"] is False and result["failed"] > 0


def test_without_a_card_the_command_fails_and_prints_no_result(tmp_path):
    cmd = [sys.executable, "perfbench/run.py", "--workload",
           "mfcc13.libri_sorted", "--seed", "1", "--seconds", "1",
           "--trace", "0"]
    out = subprocess.run(cmd, cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    # a directory with only BENCHMARK.json and perfbench/: no program
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
