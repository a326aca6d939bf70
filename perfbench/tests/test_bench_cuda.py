"""One short run of a cell on the card (marked ``cuda``; skipped without
a card): the result line as the benchmark prints it."""

import json
import subprocess
import sys

import pytest

from perfbench import harness


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "mfcc13.libri_sorted", "--seed", "2147483659", "--seconds", "1",
         "--trace", "1"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert 0 < result["metrics"]["roofline_pct.fused_raw_dit"]["value"] < 100
