"""The port's twin of ``__graft_entry__.dryrun_multichip`` on the CPU:
``parallel/dryrun`` in 4 and 8 gloo processes (dp x sp x tp = 1 x 2 x 2
and 2 x 2 x 2), with the reference's bounds (raw 3e-5, CMVN 1e-4, kernel
route 3e-5, packed 3e-5) and the training step's against one process; its
command line; and how a failed rank fails the run.  On the CPU every step
takes the plain path, so no kernel launches."""

import os
import subprocess
import sys
import time

import pytest
import torch

from mfcc_tpu_torch.parallel import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = ("mfcc", "kernel route", "packed", "center", "pitch", "plp",
         "streaming", "post", "trainable")


@pytest.mark.parametrize("n,mesh", [(4, (1, 2, 2)), (8, (2, 2, 2))])
def test_dryrun_multichip_on_the_cpu(n, mesh):
    res = dryrun.dryrun_multichip(n, device="cpu")
    dp, sp, tp = mesh
    assert res["mesh"] == {"dp": dp, "sp": sp, "tp": tp}
    assert res["feat_shape"] == [2 * dp, 98, 4]
    assert res["raw_err"] < dryrun.RAW_TOL
    assert res["cmvn_err"] < dryrun.CMVN_TOL
    assert res["kernel_err"] < dryrun.KERNEL_TOL
    assert res["packed_err"] < dryrun.PACKED_TOL
    assert res["loss_rel_err"] <= dryrun.LOSS_RTOL
    assert res["grad_rel_err"] <= dryrun.GRAD_TOL
    assert res["adam_bound_ratio"] <= 1.0
    assert res["loss"] > 0 and res["device"] == "cpu"
    assert res["summary"].startswith(
        f"dryrun_multichip OK: mesh dp={dp} sp={sp} tp={tp}, feat "
        f"({2 * dp}, 98, 4), loss ")
    assert res["summary"].endswith("models: mfcc mfcc-kernel packed center "
                                   "pitch plp streaming post trainable")
    assert len(res["launches"]) == n
    for per_rank in res["launches"]:
        assert tuple(per_rank) == STEPS
        assert all(n == 0 for step in per_rank.values()
                   for n in step.values())
    ms = res["ms"]
    assert ms["stats_all_reduce"] > 0 and ms["stats_all_reduce_host"] > 0
    assert ms["feat_all_gather"] > 0
    assert ms["train_step_sharded"] > 0 and ms["train_step_one_process"] > 0


def test_dryrun_command_line():
    """``python -m mfcc_tpu_torch.parallel.dryrun 2 --device cpu``: two
    ranks (dp 1 x sp 1 x tp 2), rank 0's summary line."""
    proc = subprocess.run(
        [sys.executable, "-m", dryrun.MODULE, "2", "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("dryrun_multichip OK: mesh dp=1 sp=1 tp=2,")


def test_dryrun_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        dryrun.dryrun_multichip(2)
    proc = subprocess.run([sys.executable, "-m", dryrun.MODULE, "2"],
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and not proc.stdout
    assert "no CUDA device" in proc.stderr


def test_a_failed_rank_stops_the_others(tmp_path):
    cmds = [[sys.executable, "-c", "import sys; print('boom'); sys.exit(3)"],
            [sys.executable, "-c", "import time; time.sleep(120)"]]
    logs = [str(tmp_path / "r0.log"), str(tmp_path / "r1.log")]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 exited with code 3"):
        dryrun.run_ranks(cmds, logs, dict(os.environ), timeout=100)
    assert time.monotonic() - t0 < 60
    with pytest.raises(TimeoutError):
        dryrun.run_ranks(cmds[1:], logs[1:], dict(os.environ), timeout=1)
