"""The port's corpus runner in two processes joined by ``torch.distributed``
over gloo on the CPU (the twin of ``tests/test_multiprocess.py``).

Each process reads its strided shard of the corpus, computes on its own
device and writes its own manifest, report and features; the float64 CMVN
statistics are summed over gloo.  The outputs must equal one process's run
of the same corpus, and cmvn.npz its statistics.  The padded case runs a
worker given here as ``python -c``; the packed case runs ``python -m
mfcc_tpu_torch`` with the environment ``torchrun`` sets.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from mfcc_tpu.utils import wav
from mfcc_tpu_torch import FeatureConfig, runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC = 2

# one process of the padded case: joins the group with explicit arguments
WORKER = """
import sys
rank, port, corpus, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
from mfcc_tpu_torch import FeatureConfig, runner
from mfcc_tpu_torch.parallel import dist
dist.initialize(f"tcp://127.0.0.1:{port}", world_size=%d, rank=rank)
rep = runner.run(corpus, FeatureConfig(cmvn=True).validate(),
                 runner.RunnerOptions(out_dir=out, batch_size=2, device="cpu"))
assert rep.n_hosts == %d and rep.n_devices == 1, rep
assert rep.n_utterances > 0
print(f"rank {rank}: {rep.n_utterances} utterances", flush=True)
""" % (NPROC, NPROC)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _corpus(tmp_path, rng, n):
    d = tmp_path / "corpus"
    d.mkdir()
    for i in range(n):
        x = (rng.standard_normal(int(rng.integers(4800, 16000)))
             * 0.3).astype(np.float32)
        wav.write_wav(d / f"u{i}.wav", x, 16000)
    return d


@pytest.mark.parametrize("pack", [False, True])
def test_two_process_runner_global_cmvn(tmp_path, rng, pack):
    n = 2 * NPROC + 1            # odd: uneven shards
    corpus = _corpus(tmp_path, rng, n)
    ref = tmp_path / "ref"
    runner.run(str(corpus), FeatureConfig(cmvn=True).validate(),
               runner.RunnerOptions(out_dir=str(ref), batch_size=2,
                                    device="cpu"))
    out = tmp_path / "out"
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    if pack:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "mfcc_tpu_torch", str(corpus), "-o",
             str(out), "--cmvn", "--pack", "--pack-seconds", "2",
             "--batch-size", "2", "--device", "cpu"],
            cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r),
                               WORLD_SIZE=str(NPROC), MASTER_ADDR="127.0.0.1",
                               MASTER_PORT=str(port)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(NPROC)]
    else:
        procs = [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), str(port), str(corpus),
             str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(NPROC)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]

    # every utterance once, equal to the one-process run (the global
    # statistics are the same float64 sums in another order)
    for i in range(n):
        np.testing.assert_allclose(np.load(out / f"u{i}.npy"),
                                   np.load(ref / f"u{i}.npy"),
                                   atol=2e-5 if pack else 1e-5, rtol=1e-5)
    got, want = np.load(out / "cmvn.npz"), np.load(ref / "cmvn.npz")
    assert float(got["count"]) == float(want["count"])
    np.testing.assert_allclose(got["sum"], want["sum"], rtol=1e-9)
    np.testing.assert_allclose(got["sumsq"], want["sumsq"], rtol=1e-9)
    # per-rank manifests over the strided shards, per-rank reports
    paths = runner.collect_wavs(str(corpus))
    for r in range(NPROC):
        man = json.loads((out / f"manifest.{r}.json").read_text())
        assert man["done"] == sorted(paths[r::NPROC]) and man["cmvn_applied"]
        rep = json.loads((out / f"run_report.{r}.json").read_text())
        assert rep["n_hosts"] == NPROC
        assert rep["n_utterances"] == len(paths[r::NPROC])
