"""The port in two and four processes joined by ``torch.distributed`` over
gloo on the CPU (the twin of ``tests/test_multiprocess.py``).

The corpus runner: each process reads its strided shard of the corpus,
computes on its own device and writes its own manifest, report and
features; the float64 CMVN statistics are summed over gloo.  The outputs
must equal one process's run of the same corpus, and cmvn.npz its
statistics.  The padded cases run a worker given here as ``python -c``;
the packed case runs ``python -m mfcc_tpu_torch`` with the environment
``torchrun`` sets.

The global CMVN statistics on the device: each process extracts features
of its shard and ``cmvn.batch_stats_psum`` sums their statistics over the
processes; rank 0 holds them to the float64 oracle over the same
utterances (rtol 1e-4, atol 1e-2, as the reference's worker does).
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
rank, port, corpus, out, n = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                              sys.argv[4], int(sys.argv[5]))
from mfcc_tpu_torch import FeatureConfig, runner
from mfcc_tpu_torch.parallel import dist
dist.initialize(f"tcp://127.0.0.1:{port}", world_size=n, rank=rank)
rep = runner.run(corpus, FeatureConfig(cmvn=True).validate(),
                 runner.RunnerOptions(out_dir=out, batch_size=2, device="cpu"))
assert rep.n_hosts == n and rep.n_devices == 1, rep
assert rep.n_utterances > 0
dist.finalize()
print(f"rank {rank}: {rep.n_utterances} utterances", flush=True)
"""

# one process of the global CMVN case (the twin of tests/mp_cmvn_worker.py)
CMVN_WORKER = """
import os, sys
import numpy as np
import torch
rank, port, corpus, out, n = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                              sys.argv[4], int(sys.argv[5]))
from mfcc_tpu_torch import FeatureConfig, oracle
from mfcc_tpu_torch.models import mfcc as mfcc_model
from mfcc_tpu_torch.parallel import cmvn, dist
from mfcc_tpu_torch.utils import wav
dist.initialize(f"tcp://127.0.0.1:{port}", world_size=n, rank=rank)
cfg = FeatureConfig()
paths = sorted(os.path.join(corpus, f) for f in os.listdir(corpus)
               if f.endswith(".wav"))
PAD, B_LOCAL = 16000, 4


def rows(shard):
    for p in shard[:B_LOCAL]:
        x, _ = wav.read_wav(p)
        yield x[:PAD]


audio = np.zeros((B_LOCAL, PAD), np.float32)
lengths = np.zeros((B_LOCAL,), np.int32)
for i, x in enumerate(rows(dist.host_shard(paths))):
    audio[i, : len(x)], lengths[i] = x, len(x)
feat, flens, mask = mfcc_model.mfcc_batch(torch.from_numpy(audio),
                                          torch.from_numpy(lengths), cfg)
stats = cmvn.batch_stats_psum(feat, mask)   # summed across the processes
if rank == 0:
    # the oracle over the same utterances every process contributed
    feats64 = [oracle.mfcc(x.astype(np.float64), cfg) for r in range(n)
               for x in rows(dist.host_shard(paths, r, n))]
    c, s, sq = oracle.cmvn_stats(feats64)
    assert float(stats.count) == c, (float(stats.count), c)
    np.testing.assert_allclose(stats.sum.numpy(), s, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(stats.sumsq.numpy(), sq, rtol=1e-4, atol=1e-2)
    with open(os.path.join(out, "mp_ok"), "w") as f:
        f.write(f"count={float(stats.count)}\\n")
assert "jax" not in sys.modules and "mfcc_tpu" not in sys.modules
dist.finalize()
print(f"rank {rank} done; global frame count {float(stats.count)}",
      flush=True)
"""


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


def _run(cmd_args, nproc, **popen):
    procs = [subprocess.Popen(cmd_args(r), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, **popen)
             for r in range(nproc)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]


@pytest.mark.parametrize("nproc", [2, 4])
def test_multi_process_global_cmvn(tmp_path, rng, nproc):
    """The statistics of every process's shard summed on the device over
    gloo (``cmvn.batch_stats_psum``); n = 4 makes the strided shards and
    the reduction order non-trivial."""
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for i in range(4 * nproc):
        x = (rng.standard_normal(12000) * 0.3).astype(np.float32)
        wav.write_wav(corpus / f"u{i}.wav", x, 16000)
    port = _free_port()
    _run(lambda r: [sys.executable, "-c", CMVN_WORKER, str(r), str(port),
                    str(corpus), str(tmp_path), str(nproc)], nproc,
         cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert (tmp_path / "mp_ok").exists()


def test_four_process_runner_global_cmvn(tmp_path, rng):
    """The runner at 4 processes (the reference's runner test runs 2 and
    4): strided shards of an odd corpus, per-rank files, the float64 global
    statistics."""
    _runner_global_cmvn(tmp_path, rng, False, 4)


@pytest.mark.parametrize("pack", [False, True])
def test_two_process_runner_global_cmvn(tmp_path, rng, pack):
    _runner_global_cmvn(tmp_path, rng, pack, NPROC)


def _runner_global_cmvn(tmp_path, rng, pack, nproc):
    n = 2 * nproc + 1            # odd: uneven shards
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
                               WORLD_SIZE=str(nproc), MASTER_ADDR="127.0.0.1",
                               MASTER_PORT=str(port)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(nproc)]
        outs = [p.communicate(timeout=300)[0] for p in procs]
        for p, o in zip(procs, outs):
            assert p.returncode == 0, o[-3000:]
    else:
        _run(lambda r: [sys.executable, "-c", WORKER, str(r), str(port),
                        str(corpus), str(out), str(nproc)], nproc, cwd=REPO,
             env=env)

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
    for r in range(nproc):
        man = json.loads((out / f"manifest.{r}.json").read_text())
        assert man["done"] == sorted(paths[r::nproc]) and man["cmvn_applied"]
        rep = json.loads((out / f"run_report.{r}.json").read_text())
        assert rep["n_hosts"] == nproc
        assert rep["n_utterances"] == len(paths[r::nproc])
