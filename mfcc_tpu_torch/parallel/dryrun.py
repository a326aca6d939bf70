"""The reference's multichip dry run across processes (twin of
``__graft_entry__.dryrun_multichip``).

    python -m mfcc_tpu_torch.parallel.dryrun N [--device cpu]
        [--config default --batch 64 --seconds 10]

starts N processes joined by ``torch.distributed`` on gloo
(``parallel/dist``), lays their ranks out as the reference's mesh, dp x sp
x tp = ``mesh.split(N)`` over ("data", "time", "feat"), and runs one full
distributed step in each, with the reference's asserts and bounds:

- inference under dp x sp: ``mfcc_batch`` on the rank's rows, the
  statistics of its frame block summed over data x time
  (``cmvn.batch_stats_psum``), ``cmvn.apply``; against one process on the
  whole batch, raw 3e-5 and CMVN 1e-4;
- the kernel route under dp: a config the route sends to ``fused_raw_dit``
  (the card's kernel; the plain path on the CPU), 3e-5;
- a split-packed batch under dp: every utterance start against its
  standalone features, 3e-5;
- centre mode, pitch, PLP, streaming (``process_chunks_batch``) and the
  post trio under dp: shapes and frame counts;
- the trainable front end's dp x sp x tp step (``models/trainable``, its
  filterbank columns split over "feat"): the loss finite, and against one
  process's step on the whole batch: the loss within rtol 1e-5, the
  clipped gradients within 1e-4 of their largest element (float32 sums
  over the batch reassociated by the split), the parameters after the
  step within the bound Adam's first step puts on them
  (:func:`adam_step_bound`).

Rank 0 prints the reference's one summary line.  Each rank computes on
``cuda:{rank % device_count}`` (on one card every rank shares it), or on
the CPU with ``--device cpu``, counts the kernels each step launches, and
asserts that neither jax nor ``mfcc_tpu`` was imported.  The default
config is the reference's tiny one (2 kHz, n_fft 64, 8 mels, B = 2 dp rows
of 1 s of noise); ``--config default`` runs the MFCC + CMVN and training
steps at the default FeatureConfig on the bench batch (two tones plus
noise, numpy seed 0), the other models staying at the tiny sizes.  A
failed rank fails the run: the others are stopped and its log raised.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as tdist

from . import cmvn, dist, mesh as mesh_lib
from .mesh import DATA_AXIS, FEAT_AXIS, TIME_AXIS

MODULE = "mfcc_tpu_torch.parallel.dryrun"
PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY = dict(sample_rate=2000, frame_ms=25, hop_ms=10, n_fft=64, n_mels=8,
            n_mfcc=4)
RAW_TOL = 3e-5       # sharded vs unsharded features (tests/test_parallel.py)
CMVN_TOL = 1e-4      # the same after CMVN (divides by each dim's std)
KERNEL_TOL = 3e-5    # the kernel route, sharded vs unsharded
PACKED_TOL = 3e-5    # a packed segment vs its standalone features
LOSS_RTOL = 1e-5     # sharded training loss vs one process's
GRAD_TOL = 1e-4      # clipped gradients, relative to their largest element
LR = 1e-3            # the training step's (make_optimizer's default)
ADAM_EPS = 1e-8
TIMED = 10           # calls of each timed collective and step
KERNELS = ("fused_raw_dit", "fused_raw", "fused_mfcc", "fused_dit",
           "fused_nccf", "fused_viterbi")


def bench_signal(batch: int, n: int, sr: int) -> np.ndarray:
    """The bench.py signal: two tones plus noise, numpy seed 0."""
    rng = np.random.default_rng(0)
    t = np.arange(n) / sr
    base = (0.3 * np.sin(2 * np.pi * 180 * t)
            + 0.1 * np.sin(2 * np.pi * 1200 * t)).astype(np.float32)
    audio = np.tile(base, (batch, 1))
    audio += 0.02 * rng.standard_normal(audio.shape).astype(np.float32)
    return audio


def adam_step_bound(g_a: torch.Tensor, g_b: torch.Tensor, p: torch.Tensor,
                    lr: float = LR, rel: float = 1e-6) -> torch.Tensor:
    """Per-element bound on |p_a - p_b| after Adam's first step from equal
    parameters p with gradients g_a and g_b (then the projection, which is
    1-Lipschitz).  The first step moves p by lr g / (|g| + eps), whose
    change between g_a and g_b is at most |g_a - g_b| / (min(|g_a|, |g_b|)
    + eps) and at most 2; plus ``rel`` of lr for the update's rounding
    (two torch.optim.Adam steps: 1e-6) and 2^-22 of |p| for p's."""
    d = (g_a - g_b).abs() / (torch.minimum(g_a.abs(), g_b.abs()) + ADAM_EPS)
    return lr * (torch.clamp(d, max=2.0) + rel) + p.abs() * 2.0 ** -22


def _kernel_modules() -> dict:
    from ..ops.kernels import (fused_dit, fused_mfcc, fused_nccf, fused_raw,
                               fused_raw_dit, fused_viterbi)
    mods = (fused_raw_dit, fused_raw, fused_mfcc, fused_dit, fused_nccf,
            fused_viterbi)
    return dict(zip(KERNELS, mods))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_ms(fn, dev, reps: int = TIMED) -> float:
    """ms a call of fn: CUDA events around reps calls on the card, the host
    clock on the CPU; one call first, untimed."""
    fn()
    _sync(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def _world_max(x: float) -> float:
    t = torch.tensor([float(x)], dtype=torch.float64)
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX)
    return float(t)


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def run_rank(rank: int, world: int, port: int, device: str = "cuda",
             config: str = "tiny", batch: int | None = None,
             seconds: float = 1.0) -> dict:
    """One rank of the dry run (every rank calls it, in its own process)
    -> its results: errors (maxima over the world), launches by step,
    timings, and on rank 0 the summary line."""
    from .. import backend
    from ..config import FeatureConfig, PitchConfig
    from ..models import mfcc as mfcc_model, pitch as pitch_model
    from ..models import plp as plp_model, streaming, trainable
    from ..ops import post
    from ..ops.kernels import routes
    from ..utils import batch as batch_lib

    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=world, rank=rank)
    dp, sp, tp = mesh_lib.split(world)
    mesh = mesh_lib.make_mesh((dp, sp, tp), (DATA_AXIS, TIME_AXIS, FEAT_AXIS))
    # the ranks share the host's cores: oversubscribed intra-op threads
    # made a tiny sharded step on the CPU 100x slower than one process's
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = backend.require_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    mods = _kernel_modules()
    launches = {}

    def counted(step, fn):
        for m in mods.values():
            m.LAUNCHES = 0
        out = fn()
        _sync(dev)
        launches[step] = {k: m.LAUNCHES for k, m in mods.items()}
        return out

    tiny = FeatureConfig(**TINY).validate()
    cfg = tiny if config == "tiny" else FeatureConfig().validate()
    rng = np.random.default_rng(1)
    Bt, Nt = 2 * dp, 2000                 # the reference's tiny batch
    audio_t = rng.standard_normal((Bt, Nt)).astype(np.float32)
    B = batch or Bt
    N = int(round(seconds * cfg.sample_rate))
    audio = (audio_t if (config, B, N) == ("tiny", Bt, Nt)
             else bench_signal(B, N, cfg.sample_rate))
    x = torch.from_numpy(audio).to(dev)
    lens = torch.full((B,), N, dtype=torch.int32, device=dev)
    xt = torch.from_numpy(audio_t).to(dev)
    lt = torch.full((Bt,), Nt, dtype=torch.int32, device=dev)
    rows, rows_t = mesh.block(B, DATA_AXIS), mesh.block(Bt, DATA_AXIS)
    T = cfg.num_frames(N)
    tb = mesh.block(T, TIME_AXIS)
    dt_group = mesh.group(DATA_AXIS, TIME_AXIS)

    # --- inference: dp over rows, sp over frames, CMVN summed over both
    raw, flens, mask = counted("mfcc", lambda: mfcc_model.mfcc_batch(
        x[rows], lens[rows], cfg))
    stats = cmvn.batch_stats_psum(raw[:, tb], mask[:, tb], dt_group)
    feat = cmvn.apply(raw, stats)          # this rank's rows, every frame
    assert feat.shape == (rows.stop - rows.start, T, cfg.n_mfcc)
    assert float(stats.count) > 0 and bool(torch.isfinite(feat).all())
    raw1, _, mask1 = mfcc_model.mfcc_batch(x, lens, cfg)
    feat1 = cmvn.apply(raw1, cmvn.batch_stats(raw1, mask1))
    shard_err = _world_max(_max_err(raw[:, tb], raw1[rows, tb]))
    cmvn_err = _world_max(_max_err(feat[:, tb], feat1[rows, tb]))
    assert shard_err < RAW_TOL, f"sharded-vs-unsharded parity: {shard_err}"
    assert cmvn_err < CMVN_TOL, \
        f"sharded-vs-unsharded CMVN parity: {cmvn_err}"
    # the statistics' step as it ran, and on host copies of its shard
    shard = (raw[:, tb], mask[:, tb])
    stats_ms = _time_ms(lambda: cmvn.batch_stats_psum(*shard, dt_group), dev)
    host = [t.cpu() for t in shard]
    stats_host_ms = _time_ms(lambda: cmvn.batch_stats_psum(*host, dt_group),
                             torch.device("cpu"))

    # --- the kernel route under dp (fused_raw_dit on the card)
    kcfg = FeatureConfig(sample_rate=2000, frame_ms=40, hop_ms=16,
                         n_fft=128, n_mels=8, n_mfcc=4).validate()
    assert routes.spectral_route(kcfg, True) == "fused_raw_dit"
    kf = counted("kernel route", lambda: mfcc_model.mfcc_batch(
        xt[rows_t], lt[rows_t], kcfg)[0])
    assert kf.shape == (rows_t.stop - rows_t.start, kcfg.num_frames(Nt),
                        kcfg.n_mfcc)
    kf1 = mfcc_model.mfcc_batch(xt, lt, kcfg)[0]
    kerr = _world_max(_max_err(kf, kf1[rows_t]))
    assert kerr < KERNEL_TOL, f"kernel-route sharded parity: {kerr}"

    # --- a split-packed batch under dp, utterance starts vs standalone
    plens = [Nt, (2 * Nt) // 3, Nt // 2, Nt // 3] * (Bt // 4 or 1)
    infos = [(i, plens[i % len(plens)]) for i in range(2 * Bt)]
    prow = list(batch_lib.pack_rows_split(
        infos, capacity=Nt, hop=tiny.hop_len, frame_len=tiny.frame_len))[:Bt]
    S = max(len(r.segments) for r in prow)
    xp = np.zeros((Bt, Nt), np.float32)
    pst = np.zeros((Bt, S), np.int32)
    pln = np.zeros((Bt, S), np.int32)
    psigs = {i: rng.standard_normal(plens[i % len(plens)]).astype(
        np.float32) for i in range(2 * Bt)}
    for b, row in enumerate(prow):
        sig, st, ln, _ = batch_lib.pack_audio_split(row, psigs.__getitem__)
        xp[b], pst[b, : len(st)], pln[b, : len(ln)] = sig, st, ln
    pf, pf0, pfc, _ = counted("packed", lambda: mfcc_model.mfcc_batch_packed(
        torch.from_numpy(xp[rows_t]).to(dev), torch.from_numpy(pst[rows_t]),
        torch.from_numpy(pln[rows_t]), tiny))
    perr, starts = 0.0, 0
    for b, row in enumerate(prow[rows_t]):
        for j, pc in enumerate(row.segments):
            if pc.samp_start:
                continue          # a continuation: its predecessor differs
            want = mfcc_model.mfcc_batch(
                torch.from_numpy(psigs[pc.uid][None, : pc.span]).to(dev),
                torch.tensor([pc.span], device=dev), tiny)[0][0]
            f0, fc = int(pf0[b, j]), int(pfc[b, j])
            perr = max(perr, _max_err(pf[b, f0: f0 + fc], want))
            starts += 1
    perr = _world_max(perr)
    assert _world_max(starts) > 0, "no utterance start checked"
    assert perr < PACKED_TOL, f"packed sharded parity: {perr}"

    # --- centred framing, pitch, PLP and streaming under dp
    ccfg = tiny.replace(frame_mode="center")
    cf, cfl, _ = counted("center", lambda: mfcc_model.mfcc_batch(
        xt[rows_t], lt[rows_t], ccfg))
    assert cf.shape[1] == ccfg.num_frames(Nt)
    assert int(cfl[0]) == ccfg.num_frames(Nt)
    pcfg = PitchConfig(sample_rate=2000, work_rate=2000, min_f0=50.0,
                       max_f0=400.0).validate()
    pf_, pl_, _ = counted("pitch", lambda: pitch_model.pitch_batch(
        xt[rows_t], lt[rows_t], pcfg))
    assert pf_.shape == (rows_t.stop - rows_t.start, pcfg.num_frames(Nt), 3)
    assert int(pl_[0]) == pcfg.num_frames(Nt)
    pl_cfg = tiny.replace(n_bark=8, lpc_order=6).validate()
    plp_f = counted("plp", lambda: plp_model.plp_batch(
        xt[rows_t], lt[rows_t], pl_cfg)[0])
    assert plp_f.shape == (rows_t.stop - rows_t.start,
                           pl_cfg.num_frames(Nt), pl_cfg.n_mfcc)
    K, chunk_frames = 3, 8
    C = chunk_frames * tiny.hop_len
    chunks = torch.from_numpy(rng.standard_normal((Bt, K, C)).astype(
        np.float32)).to(dev)
    sstate = streaming.init_state_batch(rows_t.stop - rows_t.start, tiny,
                                        device=dev)
    _, sfeats, _ = counted("streaming", lambda: streaming.process_chunks_batch(
        sstate, chunks[rows_t], tiny))
    assert sfeats.shape == (rows_t.stop - rows_t.start, K, chunk_frames,
                            tiny.n_mfcc)

    # --- the post trio + online CMVN on this rank's normalized rows
    spliced, vad = counted("post", lambda: (
        post.sliding_cmvn(feat, flens, 21),
        post.splice(post.online_cmvn(feat, flens, 15,
                                     normalize_variance=True), flens, 2, 2),
        post.energy_vad(feat[..., 0], flens, context=2))[1:])
    assert spliced.shape == (rows.stop - rows.start, T, 5 * cfg.n_mfcc)
    assert vad.dtype == torch.bool

    # --- the training step: dp x sp x tp against one process
    target = torch.from_numpy(rng.standard_normal(
        (B, T, cfg.n_mfcc)).astype(np.float32)).to(dev)
    params = trainable.shard_params(trainable.init_params(cfg, dev), mesh)
    opt = trainable.make_optimizer(params, LR)
    loss = counted("trainable", lambda: trainable.train_step(
        params, opt, x[rows], target[rows], cfg, mesh))
    assert np.isfinite(float(loss)), float(loss)
    ref = trainable.init_params(cfg, dev)
    opt_ref = trainable.make_optimizer(ref, LR)
    loss_ref = trainable.train_step(ref, opt_ref, x, target, cfg)
    cols = mesh.block(cfg.n_mels, FEAT_AXIS)
    mine = (params.mel_w, params.log_floor)
    # one process's value and clipped gradient of this rank's columns
    theirs = ((ref.mel_w.detach()[:, cols], ref.mel_w.grad[:, cols]),
              (ref.log_floor.detach()[cols], ref.log_floor.grad[cols]))
    g_scale = max(float(p.grad.abs().max()) for p in ref.parameters())
    loss_err = _world_max(abs(float(loss) - float(loss_ref))
                          / abs(float(loss_ref)))
    grad_err = _world_max(max(_max_err(p.grad, g) for p, (_, g) in zip(
        mine, theirs)) / g_scale)
    # the bound is taken at the parameters before the step: init values
    init = trainable.shard_params(trainable.init_params(cfg, dev), mesh)
    step_ratio = _world_max(max(float(((p.detach() - v).abs() / (
        adam_step_bound(p.grad, g, q))).max()) for p, (v, g), q in zip(
        mine, theirs, (init.mel_w.detach(), init.log_floor.detach()))))
    assert loss_err <= LOSS_RTOL, f"sharded loss vs one process: {loss_err}"
    assert grad_err <= GRAD_TOL, f"sharded gradients vs one process: " \
                                 f"{grad_err}"
    assert step_ratio <= 1.0, f"parameters past Adam's bound: {step_ratio}"
    logmel = torch.zeros((rows.stop - rows.start, tb.stop - tb.start,
                          cols.stop - cols.start), device=dev)
    gather_ms = _time_ms(lambda: dist.all_gather_cat(
        logmel, -1, mesh.group(FEAT_AXIS)), dev)
    step_ms = _time_ms(lambda: trainable.train_step(
        params, opt, x[rows], target[rows], cfg, mesh), dev)
    one_ms = None
    tdist.barrier()
    if rank == 0:     # one process on the whole batch, the others waiting
        one_ms = _time_ms(lambda: trainable.train_step(
            ref, opt_ref, x, target, cfg), dev)
    tdist.barrier()

    assert "jax" not in sys.modules and "mfcc_tpu" not in sys.modules
    out = {"rank": rank, "mesh": {"dp": dp, "sp": sp, "tp": tp},
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "feat_shape": [B, T, cfg.n_mfcc], "loss": float(loss),
           "raw_err": shard_err, "cmvn_err": cmvn_err, "kernel_err": kerr,
           "packed_err": perr, "loss_rel_err": loss_err,
           "grad_rel_err": grad_err, "adam_bound_ratio": step_ratio,
           "launches": launches,
           "ms": {"stats_all_reduce": stats_ms,
                  "stats_all_reduce_host": stats_host_ms,
                  "feat_all_gather": gather_ms,
                  "train_step_sharded": step_ms,
                  "train_step_one_process": one_ms}}
    out["summary"] = (
        f"dryrun_multichip OK: mesh dp={dp} sp={sp} tp={tp}, feat "
        f"{tuple(out['feat_shape'])}, loss {float(loss):.4f}, "
        f"sharded-vs-unsharded max|err| raw {shard_err:.2e} / cmvn "
        f"{cmvn_err:.2e} / kernel-route {kerr:.2e} / packed {perr:.2e}, "
        f"models: mfcc mfcc-kernel packed center pitch plp streaming post "
        f"trainable")
    dist.finalize()
    return out


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _tail(path: str, n: int = 4000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def run_ranks(cmds: list, logs: list, env: dict, timeout: float) -> None:
    """Run one command a rank, each logging to its file, until all exit 0.
    A rank that exits otherwise, or the timeout, raises; every process
    still running is then killed (a rank's peers would wait on it)."""
    procs = []
    try:
        for cmd, log in zip(cmds, logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(cmd, stdout=f,
                                              stderr=subprocess.STDOUT,
                                              env=env))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            for r, c in enumerate(codes):
                if c not in (None, 0):
                    raise RuntimeError(f"rank {r} exited with code {c}:\n"
                                       f"{_tail(logs[r])}")
            if all(c == 0 for c in codes):
                return
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s:"
                                   f"\n{_tail(logs[0])}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def dryrun_multichip(n_processes: int = 8, device: str = "cuda",
                     config: str = "tiny", batch: int | None = None,
                     seconds: float = 1.0, timeout: float = 900.0) -> dict:
    """Run the dry run in n_processes gloo processes (module docstring) ->
    rank 0's results, with ``launches`` every rank's (a list by rank).
    ``device="cuda"`` raises without a card."""
    from .. import backend
    if config not in ("tiny", "default"):
        raise ValueError(f"config must be 'tiny' or 'default', got "
                         f"{config!r}")
    backend.require_device(device)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (PACKAGE_PARENT, os.environ.get("PYTHONPATH")) if p))
    with tempfile.TemporaryDirectory(prefix="mfcc_dryrun_") as d:
        cmds = [[sys.executable, "-m", MODULE, str(n_processes), "--rank",
                 str(r), "--port", str(port), "--result-dir", d, "--device",
                 device, "--config", config, "--seconds", str(seconds)]
                + (["--batch", str(batch)] if batch else [])
                for r in range(n_processes)]
        logs = [os.path.join(d, f"rank{r}.log") for r in range(n_processes)]
        run_ranks(cmds, logs, env, timeout)
        results = []
        for r in range(n_processes):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                results.append(json.load(f))
    return {**results[0], "launches": [res["launches"] for res in results]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m " + MODULE,
        description="the distributed dry run over N gloo processes")
    ap.add_argument("n", type=int, nargs="?", default=8,
                    help="processes (default 8: dp 2 x sp 2 x tp 2)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--config", default="tiny", choices=("tiny", "default"))
    ap.add_argument("--batch", type=int, default=None,
                    help="rows of the main batch (default 2 dp)")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--result-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is None:
        try:
            res = dryrun_multichip(args.n, args.device, args.config,
                                   args.batch, args.seconds)
        except RuntimeError as e:
            print(f"dryrun: {e}", file=sys.stderr)
            return 1
        print(res["summary"], flush=True)
        return 0
    res = run_rank(args.rank, args.n, args.port, args.device, args.config,
                   args.batch, args.seconds)
    with open(os.path.join(args.result_dir, f"rank{args.rank}.json"),
              "w") as f:
        json.dump(res, f)
    if args.rank == 0:
        print(res["summary"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
