"""The port's distributed pieces (``parallel/mesh``, ``parallel/dist``'s
collectives, ``parallel/cmvn.batch_stats_psum``, the sharded trainable
step) against the JAX package: twins of tests/test_parallel.py, each also
held to the JAX function on the same seeded batch (JAX's
``batch_stats_psum`` on the 8-device CPU mesh of conftest.py, rtol 1e-5),
and gloo processes on the CPU for what needs a world of several.

Tolerances of the trainable step, sharded against one process: the loss
rtol 1e-5 and the clipped gradients 1e-4 of their largest element (float32
sums over the batch and the frames reassociated by the split); the
parameters after the step within ``dryrun.adam_step_bound``: Adam's first
step divides each gradient by its own magnitude + 1e-8, so a gradient
difference moves a parameter by up to lr times the difference over the
smaller magnitude."""

import os
import socket
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as P

from mfcc_tpu import FeatureConfig as JaxConfig, oracle as jax_oracle
from mfcc_tpu.models import mfcc as jax_mfcc, trainable as jax_trainable
from mfcc_tpu.parallel import cmvn as jax_cmvn, dist as jax_dist
from mfcc_tpu.parallel import mesh as jax_mesh
from mfcc_tpu_torch import FeatureConfig
from mfcc_tpu_torch.models import mfcc as mfcc_model, trainable
from mfcc_tpu_torch.parallel import cmvn, dist, dryrun, mesh as mesh_lib
from mfcc_tpu_torch.parallel.mesh import DATA_AXIS, FEAT_AXIS, TIME_AXIS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = FeatureConfig()
TINY = FeatureConfig(**dryrun.TINY).validate()
AXES = (DATA_AXIS, TIME_AXIS, FEAT_AXIS)

# one rank of a gloo world on the CPU: the statistics or the training step
# of its shard, rank 0 saving what the test compares
WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as tdist
rank, world, port, task, d = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4], sys.argv[5])
shape = tuple(int(v) for v in sys.argv[6].split(","))
tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                         world_size=world, rank=rank)
from mfcc_tpu_torch import FeatureConfig
from mfcc_tpu_torch.models import trainable
from mfcc_tpu_torch.parallel import cmvn, dist, dryrun, mesh as mesh_lib
from mfcc_tpu_torch.parallel.mesh import DATA_AXIS, FEAT_AXIS, TIME_AXIS
m = mesh_lib.make_mesh(shape, (DATA_AXIS, TIME_AXIS, FEAT_AXIS))
z = np.load(f"{d}/in.npz")
if task == "stats":
    feat, mask = torch.from_numpy(z["feat"]), torch.from_numpy(z["mask"])
    rows = m.block(feat.shape[0], DATA_AXIS)
    tb = m.block(feat.shape[1], TIME_AXIS)
    s = cmvn.batch_stats_psum(feat[rows][:, tb], mask[rows][:, tb],
                              m.group(DATA_AXIS, TIME_AXIS))
    out = dict(count=s.count.numpy(), sum=s.sum.numpy(),
               sumsq=s.sumsq.numpy())
else:
    cfg = FeatureConfig(**dryrun.TINY).validate()
    audio, target = torch.from_numpy(z["audio"]), torch.from_numpy(z["target"])
    rows = m.block(audio.shape[0], DATA_AXIS)
    p = trainable.shard_params(trainable.init_params(cfg, "cpu"), m)
    opt = trainable.make_optimizer(p, dryrun.LR)
    loss = trainable.train_step(p, opt, audio[rows], target[rows], cfg, m)
    g = m.group(FEAT_AXIS)
    full = trainable.gather_params(p, m)
    out = dict(loss=loss.numpy(),
               g_mel=dist.all_gather_cat(p.mel_w.grad, 1, g).numpy(),
               g_floor=dist.all_gather_cat(p.log_floor.grad, 0, g).numpy(),
               mel_w=full.mel_w.detach().numpy(),
               log_floor=full.log_floor.detach().numpy())
assert "jax" not in sys.modules and "mfcc_tpu" not in sys.modules
if rank == 0:
    np.savez(f"{d}/out.npz", **out)
dist.finalize()
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _world(tmp_path, task, shape, **arrays):
    """Run WORKER in prod(shape) gloo processes -> rank 0's npz."""
    np.savez(tmp_path / "in.npz", **arrays)
    n, port = int(np.prod(shape)), _free_port()
    cmds = [[sys.executable, "-c", WORKER, str(r), str(n), str(port), task,
             str(tmp_path), ",".join(map(str, shape))] for r in range(n)]
    logs = [str(tmp_path / f"rank{r}.log") for r in range(n)]
    dryrun.run_ranks(cmds, logs, dict(os.environ, PYTHONPATH=REPO), 300)
    return np.load(tmp_path / "out.npz")


def _batch(rng, B=8, L=8000):
    xs = rng.standard_normal((B, L)).astype(np.float32) * 0.3
    lens = rng.integers(L // 2, L, B).astype(np.int32)
    for i, n in enumerate(lens):
        xs[i, n:] = 0
    return xs, lens


def _features(rng, B=8):
    xs, lens = _batch(rng, B)
    feat, fl, mask = mfcc_model.mfcc_batch(torch.from_numpy(xs),
                                           torch.from_numpy(lens), CFG)
    return xs, lens, feat, mask


def _jax_psum(feat, mask):
    m = jax_mesh.make_mesh()
    return jax_cmvn.batch_stats_psum(
        jax_mesh.shard_batch(np.asarray(feat), m),
        jax_mesh.shard_batch(np.asarray(mask), m), m)


def _close_to_jax(stats, jstats):
    assert float(stats.count) == float(jstats.count)
    np.testing.assert_allclose(np.asarray(stats.sum), np.asarray(jstats.sum),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(stats.sumsq),
                               np.asarray(jstats.sumsq), rtol=1e-5)


def test_eight_jax_devices_present():
    assert len(jax.devices()) == 8


def test_cmvn_stats_match_oracle(rng):
    xs, lens, feat, mask = _features(rng)
    stats = cmvn.batch_stats(feat, mask)
    feats_np = [jax_oracle.mfcc(xs[i, : lens[i]].astype(np.float64),
                                JaxConfig()) for i in range(len(lens))]
    c, s, sq = jax_oracle.cmvn_stats(feats_np)
    assert int(stats.count) == c
    np.testing.assert_allclose(stats.sum.numpy(), s, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(stats.sumsq.numpy(), sq, rtol=1e-4, atol=1e-2)
    _close_to_jax(stats, _jax_psum(feat, mask))


def test_cmvn_psum_in_one_process_equals_batch_stats(rng):
    _, _, feat, mask = _features(rng)
    one = cmvn.batch_stats(feat, mask)
    psum = cmvn.batch_stats_psum(feat, mask)       # a world of one
    for a, b in zip(one, psum):
        assert torch.equal(a, b)
    _close_to_jax(psum, _jax_psum(feat, mask))


@pytest.mark.parametrize("shape", [(2, 1, 1), (2, 2, 1)])
def test_cmvn_psum_over_processes(tmp_path, rng, shape):
    """Rows over "data", and with (2, 2, 1) frames over "time" too: the
    statistics summed over both axes equal one process's, JAX's psum on
    the same features, and the oracle's."""
    xs, lens, feat, mask = _features(rng)
    got = _world(tmp_path, "stats", shape, feat=feat.numpy(),
                 mask=mask.numpy())
    stats = cmvn.Stats(*(torch.from_numpy(got[k])
                         for k in ("count", "sum", "sumsq")))
    one = cmvn.batch_stats(feat, mask)
    assert float(stats.count) == float(one.count)
    np.testing.assert_allclose(stats.sum.numpy(), one.sum.numpy(), rtol=1e-6)
    np.testing.assert_allclose(stats.sumsq.numpy(), one.sumsq.numpy(),
                               rtol=1e-6)
    _close_to_jax(stats, _jax_psum(feat, mask))
    feats_np = [jax_oracle.mfcc(xs[i, : lens[i]].astype(np.float64),
                                JaxConfig()) for i in range(len(lens))]
    c, s, sq = jax_oracle.cmvn_stats(feats_np)
    assert int(stats.count) == c
    np.testing.assert_allclose(stats.sum.numpy(), s, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(stats.sumsq.numpy(), sq, rtol=1e-4, atol=1e-2)


def test_cmvn_apply_normalizes(rng):
    _, _, feat, mask = _features(rng, B=16)
    normed = cmvn.apply(feat, cmvn.batch_stats(feat, mask))
    sel = normed.numpy()[mask.numpy()]
    np.testing.assert_allclose(sel.mean(axis=0), 0.0, atol=1e-4)
    np.testing.assert_allclose(sel.std(axis=0), 1.0, atol=1e-3)
    # given the same statistics, JAX's apply
    js = _jax_psum(feat, mask)
    want = jax_cmvn.apply(jnp.asarray(feat.numpy()), js)
    got = cmvn.apply(feat, cmvn.Stats(*(torch.from_numpy(np.array(t))
                                        for t in js)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_stats_merge_associative():
    a = cmvn.Stats(torch.tensor(3.0), torch.ones(13), torch.ones(13))
    b = cmvn.Stats(torch.tensor(5.0), 2 * torch.ones(13), 3 * torch.ones(13))
    ab = a.merge(b).merge(cmvn.Stats.zero(13, device="cpu"))
    assert float(ab.count) == 8.0
    np.testing.assert_allclose(ab.sum.numpy(), 3.0)
    ja = jax_cmvn.Stats(jnp.asarray(3.0), jnp.ones(13), jnp.ones(13))
    jb = jax_cmvn.Stats(jnp.asarray(5.0), 2 * jnp.ones(13), 3 * jnp.ones(13))
    jab = ja.merge(jb).merge(jax_cmvn.Stats.zero(13))
    for t, j in zip(ab, jab):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_host_shard_partition():
    items = list(range(103))
    shards = [dist.host_shard(items, i, 4) for i in range(4)]
    assert sorted(x for s in shards for x in s) == items
    assert abs(max(map(len, shards)) - min(map(len, shards))) <= 1
    assert shards == [jax_dist.host_shard(items, i, 4) for i in range(4)]


def test_mesh_two_axis():
    """The rank grid of a (4, 2) ("data", "feat") mesh is the reference's
    device grid: each group the ranks of one row or column."""
    jm = jax_mesh.make_mesh((4, 2), ("data", "feat"))
    assert dict(jm.shape) == {"data": 4, "feat": 2}
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    groups = mesh_lib.axis_groups((4, 2), ("data", "feat"))
    assert sorted(groups[("data",)]) == sorted(ids.T.tolist())
    assert sorted(groups[("feat",)]) == sorted(ids.tolist())
    assert groups[("data", "feat")] == [list(range(8))]
    m = mesh_lib.Mesh({"data": 4, "feat": 2}, rank=5, groups={})
    assert m.coords == {"data": 2, "feat": 1}
    assert m.size("data", "feat", "time") == 8 and m.coord("time") == 0


def test_mesh_in_one_process():
    m = mesh_lib.make_mesh()
    assert m.shape == {"data": 1} and m.rank == 0
    assert m.group(DATA_AXIS) is None
    with pytest.raises(ValueError):
        mesh_lib.make_mesh((2, 1), (DATA_AXIS, FEAT_AXIS))
    with pytest.raises(ValueError):
        m.group(FEAT_AXIS)


@pytest.mark.parametrize("n,size", [(98, 2), (7, 4), (3, 4), (64, 1)])
def test_mesh_block_is_array_split(n, size):
    want = [len(a) for a in np.array_split(np.arange(n), size)]
    got = [mesh_lib.Mesh({"time": size}, rank=r, groups={}).block(n, "time")
           for r in range(size)]
    assert [s.stop - s.start for s in got] == want
    assert got[0].start == 0 and got[-1].stop == n
    assert all(a.stop == b.start for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_split_is_the_reference_rule(n):
    tp = 2 if n % 2 == 0 else 1
    sp = 2 if (n // tp) % 2 == 0 else 1
    assert mesh_lib.split(n) == (n // tp // sp, sp, tp)


def test_collectives_in_one_process():
    a, b = torch.arange(6.0).reshape(2, 3), torch.tensor(7.0)
    ra, rb = dist.all_reduce_sum([a, b])
    assert torch.equal(ra, a) and torch.equal(rb, b)
    assert ra.data_ptr() != a.data_ptr()
    x = torch.randn(3, 4, requires_grad=True)
    y = dist.all_gather_cat(x, -1)
    (y * torch.arange(4.0)).sum().backward()
    assert torch.equal(y, x) and torch.equal(x.grad,
                                             torch.arange(4.0).expand(3, 4))


def test_shard_params_from_jax():
    """params_from_jax then shard_params: each feat rank's columns of the
    JAX front end; gather_params in a world of one is the identity; an
    uneven split raises as the reference's NamedSharding does."""
    jp = jax_trainable.init_params(JaxConfig(n_mels=26))
    full = trainable.params_from_jax(jp, device="cpu")
    for r in range(2):
        m = mesh_lib.Mesh({"data": 1, "time": 1, "feat": 2}, rank=r,
                          groups={})
        p = trainable.shard_params(full, m)
        cols = slice(13 * r, 13 * (r + 1))
        np.testing.assert_array_equal(p.mel_w.detach().numpy(),
                                      np.asarray(jp.mel_w)[:, cols])
        np.testing.assert_array_equal(p.log_floor.detach().numpy(),
                                      np.asarray(jp.log_floor)[cols])
    one = mesh_lib.make_mesh((1, 1, 1), AXES)
    back = trainable.gather_params(trainable.shard_params(full, one), one)
    assert torch.equal(back.mel_w, full.mel_w)
    with pytest.raises(ValueError):
        trainable.shard_params(full, mesh_lib.Mesh({"feat": 4}, 0, {}))
    with pytest.raises(ValueError):    # the reference refuses it too
        jax.device_put(jp.mel_w, NamedSharding(JaxMesh(
            np.asarray(jax.devices()[:4]), ("feat",)), P(None, "feat")))


def _jax_sharded_step(shape, audio, target):
    """JAX's train_step under param_shardings on a (dp, sp, tp) mesh of the
    fake devices -> (loss, clipped grads, params after the step)."""
    jcfg = JaxConfig(**dryrun.TINY).validate()
    n = int(np.prod(shape))
    mesh = JaxMesh(np.asarray(jax.devices()[:n]).reshape(shape),
                   ("data", "time", "feat"))
    params = jax.tree.map(jax.device_put, jax_trainable.init_params(jcfg),
                          jax_trainable.param_shardings(mesh))
    data = NamedSharding(mesh, P("data"))
    a = jax.device_put(jnp.asarray(audio), data)
    t = jax.device_put(jnp.asarray(target), data)
    grads = jax.jit(jax.grad(jax_trainable.loss_fn), static_argnums=3)(
        params, a, t, jcfg)
    clipped, _ = optax.clip_by_global_norm(1.0).update(grads, None)
    opt = jax_trainable.make_optimizer(dryrun.LR)
    new, _, loss = jax_trainable.train_step(params, opt.init(params), a, t,
                                            jcfg, opt)
    return float(loss), clipped, new


@pytest.mark.parametrize("shape", [(2, 1, 2), (1, 2, 2)])
def test_sharded_train_step_over_processes(tmp_path, rng, shape):
    """The dp x tp (and sp x tp) step on 4 gloo processes against the
    port's one-process step and JAX's step under param_shardings."""
    B, N = 4, 2000
    audio = (rng.standard_normal((B, N)) * 0.3).astype(np.float32)
    target = rng.standard_normal(
        (B, TINY.num_frames(N), TINY.n_mfcc)).astype(np.float32)
    got = _world(tmp_path, "train", shape, audio=audio, target=target)
    init = trainable.init_params(TINY, "cpu")
    ref = trainable.init_params(TINY, "cpu")
    opt = trainable.make_optimizer(ref, dryrun.LR)
    loss = trainable.train_step(ref, opt, torch.from_numpy(audio),
                                torch.from_numpy(target), TINY)
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5)
    g_ref = [ref.mel_w.grad, ref.log_floor.grad]
    g_got = [torch.from_numpy(got["g_mel"]), torch.from_numpy(got["g_floor"])]
    scale = max(float(g.abs().max()) for g in g_ref)
    for a, b in zip(g_got, g_ref):
        assert float((a - b).abs().max()) <= 1e-4 * scale
    p_got = [torch.from_numpy(got["mel_w"]), torch.from_numpy(got["log_floor"])]
    for p, r, ga, gb, q in zip(p_got, [ref.mel_w, ref.log_floor], g_got,
                               g_ref, [init.mel_w, init.log_floor]):
        bound = dryrun.adam_step_bound(ga, gb, q.detach())
        assert bool(((p - r.detach()).abs() <= bound).all())
    # JAX's sharded step on the same batch
    jloss, jgrads, jnew = _jax_sharded_step(shape, audio, target)
    np.testing.assert_allclose(float(got["loss"]), jloss, rtol=1e-5)
    jg = [torch.from_numpy(np.array(jgrads.mel_w)),
          torch.from_numpy(np.array(jgrads.log_floor))]
    for a, b in zip(g_got, jg):
        assert float((a - b).abs().max()) <= 1e-4 * scale
    for p, j, ga, gb, q in zip(p_got, [jnew.mel_w, jnew.log_floor], g_got,
                               jg, [init.mel_w, init.log_floor]):
        # optax takes Adam's bias corrections in float32: 1 - f32(0.999)
        # is 1.3e-5 off 1 - 0.999, so its first update is 6.4e-6 longer
        bound = dryrun.adam_step_bound(ga, gb, q.detach(), rel=1e-5)
        assert bool(((p - torch.from_numpy(np.array(j))).abs()
                     <= bound).all())


def test_adam_step_bound_holds_for_torch_adam():
    """One torch Adam step from equal parameters with two gradients that
    differ a little (and some that flip sign near zero) stays within the
    bound."""
    g = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    g[:50] *= 1e-8
    g_b = g + 1e-6 * torch.randn(1000, generator=torch.Generator()
                                 .manual_seed(1))
    p0 = torch.rand(1000, generator=torch.Generator().manual_seed(2))
    out = []
    for grad in (g, g_b):
        p = torch.nn.Parameter(p0.clone())
        opt = torch.optim.Adam([p], lr=dryrun.LR, eps=1e-8)
        p.grad = grad.clone()
        opt.step()
        out.append(p.detach())
    bound = dryrun.adam_step_bound(g, g_b, p0)
    assert bool(((out[0] - out[1]).abs() <= bound).all())
    assert float((out[0] - out[1]).abs().max()) > 1e-4 * dryrun.LR
