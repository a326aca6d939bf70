"""Process groups and per-process corpus shards (twin of
``mfcc_tpu/parallel/dist.py``).

The reference runs one process a host: ``jax.distributed`` wires the
processes together and an in-process mesh spans the host's chips.  The
port runs one process a GPU: ``torch.distributed`` wires them, each
process computes on its own card (``cuda:{LOCAL_RANK}``) and reads its own
strided shard of the corpus listing, and the only traffic between
processes is the sum of the float64 CMVN statistics, over gloo.

The distributed step (``parallel/mesh``, ``parallel/dryrun``) adds two
collectives over a group of a mesh: :func:`all_reduce_sum` (CMVN
statistics, gradients, the loss) and :func:`all_gather_cat` (the trainable
front end's filterbank columns).  Only gloo is used, and only its
all-reduce and all-gather: NCCL needs a card a rank, and several ranks
share one card here.

Rank and world size come from the environment as ``torchrun`` sets them
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), or from :func:`initialize`'s arguments.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as tdist


def initialize(init_method: str | None = None,
               world_size: int | None = None,
               rank: int | None = None) -> None:
    """Initialize the default process group on gloo.  A no-op for a world
    of one process, or where a group already exists."""
    ws = (int(os.environ.get("WORLD_SIZE", "1")) if world_size is None
          else world_size)
    if ws <= 1 or tdist.is_initialized():
        return
    rk = int(os.environ["RANK"]) if rank is None else rank
    tdist.init_process_group("gloo", init_method=init_method or "env://",
                             world_size=ws, rank=rk)


def finalize() -> None:
    """Leave the default process group: a barrier, then destroy it (a no-op
    without one).  A rank that tore its gloo connections down while a peer
    still held them aborted at exit ("terminate called without an active
    exception": one 4-rank world in ~15 on a loaded CPU host); the barrier
    keeps every rank in until all are done."""
    if tdist.is_initialized():
        tdist.barrier()
        tdist.destroy_process_group()


def process_index() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


_rank, _world = process_index, process_count   # unshadowed by host_shard


def local_device_index() -> int:
    """The card this process computes on: ``LOCAL_RANK`` where the launcher
    sets it, else the rank modulo the cards visible."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_index() % max(torch.cuda.device_count(), 1)


def host_shard(items: list, process_index: int | None = None,
               process_count: int | None = None) -> list:
    """Deterministic per-process shard of a corpus listing (strided split,
    balancing utterance order across processes)."""
    pi = _rank() if process_index is None else process_index
    pc = _world() if process_count is None else process_count
    return items[pi::pc]


def is_coordinator() -> bool:
    return process_index() == 0


def all_reduce_sum_f64(tensors) -> list:
    """Sum float64 CPU tensors (or what converts to them) over every
    process, in one all-reduce over gloo (the default group where it is
    gloo, else a gloo group made for the call, collectively).  -> new
    tensors of the same shapes; the input unchanged in a world of one
    process."""
    group = (None if process_count() == 1 or tdist.get_backend() == "gloo"
             else tdist.new_group(backend="gloo"))
    return all_reduce_sum([torch.as_tensor(t, dtype=torch.float64)
                           for t in tensors], group)


def _group_size(group) -> int:
    return tdist.get_world_size(group) if tdist.is_initialized() else 1


def all_reduce_sum(tensors, group=None) -> list:
    """Sum tensors of one dtype and device over the processes of ``group``
    (default: every process) in one flat all-reduce -> new tensors of the
    same shapes; the inputs unchanged in a group of one.  CUDA tensors go
    to gloo as they are: its all-reduce takes them (it stages through host
    memory itself)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if _group_size(group) > 1:
        tdist.all_reduce(flat, op=tdist.ReduceOp.SUM, group=group)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off: off + t.numel()].reshape(t.shape))
        off += t.numel()
    return out


class _AllGatherCat(torch.autograd.Function):
    """Forward: the group's shards concatenated along ``dim`` in group-rank
    order.  Backward: this rank's slice of the incoming gradient, with no
    reduction: every rank of the group computes the same loss from the
    gathered tensor, so the slice is the whole gradient of its shard (a
    reduce-scatter would count it once per rank)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        n = _group_size(group)
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.index = tdist.get_rank(group) if n > 1 else 0
        if n == 1:
            return x.clone()
        if x.is_cuda:   # gloo's all-gather takes no CUDA tensor: stage it
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x)
        else:
            host = x.contiguous()
        parts = [torch.empty_like(host) for _ in range(n)]
        tdist.all_gather(parts, host, group=group)
        return torch.cat(parts, dim=dim).to(x.device)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


def all_gather_cat(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The shards of ``group`` (default: every process) concatenated along
    ``dim`` in group-rank order, differentiable (:class:`_AllGatherCat`).
    Every shard has the same shape.  A CUDA tensor is staged through pinned
    host memory on every call (gloo's all-gather takes CPU tensors only),
    and the result copied back to its card."""
    return _AllGatherCat.apply(x, dim % x.dim(), group)
