"""Process groups and per-process corpus shards (twin of
``mfcc_tpu/parallel/dist.py``).

The reference runs one process a host: ``jax.distributed`` wires the
processes together and an in-process mesh spans the host's chips.  The
port runs one process a GPU: ``torch.distributed`` wires them, each
process computes on its own card (``cuda:{LOCAL_RANK}``) and reads its own
strided shard of the corpus listing, and the only traffic between
processes is the sum of the float64 CMVN statistics, over gloo.

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
    """Sum float64 CPU tensors over every process, in one all-reduce over
    gloo (the default group where it is gloo, else a gloo group made for
    the call, collectively).  -> new tensors of the same shapes; the input
    unchanged in a world of one process."""
    flat = torch.cat([torch.as_tensor(t, dtype=torch.float64).reshape(-1)
                      for t in tensors])
    if process_count() > 1:
        group = (None if tdist.get_backend() == "gloo"
                 else tdist.new_group(backend="gloo"))
        tdist.all_reduce(flat, op=tdist.ReduceOp.SUM, group=group)
    out, off = [], 0
    for t in tensors:
        n = torch.as_tensor(t).numel()
        out.append(flat[off: off + n].reshape(torch.as_tensor(t).shape))
        off += n
    return out
