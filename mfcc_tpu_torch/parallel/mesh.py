"""Process meshes: the ranks of a ``torch.distributed`` world laid out as a
grid of named axes (the process-group counterpart of
``mfcc_tpu/parallel/mesh.py``).

The reference lays its devices out as a grid inside one process and lets
XLA's partitioner insert the collectives.  The port runs one process a GPU
(``parallel/dist``), so the grid is one of ranks: ``make_mesh((dp, sp,
tp), (DATA_AXIS, TIME_AXIS, FEAT_AXIS))`` gives each rank the coordinates
of its rank in row-major order and, for every set of axes, the gloo group
of the ranks that differ from it along those axes only.  A collective then
names the axes it reduces over (``mesh.group(DATA_AXIS, TIME_AXIS)``).
A mesh holds no devices: each process computes on its own card, or on the
device it is given.

Axis convention (the reference's, and the time axis of its dry run):

- ``data`` — the utterance batch: each rank computes its rows.
- ``time`` — frames of the feature tensor: each rank a contiguous range.
- ``feat`` — filterbank columns of the trainable front end (tensor
  parallelism; ``models/trainable.shard_params``).

An axis a mesh does not name has size 1 there, so code written for the
three axes runs on a mesh with fewer.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch.distributed as tdist

DATA_AXIS = "data"
TIME_AXIS = "time"
FEAT_AXIS = "feat"


def split(n: int) -> tuple[int, int, int]:
    """Factor n ranks into (dp, sp, tp), the largest share to dp (the
    reference dry run's rule, ``__graft_entry__.py:76-80``)."""
    tp = 2 if n % 2 == 0 else 1
    rest = n // tp
    sp = 2 if rest % 2 == 0 else 1
    return rest // sp, sp, tp


def axis_groups(shape: tuple[int, ...], axis_names: tuple[str, ...]) -> dict:
    """{axes: [ranks of each group]} for every non-empty set of axes (as a
    tuple in mesh order): the ranks that share their coordinates on the
    other axes, ascending, so a group's rank order is its axes' row-major
    order."""
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    out = {}
    for k in range(1, len(shape) + 1):
        for axes in itertools.combinations(range(len(shape)), k):
            rest = [a for a in range(len(shape)) if a not in axes]
            g = grid.transpose(*rest, *axes).reshape(-1, int(
                np.prod([shape[a] for a in axes])))
            out[tuple(axis_names[a] for a in axes)] = g.tolist()
    return out


class Mesh:
    """This rank's place in a grid of ranks: ``shape`` {axis: size},
    ``coords`` {axis: index} and the process group of each set of axes."""

    def __init__(self, shape: dict, rank: int, groups: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.rank = rank
        idx = np.unravel_index(rank, tuple(shape.values()))
        self.coords = {a: int(i) for a, i in zip(self.axis_names, idx)}
        self._groups = groups

    def size(self, *axes: str) -> int:
        """Ranks along these axes (an axis the mesh lacks counts 1)."""
        return int(np.prod([self.shape.get(a, 1) for a in axes]))

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, *axes: str):
        """The process group of the ranks that differ from this one along
        ``axes`` only (axes the mesh lacks are left out).  None in a world
        of one process, where every collective is the identity."""
        named = tuple(a for a in self.axis_names if a in axes)
        if not named:
            raise ValueError(f"no axis of {self.axis_names} in {axes}")
        return self._groups.get(named)

    def block(self, n: int, axis: str) -> slice:
        """This rank's contiguous share of n items along ``axis``: blocks of
        n // size, the first n % size one longer (numpy's array_split)."""
        size, c = self.size(axis), self.coord(axis)
        q, r = divmod(n, size)
        start = c * q + min(c, r)
        return slice(start, start + q + (c < r))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def make_mesh(shape: tuple[int, ...] | None = None,
              axis_names: tuple[str, ...] = (DATA_AXIS,)) -> Mesh:
    """Lay this process's world out as a mesh.

    Default: one axis over every rank, named "data".  The world is the
    default process group (``parallel/dist.initialize``); with none, a
    world of one process.  Every rank must call this, in the same order
    relative to its other collectives: one gloo group is made for each row
    of every set of axes (``tdist.new_subgroups_by_enumeration``, which
    each rank calls for all rows), the whole world's being the default
    group.
    """
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    rank = tdist.get_rank() if tdist.is_initialized() else 0
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(shape):
        raise ValueError(f"shape {shape} and axis names {axis_names} "
                         "must pair up, names distinct")
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {tuple(shape)} != {world} processes")
    groups = {}
    if world > 1:
        for axes, rows in axis_groups(tuple(shape), axis_names).items():
            if len(rows) == 1:
                groups[axes] = tdist.group.WORLD
            else:
                groups[axes], _ = tdist.new_subgroups_by_enumeration(
                    rows, backend="gloo")
    return Mesh(dict(zip(axis_names, shape)), rank, groups)
