"""Meshes of rank processes (the JAX package's ``launch/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` over devices and runs each
expert-parallel schedule's body under ``shard_map``, which hands every
device its block of the global arrays.  The port is SPMD over
``torch.distributed`` ranks instead: every rank process runs the same
program on its own block, and a ``Mesh`` is that rank's view of the
layout: the axis names, their sizes, this rank's coordinate on each axis,
and one process group per axis (the ranks that differ from this one along
that axis alone).  Ranks are numbered row-major over the axes, the last
axis fastest, as ``jax.make_mesh`` lays devices out.

The rank layout of the expert-parallel path (``core/expert_parallel.py``):
each rank holds its batch shard over the data axes, the replicated
attention, norms, router, embedding and head, and its own rows of every
expert stack (the paper's P-*-D layout).

Why a class of its own over ``dist.new_group`` and not ``DeviceMesh``:
``init_device_mesh("cuda", ...)`` binds NCCL with one device per rank, and
a machine with one GPU runs several ranks on that one device, which NCCL
refuses ("Duplicate GPU detected", seen on an H100 with torch 2.11).  So
the ranks meet over gloo, the only backend here.  Gloo's collectives are
documented for CPU tensors, and on that card a CUDA tensor handed to one
behaved inconsistently: one probe aborted every rank, another ran and
summed right.  So ``core/collectives.py`` stages every CUDA operand
through a pinned host buffer.  That choice is made by the tensor's device,
never by catching an error, and it moves only the collective's operand:
the kernels and the rest of the compute stay on the card.  A backend
choice (NCCL over one card per rank) belongs with the meshes that have
several cards to run it on.

Rank processes meet through a ``FileStore`` (``init_ranks``), never a
fixed TCP port, so concurrent test workers cannot collide.

``make_meta_mesh`` is a mesh with no process group: one rank's view of a
mesh of any size (the production (16, 16) or (2, 16, 16) included), on
which every collective takes meta tensors, returns its result's shape
and counts its bytes without communicating.  It stands in for the JAX
dry-run's 512 placeholder devices: the program is SPMD, so rank 0's
program gives the per-device numbers.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math

import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass
class Mesh:
    """This rank's view of a mesh of ``math.prod(shape)`` ranks.

    ``shape`` and ``coords`` map axis name -> size / this rank's index;
    ``groups`` maps axis name -> the process group along it (None for an
    axis of size 1, whose collectives are identities).  ``bytes`` and
    ``seconds`` are this rank's collective counters (``core/collectives``),
    keyed by kind."""
    axis_names: tuple
    shape: dict
    coords: dict
    groups: dict
    bytes: dict = dataclasses.field(default_factory=dict)
    seconds: dict = dataclasses.field(default_factory=dict)
    meta: bool = False             # no process group: meta tensors only

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def rank_at(self, axis: str, index: int) -> int:
        """The global rank that differs from this one only in its ``axis``
        coordinate, which is ``index``."""
        coords = dict(self.coords, **{axis: index})
        rank = 0
        for a in self.axis_names:
            rank = rank * self.shape[a] + coords[a]
        return rank

    def reset_counters(self) -> None:
        self.bytes.clear()
        self.seconds.clear()


def init_ranks(rank: int, world: int, store_path: str,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join ``world`` rank processes through a file store at
    ``store_path`` (a path in a directory every rank can reach), over
    gloo."""
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world, timeout=timeout)


def make_mesh(shape: tuple, axes: tuple) -> Mesh:
    """This rank's view of a mesh of ``shape`` over the initialised process
    group, whose world size must be ``prod(shape)``.  Every rank creates
    every axis group in the same order, as ``dist.new_group`` requires."""
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                         f"{math.prod(shape)} ranks, the world has {world}")
    rank = dist.get_rank()
    coords = _coords(rank, tuple(axes), tuple(shape))
    sizes = dict(zip(axes, shape))
    groups = {}
    for i, a in enumerate(axes):
        if sizes[a] == 1:
            groups[a] = None
            continue
        others = [range(n) for j, n in enumerate(shape) if j != i]
        for fixed in itertools.product(*others):
            line = []
            for k in range(sizes[a]):
                c = list(fixed)
                c.insert(i, k)
                line.append(sum(ci * math.prod(shape[j + 1:])
                                for j, ci in enumerate(c)))
            g = dist.new_group(line)
            if rank in line:
                groups[a] = g
    return Mesh(tuple(axes), sizes, coords, groups)


def _coords(rank: int, axes: tuple, shape: tuple) -> dict:
    coords, rest = {}, rank
    for a, n in reversed(tuple(zip(axes, shape))):
        coords[a] = rest % n
        rest //= n
    return {a: coords[a] for a in axes}


def make_meta_mesh(shape: tuple, axes: tuple, rank: int = 0) -> Mesh:
    """Rank ``rank``'s view of a mesh of ``shape`` with no process group:
    the collectives take meta tensors, count their bytes and move nothing
    (``core/collectives``)."""
    if not 0 <= rank < math.prod(shape):
        raise ValueError(f"rank {rank} is outside a mesh of {shape}")
    sizes = dict(zip(axes, shape))
    # a group stands for every axis of more than one rank; none is called
    groups = {a: (None if n == 1 else "meta") for a, n in sizes.items()}
    return Mesh(tuple(axes), sizes, _coords(rank, tuple(axes), tuple(shape)),
                groups, meta=True)


def production_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(shape, axes) of the production mesh."""
    return (((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else ((16, 16), ("data", "model")))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 ranks; 2x16x16 = 512 ranks multi-pod."""
    return make_mesh(*production_shape(multi_pod))


def make_test_mesh(n_data: int = 2, n_model: int = 4) -> Mesh:
    """A small (data, model) mesh over n_data * n_model rank processes."""
    return make_mesh((n_data, n_model), ("data", "model"))


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def axes_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n
