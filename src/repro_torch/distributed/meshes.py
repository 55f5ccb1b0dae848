"""The meshes of one rank (port of ``repro.distributed.meshes``): the
ranks of the default process group laid out as a grid of named axes in
the reference's row-major order (the last axis varies fastest, so ranks
that differ only in their last coordinate are adjacent).

  * ``make_mesh(shape, axes)`` — the general mesh (``Mesh``), one
    ``Group`` an axis plus the data axes together (``"pod"`` and
    ``"data"``) and the whole mesh: the training meshes ``("data",
    "model")`` and ``("pod", "data", "model")`` (``launch.mesh``), the
    pipeline's ``("pipe",)``;
  * ``serve_mesh(sp, tp)`` — the serving mesh (``ServeMesh``, port of
    ``tp_mesh`` and ``sp_tp_mesh``): the ``("sp", "tp")`` case, so the
    per-layer tp all-reduces stay within a row and the sp K/V movement
    crosses rows. A tp-only mesh is the grid with one row.

There is no module-global group state: each constructor returns a mesh that
the engine, the model and the train step are handed explicitly. Two
backends:

  * ``"nccl"`` — rank r on ``cuda:r``, one card a rank; more ranks than
    cards raise before any collective;
  * ``"gloo"`` — the device the caller names (the CPU, or ranks that share
    one card); on ``cuda`` each collective stages its payload through host
    memory (``comm``).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass(frozen=True)
class Group:
    """One axis of the mesh as this rank sees it: the global ranks along
    the axis in coordinate order, this rank's index among them, the
    process group (None for an axis of one rank), the backend and the
    counter each collective on it adds to (``collectives``, labelled by
    kind)."""
    ranks: tuple[int, ...]
    index: int
    pg: Any
    backend: str
    counter: Any = None

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    sp: int
    tp: int
    rank: int
    tp_group: Group
    sp_group: Group
    device: torch.device

    @property
    def coord(self) -> tuple[int, int]:
        """This rank's (sp, tp) coordinate."""
        return self.sp_group.index, self.tp_group.index

    @property
    def named_coord(self) -> dict[str, int]:
        return {"sp": self.sp_group.index, "tp": self.tp_group.index}

    @property
    def shape(self) -> dict[str, int]:
        return {"sp": self.sp, "tp": self.tp}

    def counted(self, registry) -> "ServeMesh":
        """The same mesh whose collectives add to ``registry``'s
        ``collectives`` counter (by kind)."""
        c = registry.counter("collectives",
                             "collective calls of the sharded model",
                             labels=("kind",))
        return dataclasses.replace(
            self, tp_group=dataclasses.replace(self.tp_group, counter=c),
            sp_group=dataclasses.replace(self.sp_group, counter=c))


def _checked_world(need: int, what: str, backend: str, device
                   ) -> tuple[int, torch.device]:
    """(this rank, its device) once the default group is known to hold
    ``need`` ranks of ``backend``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if not dist.is_initialized():
        raise ValueError("a mesh is built over an initialised default "
                         "process group (torch.distributed."
                         "init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if need != world:
        raise ValueError(
            f"{what} needs {need} devices (one rank each) but the process "
            f"group has {world} ranks")
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"backend 'nccl' puts rank r on cuda:r, so {world} ranks "
                f"need {world} cards, and {cards} are visible; ranks that "
                f"share a card run backend='gloo'")
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu" if device is None else device)
    if dist.get_backend() != backend:
        raise ValueError(f"the default process group runs "
                         f"{dist.get_backend()!r}, the mesh was asked for "
                         f"{backend!r}")
    return rank, dev


def _axis_group(sizes: tuple[int, ...], names: tuple[str, ...],
                axes: tuple[str, ...], rank: int, backend: str) -> Group:
    """This rank's group along ``axes`` of a row-major grid: the ranks that
    share its coordinates on every other axis, in row-major order over
    ``axes``. Every rank creates every group of the axes, in the same
    order (a process group is made by all ranks together)."""
    rest = [i for i, n in enumerate(names) if n not in axes]
    rows: dict[tuple, list[int]] = {}
    for r, c in enumerate(itertools.product(*map(range, sizes))):
        rows.setdefault(tuple(c[i] for i in rest), []).append(r)
    mine = None
    for ranks in rows.values():
        pg = dist.new_group(ranks) if len(ranks) > 1 else None
        if rank in ranks:
            mine = Group(tuple(ranks), ranks.index(rank), pg, backend)
    return mine


def serve_mesh(sp: int = 1, tp: int = 1, *, backend: str = "gloo",
               device=None) -> ServeMesh:
    """This rank's ``("sp", "tp")`` mesh over the initialised default
    process group, whose world must be ``sp * tp`` ranks. Every rank calls
    this with the same arguments (it creates the axis groups, which every
    rank joins in the same order). ``device`` is the gloo ranks' device
    (default the CPU); nccl puts rank r on ``cuda:r``."""
    if sp < 1 or tp < 1:
        raise ValueError(f"sp/tp mesh needs >= 1 shard per axis, got "
                         f"sp={sp}, tp={tp}")
    rank, dev = _checked_world(sp * tp, f"sp={sp} x tp={tp}", backend,
                               device)
    sizes, names = (sp, tp), ("sp", "tp")
    tp_group = _axis_group(sizes, names, ("tp",), rank, backend)
    sp_group = _axis_group(sizes, names, ("sp",), rank, backend)
    return ServeMesh(sp, tp, rank, tp_group, sp_group, dev)


DATA_AXES = ("pod", "data")


def data_axis_names(mesh) -> tuple[str, ...]:
    """The mesh's data-parallel axes, "pod" before "data"."""
    return tuple(a for a in DATA_AXES if a in mesh.axis_names)


def num_data_shards(mesh) -> int:
    return math.prod(mesh.shape[a] for a in data_axis_names(mesh))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a mesh of named axes: the axes and their sizes,
    this rank, its groups (one an axis, keyed by the axis name; the data
    axes together, keyed by their tuple; the whole mesh, keyed by
    ``axis_names``) and its device."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    rank: int
    groups: dict
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def named_coord(self) -> dict[str, int]:
        """This rank's coordinate on each axis."""
        return {a: self.groups[a].index for a in self.axis_names}

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def group(self, axes) -> Group:
        """The group along one axis (a name), or along the data axes or the
        whole mesh (a tuple of names in mesh order)."""
        if isinstance(axes, tuple) and len(axes) == 1:
            axes = axes[0]
        if axes not in self.groups:
            raise ValueError(f"the mesh {self.shape} has no group along "
                             f"{axes!r}")
        return self.groups[axes]

    @property
    def data(self) -> Group:
        """The data axes together (this rank alone without one)."""
        return self.group(data_axis_names(self) or ())

    @property
    def world(self) -> Group:
        return self.group(self.axis_names)

    def counted(self, registry) -> "Mesh":
        """The same mesh whose collectives add to ``registry``'s
        ``collectives`` counter (by kind)."""
        c = registry.counter("collectives",
                             "collective calls of the sharded model",
                             labels=("kind",))
        return dataclasses.replace(self, groups={
            k: dataclasses.replace(g, counter=c)
            for k, g in self.groups.items()})


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              backend: str = "gloo", device=None) -> Mesh:
    """This rank's mesh of ``axes`` with ``shape`` over the initialised
    default process group, whose world must be the product of the shape
    (the reference's ``jax.make_mesh`` raises there too). Every rank calls
    this with the same arguments. ``device`` is the gloo ranks' device
    (default the CPU); nccl puts rank r on ``cuda:r``."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} must pair "
                         f"one size with each distinct name")
    if any(n < 1 for n in shape):
        raise ValueError(f"mesh shape {shape} needs >= 1 rank per axis")
    rank, dev = _checked_world(math.prod(shape), f"mesh {shape} over {axes}",
                               backend, device)
    groups = {a: _axis_group(shape, axes, (a,), rank, backend) for a in axes}
    data = tuple(a for a in DATA_AXES if a in axes)
    if len(data) > 1:
        groups[data] = _axis_group(shape, axes, data, rank, backend)
    groups[axes] = (groups[axes[0]] if len(axes) == 1 else
                    _axis_group(shape, axes, axes, rank, backend))
    # a mesh without data axes: each rank is its own data group
    groups[()] = Group((rank,), 0, None, backend)
    return Mesh(axes, shape, rank, groups, dev)
