"""The serving mesh of one rank (port of ``repro.distributed.meshes``'
``tp_mesh`` and ``sp_tp_mesh``): the ranks of the default process group
laid out as a 2-D ``("sp", "tp")`` grid in the reference's row-major
order (ranks that differ only in their tp coordinate are adjacent, so the
per-layer tp all-reduces stay within a row and the sp K/V movement
crosses rows). A tp-only mesh is the grid with one row.

There is no module-global group state: ``serve_mesh`` returns a
``ServeMesh`` that the engine and the model are handed explicitly. Two
backends:

  * ``"nccl"`` — rank r on ``cuda:r``, one card a rank; more ranks than
    cards raise before any collective;
  * ``"gloo"`` — the device the caller names (the CPU, or ranks that share
    one card); on ``cuda`` each collective stages its payload through host
    memory (``comm``).
"""

from __future__ import annotations

import dataclasses
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
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if not dist.is_initialized():
        raise ValueError("a serving mesh is built over an initialised "
                         "default process group (torch.distributed."
                         "init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    need = sp * tp
    if need != world:
        raise ValueError(
            f"sp={sp} x tp={tp} needs {need} devices (one rank each) but "
            f"the process group has {world} ranks")
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

    def groups(rows: list[list[int]]) -> Group:
        # every rank creates every group of the axis, in the same order
        mine = None
        for ranks in rows:
            pg = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                mine = Group(tuple(ranks), ranks.index(rank), pg, backend)
        return mine

    tp_group = groups([[i * tp + j for j in range(tp)] for i in range(sp)])
    sp_group = groups([[i * tp + j for i in range(sp)] for j in range(tp)])
    return ServeMesh(sp, tp, rank, tp_group, sp_group, dev)
