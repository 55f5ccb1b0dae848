"""The collectives of the sharded serving model (the counterparts of the
``psum``, tiled ``all_gather`` and ``ppermute`` that the reference's
``shard_map`` bodies trace), each on one axis ``Group`` of a
``ServeMesh``:

  * ``all_reduce_sum`` — the tp projection boundaries (attention ``wo``,
    MLP ``w_down``), summed in the payload's dtype;
  * ``all_gather`` — an sp chunk's K/V slabs, concatenated in slab order;
  * ``ring_shift`` — one ``batch_isend_irecv`` step, each rank sending to
    its right neighbour ``(i + 1) % n`` and receiving from its left.

Each call adds one to the group's ``collectives`` counter under its kind
(``all_reduce``, ``all_gather``, ``ring_shift``): that counter is the
port's census of a step. A call on an axis of one rank returns its input
unsent (the sum, gather or shift over one rank is the identity), and is
counted all the same, as the reference's trace counts a ``psum`` over an
axis of size 1. With backend ``gloo`` a CUDA payload is copied to host
memory, sent, and copied back: that is how gloo carries it (several ranks
on one card), not a fallback after a failure; nothing here catches a
failed collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.meshes import Group


def _count(group: Group, kind: str) -> None:
    if group.counter is not None:
        group.counter.inc(kind=kind)


def _staged(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The buffer the backend sends: host memory under gloo, else x."""
    if group.backend == "gloo" and x.is_cuda:
        return x.to("cpu")
    return x.contiguous()


def all_reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of every rank's ``x`` over the group, in x's dtype, on x's
    device. Every rank of the group receives the same bits. May reuse x's
    storage."""
    _count(group, "all_reduce")
    if group.size == 1:
        return x
    buf = _staged(x, group)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group.pg)
    return buf.to(x.device)


def all_gather(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in the group's rank
    order (an sp slab's order in the packed chunk)."""
    _count(group, "all_gather")
    if group.size == 1:
        return x
    buf = _staged(x, group)
    parts = [torch.empty_like(buf) for _ in range(group.size)]
    dist.all_gather(parts, buf, group=group.pg)
    return torch.cat(parts, dim=dim).to(x.device)


def ring_shift(x: torch.Tensor, group: Group) -> torch.Tensor:
    """One ring step: send ``x`` to the next rank of the group, return what
    the previous one sent (same shape and dtype)."""
    _count(group, "ring_shift")
    n = group.size
    if n == 1:
        return x
    buf = _staged(x, group)
    recv = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf, group.ranks[(group.index + 1) % n],
                      group=group.pg),
           dist.P2POp(dist.irecv, recv, group.ranks[(group.index - 1) % n],
                      group=group.pg)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device)
