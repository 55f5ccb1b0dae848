"""The collectives of the sharded model and of the sharded train step (the
counterparts of the ``psum``, ``pmax``, tiled ``all_gather``,
``psum_scatter`` and ``ppermute`` that the reference's ``shard_map``
bodies and sharded ``jit`` trace), each on one axis ``Group`` of a mesh
(``meshes.ServeMesh`` or ``meshes.Mesh``):

  * ``all_reduce_sum`` — the tp projection boundaries of serving
    (attention ``wo``, MLP ``w_down``), summed in the payload's dtype;
  * ``all_reduce_max`` — the global max of a vocab-sharded softmax;
  * ``all_gather`` — an sp chunk's K/V slabs, concatenated in slab order;
  * ``reduce_scatter`` — the data-parallel gradient sum under ZeRO-1:
    the sum over the group, cut along one dim, slab i to rank i;
  * ``ring_shift`` — one ``batch_isend_irecv`` step, each rank sending to
    its right neighbour ``(i + 1) % n`` and receiving from its left;
    differentiable: its backward is the reverse shift (the pipeline's
    activations).

and the autograd-aware pair of tensor-parallel training (Megatron's f and
g), with a differentiable gather:

  * ``copy_to_group`` — the identity forward, a sum over the group
    backward: where a replicated activation (or parameter) enters a
    column-parallel computation, each rank's gradient is a partial sum;
  * ``reduce_from_group`` — a sum over the group forward, the identity
    backward: the row-parallel outputs (``wo``, ``w_down``), the masked
    embedding lookup, the softmax statistics of a vocab-sharded loss;
  * ``gather_from_group`` — an ``all_gather`` forward, a
    ``reduce_scatter`` backward (the K/V columns when a kv head is split
    across ranks);
  * ``sum_over_group`` — a sum forward and a sum backward: a statistic
    each rank takes over its own part and every rank then uses whole
    (the SSM's gated-norm sum of squares over channels cut by head
    group), whose gradient each rank holds only for its own uses;
  * ``copy_parts_to_group`` — ``copy_to_group`` for parts of several
    tensors at once: views forward, and backward the listed spans of
    their gradients summed over the group in one fp32 ``all_reduce``
    (the pieces of a head-group SSM that every rank holds whole).

Each call adds one to the group's ``collectives`` counter under its kind
(``all_reduce``, ``all_reduce_max``, ``all_gather``, ``reduce_scatter``,
``ring_shift``), a backward's collective too: that counter is the port's
census of a step. A call on an axis of one rank returns its input unsent
(the sum, gather or shift over one rank is the identity), and is counted
all the same, as the reference's trace counts a ``psum`` over an axis of
size 1. With backend ``gloo`` a CUDA payload is copied to host memory,
sent, and copied back: that is how gloo carries it (several ranks on one
card), not a fallback after a failure; nothing here catches a failed
collective.
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


def _reduce(x: torch.Tensor, group: Group, op) -> torch.Tensor:
    buf = _staged(x, group)
    dist.all_reduce(buf, op=op, group=group.pg)
    return buf.to(x.device)


def all_reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of every rank's ``x`` over the group, in x's dtype, on x's
    device. Every rank of the group receives the same bits. May reuse x's
    storage."""
    _count(group, "all_reduce")
    if group.size == 1:
        return x
    return _reduce(x, group, dist.ReduceOp.SUM)


def all_reduce_max(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The elementwise max of every rank's ``x`` over the group (a new
    tensor; not differentiable)."""
    _count(group, "all_reduce_max")
    if group.size == 1:
        return x
    return _reduce(x.detach().clone(), group, dist.ReduceOp.MAX)


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


def reduce_scatter(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """The sum over the group of every rank's ``x``, cut along ``dim`` into
    ``group.size`` equal slabs: rank i of the group receives slab i (in
    x's dtype, on x's device). ``x.shape[dim]`` must divide."""
    _count(group, "reduce_scatter")
    n = group.size
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not divide into {n} slabs")
    if n == 1:
        return x
    buf = _staged(x, group)
    parts = [p.contiguous() for p in buf.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group.pg)
    return out.to(x.device)


def _shift(x: torch.Tensor, group: Group, step: int) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` places on, receive from the rank
    ``step`` places back."""
    _count(group, "ring_shift")
    n = group.size
    if n == 1:
        return x
    buf = _staged(x, group)
    recv = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf, group.ranks[(group.index + step) % n],
                      group=group.pg),
           dist.P2POp(dist.irecv, recv, group.ranks[(group.index - step) % n],
                      group=group.pg)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = _shift(x, group, 1)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, g):
        return _shift(g.contiguous(), ctx.group, -1), None


def ring_shift(x: torch.Tensor, group: Group) -> torch.Tensor:
    """One ring step: send ``x`` to the next rank of the group, return what
    the previous one sent (same shape and dtype). Its gradient goes the
    other way round the ring."""
    return _RingShift.apply(x, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        out = all_gather(x, group, dim)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.group, ctx.dim), None, None


def copy_to_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """x itself; in the backward its gradient is summed over the group."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """x summed over the group; in the backward its gradient passes as
    it is to every rank's summand."""
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """Every rank's x concatenated along ``dim``; in the backward each
    rank's slab of the gradient is summed over the group."""
    return _GatherFromGroup.apply(x, group, dim)


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(), ctx.group), None


class _CopyPartsToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, parts, *tensors):
        ctx.group, ctx.parts = group, parts
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        grads = [g.clone() for g in grads]
        spans = [g.narrow(dim, off, size)
                 for g, (dim, offs) in zip(grads, ctx.parts)
                 for off, size in offs]
        flat = all_reduce_sum(torch.cat([t.float().reshape(-1)
                                         for t in spans]), ctx.group)
        for t, part in zip(spans, flat.split([t.numel() for t in spans])):
            t.copy_(part.view(t.shape))
        return (None, None, *grads)


def sum_over_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """x summed over the group; in the backward its gradient is summed over
    the group too (every rank's use of the sum contributes to each
    summand's gradient)."""
    return _SumOverGroup.apply(x, group)


def copy_parts_to_group(tensors, parts, group: Group) -> tuple:
    """Views of ``tensors``; in the backward the spans ``parts`` of their
    gradients, ``(dim, [(offset, size), ...])`` a tensor, are summed over
    the group (one ``all_reduce`` in fp32, cast back) and the rest passes
    as it is."""
    return _CopyPartsToGroup.apply(group, tuple(parts), *tensors)
