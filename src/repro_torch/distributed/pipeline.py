"""GPipe pipeline parallelism over a ring of ranks (port of
``repro.distributed.pipeline``).

The layer stack is split into S stages (``split_stages``: the leading dim
of every leaf); rank s of the mesh's ``"pipe"`` axis runs stage s.
Microbatches stream round the ring through ``comm.ring_shift``, the
reference's ``ppermute``: GPipe's fill-run-drain in M + S - 1 ticks, a
bubble of (S - 1) / (M + S - 1). Every rank runs every tick the same way
(stage 0 picks the injected microbatch with ``torch.where``, as the
reference's ``jnp.where``), so every rank runs the same collectives in
the same order, forward and backward. The last stage's outputs reach
every stage by a masked sum over the ring (``comm.reduce_from_group``):
the loss is taken once, on the replicated output, and its gradient flows
back through the reverse shifts. Differentiable end to end.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.distributed import comm


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                   mesh, axis: str = "pipe",
                   num_microbatches: int) -> torch.Tensor:
    """``stage_fn(params_of_one_stage, x_mb) -> y_mb`` over the stages;
    ``stage_params`` a tree whose leaves lead with the stage dim (every
    rank takes its own, ``mesh.named_coord[axis]``); ``x`` (global_batch,
    ...) the same on every rank. Returns the stack's output (global_batch,
    ...) on every rank."""
    group = mesh.group(axis)
    S, stage = group.size, group.index
    M = num_microbatches
    gb = x.shape[0]
    if gb % M:
        raise ValueError(f"global batch {gb} is not a multiple of "
                         f"{M} microbatches")
    xs = x.reshape(M, gb // M, *x.shape[1:])
    params = tree_map(lambda p: p[stage], stage_params)
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == S - 1, device=x.device)
    state = torch.zeros_like(xs[0])
    out = [torch.zeros_like(xs[0]) for _ in range(M)]
    for t in range(M + S - 1):
        inp = torch.where(first, xs[min(t, M - 1)], state)
        y = stage_fn(params, inp)
        state = comm.ring_shift(y, group)
        if t >= S - 1:
            out[t - (S - 1)] = torch.where(last, y, out[t - (S - 1)])
    # the last stage's outputs on every stage
    mask = float(stage == S - 1)
    y = comm.reduce_from_group(torch.stack(out) * mask, group)
    return y.reshape(gb, *y.shape[2:])


def split_stages(stacked_params, num_stages: int):
    """A (L, ...) layer-stacked tree reshaped to (S, L / S, ...)."""
    def one(p):
        L = p.shape[0]
        if L % num_stages:
            raise ValueError(f"{L} layers do not split into {num_stages} "
                             f"stages")
        return p.reshape(num_stages, L // num_stages, *p.shape[1:])
    return tree_map(one, stacked_params)


def make_stage_fn(block_fn: Callable):
    """A per-layer ``block_fn(params_of_one_layer, x)`` as a stage function
    running its sub-stack in order."""
    def stage_fn(stage_params, x):
        for l in range(tree_leaves(stage_params)[0].shape[0]):
            x = block_fn(tree_map(lambda p: p[l], stage_params), x)
        return x
    return stage_fn



def tanh_block(p_l, x):
    """The reference test's layer, a residual tanh of a square matrix:
    ``tanh(x @ w) + x`` (``launch.pipeline_rank`` and the card's check)."""
    return torch.tanh(x @ p_l["w"]) + x
