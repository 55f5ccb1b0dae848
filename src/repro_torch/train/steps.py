"""The train step (port of ``repro.train.steps.make_train_step``).

One device, eager: the loss and its gradient with respect to every
parameter (``torch.autograd.grad``), optional gradient accumulation as a
loop over microbatches, global-norm clipping, then the optimizer update.
The dropout seed is the optimizer step, as in the JAX package. The
metrics are the reference's: loss, ce, aux (the MoE load-balancing loss,
0 for dense models), tokens and grad_norm.

Clipping, update and apply go piece by piece (each top-level entry of the
params, each block of ``blocks`` and of an encoder's ``enc_blocks``), so
the fp32 clipped gradients and updates of only one piece exist at a time:
at olmoe-1b-7b's width that is ~3.4 GB instead of 8 bytes a parameter.
The global norm is taken over every gradient first, AdamW works element
by element, and LAMB's trust ratio of a block leaf is taken over all
layers (two passes over the blocks, ``Optimizer.stacked``), so the result
is the same as clipping and updating the whole tree at once — the tree as
the reference holds it: its blocks stacked on a leading layer axis. Its
optimizers decay a leaf of two or more dims, and each block leaf has the
layer axis there, so a block's 1-D leaves (norm scales, biases, the SSM's
``A_log``, ``D``, ``dt_bias``) are decayed and only the top-level 1-D ones
(the final norm, an encoder's final norm) are not. The step hands each
block, an encoder's too, to the optimizer with that axis (a view), so the
updates are the reference's. The sharded and ZeRO-1 step factories wait
for the tensor/data-parallel slice (ROADMAP.md).
"""

from __future__ import annotations

import torch

from repro_torch.core.tree import tree_leaves, tree_map, with_leaves
from repro_torch.models.model_zoo import Model
from repro_torch.optim.optimizers import (Optimizer, apply_updates,
                                          clip_scale, global_norm)


def _get(tree, key):
    return tree[key[0]] if len(key) == 1 else tree[key[0]][key[1]]


def _set(tree, key, value) -> None:
    if len(key) == 1:
        tree[key[0]] = value
    else:
        tree[key[0]][key[1]] = value


def _clip_update_apply(optimizer: Optimizer, grads, opt_state, params,
                       clip_norm: float):
    """Global-norm clipping, the optimizer update and its application, one
    piece at a time (each top-level entry of the params, each block of a
    list); each piece's gradients are released once its moments are
    updated; a block goes with a leading layer axis, as the reference
    stacks it (the moments are updated in place through the views). An
    optimizer with a ``stacked`` update (LAMB) takes the blocks of a list
    in two passes, so that a block leaf's update sees the whole stack:
    pass 1 updates every block's moments and sums its statistics (turned
    into one scale per leaf), pass 2 forms and applies every block's
    update.
    Returns (new params, opt_state, norm before clipping)."""
    norm = global_norm(grads)
    scale = clip_scale(norm, clip_norm)
    step = opt_state["step"]
    new = {k: list(v) if isinstance(v, list) else v
           for k, v in params.items()}

    def piece(key, with_grads=True):
        """(clipped fp32 grads or None, optimizer state, params) of one
        piece, a block with a leading layer axis (views)."""
        def view(t):
            return t.unsqueeze(0) if len(key) == 2 else t

        g = None
        if with_grads:
            g = tree_map(lambda x: view(x.float() * scale), _get(grads, key))
            _set(grads, key, None)
        state = {"step": step, "mu": tree_map(view, _get(opt_state["mu"], key)),
                 "nu": tree_map(view, _get(opt_state["nu"], key))}
        return g, state, tree_map(view, _get(params, key))

    def apply(key, updates):
        if len(key) == 2:
            updates = tree_map(lambda u: u.squeeze(0), updates)
        _set(new, key, apply_updates(_get(params, key), updates))

    for name, entry in params.items():
        stacked = isinstance(entry, list) and optimizer.stacked is not None
        keys = ([(name, i) for i in range(len(entry))]
                if isinstance(entry, list) else [(name,)])
        if stacked:
            sums: list = []
            for key in keys:
                g, state, p = piece(key)
                optimizer.stacked.moments(g, state, p, sums)
                del g
            scales = optimizer.stacked.scales(state, sums)
            for key in keys:
                _, state, p = piece(key, with_grads=False)
                apply(key, optimizer.stacked.update(state, p, scales))
            continue
        for key in keys:
            g, state, p = piece(key)
            updates, _ = optimizer.update(g, state, p)
            del g
            apply(key, updates)
    opt_state["step"] = step + 1
    return new, opt_state, norm


def make_train_step(model: Model, optimizer: Optimizer, *,
                    clip_norm: float = 1.0, grad_accum: int = 1,
                    deterministic: bool = False):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``.
    ``batch`` leaves are numpy arrays or tensors with the global batch on
    axis 0 (divisible by ``grad_accum``). Metrics are 0-d tensors:
    loss, ce, aux, tokens (averaged over microbatches) and grad_norm."""

    def grads_of(params, batch, seed):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, metrics = model.loss(with_leaves(params, leaves), batch,
                                   deterministic=deterministic,
                                   dropout_seed=seed)
        # a leaf the loss never reads (hymba's ssm_norm) gets a zero
        # gradient, as under jax.grad
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return (with_leaves(params, grads),
                {k: v.detach() for k, v in metrics.items()})

    def train_step(params, opt_state, batch):
        seed = int(opt_state["step"])
        if grad_accum == 1:
            grads, metrics = grads_of(params, batch, seed)
        else:
            n = len(next(iter(batch.values())))
            if n % grad_accum:
                raise ValueError(f"batch {n} is not a multiple of "
                                 f"grad_accum {grad_accum}")
            mb = n // grad_accum
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            metrics = None
            for i in range(grad_accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                g, m = grads_of(params, micro, seed)
                grads = tree_map(lambda a, x: a + x / grad_accum, grads, g)
                m = {k: v / grad_accum for k, v in m.items()}
                metrics = m if metrics is None else {
                    k: metrics[k] + m[k] for k in m}
        params, opt_state, gnorm = _clip_update_apply(
            optimizer, grads, opt_state, params, clip_norm)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step
