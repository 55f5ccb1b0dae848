"""The train step (port of ``repro.train.steps.make_train_step``).

One device, eager: the loss and its gradient with respect to every
parameter (``torch.autograd.grad``), optional gradient accumulation as a
loop over microbatches, global-norm clipping, then the optimizer update.
The dropout seed is the optimizer step, as in the JAX package. The
sharded and ZeRO-1 step factories wait for the tensor/data-parallel slice
(ROADMAP.md).
"""

from __future__ import annotations

import torch

from repro_torch.core.tree import tree_leaves, tree_map, with_leaves
from repro_torch.models.model_zoo import Model
from repro_torch.optim.optimizers import (Optimizer, apply_updates,
                                          clip_by_global_norm)


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
        grads = torch.autograd.grad(loss, leaves)
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
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        del grads
        params = apply_updates(params, updates)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step
