"""AdamW (the GPT-2 recipe of the paper's App. E.2) and LAMB (the MLPerf
BERT recipe of App. E.1), port of ``repro.optim.optimizers``.

Functional API over the port's parameter trees (nested dicts and lists of
tensors):

    opt = adamw(lr_fn, ...)          # or lamb(lr_fn, ...)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

The state is ``{"step": 0-d int32 tensor on the CPU, "mu": tree, "nu":
tree}`` with fp32 moments beside each parameter. Unlike the JAX package,
``update`` writes the new moments IN PLACE into ``state["mu"]`` /
``state["nu"]`` (at the full width of granite-3-2b a second copy of the
fp32 moments is 20 GB) and returns the same state dict with the step
advanced; callers that must keep an old state pass a copy.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(tree, max_norm: float):
    """(fp32 grads scaled so their global norm is at most ``max_norm``,
    the norm before clipping)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, tree), norm


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)


def _is_matrix(p: torch.Tensor) -> bool:
    return p.ndim >= 2


def _init_moments(params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"step": torch.zeros((), dtype=torch.int32),
            "mu": tree_map(zeros, params),
            "nu": tree_map(zeros, params)}


def _bias_corrections(step, b1, b2):
    stepf = step.float()
    return (1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), stepf),
            1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), stepf))


def _lr_fn(lr):
    return lr if callable(lr) else (
        lambda _: torch.tensor(lr, dtype=torch.float32))


def adamw(lr: Callable[[torch.Tensor], torch.Tensor] | float,
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    """AdamW with bias correction; decoupled weight decay on matrices only
    (norm scales are not decayed); ``lr`` is a schedule of the step
    (1-based, as in the JAX package) or a constant."""
    lr_fn = _lr_fn(lr)

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        b1c, b2c = _bias_corrections(step, b1, b2)

        def upd(g, m, v, p):
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            u = (m / b1c) / (torch.sqrt(v / b2c) + eps)
            if _is_matrix(p):
                u = u + weight_decay * p.float()
            return -lr_t * u

        updates = tree_map(upd, grads, state["mu"], state["nu"], params)
        state["step"] = step
        return updates, state

    return Optimizer(_init_moments, update)


def lamb(lr: Callable[[torch.Tensor], torch.Tensor] | float,
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         weight_decay: float = 0.01) -> Optimizer:
    """LAMB [You et al.]: the AdamW direction (weight decay on matrices
    only) scaled per leaf by the trust ratio ||p|| / ||r||, or 1 where
    either norm is 0 (a zero-initialised LayerNorm bias). The ratio stays
    a device tensor (``torch.where``), so a step never waits on the host
    once per leaf."""
    lr_fn = _lr_fn(lr)

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        b1c, b2c = _bias_corrections(step, b1, b2)

        def upd(g, m, v, p):
            g = g.float()
            pf = p.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            r = (m / b1c) / (torch.sqrt(v / b2c) + eps)
            if _is_matrix(p):
                r = r + weight_decay * pf
            w_norm = torch.linalg.vector_norm(pf)
            r_norm = torch.linalg.vector_norm(r)
            trust = torch.where((w_norm > 0) & (r_norm > 0),
                                w_norm / r_norm, torch.ones_like(w_norm))
            return -lr_t * trust * r

        updates = tree_map(upd, grads, state["mu"], state["nu"], params)
        state["step"] = step
        return updates, state

    return Optimizer(_init_moments, update)
