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

from repro_torch.core.tree import tree_leaves, tree_map, with_leaves


class StackedUpdate(NamedTuple):
    """The update of leaves stacked on a leading layer axis, taken one
    layer at a time (the train step hands the optimizer one block at a
    time), for an optimizer whose update of a leaf depends on the whole
    leaf (LAMB's trust ratio). ``moments(grads, state, params, sums,
    shares=None)`` (pass 1, every layer) updates the layer's moments in
    place and adds each leaf's statistics into ``sums`` (device tensors,
    one per leaf in tree order; an empty list before the first layer),
    each element counted by its share where ``shares`` gives one a leaf
    (a float or a broadcasting tensor: a sharded rank's part of a sum
    over the mesh); ``scales(state,
    sums)`` turns the whole stack's sums into one device tensor, a scale
    per leaf; ``update(state, params, scales)`` (pass 2, every layer) returns
    the layer's updates from the moments stored in pass 1. They take the
    state as ``update`` does (the step before this one) and never wait on
    the host."""
    moments: Callable
    scales: Callable
    update: Callable


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    # None: ``update`` works element by element (AdamW), so one layer of a
    # stacked leaf updates as the whole leaf would
    stacked: StackedUpdate | None = None


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that brings a global norm of ``norm`` to at most
    ``max_norm``."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """(fp32 grads scaled so their global norm is at most ``max_norm``,
    the norm before clipping)."""
    norm = global_norm(tree)
    scale = clip_scale(norm, max_norm)
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


def _update_moments(g, m, v, b1, b2):
    """The fp32 moments of one leaf, in place."""
    g = g.float()
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)


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
            _update_moments(g, m, v, b1, b2)
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
    once per leaf. A leaf stacked on a layer axis but updated a layer at a
    time takes its ratio over the whole stack, as the reference's stacked
    leaf does (``stacked``: pass 1 sums ||p||² and ||r||² over the layers,
    pass 2 recomputes r from the stored moments with the same arithmetic
    and applies the ratio)."""
    lr_fn = _lr_fn(lr)

    def consts(state):
        step = state["step"] + 1
        return step, lr_fn(step), *_bias_corrections(step, b1, b2)

    def direction(m, v, p, b1c, b2c):
        r = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        if _is_matrix(p):
            r = r + weight_decay * p.float()
        return r

    def trust_ratio(w_norm, r_norm):
        return torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                           torch.ones_like(w_norm))

    def update(grads, state, params):
        step, lr_t, b1c, b2c = consts(state)

        def upd(g, m, v, p):
            _update_moments(g, m, v, b1, b2)
            r = direction(m, v, p, b1c, b2c)
            trust = trust_ratio(torch.linalg.vector_norm(p.float()),
                                torch.linalg.vector_norm(r))
            return -lr_t * trust * r

        updates = tree_map(upd, grads, state["mu"], state["nu"], params)
        state["step"] = step
        return updates, state

    def layer_moments(grads, state, params, sums, shares=None):
        """||p||² and ||r||² of each leaf of one layer (each element times
        its share, where given), added into sums."""
        _, _, b1c, b2c = consts(state)
        leaves = zip(tree_leaves(grads), tree_leaves(state["mu"]),
                     tree_leaves(state["nu"]), tree_leaves(params))
        for i, (g, m, v, p) in enumerate(leaves):
            _update_moments(g, m, v, b1, b2)
            r = direction(m, v, p, b1c, b2c)
            w = 1.0 if shares is None else shares[i]
            if isinstance(w, float):
                sq = torch.stack([
                    torch.linalg.vector_norm(p, dtype=torch.float32),
                    torch.linalg.vector_norm(r)]).square() * w
            else:
                sq = torch.stack([(p.float().square() * w).sum(),
                                  (r.square() * w).sum()])
            if i == len(sums):
                sums.append(sq)
            else:
                sums[i] = sums[i] + sq

    def stack_scales(state, sums):
        """-lr times the trust ratio of each stacked leaf."""
        _, lr_t, _, _ = consts(state)
        norms = torch.stack(sums).sqrt()
        return -lr_t * trust_ratio(norms[:, 0], norms[:, 1])

    def layer_update(state, params, scales):
        _, _, b1c, b2c = consts(state)
        leaves = zip(tree_leaves(state["mu"]), tree_leaves(state["nu"]),
                     tree_leaves(params), scales)
        return with_leaves(params, [c * direction(m, v, p, b1c, b2c)
                                    for m, v, p, c in leaves])

    return Optimizer(_init_moments, update,
                     StackedUpdate(layer_moments, stack_scales, layer_update))
