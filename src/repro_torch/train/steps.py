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
updates are the reference's.

``make_sharded_train_step`` is the port of the reference's pjit-sharded
step as SPMD ranks over a ``distributed.meshes.Mesh`` (one process a
shard, every rank running the same step): each rank holds its batch rows
(the data axes), its head, FFN, vocab, expert and SSM head-group slices
of the params (the "model" axis, through the rule table; every family
trains at "model" > 1, the heads replicated where the axis would not cut
them whole: ``sharding.train_rules``) and, under ZeRO-1, its slice of
each moment (``distributed.zero``). The rank's forward and backward run
the model's tensor-parallel collectives (``Model`` with a ``TrainShard``);
the gradients are then summed over the data axes, into the moment
slices under ZeRO-1 (one ``reduce_scatter``), else everywhere (one
``all_reduce``), each in one flat fp32 buffer; clipping reads the global
norm (one ``all_reduce`` over the mesh, each element counted once: the
pieces every rank of an axis holds, the SSM's whole B and C columns
among them, divided by their holders, ``NamedSharding.share``); the
rank updates its slice (LAMB's trust-ratio sums are one more
``all_reduce``) in place, and under ZeRO-1 the updated slices are
all-gathered back (one ``all_gather``). Every result is the unsharded
step's up to the order of float sums, the reference's contract (its jit
is one global program).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.tree import tree_leaves, tree_map, with_leaves
from repro_torch.distributed import comm
from repro_torch.distributed.meshes import data_axis_names
from repro_torch.distributed.sharding import (
    DecodeShard, NamedSharding, P, TrainShard, _pairs, decode_cuts,
    expected_kv_seq_decode_census, expected_train_census, local_shape,
    resolve_spec, resolve_tree, rules_for_mesh, train_cuts, train_rules,
    validate_divisibility)
from repro_torch.distributed.zero import (moment_shardings, param_slice,
                                          zero1_dim)
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


def _grads_fn(model: Model, deterministic: bool):
    """``grads_of(params, batch, seed) -> (gradient leaves, metrics)``."""
    def grads_of(params, batch, seed):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, metrics = model.loss(with_leaves(params, leaves), batch,
                                   deterministic=deterministic,
                                   dropout_seed=seed)
        # a leaf the loss never reads (hymba's ssm_norm) gets a zero
        # gradient, as under jax.grad
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return list(grads), {k: v.detach() for k, v in metrics.items()}
    return grads_of


def _accumulate(grads_of, params, batch, seed, grad_accum: int):
    """(gradient leaves, metrics) of ``grads_of`` over the batch, averaged
    over ``grad_accum`` contiguous microbatches of its rows (fp32 sums)."""
    if grad_accum == 1:
        return grads_of(params, batch, seed)
    n = len(next(iter(batch.values())))
    if n % grad_accum:
        raise ValueError(f"batch {n} is not a multiple of grad_accum "
                         f"{grad_accum}")
    mb = n // grad_accum
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in tree_leaves(params)]
    metrics = None
    for i in range(grad_accum):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        g, m = grads_of(params, micro, seed)
        grads = [a + x / grad_accum for a, x in zip(grads, g)]
        m = {k: v / grad_accum for k, v in m.items()}
        metrics = m if metrics is None else {k: metrics[k] + m[k] for k in m}
    return grads, metrics


def make_train_step(model: Model, optimizer: Optimizer, *,
                    clip_norm: float = 1.0, grad_accum: int = 1,
                    deterministic: bool = False):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``.
    ``batch`` leaves are numpy arrays or tensors with the global batch on
    axis 0 (divisible by ``grad_accum``). Metrics are 0-d tensors:
    loss, ce, aux, tokens (averaged over microbatches) and grad_norm."""

    grads_of = _grads_fn(model, deterministic)

    def train_step(params, opt_state, batch):
        seed = int(opt_state["step"])
        grads, metrics = _accumulate(grads_of, params, batch, seed,
                                     grad_accum)
        grads = with_leaves(params, grads)
        params, opt_state, gnorm = _clip_update_apply(
            optimizer, grads, opt_state, params, clip_norm)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """The batch on the mesh: its rows cut over the data axes (``axes``),
    or the same rows on every rank (``axes`` empty). ``shard`` takes a
    rank's rows of the global batch; with ``grad_accum`` microbatches
    they are its part of each microbatch in turn (microbatch i is the
    global rows [i * mb, (i + 1) * mb), as the reference's scan splits
    them), so the step's microbatches are contiguous runs of the rank's
    rows."""
    mesh: object
    axes: tuple[str, ...]

    def shard(self, batch: dict, grad_accum: int = 1) -> dict:
        if not self.axes:
            return batch
        group = self.mesh.data
        n = group.size

        def rows(x):
            b = x.shape[0]
            if b % (grad_accum * n):
                raise ValueError(f"batch {b} does not split into "
                                 f"{grad_accum} microbatches over {n} data "
                                 f"ranks")
            x = x.reshape(grad_accum, n, b // (grad_accum * n), *x.shape[1:])
            x = x[:, group.index]
            return x.reshape(b // n, *x.shape[2:])

        return {k: rows(v) for k, v in batch.items()}


def _batch_sharding(mesh, rules, batch_specs) -> BatchSharding:
    """Rows over the data axes where a spec's first entry resolves to them
    (the reference's ``batch_specs``); no spec: replicated, as the
    reference's ``P()``."""
    data = set(data_axis_names(mesh))
    axes: tuple[str, ...] = ()
    for spec in (batch_specs or {}).values():
        phys = resolve_spec(spec, rules)
        for i, entry in enumerate(phys):
            names = entry if isinstance(entry, tuple) else (entry,)
            if entry is None:
                continue
            if i != 0 or not set(names) <= data:
                raise ValueError(f"batch spec {spec} resolves to {phys}: the "
                                 f"port cuts only the rows, over the data "
                                 f"axes")
            axes = tuple(names)
    if axes and axes != tuple(data_axis_names(mesh)):
        raise ValueError(f"the batch rows are cut over {axes}; the port cuts "
                         f"them over all the data axes "
                         f"{data_axis_names(mesh)}")
    return BatchSharding(mesh, axes)


def _rank_cfg(cfg, shard: TrainShard):
    """The config of a rank's model: its q and kv heads, d_ff and experts
    where they are cut (the SSM reads its head group off the shard). A
    rank whose heads are cut resolves its attention tiles as one of
    ``m`` shards (``tp_shards``), as the serving engine's ranks do."""
    m = shard.model.size
    kw = {}
    if shard.heads:
        kw.update(num_heads=cfg.num_heads // m,
                  num_kv_heads=(cfg.num_kv_heads // m if not shard.kv_split
                                else 1),
                  tp_shards=m)
    if shard.ff:
        kw["d_ff"] = cfg.d_ff // m
    if shard.experts:
        kw["num_experts"] = cfg.num_experts // m
    return dataclasses.replace(cfg, **kw)


def _entries(params):
    """(key, piece) of each optimizer piece: every top-level entry, and
    every block of a list (key (name, i))."""
    for name, entry in params.items():
        if isinstance(entry, list):
            for i, block in enumerate(entry):
                yield (name, i), block
        else:
            yield (name,), entry


def make_sharded_train_step(model: Model, optimizer: Optimizer, mesh, *,
                            rules=None, zero1: bool = True,
                            clip_norm: float = 1.0, grad_accum: int = 1,
                            deterministic: bool = False, batch_specs=None,
                            donate: bool = True, on_grads=None):
    """Returns ``(step, shardings)``: ``step(params, opt_state, batch) ->
    (params, opt_state, metrics)`` for THIS rank of ``mesh`` (a
    ``meshes.Mesh``), every rank calling it with its own pieces and the
    same global ``batch``; ``shardings`` = {"params", "opt", "batch"}:
    ``NamedSharding`` trees of the params and of the optimizer state
    (``shard`` cuts a rank's pieces out of full arrays, ``gather`` puts
    them back), the ``BatchSharding`` and the ``census`` a step must
    count (``sharding.expected_train_census``). ``batch_specs``: the
    logical specs of the batch leaves (rows over "data"), else the batch
    is replicated. The metrics are the reference's (loss, ce, aux, tokens,
    grad_norm), the whole batch's, the same on every rank. ``donate``:
    the rank's params are updated in place (the moments always are).
    ``on_grads``: called every step with the summed gradients before
    clipping, fp32, a tree of the rank's moment slices
    (``shardings["opt"]["mu"]`` gathers them). ``rules`` pass through
    ``sharding.train_rules``."""
    cfg = model.cfg
    rules = train_rules(cfg, mesh.shape, rules or rules_for_mesh(mesh))
    specs, shapes = model.param_specs(), model.param_shapes()
    problems = validate_divisibility(shapes, specs, mesh, rules)
    if problems:
        raise ValueError("sharding preflight failed:\n" + "\n".join(problems))
    param_sh = resolve_tree(specs, mesh, rules)
    moment_sh = (moment_shardings(shapes, specs, mesh, rules) if zero1
                 else param_sh)
    batch_sh = _batch_sharding(mesh, rules, batch_specs)
    shard = TrainShard(model=mesh.group("model") if "model" in mesh.shape
                       else mesh.group(()), data=mesh.data,
                       **train_cuts(cfg, mesh.shape, rules),
                       num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                       vocab_size=cfg.vocab_size,
                       batch_sharded=bool(batch_sh.axes),
                       num_experts=cfg.num_experts,
                       ssm_num_heads=cfg.ssm_num_heads if cfg.ssm_state else 0)
    rank_model = type(model)(_rank_cfg(cfg, shard), shard=shard)
    world, data = mesh.world, mesh.data
    leaf_sh = tree_leaves(moment_sh)
    cuts = [zero1_dim(sh) if zero1 else None for sh in leaf_sh]
    whole = [i for i, c in enumerate(cuts) if c is None]
    sliced = [i for i, c in enumerate(cuts) if c is not None]
    # each element's share of a mesh-wide sum (1 / the ranks holding it)
    elem_shares = tree_leaves(_pairs(shapes, moment_sh, lambda t, sh: _on(
        sh.share(t.ndim), mesh.device)))

    grads_of = _grads_fn(rank_model, deterministic)

    def reduce_grads(grads):
        """The data-parallel sum of every gradient, fp32: this rank's
        moment slice of it under ZeRO-1."""
        if data.size == 1:
            return [g.float() for g in grads]
        out = [None] * len(grads)
        if whole:
            flat = comm.all_reduce_sum(
                torch.cat([grads[i].float().reshape(-1) for i in whole]), data)
            for i, part in zip(whole, flat.split([grads[i].numel()
                                                  for i in whole])):
                out[i] = part.view(grads[i].shape)
        if sliced:
            n = data.size
            # each leaf's cut dim first, split into the data ranks' slabs
            parts = [grads[i].float().movedim(cuts[i], 0).reshape(
                n, -1) for i in sliced]
            mine = comm.reduce_scatter(torch.cat(parts, dim=1), data,
                                       dim=0)[0]
            sizes = [p.shape[1] for p in parts]
            for i, part in zip(sliced, mine.split(sizes)):
                shape = list(grads[i].movedim(cuts[i], 0).shape)
                shape[0] //= n
                out[i] = part.view(shape).movedim(0, cuts[i])
        return out

    def gather_params(params):
        """The updated moment slices all-gathered back into each rank's
        param pieces (ZeRO-1), in place."""
        pieces = tree_leaves(params)
        if data.size == 1 or not sliced:
            return
        n = data.size
        mine = [param_slice(pieces[i], leaf_sh[i]).float().movedim(
            cuts[i], 0).reshape(-1) for i in sliced]
        every = comm.all_gather(torch.cat(mine), data, dim=0).view(n, -1)
        off = 0
        for i, part in zip(sliced, mine):
            piece = pieces[i].movedim(cuts[i], 0)
            slabs = every[:, off:off + part.numel()]
            off += part.numel()
            piece.copy_(slabs.reshape(piece.shape).to(piece.dtype))

    def train_step(params, opt_state, batch):
        # the trees in the shardings' leaf order (the specs' key order)
        params = _pairs(params, param_sh, lambda t, _: t)
        opt_state = dict(opt_state, **{k: _pairs(opt_state[k], moment_sh,
                                                 lambda t, _: t)
                                       for k in ("mu", "nu")})
        seed = int(opt_state["step"])
        grads, metrics = _accumulate(grads_of, params,
                                     batch_sh.shard(batch, grad_accum), seed,
                                     grad_accum)
        if data.size > 1:
            shares = comm.all_reduce_sum(torch.stack(
                [metrics["loss"], metrics["ce"], metrics["aux"].float()]),
                data)
            metrics = dict(metrics, loss=shares[0], ce=shares[1],
                           aux=shares[2])
        grads = reduce_grads(grads)
        if on_grads is not None:
            on_grads(with_leaves(moment_sh, grads))
        # the global norm: each element's square once (its share), summed
        # over the mesh
        sq = torch.stack([_once(g.square(), w)
                          for g, w in zip(grads, elem_shares)]).sum()
        if world.size > 1:
            sq = comm.all_reduce_sum(sq, world)
        norm = torch.sqrt(sq)
        scale = clip_scale(norm, clip_norm)
        if not donate:
            params = tree_map(torch.clone, params)
        _sharded_update(optimizer, grads, opt_state, params, scale,
                        leaf_sh, elem_shares, world)
        gather_params(params)
        metrics = dict(metrics)
        metrics["grad_norm"] = norm
        return params, opt_state, metrics

    census = expected_train_census(
        cfg, mesh.shape, rules, zero1=zero1,
        cut_leaves=any(c is not None for c in cuts),
        whole_leaves=any(c is None for c in cuts), grad_accum=grad_accum,
        stacked=optimizer.stacked is not None)
    shardings = {"params": param_sh,
                 "opt": {"step": NamedSharding(mesh, P()), "mu": moment_sh,
                         "nu": moment_sh},
                 "batch": batch_sh, "census": census}
    return train_step, shardings


def init_opt_state(optimizer: Optimizer, params, shardings):
    """A rank's optimizer state for its param pieces: the moments of
    ``optimizer.init`` at the shapes of its moment slices (nothing of the
    full moments is made)."""
    slices = _pairs(_pairs(params, shardings["params"], lambda t, _: t),
                    shardings["opt"]["mu"], param_slice)
    return optimizer.init(slices)


def _on(share, device):
    return share if isinstance(share, float) else share.to(device)


def _once(sq: torch.Tensor, share) -> torch.Tensor:
    """The sum of ``sq`` (a piece's squares) with each element counted by
    its share (``NamedSharding.share``)."""
    if isinstance(share, float):
        return sq.sum() * share
    return (sq * share).sum()


def _sharded_update(optimizer: Optimizer, grads: list, opt_state, params,
                    scale, leaf_sh, shares, world) -> None:
    """The optimizer update of this rank's slices, one piece (top-level
    entry or block, a block with a leading layer axis) at a time, applied
    in place to the slices of the rank's params. A ``stacked`` optimizer
    (LAMB) runs its two passes over every piece, its per-leaf sums summed
    over the mesh in between (each piece's sums once); a top-level entry
    is a stack of one piece."""
    step = opt_state["step"]
    pieces = list(_entries(params))
    offsets, off = [], 0
    for _, piece in pieces:
        offsets.append(off)
        off += len(tree_leaves(piece))

    def piece_args(k, with_grads=True):
        key, piece = pieces[k]
        view = (lambda t: t.unsqueeze(0)) if len(key) == 2 else (lambda t: t)
        o = offsets[k]
        shs = leaf_sh[o:o + len(tree_leaves(piece))]
        p = with_leaves(piece, [view(param_slice(t, sh)) for t, sh in
                                zip(tree_leaves(piece), shs)])
        get = (lambda tree: tree[key[0]] if len(key) == 1
               else tree[key[0]][key[1]])
        state = {"step": step, "mu": tree_map(view, get(opt_state["mu"])),
                 "nu": tree_map(view, get(opt_state["nu"]))}
        g = None
        if with_grads:
            g = with_leaves(piece, [view(grads[o + j] * scale) for j in
                                    range(len(shs))])
        return g, state, p

    def apply(k, updates):
        _, state, p = piece_args(k, with_grads=False)
        for t, u in zip(tree_leaves(p), tree_leaves(updates)):
            t.copy_((t.float() + u).to(t.dtype))

    if optimizer.stacked is None:
        for k in range(len(pieces)):
            g, state, p = piece_args(k)
            updates, _ = optimizer.update(g, state, p)
            del g
            apply(k, updates)
    else:
        stacks: dict = {}
        for k, (key, _) in enumerate(pieces):
            stacks.setdefault(key[0], []).append(k)
        sums: dict = {}
        for name, ks in stacks.items():
            sums[name] = []
            for k in ks:
                g, state, p = piece_args(k)
                o = offsets[k]
                # each leaf's (||p||², ||r||²) with every element once
                optimizer.stacked.moments(g, state, p, sums[name],
                                          shares=shares[o:o + len(
                                              tree_leaves(g))])
                del g
        names = list(stacks)
        flat = torch.stack([x for n in names for x in sums[n]])
        if world.size > 1:
            flat = comm.all_reduce_sum(flat, world)
        flat = list(flat)
        for name in names:
            mine, flat = flat[:len(sums[name])], flat[len(sums[name]):]
            scales = optimizer.stacked.scales({"step": step}, mine)
            for k in stacks[name]:
                _, state, p = piece_args(k, with_grads=False)
                apply(k, optimizer.stacked.update(state, p, scales))
    opt_state["step"] = step + 1


# ---------------------------------------------------------------------------
# the sharded serve steps
# ---------------------------------------------------------------------------

def _state_cuts(state_sh, mesh) -> tuple[bool, bool, bool | None]:
    """(the KV capacity or pages cut over "model", the lanes cut over the
    data axes, the SSM state cut over "model" or None without one) of the
    resolved state specs; any other cut raises."""
    caches = state_sh["caches"]
    kv_seq = False
    if "kv" in caches:
        # (L, hkv, pages, page, hd) or (L, lanes, hkv, capacity, hd)
        entry = caches["kv"]["k"].spec[2 if "page_table" in state_sh else 3]
        if entry not in (None, "model"):
            raise ValueError(f"the KV capacity resolves to {entry!r}; the "
                             f"port cuts it over \"model\" only")
        kv_seq = entry == "model"
    entry = state_sh["kv_len"].spec[0]
    data = data_axis_names(mesh)
    if entry is not None and tuple(entry if isinstance(entry, tuple)
                                   else (entry,)) != data:
        raise ValueError(f"the lanes resolve to {entry!r}; the port cuts "
                         f"them over all the data axes {data}")
    ssm = None
    if "ssm" in caches:
        ssm = caches["ssm"]["h"].spec[2] == "model"
    return kv_seq, entry is not None, ssm


def make_sharded_serve_steps(model: Model, mesh, *, rules=None,
                             state_specs=None, donate: bool = True):
    """``(prefill_fn, decode_fn)`` for THIS rank of ``mesh`` (a
    ``meshes.Mesh`` with "data" and "model" axes, "model" last), the
    port of the reference's sharded serve steps, every rank calling them
    with its own pieces:

      * ``prefill_fn(params, batch, capacity, page_size=None) -> (state,
        logits)``: the global ``batch``; the rank's lanes run the
        tensor-parallel prefill and it returns its piece of the decode
        state (the reference's state after its ``device_put`` to the
        state specs: the port's prefill returns the rank's piece
        directly) and its lanes' last logits (b, 1, V). For paged
        ``state_specs`` (``Model.paged_decode_state_specs``) pass
        ``page_size``: the state is then the rank's pages of a pool in
        ``transformer.interleaved_page_table``'s layout;
      * ``decode_fn(params, state, token) -> (state, logits)``: one decode
        step of the rank's lanes (``token`` its lanes' ids) over its state
        piece: the capacity or the pool's pages cut over "model", each
        rank attending its slice with the decode kernel (#7 / #8) and the
        fp32 split partials merged across ranks; the MoE's experts and
        the SSM's head groups cut as the sharded train step cuts them.
        ``donate=False`` leaves the input state's tensors unchanged (the
        step runs on a copy).

    ``params`` are the rank's pieces (``shardings["params"]``: a tree of
    ``NamedSharding`` whose ``shard`` cuts them). ``rules`` default
    ``rules_for_mesh``; a dim that does not divide raises a ``ValueError``
    naming the leaf (granite's vocab 49155 at "model" 2: pass
    ``sharding.auto_rules``). ``state_specs`` None: no state sharding,
    the single-rank ``Model.prefill`` / ``decode_step`` over whole params
    and a whole state on every rank. Both functions carry ``shardings``:
    {"params", "state", "token", "census"}, ``census`` the collectives
    one decode step counts on every rank
    (``sharding.expected_kv_seq_decode_census``)."""
    cfg = model.cfg
    if state_specs is None:
        def decode(params, state, token):
            if not donate:
                state = tree_map(torch.clone, state)
            return model.decode_step(params, state, token)

        def prefill(params, batch, capacity):
            return model.prefill(params, batch, capacity)

        prefill.shardings = decode.shardings = {
            "params": None, "state": None, "token": None, "census": {}}
        return prefill, decode

    axes = tuple(mesh.axis_names)
    if "model" in axes and axes[-1] != "model":
        raise ValueError(f"the mesh's axes {axes} must end with \"model\"")
    rules = rules or rules_for_mesh(mesh)
    specs, shapes = model.param_specs(), model.param_shapes()
    problems = validate_divisibility(shapes, specs, mesh, rules)
    if problems:
        raise ValueError("sharding preflight failed:\n" + "\n".join(problems))
    param_sh = resolve_tree(specs, mesh, rules)
    state_sh = resolve_tree(state_specs, mesh, rules)
    paged = "page_table" in state_specs
    kv_seq, lanes, ssm_state = _state_cuts(state_sh, mesh)
    cuts = decode_cuts(cfg, mesh.shape, rules)
    if ssm_state is not None and ssm_state != cuts["ssm"]:
        raise ValueError(
            f"the SSM state is {'' if ssm_state else 'not '}cut over "
            f"\"model\" and its params are {'' if cuts['ssm'] else 'not '}"
            f"(rules ssm_heads={rules.get('ssm_heads')!r}, "
            f"ssm_ff={rules.get('ssm_ff')!r}): the port cuts both by head "
            f"group or neither")
    model_group = (mesh.group("model") if "model" in mesh.shape
                   else mesh.group(()))
    shard = DecodeShard(
        model=model_group, data=mesh.data, world=mesh.world,
        heads=cuts["heads"], ff=cuts["ff"], vocab=cuts["vocab"],
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        vocab_size=cfg.vocab_size, batch_sharded=lanes,
        experts=cuts["experts"], num_experts=cfg.num_experts,
        ssm=cuts["ssm"],
        ssm_num_heads=cfg.ssm_num_heads if cfg.ssm_state else 0,
        kv_seq=kv_seq)
    rank_model = type(model)(cfg, shard=shard)
    local = _pairs(shapes, param_sh, lambda t, sh: local_shape(
        tuple(t.shape), sh.spec, mesh.shape))

    def check_pieces(params):
        bad = []
        _pairs(_pairs(params, param_sh, lambda t, _: t), local,
               lambda t, want: bad.append((tuple(t.shape), want))
               if tuple(t.shape) != want else None)
        if bad:
            raise ValueError(f"the params are not this rank's pieces: "
                             f"shapes {bad[:3]} (shardings['params'] "
                             f"cuts them)")

    def decode(params, state, token):
        check_pieces(params)
        if not donate:
            state = tree_map(torch.clone, state)
        return rank_model.decode_step(params, state, token)

    def prefill(params, batch, capacity, page_size=None):
        check_pieces(params)
        if paged and page_size is None:
            raise ValueError("paged state specs: pass the pool's page_size")
        if not paged and page_size is not None:
            raise ValueError("page_size needs paged state specs "
                             "(Model.paged_decode_state_specs)")
        return rank_model.prefill(params, batch, capacity,
                                  page_size=page_size)

    census = expected_kv_seq_decode_census(
        cfg, mesh.shape.get("model", 1),
        data=math.prod(mesh.shape.get(a, 1) for a in ("pod", "data")),
        paged=paged, rules=rules)
    prefill.shardings = decode.shardings = {
        "params": param_sh, "state": state_sh,
        "token": NamedSharding(mesh, resolve_spec(P("data"), rules)),
        "census": census}
    return prefill, decode
