"""Mixture-of-experts FFN with grouped top-k token-choice routing (port of
``repro.models.moe``).

Routing is per group, one group being one sequence row: each row's k
choices per token are sorted by expert (a stable sort), each expert keeps
its first ``capacity`` entries in that order, and the rest are dropped
(GShard-style capacity-factor dropping keeps the shapes static). Two
modes:

  * ``capacity`` (default): dispatch into (b, E, C, d) buffers, batched
    expert matmuls, combine — the path;
  * ``dense``: every expert for every token, masked by the routing weights
    (E/k x the FLOPs) — the oracle the tests hold the path against.

The routes are the reference's bit for bit: the top-k is taken from a
stable descending sort (lower expert index first among equal
probabilities, as ``jax.lax.top_k``), the expert order from a stable
argsort, and each entry's rank within its expert from ``searchsorted``
(left). Dispatch and combine are gathers in both directions
(``_take_rows``): every backward sums a token's k slots in a fixed order
and uses no atomics, so two calls on the card are bit-identical; no step
reads a value back to the host, so the layer never waits on the card.

The Switch-Transformer load-balancing loss is returned beside the output.

Expert parallelism (a ``TrainShard`` with ``experts`` set; the rank's
config holds its E/m experts) keeps the routing whole on every rank: the
float32 router is replicated and the routes and dispatch maps are taken
over all E experts, so they are the reference's bit for bit. A rank
gathers only its experts' slots (its contiguous range of the buffer),
runs its experts, and the combine reads a zero row for every slot of
another rank's expert; the partial outputs are summed over "model". The
batch rows are cut over "data" only, so no all-to-all is needed:
Megatron's pair, ``copy_to_group`` on the input of the dispatch and on
the routing weights before the combine, ``reduce_from_group`` on the
output. The router itself reads the uncopied input: its gradient (the
combine's through the copied weights, plus the load-balancing loss's,
which every rank computes whole) is whole on every rank and is never
summed again.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import comm
from repro_torch.distributed.sharding import P
from repro_torch.models.layers import dense_init, truncated_normal_init


def init_moe(cfg: ModelConfig, dtype, *, generator, device):
    """The router (d, E) in float32, as in the reference, and the experts
    stacked: ``w_gate`` / ``w_up`` (E, d, d_ff), ``w_down`` (E, d_ff, d) in
    the model's dtype."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    kw = dict(generator=generator, device=device)
    return {
        "router": dense_init(d, e, torch.float32, **kw),
        "w_gate": truncated_normal_init((e, d, ff), 1.0, dtype, **kw),
        "w_up": truncated_normal_init((e, d, ff), 1.0, dtype, **kw),
        "w_down": truncated_normal_init((e, ff, d), 1.0, dtype, **kw),
    }


def moe_specs(cfg: ModelConfig):
    return {"router": P("embed", None), "w_gate": P("expert", "embed", None),
            "w_up": P("expert", "embed", None),
            "w_down": P("expert", None, "embed")}


def _route(router_logits, k: int):
    """top-k routing. Returns (expert_idx (..., k), weights (..., k),
    probs (..., E)); weights renormalised over the k."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights = top[..., :k]
    return idx[..., :k], weights / weights.sum(-1, keepdim=True), probs


def load_balance_loss(probs, idx, num_experts: int, data=None):
    """Switch-Transformer aux loss E * sum_e f_e * p_e: f_e the fraction of
    tokens whose top-1 choice is e, p_e the mean router probability. Given
    the ``data`` group of a sharded step (each rank an equal part of the
    batch), f is the whole batch's (a sum over the group) and the result
    this rank's share, E * sum_e f_e * p_e / n: the shares sum to the
    whole batch's loss, and so do their gradients."""
    top1 = idx[..., 0]
    lead = tuple(range(top1.ndim))
    experts = torch.arange(num_experts, device=idx.device)
    f = (top1[..., None] == experts).float().mean(dim=lead)
    p = probs.mean(dim=lead)
    if data is None or data.size == 1:
        return num_experts * torch.sum(f * p)
    f = comm.all_reduce_sum(f, data) / data.size
    return num_experts * torch.sum(f * p) / data.size


def capacity(cfg: ModelConfig, s: int, num_experts: int | None = None) -> int:
    """Expert buffer rows per sequence row of ``s`` tokens (a Python value
    of static shapes, as in the reference) over ``num_experts`` (default
    the config's)."""
    k = cfg.num_experts_per_token
    e = num_experts or cfg.num_experts
    return max(int(cfg.moe_capacity_factor * s * k / e + 0.999), 1)


def _rows(x, idx):
    """x (b, n, d) gathered at idx (b, m) into (b, m, d); idx == n reads a
    zero row."""
    pad = x.new_zeros((x.shape[0], 1, x.shape[2]))
    xp = torch.cat([x, pad], dim=1)
    return xp.gather(1, idx[..., None].expand(-1, -1, x.shape[2]))


class _TakeRows(torch.autograd.Function):
    """y[b, r] = x[b, fwd[b, r]] (a zero row where fwd == x's rows), whose
    gradient is again a gather: dx[b, t] = sum_j dy[b, bwd[b, t, j]] over
    the ``group`` rows j that read row t, in a fixed order (bwd == y's rows
    reads a zero row). The two maps are each other's inverse on the rows
    they keep, so no atomics are needed on the card."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, group: int):
        ctx.save_for_backward(bwd)
        ctx.group = group
        return _rows(x, fwd)

    @staticmethod
    def backward(ctx, dy):
        (bwd,) = ctx.saved_tensors
        b = dy.shape[0]
        g = _rows(dy.contiguous(), bwd)
        return g.view(b, -1, ctx.group, dy.shape[2]).sum(2), None, None, None


def dispatch_maps(idx, e: int, cap: int):
    """The routing of each row as index maps, from a stable sort of the
    (token, choice) entries by expert. ``idx`` (b, s, k). Returns

      * ``slot_src`` (b, E * cap): the token each buffer slot reads (s for
        an empty slot);
      * ``entry_of_slot`` (b, E * cap): the entry t * k + j each slot holds
        (s * k for an empty slot);
      * ``slot_of_entry`` (b, s * k): the slot of each entry (E * cap where
        capacity dropped it).

    Only sorts, ``searchsorted`` and gathers: nothing waits on the host."""
    b, s, k = idx.shape
    n = s * k
    flat_e = idx.reshape(b, n)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(1, order)
    experts = torch.arange(e, device=idx.device).expand(b, e).contiguous()
    start = torch.searchsorted(sorted_e, experts, right=False)      # (b, e)
    count = torch.searchsorted(sorted_e, experts, right=True) - start
    c = torch.arange(cap, device=idx.device)
    pos = (start[:, :, None] + c).clamp(max=n - 1).view(b, e * cap)
    kept = (c < count[:, :, None]).view(b, e * cap)
    entry_of_slot = torch.where(kept, order.gather(1, pos), n)
    slot_src = torch.where(kept, entry_of_slot // k, s)
    # rank of each entry within its expert: its sorted position minus the
    # expert's first (the reference's arange - searchsorted(left))
    inv = torch.argsort(order, dim=-1)
    rank = inv - start.gather(1, flat_e)
    slot_of_entry = torch.where(rank < cap, flat_e * cap + rank, e * cap)
    return slot_src, entry_of_slot, slot_of_entry


def _local_slots(slot_src, slot_of_entry, entry_of_slot, lo: int, hi: int,
                 cap: int):
    """The maps of ``dispatch_maps`` cut to the buffer slots of experts
    [lo, hi): the slots' sources and entries, and each entry's slot among
    them (the slot count, a zero row, where it lies on another rank or
    was dropped)."""
    first, rows = lo * cap, (hi - lo) * cap
    local = slot_of_entry - first
    local = torch.where((local >= 0) & (local < rows), local, rows)
    return (slot_src[:, first:first + rows], local,
            entry_of_slot[:, first:first + rows])


def apply_moe(params, cfg: ModelConfig, x, *, mode: str = "capacity",
              data=None, shard=None):
    """x (b, s, d) -> (y (b, s, d), aux_loss); ``data``: the data group of
    a sharded step (``load_balance_loss``); ``shard``: a rank's experts
    of an expert-parallel training step (module docstring)."""
    ep = shard is not None and shard.experts
    e = shard.num_experts if ep else cfg.num_experts
    k = cfg.num_experts_per_token
    logits = x @ params["router"].to(x.dtype)                        # (b, s, e)
    idx, weights, probs = _route(logits, k)
    aux = load_balance_loss(probs, idx, e, data)

    if mode == "dense":
        if ep:
            raise ValueError("the dense MoE oracle runs every expert; an "
                             "expert-parallel rank holds only its own")
        h_g = torch.einsum("bsd,edf->besf", x, params["w_gate"])
        h_u = torch.einsum("bsd,edf->besf", x, params["w_up"])
        y_e = torch.einsum("besf,efd->besd", F.silu(h_g) * h_u,
                           params["w_down"])                         # (b,e,s,d)
        experts = torch.arange(e, device=x.device)
        mask = (idx[..., None] == experts).float()                   # (b,s,k,e)
        comb = torch.einsum("bske,bsk->bse", mask, weights)
        return torch.einsum("besd,bse->bsd", y_e, comb.to(y_e.dtype)), aux
    if mode != "capacity":
        raise ValueError(f"unknown MoE mode {mode!r}")

    b, s, d = x.shape
    cap = capacity(cfg, s, e)
    slot_src, entry_of_slot, slot_of_entry = dispatch_maps(idx, e, cap)
    if ep:
        lo, hi = shard.expert_range
        slot_src, slot_of_entry, entry_of_slot = _local_slots(
            slot_src, slot_of_entry, entry_of_slot, lo, hi, cap)
        x = comm.copy_to_group(x, shard.model)
        weights = comm.copy_to_group(weights, shard.model)
        e = hi - lo
    buf = _TakeRows.apply(x, slot_src, slot_of_entry, k)             # (b,e*cap,d)
    buf = buf.view(b, e, cap, d)
    h = F.silu(torch.einsum("becd,edf->becf", buf, params["w_gate"]))
    h = h * torch.einsum("becd,edf->becf", buf, params["w_up"])
    out = torch.einsum("becf,efd->becd", h, params["w_down"])
    # combine: each (token, choice) reads its slot (a zero row if dropped,
    # or, under expert parallelism, held by another rank)
    contrib = _TakeRows.apply(out.reshape(b, e * cap, d), slot_of_entry,
                              entry_of_slot, 1)                      # (b,s*k,d)
    y = (contrib.view(b, s, k, d) * weights.to(x.dtype)[..., None]).sum(2)
    if ep:
        y = comm.reduce_from_group(y, shard.model)
    return y, aux
