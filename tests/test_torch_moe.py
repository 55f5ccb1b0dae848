"""The MoE layer of the port (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the CPU, in float32, with the same
weights and inputs (numpy from a seed):

  * ``apply_moe`` in ``capacity`` and ``dense`` modes: outputs at atol
    1e-5, the load-balancing loss within 1e-6 relative, at capacity
    factors 0.25 (most experts overflow: drops), 1.25 (the default) and 8
    (none dropped), for the reduced MoE configs and a wider 16-expert
    top-4 one;
  * the routes: top-k indices identical to ``jax.lax.top_k``'s, including
    forced ties (the lower expert index wins), and the dispatch maps equal
    to the reference's sort / ``searchsorted`` formula (which entries are
    kept, into which slot);
  * router and expert gradients against ``jax.grad`` (atol 1e-4 once
    scaled by their max);
  * the gather-based dispatch and combine: the custom autograd function's
    gradient equals a plain scatter-add's, and two forward + backward calls
    are bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import moe as jax_moe
from repro_torch.configs import reduced_config
from repro_torch.models import moe

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py
CASES = {
    # name: (arch, overrides)
    "olmoe": ("olmoe-1b-7b", {}),
    "phi35moe": ("phi3.5-moe-42b-a6.6b", {"d_ff": 96}),
    "e16_top4": ("olmoe-1b-7b", {"num_experts": 16,
                                 "num_experts_per_token": 4}),
}


def _cfgs(case, **kw):
    arch, over = CASES[case]
    kw = {**over, **kw}
    return reduced_config(arch, **kw), jax_reduced_config(arch, **kw)


def _weights(jcfg, seed=0):
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_maps(idx, e, cap):
    """The reference's per-row routing (``route_group`` of
    ``repro.models.moe``), evaluated with jnp: (slot, ok, order) of the
    stably sorted entries."""
    def group(idxg):
        flat_e = idxg.reshape(-1)
        order = jnp.argsort(flat_e)
        sorted_e = flat_e[order]
        pos = jnp.arange(flat_e.shape[0]) - jnp.searchsorted(
            sorted_e, sorted_e, side="left")
        return sorted_e * cap + pos, pos < cap, order
    return [np.asarray(a) for a in jax.vmap(group)(jnp.asarray(idx))]


@pytest.mark.parametrize("cf", [0.25, 1.25, 8.0])
@pytest.mark.parametrize("mode", ["capacity", "dense"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_moe_matches_jax(case, mode, cf):
    cfg, jcfg = _cfgs(case, moe_capacity_factor=cf)
    jp, tp = _weights(jcfg)
    x = _x((3, 40, cfg.d_model))
    jy, jaux = jax_moe.apply_moe(jp, jcfg, jnp.asarray(x), mode=mode)
    ty, taux = moe.apply_moe(tp, cfg, torch.from_numpy(x), mode=mode)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert ty.dtype == torch.float32 and taux.dtype == torch.float32


@pytest.mark.parametrize("cf", [0.25, 1.25])
@pytest.mark.parametrize("case", sorted(CASES))
def test_routes_and_dispatch_maps_equal_the_reference(case, cf):
    """The same top-k experts in the same order, and every (token, choice)
    entry kept or dropped and placed into the same slot as the reference
    does (at cf 0.25 some are dropped)."""
    cfg, jcfg = _cfgs(case, moe_capacity_factor=cf)
    jp, tp = _weights(jcfg)
    x = _x((3, 40, cfg.d_model), seed=2)
    logits = x @ np.asarray(jp["router"])
    k, e = cfg.num_experts_per_token, cfg.num_experts
    jidx, jw, _ = jax_moe._route(jnp.asarray(logits), k)
    tidx, tw, _ = moe._route(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=0)

    cap = moe.capacity(cfg, 40)
    assert cap == int(jcfg.moe_capacity_factor * 40 * k / e + 0.999)
    slot, ok, order = _jax_maps(np.asarray(jidx), e, cap)
    src, entry_of_slot, slot_of_entry = moe.dispatch_maps(tidx, e, cap)
    b, n = slot.shape
    want = np.full((b, n), e * cap)                  # per entry, token order
    for r in range(b):
        want[r, order[r]] = np.where(ok[r], slot[r], e * cap)
    np.testing.assert_array_equal(slot_of_entry.numpy(), want)
    if cf == 0.25:
        assert int((~ok).sum()) > 0, "cf 0.25 no longer forces drops"
    # the slot -> entry -> slot round trip, and the token each slot reads
    for r in range(b):
        live = entry_of_slot[r] < n
        assert int(live.sum()) == int(ok[r].sum())
        ent = entry_of_slot[r][live]
        np.testing.assert_array_equal(
            slot_of_entry[r][ent].numpy(), np.flatnonzero(live.numpy()))
        np.testing.assert_array_equal(src[r][live].numpy(),
                                      (ent // k).numpy())
        assert bool((src[r][~live] == 40).all())


@pytest.mark.parametrize("k", [1, 2, 4])
def test_forced_ties_pick_the_lower_expert(k):
    """Equal probabilities (repeated logits) are taken lower index first,
    as ``jax.lax.top_k`` takes them."""
    rng = np.random.default_rng(k)
    logits = rng.integers(0, 3, size=(4, 7, 8)).astype(np.float32)
    logits[0, 0] = 0.0                               # an all-equal row
    jidx, _, _ = jax_moe._route(jnp.asarray(logits), k)
    tidx, _, _ = moe._route(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert tidx[0, 0].tolist() == list(range(k))


def test_load_balance_loss_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 16, 8)).astype(np.float32)
    jidx, _, jprobs = jax_moe._route(jnp.asarray(logits), 2)
    tidx, _, tprobs = moe._route(torch.from_numpy(logits), 2)
    want = float(jax_moe.load_balance_loss(jprobs, jidx, 8))
    got = float(moe.load_balance_loss(tprobs, tidx, 8))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # all tokens on one expert with all the probability: E * 1 * 1
    one = torch.zeros((2, 16, 8))
    one[..., 3] = 1.0
    idx = torch.full((2, 16, 2), 3)
    assert float(moe.load_balance_loss(one, idx, 8)) == 8.0


@pytest.mark.parametrize("cf", [0.25, 1.25])
@pytest.mark.parametrize("case", ["olmoe", "e16_top4"])
def test_router_and_expert_grads_match_jax(case, cf):
    """d(sum(y * g) + aux) by every weight and by x, against ``jax.grad``."""
    cfg, jcfg = _cfgs(case, moe_capacity_factor=cf)
    jp, tp = _weights(jcfg, seed=4)
    x = _x((2, 24, cfg.d_model), seed=5)
    cot = _x((2, 24, cfg.d_model), seed=6)

    def jloss(p, xx):
        y, aux = jax_moe.apply_moe(p, jcfg, xx)
        return jnp.sum(y * cot) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {n: t.clone().requires_grad_() for n, t in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.apply_moe(leaves, cfg, tx)
    (torch.sum(y * torch.from_numpy(cot)) + aux).backward()

    def close(g, w):
        w = np.asarray(w)
        s = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy() / s, w / s, atol=1e-4, rtol=0)

    for n, t in leaves.items():
        close(t.grad, jg[n])
    close(tx.grad, jgx)


def test_take_rows_gradient_is_the_scatter_add():
    """``_TakeRows``' backward (a gather through the inverse map, summed
    over each token's k slots) equals autograd's scatter-add gradient of
    the plain gather, in float64, dispatch and combine."""
    cfg, jcfg = _cfgs("olmoe", moe_capacity_factor=0.5)
    gen = torch.Generator().manual_seed(7)
    b, s, d = 2, 20, 8
    k, e = cfg.num_experts_per_token, cfg.num_experts
    idx = torch.stack([torch.randperm(e, generator=gen)[:k]
                       for _ in range(b * s)]).view(b, s, k)
    cap = moe.capacity(cfg, s)
    src, entry_of_slot, slot_of_entry = moe.dispatch_maps(idx, e, cap)
    x = torch.randn(b, s, d, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    dy = torch.randn(b, e * cap, d, generator=gen, dtype=torch.float64)
    got = torch.autograd.grad(
        (moe._TakeRows.apply(x, src, slot_of_entry, k) * dy).sum(), x)[0]
    want = torch.autograd.grad((moe._rows(x, src) * dy).sum(), x)[0]
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    out = torch.randn(b, e * cap, d, generator=gen, dtype=torch.float64,
                      requires_grad=True)
    dc = torch.randn(b, s * k, d, generator=gen, dtype=torch.float64)
    got = torch.autograd.grad(
        (moe._TakeRows.apply(out, slot_of_entry, entry_of_slot, 1)
         * dc).sum(), out)[0]
    want = torch.autograd.grad(
        (moe._rows(out, slot_of_entry) * dc).sum(), out)[0]
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_and_backward_bit_identical_across_calls(dtype):
    cfg, _ = _cfgs("e16_top4", moe_capacity_factor=1.0)
    gen = torch.Generator().manual_seed(8)
    p = moe.init_moe(cfg, dtype, generator=gen, device="cpu")
    assert p["router"].dtype == torch.float32
    assert p["w_gate"].shape == (16, cfg.d_model, cfg.d_ff)
    assert p["w_down"].shape == (16, cfg.d_ff, cfg.d_model)
    x = torch.randn(2, 33, cfg.d_model, generator=gen).to(dtype)
    cot = torch.randn(2, 33, cfg.d_model, generator=gen).to(dtype)
    runs = []
    for _ in range(2):
        leaves = {n: t.clone().requires_grad_() for n, t in p.items()}
        xx = x.clone().requires_grad_()
        y, aux = moe.apply_moe(leaves, cfg, xx)
        grads = torch.autograd.grad((y * cot).float().sum() + aux,
                                    [xx, *leaves.values()])
        runs.append((y, aux, *grads))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert runs[0][0].dtype == dtype
