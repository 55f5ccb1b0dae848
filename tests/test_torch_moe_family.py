"""The reference's mixture-of-experts decoders on the CPU, against the JAX
package, with its weights handed over by ``params_from_jax``: reduced
olmoe-1b-7b (8 of 64 experts, top-2 of 8, MHA, untied head) and
phi3.5-moe-42b-a6.6b (8 of 16 experts, top-2, GQA 4:1).

  * the parameter tree: every JAX leaf arrives with its shape and dtype —
    the float32 router stays float32 in a bf16 model (its logits then
    equal the JAX model's bf16 ones), the experts take the model's dtype —
    and ``Model.init`` draws the same tree;
  * ``forward`` logits (atol 1e-4), ``loss`` with the load-balancing term
    (1e-4 relative; aux 1e-6) and every gradient, the router's included
    (atol 1e-4 once scaled by its max), for ``attn_impl`` ``chunked`` and
    ``pallas`` (the port's plain versions; JAX's Pallas kernels in
    interpret mode), on a packed ``SyntheticLM`` batch with a loss mask,
    with and without remat;
  * three AdamW train steps against the JAX step (losses 1e-4 relative,
    aux reported as the reference's step reports it);
  * the train launcher on both archs with ``--reduced --device cpu``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import reduced_config
from repro_torch.core.tree import tree_leaves, tree_map, with_leaves
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model, params_from_jax
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train import make_train_step

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py
ARCHS = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"]


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    arch = request.param
    params = jax_build_model(jax_reduced_config(arch)).init(
        jax.random.PRNGKey(0))
    return arch, params, jax.tree.map(np.asarray, params)


def _batch():
    return SyntheticLM(256, 48, 2, seed=1, mean_doc_len=16).batch_at(0)


def _jax_blocks(tree, num_layers):
    return [jax.tree.map(lambda a, l=l: a[l], tree) for l in range(num_layers)]


def test_params_from_jax_carries_every_leaf(family):
    arch, _, np_params = family
    cfg = reduced_config(arch)
    params = params_from_jax(np_params, cfg, device="cpu")
    assert set(params) == {"embed", "final_norm", "blocks", "lm_head"}
    for block, ref in zip(params["blocks"],
                          _jax_blocks(np_params["blocks"], cfg.num_layers)):
        assert set(block) == set(ref) == {"attn_norm", "attn", "mlp_norm",
                                          "moe"}
        assert set(block["moe"]) == {"router", "w_gate", "w_up", "w_down"}
        tree_map(lambda t, a: np.testing.assert_array_equal(t.numpy(), a),
                 block, ref)
    e, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
    moe_p = params["blocks"][0]["moe"]
    assert moe_p["router"].shape == (d, e)
    assert moe_p["w_gate"].shape == moe_p["w_up"].shape == (e, d, ff)
    assert moe_p["w_down"].shape == (e, ff, d)
    drawn = build_model(cfg).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    assert _shapes(drawn) == _shapes(params)


def _shapes(tree, prefix=""):
    """{path: (shape, dtype)} of a params tree."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k: v for key, sub in items
                for k, v in _shapes(sub, f"{prefix}/{key}").items()}
    return {prefix: (tuple(tree.shape), tree.dtype)}


def test_bf16_model_keeps_the_float32_router(family):
    """In a bf16 model the reference keeps the router float32 and casts it
    to bf16 only at use; ``params_from_jax`` keeps it float32 (every other
    leaf bf16, as ``Model.init`` draws them), and the router logits equal
    the JAX model's bf16 ones."""
    arch, _, _ = family
    jcfg = jax_reduced_config(arch, dtype="bfloat16")
    cfg = reduced_config(arch, dtype="bfloat16")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(2))
    np_params = jax.tree.map(np.asarray, jparams)
    assert np_params["blocks"]["moe"]["router"].dtype == np.float32
    params = params_from_jax(np_params, cfg, device="cpu")
    drawn = build_model(cfg).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    for tree in (params, drawn):
        for block in tree["blocks"]:
            assert block["moe"]["router"].dtype == torch.float32
            assert block["moe"]["w_gate"].dtype == torch.bfloat16
            assert block["attn"]["wq"].dtype == torch.bfloat16
        assert tree["embed"].dtype == torch.bfloat16
    router = np_params["blocks"]["moe"]["router"][0]
    np.testing.assert_array_equal(params["blocks"][0]["moe"]["router"].numpy(),
                                  router)
    x = np.random.default_rng(3).standard_normal((2, 12, cfg.d_model))
    jx = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray((jx @ jnp.asarray(router).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16)
    got = tx @ params["blocks"][0]["moe"]["router"].to(tx.dtype)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                               atol=1e-6)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_logits_loss_and_grads_match_jax(family, impl, remat):
    arch, jparams, np_params = family
    cfg = reduced_config(arch, attn_impl=impl, remat=remat)
    jcfg = jax_reduced_config(arch, attn_impl=impl, remat=remat)
    batch = _batch()
    assert batch["segment_ids"].max() > 0 and batch["loss_mask"].min() == 0
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_build_model(jcfg)
    model = build_model(cfg)
    params = params_from_jax(np_params, cfg, device="cpu")

    jlogits, jaux = jmodel.forward(jparams, jbatch)
    with torch.no_grad():
        logits, aux = model.forward(params, batch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert float(aux) > 0

    def jloss(p):
        return jmodel.loss(p, jbatch, deterministic=True)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tl, tm = model.loss(with_leaves(params, leaves), batch, deterministic=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-4)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-6)
    assert float(tl.detach()) != float(tm["ce"])     # aux_weight 0.01 counts
    grads = with_leaves(params, torch.autograd.grad(tl, leaves))
    jg = jax.tree.map(np.asarray, jg)
    jg["blocks"] = _jax_blocks(jg["blocks"], cfg.num_layers)

    def close(g, w):
        s = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy() / s, w / s, atol=1e-4, rtol=0)

    tree_map(close, grads, jg)
    assert float(grads["blocks"][0]["moe"]["router"].abs().max()) > 0


def _routes(model, params, batch):
    """Each MoE layer's top-k experts and router probabilities on
    ``batch`` (the port's forward, ``moe._route`` watched)."""
    from repro_torch.models import moe

    seen, route = [], moe._route

    def watch(logits, k):
        out = route(logits, k)
        seen.append((out[0], out[2]))
        return out

    moe._route = watch
    try:
        with torch.no_grad():
            model.forward(params, batch)
    finally:
        moe._route = route
    return seen


def _flipped_rows(got, want) -> set:
    """Rows where the two runs' routes differ; each difference must be a
    near-tie: the probabilities (of ``want``) at the first differing rank
    and the next within 1e-5."""
    rows = set()
    for (gi, _), (wi, wp) in zip(got, want):
        for b, t in (gi != wi).any(-1).nonzero().tolist():
            j = int((gi[b, t] != wi[b, t]).nonzero()[0])
            top = wp[b, t].sort(descending=True).values
            gap = float(top[j] - top[j + 1])
            assert gap <= 1e-5, f"route flip at row {b} token {t}, gap {gap}"
            rows.add(b)
    return rows


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch):
    """The launcher's recipe, AdamW with warmup_cosine and clip 1.0, three
    steps from the same weights: loss, ce and aux within 1e-4 relative of
    the JAX step's, grad norms within 1e-3. AdamW magnifies float noise in
    the parameters (so they are not compared), and that noise can flip a
    route at a near-tie of the router; before each step the routes of the
    port's parameters are held against those of JAX's, every flip must be
    a near-tie, and a step with one compares the cross-entropy of the rows
    without one (on JAX's side, the JAX model on those rows). The float32
    router is updated in float32."""
    cfg, jcfg = reduced_config(arch), jax_reduced_config(arch)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    jopt = jax_adamw(jax_warmup_cosine(1e-3, 2, 10))
    opt = adamw(warmup_cosine(1e-3, 2, 10))
    jstep = jax.jit(jax_make_train_step(jmodel, jopt, deterministic=True))
    jstate = jopt.init(jparams)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    start = params["blocks"][0]["moe"]["router"].clone()
    state = opt.init(params)
    step = make_train_step(model, opt, clip_norm=1.0, deterministic=True)
    data = SyntheticLM(cfg.vocab_size, 32, 4, seed=3)
    for s in range(3):
        batch = data.batch_at(s)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        mirror = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                 device="cpu")
        flipped = _flipped_rows(_routes(model, params, batch),
                                _routes(model, mirror, batch))
        if flipped:
            rows = [r for r in range(4) if r not in flipped]
            assert rows, "every row has a route flip"
            sub = {k: v[rows] for k, v in batch.items()}
            _, tm = model.loss(params, sub, deterministic=True)
            _, jm = jmodel.loss(jparams, {k: jnp.asarray(v)
                                          for k, v in sub.items()},
                                deterministic=True)
            np.testing.assert_allclose(float(tm["ce"].detach()),
                                       float(jm["ce"]), rtol=1e-4)
        jparams, jstate, jm = jstep(jparams, jstate, jbatch)
        params, state, tm = step(params, state, batch)
        if not flipped:
            for key in ("loss", "ce", "aux"):
                np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                           rtol=1e-4)
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-3)
    assert int(state["step"]) == 3
    router = params["blocks"][0]["moe"]["router"]
    assert router.dtype == torch.float32 and not torch.equal(router, start)


def _stacked(tree):
    """The tree as the reference holds it: the blocks stacked on a leading
    layer axis."""
    return {k: tree_map(lambda *ls: torch.stack(ls), *v)
            if isinstance(v, list) else v for k, v in tree.items()}


def test_piecewise_update_equals_whole_tree_update():
    """The train step clips, updates and applies one piece of the params
    at a time; that is bit-identical to the whole-tree clip, update and
    apply of ``repro_torch.optim`` on the tree as the reference holds it
    (blocks stacked on a layer axis, so a block's 1-D leaves are decayed),
    the moments included."""
    from repro_torch.optim import apply_updates, clip_by_global_norm

    cfg = dataclasses.replace(reduced_config("olmoe-1b-7b"), num_layers=3)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(4), device="cpu")
    batch = SyntheticLM(cfg.vocab_size, 32, 2, seed=5).batch_at(0)
    opt = adamw(warmup_cosine(1e-3, 1, 10))
    state = opt.init(params)
    new, state, metrics = make_train_step(model, opt, clip_norm=0.5,
                                          deterministic=True)(
        params, state, batch)

    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, _ = model.loss(with_leaves(params, leaves), batch,
                         deterministic=True)
    grads = with_leaves(params, torch.autograd.grad(loss, leaves))
    grads, norm = clip_by_global_norm(grads, 0.5)
    ref_state = opt.init(_stacked(params))
    updates, ref_state = opt.update(_stacked(grads), ref_state,
                                    _stacked(params))
    ref = apply_updates(_stacked(params), updates)
    assert torch.equal(metrics["grad_norm"], norm)
    for a, b in zip(tree_leaves(_stacked(new)), tree_leaves(ref)):
        assert torch.equal(a, b)
    for name in ("mu", "nu"):
        for a, b in zip(tree_leaves(_stacked(state[name])),
                        tree_leaves(ref_state[name])):
            assert torch.equal(a, b)
    # a block's 1-D leaves are decayed, as the reference's stacked ones
    w0 = params["blocks"][0]["attn_norm"]["w"]
    assert not torch.equal(new["blocks"][0]["attn_norm"]["w"], w0)
    assert int(state["step"]) == int(ref_state["step"]) == 1
    # the caller's params are untouched
    assert not torch.equal(tree_leaves(new)[0], tree_leaves(params)[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_takes_the_moe_archs(arch, tmp_path, capsys):
    from repro_torch.launch import train as launch_train

    trainer = launch_train.main(["--arch", arch, "--reduced", "--device",
                                 "cpu", "--steps", "2", "--seq", "32",
                                 "--batch", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and " aux " in out
    assert len(trainer.history) == 2
    for rec in trainer.history:
        assert np.isfinite(rec["loss"]) and rec["aux"] > 0
        np.testing.assert_allclose(rec["loss"], rec["ce"] + 0.01 * rec["aux"],
                                   rtol=1e-6)
    assert trainer.params["blocks"][0]["moe"]["router"].dtype == torch.float32
