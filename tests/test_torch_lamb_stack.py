"""LAMB's trust ratio over a block leaf stacked on the layer axis, on the
CPU, against the JAX package: the reference holds its blocks stacked
(``scan_layers``), so one ``||p|| / ||r||`` covers every layer of a block
leaf, while the port's train step hands the optimizer one block at a time
(``Optimizer.stacked``: two passes over the blocks). Reduced bert-large
(the paper's BERT recipe, LAMB) with layer 1's weight matrices scaled by
8, so that the layers' ratios differ and a per-layer ratio would move each
layer's update by the ratio of the two ratios. (Its LayerNorm scales stay
as drawn: scaled too, they saturate the layer's attention and make three
steps chaotic, where float noise of 1e-7 moves the third loss by 1e-4.)

  * one update of the train step (``_clip_update_apply``) against the
    reference's clip and ``lamb.update`` on the stacked tree, the same
    weights (``params_from_jax``) and gradients: each leaf's update within
    1e-4 of its max |.| (a constant learning rate of 0.5, so that the
    update is far above the rounding of the parameters it is read from);
  * three steps of the MLPerf recipe (``warmup_poly``): losses within
    1e-4 relative;
  * the two passes at the optimizer level: the updates of a stacked tree
    handed over layer by layer equal ``lamb.update`` on the whole stacked
    tree (atol 1e-6), the moments included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.optim import lamb as jax_lamb
from repro.optim import warmup_poly as jax_warmup_poly
from repro.optim.optimizers import clip_by_global_norm as jax_clip_by_global_norm
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import reduced_config
from repro_torch.core.tree import tree_leaves, tree_map, with_leaves
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model, params_from_jax
from repro_torch.optim import lamb, warmup_poly
from repro_torch.train import make_train_step
from repro_torch.train.steps import _clip_update_apply

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py
ARCH = "bert-large"
SCALED_LAYER, SCALE = 1, 8.0


def _scaled_params(num_layers=3):
    """The reference's stacked bert params with one layer's weight
    matrices scaled by 8 (its LayerNorm scales and biases as drawn)."""
    jcfg = jax_reduced_config(ARCH, num_layers=num_layers)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(2))
    jparams["blocks"] = jax.tree.map(
        lambda a: a.at[SCALED_LAYER].multiply(SCALE) if a.ndim >= 3 else a,
        jparams["blocks"])
    return jcfg, jparams


def _losses(lr_port, lr_jax, n_steps, num_layers=3):
    """(port metrics, reference metrics) of each of ``n_steps`` train steps
    on the same batches."""
    jcfg, jparams = _scaled_params(num_layers)
    cfg = reduced_config(ARCH, num_layers=num_layers)
    jopt, topt = jax_lamb(lr_jax), lamb(lr_port)
    jstep = jax.jit(jax_make_train_step(jax_build_model(jcfg), jopt,
                                        deterministic=True))
    step = make_train_step(build_model(cfg), topt, clip_norm=1.0,
                           deterministic=True)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    jstate, state = jopt.init(jparams), topt.init(params)
    data = SyntheticLM(cfg.vocab_size, 32, 4, seed=7)
    out = []
    for s in range(n_steps):
        batch = data.batch_at(s)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, tm = step(params, state, batch)
        out.append((tm, jm))
    return out


def test_one_step_updates_match_the_stacked_reference():
    """The train step's update (``_clip_update_apply``, what
    ``make_train_step`` runs after the gradients) against the reference's
    clip and ``lamb.update`` on the stacked tree, both fed the same
    gradients: from two frameworks' gradients, AdamW's m / sqrt(v) would
    magnify float noise where |g| is near eps (``ROADMAP.md``,
    tolerances), and the point here is the trust ratio."""
    jcfg, jparams = _scaled_params()
    cfg = reduced_config(ARCH, num_layers=3)
    model = build_model(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    batch = SyntheticLM(cfg.vocab_size, 32, 4, seed=7).batch_at(0)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, _ = model.loss(with_leaves(params, leaves), batch,
                         deterministic=True)
    grads = with_leaves(params, torch.autograd.grad(loss, leaves))
    jgrads = tree_map(lambda g: g.numpy().copy(), grads)
    jgrads["blocks"] = jax.tree.map(lambda *ls: np.stack(ls),
                                    *jgrads["blocks"])

    opt, jopt = lamb(0.5), jax_lamb(0.5)
    after, _, norm = _clip_update_apply(opt, grads, opt.init(params), params,
                                        1.0)
    jclipped, jnorm = jax_clip_by_global_norm(
        jax.tree.map(jnp.asarray, jgrads), 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    jupd, _ = jopt.update(jclipped, jopt.init(jparams), jparams)
    jafter = jax.tree.map(lambda p, u: p + u, jparams, jupd)

    def unstack(tree):
        tree = jax.tree.map(np.asarray, tree)
        tree["blocks"] = [jax.tree.map(lambda a, l=l: a[l], tree["blocks"])
                          for l in range(cfg.num_layers)]
        return tree

    want = jax.tree.map(lambda a, b: np.float64(a) - np.float64(b),
                        unstack(jafter), unstack(jparams))
    got = tree_map(lambda a, b: a.double().numpy() - b.double().numpy(),
                   after, params)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        s = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g / s, w / s, atol=1e-4, rtol=0)
    # one ||p|| / ||r|| for all three layers: the scaled layer moves about
    # as far as the others (a ratio per layer would move it ~8x as far)
    r0 = [np.abs(w).max() for w in jax.tree.leaves(want["blocks"][0])]
    r1 = [np.abs(w).max() for w in jax.tree.leaves(want["blocks"][1])]
    assert np.median(np.array(r1) / np.maximum(np.array(r0), 1e-30)) < 2


def test_three_steps_of_the_bert_recipe_match_the_stacked_reference():
    out = _losses(warmup_poly(3.75e-3, 2, 10),
                  jax_warmup_poly(3.75e-3, 2, 10), 3)
    losses = []
    for tm, jm in out:
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        losses.append(float(tm["loss"]))
    assert len(set(losses)) == 3


@pytest.mark.parametrize("weight_decay", [0.01, 0.0])
def test_two_passes_equal_the_whole_stacked_tree(weight_decay):
    """``lamb(...).stacked`` over the layers of a stacked tree (each layer
    a view with a leading axis of 1, as the train step hands them) gives
    ``lamb(...).update`` on the whole tree, twice in a row."""
    rng = np.random.default_rng(1)
    f = lambda *s: torch.as_tensor(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    stack = {"w": f(3, 5, 4) * torch.tensor([1.0, 8.0, 0.5])[:, None, None],
             "bias": torch.zeros(3, 4), "scale": f(3, 4)}
    opt = lamb(0.1, weight_decay=weight_decay)
    whole, parts = opt.init(stack), opt.init(stack)
    for _ in range(2):
        grads = tree_map(lambda p: f(*p.shape), stack)
        want, whole = opt.update(grads, whole, stack)
        sums = []
        views = []
        for l in range(3):
            layer = {"step": parts["step"],
                     **{k: tree_map(lambda t, l=l: t[l:l + 1], parts[k])
                        for k in ("mu", "nu")}}
            views.append(layer)
            opt.stacked.moments(tree_map(lambda t, l=l: t[l:l + 1], grads),
                                layer, tree_map(lambda t, l=l: t[l:l + 1],
                                                stack), sums)
        scales = opt.stacked.scales(parts, sums)
        got = [opt.stacked.update(views[l],
                                  tree_map(lambda t, l=l: t[l:l + 1], stack),
                                  scales) for l in range(3)]
        parts["step"] = parts["step"] + 1
        for k in want:
            torch.testing.assert_close(torch.cat([g[k] for g in got]),
                                       want[k], atol=1e-6, rtol=0)
        for k in ("mu", "nu"):
            for a, b in zip(tree_leaves(parts[k]), tree_leaves(whole[k])):
                torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
        stack = tree_map(lambda p, u: p + u, stack, want)
    assert int(parts["step"]) == int(whole["step"]) == 2
